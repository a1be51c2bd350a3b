#!/bin/sh
# CI entry: CPU suite (8 virtual devices) + native build/selftest + ASan +
# the CPU rehearsal of chip_smoke.py; on a CUDA GPU runner set
# LIBHPC_CI_GPU=1 to run chip_smoke.py (which runs the gpu-marked tests
# in-process) and bench.py.
set -e
cd "$(dirname "$0")/.."
echo "== native build + selftest =="
make -C native all
python -c "from libhpc_tpu.runtime.native import selftest; assert selftest() == 0; print('selftest ok')"
echo "== ASan selftest =="
make -C native asan && ./native/build/selftest_asan
echo "== CPU test suite (fast tier) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "not slow"
if [ "$LIBHPC_CI_FAST" != "1" ]; then
  echo "== CPU test suite (slow tier) =="
  JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "slow"
fi
echo "== graft entry dryrun =="
python -c "import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun ok')"
echo "== chip smoke rehearsal (CPU) =="
JAX_PLATFORMS=cpu python chip_smoke.py --rehearse
if [ "$LIBHPC_CI_GPU" = "1" ]; then
  echo "== chip smoke (GPU) =="
  python chip_smoke.py
  echo "== bench =="
  python bench.py
fi
