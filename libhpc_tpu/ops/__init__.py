from libhpc_tpu.ops import scan, histogram, reduce, transpose, sort  # noqa: F401
from libhpc_tpu.ops import spmv, spmm, spgemm, stencil, solver, multigrid, precision  # noqa: F401
from libhpc_tpu.ops import spgemm_bsr, spmv_pallas  # noqa: F401
