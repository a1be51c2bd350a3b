"""libhpc_tpu — a sparse linear-algebra / HPC-primitives framework in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of the reference
C++/CUDA library libHPC (see SURVEY.md), running on CUDA GPUs:

- ``libhpc_tpu.sparse``   — CSR/COO/BSR/ELL/DIA/SBELL containers + hierarchical
  block grid (replacement for the reference's ``lib/sparse`` hierarchical
  grid, reference: lib/sparse/include/RootGrid.hpp:12), and auto_format.
- ``libhpc_tpu.ops``      — XLA primitives and the Triton SBELL SpMV kernel:
  transpose, exclusive scan, histogram, segmented reduce, radix sort,
  SpMV/SpMM/SpGEMM, stencils, CG/AMG solvers (replacements for lib/sort,
  lib/gpu/radix_gpu, lib/hpc stencil workloads).
- ``libhpc_tpu.parallel`` — device meshes, halo exchange via ``ppermute``,
  distributed SpMV/CG/AMG/stencil (new work; the reference is
  single-node).
- ``libhpc_tpu.runtime``  — native C++ host runtime (arena memory pool, thread
  pool, lock-free MPMC queue, parallel MatrixMarket loader) bound via ctypes
  (replacements for lib/mempool, lib/concurrency).
- ``libhpc_tpu.utils``    — Morton codes (replacement for libmorton), config
  dataclasses, profiling/roofline helpers.
"""

__version__ = "0.1.0"

from libhpc_tpu.sparse.csr import CSR  # noqa: F401
from libhpc_tpu.sparse.coo import COO  # noqa: F401
from libhpc_tpu.sparse.bsr import BSR  # noqa: F401
from libhpc_tpu.sparse.ell import ELL  # noqa: F401
