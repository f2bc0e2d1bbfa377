"""uspmv_tpu — SELL-C-sigma sparse linear algebra in JAX, for NVIDIA GPUs.

A JAX/XLA/Pallas re-design of the capabilities of RRZE-HPC/Ultimate-SpMV:
CRS and SELL-C-sigma sparse storage, single-vector SpMV and block-vector
SpMMV, adaptive mixed precision (dp/sp/hp nonzero partitioning),
distributed row-partitioned execution with halo exchange over a JAX device
mesh, and a benchmark/validation harness replicating the reference's
methodology. On a GPU the SpMV is a Pallas (Triton) kernel in the design
of the reference's CUDA ``scs_impl_gpu<C>``; on the CPU, where the tests
run, the same operators execute through XLA.

Precision naming follows the reference (classes_structs.hpp:47-153):
  dp = float64
  sp = float32
  hp = bfloat16 values with float32 vectors (reference: _Float16)
"""

import os as _os

import jax as _jax

# The reference is a double-precision HPC code (value_type "dp" default,
# utilities.hpp:parse_cli_inputs), so x64 is on; the sp/hp paths keep
# their arrays in 32 bits or fewer.
_jax.config.update("jax_enable_x64", True)

# Persistent compile cache: JAX_COMPILATION_CACHE_DIR when set (JAX reads
# it itself), else a fixed directory in the checkout, so a later process
# on the same tree finds what an earlier one compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )

__version__ = "0.1.0"

from .config import Config, DefaultValues, PRECISION_DTYPES, dtype_for
from .formats.coo import MtxData
from .formats.scs import ScsData, convert_to_scs, permute_scs_cols
from .formats.coo import (
    apply_permutation,
    apply_strided_permutation,
    equilibrate_matrix,
    extract_largest_col_elems,
    extract_largest_row_elems,
)
from .io.mmio import read_mtx, write_mtx
from .precision.partition import partition_precisions, ap_threshold_from_norm

__all__ = [
    "Config",
    "DefaultValues",
    "PRECISION_DTYPES",
    "dtype_for",
    "MtxData",
    "ScsData",
    "convert_to_scs",
    "permute_scs_cols",
    "apply_permutation",
    "apply_strided_permutation",
    "equilibrate_matrix",
    "extract_largest_row_elems",
    "extract_largest_col_elems",
    "read_mtx",
    "write_mtx",
    "partition_precisions",
    "ap_threshold_from_norm",
]
