"""Runtime configuration.

The reference splits configuration between compile-time defines
(Makefile/config.mk, SURVEY.md L0) and a runtime ``Config`` struct populated
by ``parse_cli_inputs`` (reference classes_structs.hpp:47-153,
utilities.hpp:1047-1545). Under JAX there is no reason to bake layout or
parallelism into a build, so everything is one runtime dataclass here.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Precision names follow the reference CLI (-dp/-sp/-hp/-ap[...]).
PRECISION_DTYPES = {
    "dp": np.float64,
    "sp": np.float32,
    "hp": "bfloat16",  # resolved lazily to ml_dtypes/jnp bfloat16
}

AP_VALUE_TYPES = ("ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]", "ap[dp_sp_hp]")
VALUE_TYPES = ("dp", "sp", "hp") + AP_VALUE_TYPES
KERNEL_FORMATS = ("crs", "scs")
SEG_METHODS = ("seg-rows", "seg-nnz", "seg-metis")
# Reference block-vector layouts (Makefile:17-31): colwise = X[vec_len*v + row],
# rowwise = X[row*bs + v]. Here these are axis orders of a 2-D array.
VECTOR_LAYOUTS = ("colwise", "rowwise")
# Reference MPI message-batching modes (Makefile:199-218). Under XLA,
# "bulkvec" (all RHS columns in one collective) is the natural mode;
# "graphtopo" (the reference's MPI_Neighbor_alltoallv graph-topology mode)
# is accepted and collapses to the same schedule — XLA's static per-offset
# ppermute plan IS the neighbor topology, precomputed at plan time;
# "allgather" is our additional naive/robust mode with no reference analogue.
COMM_MODES = ("singlevec", "multivec", "bulkvec", "graphtopo", "allgather")


def dtype_for(prec: str):
    """Numpy dtype for a precision name ('dp'|'sp'|'hp')."""
    d = PRECISION_DTYPES[prec]
    if d == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(d)


@dataclasses.dataclass
class Config:
    """All runtime knobs; mirrors reference Config + compile-time defines."""

    # --- format (reference: -c, -s; classes_structs.hpp:49-51) ---
    chunk_size: int = 1  # C of SELL-C-sigma
    sigma: int = 1  # sorting scope
    kernel_format: str = "scs"  # 'crs' | 'scs'

    # --- precision (reference: -dp/-sp/-hp/-ap[...]) ---
    value_type: str = "dp"

    # --- block vectors / SpMMV (reference: -block_vec_size, BLOCK_VECTOR_LAYOUT) ---
    block_vec_size: int = 1
    vector_layout: str = "colwise"  # 'colwise' | 'rowwise'

    # --- x initialization (reference: -rand_x 0|1|m, DefaultValues) ---
    random_init_x: bool = False
    mean_init_x: bool = False  # 'm': fill x with the matrix min/max midpoint
    random_init_A: bool = False
    seed: int = 42

    # --- modes & loop counts (reference: -mode, -rev, -bench_time) ---
    mode: str = "b"  # 'b' bench | 's' solve
    n_repetitions: int = 1
    bench_time: float = 5.0
    validate_result: bool = True
    verbose: bool = False

    # --- adaptive precision (reference: -ap_threshold_1/2, -dropout*) ---
    ap_threshold_1: float = 0.0
    ap_threshold_2: float = 0.0
    # The reference parses these but never applies them
    # (utilities.hpp:1281-1306); we implement them.
    dropout: bool = False
    dropout_threshold: float = 0.0

    # --- scaling (reference: -equilibrate, jacobi_scale) ---
    equilibrate: bool = False
    jacobi_scale: bool = False

    # --- heavy-row splitting (extension beyond the reference) ---
    # Rows longer than the auto threshold split into virtual rows so one
    # power-law row can't inflate its whole C-row chunk; partials are added
    # back after each SpMV. 0 = auto threshold, -1 = disabled. Single-device
    # operator only; the sharded operator does not split.
    split_rows_threshold: int = 0

    # --- distribution (reference: -seg_method, MPI_MODE) ---
    seg_method: str = "seg-rows"
    comm_mode: str = "bulkvec"
    # Comm/compute overlap (SURVEY.md §7 stage 8): split each shard's matrix
    # into interior elements (local columns, computed while the halo
    # exchange is in flight — XLA async collectives) and halo elements
    # (applied after). The reference structures for this but never does it
    # (main.cpp:408-418,464-469 call begin+finish back-to-back).
    overlap_comm: bool = True
    comm_halos: bool = True  # reference: -comm_halos
    # Accepted for reference-CLI parity but intentionally no-ops under XLA:
    # iterations are timed inside one compiled loop with a device-fetch
    # fence (ba_synch's barrier is implicit), and the halo pack is a fused
    # device gather (par_pack's OpenMP toggle has no analogue).
    ba_synch: bool = True
    par_pack: bool = True
    no_pack: bool = False  # skip halo pack (perf experiment, reference -no_pack)
    print_comm_vol: bool = False
    n_shards: int = 1  # number of mesh devices along the "rows" axis

    # --- device execution ---
    backend: str = "auto"  # 'auto' | 'gpu' | 'cpu'
    # 'auto' = the SELL-C-sigma kernel on a GPU, XLA elsewhere; 'xla'
    # forces the XLA path; 'bcoo' runs the INDEPENDENT jax.experimental
    # .sparse baseline (the cuSPARSE comparison, utilities.hpp:3380-3550)
    impl: str = "auto"

    # --- reporting (reference: output_filename_*) ---
    output_dir: str = "."
    matrix_file_name: str = ""
    mode_matrix_stats: bool = False  # -matrix_stats
    output_sparsity: bool = False  # OUTPUT_SPARSITY compile flag analogue
    log_prof: bool = False
    # DEBUG_MODE_FINE analogue: stage dumps + invariant checks via
    # runtime/sanity.SanityChecker
    debug_mode: bool = False

    def validate(self) -> None:
        """Cross-validation of flag combinations (ref utilities.hpp:1047-1545).

        The reference *rejects* AP+MPI and SpMMV+AP (utilities.hpp:1382-1393,
        1446-1451); we support both, so no error here — parity only requires
        matching the supported matrix (SURVEY.md §7).
        """
        if self.kernel_format not in KERNEL_FORMATS:
            raise ValueError(f"kernel_format must be one of {KERNEL_FORMATS}")
        if self.value_type not in VALUE_TYPES:
            raise ValueError(f"value_type must be one of {VALUE_TYPES}")
        if self.mode not in ("b", "s"):
            raise ValueError("mode must be 'b' (bench) or 's' (solve)")
        if self.chunk_size < 1 or self.sigma < 1:
            raise ValueError("chunk_size and sigma must be >= 1")
        if self.vector_layout not in VECTOR_LAYOUTS:
            raise ValueError(f"vector_layout must be one of {VECTOR_LAYOUTS}")
        if self.seg_method not in SEG_METHODS:
            raise ValueError(f"seg_method must be one of {SEG_METHODS}")
        if self.comm_mode not in COMM_MODES:
            raise ValueError(f"comm_mode must be one of {COMM_MODES}")
        if self.impl not in ("auto", "xla", "bcoo"):
            raise ValueError("impl must be one of ('auto', 'xla', 'bcoo')")
        if self.backend not in ("auto", "gpu", "cpu"):
            raise ValueError("backend must be one of ('auto', 'gpu', 'cpu')")
        if self.block_vec_size < 1:
            raise ValueError("block_vec_size must be >= 1")
        if self.value_type in AP_VALUE_TYPES:
            if self.ap_threshold_1 < 0:
                raise ValueError("ap_threshold_1 must be >= 0")
            if self.value_type == "ap[dp_sp_hp]" and not (
                0 <= self.ap_threshold_2 <= self.ap_threshold_1
            ):
                # reference requires 0 <= th2 <= th1 (utilities.hpp:3042-3121)
                raise ValueError("need 0 <= ap_threshold_2 <= ap_threshold_1")
        if self.dropout and self.dropout_threshold < 0:
            raise ValueError("dropout_threshold must be >= 0")
        if self.kernel_format == "crs" and (self.chunk_size != 1 or self.sigma != 1):
            raise ValueError("crs implies chunk_size == sigma == 1")

    @property
    def is_ap(self) -> bool:
        return self.value_type in AP_VALUE_TYPES

    @property
    def ap_precisions(self) -> tuple:
        """Ordered precisions of an adaptive value type, e.g. ('dp','sp')."""
        if not self.is_ap:
            return (self.value_type,)
        return tuple(self.value_type[3:-1].split("_"))

    def working_dtype(self):
        """The dtype y/x are held in.

        Matrix VALUES stream in each precision's own dtype; x/y and the
        accumulator use the highest precision in play, with bfloat16
        promoted to float32 — 'hp' means a bf16-valued matrix with f32
        vectors/accumulation (strictly more accurate than the reference's
        all-_Float16 path)."""
        d = dtype_for(self.ap_precisions[0])
        if d.itemsize == 2:
            return np.dtype(np.float32)
        return d


@dataclasses.dataclass
class DefaultValues:
    """Initial x/y fills (reference classes_structs.hpp:1792-1810)."""

    A: float = 2.0
    x: float = 5.00
    y: float = 0.0
