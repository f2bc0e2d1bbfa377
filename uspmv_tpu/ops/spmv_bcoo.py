"""Independent comparison path: jax.experimental.sparse BCOO SpMV.

The reference cross-checks its kernels against a vendor library it did not
write — cuSPARSE CSR and SlicedEll descriptors (utilities.hpp:3380-3550,
invoked via cusparseSpMV at classes_structs.hpp:998-1011). Here that is the
sparse support shipped with JAX itself: BCOO matrices, which on a GPU lower
to cuSPARSE (``jax_bcoo_cusparse_lowering``, switched on when the operator
is built for a GPU) and elsewhere to XLA's own sparse rules. Select with
``-impl bcoo``; the bench block then reports a number produced by library
kernels rather than ours, against the identical flops/bytes accounting.

Deliberately minimal: no SCS conversion, no row permutation, no halo
machinery — x and y stay in natural order. This keeps the path independent
(nothing from our format pipeline can leak into it) and makes it the
honest external baseline for the SELL-C-sigma kernel's speedup claims.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, dtype_for
from ..formats.coo import MtxData, extract_matrix_min_mean_max
from ..ops.vectors import init_x_host


@dataclasses.dataclass
class _BcooDev:
    """Wrapper so bench byte-accounting sees the same interface DeviceScs
    exposes (values stream + index stream)."""

    mat: object  # sparse.BCOO

    def stream_bytes(self) -> int:
        return int(self.mat.data.nbytes + self.mat.indices.nbytes)

    @property
    def device_beta(self) -> float:
        return 1.0  # COO stores no padding


# flows through jit as an argument (the devs dict), so it must be a pytree
jax.tree_util.register_pytree_node(
    _BcooDev,
    lambda d: ((d.mat,), None),
    lambda _, children: _BcooDev(children[0]),
)


@dataclasses.dataclass
class BcooSpmvOperator:
    """Same public surface as SpmvOperator, executing through
    jax.experimental.sparse. Single-device only (it is a comparison
    baseline, not a distribution path)."""

    config: Config
    n_rows: int
    n_rows_padded: int
    devs: Dict[str, _BcooDev]
    matrix_stats: tuple
    nnz: int
    device: Optional[object] = None
    _jit_spmv: Optional[object] = None

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "BcooSpmvOperator":
        from jax.experimental import sparse

        from ..runtime.operator import resolve_device

        config.validate()
        if config.n_shards > 1:
            raise ValueError("-impl bcoo is a single-device comparison path")
        if config.is_ap:
            raise ValueError(
                "-impl bcoo supports uniform precisions only (dp|sp|hp)"
            )
        mtx = mtx.copy()
        if not mtx.is_sorted:
            mtx = mtx.sort_by_row()
        stats = extract_matrix_min_mean_max(mtx)
        device = resolve_device(config)
        if device.platform == "gpu":
            jax.config.update("jax_bcoo_cusparse_lowering", True)
        indices = np.stack(
            [mtx.I.astype(np.int32), mtx.J.astype(np.int32)], axis=1
        )
        data = mtx.values.astype(dtype_for(config.value_type))
        mat = sparse.BCOO(
            (jax.device_put(data, device), jax.device_put(indices, device)),
            shape=(mtx.n_rows, mtx.n_cols),
            indices_sorted=True,
            unique_indices=False,
        )
        return cls(
            config=config,
            n_rows=mtx.n_rows,
            n_rows_padded=mtx.n_rows,
            devs={config.value_type: _BcooDev(mat)},
            matrix_stats=stats,
            nnz=mtx.nnz,
            device=device,
        )

    # ------------------------------------------------------------- execution

    @property
    def working_dtype(self):
        return self.config.working_dtype()

    @property
    def kernel_args(self):
        return self.devs

    def build_spmv_closure(self):
        from jax.experimental import sparse

        layout = self.config.vector_layout
        bs = self.config.block_vec_size
        acc = jnp.dtype(self.working_dtype)

        def one(devs, x):
            mat = next(iter(devs.values())).mat
            # low-precision values x full-precision accumulation, matching
            # the main path's semantics (values stream in value_type, the
            # product accumulates in the working dtype). BCOO's matvec
            # accumulates in the operand dtype, so for 2-byte values (hp)
            # the data is widened to the accumulator dtype BEFORE the
            # matmul — bf16 quantization stays (stored values), bf16
            # accumulation does not (ADVICE r2)
            if mat.data.dtype.itemsize < jnp.dtype(acc).itemsize:
                mat = mat.astype(acc)
            y = sparse.bcoo_dot_general(
                mat, x.astype(mat.data.dtype),
                dimension_numbers=(([1], [0]), ([], [])),
                precision=jax.lax.Precision.HIGHEST,
            )
            return y.astype(acc)

        if bs > 1 and layout == "colwise":
            return lambda devs, x: jax.vmap(lambda xv: one(devs, xv))(x)
        return one

    def _spmv_fn(self):
        if self._jit_spmv is None:
            self._jit_spmv = jax.jit(self.build_spmv_closure())
        return self._jit_spmv

    def spmv(self, x):
        return self._spmv_fn()(self.devs, x)

    def _solve_fn(self):
        if getattr(self, "_jit_solve", None) is None:
            fn = self.build_spmv_closure()

            def solve(devs, x, n):
                def body(carry, _):
                    x, _y = carry
                    return (fn(devs, x), x), None

                (x_fin, y_fin), _ = jax.lax.scan(
                    body, (x, jnp.zeros_like(x)), None, length=n
                )
                return y_fin, x_fin

            self._jit_solve = jax.jit(solve, static_argnums=2)
        return self._jit_solve

    def solve(self, x, n_repetitions: int):
        return self._solve_fn()(self.devs, x, n_repetitions)

    # --------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None):
        host = init_x_host(
            self.config, self.n_rows, self.matrix_stats,
            x_in=x_in, dtype=self.working_dtype,
        )
        if self.config.block_vec_size > 1 and self.config.vector_layout == "colwise":
            host = np.ascontiguousarray(host.T)  # [bs, n]
        return jax.device_put(host, self.device)

    def to_host(self, y) -> np.ndarray:
        y = np.asarray(y)
        if self.config.block_vec_size > 1 and self.config.vector_layout == "colwise":
            y = np.ascontiguousarray(y.T)
        return y

    # --------------------------------------------------------------- metrics

    def flops_per_spmv(self) -> int:
        return 2 * self.nnz * self.config.block_vec_size

    def bytes_per_spmv(self) -> int:
        total = sum(d.stream_bytes() for d in self.devs.values())
        xw = np.dtype(self.working_dtype).itemsize
        total += self.n_rows * self.config.block_vec_size * xw * 2
        return total

    def beta(self):
        return {p: 1.0 for p in self.devs}

    def device_beta(self):
        return {p: d.device_beta for p, d in self.devs.items()}

    def nnz_per_precision(self):
        return {p: self.nnz for p in self.devs}

    def comm_volume_per_spmv(self) -> dict:
        return {}

    def impl_name(self) -> str:
        return "jax-bcoo"

    def per_shard_nnz(self):
        return None

    def dump_sparsity(self, outdir: str) -> list:
        raise NotImplementedError("-output_sparsity needs the SCS path")
