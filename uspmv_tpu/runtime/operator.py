"""SpmvOperator — the kernel dispatch / execution object.

Re-design of the reference's ``SpmvKernel`` (classes_structs.hpp:
280-1166): owns the per-precision device matrices, selects the kernel
implementation from (format x precision x backend), and exposes a jitted
``spmv`` plus the x<->y swap used by solve mode. Distribution (multi-shard)
is layered on top in parallel/distributed.py.

Pipeline (reference init_local_structs, main.cpp:1074-1334):
  ingest COO -> [jacobi|equilibrate] -> [heavy-row split] -> [AP partition]
  -> convert_to_scs (shared permutation across precisions) -> symmetric
  column permutation -> device arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, dtype_for
from ..formats.coo import (
    MtxData,
    equilibrate_matrix,
    extract_matrix_min_mean_max,
    jacobi_scale_matrix,
    split_heavy_rows,
)
from ..formats.scs import ScsData, convert_to_scs, permute_scs_cols
from ..ops.device_format import DeviceScs, build_device_scs
from ..ops.spmv_xla import spmv_flat, spmv_tiled
from ..ops.vectors import from_device_layout, init_x_host, to_device_layout
from ..precision.partition import partition_precisions


def resolve_device(config: Config):
    """The execution device: the default device for ``auto``, else the
    first device of the requested platform. A platform the process does
    not have raises (jax.devices) — work never moves to another one."""
    if config.backend == "auto":
        return jax.devices()[0]
    return jax.devices(config.backend)[0]


MAX_SCS_EXPANSION = 16.0  # n_elements / nnz beyond which SCS is refused


def _guard_scs_explosion(mtx: MtxData, C: int, sigma: int):
    """Estimate SCS padding before converting; degrade to CRS when the
    chosen (C, sigma) would explode (e.g. power-law rows at a large C: one
    17k-nnz row inflates its whole chunk). The reference would happily
    allocate the padding (its sigma exists to fix this); we refuse to hang
    and fall back with a warning."""
    if C <= 1 or mtx.nnz == 0:
        return C, sigma
    counts = np.bincount(mtx.I, minlength=mtx.n_rows).astype(np.int64)
    n_pad = ((mtx.n_rows + C - 1) // C) * C
    counts = np.pad(counts, (0, n_pad - counts.size))
    if sigma > 1:
        # sigma-window descending sort, window-aligned like the converter
        # (vectorized: pad to a multiple of sigma and sort each window row)
        n_sig = ((n_pad + sigma - 1) // sigma) * sigma
        w = np.pad(counts, (0, n_sig - counts.size)).reshape(-1, sigma)
        counts = -np.sort(-w, axis=1).reshape(-1)[:n_pad]
    est = int(counts.reshape(-1, C).max(axis=1).sum()) * C
    if est > mtx.nnz * MAX_SCS_EXPANSION and est > (1 << 24):
        import warnings

        warnings.warn(
            f"SCS with C={C}, sigma={sigma} would pad {mtx.nnz} nonzeros to "
            f"{est} elements ({est / mtx.nnz:.0f}x); falling back to CRS. "
            "Increase sigma (row sorting) or use a smaller C for this "
            "matrix.",
            stacklevel=3,
        )
        return 1, 1
    return C, sigma


def impl_for(config: Config, platform: str):
    """Kernel implementation (reference SpmvKernel ctor decision tree,
    classes_structs.hpp:435-688, collapsed): the SELL-C-sigma Triton
    kernel on a GPU, XLA's tiled (scs) or flat (crs) path elsewhere or
    with ``-impl xla``. Returns (fn(dev, x) -> y, name, streamed layout)."""
    if config.impl == "auto" and platform == "gpu":
        from ..ops.spmv_triton import spmv_triton

        return spmv_triton, "triton-scs", "scs"
    if config.kernel_format == "crs":
        return spmv_flat, "xla-flat-crs", "flat"
    return spmv_tiled, "xla-tiled-scs", "tiled"


def split_threshold(mtx: MtxData, config: Config) -> int:
    """Heavy-row split threshold: the configured one, or for 0 (auto)
    four times the mean row length, clamped to [32, 1024]."""
    th = config.split_rows_threshold
    if th == 0:
        mean = max(mtx.nnz // max(mtx.n_rows, 1), 1)
        th = int(min(max(4 * mean, 32), 1024))
    return th


@dataclasses.dataclass
class SpmvOperator:
    config: Config
    n_rows: int
    n_rows_padded: int
    scs: Dict[str, ScsData]  # host structs per precision
    devs: Dict[str, DeviceScs]  # device structs per precision
    old_to_new: np.ndarray
    matrix_stats: tuple
    nnz: int
    n_dropped: int = 0
    jacobi_diag: Optional[np.ndarray] = None
    equilib: Optional[tuple] = None
    device: Optional[object] = None
    # heavy-row splitting: (virtual_pos, parent_pos) in permuted row space;
    # each SpMV adds y[virtual_pos] into y[parent_pos]
    split_plan: Optional[tuple] = None
    _jit_spmv: Optional[object] = None

    # ----------------------------------------------------------------- build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "SpmvOperator":
        config.validate()
        mtx = mtx.copy()
        if not mtx.is_sorted:
            mtx = mtx.sort_by_row()
        stats = extract_matrix_min_mean_max(mtx)

        jac = None
        if config.jacobi_scale:
            jac = jacobi_scale_matrix(mtx)
        equilib = None
        lr = lc = None
        if config.equilibrate:
            lr, lc = equilibrate_matrix(mtx)
            equilib = (lr, lc)

        C = config.chunk_size if config.kernel_format == "scs" else 1
        sigma = config.sigma if config.kernel_format == "scs" else 1

        # heavy-row splitting (after scaling, which is per ORIGINAL row;
        # before conversion, whose padding it is there to bound)
        n_real = mtx.n_rows
        split_parent = None
        if C > 1 and config.split_rows_threshold >= 0:
            mtx, split_parent = split_heavy_rows(
                mtx, split_threshold(mtx, config)
            )
        C, sigma = _guard_scs_explosion(mtx, C, sigma)

        n_dropped = 0
        scs: Dict[str, ScsData] = {}
        if config.is_ap:
            subs, n_dropped = partition_precisions(
                mtx,
                config.value_type,
                config.ap_threshold_1,
                config.ap_threshold_2,
                equilibrate=config.equilibrate,
                largest_row_elems=lr,
                largest_col_elems=lc,
                dropout=config.dropout,
                dropout_threshold=config.dropout_threshold,
            )
            # highest precision defines the permutation; the rest reuse it
            # (reference main.cpp:1170-1221)
            precs = list(subs)
            primary = convert_to_scs(subs[precs[0]], C, sigma)
            scs[precs[0]] = primary
            for p in precs[1:]:
                scs[p] = convert_to_scs(
                    subs[p], C, sigma,
                    fixed_permutation=primary.old_to_new_idx,
                )
        else:
            prec = config.value_type
            scs[prec] = convert_to_scs(mtx.astype(dtype_for(prec)), C, sigma)

        primary = next(iter(scs.values()))
        old_to_new = primary.old_to_new_idx
        split_plan = None
        if split_parent is not None:
            virt_ids = np.arange(n_real, mtx.n_rows, dtype=np.int64)
            split_plan = (old_to_new[virt_ids], old_to_new[split_parent])
        # symmetric column permutation so x can live in permuted order
        # (reference main.cpp:1308 -> permute_scs_cols)
        full_perm = np.arange(primary.n_rows_padded, dtype=np.int32)
        full_perm[: primary.n_rows] = old_to_new
        for s in scs.values():
            permute_scs_cols(s, full_perm)

        device = resolve_device(config)
        devs = {p: build_device_scs(s, device=device) for p, s in scs.items()}
        return cls(
            config=config,
            n_rows=n_real,
            n_rows_padded=primary.n_rows_padded,
            scs=scs,
            devs=devs,
            old_to_new=old_to_new[:n_real],
            matrix_stats=stats,
            split_plan=split_plan,
            nnz=mtx.nnz,
            n_dropped=n_dropped,
            jacobi_diag=jac,
            equilib=equilib,
            device=device,
        )

    # ------------------------------------------------------------- execution

    @property
    def working_dtype(self):
        return self.config.working_dtype()

    @property
    def kernel_args(self):
        return {"devs": self.devs}

    def _impl(self):
        return impl_for(self.config, self.device.platform)

    def build_spmv_closure(self):
        """The unjitted spmv function ``fn(kernel_args, x)`` (precisions
        summed for AP; a colwise block vector runs transposed through the
        same rowwise kernels, one matrix stream for all columns).

        Device arrays flow in as ARGUMENTS, never as closure captures —
        jit would embed captured arrays as constants in the executable.
        """
        impl = self._impl()[0]
        colwise = (self.config.block_vec_size > 1
                   and self.config.vector_layout == "colwise")
        split = self.split_plan
        if split is not None:
            vp, pp = split
            sorted_pp = bool(np.all(np.diff(pp) >= 0))

        def one(args, x):
            y = None
            for dev in args["devs"].values():
                yk = impl(dev, x)
                y = yk if y is None else y + yk
            if split is not None:
                # fold the virtual-row partials into their parents
                y = y.at[pp].add(
                    y[vp], indices_are_sorted=sorted_pp,
                    mode="promise_in_bounds",
                )
            return y

        if colwise:
            return lambda args, x: one(args, x.T).T
        return one

    def _spmv_fn(self):
        if self._jit_spmv is None:
            self._jit_spmv = jax.jit(self.build_spmv_closure())
        return self._jit_spmv

    def spmv(self, x: jax.Array) -> jax.Array:
        """One y = A x in device layout (permuted/padded)."""
        return self._spmv_fn()(self.kernel_args, x)

    def _solve_fn(self):
        if getattr(self, "_jit_solve", None) is None:
            fn = self.build_spmv_closure()

            def solve(args, x, n):
                def body(carry, _):
                    x, _y = carry
                    return (fn(args, x), x), None

                (x_fin, y_fin), _ = jax.lax.scan(
                    body, (x, jnp.zeros_like(x)), None, length=n
                )
                return y_fin, x_fin

            self._jit_solve = jax.jit(solve, static_argnums=2)
        return self._jit_solve

    def solve(self, x: jax.Array, n_repetitions: int) -> tuple:
        """Solve mode: n_repetitions of y = A x with x<->y swap (reference
        main.cpp:528-607 + swap_local_vectors). Returns (x_last_input,
        y_result) after the final iteration, device layout."""
        return self._solve_fn()(self.kernel_args, x, n_repetitions)

    # ------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None) -> jax.Array:
        host = init_x_host(
            self.config,
            self.n_rows,
            self.matrix_stats,
            x_in=x_in,
            dtype=self.working_dtype,
        )
        dev = to_device_layout(
            host, self.config.vector_layout, self.n_rows_padded, self.old_to_new
        )
        return jax.device_put(dev, self.device)

    def to_host(self, y: jax.Array) -> np.ndarray:
        return from_device_layout(
            np.asarray(y), self.config.vector_layout, self.old_to_new
        )

    # ------------------------------------------------------------- metrics

    def flops_per_spmv(self) -> int:
        """Useful flops only, padding excluded (reference main.cpp:521-526)."""
        return 2 * (self.nnz) * self.config.block_vec_size

    def bytes_per_spmv(self) -> int:
        """Minimum traffic: matrix stream + x + y (reference memory
        footprint accounting, main.cpp:655-668)."""
        layout = self._impl()[2]
        total = sum(d.stream_bytes(layout) for d in self.devs.values())
        bs = self.config.block_vec_size
        xw = np.dtype(self.working_dtype).itemsize
        total += self.n_rows_padded * bs * xw * 2
        return total

    def beta(self) -> Dict[str, float]:
        """Fill efficiency of the (C, sigma) format (reference
        main.cpp:693); device_beta() is what the chosen kernel streams."""
        return {p: s.beta for p, s in self.scs.items()}

    def device_beta(self) -> Dict[str, float]:
        layout = self._impl()[2]
        return {p: d.device_beta(layout) for p, d in self.devs.items()}

    def nnz_per_precision(self) -> Dict[str, int]:
        return {p: s.nnz for p, s in self.scs.items()}

    def comm_volume_per_spmv(self) -> dict:
        return {}

    def impl_name(self) -> str:
        """Which kernel implementation executes (printed in the bench
        block)."""
        return self._impl()[1]

    def per_shard_nnz(self):
        return None

    def dump_sparsity(self, outdir: str) -> list:
        """OUTPUT_SPARSITY analogue (reference main.cpp:1225-1254): dump each
        precision's SCS struct back to .mtx in original row/col indices."""
        import os

        primary = next(iter(self.scs.values()))
        paths = []
        for p, s in self.scs.items():
            path = os.path.join(outdir, f"{p}_local_scs.mtx")
            s.write_to_mtx_file(path, col_unperm=primary.new_to_old_idx)
            paths.append(path)
        return paths
