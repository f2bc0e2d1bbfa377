"""Pure-XLA SpMV / SpMMV kernels.

These are the portable compute paths (the CPU, and ``-impl xla`` on a
GPU); the Triton kernel in spmv_triton.py implements the same contract in
one pass over the SELL-C-sigma stream. They re-design the reference's
kernel layer (kernels.hpp:22-551, ap_kernels.hpp:21-634) for XLA: the
OpenMP chunk loop becomes whole-array gather/segment ops.

Contracts (all take *permuted, padded* x and produce *permuted, padded* y):

  spmv_flat(dev, x)   — works for any C (CRS = C=1): per-element gather of
                        x[col], multiply, scatter-add by element row.
  spmv_tiled(dev, x)  — SCS-native: [n_tiles, jt, C] bricks, gather +
                        within-tile j-reduction + sorted segment-sum over
                        tiles of the same chunk.

Block vectors (SpMMV, reference block_spmv_*): x may be [n_pad] or
[n_pad, bs] (rowwise layout) / [bs, n_pad] (colwise); see vectors.py.
Low-precision values are multiplied against the high-precision x and
accumulated in x's dtype, matching the reference AP kernels
(ap_kernels.hpp:204: low-prec values x high-prec x, double accumulator).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .device_format import DeviceScs


def _acc_dtype(x_dtype):
    """Accumulation dtype: bf16 inputs accumulate in f32,
    f32/f64 accumulate in themselves (reference accumulates in double)."""
    if x_dtype == jnp.bfloat16:
        return jnp.float32
    return x_dtype


def spmv_flat(dev: DeviceScs, x: jax.Array) -> jax.Array:
    """Gather/scatter SpMV over the flat element stream.

    x: [n_x] or [n_x, bs] (row-major block vector). Returns y of shape
    [n_rows_padded] or [n_rows_padded, bs] in x's dtype.
    """
    acc = _acc_dtype(x.dtype)
    xg = jnp.take(x, dev.col_idxs, axis=0)  # [E_pad(, bs)]
    v = dev.values.astype(acc)
    if x.ndim == 2:
        v = v[:, None]
    prod = v * xg.astype(acc)
    out_shape = (dev.n_rows_padded,) + x.shape[1:]
    y = jnp.zeros(out_shape, dtype=acc)
    y = y.at[dev.row_idxs].add(prod, mode="drop")
    return y.astype(x.dtype)


def spmv_tiled(dev: DeviceScs, x: jax.Array) -> jax.Array:
    """SCS-tiled SpMV: per-tile gather + j-reduction, then a sorted
    segment-sum over the (few) tiles of each chunk."""
    acc = _acc_dtype(x.dtype)
    nt, jt, C = dev.t_values.shape
    cols = dev.t_col_idxs.reshape(-1)
    xg = jnp.take(x, cols, axis=0)  # [nt*jt*C(, bs)]
    v = dev.t_values.astype(acc).reshape(-1)
    if x.ndim == 2:
        bs = x.shape[1]
        prod = v[:, None] * xg.astype(acc)
        partial = prod.reshape(nt, jt, C, bs).sum(axis=1)  # [nt, C, bs]
    else:
        prod = v * xg.astype(acc)
        partial = prod.reshape(nt, jt, C).sum(axis=1)  # [nt, C]
    y_chunks = jax.ops.segment_sum(
        partial,
        dev.t_chunk,
        num_segments=dev.n_chunks,
        indices_are_sorted=True,
    )  # [n_chunks, C(, bs)]
    out_shape = (dev.n_rows_padded,) + x.shape[1:]
    return y_chunks.reshape(out_shape).astype(x.dtype)


def spmv_ap(devs: dict, x: jax.Array, impl=spmv_tiled) -> jax.Array:
    """Adaptive-precision SpMV: sum the per-precision sub-matrix products,
    each computed against the full-precision x (reference execute_two_prec /
    execute_three_prec, classes_structs.hpp:997-1115)."""
    y = None
    for dev in devs.values():
        yk = impl(dev, x)
        y = yk if y is None else y + yk
    return y
