"""SELL-C-sigma SpMV / SpMMV kernel for NVIDIA GPUs (Pallas, Triton route).

The design of the reference's ``scs_impl_gpu<C>`` (kernels.hpp:685-754):
one thread per row. Each program owns ``ROWS`` consecutive rows of the
permuted row space, i.e. ``ROWS / C`` whole chunks when C divides ROWS.
A row walks its chunk's own length over the column-major element stream,
so at every step the threads of one chunk read consecutive values and
column indices (coalesced), gather x through the cache with array-indexed
loads, and accumulate in registers. Each row is stored once, no atomics.
At C >= 32 the value and index streams are loaded with L2 policy
evict-first, which keeps x resident for its gathers (measured on an H100
at 400 W: powerlaw_cols(4M, 8) sp 126 -> 175 GFLOP/s, the stencil
unchanged).

The matrix is the flat element stream of ``DeviceScs`` (values / col_idxs
in ``convert_to_scs`` order) plus its chunk pointers and chunk lengths, so
nothing is packed beyond the SELL-C-sigma format itself and every element
is read once. Any C works (CRS is C = 1); σ-sorting keeps the rows of a
program at similar lengths, which bounds the masked tail of the loop.

Block vectors are row-major ``[n, bs]``: one matrix stream serves all bs
right-hand sides; bs is padded to a power of two inside the kernel and
masked. Accumulation is in x's dtype (f32 for sp/hp, f64 for dp), low-
precision values widened on load — the reference AP kernels' rule
(ap_kernels.hpp:204). No matrix product is involved, so no tensor-core
precision setting applies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .device_format import DeviceScs

ROWS = 128  # rows per program: one row per thread at 4 warps
NUM_WARPS = 4
# From this chunk height on, one step of a chunk reads whole 128-byte lines
# of the index stream that no later step reuses, so the stream is loaded
# evict-first and the L2 keeps x for its gathers. Below it a row's next
# elements share the line (CRS: a row is contiguous), and evicting early
# costs: measured on an H100 at 400 W, CRS 230 -> 218 GFLOP/s.
EVICT_FIRST_MIN_C = 32


def _acc_dtype(x_dtype):
    return jnp.float32 if jnp.dtype(x_dtype).itemsize < 4 else x_dtype


def _kernel(ptr_ref, len_ref, val_ref, col_ref, x_ref, y_ref, *,
            C: int, n_rows: int, bs: int, bs_pad: int, acc_dtype):
    r = pl.program_id(0) * ROWS + jnp.arange(ROWS, dtype=jnp.int32)
    live = r < n_rows
    chunk = jnp.where(live, r // C, 0)
    base = plgpu.load(ptr_ref.at[chunk]) + (r - chunk * C)
    length = jnp.where(live, plgpu.load(len_ref.at[chunk]), 0)
    if bs > 1:
        k = jnp.arange(bs_pad, dtype=jnp.int32)[None, :]
        kmask = k < bs
        acc0 = jnp.zeros((ROWS, bs_pad), acc_dtype)
    else:
        acc0 = jnp.zeros((ROWS,), acc_dtype)

    evict = "evict_first" if C >= EVICT_FIRST_MIN_C else None

    def body(j, acc):
        off = base + j * C
        m = j < length
        v = plgpu.load(val_ref.at[off], mask=m, other=0,
                       eviction_policy=evict).astype(acc_dtype)
        c = plgpu.load(col_ref.at[off], mask=m, other=0,
                       eviction_policy=evict)
        if bs > 1:
            xv = plgpu.load(x_ref.at[c[:, None] * bs + k],
                            mask=m[:, None] & kmask, other=0)
            return acc + v[:, None] * xv.astype(acc_dtype)
        xv = plgpu.load(x_ref.at[c], mask=m, other=0)
        return acc + v * xv.astype(acc_dtype)

    acc = jax.lax.fori_loop(0, jnp.max(length), body, acc0)
    if bs > 1:
        plgpu.store(y_ref.at[r[:, None] * bs + k], acc.astype(y_ref.dtype),
                    mask=live[:, None] & kmask)
    else:
        plgpu.store(y_ref.at[r], acc.astype(y_ref.dtype), mask=live)


def spmv_triton(dev: DeviceScs, x: jax.Array, interpret: bool = False):
    """y = A x on the SELL-C-sigma element stream. x: [n_x] or [n_x, bs]
    (row-major block vector), permuted and padded like the XLA paths;
    returns [n_rows_padded(, bs)] in x's dtype."""
    n = dev.n_rows_padded
    bs = x.shape[1] if x.ndim == 2 else 1
    out_shape = (n,) + x.shape[1:]
    kernel = functools.partial(
        _kernel, C=dev.C, n_rows=n, bs=bs,
        bs_pad=max(1, 1 << (bs - 1).bit_length()),
        acc_dtype=_acc_dtype(x.dtype),
    )
    y = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n * bs,), x.dtype),
        grid=(pl.cdiv(n, ROWS),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="spmv_scs_triton",
    )(dev.chunk_ptrs, dev.chunk_lengths, dev.values, dev.col_idxs,
      x.reshape(-1))
    return y.reshape(out_shape)
