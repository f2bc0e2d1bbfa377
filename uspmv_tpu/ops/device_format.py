"""Device-resident SCS representation.

The host ``ScsData`` (formats/scs.py) is ragged: chunk c owns
``chunk_lengths[c] * C`` flat elements at ``chunk_ptrs[c]``. XLA wants static
shapes, so the device format re-tiles the flat arrays two ways:

* **flat**: values/col_idxs in ``convert_to_scs`` order plus a precomputed
  per-element (permuted) row index, padded to a multiple of ``tile_elems``.
  Works for any C, including CRS (C=1). SpMV is gather + scatter-add. The
  chunk pointers and chunk lengths travel with it: together they are the
  SELL-C-sigma format itself, which the GPU kernel (spmv_triton.py) walks
  row by row.

* **tiled**: every chunk's length is padded up to a multiple of ``jt``
  (j-positions per tile), after which the element stream is exactly
  ``[n_tiles, jt, C]`` dense — each tile is a (jt, C) brick of one chunk,
  contiguous in memory (the chunk layout is column-major, so consecutive
  flat elements sweep the C rows of one j-position). SpMV is gather +
  within-tile reduction + short sorted segment-sum over tiles. The extra
  padding is reported as ``device_beta`` next to the format's own ``beta``
  (reference main.cpp:693).

This mirrors the roles of the reference's kernel arg marshaling
(assign_spmv_kernel_cpu_data / _gpu_data, utilities.hpp:3125-3299) — wiring
host structures into device-consumable buffers — redesigned for XLA's
static-shape model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.scs import ScsData


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceScs:
    """Device arrays for one (precision's) SCS matrix. A JAX pytree;
    integer/shape metadata is static."""

    # flat layout (padded to tile_elems)
    values: jax.Array  # [E_pad] matrix dtype
    col_idxs: jax.Array  # [E_pad] int32
    row_idxs: jax.Array  # [E_pad] int32 — permuted row of each element
    chunk_ptrs: jax.Array  # [n_chunks + 1] int32 — chunk start in values
    chunk_lengths: jax.Array  # [n_chunks] int32 — elements per chunk row

    # tiled layout (chunk lengths padded to multiples of jt)
    t_values: jax.Array  # [n_tiles, jt, C]
    t_col_idxs: jax.Array  # [n_tiles, jt, C] int32
    t_chunk: jax.Array  # [n_tiles] int32, ascending

    # static metadata
    C: int = dataclasses.field(metadata=dict(static=True))
    jt: int = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    n_rows_padded: int = dataclasses.field(metadata=dict(static=True))
    n_chunks: int = dataclasses.field(metadata=dict(static=True))
    n_elements: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_tiles(self) -> int:
        return self.t_values.shape[0]

    def streamed_elements(self, layout: str = "tiled") -> int:
        """Elements one SpMV reads: the jt-padded tiles (``tiled``) or the
        SELL-C-sigma element stream itself (``flat`` and ``scs``)."""
        return self.t_values.size if layout == "tiled" else self.n_elements

    def stream_bytes(self, layout: str = "tiled") -> int:
        """Matrix bytes one SpMV reads: values + column indices, plus the
        per-element row index for the flat scatter path."""
        per = self.values.dtype.itemsize + 4 + (4 if layout == "flat" else 0)
        return int(self.streamed_elements(layout) * per)

    def device_beta(self, layout: str = "tiled") -> float:
        """nnz / elements the kernel actually streams."""
        n = self.streamed_elements(layout)
        return self.nnz / n if n else 1.0

    @property
    def beta(self) -> float:
        return self.nnz / self.n_elements if self.n_elements else 1.0


def _element_coords(scs: ScsData):
    """(chunk, j, i) of every flat element, vectorized."""
    cp = scs.chunk_ptrs.astype(np.int64)
    e = np.arange(scs.n_elements, dtype=np.int64)
    chunk = np.searchsorted(cp, e, side="right") - 1
    off = e - cp[chunk]
    return chunk, off // scs.C, off % scs.C


def build_device_scs(
    scs: ScsData,
    jt: int = 8,
    tile_elems: int = 1024,
    dtype=None,
    device=None,
) -> DeviceScs:
    """Host ScsData -> DeviceScs (both layouts)."""
    C = scs.C
    vals = scs.values if dtype is None else scs.values.astype(dtype)

    chunk, j, i = _element_coords(scs)

    # --- flat, padded to tile_elems ---
    E = scs.n_elements
    E_pad = max(tile_elems, ((E + tile_elems - 1) // tile_elems) * tile_elems)
    values = np.zeros(E_pad, dtype=vals.dtype)
    values[:E] = vals
    col_idxs = np.zeros(E_pad, dtype=np.int32)
    col_idxs[:E] = scs.col_idxs
    row_idxs = np.full(E_pad, scs.n_rows_padded - 1, dtype=np.int32)
    row_idxs[:E] = (chunk * C + i).astype(np.int32)

    # --- tiled: pad chunk lengths to multiples of jt ---
    lens = scs.chunk_lengths.astype(np.int64)
    lens_pad = np.maximum(jt, ((lens + jt - 1) // jt) * jt)
    tiles_per_chunk = lens_pad // jt
    n_tiles = int(tiles_per_chunk.sum())
    t_chunk = np.repeat(
        np.arange(scs.n_chunks, dtype=np.int32), tiles_per_chunk
    )
    tile_starts = np.concatenate(
        ([0], np.cumsum(tiles_per_chunk))
    ).astype(np.int64)
    # flat destination of element (chunk, j, i) in the [n_tiles, jt, C] array
    dest = (tile_starts[chunk] + j // jt) * (jt * C) + (j % jt) * C + i
    t_values = np.zeros(n_tiles * jt * C, dtype=vals.dtype)
    t_cols = np.zeros(n_tiles * jt * C, dtype=np.int32)
    t_values[dest] = vals
    t_cols[dest] = scs.col_idxs
    t_values = t_values.reshape(n_tiles, jt, C)
    t_cols = t_cols.reshape(n_tiles, jt, C)

    put = lambda a: jax.device_put(a, device) if device else jnp.asarray(a)
    return DeviceScs(
        values=put(values),
        col_idxs=put(col_idxs),
        row_idxs=put(row_idxs),
        chunk_ptrs=put(np.asarray(scs.chunk_ptrs, dtype=np.int32)),
        chunk_lengths=put(np.asarray(scs.chunk_lengths, dtype=np.int32)),
        t_values=put(t_values),
        t_col_idxs=put(t_cols),
        t_chunk=put(t_chunk),
        C=C,
        jt=jt,
        n_rows=scs.n_rows,
        n_rows_padded=scs.n_rows_padded,
        n_chunks=scs.n_chunks,
        n_elements=scs.n_elements,
        nnz=scs.nnz,
    )
