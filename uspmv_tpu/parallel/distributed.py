"""Distributed SpMV over a 1-D JAX device mesh.

Re-design of the reference's MPI execution model (SURVEY.md §2 parallelism
table): 1-D row partitioning (seg-rows/seg-nnz/seg-metis) across a
``Mesh(..., ('rows',))``; remote x entries are deduplicated, renumbered into
a per-shard halo appended after the local (padded) rows, and exchanged each
iteration through a static schedule of ``ppermute`` rounds, which XLA hands
to NCCL (reference Isend/Irecv halo exchange, classes_structs.hpp:857-995).
The pack step (pack_send_buf) is the gather by precomputed send indices; the
recv-into-halo is a scatter at precomputed halo positions; ring offsets with
zero traffic are pruned from the schedule at plan time.

Comm modes (reference MPI_MODE, Makefile:199-218):
  bulkvec   : one exchange carries all RHS columns (rowwise block vectors)
  singlevec/multivec : per-vector exchange in the reference; a colwise
              block vector here runs transposed through the same single
              exchange, so all three reduce to the same schedule
  allgather : no halo plan — all-gather the permuted local x blocks and
              gather columns from the concatenation (robust baseline; this
              mode has no reference analogue)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import Config, dtype_for
from ..formats.coo import (
    MtxData,
    equilibrate_matrix,
    extract_matrix_min_mean_max,
    generate_inv_perm,
    jacobi_scale_matrix,
)
from ..formats.scs import ScsData, convert_to_scs
from ..ops.device_format import DeviceScs, build_device_scs
from ..ops.vectors import init_x_host
from ..precision.partition import partition_precisions
from ..runtime.operator import impl_for, resolve_device
from .halo import HaloPlan, build_allgather_col_map, build_halo_plan
from .partition import seg_work_sharing


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma=False: pallas_call out_shapes carry no varying-mesh-axes
    # annotation, and the halo exchange's ppermutes make the data movement
    # explicit anyway
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def _stack_device_scs(devs: List[DeviceScs]) -> DeviceScs:
    """Pad per-shard device structs to common shapes and stack on a new
    leading 'rows' axis. Padding elements are (value 0, col 0) pointed at a
    padding row, and padding chunks have length 0, so they contribute
    nothing."""
    n_loc = max(d.n_rows_padded for d in devs)
    n_chunks = max(d.n_chunks for d in devs)
    E = max(d.values.shape[0] for d in devs)
    NT = max(d.t_values.shape[0] for d in devs)
    jt, C = devs[0].jt, devs[0].C

    def pad1(a, n, fill=0):
        return np.pad(np.asarray(a), (0, n - a.shape[0]), constant_values=fill)

    vals, cols, rows, ptrs, lens, tv, tc, tchunk = ([] for _ in range(8))
    for d in devs:
        vals.append(pad1(d.values, E))
        cols.append(pad1(d.col_idxs, E))
        rows.append(pad1(d.row_idxs, E, fill=n_loc - 1))
        ptrs.append(pad1(d.chunk_ptrs, n_chunks + 1, fill=0))
        lens.append(pad1(d.chunk_lengths, n_chunks))
        ntd = d.t_values.shape[0]
        tv.append(
            np.pad(np.asarray(d.t_values), ((0, NT - ntd), (0, 0), (0, 0)))
        )
        tc.append(
            np.pad(np.asarray(d.t_col_idxs), ((0, NT - ntd), (0, 0), (0, 0)))
        )
        tchunk.append(pad1(d.t_chunk, NT, fill=n_chunks - 1))
    return DeviceScs(
        values=jnp.asarray(np.stack(vals)),
        col_idxs=jnp.asarray(np.stack(cols)),
        row_idxs=jnp.asarray(np.stack(rows)),
        chunk_ptrs=jnp.asarray(np.stack(ptrs)),
        chunk_lengths=jnp.asarray(np.stack(lens)),
        t_values=jnp.asarray(np.stack(tv)),
        t_col_idxs=jnp.asarray(np.stack(tc)),
        t_chunk=jnp.asarray(np.stack(tchunk)),
        C=C,
        jt=jt,
        n_rows=sum(d.n_rows for d in devs),
        n_rows_padded=n_loc,
        n_chunks=n_chunks,
        n_elements=sum(d.n_elements for d in devs),
        nnz=sum(d.nnz for d in devs),
    )


@dataclasses.dataclass
class _PrecPlan:
    """Static + array data for one precision's halo exchange."""

    H: int  # x-buffer length (dump slot at H)
    offsets: List[int]
    gathers: List[jax.Array]  # per offset: [R, max_d] int32
    scatters: List[jax.Array]  # per offset: [R, max_d] int32


def _split_scs_for_overlap(scs: ScsData):
    """Split a halo-renumbered local SCS into (interior, halo) element
    structs over the same permuted row space (comm/compute overlap,
    SURVEY.md §7 stage 8: interior SpMV runs while ppermutes are in
    flight). Returns (interior ScsData, halo ScsData)."""
    boundary = scs.n_rows_padded
    keep = ~scs.padding_mask()
    rows = scs.flat_row_idx()
    is_halo = keep & (scs.col_idxs >= boundary)
    is_int = keep & ~is_halo
    n_cols = max(int(scs.col_idxs.max(initial=0)) + 1, boundary)
    ident = np.arange(scs.n_rows_padded, dtype=np.int32)

    def build(mask):
        sub = MtxData.from_arrays(
            rows[mask], scs.col_idxs[mask], scs.values[mask],
            n_rows=scs.n_rows_padded, n_cols=n_cols,
        )
        return convert_to_scs(sub, scs.C, 1, fixed_permutation=ident)

    return build(is_int), build(is_halo)


@dataclasses.dataclass
class DistributedSpmvOperator:
    """Drop-in sharded analogue of SpmvOperator (same public surface)."""

    config: Config
    mesh: Mesh
    n_rows: int
    n_rows_padded: int  # common per-shard local padded length
    work_sharing: np.ndarray
    scs: Dict[str, List[ScsData]]  # per precision, per shard (host)
    devs: Dict[str, DeviceScs]  # stacked [R, ...] (interior when overlapped)
    devs_halo: Dict[str, Optional[DeviceScs]]  # halo-column elements, or None
    plans: Dict[str, Optional[_PrecPlan]]
    halo_plans: Dict[str, Optional[HaloPlan]]
    shard_perms: List[np.ndarray]  # per-shard old_to_new (local rows)
    global_perm: Optional[np.ndarray]  # seg-metis permutation (old->new)
    matrix_stats: tuple
    nnz: int
    n_dropped: int = 0
    _jit_spmv: Optional[object] = None

    # ------------------------------------------------------------------ build

    @classmethod
    def from_mtx(cls, config: Config, mtx: MtxData) -> "DistributedSpmvOperator":
        config.validate()
        R = config.n_shards
        mtx = mtx.copy()
        if not mtx.is_sorted:
            mtx = mtx.sort_by_row()
        stats = extract_matrix_min_mean_max(mtx)

        ws, gperm = seg_work_sharing(mtx, R, config.seg_method)
        if gperm is not None:
            mtx = mtx.permute(gperm, None).sort_by_row()

        if config.jacobi_scale:
            jacobi_scale_matrix(mtx)
        lr = lc = None
        if config.equilibrate:
            # the reference equilibrates each rank's local rows with local
            # column maxima; we scale globally (identical row scaling —
            # rows are disjoint — and cleaner column scaling)
            lr, lc = equilibrate_matrix(mtx)

        C = config.chunk_size if config.kernel_format == "scs" else 1
        sigma = config.sigma if config.kernel_format == "scs" else 1

        # --- per-shard local COO (global cols) -> per-precision SCS ---
        precisions = config.ap_precisions
        scs: Dict[str, List[ScsData]] = {p: [] for p in precisions}
        shard_perms: List[np.ndarray] = []
        n_dropped = 0
        for r in range(R):
            local = mtx.slice_rows(int(ws[r]), int(ws[r + 1]))
            if config.is_ap:
                subs, dr = partition_precisions(
                    local,
                    config.value_type,
                    config.ap_threshold_1,
                    config.ap_threshold_2,
                    equilibrate=config.equilibrate,
                    largest_row_elems=lr[ws[r] : ws[r + 1]] if lr is not None else None,
                    largest_col_elems=lc,
                    dropout=config.dropout,
                    dropout_threshold=config.dropout_threshold,
                )
                n_dropped += dr
                primary = convert_to_scs(subs[precisions[0]], C, sigma)
                scs[precisions[0]].append(primary)
                for p in precisions[1:]:
                    scs[p].append(
                        convert_to_scs(
                            subs[p], C, sigma,
                            fixed_permutation=primary.old_to_new_idx,
                        )
                    )
            else:
                p = precisions[0]
                scs[p].append(
                    convert_to_scs(local.astype(dtype_for(p)), C, sigma)
                )
            shard_perms.append(scs[precisions[0]][r].old_to_new_idx)

        n_loc = max(s.n_rows_padded for s in scs[precisions[0]])

        # --- communication plan + column renumbering (per precision) ---
        plans: Dict[str, Optional[_PrecPlan]] = {}
        halo_plans: Dict[str, Optional[HaloPlan]] = {}
        for p in precisions:
            # lower-precision structs share the shard's row permutation but
            # have their own column sets, hence their own plan
            if config.comm_mode == "allgather":
                build_allgather_col_map(scs[p], ws, stride=n_loc)
                plans[p] = None
                halo_plans[p] = None
            else:
                hp = build_halo_plan(scs[p], ws)
                halo_plans[p] = hp
                plans[p] = _PrecPlan(
                    H=max(hp.H, n_loc),
                    offsets=list(hp.offsets),
                    gathers=[jnp.asarray(hp.send_gather_idx[d]) for d in hp.offsets],
                    scatters=[jnp.asarray(hp.recv_scatter_idx[d]) for d in hp.offsets],
                )

        overlap = config.overlap_comm and config.comm_mode != "allgather"

        def stack(structs):
            return _stack_device_scs([build_device_scs(s) for s in structs])

        devs: Dict[str, DeviceScs] = {}
        devs_halo: Dict[str, Optional[DeviceScs]] = {}
        for p in precisions:
            devs_halo[p] = None
            if overlap:
                pairs = [_split_scs_for_overlap(s) for s in scs[p]]
                devs[p] = stack([a for a, _ in pairs])
                if any(b.nnz for _, b in pairs):
                    devs_halo[p] = stack([b for _, b in pairs])
            else:
                devs[p] = stack(scs[p])

        mesh = Mesh(_mesh_devices(config, R), ("rows",))
        op = cls(
            config=config,
            mesh=mesh,
            n_rows=mtx.n_rows,
            n_rows_padded=n_loc,
            work_sharing=ws,
            scs=scs,
            devs=devs,
            devs_halo=devs_halo,
            plans=plans,
            halo_plans=halo_plans,
            shard_perms=shard_perms,
            global_perm=gperm,
            matrix_stats=stats,
            nnz=mtx.nnz,
            n_dropped=n_dropped,
        )
        op._place()
        return op

    def _place(self):
        """Shard the stacked arrays over the mesh."""
        sh = NamedSharding(self.mesh, P("rows"))
        self.devs = {
            p: jax.tree.map(lambda a: jax.device_put(a, sh), d)
            for p, d in self.devs.items()
        }
        self.devs_halo = {
            p: (jax.tree.map(lambda a: jax.device_put(a, sh), d)
                if d is not None else None)
            for p, d in self.devs_halo.items()
        }
        for p, plan in self.plans.items():
            if plan is not None:
                plan.gathers = [jax.device_put(g, sh) for g in plan.gathers]
                plan.scatters = [jax.device_put(s, sh) for s in plan.scatters]

    # -------------------------------------------------------------- execution

    @property
    def working_dtype(self):
        return self.config.working_dtype()

    @property
    def R(self) -> int:
        return self.config.n_shards

    def _exchange(self, x_loc, plan: Optional[_PrecPlan], gathers, scatters):
        """Inside shard_map: local x [n_loc(, bs)] -> gatherable x buffer.

        bulkvec halo exchange: pack (gather) -> ppermute per ring offset ->
        scatter into halo region; padding lanes land in the dump slot at H.
        allgather mode: all-gather the local blocks.
        """
        R = self.R
        cfg = self.config
        if plan is None:  # allgather mode
            xg = jax.lax.all_gather(x_loc, "rows", axis=0, tiled=False)
            return xg.reshape((-1,) + x_loc.shape[1:])
        H = plan.H
        pad = [(0, H + 1 - x_loc.shape[0])] + [(0, 0)] * (x_loc.ndim - 1)
        xb = jnp.pad(x_loc, pad)
        if not cfg.comm_halos:
            return xb  # benchmark knob: skip communication entirely
        for d, gather, scatter in zip(plan.offsets, gathers, scatters):
            if cfg.no_pack:
                # perf experiment (reference -no_pack): send a contiguous
                # slice instead of packing — results are wrong on purpose
                buf = jax.lax.dynamic_slice_in_dim(xb, 0, gather.shape[0], 0)
            else:
                buf = jnp.take(xb, gather, axis=0)
            perm = [(r, (r + d) % R) for r in range(R)]
            buf = jax.lax.ppermute(buf, "rows", perm)
            xb = xb.at[scatter].set(buf, mode="drop")
        return xb

    @property
    def kernel_args(self):
        """Device-array pytree passed as a jit ARGUMENT (closure captures
        would be embedded in the executable as constants)."""
        plan_arrays = {
            p: {
                "g": (self.plans[p].gathers if self.plans[p] else []),
                "s": (self.plans[p].scatters if self.plans[p] else []),
            }
            for p in self.devs
        }
        return (self.devs, self.devs_halo, plan_arrays)

    def _impl(self):
        return impl_for(self.config, self.mesh.devices.flat[0].platform)

    def build_spmv_closure(self):
        """Raw (unjitted) sharded step fn(args, x):
        [R, n_loc(, bs)] -> [R, n_loc(, bs)] (colwise: [bs, R, n_loc])."""
        cfg = self.config
        impl = self._impl()[0]
        precisions = list(self.devs)
        n_loc = self.n_rows_padded

        def shard_fn(x_blk, devs_blk, halo_blk, plan_arrays):
            # shard_map gives blocks with leading dim 1
            x = x_blk[0]
            y = None
            for p in precisions:
                dev = jax.tree.map(lambda a: a[0], devs_blk[p])
                plan = self.plans[p]
                ga = [a[0] for a in plan_arrays[p]["g"]]
                sc = [a[0] for a in plan_arrays[p]["s"]]
                halo = halo_blk.get(p)
                if halo is not None:
                    # comm/compute overlap: the interior part reads only
                    # local x, so XLA schedules it while the ppermutes of
                    # _exchange are in flight (async collectives); the small
                    # halo part runs after the exchange completes
                    halo_dev = jax.tree.map(lambda a: a[0], halo)
                    yk = impl(dev, x)[:n_loc]
                    xb = self._exchange(x, plan, ga, sc)
                    yk = yk + impl(halo_dev, xb)[:n_loc]
                else:
                    xb = self._exchange(x, plan, ga, sc)
                    yk = impl(dev, xb)[:n_loc]
                y = yk if y is None else y + yk
            return y[None]

        fn = _shard_map(
            shard_fn,
            self.mesh,
            in_specs=(P("rows"), P("rows"), P("rows"), P("rows")),
            out_specs=P("rows"),
        )

        def step(args, x):
            return fn(x, *args)

        if cfg.block_vec_size > 1 and cfg.vector_layout == "colwise":
            # [bs, R, n_loc] runs as the rowwise [R, n_loc, bs] block
            return lambda args, x: jnp.moveaxis(
                step(args, jnp.moveaxis(x, 0, -1)), -1, 0
            )
        return step

    def _spmv_fn(self):
        if self._jit_spmv is None:
            self._jit_spmv = jax.jit(self.build_spmv_closure())
        return self._jit_spmv

    def spmv(self, x):
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

    def solve(self, x, n_repetitions: int):
        return self._solve_fn()(self.kernel_args, x, n_repetitions)

    # ---------------------------------------------------------------- vectors

    def make_x(self, x_in: Optional[np.ndarray] = None):
        host = init_x_host(
            self.config, self.n_rows, self.matrix_stats,
            x_in=x_in, dtype=self.working_dtype,
        )
        if self.global_perm is not None:
            host = host[generate_inv_perm(self.global_perm)]
        bs = self.config.block_vec_size
        shape = (self.R, self.n_rows_padded) + ((bs,) if bs > 1 else ())
        out = np.zeros(shape, dtype=host.dtype)
        ws = self.work_sharing
        for r in range(self.R):
            lo, hi = int(ws[r]), int(ws[r + 1])
            out[r][self.shard_perms[r]] = host[lo:hi]
        if bs > 1 and self.config.vector_layout == "colwise":
            out = np.moveaxis(out, -1, 0)  # [bs, R, n_loc]
            spec = P(None, "rows")
        else:
            spec = P("rows")
        return jax.device_put(out, NamedSharding(self.mesh, spec))

    def to_host(self, y) -> np.ndarray:
        from .multihost import fetch_global

        # multi-host: shards owned by other processes are gathered first
        # (reference MPI_Gatherv, main.cpp:968-990)
        y = fetch_global(y)
        bs = self.config.block_vec_size
        if bs > 1 and self.config.vector_layout == "colwise":
            y = np.moveaxis(y, 0, -1)  # [R, n_loc, bs]
        out_shape = (self.n_rows,) + y.shape[2:]
        out = np.zeros(out_shape, dtype=y.dtype)
        ws = self.work_sharing
        for r in range(self.R):
            lo, hi = int(ws[r]), int(ws[r + 1])
            out[lo:hi] = y[r][self.shard_perms[r]]
        if self.global_perm is not None:
            out = out[self.global_perm]
        return out

    # ---------------------------------------------------------------- metrics

    def flops_per_spmv(self) -> int:
        return 2 * self.nnz * self.config.block_vec_size

    def bytes_per_spmv(self) -> int:
        layout = self._impl()[2]
        total = 0
        for dev in list(self.devs.values()) + list(self.devs_halo.values()):
            if dev is not None:
                total += dev.stream_bytes(layout)
        xw = np.dtype(self.working_dtype).itemsize
        total += self.R * self.n_rows_padded * self.config.block_vec_size * xw * 2
        return total

    def comm_volume_per_spmv(self) -> dict:
        """Halo elements received per SpMV (reference -print_comm_vol)."""
        out = {}
        for p, hp in self.halo_plans.items():
            if hp is not None:
                out[p] = {
                    "real": hp.comm_volume_per_spmv,
                    "padded": hp.padded_comm_volume_per_spmv,
                    "per_shard": list(map(int, hp.halo_counts)),
                }
            else:
                out[p] = {
                    "real": self.R * self.n_rows_padded * (self.R - 1),
                    "padded": self.R * self.n_rows_padded * (self.R - 1),
                    "per_shard": [self.n_rows_padded * (self.R - 1)] * self.R,
                }
        return out

    def comm_volume_per_host(self) -> dict:
        """Halo elements received per HOST per SpMV (reference per-rank
        -print_comm_vol rolled up to processes; write_results.hpp:141-154).
        Keys are process indices."""
        procs = [d.process_index for d in self.mesh.devices.flat]
        out: Dict[str, dict] = {}
        for p, hp in self.halo_plans.items():
            if hp is None:
                continue
            acc: dict = {}
            for r, h in enumerate(hp.halo_counts):
                acc[int(procs[r])] = acc.get(int(procs[r]), 0) + int(h)
            out[p] = acc
        return out

    def impl_name(self) -> str:
        return self._impl()[1]

    def per_shard_nnz(self) -> list:
        """Useful nonzeros per shard (per-shard gflops in the bench block,
        reference per-rank perf gather, main.cpp:833-890)."""
        R = self.R
        out = [0] * R
        for lst in self.scs.values():
            for r, s in enumerate(lst):
                out[r] += s.nnz
        return out

    def beta(self):
        """Fill efficiency of the (C, sigma) format, averaged over shards."""
        return {
            p: float(np.mean([s.beta for s in lst])) for p, lst in self.scs.items()
        }

    def device_beta(self):
        layout = self._impl()[2]
        return {p: d.device_beta(layout) for p, d in self.devs.items()}

    def nnz_per_precision(self):
        return {p: sum(s.nnz for s in lst) for p, lst in self.scs.items()}

    def dump_sparsity(self, outdir: str) -> list:
        import os

        paths = []
        for p, lst in self.scs.items():
            for r, s in enumerate(lst):
                path = os.path.join(outdir, f"{p}_local_scs_rank{r}.mtx")
                s.write_to_mtx_file(path)
                paths.append(path)
        return paths


def _mesh_devices(config: Config, R: int):
    """R devices of the execution platform for the 'rows' axis. Fewer
    devices than shards is an error; there is no other platform to try."""
    platform = resolve_device(config).platform
    devs = list(jax.devices(platform))
    if len(devs) < R:
        raise ValueError(
            f"need {R} devices on platform {platform!r}, have {len(devs)}"
        )
    return np.array(devs[:R])
