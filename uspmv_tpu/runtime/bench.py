"""Benchmark harness.

Replicates the reference's measurement methodology (bench_spmv,
main.cpp:50-798; SURVEY.md §6):

  * warm-up repetitions (reference WARM_UP_REPS = 100, main.cpp:22);
  * a doubling timed loop — run n_iter iterations, double n_iter until the
    elapsed time reaches ``bench_time`` (default 5 s, main.cpp:449-519);
  * perf_gflops = nnz * 2 * block_vec_size * n_iter / t / 1e9 — useful
    flops only, padding excluded (main.cpp:521-526);
  * effective GB/s from the same byte accounting the reference uses with
    LIKWID (values + col_idxs streams + x + y, main.cpp:655-668).

Under JAX, iterations run inside one jitted ``fori_loop`` with a dynamic
trip count (no recompiles while doubling) and a per-iteration epsilon added
to x (runtime zeros) so XLA cannot hoist the loop-invariant SpMV out of the
loop. ``block_until_ready`` is the reference's barrier/timing fence. The
record names the platform and device it ran on; only a GPU run's rates are
device numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .operator import SpmvOperator

WARM_UP_REPS = 100  # reference main.cpp:22
_EPS_LEN = 256


@dataclasses.dataclass
class BenchResult:
    """Mirrors the reference Result struct (classes_structs.hpp:1812-1888)."""

    perf_gflops: float
    effective_gbps: float
    duration_total_s: float
    duration_kernel_s: float
    n_iterations: int
    nnz: int
    block_vec_size: int
    value_type: str
    kernel_format: str
    C: int
    sigma: int
    beta: Dict[str, float]
    device_beta: Dict[str, float]
    nnz_per_precision: Dict[str, int]
    memory_footprint_bytes: int
    n_rows: int
    platform: str
    comm_volume_elems: int = 0  # halo elements received per SpMV (distributed)
    impl: str = ""  # kernel implementation actually selected
    device_kind: str = ""  # jax device_kind of the (first) device
    # final-batch timing samples (median is duration_kernel_s)
    timing_samples_s: Optional[list] = None
    # per-shard breakdown (reference per-rank gather, main.cpp:833-890):
    # [{shard, nnz, gflops, halo_elems_recv}]
    per_shard: Optional[list] = None
    # multi-host: halo elements received per process per SpMV
    # {precision: {process_index: elems}} (DCN-traffic proxy)
    comm_volume_per_host: Optional[dict] = None
    n_processes: int = 1

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d


def _make_runner(op: SpmvOperator):
    """jitted (args, x, eps, n) -> y running n chained SpMVs; eps (zeros at
    runtime) varies per iteration to defeat CSE/LICM. All device arrays are
    jit ARGUMENTS, not constants embedded in the executable."""
    fn = op.build_spmv_closure()

    def run(args, x, eps, n):
        y0 = fn(args, x)

        def body(i, y_prev):
            # eps is zero at runtime but unknown to the compiler; the
            # y_prev[0] factor creates a true loop-carried dependence so
            # XLA cannot collapse the counted loop into its last iteration
            s = jnp.ravel(y_prev)[0] * eps[i % _EPS_LEN]
            return fn(args, x + s)

        return jax.lax.fori_loop(1, n, body, y0)

    return jax.jit(run)


def _device_of(op):
    """First device the operator's arrays live on."""
    if getattr(op, "device", None) is not None:
        return op.device
    if getattr(op, "mesh", None) is not None:
        return op.mesh.devices.flat[0]
    return jax.tree.leaves(op.kernel_args)[0].devices().pop()


def bench_solve(
    op: SpmvOperator,
    n_repetitions: int,
    x: Optional[jax.Array] = None,
    bench_time: Optional[float] = None,
    warmup: int = 2,
    timing_reps: int = 3,
) -> BenchResult:
    """Solve-mode benchmark: time y = A^k x with the x<->y swap, the way
    the reference times its solve loop (main.cpp:528-607): one jitted scan
    of k SpMVs per call, the call repeated until a batch of calls reaches
    bench_time. GFLOP/s counts 2*nnz*bs per iteration."""
    if x is None:
        x = op.make_x()
    bench_time = bench_time if bench_time is not None else op.config.bench_time
    solve_fn = op._solve_fn()
    args = op.kernel_args
    k = int(n_repetitions)

    def batch(m):
        t0 = time.perf_counter()
        for _ in range(m):
            out = solve_fn(args, x, k)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    for _ in range(max(warmup, 1)):
        batch(1)  # compile + warm-up
    t_total0 = time.perf_counter()
    m = 1
    while True:
        elapsed = batch(m)
        if elapsed >= bench_time or m >= (1 << 14):
            break
        m *= 2
    samples = [elapsed] + [batch(m) for _ in range(max(timing_reps, 1) - 1)]
    elapsed = float(np.median(samples))
    return _result(op, k * m, elapsed, time.perf_counter() - t_total0,
                   samples, impl="solve-scan[" + op.impl_name() + "]")


def bench_spmv(
    op: SpmvOperator,
    x: Optional[jax.Array] = None,
    bench_time: Optional[float] = None,
    warmup: int = WARM_UP_REPS,
    start_iters: int = 10,
    timing_reps: int = 3,
) -> BenchResult:
    if x is None:
        x = op.make_x()
    bench_time = bench_time if bench_time is not None else op.config.bench_time
    runner = _make_runner(op)
    eps = jnp.zeros((_EPS_LEN,), dtype=x.dtype)
    if getattr(op, "device", None) is not None:
        eps = jax.device_put(eps, op.device)
    args = op.kernel_args

    def batch(n):
        t0 = time.perf_counter()
        jax.block_until_ready(runner(args, x, eps, n))
        return time.perf_counter() - t0

    # warm-up (compile + cache warm), excluded from timing
    batch(min(warmup, 1))
    if warmup > 1:
        batch(warmup)

    n_iter = max(1, start_iters)
    max_iters = 1 << 17
    t_total0 = time.perf_counter()
    while True:
        elapsed = batch(n_iter)
        if elapsed >= bench_time or n_iter >= max_iters:
            break
        n_iter *= 2
    # re-run the final batch and take the median
    samples = [elapsed] + [batch(n_iter) for _ in range(max(timing_reps, 1) - 1)]
    return _result(op, n_iter, float(np.median(samples)),
                   time.perf_counter() - t_total0, samples,
                   impl=op.impl_name())


def _result(op, n_iter, elapsed, t_total, samples, impl) -> BenchResult:
    """GFLOP/s (useful flops, padding excluded) and effective GB/s (the
    operator's byte accounting: matrix stream + x + y) for n_iter SpMVs
    in ``elapsed`` seconds, with the per-shard breakdown when sharded."""
    bs = op.config.block_vec_size
    gflops = 2.0 * op.nnz * bs * n_iter / elapsed / 1e9
    gbps = op.bytes_per_spmv() * n_iter / elapsed / 1e9
    device = _device_of(op)
    comm = op.comm_volume_per_spmv()
    comm_elems = sum(v["real"] for v in comm.values()) if comm else 0
    per_shard = None
    shard_nnz = op.per_shard_nnz()
    if shard_nnz is not None:
        halo_per_shard = [0] * len(shard_nnz)
        for v in comm.values():
            for r, h in enumerate(v.get("per_shard", [])):
                halo_per_shard[r] += h
        per_shard = [
            {
                "shard": r,
                "nnz": int(nz),
                "gflops": 2.0 * nz * bs * n_iter / elapsed / 1e9,
                "halo_elems_recv": halo_per_shard[r],
            }
            for r, nz in enumerate(shard_nnz)
        ]
    return BenchResult(
        perf_gflops=gflops,
        effective_gbps=gbps,
        duration_total_s=t_total,
        duration_kernel_s=elapsed,
        n_iterations=n_iter,
        nnz=op.nnz,
        block_vec_size=bs,
        value_type=op.config.value_type,
        kernel_format=op.config.kernel_format,
        C=op.config.chunk_size,
        sigma=op.config.sigma,
        beta=op.beta(),
        device_beta=op.device_beta(),
        nnz_per_precision=op.nnz_per_precision(),
        memory_footprint_bytes=op.bytes_per_spmv(),
        n_rows=op.n_rows,
        platform=device.platform,
        comm_volume_elems=comm_elems,
        impl=impl,
        device_kind=device.device_kind,
        timing_samples_s=[float(s) for s in samples],
        per_shard=per_shard,
        comm_volume_per_host=(
            op.comm_volume_per_host()
            if hasattr(op, "comm_volume_per_host") else None
        ),
        n_processes=jax.process_count(),
    )
