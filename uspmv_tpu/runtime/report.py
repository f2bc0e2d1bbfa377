"""Report writers.

Re-design of the reference's write_results.hpp: append-mode human-readable
blocks for bench results (``spmv_bench.txt``, write_bench_to_file,
write_results.hpp:42-157) and accuracy reports per precision
(``spmv_scipy_compare_{dp,sp,hp,ap}.txt`` — our MKL stand-in is scipy —
write_result_to_file, write_results.hpp:170-434), plus machine-readable
JSON that the reference lacks.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Optional

from ..config import Config
from .bench import BenchResult
from .validate import ValidationReport


def _stamp() -> str:
    return datetime.datetime.now().isoformat(timespec="seconds")


def format_bench_block(cfg: Config, res: BenchResult) -> str:
    lines = [
        "=" * 64,
        f"uspmv_tpu bench @ {_stamp()}",
        f"matrix: {cfg.matrix_file_name or '<generated>'}",
        f"format: {res.kernel_format} C={res.C} sigma={res.sigma} "
        f"value_type={res.value_type} block_vec_size={res.block_vec_size} "
        f"layout={cfg.vector_layout}",
        f"platform: {res.platform} ({res.device_kind})  "
        f"impl: {res.impl or '?'}  "
        f"n_rows: {res.n_rows}  nnz: {res.nnz}",
        f"n_iterations: {res.n_iterations}  kernel_time: "
        f"{res.duration_kernel_s:.4f} s"
        + (
            f" (median of {len(res.timing_samples_s)}: "
            + ", ".join(f"{s:.4f}" for s in res.timing_samples_s) + ")"
            if res.timing_samples_s and len(res.timing_samples_s) > 1
            else ""
        ),
        f"perf: {res.perf_gflops:.3f} GFLOP/s   effective bw: "
        f"{res.effective_gbps:.2f} GB/s",
        f"memory footprint: {res.memory_footprint_bytes / 1e6:.2f} MB",
    ]
    for p in res.beta:
        pct = 100.0 * res.nnz_per_precision[p] / max(res.nnz, 1)
        lines.append(
            f"  [{p}] nnz={res.nnz_per_precision[p]} ({pct:.1f}%) "
            f"beta={res.beta[p]:.4f} device_beta={res.device_beta[p]:.4f}"
        )
    if res.comm_volume_elems:
        lines.append(f"comm volume: {res.comm_volume_elems} halo elems/SpMV")
    if res.n_processes > 1 and res.comm_volume_per_host:
        # multi-process runs: per-process received halo elements
        for p, hosts in res.comm_volume_per_host.items():
            per = "  ".join(
                f"host{h}={v}" for h, v in sorted(hosts.items())
            )
            lines.append(f"  [{p}] halo elems/SpMV per host: {per}")
    if cfg.comm_mode in ("singlevec", "multivec"):
        lines.append(
            f"note: comm_mode={cfg.comm_mode} — under XLA's async execution "
            "the reference's message-batching modes (MPI_MODE, "
            "Makefile:199-218) collapse to one exchange schedule; the only "
            "behavioral split here is per-vector (colwise vmap) vs bulk "
            "(rowwise fused) exchange"
        )
    if cfg.block_vec_size > 1 and cfg.vector_layout == "colwise":
        lines.append(
            f"note: colwise SpMMV streams the matrix once PER RHS vector "
            f"(~{cfg.block_vec_size}x the matrix traffic of rowwise — the "
            "reference's colwise layout has the same property per its "
            "X[vec_len*v + row] indexing, kernels.hpp:68-154); use "
            "-layout rowwise for the fused single-stream kernel"
        )
    if cfg.comm_mode == "graphtopo":
        lines.append(
            "note: comm_mode=graphtopo — the reference's "
            "MPI_Neighbor_alltoallv graph topology (Makefile:199-218) is "
            "implicit here: the static per-ring-offset ppermute schedule "
            "computed at plan time IS the neighbor topology, so this mode "
            "collapses to the bulkvec schedule"
        )
    if res.per_shard and (cfg.verbose or cfg.print_comm_vol):
        # reference -verbose/-print_comm_vol per-rank block
        # (main.cpp:833-890, write_results.hpp:141-154)
        for s in res.per_shard:
            lines.append(
                f"  shard {s['shard']}: nnz={s['nnz']} "
                f"gflops={s['gflops']:.3f} "
                f"halo_elems_recv={s['halo_elems_recv']}"
            )
    lines.append("")
    return "\n".join(lines)


def write_bench_to_file(cfg: Config, res: BenchResult, path: Optional[str] = None) -> str:
    path = path or os.path.join(cfg.output_dir, "spmv_bench.txt")
    with open(path, "a") as f:
        f.write(format_bench_block(cfg, res))
    # machine-readable sibling
    jpath = os.path.splitext(path)[0] + ".jsonl"
    with open(jpath, "a") as f:
        f.write(json.dumps({"ts": _stamp(), **res.to_dict()}) + "\n")
    return path


def format_result_block(cfg: Config, rep: ValidationReport, n_repetitions: int) -> str:
    return "\n".join(
        [
            "=" * 64,
            f"uspmv_tpu solve validation @ {_stamp()}",
            f"matrix: {cfg.matrix_file_name or '<generated>'}",
            f"format: {cfg.kernel_format} C={cfg.chunk_size} sigma={cfg.sigma} "
            f"value_type={cfg.value_type} revs={n_repetitions}",
            f"oracle: scipy.sparse CSR (float64)",
            rep.summary(),
            "",
        ]
    )


def write_result_to_file(
    cfg: Config, rep: ValidationReport, n_repetitions: int, path: Optional[str] = None
) -> str:
    if path is None:
        tag = "ap" if cfg.is_ap else cfg.value_type
        path = os.path.join(cfg.output_dir, f"spmv_scipy_compare_{tag}.txt")
    with open(path, "a") as f:
        f.write(format_result_block(cfg, rep, n_repetitions))
    return path
