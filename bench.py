"""Headline benchmark.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ...,
"vs_baseline": N, ...}, with the platform, device kind and device count it
ran on.

Benchmark: SELL-C-sigma SpMV (C=32, sigma=1, sp) on a generated 3-D
Laplacian through the normal SpmvOperator path — on a GPU the Triton
kernel (ops/spmv_triton.py). The reference's intended SuiteSparse FEM
workloads are stencil-like; there is no network, so the matrix is
generated.

Metric: SpMV GFLOP/s (the reference's headline, nnz*2/t, main.cpp:521-526).
vs_baseline normalizes by the speed of an IDEAL memory-bound SpMV running
at 80% of the device's HBM bandwidth with the reference's storage
accounting (8 bytes/nonzero: f32 value + i32 column index, plus x and y
once). It is layout-independent: only real speed moves it. The bandwidth
comes from HBM_PEAK_GBPS, keyed by jax's device_kind; an accelerator not
in the table is an error, and a CPU run reports no vs_baseline.

Secondary cells (same JSON line): an FEM matrix, three irregular matrix
classes, a solve-mode run, and the adaptive-precision mixes ap[sp_hp] and
ap[dp_sp] (native f64 for the dp partition).
"""

import json
import sys

# Published HBM bandwidth per device, GB/s (NVIDIA H100 SXM5 data sheet).
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_gbps(device):
    """HBM bandwidth of ``device`` in GB/s; None on the CPU. An
    accelerator that is not in HBM_PEAK_GBPS raises."""
    if device.platform == "cpu":
        return None
    if device.device_kind not in HBM_PEAK_GBPS:
        raise KeyError(
            f"no published HBM bandwidth for {device.device_kind!r}; "
            "add it to bench.HBM_PEAK_GBPS with its source"
        )
    return HBM_PEAK_GBPS[device.device_kind]


def main() -> int:
    import jax

    from uspmv_tpu.config import Config
    from uspmv_tpu.io.generators import (
        banded_imbalanced, fem_tet3d, laplace3d, powerlaw_cols,
        random_imbalanced,
    )
    from uspmv_tpu.runtime.bench import bench_solve, bench_spmv
    from uspmv_tpu.runtime.operator import SpmvOperator

    device = jax.devices()[0]
    peak = peak_gbps(device)
    record = {
        "metric": "scs_spmv_gflops (C=32, sp, Laplace3D-128^3)",
        "value": None,
        "unit": "GFLOP/s",
        "vs_baseline": None,
        "platform": device.platform,
        "device_kind": device.device_kind,
        "device_count": len(jax.devices()),
    }

    def cfg(value_type="sp", sigma=1, bench_time=1.5, **kw):
        return Config(kernel_format="scs", chunk_size=32, sigma=sigma,
                      value_type=value_type, bench_time=bench_time, **kw)

    mtx = laplace3d(128)  # 2.1M rows, 14.6M nnz
    op = SpmvOperator.from_mtx(cfg(bench_time=3.0), mtx)
    res = bench_spmv(op, warmup=20, start_iters=64)
    record.update({
        "value": round(res.perf_gflops, 2),
        "effective_gbps": round(res.effective_gbps, 2),
        "n_iterations": res.n_iterations,
        "impl": res.impl,
    })
    if peak is not None:
        # ideal 80%-of-peak classical SpMV: 8 B per nonzero + x + y once
        ref_bytes = 8.0 * op.nnz + 2 * 4.0 * op.n_rows
        baseline_gflops = 2.0 * op.nnz / (ref_bytes / (0.8 * peak * 1e9)) / 1e9
        record["vs_baseline"] = round(res.perf_gflops / baseline_gflops, 4)

    cells = (
        ("fem_tet3d_55", lambda: fem_tet3d(55), {}),
        ("banded_imbalanced_500k",
         lambda: banded_imbalanced(500_000, bandwidth=64,
                                   avg_nnz_per_row=8, seed=7),
         {"sigma": 128}),
        ("powerlaw_cols_500k", lambda: powerlaw_cols(500_000, 8), {}),
        ("random_imbalanced_500k", lambda: random_imbalanced(500_000, 8),
         {"sigma": 128}),
    )
    for name, make, kw in cells:
        try:
            op2 = SpmvOperator.from_mtx(cfg(**kw), make())
            r2 = bench_spmv(op2, warmup=20, start_iters=64, timing_reps=3)
            record[name + "_gflops"] = round(r2.perf_gflops, 2)
        except Exception as e:  # noqa: BLE001 - one cell must not erase all
            record[name + "_gflops"] = f"error: {str(e)[:120]}"

    # solve mode (-mode s, main.cpp:528-607) on a small FEM matrix, 512
    # repetitions per call
    try:
        opb = SpmvOperator.from_mtx(cfg(), fem_tet3d(9))
        rb = bench_solve(opb, 512)
        record["solve_fem_tet3d_9_gflops"] = round(rb.perf_gflops, 2)
        record["solve_fem_tet3d_9_impl"] = rb.impl
    except Exception as e:  # noqa: BLE001
        record["solve_fem_tet3d_9_gflops"] = f"error: {str(e)[:120]}"

    # adaptive precision — the reference's headline feature
    # (ap_kernels.hpp, AP reporting main.cpp:895-905)
    for name, m, vt in (("ap_sp_hp_gflops", mtx, "ap[sp_hp]"),
                        ("ap_dp_sp_96_gflops", None, "ap[dp_sp]")):
        try:
            op_ap = SpmvOperator.from_mtx(
                cfg(vt, ap_threshold_1=2.44),  # sqrt(1*6)
                m if m is not None else laplace3d(96),
            )
            record[name] = round(
                bench_spmv(op_ap, warmup=20, start_iters=64).perf_gflops, 2
            )
        except Exception as e:  # noqa: BLE001
            record[name] = f"error: {str(e)[:120]}"

    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
