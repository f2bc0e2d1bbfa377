#!/usr/bin/env python
"""Adaptive-precision benchmark.

Measures the reference's headline feature — adaptive mixed precision
(ap_kernels.hpp:24-142, AP split reporting main.cpp:895-905) — on one
device: per value_type, GFLOP/s + effective GB/s + per-precision
nnz%/beta + max relative error of ONE SpMV against the scipy f64 oracle
with random x. dp is native f64; an ap[dp_*] mix accumulates every
partition in f64, like the reference.

Thresholds follow scripts/get_buckets.py: th = tol * ||A||_inf / (0.5*2^-23)
with tol = 1e-14 (th1) / 1e-16 (th2), clamped into the value range so the
split is non-degenerate on narrow-spectrum matrices.

Usage: python scripts/ap_bench.py ['Laplace3D,128'] [--bench_time S]
           [--out FILE.jsonl]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def get_buckets_threshold(mtx, tol: float) -> float:
    """Reference scripts/get_buckets.py: th = tol * ||A||_inf / (0.5*2^-23)."""
    import scipy.sparse as sp

    A = mtx.to_scipy().tocsr()
    inf_norm = float(np.abs(A).sum(axis=1).max())
    return tol * inf_norm / (0.5 * 2.0 ** -23)


def clamp_threshold(mtx, th: float) -> float:
    """Keep the split non-degenerate: on narrow-spectrum matrices (e.g. a
    Laplacian with two magnitudes) the get_buckets formula may land
    outside (min|a|, max|a|]; clamp to the geometric mean of the range
    then (the median can coincide with min on two-valued matrices, which
    would put every element in the high-precision partition)."""
    a = np.abs(mtx.values[mtx.values != 0])
    if a.size == 0:
        return th
    if th <= a.min() or th > a.max():
        return float(np.sqrt(a.min() * a.max()))
    return float(th)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix", nargs="?", default="Laplace3D,128")
    ap.add_argument("--bench_time", type=float, default=1.5)
    ap.add_argument("--out", default=None)
    # get_buckets tolerances; the defaults target f64-level output
    # accuracy. For the wide-spectrum ap[dp_sp_hp] demonstration use
    # --tol1 1e-10 --tol2 1e-13.
    ap.add_argument("--tol1", type=float, default=1e-14)
    ap.add_argument("--tol2", type=float, default=1e-16)
    args = ap.parse_args()

    from uspmv_tpu.cli import load_matrix
    from uspmv_tpu.config import Config
    from uspmv_tpu.runtime.bench import bench_spmv
    from uspmv_tpu.runtime.operator import SpmvOperator

    mtx = load_matrix(args.matrix)
    A = mtx.to_scipy().tocsr().astype(np.float64)
    rng = np.random.default_rng(7)
    x_in = rng.standard_normal(mtx.n_rows)
    y_ref = A @ x_in
    ref_inf = np.abs(y_ref).max()

    th1 = clamp_threshold(mtx, get_buckets_threshold(mtx, args.tol1))
    th2 = clamp_threshold(mtx, get_buckets_threshold(mtx, args.tol2))
    if th2 >= th1:
        th2 = th1 / 2
    print(f"matrix: {args.matrix}  n={mtx.n_rows}  nnz={mtx.nnz}")
    print(f"thresholds (get_buckets-style): th1={th1:.3e} th2={th2:.3e}")

    cases = [
        ("sp", dict(value_type="sp")),
        ("hp", dict(value_type="hp")),
        ("dp", dict(value_type="dp")),
        ("ap[sp_hp]", dict(value_type="ap[sp_hp]", ap_threshold_1=th1)),
        ("ap[dp_sp]", dict(value_type="ap[dp_sp]", ap_threshold_1=th1)),
        ("ap[dp_sp_hp]", dict(value_type="ap[dp_sp_hp]", ap_threshold_1=th1,
                              ap_threshold_2=th2)),
    ]
    hdr = (f"{'value_type':>13} {'GFLOP/s':>8} {'GB/s':>6} "
           f"{'max_rel_err':>11}  nnz% per precision (beta)")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for name, kw in cases:
        cfg = Config(
            kernel_format="scs", chunk_size=32, sigma=1,
            bench_time=args.bench_time, **kw,
        )
        op = SpmvOperator.from_mtx(cfg, mtx)
        # accuracy first (one spmv, random x, vs f64 oracle)
        y = op.to_host(op.spmv(op.make_x(x_in)))
        err = float(np.abs(y - y_ref).max() / ref_inf)
        res = bench_spmv(op, warmup=20, start_iters=32)
        npp = res.nnz_per_precision
        split = "  ".join(
            f"{p}:{100.0 * npp[p] / max(res.nnz, 1):.1f}%"
            f"({res.beta[p]:.3f})"
            for p in npp
        )
        print(f"{name:>13} {res.perf_gflops:8.1f} "
              f"{res.effective_gbps:6.0f} {err:11.2e}  {split}  "
              f"[{res.impl}]")
        rows.append({
            "matrix": args.matrix, "value_type": name,
            "gflops": round(res.perf_gflops, 2),
            "gbps": round(res.effective_gbps, 1),
            "max_rel_err": err,
            "nnz_per_precision": npp,
            "beta": res.beta, "impl": res.impl,
            "platform": res.platform, "device_kind": res.device_kind,
        })
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
