#!/usr/bin/env python
"""Node-performance sweep (reference scripts/check_perf.sh +
SPMMV_bottleneck.sh): benchmark SpMV/SpMMV over C x sigma x precision x
block_vec_size on one device and print a GFLOP/s / effective-GB/s table;
with --out, also appends JSON lines for scraping (the scrape_perf.py
analogue is `jq`). Each row names the device it ran on.

Usage:
  python scripts/perf_sweep.py [matrix.mtx | 'Laplace3D,64'] [--quick]
      [--bs_only] [--bench_time S] [--out FILE.jsonl]
"""

import argparse
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix", nargs="?", default="Laplace3D,64")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--bs_only", action="store_true",
        help="only the block-vector dimension, at C=32 sp")
    ap.add_argument("--bench_time", type=float, default=1.5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from uspmv_tpu.cli import load_matrix
    from uspmv_tpu.config import Config
    from uspmv_tpu.runtime.bench import bench_spmv
    from uspmv_tpu.runtime.operator import SpmvOperator

    mtx = load_matrix(args.matrix)
    print(f"matrix: {args.matrix}  n={mtx.n_rows}  nnz={mtx.nnz}")

    # C = 32 (one warp per chunk) is the GPU kernel's native chunk height;
    # the reference's canonical -c 16 -s 512 and CRS sweep beside it
    if args.bs_only:
        cs = [(32, 1)]
        bss = [1, 4, 8, 16, 32]
        precs = ["sp"]
    elif args.quick:
        cs = [(32, 1)]
        bss = [1, 8]
        precs = ["sp"]
    else:
        cs = [(1, 1), (16, 512), (32, 1), (32, 128)]
        # the reference supports arbitrary block_vec_size
        # (kernels.hpp:306-551)
        bss = [1, 4, 8, 16, 32]
        precs = ["sp", "hp"]

    rows = []
    header = f"{'C':>6} {'sigma':>6} {'prec':>5} {'bs':>3} {'GFLOP/s':>9} {'GB/s':>7} {'us/iter':>8} {'beta':>6}"
    print(header)
    print("-" * len(header))
    for (C, sigma), prec, bs in itertools.product(cs, precs, bss):
        cfg = Config(
            kernel_format="scs" if C > 1 or sigma > 1 else "crs",
            chunk_size=C, sigma=sigma, value_type=prec,
            block_vec_size=bs,
            vector_layout="rowwise" if bs > 1 else "colwise",
            bench_time=args.bench_time,
        )
        try:
            op = SpmvOperator.from_mtx(cfg, mtx)
            res = bench_spmv(op, warmup=10, start_iters=32)
        except Exception as e:  # noqa: BLE001 - sweep keeps going
            print(f"{C:>6} {sigma:>6} {prec:>5} {bs:>3}  FAILED: {e}")
            continue
        us = res.duration_kernel_s / res.n_iterations * 1e6
        beta = next(iter(res.device_beta.values()))
        print(f"{C:>6} {sigma:>6} {prec:>5} {bs:>3} "
              f"{res.perf_gflops:>9.1f} {res.effective_gbps:>7.1f} "
              f"{us:>8.1f} {beta:>6.3f}")
        row = {
            "matrix": args.matrix, "C": C, "sigma": sigma,
            "value_type": prec, "block_vec_size": bs,
            "gflops": round(res.perf_gflops, 2),
            "effective_gbps": round(res.effective_gbps, 2),
            "us_per_iter": round(us, 2),
            "device_beta": round(beta, 4),
            "platform": res.platform,
            "device_kind": res.device_kind,
            "impl": res.impl,
        }
        rows.append(row)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"\n{len(rows)} results appended to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
