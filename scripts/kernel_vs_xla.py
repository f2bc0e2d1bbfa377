#!/usr/bin/env python
"""Time the SELL-C-sigma Triton kernel against XLA's SpMV paths on a GPU.

End to end through ``bench_spmv`` on one operator build per (matrix,
precision): the kernel (``impl=auto``), XLA's tiled SCS path
(``impl=xla``), and for CRS XLA's flat path, in the order A B B A so a
drift of the card shows. Before timing, each variant's result is compared
with scipy's f64 product. Also measured in the same process: a large
device copy (the attainable-bandwidth reference) and the BCOO/cuSPARSE
baseline.

Usage: python scripts/kernel_vs_xla.py [--bench_time S] [--out FILE.jsonl]
Needs a GPU; prints one JSON line per measurement.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench_time", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from uspmv_tpu.config import Config
    from uspmv_tpu.io.generators import laplace3d, powerlaw_cols
    from uspmv_tpu.ops.spmv_bcoo import BcooSpmvOperator
    from uspmv_tpu.runtime.bench import bench_spmv
    from uspmv_tpu.runtime.operator import SpmvOperator

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    rows = []

    def emit(**rec):
        rec.update(card=card, device_kind=dev.device_kind)
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    # attainable bandwidth: a 2 GiB f32 read + write
    a = jnp.ones(1 << 29, jnp.float32)
    copy = jax.jit(lambda v, s: v * s)
    jax.block_until_ready(copy(a, 1.0))
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        out = copy(a, 1.0)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    emit(case="copy_2GiB", gbps=2 * a.nbytes / dt / 1e9)
    del a, out

    def err(op, mtx_csr, x):
        y = op.to_host(op.spmv(op.make_x(x))).astype(np.float64)
        ref = mtx_csr @ x
        return float(np.abs(y - ref).max() / np.abs(ref).max())

    def variant(op, **cfg_kw):
        return dataclasses.replace(
            op, config=dataclasses.replace(op.config, **cfg_kw),
            _jit_spmv=None,
        )

    def bench(op):
        r = bench_spmv(op, bench_time=args.bench_time, warmup=5,
                       start_iters=16)
        return r.perf_gflops, r.effective_gbps

    makers = {"laplace3d_160": lambda: laplace3d(160),
              "powerlaw_cols_4m": lambda: powerlaw_cols(4_000_000, 8)}
    cases = [
        ("laplace3d_160", "scs", 32, "sp"),
        ("laplace3d_160", "scs", 32, "dp"),
        ("laplace3d_160", "crs", 1, "sp"),
        ("powerlaw_cols_4m", "scs", 32, "sp"),
        ("powerlaw_cols_4m", "scs", 32, "dp"),
    ]
    mtx = A = made = None
    for name, fmt, C, prec in cases:
        if made != name:
            mtx = makers[name]()
            A = mtx.to_scipy().tocsr()
            made = name
        x = np.random.default_rng(0).standard_normal(mtx.n_rows)
        t0 = time.perf_counter()
        op = SpmvOperator.from_mtx(
            Config(kernel_format=fmt, chunk_size=C, value_type=prec), mtx)
        build_s = time.perf_counter() - t0
        ops = {"kernel": op, "xla": variant(op, impl="xla")}
        for k, o in ops.items():
            compiled = jax.jit(o.build_spmv_closure()).lower(
                o.kernel_args, o.make_x()).compile()
            ma = compiled.memory_analysis()
            emit(case=name, prec=prec, fmt=fmt, C=C, impl=o.impl_name(),
                 max_rel_err=err(o, A, x), build_s=build_s,
                 temp_bytes=getattr(ma, "temp_size_in_bytes", None),
                 arg_bytes=getattr(ma, "argument_size_in_bytes", None),
                 nnz=o.nnz, n_rows=o.n_rows,
                 bytes_per_spmv=o.bytes_per_spmv())
        for k in ("kernel", "xla", "xla", "kernel"):
            g, b = bench(ops[k])
            emit(case=name, prec=prec, fmt=fmt, C=C, impl=ops[k].impl_name(),
                 gflops=g, gbps=b)
        if prec == "sp" and fmt == "scs":
            bop = BcooSpmvOperator.from_mtx(
                Config(impl="bcoo", value_type=prec), mtx)
            e = err(bop, A, x)
            g, b = bench(bop)
            emit(case=name, prec=prec, impl=bop.impl_name(), max_rel_err=e,
                 gflops=g, gbps=b)
            del bop
        del ops, op
    emit(case="peak_memory",
         peak_bytes_in_use=(dev.memory_stats() or {}).get(
             "peak_bytes_in_use"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
