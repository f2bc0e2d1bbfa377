#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, at a size users run.

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # the 4-shard path on four GPUs, only

Phases (any failure raises: non-zero exit, no result line):
  1. device: jax.devices() and the card's name and power limit; fails
     unless the platform is 'gpu';
  2. kernels against the plain reference: every SpMV implementation that
     ships (the SELL-C-sigma Triton kernel, XLA's tiled path, the BCOO /
     cuSPARSE baseline) against scipy's f64 product on laplace3d(160)
     (4.1M rows, 28M nnz) and powerlaw_cols(4M, 8) — both matrix streams
     are over 4x the card's 50 MB L2 — at the unit tolerances of
     runtime/validate.py (max |y - y_ref| / max |y_ref|); on the stencil
     also hp, ap[dp_sp], ap[sp_hp] and a rowwise block vector (bs=8), and
     the sp step's HLO is checked for 64-bit types;
  3. the user entry points end to end on the stencil, in this process:
     uspmv_tpu.cli.main in bench mode and in solve mode with scipy
     validation, and uspmv_tpu.interface (prepare + execute_uspmv);
  4. (--four only) DistributedSpmvOperator over four GPUs, seg-nnz,
     overlap on and off, against the one-GPU result and scipy.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
Everything runs in this one process, so only it holds the card.
"""

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# a 64-bit array type in StableHLO text, e.g. tensor<4096xf64>
WIDE = re.compile(r"tensor<[0-9x]*(?:f64|i64)>")


def rel_err(y, ref) -> float:
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def check(label, op, A, x, tol):
    """One SpMV through ``op`` against scipy; raises beyond ``tol``."""
    t0 = time.perf_counter()
    y = np.asarray(op.to_host(op.spmv(op.make_x(x))), dtype=np.float64)
    ref = A @ x
    if y.shape != ref.shape or not np.isfinite(y).all():
        raise AssertionError(f"{label}: bad result shape/values {y.shape}")
    err = rel_err(y, ref)
    print(f"  {label:34s} impl={op.impl_name():14s} max_rel_err={err:.3e} "
          f"(tol {tol:g}, {time.perf_counter() - t0:.1f} s incl. compile)",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{label}: max_rel_err {err:.3e} > {tol:g}")
    return y


def with_impl(op, **cfg_kw):
    """The same device matrices under another configuration (e.g. XLA's
    path instead of the kernel): no second build, a fresh jit."""
    import dataclasses

    return dataclasses.replace(
        op, config=dataclasses.replace(op.config, **cfg_kw), _jit_spmv=None
    )


def phase_kernels():
    import jax

    from uspmv_tpu.config import Config
    from uspmv_tpu.io.generators import laplace3d, powerlaw_cols
    from uspmv_tpu.ops.spmv_bcoo import BcooSpmvOperator
    from uspmv_tpu.runtime.operator import SpmvOperator
    from uspmv_tpu.runtime.validate import UNIT_TOL

    tol = dict(UNIT_TOL)
    tol.update({"ap[dp_sp]": UNIT_TOL["sp"], "ap[sp_hp]": UNIT_TOL["hp"]})
    rng = np.random.default_rng(0)

    print("phase 2: kernels against scipy (f64)", flush=True)
    for name, make, precs in (
        ("laplace3d(160)", lambda: laplace3d(160),
         ("sp", "dp", "hp", "ap[dp_sp]", "ap[sp_hp]")),
        ("powerlaw_cols(4M,8)", lambda: powerlaw_cols(4_000_000, 8),
         ("sp", "dp")),
    ):
        mtx = make()
        A = mtx.to_scipy().tocsr()
        x = rng.standard_normal(mtx.n_rows)
        print(f" {name}: {mtx.n_rows} rows, {mtx.nnz} nnz", flush=True)
        for prec in precs:
            op = SpmvOperator.from_mtx(
                Config(chunk_size=32, sigma=1, value_type=prec,
                       ap_threshold_1=2.44), mtx)
            if op.impl_name() != "triton-scs":
                raise AssertionError(f"GPU default is {op.impl_name()}")
            check(f"{prec} kernel", op, A, x, tol[prec])
            check(f"{prec} xla", with_impl(op, impl="xla"), A, x, tol[prec])
            if prec in ("sp", "dp"):
                bop = BcooSpmvOperator.from_mtx(
                    Config(impl="bcoo", value_type=prec), mtx)
                check(f"{prec} bcoo", bop, A, x, tol[prec])
                del bop
            if prec == "sp" and name.startswith("laplace"):
                xb = rng.standard_normal((mtx.n_rows, 8))
                check("sp rowwise bs=8 kernel",
                      with_impl(op, block_vec_size=8,
                                vector_layout="rowwise"), A, xb, tol["sp"])
                step = jax.jit(op.build_spmv_closure())
                lowered = step.lower(op.kernel_args, op.make_x())
                wide = WIDE.findall(lowered.as_text())
                if wide:
                    raise AssertionError(f"sp step carries {wide} types")
                print("  sp step HLO: no f64/i64 arrays; memory_analysis:",
                      lowered.compile().memory_analysis(), flush=True)
            del op


def phase_cli(card: str):
    import jax

    from uspmv_tpu import cli

    print("phase 3: entry points end to end on Laplace3D,160", flush=True)
    out_dir = tempfile.mkdtemp(prefix="uspmv_smoke_")
    common = ["Laplace3D,160", "scs", "-c", "32", "-s", "1", "-sp",
              "-mtx_out", out_dir]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(common + ["-mode", "b", "-bench_time", "1", "-json"])
    if rc != 0:
        raise AssertionError(f"cli bench rc={rc}")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    print(f"  bench: {res['perf_gflops']:.2f} GFLOP/s  "
          f"{res['effective_gbps']:.2f} GB/s  impl={res['impl']}  "
          f"peak_bytes_in_use={peak}  [{card}]", flush=True)
    if res["impl"] != "triton-scs" or not res["perf_gflops"] > 0:
        raise AssertionError(f"cli bench result {res}")
    rc = cli.main(common + ["-mode", "s", "-rev", "3", "-validate", "1"])
    if rc != 0:
        raise AssertionError(f"cli solve validation rc={rc}")
    print(f"  solve -rev 3 validated against scipy  peak_bytes_in_use="
          f"{jax.devices()[0].memory_stats().get('peak_bytes_in_use')}  "
          f"[{card}]", flush=True)

    import uspmv_tpu.interface as ui
    from uspmv_tpu.io.generators import laplace3d

    mtx = laplace3d(160)
    x = np.random.default_rng(1).standard_normal(mtx.n_rows)
    h = ui.prepare(mtx, C=32, sigma=1, value_type="dp")
    y = ui.execute_uspmv(h, x, n_repetitions=2)
    A = mtx.to_scipy().tocsr()
    err = rel_err(y, A @ (A @ x))
    print(f"  interface: prepare + execute_uspmv(n_repetitions=2) dp "
          f"impl={h.impl_name()} max_rel_err={err:.3e}", flush=True)
    if h.impl_name() != "triton-scs" or not err <= 1e-13:
        raise AssertionError(f"interface dp: {h.impl_name()} {err:.3e}")


def phase_four(card: str):
    import jax

    from uspmv_tpu.config import Config
    from uspmv_tpu.io.generators import laplace3d
    from uspmv_tpu.parallel.distributed import DistributedSpmvOperator
    from uspmv_tpu.runtime.bench import bench_spmv
    from uspmv_tpu.runtime.operator import SpmvOperator

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 GPUs, have {jax.devices()}")
    print("phase 4: 4 shards (seg-nnz) on laplace3d(160)", flush=True)
    mtx = laplace3d(160)
    A = mtx.to_scipy().tocsr()
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    cfg = dict(chunk_size=32, sigma=1, value_type="sp", bench_time=0.5)
    y1 = check("sp one GPU", SpmvOperator.from_mtx(Config(**cfg), mtx),
               A, x, 1e-5)
    for overlap in (True, False):
        op = DistributedSpmvOperator.from_mtx(
            Config(n_shards=4, seg_method="seg-nnz", overlap_comm=overlap,
                   **cfg), mtx)
        mesh = list(op.mesh.devices.flat)
        if len({d.id for d in mesh}) != 4 or any(
                d.platform != "gpu" for d in mesh):
            raise AssertionError(f"mesh is not four distinct GPUs: {mesh}")
        y = check(f"sp 4 shards overlap={overlap}", op, A, x, 1e-5)
        vs_one = rel_err(y, y1)
        if not vs_one <= 1e-5:
            raise AssertionError(f"4-shard vs one-GPU: {vs_one:.3e}")
        r = bench_spmv(op, warmup=5, start_iters=16)
        print(f"  vs one GPU {vs_one:.3e}; halo elems/SpMV "
              f"{op.comm_volume_per_spmv()['sp']}; mesh "
              f"{[d.id for d in mesh]}; {r.perf_gflops:.2f} GFLOP/s  "
              f"{r.effective_gbps:.2f} GB/s  [{card}]", flush=True)
        del op


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-shard path on four GPUs")
    args = ap.parse_args()

    import jax

    import uspmv_tpu  # noqa: F401  (x64 + compile cache, before use)

    print("phase 1: devices", jax.devices(), flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: platform is {dev.platform!r}", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        phase_kernels()
        phase_cli(card)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
