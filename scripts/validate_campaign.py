#!/usr/bin/env python
"""Validation campaign — the reference's SLURM validate.sh sweep
(scripts/validate{,_master,_no_mpi,_one_proc,_multi_proc}.sh) as one script.

Sweeps C x sigma x precision x rand_x x seg_method x shards in SOLVE mode on
small matrices (generated by default, or .mtx files given with
--matrices), each run in-process through the real CLI driver
(python -m uspmv_tpu.cli ... -mode s -validate 1), which validates against
scipy.sparse (the MKL stand-in) at the reference tolerances and exits
nonzero on ERROR — the reference campaign greps its compare files for
"ERROR" the same way (validate.sh:24-46).

Usage:
  python scripts/validate_campaign.py [--quick] [--matrices m.mtx ...]
  [--shards N] [--platform cpu|gpu] [--multihost]

--multihost spawns pairs of CPU processes (-backend cpu), so it never
competes for a GPU.
"""

import argparse
import itertools
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="reduced sweep")
    ap.add_argument("--matrices", nargs="*", default=None)
    ap.add_argument("--shards", type=int, default=1)
    # default cpu: this is the oracle-correctness campaign (the reference
    # validates against CPU MKL, validate.sh); --platform gpu validates
    # the GPU kernels (one process, one card)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument(
        "--multihost", action="store_true",
        help="additionally run a reduced sweep on a REAL 2-process gloo "
        "cluster (the reference validate_multi_proc.sh analogue); each "
        "config launches two subprocesses through the public CLI",
    )
    args = ap.parse_args()

    if args.platform == "cpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        if args.shards > 1:
            os.environ.setdefault(
                "XLA_FLAGS",
                f"--xla_force_host_platform_device_count={args.shards}",
            )

    from uspmv_tpu import cli

    matrices = args.matrices or [
        "Laplace2D,16", "Tridiag,100", "RandomImbalanced,300,6",
    ]
    backend = ["-backend", args.platform]

    # reference sweep: C,sigma in {1,2,3,4,8,10,16,32,64}^2 (validate.sh)
    cs = [1, 2, 4, 16] if args.quick else [1, 2, 3, 4, 8, 10, 16, 32, 64]
    sigmas = [1, 4, 64] if args.quick else [1, 2, 3, 4, 8, 10, 16, 32, 64]
    precs = ["-dp", "-sp"] if args.quick else ["-dp", "-sp", "-hp", "-ap"]
    rand_x = ["0", "1"]
    out_dir = (os.environ.get("USPMV_CAMPAIGN_DIR")
               or tempfile.mkdtemp(prefix="uspmv_campaign_"))
    os.makedirs(out_dir, exist_ok=True)

    n_runs = n_fail = 0
    for path, C, sigma, prec, rx in itertools.product(
        matrices, cs, sigmas, precs, rand_x
    ):
        fmt = "crs" if (C == 1 and sigma == 1) else "scs"
        argv = [
            path, fmt, "-c", str(C), "-s", str(sigma),
            "-mode", "s", "-rev", "3", "-validate", "1",
            "-rand_x", rx, "-mtx_out", out_dir,
            "-n_shards", str(args.shards), *backend,
        ]
        if prec == "-ap":
            argv += ["-ap_value_type", "ap[dp_sp]", "-ap_threshold_1", "0.5"]
        else:
            argv.append(prec)
        n_runs += 1
        try:
            rc = cli.main(argv)
        except Exception as e:  # noqa: BLE001 - campaign must keep going
            rc = 3
            print(f"EXCEPTION {os.path.basename(path)} C={C} s={sigma} "
                  f"{prec} rand_x={rx}: {e}")
        if rc != 0:
            n_fail += 1
            print(f"ERROR rc={rc} {os.path.basename(path)} C={C} "
                  f"sigma={sigma} {prec} rand_x={rx}")
    # the BCOO comparison baseline and heavy-row splitting, each through
    # the same solve+validate harness
    extra_runs = [
        ["-impl", "bcoo", "-sp"],
        ["-c", "32", "-s", "1", "-sp", "-split_rows_threshold", "6"],
        ["-c", "32", "-s", "1", "-dp"],
    ]
    for path in matrices[:1]:
        for extra in extra_runs:
            fmt = "scs" if "-c" in extra else "crs"
            argv = [path, fmt, "-mode", "s", "-rev", "2", "-validate", "1",
                    "-mtx_out", out_dir, *backend] + extra
            n_runs += 1
            try:
                rc = cli.main(argv)
            except Exception as e:  # noqa: BLE001
                rc = 3
                print(f"EXCEPTION {os.path.basename(path)} {extra}: {e}")
            if rc != 0:
                n_fail += 1
                print(f"ERROR rc={rc} {os.path.basename(path)} {extra}")
    # matrices without column locality (uniform-random and power-law
    # columns), sharded when --shards > 1
    zl_runs = [
        ("RandomImbalanced,20000,8", ["-c", "32", "-s", "128", "-sp"]),
        ("PowerLawCols,20000,8", ["-c", "32", "-s", "128", "-sp"]),
        ("RandomImbalanced,20000,8",
         ["-c", "32", "-s", "128", "-sp", "-block_vec_size", "2",
          "-layout", "rowwise"]),
    ]
    for spec, extra in zl_runs:
        argv = [spec, "scs", "-mode", "s", "-rev", "2", "-validate", "1",
                "-mtx_out", out_dir, "-n_shards", str(args.shards),
                *backend] + extra
        n_runs += 1
        try:
            rc = cli.main(argv)
        except Exception as e:  # noqa: BLE001
            rc = 3
            print(f"EXCEPTION {spec} {extra}: {e}")
        if rc != 0:
            n_fail += 1
            print(f"ERROR rc={rc} {spec} {extra}")
    if args.multihost:
        # 2-process cluster sweep (reference validate_multi_proc.sh):
        # every config runs as two real CPU subprocesses wired by
        # jax.distributed, validated on process 0
        import socket
        import subprocess

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        mh_configs = [
            ["scs", "-c", "4", "-s", "8", "-sp"],
            ["crs", "-dp", "-rand_x", "1"],
            ["scs", "-c", "32", "-s", "1", "-sp", "-seg_method",
             "seg-nnz"],
        ]
        for path in matrices[:1]:
            for extra in mh_configs:
                s = socket.socket()
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
                s.close()
                env = dict(os.environ)
                env.pop("JAX_PLATFORMS", None)
                env.pop("XLA_FLAGS", None)
                env["PYTHONPATH"] = repo
                procs = [
                    subprocess.Popen(
                        [sys.executable, "-m", "uspmv_tpu.cli", path,
                         *extra, "-mode", "s", "-rev", "2", "-validate",
                         "1", "-n_shards", "4", "-mtx_out", out_dir,
                         "-coordinator", f"localhost:{port}",
                         "-n_processes", "2", "-process_id", str(pid),
                         "-local_devices", "2", "-backend", "cpu"],
                        cwd=repo, env=env,
                    )
                    for pid in range(2)
                ]
                rcs = [p.wait(timeout=600) for p in procs]
                n_runs += 1
                if any(rcs):
                    n_fail += 1
                    print(f"ERROR multihost rc={rcs} "
                          f"{os.path.basename(path)} {extra}")
    print(f"campaign: {n_runs} runs, {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
