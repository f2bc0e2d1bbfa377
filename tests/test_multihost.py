"""Multi-host execution: a REAL 2-process jax.distributed cluster on CPU
(gloo collectives), driven through the public CLI — the analogue of the
reference's mpirun validation campaign (scripts/validate_multi_proc.sh)
and the missing SURVEY §7-stage-7 component from round 1.

Each test launches two subprocesses that each run the same CLI line with
``-coordinator/-n_processes/-process_id``; the mesh spans 2 processes x 2
CPU devices = 4 shards, so the halo-exchange ppermutes cross a real
process boundary."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(cli_args, pid, port, tmp_path, n=2, local_devices=2):
    env = dict(os.environ)
    # the bootstrap pins the platform itself (-backend cpu), and
    # conftest's 8 virtual devices must not leak into the children
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [
            sys.executable, "-m", "uspmv_tpu.cli", *cli_args,
            "-coordinator", f"localhost:{port}",
            "-n_processes", str(n), "-process_id", str(pid),
            "-local_devices", str(local_devices), "-backend", "cpu",
            "-mtx_out", str(tmp_path),
        ],
        cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )


def _run_cluster(cli_args, tmp_path, timeout=300, n=2, local_devices=2):
    port = _free_port()
    procs = [
        _launch(cli_args, pid, port, tmp_path, n=n,
                local_devices=local_devices)
        for pid in range(n)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return [p.returncode for p in procs], outs


def test_two_process_solve_validates(tmp_path):
    args = [
        "Laplace2D,24", "scs", "-c", "4", "-s", "8", "-mode", "s",
        "-rev", "3", "-n_shards", "4", "-seg_method", "seg-nnz",
        "-validate", "1",
    ]
    rcs, outs = _run_cluster(args, tmp_path)
    assert rcs == [0, 0], outs
    # process 0 prints the validation block; process 1 stays quiet
    assert "[OK]" in outs[0], outs[0]
    assert "[OK]" not in outs[1], outs[1]
    assert os.path.exists(tmp_path / "spmv_scipy_compare_dp.txt")


def test_two_process_bench_reports_per_host_comm_volume(tmp_path):
    args = [
        "Laplace2D,24", "scs", "-c", "4", "-s", "8", "-mode", "b",
        "-bench_time", "0.05", "-n_shards", "4", "-sp",
        "-print_comm_vol", "1", "-verbose", "1",
    ]
    rcs, outs = _run_cluster(args, tmp_path)
    assert rcs == [0, 0], outs
    out = outs[0]
    assert "halo elems/SpMV per host" in out, out
    assert "host0=" in out and "host1=" in out, out
    # per-shard lines (reference per-rank gather) under -verbose
    assert "shard 0:" in out and "shard 3:" in out, out


def test_four_process_one_device_each(tmp_path):
    """4 processes x 1 device: EVERY halo exchange crosses a process
    boundary and the host boundaries are asymmetric under seg-nnz (the
    reference's multi-node case, validate_multi_proc.sh with -np 4)."""
    args = [
        "Laplace2D,20", "scs", "-c", "8", "-s", "16", "-mode", "s",
        "-rev", "2", "-n_shards", "4", "-seg_method", "seg-nnz",
        "-rand_x", "1", "-json",
    ]
    rcs, outs = _run_cluster(args, tmp_path, n=4, local_devices=1)
    assert rcs == [0, 0, 0, 0], outs
    import json

    line = [l for l in outs[0].splitlines() if l.startswith("{")][-1]
    rep = json.loads(line)["validation"]
    assert rep["flag"] == "OK"
    assert rep["max_rel_diff"] < 1e-13


def test_two_process_result_exact_vs_oracle(tmp_path):
    """The multi-host dp CRS solve must match the scipy oracle to dp unit
    tolerance — process count is an execution detail, not a numerical
    one (the single-process path passes the identical gate in
    test_distributed.py)."""
    args = [
        "Laplace2D,16", "crs", "-mode", "s", "-rev", "2",
        "-n_shards", "4", "-rand_x", "1", "-json",
    ]
    rcs, outs = _run_cluster(args, tmp_path)
    assert rcs == [0, 0], outs
    import json

    line = [l for l in outs[0].splitlines() if l.startswith("{")][-1]
    rep = json.loads(line)["validation"]
    # dp CRS: exact within dp unit tolerance of the scipy oracle
    assert rep["flag"] == "OK"
    assert rep["max_rel_diff"] < 1e-13
