"""CLI + bench harness + report writer tests (reference harness layer,
SURVEY.md §1 L8-L9)."""

import json
import os

import numpy as np
import pytest

from uspmv_tpu.cli import build_parser, config_from_args, main
from uspmv_tpu.config import Config
from uspmv_tpu.formats.stats import get_matrix_stats
from uspmv_tpu.io.mmio import read_mtx
from uspmv_tpu.runtime.bench import bench_spmv
from uspmv_tpu.runtime.operator import SpmvOperator

from conftest import matrix_path


def run_cli(tmp_path, *argv):
    return main(list(argv) + ["-mtx_out", str(tmp_path), "-backend", "cpu"])


def test_solve_mode_validates(tmp_path, capsys):
    rc = run_cli(
        tmp_path, matrix_path("impcol_e.mtx"), "crs", "-mode", "s", "-rev", "2"
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "[OK]" in out
    assert os.path.exists(tmp_path / "spmv_scipy_compare_dp.txt")


def test_bcoo_impl_solve_validates(tmp_path, capsys):
    # the independent jax.experimental.sparse baseline must validate
    # through the same solve harness as our kernels
    rc = run_cli(
        tmp_path, matrix_path("impcol_e.mtx"), "crs", "-mode", "s",
        "-rev", "3", "-impl", "bcoo",
    )
    assert rc == 0
    assert "[OK]" in capsys.readouterr().out


def test_bcoo_impl_bench_reports_its_own_name(tmp_path, capsys):
    rc = run_cli(
        tmp_path, matrix_path("bcsstk13.mtx"), "scs", "-c", "16",
        "-s", "512", "-mode", "b", "-bench_time", "0.05", "-impl", "bcoo",
        "-sp",
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "impl: jax-bcoo" in out


def test_bcoo_matches_scipy_directly():
    from uspmv_tpu.ops.spmv_bcoo import BcooSpmvOperator

    mtx = read_mtx(matrix_path("bcsstk13.mtx"))
    cfg = Config(kernel_format="crs", value_type="dp", backend="cpu",
                 impl="bcoo")
    op = BcooSpmvOperator.from_mtx(cfg, mtx)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(mtx.n_rows)
    y = op.to_host(np.asarray(op.spmv(op.make_x(x))))
    ref = mtx.to_scipy().tocsr() @ x
    np.testing.assert_allclose(y, ref, rtol=1e-12)


def test_bcoo_rejects_shards_and_ap():
    from uspmv_tpu.ops.spmv_bcoo import BcooSpmvOperator

    mtx = read_mtx(matrix_path("impcol_e.mtx"))
    with pytest.raises(ValueError, match="single-device"):
        BcooSpmvOperator.from_mtx(
            Config(value_type="dp", n_shards=2, impl="bcoo"), mtx
        )
    with pytest.raises(ValueError, match="uniform precisions"):
        BcooSpmvOperator.from_mtx(
            Config(value_type="ap[dp_sp]", ap_threshold_1=1.0, impl="bcoo"),
            mtx,
        )


def test_bench_mode_writes_reports(tmp_path, capsys):
    rc = run_cli(
        tmp_path,
        matrix_path("FDM-2d-16.mtx"),
        "scs",
        "-c", "8", "-s", "16", "-sp",
        "-bench_time", "0.05",
        "-json",
    )
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["perf_gflops"] > 0
    assert res["effective_gbps"] > 0
    assert os.path.exists(tmp_path / "spmv_bench.txt")
    jl = (tmp_path / "spmv_bench.jsonl").read_text().strip()
    assert json.loads(jl)["nnz"] == res["nnz"]


def test_solve_ap_with_thresholds(tmp_path, capsys):
    # threshold must keep the sp bucket to small-magnitude elements: y of
    # bcsstk13 cancels 1e12-magnitude partial sums down to ~1e-5, so sp
    # rounding of large elements genuinely fails the reference tolerance
    # (an honest ERROR, not a bug — verified element 1902 by hand)
    rc = run_cli(
        tmp_path,
        matrix_path("bcsstk13.mtx"),
        "scs",
        "-c", "16", "-s", "64",
        "-mode", "s",
        "-ap_value_type", "ap[dp_sp]",
        "-ap_threshold_1", "1e-3",
    )
    assert rc == 0
    assert os.path.exists(tmp_path / "spmv_scipy_compare_ap.txt")


def test_solve_ap_large_threshold_flags_error(tmp_path, capsys):
    # with sp holding large elements, cancellation error must be flagged
    rc = run_cli(
        tmp_path,
        matrix_path("bcsstk13.mtx"),
        "scs",
        "-c", "16", "-s", "64",
        "-mode", "s",
        "-ap_value_type", "ap[dp_sp]",
        "-ap_threshold_1", "1e5",
    )
    assert rc == 1
    assert "[ERROR]" in capsys.readouterr().out


def test_generator_spec(tmp_path, capsys):
    rc = run_cli(
        tmp_path, "Tridiag,100", "scs", "-c", "4", "-s", "8",
        "-mode", "s", "-rev", "3",
    )
    assert rc == 0
    assert "[OK]" in capsys.readouterr().out


def test_matrix_stats_flag(tmp_path, capsys):
    rc = run_cli(tmp_path, matrix_path("bcsstk13.mtx"), "scs", "-matrix_stats")
    assert rc == 0
    out = capsys.readouterr().out
    assert "row lengths" in out and "bandwidth" in out


def test_output_sparsity_roundtrip(tmp_path, capsys):
    rc = run_cli(
        tmp_path, matrix_path("impcol_e.mtx"), "scs", "-c", "4", "-s", "8",
        "-output_sparsity",
    )
    assert rc == 0
    dumped = read_mtx(str(tmp_path / "dp_local_scs.mtx"))
    orig = read_mtx(matrix_path("impcol_e.mtx"))
    assert abs(dumped.to_scipy() - orig.to_scipy()).max() < 1e-12


def test_stats_module():
    mtx = read_mtx(matrix_path("impcol_e.mtx"))
    st = get_matrix_stats(mtx)
    assert st.nnz == mtx.nnz
    assert st.row_lengths.max >= st.row_lengths.avg >= st.row_lengths.min
    assert st.n_empty_rows == 0


def test_bench_harness_doubling():
    mtx = read_mtx(matrix_path("FDM-2d-16.mtx"))
    cfg = Config(
        kernel_format="scs", chunk_size=4, sigma=4, value_type="sp",
        bench_time=0.05, backend="cpu",
    )
    op = SpmvOperator.from_mtx(cfg, mtx)
    res = bench_spmv(op, warmup=3, start_iters=2)
    assert res.n_iterations >= 2
    # the doubling loop stops when a batch reaches bench_time; the reported
    # duration is the MEDIAN of timing_reps re-runs of that final batch, so
    # only the first sample is guaranteed >= bench_time
    assert res.timing_samples_s[0] >= 0.05
    assert len(res.timing_samples_s) == 3
    assert res.duration_kernel_s == float(np.median(res.timing_samples_s))
    assert res.perf_gflops > 0
    assert res.platform == "cpu"
    assert res.impl == "xla-tiled-scs"


def test_bench_solve_harness():
    """Solve-mode timing: whole scan calls fenced by block_until_ready;
    k iterations per call, the batch doubled until bench_time."""
    from uspmv_tpu.runtime.bench import bench_solve

    mtx = read_mtx(matrix_path("FDM-2d-16.mtx"))
    cfg = Config(kernel_format="scs", chunk_size=32, sigma=1,
                 value_type="sp", bench_time=0.05, backend="cpu")
    op = SpmvOperator.from_mtx(cfg, mtx)
    res = bench_solve(op, 8, warmup=1)
    assert res.n_iterations % 8 == 0 and res.n_iterations >= 8
    assert res.timing_samples_s[0] >= 0.05
    assert res.duration_kernel_s == float(np.median(res.timing_samples_s))
    assert res.impl == "solve-scan[xla-tiled-scs]"
    assert (res.platform, res.device_kind) == ("cpu", "cpu")
    assert res.memory_footprint_bytes == op.bytes_per_spmv()


def test_bench_peak_table():
    """bench.py's HBM peak is keyed by device_kind: the H100's published
    3.35 TB/s, none on the CPU, and an unknown accelerator is an error."""
    import types

    import bench

    def dev(platform, kind):
        return types.SimpleNamespace(platform=platform, device_kind=kind)

    assert bench.peak_gbps(dev("gpu", "NVIDIA H100 80GB HBM3")) == 3350.0
    assert bench.peak_gbps(dev("cpu", "cpu")) is None
    with pytest.raises(KeyError, match="no published HBM bandwidth"):
        bench.peak_gbps(dev("gpu", "Some Other GPU"))


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_location(tmp_path, env_dir):
    """The compile cache is $JAX_COMPILATION_CACHE_DIR when set, else the
    fixed <repo>/.jax_cache; importing the package decides it."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(repo, ".jax_cache")
    if env_dir:
        want = env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c", "import jax, uspmv_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip() == want


def test_cli_parser_reference_flags():
    p = build_parser()
    args = p.parse_args(
        ["m.mtx", "scs", "-c", "16", "-s", "512", "-mode", "b",
         "-block_vec_size", "4", "-layout", "rowwise", "-equilibrate", "1",
         "-seg_method", "seg-nnz", "-rand_x", "1"]
    )
    cfg = config_from_args(args)
    assert cfg.chunk_size == 16 and cfg.sigma == 512
    assert cfg.block_vec_size == 4 and cfg.vector_layout == "rowwise"
    assert cfg.equilibrate and cfg.seg_method == "seg-nnz"
    assert cfg.random_init_x


def test_reference_flag_spellings(tmp_path):
    """The reference binary's exact flags work: -ap[dp_sp], -apt1, -seg_nnz
    (utilities.hpp:1325-1360)."""
    from uspmv_tpu.cli import main

    rc = main([
        matrix_path("impcol_e.mtx"), "scs", "-c", "4", "-s", "4",
        "-mode", "s", "-rev", "2", "-ap[dp_sp]", "-apt1", "0.5",
        "-seg_nnz", "-validate", "1", "-mtx_out", str(tmp_path),
    ])
    assert rc == 0


def test_equilibrated_solve_validates(tmp_path):
    """-equilibrate changes the operator; the validation oracle must see the
    same scaled matrix (reference equilibrates total_mtx before the MKL
    compare, main.cpp:1753-1754)."""
    from uspmv_tpu.cli import main

    rc = main([
        matrix_path("impcol_e.mtx"), "scs", "-c", "4", "-s", "4",
        "-mode", "s", "-rev", "2", "-sp", "-equilibrate", "1",
        "-validate", "1", "-mtx_out", str(tmp_path),
    ])
    assert rc == 0

    rc = main([
        matrix_path("bcsstk13.mtx"), "crs", "-mode", "s", "-rev", "2",
        "-dp", "-jacobi_scale", "1", "-validate", "1",
        "-mtx_out", str(tmp_path),
    ])
    assert rc == 0


def test_rand_x_mean_mode(tmp_path):
    """-rand_x m fills x with the matrix min/max midpoint (reference
    default_values.x = matrix_mean, utilities.hpp:2352,2433)."""
    from uspmv_tpu.cli import main

    rc = main([
        matrix_path("impcol_e.mtx"), "scs", "-c", "2", "-s", "2",
        "-mode", "s", "-rev", "2", "-rand_x", "m", "-validate", "1",
        "-mtx_out", str(tmp_path),
    ])
    assert rc == 0

    from uspmv_tpu.config import Config
    from uspmv_tpu.ops.vectors import init_x_host

    cfg = Config(mean_init_x=True)
    x = init_x_host(cfg, 5, matrix_stats=(1.0, 3.5, 6.0))
    np.testing.assert_allclose(x, 3.5)
