"""Kernel tests: XLA flat/tiled SpMV + SpMMV vs scipy oracle, all precisions,
both layouts, solve-mode loop with swap (reference validate.sh campaign in
miniature, SURVEY.md §4)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from uspmv_tpu.config import Config
from uspmv_tpu.formats.coo import MtxData
from uspmv_tpu.formats.scs import convert_to_scs, permute_scs_cols
from uspmv_tpu.io.mmio import read_mtx
from uspmv_tpu.ops.device_format import build_device_scs
from uspmv_tpu.ops.spmv_xla import spmv_flat, spmv_tiled
from uspmv_tpu.runtime.operator import SpmvOperator
from uspmv_tpu.runtime.validate import UNIT_TOL, compare, oracle_solve, validate_solve

from conftest import matrix_path


def make_operator(name, **kw) -> tuple:
    mtx = read_mtx(matrix_path(name))
    cfg = Config(**kw)
    return mtx, SpmvOperator.from_mtx(cfg, mtx)


def spmv_host(op, mtx, x=None):
    """Run one spmv through the operator, return host y and oracle y."""
    xh = (
        np.random.default_rng(5)
        .standard_normal(
            (mtx.n_rows, op.config.block_vec_size)
            if op.config.block_vec_size > 1
            else mtx.n_rows
        )
        .astype(op.working_dtype)
        if x is None
        else x
    )
    xd = op.make_x(np.asarray(xh, dtype=np.float64))
    y = op.to_host(op.spmv(xd))
    A = mtx.to_scipy().tocsr()
    y_ref = A @ np.asarray(xh, dtype=np.float64)
    return np.asarray(y, dtype=np.float64), y_ref


# --------------------------------------------------------------- raw kernels


@pytest.mark.parametrize("impl", [spmv_flat, spmv_tiled])
@pytest.mark.parametrize("C,sigma", [(1, 1), (4, 8), (16, 512), (3, 5)])
def test_raw_kernels_vs_scipy(impl, C, sigma):
    mtx = read_mtx(matrix_path("impcol_e.mtx"))
    scs = convert_to_scs(mtx, C=C, sigma=sigma)
    full_perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    full_perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, full_perm)
    dev = build_device_scs(scs)
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    xp = np.zeros(scs.n_rows_padded)
    xp[scs.old_to_new_idx] = x
    y = np.asarray(impl(dev, jnp.asarray(xp)))[scs.old_to_new_idx]
    y_ref = mtx.to_scipy().tocsr() @ x
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("impl", [spmv_flat, spmv_tiled])
def test_raw_kernels_block(impl):
    mtx = read_mtx(matrix_path("FDM-2d-16.mtx"))
    scs = convert_to_scs(mtx, C=8, sigma=16)
    full_perm = np.arange(scs.n_rows_padded, dtype=np.int32)
    full_perm[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, full_perm)
    dev = build_device_scs(scs)
    bs = 4
    x = np.random.default_rng(1).standard_normal((mtx.n_rows, bs))
    xp = np.zeros((scs.n_rows_padded, bs))
    xp[scs.old_to_new_idx] = x
    y = np.asarray(impl(dev, jnp.asarray(xp)))[scs.old_to_new_idx]
    y_ref = mtx.to_scipy().tocsr() @ x
    np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------- operator end2end


@pytest.mark.parametrize("fmt,C,sigma", [("crs", 1, 1), ("scs", 16, 512), ("scs", 8, 8)])
@pytest.mark.parametrize("prec", ["dp", "sp"])
def test_operator_single_vector(fmt, C, sigma, prec):
    mtx, op = make_operator(
        "impcol_e.mtx", kernel_format=fmt, chunk_size=C, sigma=sigma, value_type=prec
    )
    y, y_ref = spmv_host(op, mtx)
    rep = compare(y_ref, y)
    assert rep.max_rel_diff < UNIT_TOL[prec] * 100  # impcol_e is ill-scaled
    assert rep.flag != "ERROR" or prec == "sp"


def test_operator_hp_bf16():
    mtx, op = make_operator(
        "FDM-2d-16.mtx", kernel_format="scs", chunk_size=8, sigma=8, value_type="hp"
    )
    y, y_ref = spmv_host(op, mtx)
    rep = compare(y_ref, y)
    assert rep.max_rel_diff < 0.1  # bf16 has ~3 decimal digits


@pytest.mark.parametrize("layout", ["rowwise", "colwise"])
def test_operator_block_layouts(layout):
    mtx, op = make_operator(
        "FDM-2d-16.mtx",
        kernel_format="scs",
        chunk_size=8,
        sigma=16,
        value_type="sp",
        block_vec_size=4,
        vector_layout=layout,
    )
    y, y_ref = spmv_host(op, mtx)
    rep = compare(y_ref, y)
    assert rep.max_rel_diff < 1e-4


@pytest.mark.parametrize(
    "vt,th1,th2",
    [
        ("ap[dp_sp]", 1.0, 0.0),
        ("ap[dp_hp]", 1.0, 0.0),
        ("ap[sp_hp]", 1.0, 0.0),
        ("ap[dp_sp_hp]", 10.0, 0.1),
    ],
)
def test_operator_adaptive_precision(vt, th1, th2):
    mtx, op = make_operator(
        "bcsstk13.mtx",
        kernel_format="scs",
        chunk_size=16,
        sigma=128,
        value_type=vt,
        ap_threshold_1=th1 * 1e5,
        ap_threshold_2=th2 * 1e5,
    )
    assert len(op.devs) == len(op.config.ap_precisions)
    # sub-matrices share the primary permutation
    precs = list(op.scs)
    for p in precs[1:]:
        np.testing.assert_array_equal(
            op.scs[p].old_to_new_idx, op.scs[precs[0]].old_to_new_idx
        )
    y, y_ref = spmv_host(op, mtx)
    rep = compare(y_ref, y)
    # the lowest precision bucket bounds the error; bf16 has ~8 mantissa
    # bits, so on ill-scaled bcsstk13 per-element relative diffs can blow up
    # through cancellation — judge hp variants by relative L2 instead
    if "hp" in op.config.ap_precisions:
        assert rep.rel_l2 < 1e-4, rep.summary()
    else:
        assert rep.max_rel_diff < 1e-4, rep.summary()


def test_solve_mode_with_swap():
    mtx, op = make_operator(
        "FDM-2d-16.mtx", kernel_format="scs", chunk_size=4, sigma=8, value_type="dp"
    )
    x0 = np.random.default_rng(3).standard_normal(mtx.n_rows)
    xd = op.make_x(x0)
    n_rep = 5
    _, y = op.solve(xd, n_rep)
    y_host = op.to_host(y)
    rep = validate_solve(mtx, x0, y_host, n_rep)
    assert rep.flag == "OK", rep.summary()
    assert rep.max_rel_diff < 1e-10


def test_solve_mode_crs_default_x():
    # BASELINE config 1: impcol_e, crs, dp, solve mode, validate vs scipy
    mtx, op = make_operator("impcol_e.mtx", kernel_format="crs", value_type="dp")
    xd = op.make_x()  # default 5.0 fill
    _, y = op.solve(xd, 3)
    y_host = op.to_host(y)
    x0 = np.full(mtx.n_rows, 5.0)
    rep = validate_solve(mtx, x0, y_host, 3)
    assert rep.flag == "OK", rep.summary()


def test_dropout_changes_result():
    mtx = read_mtx(matrix_path("bcsstk13.mtx"))
    cfg = Config(
        kernel_format="scs",
        chunk_size=16,
        sigma=64,
        value_type="ap[dp_sp]",
        ap_threshold_1=1e3,
        dropout=True,
        dropout_threshold=1e-2,
    )
    op = SpmvOperator.from_mtx(cfg, mtx)
    assert op.n_dropped > 0
    assert sum(s.nnz for s in op.scs.values()) + op.n_dropped == mtx.nnz


def test_flops_and_bytes_accounting():
    mtx, op = make_operator("impcol_e.mtx", kernel_format="scs", chunk_size=8, sigma=8)
    assert op.flops_per_spmv() == 2 * mtx.nnz
    assert op.bytes_per_spmv() > 0
    assert 0 < op.beta()["dp"] <= 1.0


def test_scs_explosion_guard_falls_back_to_crs():
    """Power-law rows at C=1024 would pad nnz by orders of magnitude; the
    operator degrades to CRS with a warning instead of allocating gigabytes
    (reference behavior is to allocate; SURVEY.md 'hard parts')."""
    import warnings

    from uspmv_tpu.io.generators import random_imbalanced

    mtx = random_imbalanced(60_000, 12, alpha=1.1, seed=13)
    counts = np.bincount(mtx.I, minlength=mtx.n_rows)
    assert counts.max() > 1000  # genuinely heavy-tailed
    cfg = Config(
        kernel_format="scs", chunk_size=1024, sigma=1, value_type="sp",
        backend="cpu", split_rows_threshold=-1,
    )
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        op = SpmvOperator.from_mtx(cfg, mtx)
    assert any("falling back to CRS" in str(x.message) for x in w)
    prim = next(iter(op.scs.values()))
    assert prim.C == 1 and prim.n_elements <= 2 * mtx.nnz
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    ref = mtx.to_scipy().tocsr() @ x
    assert np.abs(y - ref).max() / np.abs(ref).max() < 2e-5


def test_heavy_row_splitting_bounds_padding():
    """With splitting on (the default), power-law rows split into virtual
    rows whose partials fold back into their parents after every SpMV:
    padding stays bounded at C=32 and results match scipy through spmv
    and the solve-mode scan."""
    from uspmv_tpu.io.generators import random_imbalanced

    mtx = random_imbalanced(60_000, 12, alpha=1.1, seed=13)
    cfg = Config(
        kernel_format="scs", chunk_size=32, sigma=1, value_type="sp",
        backend="cpu",
    )
    op = SpmvOperator.from_mtx(cfg, mtx)
    assert op.split_plan is not None
    prim = next(iter(op.scs.values()))
    # bounded padding (unsplit, one 4k-nnz row pads its whole chunk)
    assert prim.n_elements < 8 * mtx.nnz
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    ref = mtx.to_scipy().tocsr() @ x
    assert np.abs(y - ref).max() / np.abs(ref).max() < 2e-4
    # solve mode (repeated SpMV with swap) folds partials every iteration
    xd = op.make_x(x)
    _, y3 = op.solve(xd, 3)
    y3 = op.to_host(y3).astype(np.float64)
    A = mtx.to_scipy().tocsr()
    ref3 = A @ (A @ (A @ x))
    assert np.abs(y3 - ref3).max() / np.abs(ref3).max() < 2e-3


def test_split_heavy_rows_unit():
    from uspmv_tpu.formats.coo import split_heavy_rows

    # row 1 has 5 elements, threshold 2 -> pieces of 2,2,1
    mtx = MtxData.from_arrays(
        I=[0, 1, 1, 1, 1, 1, 2],
        J=[0, 0, 1, 2, 3, 4, 2],
        values=[1.0, 2, 3, 4, 5, 6, 7.0],
        n_rows=3, n_cols=5, is_sorted=True,
    )
    out, parent = split_heavy_rows(mtx, 2)
    assert out.n_rows == 5 and out.nnz == 7
    np.testing.assert_array_equal(parent, [1, 1])
    dense = np.zeros((3, 5))
    d5 = out.to_scipy().toarray()
    dense[:3] = d5[:3]
    dense[1] += d5[3] + d5[4]
    np.testing.assert_allclose(dense, mtx.to_scipy().toarray())
    # no-op below threshold
    same, p2 = split_heavy_rows(mtx, 16)
    assert p2 is None and same is mtx


def test_banded_imbalanced_generator_and_sigma():
    """BandedImbalanced: power-law rows inside a diagonal band — the regime
    where sigma-sorting + heavy-row splitting interact. Correctness at both
    sigma extremes at C=32."""
    from uspmv_tpu.io.generators import banded_imbalanced

    mtx = banded_imbalanced(30_000, bandwidth=300, avg_nnz_per_row=8, seed=5)
    counts = np.bincount(mtx.I, minlength=mtx.n_rows)
    assert counts.max() > 100  # tail rows fill the band
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    ref = mtx.to_scipy().tocsr() @ x
    for sigma in (1, 4096):
        cfg = Config(
            kernel_format="scs", chunk_size=32, sigma=sigma,
            value_type="sp", backend="cpu",
        )
        op = SpmvOperator.from_mtx(cfg, mtx)
        y = op.to_host(op.spmv(op.make_x(x)))
        assert np.abs(y - ref).max() / np.abs(ref).max() < 2e-4


def test_gpu_request_never_runs_on_the_cpu():
    """backend='gpu' in a process without a GPU raises; the operator never
    carries on on another platform."""
    import jax

    from uspmv_tpu.io.generators import laplace2d

    try:
        jax.devices("gpu")
        pytest.skip("this process has a GPU")
    except RuntimeError:
        pass
    with pytest.raises(RuntimeError):
        SpmvOperator.from_mtx(Config(backend="gpu", value_type="sp"),
                              laplace2d(8))

