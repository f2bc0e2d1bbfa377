"""Operator contract: ``from_mtx`` -> ``spmv`` / ``solve`` against the
scipy f64 oracle, for every SpMV implementation the package has (XLA's
tiled and flat paths, the BCOO baseline, and the SELL-C-sigma Triton
kernel, here in Pallas interpret mode), across chunk heights, sorting
scopes, precisions, block-vector layouts and generated matrix classes.
Every case is a few thousand rows at most."""

import functools

import numpy as np
import pytest

from uspmv_tpu.config import Config
from uspmv_tpu.io.generators import (
    banded_imbalanced, fem_tet3d, laplace2d, powerlaw_cols, random_imbalanced,
    stokes_saddle,
)
from uspmv_tpu.ops.spmv_bcoo import BcooSpmvOperator
from uspmv_tpu.runtime import operator as operator_mod
from uspmv_tpu.runtime.operator import SpmvOperator
from uspmv_tpu.runtime.validate import UNIT_TOL, validate_solve


@pytest.fixture(params=["xla", "triton", "bcoo"])
def impl(request, monkeypatch):
    """Which implementation ``Config(impl='auto')`` runs on this host: the
    Triton kernel is swapped in (interpret mode) for the 'triton' case."""
    if request.param == "triton":
        from uspmv_tpu.ops.spmv_triton import spmv_triton

        orig = operator_mod.impl_for

        def impl_for(config, platform):
            if config.impl == "auto":
                return (functools.partial(spmv_triton, interpret=True),
                        "triton-scs", "scs")
            return orig(config, platform)

        monkeypatch.setattr(operator_mod, "impl_for", impl_for)
    return request.param


def build(impl, mtx, **kw):
    cfg = Config(backend="cpu", **kw)
    if impl == "bcoo":
        return BcooSpmvOperator.from_mtx(
            Config(backend="cpu", impl="bcoo", value_type=kw["value_type"],
                   block_vec_size=kw.get("block_vec_size", 1),
                   vector_layout=kw.get("vector_layout", "colwise")), mtx)
    op = SpmvOperator.from_mtx(cfg, mtx)
    expect = {"xla": ("xla-flat-crs" if cfg.kernel_format == "crs"
                      else "xla-tiled-scs"),
              "triton": "triton-scs"}[impl]
    assert op.impl_name() == expect
    return op


def spmv_rel_err(op, mtx, bs=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((mtx.n_rows, bs) if bs > 1 else mtx.n_rows)
    y = op.to_host(op.spmv(op.make_x(x))).astype(np.float64)
    ref = mtx.to_scipy().tocsr() @ x
    assert y.shape == ref.shape
    return np.abs(y - ref).max() / np.abs(ref).max()


def matrix():
    return random_imbalanced(700, 7, seed=11)


# tolerance per precision: the unit tolerance of the lowest precision in
# the mix, with 10x headroom for the sum over a row (normwise max error)
TOL = {"dp": 1e-13, "sp": 1e-5, "hp": 1e-2,
       "ap[dp_sp]": 1e-5, "ap[dp_hp]": 1e-2, "ap[sp_hp]": 1e-2,
       "ap[dp_sp_hp]": 1e-2}


SCS_IMPLS = pytest.mark.parametrize("impl", ["xla", "triton"], indirect=True)


@SCS_IMPLS
@pytest.mark.parametrize("prec", ["sp", "dp"])
@pytest.mark.parametrize("sigma", [1, 64])
@pytest.mark.parametrize("C", [1, 4, 32, 128])
def test_spmv_formats(impl, C, sigma, prec):
    mtx = matrix()
    fmt = "crs" if (C, sigma) == (1, 1) else "scs"
    op = build(impl, mtx, kernel_format=fmt, chunk_size=C, sigma=sigma,
               value_type=prec)
    assert spmv_rel_err(op, mtx) < UNIT_TOL[prec]


@pytest.mark.parametrize("prec", ["sp", "dp", "hp"])
def test_uniform_precisions(impl, prec):
    mtx = matrix()
    op = build(impl, mtx, chunk_size=32, sigma=64, value_type=prec)
    assert spmv_rel_err(op, mtx) < TOL[prec]


@SCS_IMPLS
@pytest.mark.parametrize(
    "prec", ["ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]", "ap[dp_sp_hp]"]
)
def test_adaptive_precisions(impl, prec):
    mtx = matrix()
    op = build(impl, mtx, chunk_size=32, sigma=64, value_type=prec,
               ap_threshold_1=1.0, ap_threshold_2=0.3)
    npp = op.nnz_per_precision()
    assert sum(npp.values()) == mtx.nnz and min(npp.values()) > 0
    assert spmv_rel_err(op, mtx) < TOL[prec]


@pytest.mark.parametrize("bs,layout", [(1, "colwise"), (4, "rowwise"),
                                       (4, "colwise")])
def test_block_vectors(impl, bs, layout):
    mtx = matrix()
    op = build(impl, mtx, chunk_size=32, sigma=1, value_type="dp",
               block_vec_size=bs, vector_layout=layout)
    assert spmv_rel_err(op, mtx, bs=bs) < UNIT_TOL["dp"]


def test_solve_swap(impl):
    """Solve mode: n repetitions of y = A x with the x<->y swap."""
    mtx = laplace2d(30)
    op = build(impl, mtx, chunk_size=32, sigma=1, value_type="dp", mode="s")
    x0 = np.random.default_rng(3).standard_normal(mtx.n_rows)
    _, y = op.solve(op.make_x(x0), 4)
    rep = validate_solve(mtx, x0, np.asarray(op.to_host(y), np.float64), 4)
    assert rep.flag == "OK" and rep.max_rel_diff < 1e-10, rep.summary()


GENERATED = {
    "laplace2d": lambda: laplace2d(40),
    "fem_tet3d": lambda: fem_tet3d(5),
    "stokes_saddle": lambda: stokes_saddle(6),
    "banded_imbalanced": lambda: banded_imbalanced(3000, 64, seed=2),
    "powerlaw_cols": lambda: powerlaw_cols(3000, 8, seed=3),
}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_matrices(impl, name):
    mtx = GENERATED[name]()
    op = build(impl, mtx, chunk_size=32, sigma=128, value_type="sp")
    assert spmv_rel_err(op, mtx) < UNIT_TOL["sp"]
