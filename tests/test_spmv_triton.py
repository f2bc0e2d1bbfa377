"""The SELL-C-sigma Triton kernel (ops/spmv_triton.py): its arithmetic in
Pallas interpret mode against scipy, its lowering for CUDA (Pallas's
Triton lowering runs on any host; only the PTX compile needs the card),
and — marked ``gpu`` — the compiled kernel on an NVIDIA GPU."""

import re

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from uspmv_tpu.config import Config, dtype_for
from uspmv_tpu.formats.scs import convert_to_scs, permute_scs_cols
from uspmv_tpu.io.generators import (
    laplace2d, laplace3d, powerlaw_cols, random_imbalanced, tridiag,
)
from uspmv_tpu.io.mmio import read_mtx
from uspmv_tpu.ops.device_format import build_device_scs
from uspmv_tpu.ops.spmv_triton import ROWS, spmv_triton

from conftest import matrix_path


def permuted(mtx, C, sigma, dtype=np.float64):
    """Column-permuted SCS + its device struct (operator preprocessing)."""
    scs = convert_to_scs(mtx.astype(dtype), C, sigma)
    fp = np.arange(scs.n_rows_padded, dtype=np.int32)
    fp[: scs.n_rows] = scs.old_to_new_idx
    permute_scs_cols(scs, fp)
    return scs, build_device_scs(scs)


def run(mtx, C, sigma, x, val_dtype=np.float64, x_dtype=np.float64,
        interpret=True):
    scs, dev = permuted(mtx, C, sigma, val_dtype)
    xp = np.zeros((scs.n_rows_padded,) + x.shape[1:], x_dtype)
    xp[scs.old_to_new_idx] = x
    y = np.asarray(spmv_triton(dev, jnp.asarray(xp), interpret=interpret))
    return y[scs.old_to_new_idx].astype(np.float64)


def rel_err(y, ref):
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300)


MATRICES = {
    "laplace2d": lambda: laplace2d(20),
    "tridiag": lambda: tridiag(500),
    "imbalanced": lambda: random_imbalanced(800, 8, seed=9),
    "impcol_e": lambda: read_mtx(matrix_path("impcol_e.mtx")),
    "bcsstk13": lambda: read_mtx(matrix_path("bcsstk13.mtx")),
}


@pytest.mark.parametrize("prec", ["sp", "dp"])
@pytest.mark.parametrize("C,sigma", [(1, 1), (32, 64)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_kernel_interpret_vs_scipy(name, C, sigma, prec):
    mtx = MATRICES[name]()
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    dt = dtype_for(prec)
    y = run(mtx, C, sigma, x, dt, dt)
    ref = mtx.to_scipy().tocsr() @ x
    assert rel_err(y, ref) < (1e-6 if prec == "sp" else 1e-14)


@pytest.mark.parametrize("bs", [2, 3, 4, 8])
def test_kernel_block_vectors(bs):
    """Row-major block vectors; bs that is not a power of two is padded
    and masked inside the kernel."""
    mtx = random_imbalanced(600, 7, seed=4)
    x = np.random.default_rng(bs).standard_normal((mtx.n_rows, bs))
    y = run(mtx, 32, 1, x)
    assert y.shape == x.shape
    assert rel_err(y, mtx.to_scipy().tocsr() @ x) < 1e-14


def test_kernel_bf16_values_f32_accumulation():
    """hp: bfloat16 values widen to f32 on load; the only error is the
    value quantization."""
    mtx = laplace2d(24)
    x = np.random.default_rng(1).standard_normal(mtx.n_rows)
    y = run(mtx, 32, 1, x, dtype_for("hp"), np.float32)
    ref = mtx.astype(dtype_for("hp")).astype(np.float64).to_scipy() @ x
    assert rel_err(y, ref) < 1e-6


def test_kernel_low_precision_values_high_precision_x():
    """AP rule: sp values against a dp x accumulate in f64."""
    mtx = random_imbalanced(500, 6, seed=2)
    x = np.random.default_rng(2).standard_normal(mtx.n_rows)
    y = run(mtx, 4, 8, x, np.float32, np.float64)
    ref = mtx.astype(np.float32).astype(np.float64).to_scipy() @ x
    assert rel_err(y, ref) < 1e-14


@pytest.mark.parametrize("C", [3, 128, 512])
def test_kernel_chunk_heights_and_tail(C):
    """C that does not divide the program's row block, C larger than it,
    and a row count that leaves a partial last program; empty rows too."""
    rng = np.random.default_rng(C)
    n = ROWS * 3 + 17
    mtx = random_imbalanced(n, 5, seed=C)
    keep = mtx.I % 11 != 0  # every 11th row empty
    mtx = type(mtx).from_arrays(mtx.I[keep], mtx.J[keep], mtx.values[keep],
                                n_rows=n, n_cols=n, is_sorted=True)
    x = rng.standard_normal(n)
    y = run(mtx, C, 1, x)
    assert rel_err(y, mtx.to_scipy().tocsr() @ x) < 1e-14


@pytest.mark.parametrize("prec", ["sp", "dp"])
def test_kernel_lowers_for_cuda(prec):
    """Pallas's Triton lowering accepts the kernel (array-indexed loads,
    the dynamic-trip loop, masks) for CUDA, and the sp program carries no
    64-bit type although the package enables x64."""
    scs, dev = permuted(laplace3d(8), 32, 1, dtype_for(prec))
    x = jnp.zeros(scs.n_rows_padded, dtype_for(prec))
    for xx in (x, jnp.stack([x] * 3, axis=1)):
        txt = (jax.jit(spmv_triton).trace(dev, xx)
               .lower(lowering_platforms=("cuda",)).as_text())
        assert "spmv_scs_triton" in txt
        assert bool(re.search(r"tensor<[0-9x]*f64>", txt)) == (prec == "dp")
        assert not re.search(r"tensor<[0-9x]*i64>", txt)


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["sp", "dp"])
def test_kernel_compiled_on_gpu(gpu, prec):
    """The compiled kernel on the card against scipy."""
    mtx = powerlaw_cols(20_000, 8, seed=5)
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    dt = dtype_for(prec)
    with jax.default_device(gpu):
        y = run(mtx, 32, 128, x, dt, dt, interpret=False)
    ref = mtx.to_scipy().tocsr() @ x
    assert rel_err(y, ref) < (1e-6 if prec == "sp" else 1e-14)


@pytest.mark.gpu
def test_operator_selects_kernel_on_gpu(gpu):
    from uspmv_tpu.runtime.operator import SpmvOperator

    mtx = laplace3d(24)
    op = SpmvOperator.from_mtx(
        Config(chunk_size=32, value_type="sp", backend="gpu"), mtx)
    assert op.impl_name() == "triton-scs"
    x = np.random.default_rng(1).standard_normal(mtx.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    assert rel_err(y, mtx.to_scipy().tocsr() @ x) < 1e-6
