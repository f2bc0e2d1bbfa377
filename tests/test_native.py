"""Parity tests: native C++ host library vs the pure-Python implementations.

The Python paths are the oracle; the native library (native/uspmv_host.cpp)
must reproduce them bit-exactly — including tie order in the sigma-window
sort (both sides use a stable descending sort on the original index).
"""

import numpy as np
import pytest

from uspmv_tpu import native
from uspmv_tpu.formats.coo import MtxData
from uspmv_tpu.formats.scs import convert_to_scs
from uspmv_tpu.io.mmio import read_mtx, write_mtx

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native host library not built"
)


def _random_mtx(rng, n, density=0.05):
    nnz = max(1, int(n * n * density))
    I = rng.integers(0, n, nnz)
    J = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    return MtxData.from_arrays(I, J, v, n_rows=n, n_cols=n).sort_by_row()


def _assert_scs_equal(a, b):
    assert a.n_rows == b.n_rows
    assert a.n_rows_padded == b.n_rows_padded
    assert a.n_chunks == b.n_chunks
    assert a.n_elements == b.n_elements
    np.testing.assert_array_equal(a.chunk_ptrs, b.chunk_ptrs)
    np.testing.assert_array_equal(a.chunk_lengths, b.chunk_lengths)
    np.testing.assert_array_equal(a.col_idxs, b.col_idxs)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.old_to_new_idx, b.old_to_new_idx)
    np.testing.assert_array_equal(a.new_to_old_idx, b.new_to_old_idx)
    np.testing.assert_array_equal(a.row_counts_new, b.row_counts_new)


@pytest.mark.parametrize("C,sigma", [(1, 1), (4, 1), (4, 8), (16, 64), (8, 1024)])
def test_convert_parity_random(C, sigma):
    rng = np.random.default_rng(0)
    mtx = _random_mtx(rng, 101)
    py = convert_to_scs(mtx, C, sigma, native=False)
    nat = convert_to_scs(mtx, C, sigma, native=True)
    _assert_scs_equal(py, nat)


def test_convert_parity_fixed_permutation():
    rng = np.random.default_rng(1)
    mtx = _random_mtx(rng, 64)
    primary = convert_to_scs(mtx, 8, 16, native=False)
    py = convert_to_scs(
        mtx, 8, 16, fixed_permutation=primary.old_to_new_idx, native=False
    )
    nat = convert_to_scs(
        mtx, 8, 16, fixed_permutation=primary.old_to_new_idx, native=True
    )
    _assert_scs_equal(py, nat)


def test_convert_parity_empty_rows():
    # rows 0 and 3 empty; duplicate-free, unsorted columns
    I = [1, 1, 2, 4, 4, 4]
    J = [3, 0, 2, 4, 1, 0]
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    mtx = MtxData.from_arrays(I, J, v, n_rows=5, n_cols=5).sort_by_row()
    for C, sigma in [(1, 1), (2, 4), (4, 2)]:
        _assert_scs_equal(
            convert_to_scs(mtx, C, sigma, native=False),
            convert_to_scs(mtx, C, sigma, native=True),
        )


def test_convert_native_rejects_bad_args():
    mtx = MtxData.from_arrays([0], [0], [1.0], n_rows=1, n_cols=1)
    with pytest.raises(ValueError):
        convert_to_scs(mtx, 0, 1, native=True)


@pytest.mark.parametrize("sym", ["general", "symmetric", "skew-symmetric"])
def test_read_mtx_parity(tmp_path, sym):
    rng = np.random.default_rng(2)
    n = 37
    # build a valid file of the given symmetry: lower triangle only for
    # symmetric kinds
    I = rng.integers(0, n, 200)
    J = rng.integers(0, n, 200)
    if sym != "general":
        I, J = np.maximum(I, J), np.minimum(I, J)
        if sym == "skew-symmetric":
            off = I != J
            I, J = I[off], J[off]
    v = rng.standard_normal(I.size)
    path = tmp_path / "m.mtx"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate real {sym}\n")
        f.write("% a comment\n\n")
        f.write(f"{n} {n} {I.size}\n")
        for i, j, val in zip(I, J, v):
            f.write(f"{i + 1} {j + 1} {val:.17g}\n")

    py = read_mtx(str(path), native=False)
    nat = read_mtx(str(path), native=True)
    assert py.n_rows == nat.n_rows and py.n_cols == nat.n_cols
    assert py.nnz == nat.nnz
    np.testing.assert_array_equal(py.I, nat.I)
    np.testing.assert_array_equal(py.J, nat.J)
    np.testing.assert_array_equal(py.values, nat.values)
    assert py.is_symmetric == nat.is_symmetric


def test_read_mtx_pattern_parity(tmp_path):
    path = tmp_path / "p.mtx"
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write("3 3 4\n1 1\n2 3\n3 1\n3 3\n")
    py = read_mtx(str(path), native=False)
    nat = read_mtx(str(path), native=True)
    np.testing.assert_array_equal(py.I, nat.I)
    np.testing.assert_array_equal(py.J, nat.J)
    np.testing.assert_array_equal(py.values, nat.values)


def test_read_mtx_native_errors(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate real general\n3 4 1\n1 1 1.0\n")
    with pytest.raises(ValueError, match="square"):
        read_mtx(str(bad), native=True)
    trunc = tmp_path / "trunc.mtx"
    trunc.write_text("%%MatrixMarket matrix coordinate real general\n3 3 5\n1 1 1.0\n")
    with pytest.raises(ValueError, match="truncated"):
        read_mtx(str(trunc), native=True)
    with pytest.raises(ValueError):
        read_mtx(str(tmp_path / "missing.mtx"), native=True)


def test_roundtrip_write_native_read(tmp_path):
    rng = np.random.default_rng(3)
    mtx = _random_mtx(rng, 23)
    path = tmp_path / "rt.mtx"
    write_mtx(str(path), mtx)
    nat = read_mtx(str(path), native=True)
    py = read_mtx(str(path), native=False)
    assert nat.nnz == mtx.nnz
    np.testing.assert_array_equal(nat.I, py.I)
    np.testing.assert_array_equal(nat.J, py.J)
    np.testing.assert_array_equal(nat.values, py.values)


# --------------------------------------------- generated matrices, C = 32


def _generated(gen):
    from uspmv_tpu.io.generators import (
        banded_imbalanced, laplace3d, powerlaw_cols,
    )

    return {
        "laplace": lambda: laplace3d(12),
        "banded": lambda: banded_imbalanced(3000, bandwidth=40, seed=3),
        "powerlaw": lambda: powerlaw_cols(3000, 8, seed=4),
    }[gen]()


@pytest.mark.parametrize("sigma", [1, 128])
@pytest.mark.parametrize("gen", ["laplace", "banded", "powerlaw"])
def test_convert_parity_generated(gen, sigma):
    """The GPU kernel's chunk height (C = 32) on the generated matrix
    classes the benchmark uses: native and Python agree bit-exactly."""
    mtx = _generated(gen)
    _assert_scs_equal(
        convert_to_scs(mtx, 32, sigma, native=False),
        convert_to_scs(mtx, 32, sigma, native=True),
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_parity_value_dtypes(dtype):
    """Low-precision value streams (the native f32 fetch casts during the
    copy) match the Python converter's cast."""
    from uspmv_tpu.config import dtype_for

    dt = dtype_for("hp") if dtype == "bfloat16" else np.dtype(dtype)
    mtx = _generated("banded").astype(dt)
    py = convert_to_scs(mtx, 32, 64, native=False)
    nat = convert_to_scs(mtx, 32, 64, native=True)
    assert py.values.dtype == nat.values.dtype == dt
    _assert_scs_equal(py, nat)
