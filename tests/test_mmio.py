"""MatrixMarket ingest tests — validated against scipy.io as oracle
(the reference validates against its vendored NIST mmio; SURVEY.md §2 #2-3)."""

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from uspmv_tpu.io.mmio import read_mtx, write_mtx
from uspmv_tpu.formats.coo import MtxData

from conftest import MATRICES, matrix_path

ALL_MATRICES = sorted(MATRICES)


@pytest.mark.parametrize("name", ALL_MATRICES)
def test_read_matches_scipy(name):
    path = matrix_path(name)
    try:
        ours = read_mtx(path)
    except ValueError as e:
        if "square" in str(e):
            pytest.skip("non-square matrix rejected by design")
        raise
    ref = scipy.io.mmread(path).tocsr().astype(np.float64)
    got = ours.to_scipy().tocsr()
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz  # symmetric expansion matches scipy's
    with open(path) as f:
        banner = f.readline()
    if "integer" in banner:
        # the reference reads integer files as double too
        # (mm_read_unsymmetric_sparse<double>, fscanf %lg); ours matches
        assert abs(got - ref).max() == 0.0
    else:
        assert abs(got - ref).max() == 0.0


def test_rows_sorted():
    m = read_mtx(matrix_path("impcol_e.mtx"))
    assert np.all(np.diff(m.I) >= 0)
    assert m.is_sorted


def test_symmetric_expansion_mirrors_offdiag(tmp_path):
    p = tmp_path / "sym.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real symmetric\n"
        "3 3 4\n"
        "1 1 1.0\n"
        "2 1 2.0\n"
        "3 2 3.0\n"
        "3 3 4.0\n"
    )
    m = read_mtx(str(p))
    d = m.to_scipy().toarray()
    expect = np.array([[1, 2, 0], [2, 0, 3], [0, 3, 4]], dtype=float)
    np.testing.assert_array_equal(d, expect)


def test_pattern_reads_ones(tmp_path):
    p = tmp_path / "pat.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate pattern general\n"
        "2 2 2\n"
        "1 2\n"
        "2 1\n"
    )
    m = read_mtx(str(p))
    np.testing.assert_array_equal(np.sort(m.values), [1.0, 1.0])


def test_rejects_nonsquare(tmp_path):
    p = tmp_path / "rect.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate real general\n2 3 1\n1 1 1.0\n"
    )
    with pytest.raises(ValueError, match="square"):
        read_mtx(str(p))
    m = read_mtx(str(p), require_square=False)
    assert (m.n_rows, m.n_cols) == (2, 3)


def test_rejects_complex(tmp_path):
    p = tmp_path / "cplx.mtx"
    p.write_text(
        "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1.0 0.0\n"
    )
    with pytest.raises(ValueError, match="complex"):
        read_mtx(str(p))


def test_write_read_roundtrip(tmp_path, rng):
    n = 20
    mat = sp.random(n, n, density=0.2, random_state=7, dtype=np.float64)
    mtx = MtxData.from_scipy(mat)
    p = tmp_path / "rt.mtx"
    write_mtx(str(p), mtx, comment="roundtrip test")
    back = read_mtx(str(p))
    assert abs(back.to_scipy() - mat.tocsr()).max() < 1e-14
