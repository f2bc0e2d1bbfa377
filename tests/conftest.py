"""Test configuration: force the CPU with 8 virtual devices so multi-device
sharding tests run without accelerators, and provide the small MatrixMarket
fixtures the tests read.

The fixture matrices are generated from fixed seeds into a per-process
temporary directory on first use. Each stands in for the reference's test
matrix of the same name and keeps the property the tests rely on:

  impcol_e.mtx   225 x 225 general, ~1.3k nnz, values spread over six
                 decades (ill-scaled), no empty rows
  FDM-2d-16.mtx  5-point 2-D finite-difference Laplacian on a 16 x 16
                 grid, stored as a symmetric (lower-triangle) file
  bcsstk13.mtx   2003 x 2003 symmetric stiffness-like matrix: negative
                 off-diagonals spread over 1e-6..1e8, diagonal = the sum
                 of their magnitudes + a small shift, so y = A * const
                 cancels to a small result (ill-conditioned, as the
                 adaptive-precision thresholds need)
  matrix1.mtx    9 x 9 general with an empty row and an empty column
  matrix1int.mtx the same structure, declared 'integer'
"""

import os
import tempfile

# must be set before jax initializes its backends
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where the process has none.
    Decided here, at run time, never at import or collection."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (run with the 'gpu' marker on one)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _impcol_e():
    rng = np.random.default_rng(225)
    n = 225
    rows, cols = [np.arange(n)], [np.arange(n)]
    for _ in range(5):
        rows.append(np.arange(n))
        cols.append(rng.integers(0, n, n))
    I, J = np.concatenate(rows), np.concatenate(cols)
    keep = np.unique(I * n + J, return_index=True)[1]
    I, J = I[keep], J[keep]
    vals = rng.choice([-1.0, 1.0], I.size) * 10.0 ** rng.uniform(-2, 4, I.size)
    return "general", "real", n, I, J, vals


def _fdm_2d_16():
    from uspmv_tpu.io.generators import laplace2d

    m = laplace2d(16)
    low = m.I >= m.J
    return "symmetric", "real", m.n_rows, m.I[low], m.J[low], m.values[low]


def _bcsstk13():
    rng = np.random.default_rng(2003)
    n = 2003
    I = np.repeat(np.arange(n), 10)
    J = I - rng.integers(1, 60, I.size)
    ok = J >= 0
    I, J = I[ok], J[ok]
    keep = np.unique(I * n + J, return_index=True)[1]
    I, J = I[keep], J[keep]
    off = -(10.0 ** rng.uniform(-6, 8, I.size))
    absum = np.bincount(I, -off, n) + np.bincount(J, -off, n)
    diag = absum + rng.uniform(0.005, 0.02, n)
    idx = np.arange(n)
    return ("symmetric", "real", n, np.concatenate([idx, I]),
            np.concatenate([idx, J]), np.concatenate([diag, off]))


def _matrix1(field="real"):
    a = np.zeros((9, 9))
    a[np.arange(9), np.arange(9)] = np.arange(1, 10)
    a[0, 8], a[3, 1], a[5, 7], a[8, 0] = 2.5, -1.5, 4.0, 3.0
    a[4, :] = 0.0  # empty row
    a[:, 6] = 0.0  # empty column
    if field == "integer":
        a = np.round(a)
    I, J = np.nonzero(a)
    return "general", field, 9, I, J, a[I, J]


MATRICES = {
    "impcol_e.mtx": _impcol_e,
    "FDM-2d-16.mtx": _fdm_2d_16,
    "bcsstk13.mtx": _bcsstk13,
    "matrix1.mtx": _matrix1,
    "matrix1int.mtx": lambda: _matrix1("integer"),
}
_DIR = []


def matrix_path(name: str) -> str:
    """Path of fixture matrix ``name``, written on first use."""
    if not _DIR:
        _DIR.append(tempfile.mkdtemp(prefix="uspmv_mtx_"))
    path = os.path.join(_DIR[0], name)
    if not os.path.exists(path):
        symmetry, field, n, I, J, vals = MATRICES[name]()
        fmt = "%d %d %d" if field == "integer" else "%d %d %.17g"
        with open(path, "w") as f:
            f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
            f.write(f"% generated test fixture standing in for {name}\n")
            f.write(f"{n} {n} {len(I)}\n")
            np.savetxt(f, np.column_stack([I + 1, J + 1, vals]), fmt=fmt)
    return path
