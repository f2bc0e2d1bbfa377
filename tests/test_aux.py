"""Auxiliary subsystems: sanity checker, profiling hooks, ScaMaC generators,
embedding interface (SURVEY.md §2 #4, #28, #30, #34)."""

import numpy as np
import pytest

from uspmv_tpu.formats.coo import MtxData
from uspmv_tpu.io.generators import generate_matrix, laplace2d
from uspmv_tpu.io.scamac import anderson, scamac_generate, spin_chain_xxz
from uspmv_tpu.runtime.sanity import SanityChecker
from uspmv_tpu.runtime import profiling


# ------------------------------------------------------------------ scamac


def test_anderson_structure():
    m = anderson(4, 4, 4, disorder=10.0, seed=3)
    assert m.n_rows == 64
    d = m.to_scipy().toarray()
    np.testing.assert_allclose(d, d.T)  # symmetric
    off = d - np.diag(np.diag(d))
    assert set(np.unique(off)) <= {0.0, -1.0}  # hopping -1
    assert np.abs(np.diag(d)).max() <= 5.0  # disorder/2
    # interior site has 6 neighbors
    assert (off != 0).sum(axis=1).max() == 6


def test_spin_chain_hermitian_and_magnon():
    m = spin_chain_xxz(L=6, Jxy=1.0, Jz=0.7, Bz=0.0)
    assert m.n_rows == 64
    d = m.to_scipy().toarray()
    np.testing.assert_allclose(d, d.T)
    # all-up state |111111> is an eigenstate with energy Jz*L_bonds/4
    e = d[-1, -1]
    np.testing.assert_allclose(e, 0.7 * 5 / 4.0)
    assert np.count_nonzero(d[-1]) == 1  # no spin flips possible


def test_hubbard_dimer_exact_spectrum():
    # half-filled Hubbard dimer: eigenvalues 0, U, (U +- sqrt(U^2+16t^2))/2
    from uspmv_tpu.io.scamac import hubbard

    U, t = 1.3, 1.0
    m = hubbard(n_sites=2, n_fermions=1, t=t, U=U)
    assert m.n_rows == 4
    d = m.to_scipy().toarray()
    np.testing.assert_allclose(d, d.T)
    ev = np.sort(np.linalg.eigvalsh(d))
    r = np.sqrt(U * U + 16 * t * t)
    np.testing.assert_allclose(
        ev, np.sort([0.0, U, (U - r) / 2, (U + r) / 2]), atol=1e-12
    )


def test_hubbard_free_fermion_ring_spectrum():
    # U=0 on a periodic ring: the spectrum must be sums of distinct
    # single-particle energies -2t cos(2 pi k / n) per spin species.
    # A wrong fermionic sign on the wrap-around bond breaks this.
    from itertools import combinations

    from uspmv_tpu.io.scamac import hubbard

    n, nf = 5, 2
    m = hubbard(n_sites=n, n_fermions=nf, t=1.0, U=0.0, pbc=1)
    e1 = -2.0 * np.cos(2 * np.pi * np.arange(n) / n)
    sector = np.sort([sum(c) for c in combinations(e1, nf)])
    full = np.sort((sector[:, None] + sector[None, :]).ravel())
    ev = np.sort(np.linalg.eigvalsh(m.to_scipy().toarray()))
    np.testing.assert_allclose(ev, full, atol=1e-10)


def test_hubbard_reference_example_spec():
    # the reference's canonical ScaMaC example string (utilities.hpp:1610)
    from math import comb

    m = scamac_generate("Hubbard,n_sites=10,n_fermions=5,U=1.3")
    assert m.n_rows == comb(10, 5) ** 2
    A = m.to_scipy().tocsr()
    assert abs(A - A.T).nnz == 0  # hermitian
    diag = A.diagonal()
    np.testing.assert_allclose(diag.max(), 1.3 * 5)  # max double occupancy
    assert diag.min() == 0.0


def test_hubbard_ranpot_and_guards():
    from uspmv_tpu.io.scamac import hubbard

    a = hubbard(n_sites=4, n_fermions=2, U=0.5, ranpot=0.3, seed=7)
    b = hubbard(n_sites=4, n_fermions=2, U=0.5, ranpot=0.3, seed=7)
    np.testing.assert_array_equal(a.values, b.values)  # reproducible
    d = a.to_scipy().toarray()
    np.testing.assert_allclose(d, d.T)
    with pytest.raises(ValueError, match="n_fermions"):
        hubbard(n_sites=3, n_fermions=4)
    with pytest.raises(ValueError, match="memory|nonzeros"):
        hubbard(n_sites=20, n_fermions=10)


def test_free_fermion_chain_spectrum():
    """Ground energy of the fixed-filling sector equals the sum of the
    n_fermions lowest single-particle energies of the open chain,
    eps_j = -2t cos(j pi / (n+1)) — the free-fermion exactness the
    ScaMaC FreeFermionChain model is defined by."""
    from uspmv_tpu.io.scamac import free_fermion_chain

    n, nf, t = 8, 4, 1.3
    m = free_fermion_chain(n_sites=n, n_fermions=nf, t=t)
    A = m.to_scipy().toarray()
    ev = np.linalg.eigvalsh(A)
    sp = -2.0 * t * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    assert abs(ev[0] - np.sort(sp)[:nf].sum()) < 1e-10


def test_harmonic_shifted_oscillator_spectrum():
    """H = w b+b + l (b+ + b) has exact eigenvalues w*n - l^2/w; the
    truncated Fock matrix reproduces the low end to rounding."""
    from uspmv_tpu.io.scamac import harmonic

    w, lam = 1.0, 0.5
    m = harmonic(n_bos=60, omega=w, lambda_=lam)
    ev = np.linalg.eigvalsh(m.to_scipy().toarray())
    want = w * np.arange(5) - lam**2 / w
    assert np.abs(ev[:5] - want).max() < 1e-8
    # spec-string routing
    m2 = scamac_generate("Harmonic,n_bos=16,omega=2.0,lambda=0.1")
    assert m2.n_rows == 16
    m3 = scamac_generate("FreeFermionChain,n_sites=6,n_fermions=3,ranpot=1.0")
    assert m3.n_rows == 20  # C(6,3)


def test_scamac_spec_parsing():
    m = scamac_generate("Anderson,Lx=3,Ly=3,Lz=2,disorder=4.0,seed=9")
    assert m.n_rows == 18
    m2 = generate_matrix("SpinChainXXZ,L=4")  # routed through generators
    assert m2.n_rows == 16
    with pytest.raises(ValueError, match="unknown"):
        generate_matrix("NoSuchModel,x=1")


# ------------------------------------- SuiteSparse-structure generators


def test_fem_tet3d_structure():
    # Queen_4147-class structure at toy size: 20-80 nnz/row, symmetric,
    # diagonally dominant, clustered bandwidth
    from uspmv_tpu.io.generators import fem_tet3d

    m = fem_tet3d(12)
    assert m.n_rows == 12**3 * 3
    c = np.bincount(m.I, minlength=m.n_rows)
    assert 20 <= np.median(c) <= 80
    A = m.to_scipy().tocsr()
    assert abs(A - A.T).nnz == 0
    d = np.abs(A.diagonal())
    off = np.asarray(np.abs(A).sum(axis=1)).ravel() - d
    assert np.all(d >= off)  # CG-friendly
    # bandwidth is clustered, not global: median |i-j| well under n
    bw = np.abs(m.I - m.J)
    assert np.median(bw[bw > 0]) < m.n_rows // 8


def test_stokes_saddle_structure():
    from uspmv_tpu.io.generators import stokes_saddle

    nx = 8
    m = stokes_saddle(nx)
    n = nx**3
    assert m.n_rows == 4 * n
    S = (m.to_scipy().tocsr() != 0).astype(np.int8)
    assert abs(S - S.T).nnz == 0  # structurally symmetric
    c = np.bincount(m.I, minlength=m.n_rows)
    vel, pres = c[: 3 * n], c[3 * n:]
    # mixed row-length profile: velocity rows are denser than pressure rows
    assert np.median(vel) > np.median(pres)


def test_fem_generator_solves_through_operator():
    from uspmv_tpu.io.generators import fem_tet3d
    from uspmv_tpu.config import Config
    from uspmv_tpu.runtime.operator import SpmvOperator

    m = fem_tet3d(6)
    cfg = Config(kernel_format="scs", chunk_size=16, sigma=64,
                 value_type="dp", backend="cpu")
    op = SpmvOperator.from_mtx(cfg, m)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(m.n_rows)
    y = op.to_host(np.asarray(op.spmv(op.make_x(x))))
    ref = m.to_scipy().tocsr() @ x
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)


def test_generator_specs_route():
    m = generate_matrix("FemTet3D,5")
    assert m.n_rows == 5**3 * 3
    m2 = generate_matrix("StokesSaddle,5")
    assert m2.n_rows == 4 * 5**3


# ------------------------------------------------------------------ sanity


def test_sanity_checker_dumps_and_checks(tmp_path):
    c = SanityChecker(str(tmp_path), rank=0)
    c.dump_stage("before_spmv", x=np.arange(4.0), y=np.zeros(4))
    c.check_perm(np.array([2, 0, 1]))
    with pytest.raises(AssertionError, match="bijection|range"):
        c.check_perm(np.array([0, 0, 1]))
    c.check_finite("ok", np.ones(3))
    with pytest.raises(AssertionError, match="non-finite"):
        c.check_finite("bad", np.array([1.0, np.nan]))
    text = open(c.path).read()
    assert "before_spmv.x" in text and "before_spmv.y" in text


def test_sanity_checker_scs_padding():
    from uspmv_tpu.formats.scs import convert_to_scs

    mtx = laplace2d(8)
    scs = convert_to_scs(mtx, 16, 16)
    SanityChecker(".", enabled=True).check_scs_padding(scs)
    # corrupt one padding slot
    pad = np.flatnonzero(scs.padding_mask())
    if pad.size:
        scs.values[pad[0]] = 7.0
        with pytest.raises(AssertionError, match="padding"):
            SanityChecker(".", enabled=True).check_scs_padding(scs)


# --------------------------------------------------------------- profiling


def test_profiling_markers_and_trace(capsys):
    with profiling.marker("spmv_scs_benchmark"):
        _ = np.ones(4).sum()
    assert "spmv_scs_benchmark" in profiling.registered_markers()
    with profiling.trace():  # host-timer fallback path
        _ = np.ones(4).sum()
    assert "region took" in capsys.readouterr().out

    from uspmv_tpu.config import Config

    cfg = Config(kernel_format="scs", chunk_size=2, value_type="sp",
                 block_vec_size=4)
    assert profiling.kernel_marker_name(cfg) == "block_spmv_scs_benchmark"


# --------------------------------------------------------------- interface


def test_interface_prepare_execute():
    import uspmv_tpu.interface as ui

    mtx = laplace2d(12)
    h = ui.prepare(mtx, C=4, sigma=8, value_type="dp", backend="cpu")
    x = np.random.default_rng(0).standard_normal(mtx.n_rows)
    y = ui.execute_uspmv(h, x)
    ref = mtx.to_scipy().tocsr() @ x
    np.testing.assert_allclose(y, ref, rtol=1e-12, atol=1e-12)
    # repeated-SpMV solve
    y3 = ui.execute_uspmv(h, x, n_repetitions=3)
    A = mtx.to_scipy().tocsr()
    np.testing.assert_allclose(y3, A @ (A @ (A @ x)), rtol=1e-10, atol=1e-10)


def test_interface_accepts_scipy_and_dense():
    import scipy.sparse as sp

    import uspmv_tpu.interface as ui

    rng = np.random.default_rng(1)
    dense = np.triu(rng.standard_normal((9, 9)))
    h = ui.prepare(dense, backend="cpu")  # CRS by default
    x = rng.standard_normal(9)
    np.testing.assert_allclose(
        ui.execute_uspmv(h, x), dense @ x, rtol=1e-12, atol=1e-12
    )
    h2 = ui.prepare(sp.csr_matrix(dense), C=2, sigma=2, backend="cpu")
    np.testing.assert_allclose(
        ui.execute_uspmv(h2, x), dense @ x, rtol=1e-12, atol=1e-12
    )


def test_interface_device_resident_reuse():
    # upload once, iterate on device, download once — must equal the
    # host-roundtrip path exactly
    import uspmv_tpu.interface as ui

    rng = np.random.default_rng(4)
    mtx = laplace2d(12)
    h = ui.prepare(mtx, C=4, sigma=8, value_type="dp", backend="cpu")
    x = rng.standard_normal(mtx.n_rows)
    xd = ui.upload_x(h, x)
    for _ in range(3):
        xd = ui.execute_uspmv(h, xd, device_resident=True)
    y_dev = ui.download_y(h, xd)
    y_host = ui.execute_uspmv(h, x, n_repetitions=3)
    np.testing.assert_array_equal(y_dev, y_host)


def test_interface_reference_host_kernel():
    import uspmv_tpu.interface as ui
    from uspmv_tpu.formats.scs import convert_to_scs

    mtx = laplace2d(10)
    scs = convert_to_scs(mtx, 8, 16)
    x = np.random.default_rng(2).standard_normal(mtx.n_rows)
    np.testing.assert_allclose(
        ui.spmv_reference_host(scs, x), mtx.to_scipy().tocsr() @ x,
        rtol=1e-12, atol=1e-12,
    )


def test_scamac_models_listing():
    from uspmv_tpu.io.scamac import scamac_models

    ms = scamac_models()
    assert "anderson" in ms and "spinchainxxz" in ms and "tridiagonal" in ms


def test_scamac_option_errors_propagate():
    with pytest.raises(ValueError, match="exceed memory"):
        generate_matrix("SpinChainXXZ,L=30")
    with pytest.raises(ValueError, match="bad ScaMaC option"):
        generate_matrix("Anderson,badopt")


def test_cg_example_converges():
    """The embedding example (examples/cg_solver.py) converges on the
    operator's SpMV closure — the 'embed SpMV in your own solver' use case
    of the reference's interface.hpp."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "cg_solver",
        os.path.join(os.path.dirname(__file__), "..", "examples",
                     "cg_solver.py"),
    )
    cg_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cg_mod)

    import uspmv_tpu.interface as ui
    from uspmv_tpu.io.generators import laplace2d

    mtx = laplace2d(24)
    h = ui.prepare(mtx, C=32, sigma=1, value_type="sp", backend="cpu")
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(mtx.n_rows)
    b = mtx.to_scipy().tocsr() @ x_true
    x, it, res = cg_mod.cg(h, b, tol=1e-5, maxiter=400)
    assert res < 1e-4
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-2


def test_spin_chain_xy_matches_dense_kron():
    """Exact check against a dense Pauli-kron construction (L=3)."""
    from uspmv_tpu.io.scamac import spin_chain_xy

    L, Jx, Jy, Bz = 3, 1.3, 0.7, 0.25
    sx = np.array([[0, 1], [1, 0]]) / 2.0
    sy = np.array([[0, -1j], [1j, 0]]) / 2.0
    # generator convention: basis index = bit pattern, bit 0 <=> spin DOWN
    sz = np.array([[-1, 0], [0, 1]]) / 2.0
    eye = np.eye(2)

    def op(single, site):
        # site s acts on bit s: tensor order matches the bit encoding
        # (state bit i = spin i), kron builds from the HIGHEST site down
        mats = [eye] * L
        mats[L - 1 - site] = single
        out = mats[0]
        for m in mats[1:]:
            out = np.kron(out, m)
        return out

    H = np.zeros((2 ** L, 2 ** L), dtype=complex)
    for i in range(L - 1):
        H += Jx * op(sx, i) @ op(sx, i + 1)
        H += Jy * op(sy, i) @ op(sy, i + 1)
    for i in range(L):
        H += Bz * op(sz, i)
    m = spin_chain_xy(L=L, Jx=Jx, Jy=Jy, Bz=Bz)
    np.testing.assert_allclose(
        m.to_scipy().toarray(), H.real, atol=1e-12
    )
    assert np.abs(H.imag).max() < 1e-12


def test_spin_chain_xy_isotropic_equals_xxz_jz0():
    from uspmv_tpu.io.scamac import spin_chain_xy, spin_chain_xxz

    a = spin_chain_xy(L=8, Jx=1.0, Jy=1.0, Bz=0.0)
    b = spin_chain_xxz(L=8, Jxy=1.0, Jz=0.0, Bz=0.0)
    assert abs(a.to_scipy() - b.to_scipy()).max() < 1e-12


def test_bose_hubbard_exact_small():
    from math import comb

    from uspmv_tpu.io.scamac import bose_hubbard

    # L=2, N=2, U=0: H = [[0,-r2,0],[-r2,0,-r2],[0,-r2,0]], eigs {0, +-2}
    m = bose_hubbard(n_sites=2, n_bosons=2, t=1.0, U=0.0)
    assert m.n_rows == comb(3, 2)
    ev = np.sort(np.linalg.eigvalsh(m.to_scipy().toarray()))
    np.testing.assert_allclose(ev, [-2.0, 0.0, 2.0], atol=1e-12)
    # hermitian + correct dimension + interaction diagonal
    m2 = bose_hubbard(n_sites=5, n_bosons=4, t=0.7, U=2.0, pbc=1)
    assert m2.n_rows == comb(8, 4)
    A = m2.to_scipy()
    assert abs(A - A.T).max() < 1e-12
    # max diagonal = all bosons on one site: U/2 * N(N-1)
    np.testing.assert_allclose(A.diagonal().max(), 2.0 / 2 * 4 * 3)


def test_new_scamac_specs_parse():
    from uspmv_tpu.io.scamac import scamac_generate, scamac_models

    assert "spinchainxy" in scamac_models()
    assert "bosehubbard" in scamac_models()
    m = scamac_generate("SpinChainXY,L=6,Jx=1.0,Jy=0.5,pbc=1")
    assert m.n_rows == 64
    m2 = scamac_generate("BoseHubbard,n_sites=4,n_bosons=3,U=1.5")
    assert m2.n_rows == 20
