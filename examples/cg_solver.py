#!/usr/bin/env python
"""Conjugate-gradient solve built on the embedding API.

Demonstrates what a user of the reference library would do with
``interface.hpp`` — embed the SpMV kernel inside their own iterative solver —
done the JAX way: the operator's raw closure composes into one jitted CG
step, so the whole iteration (SpMV + dots + axpys) stays on device.

Usage: python examples/cg_solver.py [matrix.mtx | 'Laplace3D,48'] [--tol 1e-6]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def cg(op, b_host, tol=1e-6, maxiter=500):
    """CG on the device layout; returns (x_host, n_iters, rel_residual)."""
    import jax
    import jax.numpy as jnp

    import functools

    spmv = op.build_spmv_closure()
    args = op.kernel_args

    b = op.make_x(b_host)

    def step(args, state):
        x, r, p, rs = state
        Ap = spmv(args, p)
        alpha = rs / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.vdot(r, r)
        p = r + (rs_new / rs) * p
        return (x, r, p, rs_new)

    # Batch BATCH iterations inside ONE launch (lax.scan): the residual is
    # only inspected every BATCH iterations anyway, and per-launch dispatch
    # overhead dominates CG on small matrices (the same launch-bound tax
    # the fused solve kernel removes for -mode s; reference solve loop
    # main.cpp:528-607 pays nothing per iteration).
    BATCH = 25

    @functools.partial(jax.jit, static_argnums=2)
    def steps(args, state, n):
        return jax.lax.scan(
            lambda s, _: (step(args, s), None), state, None, length=n
        )[0]

    x = jnp.zeros_like(b)
    r = b
    p = b
    rs = jnp.vdot(r, r)
    b_norm = float(jnp.sqrt(rs))
    state = (x, r, p, rs)
    it = 0
    res = 1.0
    while it < maxiter:
        n = min(BATCH, maxiter - it)
        state = steps(args, state, n)
        it += n
        # one device sync per batch, not per iteration
        res = float(jnp.sqrt(state[3])) / b_norm
        if res <= tol:
            break
    res = float(jnp.sqrt(state[3])) / b_norm
    return op.to_host(state[0]), it, res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("matrix", nargs="?", default="Laplace3D,48")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    args = ap.parse_args()

    import uspmv_tpu.interface as ui
    from uspmv_tpu.cli import load_matrix

    mtx = load_matrix(args.matrix)  # SPD needed for CG (Laplacians are)
    h = ui.prepare(mtx, C=32, sigma=1, value_type="sp")
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(mtx.n_rows)
    b = mtx.to_scipy().tocsr() @ x_true

    x, it, res = cg(h, b, tol=args.tol, maxiter=args.maxiter)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    print(f"CG: {it} iterations, rel residual {res:.2e}, "
          f"solution rel error {err:.2e} ({mtx.n_rows} rows, {mtx.nnz} nnz)")
    return 0 if res <= args.tol * 10 else 1


if __name__ == "__main__":
    sys.exit(main())
