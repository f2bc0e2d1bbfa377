"""Device primitive microbenchmarks: the gathers, scatters and streams an
SpMV is built from, as XLA compiles them for the default device.

Every measurement loops the op inside one jitted fori_loop with a genuine
loop-carried dependence (runtime-zero eps scaling) and fetches a scalar
reduction, measuring (t(n2)-t(n1))/(n2-n1) to cancel fixed dispatch and
fetch overhead. The first line names the device.

Usage: python scripts/microbench.py [case ...]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def measure(make_op, n1=20, n2=100):
    """make_op() -> (f, args) where f(args, carry_scalar) -> array;
    returns seconds per iteration."""
    f, args = make_op()

    def run(args, eps, n):
        def body(i, c):
            y = f(args, c * eps)
            # full reduction: every output element feeds the carry, so XLA
            # cannot dead-code-eliminate any part of the op
            return jnp.sum(y, dtype=jnp.float32) * eps + c + 1.0

        return jax.lax.fori_loop(0, n, body, jnp.float32(0.0))

    jr = jax.jit(run)
    eps = jnp.float32(0.0)
    float(jr(args, eps, 2))  # compile + warm
    ts = {}
    for n in (n1, n2):
        t0 = time.perf_counter()
        float(jr(args, eps, n))
        ts[n] = time.perf_counter() - t0
    return (ts[n2] - ts[n1]) / (n2 - n1)


def main():
    n = 1 << 18
    E = 1 << 21
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    cols = jnp.asarray(rng.integers(0, n, E), dtype=jnp.int32)
    vals = jnp.asarray(rng.standard_normal(E), dtype=jnp.float32)
    rows_sorted = jnp.asarray(np.sort(rng.integers(0, n, E)).astype(np.int32))

    cases = {}

    cases["stream_mul"] = (
        lambda: (lambda a, c: a[0] * 2.0 + c, (vals,)),
        2 * E * 4,
    )
    cases["take_1d"] = (
        lambda: (lambda a, c: a[0][a[1]] + c, (x, cols)),
        E * 8,
    )
    cases["take_mul"] = (
        lambda: (lambda a, c: a[2] * (a[0][a[1]] + c), (x, cols, vals)),
        E * 12,
    )
    cases["scatter_add"] = (
        lambda: (
            lambda a, c: jnp.zeros(n, jnp.float32).at[a[1]].add(a[0] + c),
            (vals, cols),
        ),
        E * 8,
    )
    cases["segsum_sorted"] = (
        lambda: (
            lambda a, c: jax.ops.segment_sum(
                a[0] + c, a[1], num_segments=n, indices_are_sorted=True
            ),
            (vals, rows_sorted),
        ),
        E * 8,
    )

    diags = jnp.asarray(rng.standard_normal((7, n)), dtype=jnp.float32)

    def dia(a, c):
        d, xx = a
        y = 0.0
        for k, off in enumerate([-4096, -64, -1, 0, 1, 64, 4096]):
            y = y + d[k] * jnp.roll(xx + c, off)
        return y

    cases["dia_7"] = (lambda: (dia, (diags, x)), 9 * n * 4)

    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind}")
    sel = sys.argv[1:] or list(cases)
    for name in sel:
        mk, nbytes = cases[name]
        dt = measure(mk)
        print(f"{name:20s}: {dt*1e3:9.3f} ms/iter  {nbytes/dt/1e9:8.1f} GB/s")


if __name__ == "__main__":
    main()
