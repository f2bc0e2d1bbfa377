"""Profiling hooks — the LIKWID marker analogue.

The reference brackets each kernel variant in LIKWID marker regions
(register_likwid_markers, utilities.hpp:2686-2770; markers inside kernels
e.g. kernels.hpp:41-61) and measures bandwidth externally with
likwid-perfctr. The JAX equivalents:

  * named regions -> jax.profiler.TraceAnnotation / StepTraceAnnotation,
    visible in a captured XLA trace;
  * trace capture  -> jax.profiler.trace(logdir), viewable in TensorBoard /
    Perfetto;
  * bandwidth accounting -> the same byte model the reference uses
    (BenchResult.effective_gbps), computed from stream sizes.

All hooks are no-ops unless enabled, so production paths carry zero cost.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

_REGISTERED: Dict[str, int] = {}


def register_marker(name: str) -> None:
    """Pre-register a region name (reference register_likwid_markers runs a
    registration pass before the timed loop so first-touch cost is not
    measured)."""
    _REGISTERED.setdefault(name, 0)


def registered_markers() -> tuple:
    return tuple(_REGISTERED)


@contextlib.contextmanager
def marker(name: str, enabled: bool = True) -> Iterator[None]:
    """Named trace region around device work (LIKWID_MARKER_START/STOP
    analogue). Shows up in jax profiler traces; also counts entries."""
    if not enabled:
        yield
        return
    import jax

    register_marker(name)
    _REGISTERED[name] += 1
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, enabled: bool = True) -> Iterator[None]:
    """Capture a device trace to ``logdir`` (likwid-perfctr analogue).
    With logdir=None, times the region on the host and prints a one-line
    summary instead."""
    if not enabled:
        yield
        return
    import jax

    if logdir is not None:
        with jax.profiler.trace(logdir):
            yield
        return
    t0 = time.perf_counter()
    yield
    print(f"[uspmv profiling] region took {time.perf_counter() - t0:.6f}s")


def kernel_marker_name(config) -> str:
    """Region name per kernel variant, mirroring the reference's names
    (e.g. 'spmv_scs_adv_benchmark', utilities.hpp:2686-2770)."""
    fmt = config.kernel_format
    block = "block_" if config.block_vec_size > 1 else ""
    ap = "_ap" if config.is_ap else ""
    return f"{block}spmv_{fmt}{ap}_benchmark"
