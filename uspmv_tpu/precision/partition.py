"""Adaptive-precision nonzero partitioning.

Re-design of the reference's ``partition_precisions`` (utilities.hpp:
2810-3123): split a COO matrix's nonzeros into dp/sp/hp sub-matrices by
magnitude thresholds, so a low-|value| element is stored and multiplied in a
cheaper precision while the accumulation stays in the highest precision.

Semantics replicated exactly:
  * two-way ap[dp_sp]  : |a| >= th1 -> dp, else sp            (:2878-2927)
  * two-way ap[dp_hp]  : |a| >= th1 -> dp, else hp            (:2929-2983)
  * two-way ap[sp_hp]  : |a| >= th1 -> sp, else hp            (:2984-3041)
  * three-way ap[dp_sp_hp] with 0 <= th2 <= th1:
        |a| >= th1 -> dp; th2 <= |a| < th1 -> sp; |a| < th2 -> hp (:3042-3121)
  * with -equilibrate the element-wise test threshold is rescaled to
        th / (largest_col_elems[j] * largest_row_elems[i])      (:2883-2884)
  * element-count conservation is checked                       (:2922-2926)

Extension beyond the reference: the -dropout / -dropout_threshold flags are
parsed but never applied there (declared, unimplemented; SURVEY.md §2 #9).
Here dropout=True drops elements with |a| < dropout_threshold (after
equilibration scaling when enabled) before bucketing, and reports the count.

Here "hp" is bfloat16 (the reference uses _Float16 via HAVE_HALF_MATH).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..config import dtype_for
from ..formats.coo import MtxData

# machine epsilon of float32 over 2, as in the reference's threshold recipe
_HALF_EPS_SP = 0.5 * 2.0**-23


def ap_threshold_from_norm(mtx: MtxData, tol: float) -> float:
    """Threshold recipe from the reference's scripts/get_buckets.py:
    th = tol * ||A||_inf / (0.5 * 2^-23)."""
    rowsums = np.zeros(mtx.n_rows, dtype=np.float64)
    np.add.at(rowsums, mtx.I, np.abs(mtx.values.astype(np.float64)))
    norm_inf = float(rowsums.max()) if rowsums.size else 0.0
    return tol * norm_inf / _HALF_EPS_SP


def _bucket_masks(
    absvals: np.ndarray,
    precisions: Tuple[str, ...],
    th1: float,
    th2: float,
    scale: Optional[np.ndarray],
) -> Dict[str, np.ndarray]:
    """Boolean mask per precision bucket, highest precision first."""
    if scale is not None:
        # equilibrated: compare |a| against th / (maxcol_j * maxrow_i)
        t1 = th1 / scale
        t2 = th2 / scale
    else:
        t1 = th1
        t2 = th2
    if len(precisions) == 2:
        hi = absvals >= t1
        return {precisions[0]: hi, precisions[1]: ~hi}
    assert precisions == ("dp", "sp", "hp")
    dp = absvals >= t1
    hp = absvals < t2
    sp = ~dp & ~hp
    return {"dp": dp, "sp": sp, "hp": hp}


def partition_precisions(
    mtx: MtxData,
    value_type: str,
    ap_threshold_1: float,
    ap_threshold_2: float = 0.0,
    equilibrate: bool = False,
    largest_row_elems: Optional[np.ndarray] = None,
    largest_col_elems: Optional[np.ndarray] = None,
    dropout: bool = False,
    dropout_threshold: float = 0.0,
) -> Tuple[Dict[str, MtxData], int]:
    """Split ``mtx`` into per-precision COO sub-matrices.

    Returns ``(sub_matrices, n_dropped)`` where ``sub_matrices`` maps
    precision name -> MtxData (values cast to that precision's dtype),
    ordered highest precision first. All sub-matrices keep the full
    (n_rows, n_cols) shape so they can share one row permutation
    (reference fixed_permutation mechanism, main.cpp:1170-1221).
    """
    if not (value_type.startswith("ap[") and value_type.endswith("]")):
        raise ValueError(f"not an adaptive value type: {value_type!r}")
    precisions = tuple(value_type[3:-1].split("_"))
    if precisions not in (("dp", "sp"), ("dp", "hp"), ("sp", "hp"), ("dp", "sp", "hp")):
        raise ValueError(f"unknown adaptive split {value_type!r}")
    if len(precisions) == 3 and not (0 <= ap_threshold_2 <= ap_threshold_1):
        raise ValueError("need 0 <= ap_threshold_2 <= ap_threshold_1")

    absvals = np.abs(mtx.values.astype(np.float64))
    scale = None
    if equilibrate:
        if largest_row_elems is None or largest_col_elems is None:
            raise ValueError(
                "equilibrated partitioning needs largest_row/col_elems "
                "(from equilibrate_matrix)"
            )
        scale = (
            largest_col_elems[mtx.J].astype(np.float64)
            * largest_row_elems[mtx.I].astype(np.float64)
        )

    keep = np.ones(mtx.nnz, dtype=bool)
    n_dropped = 0
    if dropout:
        if scale is not None:
            keep = absvals >= dropout_threshold / scale
        else:
            keep = absvals >= dropout_threshold
        n_dropped = int((~keep).sum())

    masks = _bucket_masks(absvals, precisions, ap_threshold_1, ap_threshold_2, scale)

    subs: Dict[str, MtxData] = {}
    total = 0
    for prec in precisions:
        m = masks[prec] & keep
        total += int(m.sum())
        subs[prec] = MtxData(
            n_rows=mtx.n_rows,
            n_cols=mtx.n_cols,
            nnz=int(m.sum()),
            is_sorted=mtx.is_sorted,
            is_symmetric=mtx.is_symmetric,
            I=mtx.I[m],
            J=mtx.J[m],
            values=mtx.values[m].astype(dtype_for(prec)),
        )

    # element-count conservation (reference utilities.hpp:2922-2926)
    if total + n_dropped != mtx.nnz:
        raise AssertionError(
            f"partition_precisions lost elements: {mtx.nnz - total - n_dropped}"
        )
    return subs, n_dropped
