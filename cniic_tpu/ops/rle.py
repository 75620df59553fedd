"""Run-length encoding primitives.

Exact RLE is fully associative and vectorizes as a boundary/segment pass
(reference iterates a stateful scan, hilbertc.rs:115-196 — same records come
out of the closed form here, including the 255-cap splitting where a run of
length L becomes ceil(L/255) records of 255,...,remainder).

The approximate (running-average) variant is a non-associative recurrence
and lives in the native engine (native.approx_rle_encode), with a
lane-parallel Pallas formulation planned for batched encode.
"""

from __future__ import annotations

import numpy as np

from . import histogram

RUN_CAP = 255  # RepCount::MAX (hilbertc.rs:127-143)


def runs_to_records(starts: np.ndarray, n: int, scan: np.ndarray):
    """Closed-form 255-cap splitting: run-start indices -> RLE records.
    A run of length L becomes ceil(L/255) records of 255,...,remainder
    (hilbertc.rs:127-143)."""
    lens = np.diff(np.append(starts, n))
    reps = -(-lens // RUN_CAP)  # records per run
    total = int(reps.sum())
    counts = np.full(total, RUN_CAP, dtype=np.uint8)
    ends = np.cumsum(reps) - 1  # index of each run's last record
    counts[ends] = (lens - (reps - 1) * RUN_CAP).astype(np.uint8)
    colors = np.repeat(scan[starts], reps, axis=0)
    return counts, colors


def rle_exact(scan: np.ndarray):
    """(N, 3) uint8 -> (counts uint8[R], colors uint8[R, 3])."""
    n = scan.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros((0, 3), np.uint8)
    keys = histogram.pack_colors(scan)
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(keys[1:], keys[:-1], out=change[1:])
    return runs_to_records(np.flatnonzero(change), n, scan)


def rle_expand(counts: np.ndarray, colors: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rle_exact` (and of the approximate encoder)."""
    return np.repeat(colors, counts.astype(np.int64), axis=0)
