"""Database batch packing: length sort, lane batching, bucketed padding.

The reference packs 16 database sequences per AVX2 vector in lane-major
layout and *assumes* the database is pre-sorted by descending length
(``src/alignment_cmdline.c:429-450``, SURVEY.md §7.3). The XLA engines take
batches of hundreds of lanes per vector step, so padding waste management
matters far more. This module therefore:

- actually sorts (stable, descending length) instead of assuming sorted input
  — score-identical because '*'-padding never changes a score (asserted via
  ``ScoringModel.pad_column_is_nonpositive``);
- packs lane-batches position-major (``db[pos, lane]``), padded with '*';
- rounds every padded length up to a geometric lattice so the number of
  distinct compiled kernel shapes stays O(log max_len) for the whole run.

Short sequences are grouped together by the sort, so per-batch padding is
bounded by the lattice ratio (25%) instead of the longest database sequence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ..models.alphabet import PAD_INDEX

# Geometric length lattice: multiples of 8 up to 64, then ~1.25x steps.
_LATTICE: list[int] = [8, 16, 24, 32, 40, 48, 56, 64]
_v = 64
while _v < 1 << 26:
    _v = int(np.ceil(_v * 1.25 / 8) * 8)
    _LATTICE.append(_v)


def lattice_round_up(n: int) -> int:
    """Round a length up to the compile-shape lattice (multiple of 8)."""
    if n <= 0:
        return _LATTICE[0]
    for v in _LATTICE:
        if v >= n:
            return v
    raise ValueError(f"sequence length {n} exceeds lattice maximum")


@dataclass
class PackedBatch:
    """One lane-batch of encoded database sequences, ready for an engine."""

    db: np.ndarray  # (Lb_pad, lanes) int8, '*'-padded
    n_valid: int  # lanes actually holding real sequences
    record_ids: np.ndarray  # (n_valid,) original stream positions


def pack_encoded(
    encoded: Sequence[np.ndarray],
    lanes: int,
    sort: bool = True,
) -> Iterator[PackedBatch]:
    """Pack encoded sequences into '*'-padded lane-batches.

    Args:
      encoded: per-record int index arrays (any int dtype, values 0..31).
      lanes: lane-batch width (the reference uses 16).
      sort: length-sort (descending, stable) before batching. Disable only
        for inputs already sorted (reference-compatible mode).
    """
    n = len(encoded)
    if n == 0:
        return
    order = np.arange(n)
    if sort:
        lengths = np.fromiter((len(e) for e in encoded), dtype=np.int64, count=n)
        order = np.argsort(-lengths, kind="stable")
    for start in range(0, n, lanes):
        ids = order[start : start + lanes]
        group = [encoded[i] for i in ids]
        max_len = max((len(g) for g in group), default=1)
        lb_pad = lattice_round_up(max(max_len, 1))
        db = np.full((lb_pad, lanes), PAD_INDEX, dtype=np.int8)
        for lane, g in enumerate(group):
            db[: len(g), lane] = g
        yield PackedBatch(db=db, n_valid=len(group), record_ids=ids)
