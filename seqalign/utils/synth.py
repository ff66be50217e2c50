"""Seeded Swiss-Prot-scale synthetic protein database.

The reference's headline workload (BASELINE.md) is one query against
Swiss-Prot: 565,247 records. The file itself is not shipped, so this draws
a stand-in from a seed: gamma(1.8, 202) lengths clipped to 2..35,000 (mean
about 363, the Swiss-Prot mean) and residues drawn from UniProt's average
amino-acid composition.

A gamma draw of this size tops out near 3,200 residues, while Swiss-Prot's
longest entry, TITIN_MOUSE (A2ASS6), has 35,213 (UniProtKB/Swiss-Prot
release statistics, "longest sequence"). The 1,000 longest draws are
therefore replaced, in place and in the same rank order, by a rank-size
tail: rank r gets 35,213 * r**-a residues, with ``a`` set so rank 1,000
gets 3,000 and the tail joins the gamma body. The tail's shape between
those ends is a model, not a published histogram. About 208 M residues in
all.
"""

from __future__ import annotations

import numpy as np

from ..models.alphabet import encode
from .native_io import EncodedDatabase

SWISSPROT_RECORDS = 565_247
LONGEST = 35_213  # TITIN_MOUSE, Swiss-Prot's longest entry
TAIL_RECORDS, TAIL_FLOOR = 1_000, 3_000

# UniProt/Swiss-Prot average amino-acid composition (%), order
# ACDEFGHIKLMNPQRSTVWY.
AA = "ACDEFGHIKLMNPQRSTVWY"
AA_FREQS = np.array([
    8.25, 1.37, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84, 9.66,
    2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87, 1.08, 2.92,
])
AA_FREQS = AA_FREQS / AA_FREQS.sum()
_AA_IDX = np.array(encode(AA), dtype=np.int8)


def residues(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` encoded residues drawn from the UniProt composition."""
    cdf = np.cumsum(AA_FREQS)
    out = np.empty(n, dtype=np.int8)
    step = 1 << 24
    for s in range(0, n, step):
        u = rng.random(min(step, n - s))
        out[s : s + len(u)] = _AA_IDX[
            np.minimum(np.searchsorted(cdf, u, side="right"), 19)
        ]
    return out


def long_tail(k: int = TAIL_RECORDS) -> np.ndarray:
    """Lengths of the ``k`` longest records, longest first: the rank-size
    law through (1, LONGEST) and (TAIL_RECORDS, TAIL_FLOOR)."""
    a = np.log(LONGEST / TAIL_FLOOR) / np.log(TAIL_RECORDS)
    return np.round(LONGEST * np.arange(1, k + 1) ** -a).astype(np.int64)


def swissprot_like(n: int = SWISSPROT_RECORDS, seed: int = 42) -> EncodedDatabase:
    """An unsorted database of ``n`` records, names ``r0``, ``r1``, ..."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.gamma(shape=1.8, scale=202.0, size=n).astype(np.int64), 2, 35_000
    )
    k = min(TAIL_RECORDS, n)
    top = np.argsort(-lengths, kind="stable")[:k]
    lengths[top] = long_tail(k)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return EncodedDatabase(
        seq=residues(rng, int(offsets[-1])),
        offsets=offsets,
        names="".join(f"r{i}\n" for i in range(n)),
    )


def query(lq: int, seed: int) -> str:
    """A query of ``lq`` residues drawn from the same composition."""
    idx = residues(np.random.default_rng(seed), lq)
    return "".join(chr(64 + int(c)) for c in idx)


def write_fasta(db: EncodedDatabase, path: str) -> None:
    """Write ``db`` as FASTA, one line per sequence."""
    text = (db.seq.astype(np.uint8) + 64).tobytes()  # index k -> chr(64 + k)
    off = db.offsets
    with open(path, "wb", buffering=1 << 22) as f:
        for i, name in enumerate(db.names):
            f.write(b">%s\n%s\n" % (name.encode(), text[off[i] : off[i + 1]]))
