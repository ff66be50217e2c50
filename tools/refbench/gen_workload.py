"""Generate the calibration workload for the reference-kernel harness.

Writes (1) a binary workload (query + database as alphabet indices, sorted
descending by length — the reference's precondition, SURVEY.md §7.3) and
(2) the PAM250 matrix as (char, char, score) triples for the driver.

Same distribution as bench.py: gamma lengths calibrated to Swiss-Prot,
20-standard-amino-acid residues, query length 144.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np

from seqalign.models import ScoringModel, load_builtin
from seqalign.models.alphabet import encode

AA20 = np.array(encode("ACDEFGHIKLMNPQRSTVWY"), dtype=np.int8)
PAM_ALPHA = "ARNDCQEGHILKMFPSTWYVBZX*"


def write_matrix(path: str, name: str = "PAM250") -> None:
    sc = load_builtin(
        name, ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False)
    )
    with open(path, "w") as f:
        for a in PAM_ALPHA:
            ia = encode(a)[0]
            for b in PAM_ALPHA:
                ib = encode(b)[0]
                f.write(f"{a} {b} {sc.table[ia, ib]}\n")


def write_random_matrix(
    path: str, seed: int, max_abs: int = 60
) -> np.ndarray:
    """A random (asymmetric) substitution table over the PAM alphabet.

    Returns the 32x32 int32 table for recomputation on our side. Scores
    stay within ±max_abs (the reference asserts int8 range,
    src/alignment_scoring.c:62; a modest bound also keeps worst-case
    alignment scores far from the reference's unguarded int16 wrap,
    SURVEY.md §7.4).
    """
    rng = np.random.default_rng(seed)
    table = np.zeros((32, 32), dtype=np.int32)
    with open(path, "w") as f:
        for a in PAM_ALPHA:
            ia = encode(a)[0]
            for b in PAM_ALPHA:
                ib = encode(b)[0]
                if a == "*" or b == "*":
                    # '*' is the reference's lane-padding character; its
                    # scores must stay negative (true of every real
                    # matrix) or padded lanes could extend alignments
                    # into the padding and diverge from the true-length
                    # score — outside the behavioral envelope
                    # (SURVEY.md §7).
                    s = int(rng.integers(-max_abs, 0))
                else:
                    s = int(rng.integers(-max_abs, max_abs + 1))
                table[ia, ib] = s
                f.write(f"{a} {b} {s}\n")
    return table


def write_workload(
    path: str, n: int = 48_000, query_len: int = 144, seed: int = 42
) -> None:
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.gamma(1.8, 202.0, n).astype(np.int64), 2, 35_000)
    lengths = np.sort(lengths)[::-1].copy()
    q = AA20[rng.integers(0, 20, query_len)]
    with open(path, "wb") as f:
        f.write(np.int64(n).tobytes())
        f.write(np.int64(query_len).tobytes())
        f.write(q.tobytes())
        f.write(lengths.tobytes())
        for L in lengths:
            f.write(AA20[rng.integers(0, 20, int(L))].tobytes())


if __name__ == "__main__":
    db = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbench_db.bin"
    mat = sys.argv[2] if len(sys.argv) > 2 else "/tmp/refbench_pam250.txt"
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 48_000
    write_workload(db, n=n)
    write_matrix(mat)
    print(f"wrote {db} ({n} records) and {mat}")
