"""Differential test against the ACTUAL reference implementation.

Builds the reference's AVX2 kernel (read-only sources at /root/reference)
with our standalone driver and checks its scores equal our engines' on a
shared workload — the strongest parity evidence available (the reference
repo's own oracle binary fixture is x86-prebuilt and its FASTA submodules
are absent; SURVEY.md §4). Skipped when the reference snapshot or a C
toolchain is unavailable.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REF = Path("/root/reference/src")
REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    not (REF / "alignment.c").exists() or shutil.which("gcc") is None,
    reason="reference sources or gcc unavailable",
)


@pytest.fixture(scope="module")
def ref_binary(tmp_path_factory):
    d = tmp_path_factory.mktemp("refbench")
    exe = d / "refbench"
    subprocess.run(
        [
            "gcc", "-O3", "-march=native", "-mavx2", "-fopenmp",
            f"-I{REF}",
            "-o", str(exe),
            str(REPO / "tools/refbench/driver.c"),
            str(REF / "alignment.c"),
            str(REF / "alignment_scoring.c"),
        ],
        check=True,
        capture_output=True,
    )
    return exe


# (matrix, gap_open, gap_extend, query_len, seed): the sweep covers every
# builtin matrix, several gap regimes (incl. gap_open == gap_extend and a
# deep-open config), and short/medium/long queries; every run compares ALL
# 64 records bit-for-bit (VERDICT round-1 item #8).
CONFIGS = [
    ("PAM250", -2, -1, 37, 7),
    ("BLOSUM62", -2, -1, 144, 11),
    ("BLOSUM45", -5, -2, 17, 13),
    ("BLOSUM62", -10, -1, 64, 17),
    ("PAM250", -1, -1, 7, 19),
    ("BLOSUM45", -3, -3, 96, 23),
]


@pytest.mark.parametrize("matrix,go,ge,qlen,seed", CONFIGS)
def test_scores_match_reference_binary(
    ref_binary, tmp_path, matrix, go, ge, qlen, seed
):
    sys.path.insert(0, str(REPO / "tools/refbench"))
    import gen_workload

    db_bin = tmp_path / "db.bin"
    mat = tmp_path / "matrix.txt"
    n = 64  # 4 full 16-lane batches; the driver prints every record's score
    gen_workload.write_workload(str(db_bin), n=n, query_len=qlen, seed=seed)
    gen_workload.write_matrix(str(mat), name=matrix)

    out = subprocess.run(
        [str(ref_binary), str(db_bin), str(mat), "1", str(go), str(ge)],
        check=True,
        capture_output=True,
        text=True,
        env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"},
    ).stdout
    ref_scores = [
        int(line.split("=")[1])
        for line in out.splitlines()
        if line.startswith("score[")
    ]
    assert len(ref_scores) == n

    # Recompute with our oracle on the identical binary workload.
    from seqalign.models import ScoringModel, load_builtin
    from seqalign.ops.oracle import sw_score_single

    sc = load_builtin(
        matrix,
        ScoringModel(gap_open=go, gap_extend=ge, use_match_mismatch=False),
    )
    with open(db_bin, "rb") as f:
        nn = int(np.frombuffer(f.read(8), np.int64)[0])
        qlen_r = int(np.frombuffer(f.read(8), np.int64)[0])
        q = np.frombuffer(f.read(qlen_r), np.int8).astype(np.int32)
        lens = np.frombuffer(f.read(8 * nn), np.int64)
        seqs = [
            np.frombuffer(f.read(int(L)), np.int8).astype(np.int32)
            for L in lens
        ]
    ours = [
        sw_score_single(q, seqs[k], sc.table, sc.gap_open, sc.gap_extend)
        for k in range(n)
    ]
    assert ours == ref_scores


# ---------------------------------------------------------------------------
# Differential against the reference repo's SHIPPED oracle binary.
#
# The reference's entire test strategy is diffing its batched tool against
# the prebuilt upstream one-vs-one `test/smith_waterman`
# (/root/reference/test/tests.py:63-73, run_tests.sh:1). The source-compiled
# differential above shares sources with the batched tool; this closes the
# remaining loop against the reference's actual ground-truth artifact.
# ---------------------------------------------------------------------------

SHIPPED = Path("/root/reference/test/smith_waterman")


def _shipped_runs() -> bool:
    if not SHIPPED.exists():
        return False
    try:
        p = subprocess.run(
            [str(SHIPPED), "AC", "AC"], capture_output=True, text=True,
            timeout=30,
        )
        return p.returncode == 0 and "score:" in p.stdout
    except OSError:
        return False


@pytest.mark.skipif(
    not _shipped_runs(), reason="shipped oracle binary can't execute here"
)
@pytest.mark.parametrize(
    "matrix,qlen,seed",
    [("PAM250", 37, 101), ("BLOSUM62", 144, 103), (None, 17, 107)],
)
def test_scores_match_shipped_oracle_binary(matrix, qlen, seed):
    """One-vs-one scores equal the upstream prebuilt binary's, exactly the
    way the reference's own harness consumes it (tests.py:63-73: raw seqs on
    argv, first 'score:' parsed; default gaps open=-2/extend=-1). matrix=None
    exercises the binary's default match/mismatch (+2/-2) scoring.

    `--minscore 1` because the upstream tool's default threshold
    (match * MAX(0.2 * length, 2)) suppresses weak hits entirely — a pair
    whose best local score falls below it prints no 'score:' line, which we
    verify equals our score being < the threshold the binary applied."""
    import re

    from seqalign.models import ScoringModel, load_builtin
    from seqalign.models.alphabet import encode
    from seqalign.models.scoring import sw_default_scoring
    from seqalign.ops.oracle import sw_score_single

    rng = np.random.default_rng(seed)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    rand = lambda L: "".join(aas[i] for i in rng.integers(0, 20, size=L))

    if matrix is None:
        dsc = sw_default_scoring()
        table, go, ge = dsc.table, dsc.gap_open, dsc.gap_extend
        mat_args = []
    else:
        sc = load_builtin(
            matrix,
            ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
        )
        table, go, ge = sc.table, sc.gap_open, sc.gap_extend
        mat_args = [
            "--substitution_matrix", f"/root/reference/scoring/{matrix}.txt"
        ]

    query = rand(qlen)
    q_idx = np.asarray(encode(query), dtype=np.int32)
    records = [rand(int(L)) for L in rng.integers(2, 400, size=64)]

    for rec in records:
        out = subprocess.run(
            [str(SHIPPED), "--minscore", "1", "--maxhits", "1",
             *mat_args, query, rec],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout
        ours = sw_score_single(
            q_idx, np.asarray(encode(rec), dtype=np.int32), table, go, ge
        )
        m = re.search(r"score:\s*([+-]?\d+)", out)
        if m is None:
            # No hit printed: the binary found nothing scoring >= 1.
            assert ours == 0, (ours, query, rec)
        else:
            assert ours == int(m.group(1)), (query, rec)


@pytest.mark.slow
@pytest.mark.parametrize("seed", [211, 223, 227, 229])
def test_random_matrix_differential(ref_binary, tmp_path, seed):
    """Randomized differential vs the compiled reference kernel: a random
    asymmetric int8 substitution table and random gap penalties, all 64
    records bit-for-bit. Fixed-matrix sweeps can miss recurrence bugs
    that only random score surfaces excite (e.g. E/F update order,
    src/alignment.c:141-161)."""
    sys.path.insert(0, str(REPO / "tools/refbench"))
    import gen_workload

    rng = np.random.default_rng(seed)
    go = -int(rng.integers(1, 13))
    ge = -int(rng.integers(1, 7))
    qlen = int(rng.integers(1, 201))

    db_bin = tmp_path / "db.bin"
    mat = tmp_path / "matrix.txt"
    n = 64
    gen_workload.write_workload(str(db_bin), n=n, query_len=qlen, seed=seed)
    table = gen_workload.write_random_matrix(str(mat), seed=seed)

    out = subprocess.run(
        [str(ref_binary), str(db_bin), str(mat), "1", str(go), str(ge)],
        check=True,
        capture_output=True,
        text=True,
        env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin"},
    ).stdout
    ref_scores = [
        int(line.split("=")[1])
        for line in out.splitlines()
        if line.startswith("score[")
    ]
    assert len(ref_scores) == n

    from seqalign.ops.oracle import sw_score_single

    with open(db_bin, "rb") as f:
        nn = int(np.frombuffer(f.read(8), np.int64)[0])
        qlen_r = int(np.frombuffer(f.read(8), np.int64)[0])
        q = np.frombuffer(f.read(qlen_r), np.int8).astype(np.int32)
        lens = np.frombuffer(f.read(8 * nn), np.int64)
        seqs = [
            np.frombuffer(f.read(int(L)), np.int8).astype(np.int32)
            for L in lens
        ]
    ours = [
        sw_score_single(q, seqs[k], table, go, ge) for k in range(n)
    ]
    assert ours == ref_scores, f"mismatch at go={go} ge={ge} qlen={qlen}"
