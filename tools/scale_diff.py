"""At-scale differential: the CUDA engine vs the reference's own kernel.

Scores an N-record synthetic Swiss-Prot-like workload (tools/refbench/
gen_workload.py) twice — once with the reference's AVX2 kernel compiled
from its unmodified sources (src/alignment.c via tools/refbench/driver.c)
and once with this package's CUDA engine on the GPU, through
``pipeline.search_database`` — and diffs every score bit-for-bit.

This is the scale extension of tests/test_reference_binary.py (64-record
bit-exact differential): same ground truth, 48,000 records by default.
Long queries run in strips like any other (no query-length cap).

Usage (GPU host with the reference sources at ``REF`` below; builds the
reference binary under build/ if missing):
  python tools/scale_diff.py [n_records] [--matrix PAM250] [--go -2 --ge -1]
  python tools/scale_diff.py 256 --qlen 35000
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

REPO = Path(__file__).resolve().parents[1]
REF = Path("/root/reference")


def build_refbench(binary: Path) -> None:
    subprocess.run(
        [
            "gcc", "-O3", "-march=native", "-mavx2", "-fopenmp",
            f"-I{REF}/src", "-o", str(binary),
            str(REPO / "tools/refbench/driver.c"),
            str(REF / "src/alignment.c"),
            str(REF / "src/alignment_scoring.c"),
        ],
        check=True,
    )


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=48_000)
    p.add_argument("--matrix", default="PAM250")
    p.add_argument("--go", type=int, default=-2,
                   help="gap open, excluding the first extend (reference "
                   "convention)")
    p.add_argument("--ge", type=int, default=-1)
    p.add_argument("--qlen", type=int, default=144)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--random-matrix", type=int, default=None,
                   metavar="SEED",
                   help="use a random asymmetric substitution table "
                   "(gen_workload.write_random_matrix) instead of a "
                   "builtin — the at-scale extension of the randomized "
                   "differential in tests/test_reference_binary.py")
    args = p.parse_args()

    sys.path.insert(0, str(REPO / "tools/refbench"))
    import gen_workload

    work = REPO / "build" / "scale_diff"
    work.mkdir(parents=True, exist_ok=True)
    binary = work / "refbench"
    if not binary.exists():
        build_refbench(binary)
    db_bin, mat = str(work / "db.bin"), str(work / "matrix.txt")
    gen_workload.write_workload(db_bin, n=args.n, query_len=args.qlen,
                                seed=args.seed)
    if args.random_matrix is not None:
        rnd_table = gen_workload.write_random_matrix(
            mat, seed=args.random_matrix)
    else:
        rnd_table = None
        gen_workload.write_matrix(mat, name=args.matrix)

    out = subprocess.run(
        [str(binary), db_bin, mat, "1", str(args.go), str(args.ge)],
        check=True, capture_output=True, text=True,
        env={**os.environ, "OMP_NUM_THREADS": str(os.cpu_count() or 1)},
    ).stdout
    ref = np.array(
        [int(x.split("=")[1]) for x in out.splitlines()
         if x.startswith("score[")], np.int32)
    assert len(ref) == args.n, (len(ref), args.n)
    print(out.splitlines()[0])

    from seqalign.models import ScoringModel, load_builtin
    from seqalign.pipeline import _db_from_encoded, search_database

    if rnd_table is not None:
        sc = ScoringModel(gap_open=args.go, gap_extend=args.ge,
                          use_match_mismatch=False)
        sc.table[...] = rnd_table
    else:
        sc = load_builtin(
            args.matrix,
            ScoringModel(gap_open=args.go, gap_extend=args.ge,
                         use_match_mismatch=False),
        )
    with open(db_bin, "rb") as f:
        n = int(np.frombuffer(f.read(8), np.int64)[0])
        qlen = int(np.frombuffer(f.read(8), np.int64)[0])
        q = np.frombuffer(f.read(qlen), np.int8).astype(np.int32)
        lens = np.frombuffer(f.read(8 * n), np.int64)
        seqs = [np.frombuffer(f.read(int(L)), np.int8) for L in lens]

    scores, _ = search_database(q, _db_from_encoded(seqs), sc, engine="cuda")

    bad = np.flatnonzero(scores != ref)
    print(f"checksum ours={int(scores.sum())} ref={int(ref.sum())}")
    mname = (f"random-matrix seed={args.random_matrix}"
             if rnd_table is not None else args.matrix)
    print(f"AT-SCALE DIFFERENTIAL ({n} records, {mname}, "
          f"qlen={qlen}): mismatches={len(bad)}")
    if len(bad):
        for i in bad[:10]:
            print(f"  idx={i} len={int(lens[i])} ours={int(scores[i])} "
                  f"ref={int(ref[i])}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
