"""Worker process for the 2-process multihost_search test.

Launched by tests/test_multihost.py as a real OS process; each worker joins
the jax.distributed coordinator, searches its database stripe, and writes
the merged result to --out. Run only via the test.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--db", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--topk", type=int, default=0)
    p.add_argument("--db-cache", default=None)
    args = p.parse_args()

    from seqalign.models import ScoringModel, load_builtin
    from seqalign.parallel.multihost import multihost_search
    from seqalign.utils.fasta import read_first

    sc = load_builtin(
        "BLOSUM62",
        ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
    )
    q = sc.query_indices(read_first(args.query).seq)
    if args.topk:
        vals, ids, _ = multihost_search(
            q, args.db, sc,
            coordinator_address=args.coordinator,
            num_processes=args.nproc, process_id=args.pid,
            k=args.topk, db_cache=args.db_cache,
        )
        np.savez(args.out, vals=vals, ids=ids)
    else:
        scores, _ = multihost_search(
            q, args.db, sc,
            coordinator_address=args.coordinator,
            num_processes=args.nproc, process_id=args.pid,
            db_cache=args.db_cache,
        )
        np.save(args.out, scores)


if __name__ == "__main__":
    main()
