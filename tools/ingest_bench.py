"""Host-ingest benchmark: FASTA parse+encode and stream-pack rates.

The GPU kernel consumes database residues far faster than a naive host
loop can produce them, so single-shot (cold database) search latency is
set by this path, not the device. This tool measures the three stages the
pipeline pays before the first dispatch, on a synthetic database whose
record-length distribution mimics a protein DB:

  parse   — FASTA -> encoded flat buffer (native/fastio.cc fastio_parse)
  pack    — flat buffer -> the CUDA kernel's warp groups
            (swa_cuda.pack_groups, which calls fastio_pack per group)
  ingest  — harmonic combination (one pass of each, as a cold search pays)

Counterpart in the reference: the seq_file read + per-record encode loop
at src/alignment_cmdline.c:335-457, which is interleaved with kernel calls
and single-threaded byte-at-a-time.

Runs entirely on the host (no device needed). Prints one JSON line per
metric, best-of-N wall timing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from seqalign.utils import native_io  # noqa: E402
from seqalign.ops.swa_cuda import pack_groups  # noqa: E402

AAS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)


def synth_db(path: str, n_records: int, seed: int = 0, wrap: int = 0) -> int:
    """Writes a synthetic protein FASTA; returns total residues."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(4.8, 0.5, n_records).astype(int), 20, 2000)
    with open(path, "wb") as f:
        for i, length in enumerate(lens):
            s = AAS[rng.integers(0, 20, length)].tobytes()
            f.write(b">r%d\n" % i)
            if wrap:
                for j in range(0, len(s), wrap):
                    f.write(s[j : j + wrap])
                    f.write(b"\n")
            else:
                f.write(s)
                f.write(b"\n")
    return int(lens.sum())


def best_of(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", help="existing FASTA/FASTQ to measure (else synthetic)")
    ap.add_argument("--records", type=int, default=200_000)
    ap.add_argument("--wrap", type=int, default=0, help="wrap FASTA at N cols")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    tmp = None
    path = args.db
    if path is None:
        tmp = tempfile.NamedTemporaryFile(suffix=".fa", delete=False)
        tmp.close()
        path = tmp.name
        synth_db(path, args.records, wrap=args.wrap)

    try:
        db = native_io.parse_file(path)
        total = int(db.lengths.sum())
        meta = {
            "db": os.path.basename(path),
            "records": db.n,
            "residues": total,
            "native": native_io.available(),
        }

        t_parse = best_of(lambda: native_io.parse_file(path), args.reps)
        order = np.argsort(-db.lengths, kind="stable")
        t_pack = best_of(
            lambda: pack_groups(db, order),
            args.reps,
        )
        t_ingest = t_parse + t_pack

        # cache — warm-start path: load the .sqc sidecar instead of
        # parsing (mmap header+offsets+names; residue pages fault in
        # lazily, here forced resident by a full checksum touch so the
        # number is an honest full-read rate, not a lazy-load trick).
        cache_path = path + ".benchsqc"
        native_io.save_cache(db, cache_path, src_path=path)

        def load_all():
            d = native_io.load_cache(cache_path, src_path=path)
            assert d is not None
            int(np.asarray(d.seq, dtype=np.int8).sum(dtype=np.int64))

        t_cache = best_of(load_all, args.reps)
        os.unlink(cache_path)

        for name, t in (
            ("parse", t_parse), ("pack", t_pack), ("ingest", t_ingest),
            ("cache_load", t_cache),
        ):
            print(
                json.dumps(
                    {
                        "metric": f"host_{name}",
                        "value": round(total / t / 1e6, 1),
                        "unit": "Mres/s",
                        "seconds": round(t, 4),
                        **meta,
                    }
                )
            )
    finally:
        if tmp is not None:
            os.unlink(tmp.name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
