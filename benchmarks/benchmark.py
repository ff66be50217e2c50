"""Out-of-process benchmark harness, mirroring the reference's
``benchmarks/benchmark.py`` (sweep configurations, repeat, parse the CLI's
``Total Time:`` line, report mean +- std).

The reference sweeps ``OMP_NUM_THREADS`` over its executables
(``benchmarks/benchmark.py:15-62``); this sweeps engines
(cuda / wavefront / scan) over this package's CLI. Usage:

    python benchmarks/benchmark.py QUERY.fasta DB.fasta \
        [--matrix PAM250] [--engines cuda wavefront] [--repeats 6]

Kernel-region seconds come from the CLI's ``Total Time`` line, which (like
the reference's) excludes parsing and packing.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
from pathlib import Path

TIME_RE = re.compile(r"^Total Time: ([0-9.]+)", re.M)
ENTRIES_RE = re.compile(r"^Total Entries: (\d+)", re.M)


def run_once(query: str, db: str, matrix: str, engine: str) -> tuple[float, int]:
    out = subprocess.run(
        [
            sys.executable, "-m", "seqalign.cli",
            "--substitution_matrix", matrix,
            "--engine", engine,
            "--files", query, db,
        ],
        capture_output=True,
        text=True,
        cwd=Path(__file__).resolve().parents[1],
        check=True,
    ).stdout
    t = TIME_RE.search(out)
    n = ENTRIES_RE.search(out)
    if not t or not n:
        raise RuntimeError(f"could not parse CLI output:\n{out[-500:]}")
    return float(t.group(1)), int(n.group(1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("query")
    ap.add_argument("db")
    ap.add_argument("--matrix", default="PAM250")
    ap.add_argument("--engines", nargs="+", default=["cuda", "wavefront"])
    ap.add_argument("--repeats", type=int, default=6)
    args = ap.parse_args()

    for engine in args.engines:
        times = []
        entries = 0
        for _ in range(args.repeats):
            t, entries = run_once(args.query, args.db, args.matrix, engine)
            times.append(t)
        mean = statistics.mean(times)
        std = statistics.stdev(times) if len(times) > 1 else 0.0
        eps = entries / mean if mean else float("inf")
        print(
            f"{engine:10s}: {mean*1e3:10.1f} ms +- {std*1e3:6.1f} "
            f"({entries} entries, {eps:,.0f} entries/s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
