"""Multi-host driver tests: real 2-process runs over jax.distributed.

The reference's only coarse parallelism is an OpenMP loop
(``src/alignment_cmdline.c:504-507``); `multihost_search` is its pod-scale
replacement. These tests launch two actual OS processes on the CPU backend
(one coordinator + one worker), stripe a FASTA database between them, and
assert the merged result equals the single-process search bit-for-bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from conftest import random_protein

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_fixtures(rng, tmp_path, n_records=600):
    qp = tmp_path / "q.fa"
    dp = tmp_path / "db.fa"
    qp.write_text(f">q\n{random_protein(rng, 11)}\n")
    with open(dp, "w") as f:
        for i in range(n_records):
            f.write(f">r{i}\n{random_protein(rng, int(rng.integers(1, 30)))}\n")
    return str(qp), str(dp)


def _run_workers(tmp_path, qp, dp, nproc=2, topk=0, db_cache=None):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = []
    outs = []
    for pid in range(nproc):
        ext = "npz" if topk else "npy"
        out = str(tmp_path / f"scores_{pid}.{ext}")
        outs.append(out)
        cmd = [
            sys.executable, str(WORKER),
            "--coordinator", coord, "--nproc", str(nproc),
            "--pid", str(pid), "--query", qp, "--db", dp, "--out", out,
        ]
        if topk:
            cmd += ["--topk", str(topk)]
        if db_cache:
            cmd += ["--db-cache", db_cache]
        procs.append(
            subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
        )
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    return outs


@pytest.mark.slow
class TestMultihost:
    def test_two_process_full_scores(self, rng, blosum62, tmp_path):
        qp, dp = _write_fixtures(rng, tmp_path)
        outs = _run_workers(tmp_path, qp, dp, nproc=2)
        from seqalign.pipeline import search_files

        want = search_files(qp, dp, blosum62, engine="wavefront").scores
        for out in outs:  # every host holds the identical global vector
            got = np.load(out)
            np.testing.assert_array_equal(got, want)

    def test_two_process_topk(self, rng, blosum62, tmp_path):
        qp, dp = _write_fixtures(rng, tmp_path, n_records=400)
        k = 7
        outs = _run_workers(tmp_path, qp, dp, nproc=2, topk=k)
        from seqalign.pipeline import search_files

        want = search_files(qp, dp, blosum62, engine="wavefront").scores
        best = np.sort(want)[::-1][:k]
        for out in outs:
            z = np.load(out)
            vals, ids = z["vals"], z["ids"]
            np.testing.assert_array_equal(np.sort(vals)[::-1], best)
            # Reported ids really score what they claim.
            np.testing.assert_array_equal(want[ids], vals)

    def test_cli_two_hosts(self, rng, blosum62, tmp_path):
        """The --hosts CLI flag: two real worker processes, host 0 prints
        the merged result identical to a single-process run."""
        qp, dp = _write_fixtures(rng, tmp_path, n_records=300)
        port = _free_port()
        coord = f"127.0.0.1:{port}"
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        procs = [
            subprocess.Popen(
                [
                    sys.executable, "-m", "seqalign.cli",
                    "--substitution_matrix", "BLOSUM62",
                    "--hosts", "2", "--host-id", str(pid),
                    "--coordinator", coord,
                    "--files", qp, dp,
                ],
                env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
            for pid in range(2)
        ]
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            assert p.returncode == 0, f"CLI host failed:\n{err[-3000:]}"
            outs.append(out)
        from seqalign.pipeline import search_files

        want = search_files(qp, dp, blosum62, engine="wavefront").scores
        got = [
            int(l.split()[-1])
            for l in outs[0].splitlines()
            if l.startswith("score:")
        ]
        assert got == [int(s) for s in want]
        assert "score:" not in outs[1]  # only host 0 prints

    def test_two_process_shared_sqc_cache(self, rng, blosum62, tmp_path):
        """Both workers stripe the SAME mmapped .sqc sidecar (zero-copy
        record views, multihost.py) and the merged result equals the
        single-process search — including cache-only (FASTA deleted), so
        neither worker can be silently re-parsing the FASTA."""
        from seqalign.pipeline import search_files
        from seqalign.utils.native_io import parse_file_cached

        qp, dp = _write_fixtures(rng, tmp_path, n_records=500)
        want = search_files(qp, dp, blosum62, engine="wavefront").scores
        cp = str(tmp_path / "db.sqc")
        parse_file_cached(dp, cp)  # build the sidecar once, up front
        os.remove(dp)  # workers must be served by the cache alone
        outs = _run_workers(tmp_path, qp, dp, nproc=2, db_cache=cp)
        for out in outs:
            np.testing.assert_array_equal(np.load(out), want)

    def test_single_process_path(self, rng, blosum62, tmp_path):
        """nproc=1 short-circuits the collective but uses the same driver."""
        from seqalign.parallel.multihost import multihost_search
        from seqalign.pipeline import search_files
        from seqalign.utils.fasta import read_first

        qp, dp = _write_fixtures(rng, tmp_path, n_records=200)
        q = blosum62.query_indices(read_first(qp).seq)
        got, _ = multihost_search(q, dp, blosum62)
        want = search_files(qp, dp, blosum62, engine="wavefront").scores
        np.testing.assert_array_equal(got, want)

    def test_single_process_db_cache(self, rng, blosum62, tmp_path):
        """db_cache stripe (mmapped .sqc views) scores identically to the
        FASTA-reader stripe."""
        import os

        from seqalign.parallel.multihost import multihost_search
        from seqalign.utils.fasta import read_first

        qp, dp = _write_fixtures(rng, tmp_path, n_records=150)
        q = blosum62.query_indices(read_first(qp).seq)
        plain, _ = multihost_search(q, dp, blosum62)
        cp = str(tmp_path / "db.sqc")
        cached, _ = multihost_search(
            q, dp, blosum62, db_cache=cp
        )
        assert os.path.exists(cp)
        np.testing.assert_array_equal(cached, plain)
        # warm: served from the cache alone
        os.remove(dp)
        warm, _ = multihost_search(
            q, dp, blosum62, db_cache=cp
        )
        np.testing.assert_array_equal(warm, plain)
