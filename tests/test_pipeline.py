"""Tests for FASTA IO, packing, pipeline search, and the CLI."""

import gzip
import io
import json
import subprocess
import sys

import numpy as np
import pytest

from seqalign.models import (
    PAD_INDEX,
    ScoringModel,
    encode,
    load_builtin,
    sw_default_scoring,
    write_matrix_file,
)
from seqalign.ops.oracle import sw_score_batch
from seqalign.pipeline import search, search_encoded
from seqalign.utils.fasta import SeqRecord, read_fasta, read_first
from seqalign.utils.packing import lattice_round_up, pack_encoded

from conftest import random_protein


class TestFasta:
    def test_basic_fasta(self, tmp_path):
        p = tmp_path / "a.fa"
        p.write_text(">seq1 desc\nACDEF\nGHIKL\n>seq2\nMNPQR\n")
        recs = list(read_fasta(str(p)))
        assert [r.name for r in recs] == ["seq1 desc", "seq2"]
        assert [r.seq for r in recs] == ["ACDEFGHIKL", "MNPQR"]

    def test_gzip_fasta(self, tmp_path):
        p = tmp_path / "a.fa.gz"
        p.write_bytes(gzip.compress(b">s1\nACDEF\n>s2\nKLM\n"))
        recs = list(read_fasta(str(p)))
        assert [r.seq for r in recs] == ["ACDEF", "KLM"]

    def test_fastq(self, tmp_path):
        p = tmp_path / "a.fq"
        p.write_text("@r1\nACGT\n+\n!!!!\n@r2\nGGCC\n+\n####\n")
        recs = list(read_fasta(str(p)))
        assert [(r.name, r.seq) for r in recs] == [("r1", "ACGT"), ("r2", "GGCC")]

    def test_blank_lines_and_crlf(self, tmp_path):
        p = tmp_path / "a.fa"
        p.write_bytes(b"\n>s1\r\nAC\r\nDE\n\n>s2\nKL\n")
        recs = list(read_fasta(str(p)))
        assert [r.seq for r in recs] == ["ACDE", "KL"]

    def test_read_first_empty(self, tmp_path):
        p = tmp_path / "e.fa"
        p.write_text("")
        with pytest.raises(ValueError):
            read_first(str(p))


class TestPacking:
    def test_lattice_monotone_multiple_of_8(self):
        prev = 0
        for nint in [1, 7, 8, 9, 63, 64, 65, 100, 1000, 35000]:
            v = lattice_round_up(nint)
            assert v >= nint and v % 8 == 0
        vals = [lattice_round_up(nn) for nn in range(1, 5000)]
        assert vals == sorted(vals)

    def test_pack_sorts_and_pads(self, rng):
        encoded = [encode(random_protein(rng, n)) for n in (5, 50, 20, 3)]
        batches = list(pack_encoded(encoded, lanes=2))
        assert len(batches) == 2
        # Descending length: first batch holds the 50 and 20 seqs.
        assert batches[0].record_ids.tolist() == [1, 2]
        assert batches[0].db.shape[0] == lattice_round_up(50)
        assert batches[1].record_ids.tolist() == [0, 3]
        # padding is '*'
        assert (batches[1].db[5:, 0] == PAD_INDEX).all()

    def test_pack_partial_batch(self, rng):
        encoded = [encode(random_protein(rng, 9))] * 3
        (batch,) = pack_encoded(encoded, lanes=8)
        assert batch.n_valid == 3
        assert (batch.db[:, 3:] == PAD_INDEX).all()


class TestSearch:
    def test_search_matches_oracle(self, rng, blosum62):
        sc = blosum62
        q = SeqRecord("q", random_protein(rng, 21))
        recs = [
            SeqRecord(f"s{k}", random_protein(rng, int(rng.integers(3, 60))))
            for k in range(37)
        ]
        res = search(q, recs, sc, engine="wavefront", lanes=16)
        q_idx = sc.query_indices(q.seq)
        want = sw_score_batch(
            q_idx,
            [encode(r.seq) for r in recs],
            sc.table,
            sc.gap_open,
            sc.gap_extend,
        )
        np.testing.assert_array_equal(res.scores, want)
        assert res.total_entries == 37
        assert res.kernel_time > 0

    def test_search_unsorted_equals_sorted(self, rng, pam250):
        q = SeqRecord("q", random_protein(rng, 15))
        recs = [
            SeqRecord(f"s{k}", random_protein(rng, n))
            for k, n in enumerate([40, 40, 40, 40, 12, 12, 12, 12])
        ]
        a = search(q, recs, pam250, engine="wavefront", lanes=4, sort=True)
        b = search(q, recs, pam250, engine="wavefront", lanes=4, sort=False)
        np.testing.assert_array_equal(a.scores, b.scores)

    def test_oracle_engine(self, rng, blosum62):
        q_idx = blosum62.query_indices(random_protein(rng, 9))
        encoded = [encode(random_protein(rng, 12)) for _ in range(5)]
        s1, _ = search_encoded(q_idx, encoded, blosum62, engine="oracle")
        s2, _ = search_encoded(
            q_idx, encoded, blosum62, engine="scan", lanes=8
        )
        np.testing.assert_array_equal(s1, s2)


def run_cli(args, tmp_path):
    """Run the CLI in-process, capturing stdout/stderr."""
    from seqalign import cli

    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        code = cli.main(["smith_waterman"] + args)
    finally:
        sys.stdout, sys.stderr = old
    return code, out.getvalue(), err.getvalue()


@pytest.fixture
def fasta_pair(tmp_path, rng):
    q = tmp_path / "query.fa"
    q.write_text(">query1\nMKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ\n")
    db = tmp_path / "db.fa"
    lines = []
    for k in range(10):
        lines.append(f">entry{k}")
        lines.append(random_protein(rng, int(rng.integers(8, 70))))
    db.write_text("\n".join(lines) + "\n")
    return str(q), str(db)


class TestCli:
    def test_output_format(self, fasta_pair, tmp_path):
        qp, dp = fasta_pair
        code, out, err = run_cli(
            ["--files", qp, dp, "--engine", "wavefront", "--lanes", "8"],
            tmp_path,
        )
        assert code == 0
        assert out.startswith(f"Query File={qp} and Database File={dp}\n")
        # Parse like the reference harnesses do.
        import re

        entries = re.findall(r"Entry #(\d+):\s*\nscore: (-?\d+)", out)
        assert len(entries) == 10
        assert [int(e[0]) for e in entries] == list(range(10))
        assert re.search(r"Total Time: \d+\.\d+\n", out)
        assert re.search(r"Total Entries: 10\n", out)

    def test_scores_match_oracle(self, fasta_pair, tmp_path, blosum62):
        import re

        qp, dp = fasta_pair
        b62 = tmp_path / "b62.txt"
        write_matrix_file(str(b62), "BLOSUM62")
        code, out, _ = run_cli(
            [
                "--files",
                qp,
                dp,
                "--substitution_matrix",
                str(b62),
                "--engine",
                "wavefront",
                "--lanes",
                "8",
            ],
            tmp_path,
        )
        assert code == 0
        got = {
            int(m[0]): int(m[1])
            for m in re.findall(r"Entry #(\d+):\s*\nscore: (-?\d+)", out)
        }
        sc = load_builtin(
            "BLOSUM62",
            ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
        )
        q = read_first(qp)
        q_idx = sc.query_indices(q.seq)
        recs = list(read_fasta(dp))
        want = sw_score_batch(
            q_idx,
            [encode(r.seq) for r in recs],
            sc.table,
            sc.gap_open,
            sc.gap_extend,
        )
        for k in range(len(recs)):
            assert got[k] == want[k], k

    def test_builtin_matrix_name(self, fasta_pair, tmp_path):
        qp, dp = fasta_pair
        code, out, _ = run_cli(
            [
                "--files",
                qp,
                dp,
                "--substitution_matrix",
                "PAM250",
                "--engine",
                "scan",
                "--lanes",
                "8",
            ],
            tmp_path,
        )
        assert code == 0
        assert "score:" in out

    def test_printfasta_printseq(self, fasta_pair, tmp_path):
        qp, dp = fasta_pair
        code, out, _ = run_cli(
            [
                "--files",
                qp,
                dp,
                "--printfasta",
                "--printseq",
                "--engine",
                "wavefront",
                "--lanes",
                "8",
            ],
            tmp_path,
        )
        assert code == 0
        assert "query1" in out
        assert "entry0" in out

    def test_json_and_topk(self, fasta_pair, tmp_path):
        qp, dp = fasta_pair
        code, out, _ = run_cli(
            [
                "--files",
                qp,
                dp,
                "--json",
                "--topk",
                "3",
                "--engine",
                "wavefront",
                "--lanes",
                "8",
            ],
            tmp_path,
        )
        assert code == 0
        payload = json.loads(out.splitlines()[-1])
        assert len(payload["entries"]) == 3
        scores = [e["score"] for e in payload["entries"]]
        assert scores == sorted(scores, reverse=True)

    def test_usage_errors(self, tmp_path):
        code, _, err = run_cli([], tmp_path)
        assert code == 1 and "usage:" in err
        code, _, err = run_cli(["--bogus"], tmp_path)
        assert code == 1 and "Unknown argument" in err
        code, _, err = run_cli(["--match", "x", "--stdin"], tmp_path)
        assert code == 1 and "Invalid --match" in err
        code, _, err = run_cli(["--files", "only-one"], tmp_path)
        assert code == 1
        # match < mismatch in match/mismatch mode
        code, _, err = run_cli(
            ["--match", "-5", "--mismatch", "1", "--stdin"], tmp_path
        )
        assert code == 1 and "Match value" in err

    def test_scoring_flag_vestigial(self, fasta_pair, tmp_path):
        # --scoring <x> is silently swallowed with its argument, like the
        # reference (alignment_cmdline.c:226-228); as the LAST argument it
        # hits "Unknown argument without parameter" instead.
        qp, dp = fasta_pair
        code, out, _ = run_cli(
            ["--scoring", "whatever", "--files", qp, dp,
             "--engine", "wavefront", "--lanes", "8"],
            tmp_path,
        )
        assert code == 0 and "Total Entries: 10" in out
        code, _, err = run_cli(["--stdin", "--scoring"], tmp_path)
        assert code == 1 and "Unknown argument without parameter" in err

    def test_match_ge_mismatch_ok_with_matrix(self, fasta_pair, tmp_path):
        # With a matrix loaded and no --match, the match/mismatch check is
        # bypassed (use_match_mismatch = 0), like the reference.
        qp, dp = fasta_pair
        code, out, _ = run_cli(
            [
                "--files",
                qp,
                dp,
                "--substitution_matrix",
                "BLOSUM62",
                "--engine",
                "wavefront",
                "--lanes",
                "8",
            ],
            tmp_path,
        )
        assert code == 0

    def test_missing_matrix_file(self, tmp_path):
        code, _, err = run_cli(
            ["--substitution_matrix", "/nonexistent/m.txt", "--stdin"],
            tmp_path,
        )
        assert code == 1 and "Couldn't read" in err


class TestStreamSearch:
    """The CUDA engine's Python wrapper (packing, strips, chunking,
    checkpoints, score scatter) on CPU, with the kernel replaced by its
    NumPy model (the ``cuda_standin`` fixture)."""

    def test_matches_wavefront(self, rng, blosum62, cuda_standin):
        from seqalign.ops.swa_xla import make_profile
        from seqalign.pipeline import _cuda_search, _db_from_encoded

        sc = blosum62
        q = sc.query_indices(random_protein(rng, 13))
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 20))))
            for _ in range(2500)
        ]
        db = _db_from_encoded(encoded)
        profile = make_profile(sc.table, q)
        order = np.argsort(-db.lengths, kind="stable")
        got, _ = _cuda_search(
            [profile], db, sc.gap_open_total, sc.gap_extend, order
        )
        want, _ = search_encoded(q, encoded, sc, engine="wavefront")
        np.testing.assert_array_equal(got[0], want)

    @pytest.mark.slow
    def test_multi_query_stream(self, rng, blosum62, cuda_standin):
        from seqalign.ops.swa_xla import make_profile
        from seqalign.pipeline import _cuda_search, _db_from_encoded

        sc = blosum62
        qs = [
            sc.query_indices(random_protein(rng, int(rng.integers(5, 60))))
            for _ in range(3)
        ]
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 18))))
            for _ in range(1500)
        ]
        db = _db_from_encoded(encoded)
        order = np.argsort(-db.lengths, kind="stable")
        got, _ = _cuda_search(
            [make_profile(sc.table, q) for q in qs], db, sc.gap_open_total,
            sc.gap_extend, order,
        )
        assert got.shape == (3, 1500)
        for k, q in enumerate(qs):
            want, _ = search_encoded(q, encoded, sc, engine="wavefront")
            np.testing.assert_array_equal(got[k], want)

    @pytest.mark.parametrize("n_records", [1, 5, 1023, 1025])
    def test_stream_edge_sizes(self, rng, blosum62, cuda_standin, n_records):
        from seqalign.ops.swa_xla import make_profile
        from seqalign.pipeline import _cuda_search, _db_from_encoded

        sc = blosum62
        q = sc.query_indices(random_protein(rng, 7))
        prof = make_profile(sc.table, q)
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 9))))
            for _ in range(n_records)
        ]
        db = _db_from_encoded(encoded)
        order = np.argsort(-db.lengths, kind="stable")
        got, _ = _cuda_search(
            [prof], db, sc.gap_open_total, sc.gap_extend, order
        )
        want, _ = search_encoded(q, encoded, sc, engine="wavefront")
        np.testing.assert_array_equal(got[0], want)

    def test_single_residue_query_and_records(
        self, rng, blosum62, cuda_standin
    ):
        from seqalign.ops.swa_xla import make_profile
        from seqalign.pipeline import _cuda_search, _db_from_encoded

        sc = blosum62
        q = sc.query_indices("W")
        prof = make_profile(sc.table, q)
        encoded = [encode(s) for s in ("W", "A", "WW", "AWA")] * 40
        db = _db_from_encoded(encoded)
        order = np.argsort(-db.lengths, kind="stable")
        got, _ = _cuda_search(
            [prof], db, sc.gap_open_total, sc.gap_extend, order
        )
        want, _ = search_encoded(q, encoded, sc, engine="wavefront")
        np.testing.assert_array_equal(got[0], want)

    def test_long_records_and_checkpoint(
        self, rng, blosum62, cuda_standin, monkeypatch, tmp_path
    ):
        """Records over the long cut take the long kernel; a resumed scan
        restores them to their own places."""
        from seqalign.ops import swa_cuda
        from seqalign.ops.swa_xla import make_profile
        from seqalign.pipeline import _cuda_search, _db_from_encoded

        monkeypatch.setattr(swa_cuda, "LONG_RECORD", 14)
        monkeypatch.setattr(swa_cuda, "CHUNK_RESIDUES", 600)
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 9))
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 20))))
            for _ in range(120)
        ]
        db = _db_from_encoded(encoded)
        order = np.argsort(-db.lengths, kind="stable")
        args = ([make_profile(sc.table, q)], db, sc.gap_open_total,
                sc.gap_extend, order)
        ck = str(tmp_path / "ckpt")
        got, _ = _cuda_search(*args, checkpoint_dir=ck)
        want, _ = search_encoded(q, encoded, sc, engine="wavefront")
        np.testing.assert_array_equal(got[0], want)
        monkeypatch.setattr(swa_cuda, "compile_kernel", None)  # not called
        again, _ = _cuda_search(*args, checkpoint_dir=ck)
        np.testing.assert_array_equal(again[0], want)

    def test_checkpoint_resume(
        self, rng, blosum62, cuda_standin, monkeypatch, tmp_path
    ):
        """Chunk checkpointing: a resumed scan skips completed chunks."""
        from seqalign.ops import swa_cuda
        from seqalign.ops.swa_xla import make_profile
        from seqalign.pipeline import _cuda_search, _db_from_encoded

        monkeypatch.setattr(swa_cuda, "CHUNK_RESIDUES", 4000)  # 2 chunks
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 7))
        prof = make_profile(sc.table, q)
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 9))))
            for _ in range(1500)
        ]
        db = _db_from_encoded(encoded)
        order = np.argsort(-db.lengths, kind="stable")
        ck = str(tmp_path / "ckpt")
        go, ge = sc.gap_open_total, sc.gap_extend
        first, _ = _cuda_search([prof], db, go, ge, order, checkpoint_dir=ck)
        assert len(swa_cuda.chunk_bounds(db.lengths[order], 4000)) == 2

        # A resumed run must not dispatch the engine at all.
        def boom(*a, **k):
            raise AssertionError("engine dispatched on a completed scan")

        monkeypatch.setattr(swa_cuda, "compile_kernel", boom)
        second, _ = _cuda_search([prof], db, go, ge, order, checkpoint_dir=ck)
        np.testing.assert_array_equal(first, second)
        # Different penalties invalidate the manifest (engine needed again).
        with pytest.raises(AssertionError):
            _cuda_search([prof], db, go - 1, ge, order, checkpoint_dir=ck)
        # A different record order (sort=True scan resumed as --no-sort)
        # also invalidates it: chunk files index a permuted record set.
        with pytest.raises(AssertionError):
            _cuda_search(
                [prof], db, go, ge, np.arange(db.n), checkpoint_dir=ck
            )


@pytest.mark.slow
def test_benchmark_harness_smoke(tmp_path):
    """benchmarks/benchmark.py parses the CLI and reports mean+-std."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    q = tmp_path / "q.fa"
    d = tmp_path / "db.fa"
    q.write_text(">q\nACDEFGHIKLMNPQRSTVWY\n")
    d.write_text("".join(f">r{i}\nACDEFGHIK\n" for i in range(20)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [
            sys.executable, str(repo / "benchmarks/benchmark.py"),
            str(q), str(d), "--engines", "wavefront", "--repeats", "2",
        ],
        capture_output=True,
        text=True,
        cwd=repo,
        env=env,
        check=True,
    ).stdout
    assert "wavefront" in out and "entries/s" in out


def test_ingest_bench_smoke():
    """tools/ingest_bench.py emits parseable per-stage JSON rates."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [
            sys.executable, str(repo / "tools/ingest_bench.py"),
            "--records", "2000", "--reps", "1",
        ],
        capture_output=True,
        text=True,
        cwd=repo,
        env=dict(os.environ),
        check=True,
    ).stdout
    lines = [json.loads(ln) for ln in out.splitlines() if ln.strip()]
    metrics = {d["metric"] for d in lines}
    assert {"host_parse", "host_pack", "host_ingest"} <= metrics
    assert all(d["value"] > 0 and d["unit"] == "Mres/s" for d in lines)


def test_streaming_search_matches(tmp_path, rng, blosum62):
    """Chunked streaming search == one-shot search, bounded memory."""
    from seqalign.pipeline import search_files, search_files_streaming
    from conftest import random_protein

    q = tmp_path / "q.fa"
    d = tmp_path / "db.fa"
    q.write_text(">q\n" + random_protein(rng, 25) + "\n")
    d.write_text(
        "".join(
            f">r{i}\n{random_protein(rng, int(rng.integers(1, 40)))}\n"
            for i in range(700)
        )
    )
    full = search_files(str(q), str(d), blosum62, engine="wavefront")
    streamed = search_files_streaming(
        str(q), str(d), blosum62, engine="wavefront", chunk_records=150
    )
    np.testing.assert_array_equal(full.scores, streamed.scores)
    assert full.names == streamed.names


class TestCliExtensions:
    """CLI extension flags end-to-end (wavefront engine, CPU)."""

    @pytest.fixture
    def files(self, tmp_path, rng):
        from conftest import random_protein

        q = tmp_path / "q.fa"
        d = tmp_path / "db.fa"
        q.write_text(
            ">q0\n" + random_protein(rng, 20) + "\n"
            ">q1\n" + random_protein(rng, 15) + "\n"
        )
        d.write_text(
            "".join(
                f">r{i}\n{random_protein(rng, int(rng.integers(3, 30)))}\n"
                for i in range(40)
            )
        )
        return str(q), str(d)

    def test_all_queries(self, files, tmp_path):
        q, d = files
        code, out, _ = run_cli(
            ["--engine", "wavefront", "--all-queries", "--files", q, d],
            tmp_path,
        )
        assert code == 0
        assert out.count("Query #") == 2
        assert out.count("score:") == 80

    def test_multi_record_query_batches_by_default(self, files, tmp_path):
        """A multi-record query file batches automatically — no flag needed
        (the reference reads only the first record; VERDICT round-1 #6)."""
        q, d = files
        code, out, _ = run_cli(
            ["--engine", "wavefront", "--files", q, d], tmp_path
        )
        assert code == 0
        assert out.count("Query #") == 2
        assert out.count("score:") == 80

    def test_single_query_modes_keep_first_record(self, files, tmp_path):
        """Modes with single-query semantics (--stream-chunk etc.) keep the
        reference's first-record behavior."""
        q, d = files
        code, out, _ = run_cli(
            [
                "--engine", "wavefront", "--stream-chunk", "16",
                "--files", q, d,
            ],
            tmp_path,
        )
        assert code == 0
        assert out.count("Query #") == 0
        assert out.count("score:") == 40

    def test_all_queries_json(self, files, tmp_path):
        import json

        q, d = files
        code, out, _ = run_cli(
            [
                "--engine", "wavefront", "--all-queries", "--json",
                "--topk", "3", "--files", q, d,
            ],
            tmp_path,
        )
        assert code == 0
        data = json.loads(out.splitlines()[-1])
        assert len(data["queries"]) == 2
        assert all(len(qq["entries"]) == 3 for qq in data["queries"])

    def test_align_json(self, files, tmp_path):
        import json

        q, d = files
        code, out, _ = run_cli(
            [
                "--engine", "wavefront", "--align", "2", "--json",
                "--files", q, d,
            ],
            tmp_path,
        )
        assert code == 0
        data = json.loads(out.splitlines()[-1])
        assert len(data["alignments"]) == 2
        a = data["alignments"][0]
        assert len(a["query_aligned"]) == len(a["db_aligned"])
        assert a["cigar"]

    def test_minscore_filters(self, files, tmp_path):
        q, d = files
        code, out_all, _ = run_cli(
            ["--engine", "wavefront", "--files", q, d], tmp_path
        )
        scores = [
            int(l.split()[-1]) for l in out_all.splitlines()
            if l.startswith("score:")
        ]
        cut = sorted(scores)[len(scores) // 2]
        code, out, _ = run_cli(
            [
                "--engine", "wavefront", "--minscore", str(cut),
                "--files", q, d,
            ],
            tmp_path,
        )
        kept = [
            int(l.split()[-1]) for l in out.splitlines()
            if l.startswith("score:")
        ]
        assert kept == [s for s in scores if s >= cut]

    def test_stream_chunk_matches(self, files, tmp_path):
        q, d = files
        # Single-record query: --stream-chunk keeps first-record semantics
        # while the default path would batch a multi-record file.
        q1 = tmp_path / "q1.fa"
        q1.write_text("".join(open(q).read().split(">q1")[0]))
        q = str(q1)
        _, a, _ = run_cli(
            ["--engine", "wavefront", "--files", q, d], tmp_path
        )
        _, b, _ = run_cli(
            [
                "--engine", "wavefront", "--stream-chunk", "13",
                "--files", q, d,
            ],
            tmp_path,
        )
        strip = lambda s: [
            l for l in s.splitlines() if not l.startswith("Total Time")
        ]
        assert strip(a) == strip(b)


class TestDbCacheCli:
    def test_db_cache_identical_output(self, fasta_pair, tmp_path):
        """--db-cache: cold run builds the .sqc, warm run serves from it,
        output identical either way (scores, names, entry order)."""
        import os
        import re

        qp, dp = fasta_pair
        base = ["--files", qp, dp, "--engine", "wavefront", "--lanes", "8"]
        _, want, _ = run_cli(base, tmp_path)
        code, cold, _ = run_cli(base + ["--db-cache", "auto"], tmp_path)
        assert code == 0 and os.path.exists(dp + ".sqc")
        code, warm, _ = run_cli(base + ["--db-cache", "auto"], tmp_path)
        assert code == 0
        strip = lambda s: re.sub(r"Total Time:.*", "", s)
        assert strip(cold) == strip(want) == strip(warm)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_bench_harness_smoke(script):
    """The GPU measurement scripts refuse to run on the CPU: non-zero exit
    and no result line."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, str(repo / script)],
        capture_output=True, text=True, cwd=repo, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "gcups" not in out.stdout


def test_align_with_db_cache(tmp_path, rng):
    """--align served from the mmapped cache: traceback reads db.record
    views of the memmap; alignments identical to the direct-parse run."""
    import json

    q = tmp_path / "q.fa"
    q.write_text(">q\nMKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ\n")
    d = tmp_path / "d.fa"
    lines = []
    for k in range(12):
        lines.append(f">e{k}")
        lines.append(random_protein(rng, int(rng.integers(10, 60))))
    d.write_text("\n".join(lines) + "\n")
    base = ["--engine", "wavefront", "--align", "3", "--json",
            "--files", str(q), str(d)]
    code, want, _ = run_cli(base, tmp_path)
    assert code == 0
    cp = str(tmp_path / "d.sqc")
    code, cold, _ = run_cli(base + ["--db-cache", cp], tmp_path)
    assert code == 0
    code, warm, _ = run_cli(base + ["--db-cache", cp], tmp_path)
    assert code == 0
    strip = lambda s: {
        k: v for k, v in json.loads(s.splitlines()[-1]).items()
        if k != "total_time"
    }
    assert strip(cold) == strip(want) == strip(warm)


def test_streaming_over_cache_matches(tmp_path, rng, blosum62):
    """Streaming chunks served as mmap views of the .sqc == FASTA
    streaming == one-shot, including cache-only (FASTA deleted)."""
    import os

    from seqalign.pipeline import search_files, search_files_streaming
    from seqalign.utils.native_io import parse_file_cached

    q = tmp_path / "q.fa"
    q.write_text(">q\n" + random_protein(rng, 21) + "\n")
    d = tmp_path / "d.fa"
    lines = []
    for k in range(300):
        lines.append(f">e{k}")
        lines.append(random_protein(rng, int(rng.integers(4, 50))))
    d.write_text("\n".join(lines) + "\n")
    cp = str(tmp_path / "d.sqc")
    parse_file_cached(str(d), cp)  # build the cache

    want = search_files(str(q), str(d), blosum62, engine="wavefront")
    plain = search_files_streaming(
        str(q), str(d), blosum62, engine="wavefront", chunk_records=64,
    )
    cached = search_files_streaming(
        str(q), str(d), blosum62, engine="wavefront", chunk_records=64,
        db_cache=cp,
    )
    np.testing.assert_array_equal(plain.scores, want.scores)
    np.testing.assert_array_equal(cached.scores, want.scores)
    assert cached.names == want.names
    os.remove(d)  # cache-only deployment streams too
    only = search_files_streaming(
        str(q), str(d), blosum62, engine="wavefront", chunk_records=77,
        db_cache=cp,
    )
    np.testing.assert_array_equal(only.scores, want.scores)


def test_streaming_prefetch_error_propagates(tmp_path, rng, blosum62):
    """A parse error mid-stream (illegal residue in a later chunk) must
    surface on the consumer thread as the usual ValueError, not hang or
    die silently in the prefetch thread."""
    from seqalign.pipeline import search_files_streaming

    q = tmp_path / "q.fa"
    q.write_text(">q\n" + random_protein(rng, 12) + "\n")
    d = tmp_path / "d.fa"
    lines = []
    for k in range(120):
        lines.append(f">e{k}")
        lines.append(random_protein(rng, 20))
    lines += [">bad", "AC1DE"]  # digit: illegal for the matrix alphabet
    d.write_text("\n".join(lines) + "\n")
    with pytest.raises(ValueError):
        search_files_streaming(
            str(q), str(d), blosum62, engine="wavefront", chunk_records=32,
        )


def test_streaming_producer_released_on_consumer_failure(
    tmp_path, rng, blosum62, monkeypatch
):
    """If the consume loop dies mid-iteration (compile error, checkpoint
    IO failure), the ingest producer thread must terminate instead of
    blocking forever on the full prefetch queue (ADVICE round-3: each
    failed streaming search leaked a thread + open stream handle)."""
    import threading
    import time

    import seqalign.pipeline as pl
    from conftest import random_protein

    q = tmp_path / "q.fa"
    d = tmp_path / "db.fa"
    q.write_text(">q\n" + random_protein(rng, 12) + "\n")
    d.write_text(
        "".join(
            f">r{i}\n{random_protein(rng, int(rng.integers(1, 30)))}\n"
            for i in range(400)
        )
    )

    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("simulated compile failure")

    monkeypatch.setattr(pl, "search_database", boom)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="simulated compile failure"):
        pl.search_files_streaming(
            str(q), str(d), blosum62, engine="wavefront", chunk_records=50
        )
    assert calls  # the failure happened mid-iteration, chunks pending
    deadline = time.time() + 10
    while time.time() < deadline:
        leaked = [
            t for t in set(threading.enumerate()) - before if t.is_alive()
        ]
        if not leaked:
            break
        time.sleep(0.1)
    assert not leaked, f"producer thread leaked: {leaked}"


@pytest.mark.slow
def test_stream_search_striped_path(rng, blosum62, cuda_standin, monkeypatch):
    """A query taller than one strip runs in several strips that hand their
    last row over through the boundary array; exact vs the wavefront."""
    from seqalign.ops import swa_cuda
    from seqalign.ops.swa_xla import make_profile
    from seqalign.pipeline import _cuda_search, _db_from_encoded

    monkeypatch.setattr(swa_cuda, "MAX_STRIP", 16)
    monkeypatch.setattr(swa_cuda.strip_profile, "__defaults__", (16,))
    sc = blosum62
    q = sc.query_indices(random_protein(rng, 40))  # 3 strips
    encoded = [
        encode(random_protein(rng, int(rng.integers(1, 30))))
        for _ in range(1500)
    ]
    db = _db_from_encoded(encoded)
    order = np.argsort(-db.lengths, kind="stable")
    got, _ = _cuda_search(
        [make_profile(sc.table, q)], db, sc.gap_open_total, sc.gap_extend,
        order,
    )
    want, _ = search_encoded(q, encoded, sc, engine="wavefront")
    np.testing.assert_array_equal(got[0], want)


def test_former_package_name_forwards(tmp_path):
    """The package's former name, kept beside ``seqalign``, imports the same
    module objects and still runs the CLI under ``python -m``."""
    import importlib
    import os
    import subprocess
    import sys
    from pathlib import Path

    import seqalign.pipeline

    repo = Path(__file__).resolve().parents[1]
    (old,) = [p.name for p in repo.glob("seqalign_*")
              if (p / "__init__.py").is_file()]
    assert importlib.import_module(f"{old}.pipeline") is seqalign.pipeline
    assert seqalign.pipeline.__spec__.name == "seqalign.pipeline"
    q = tmp_path / "q.fa"
    q.write_text(">q\nACDEFG\n")
    out = subprocess.run(
        [sys.executable, "-m", f"{old}.cli", "--engine", "wavefront",
         "--files", str(q), str(q)],
        capture_output=True, text=True, cwd=repo, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr
    assert "score: 12" in out.stdout
