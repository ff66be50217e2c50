"""Native fastio (C++/ctypes) vs pure-Python reference behavior."""

import os
import gzip

import numpy as np
import pytest

from seqalign.models import PAD_INDEX, encode
from seqalign.utils import native_io
from seqalign.utils.fasta import read_fasta

from conftest import random_protein

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native fastio not built"
)


@pytest.fixture
def fasta_file(tmp_path, rng):
    p = tmp_path / "db.fa"
    lines = []
    for k in range(23):
        lines.append(f">rec{k} some description {k}")
        seq = random_protein(rng, int(rng.integers(1, 90)))
        # split across lines to exercise multi-line records
        lines.append(seq[:30])
        if len(seq) > 30:
            lines.append(seq[30:])
    p.write_text("\n".join(lines) + "\n")
    return str(p)


class TestNativeParse:
    def test_matches_python(self, fasta_file):
        ndb = native_io.parse_file(fasta_file)
        pdb = native_io._parse_file_python(fasta_file)
        assert ndb.n == pdb.n
        np.testing.assert_array_equal(ndb.offsets, pdb.offsets)
        np.testing.assert_array_equal(ndb.seq, pdb.seq)
        assert ndb.names == pdb.names

    def test_gzip(self, fasta_file, tmp_path):
        gz = tmp_path / "db.fa.gz"
        gz.write_bytes(gzip.compress(open(fasta_file, "rb").read()))
        a = native_io.parse_file(fasta_file)
        b = native_io.parse_file(str(gz))
        np.testing.assert_array_equal(a.seq, b.seq)
        assert a.names == b.names

    def test_fastq(self, tmp_path):
        p = tmp_path / "r.fq"
        p.write_text("@r1\nACGT\n+\n!!!!\n@r2\nGGCC\n+\n####\n")
        db = native_io.parse_file(str(p))
        assert db.n == 2
        np.testing.assert_array_equal(db.record(0), encode("ACGT"))
        np.testing.assert_array_equal(db.record(1), encode("GGCC"))
        assert db.names == ["r1", "r2"]

    def test_illegal_char(self, tmp_path):
        p = tmp_path / "bad.fa"
        p.write_text(">x\nAC-GT\n")
        from seqalign.models import AlphabetError

        with pytest.raises(AlphabetError):
            native_io.parse_file(str(p))

    def test_missing_file(self):
        with pytest.raises(OSError):
            native_io.parse_file("/nonexistent/x.fa")

    def test_names_match_python_reader(self, fasta_file):
        ndb = native_io.parse_file(fasta_file)
        recs = list(read_fasta(fasta_file))
        assert ndb.names == [r.name for r in recs]


class TestStreamChunks:
    """Chunked (bounded-memory) reader == whole-file parser, bit for bit."""

    def _concat(self, path, chunk_records):
        tot_n, seqs, names = 0, [], []
        offs, base = [np.zeros(1, dtype=np.int64)], 0
        for ch in native_io.stream_chunks(path, chunk_records):
            assert ch.n <= chunk_records
            tot_n += ch.n
            seqs.append(ch.seq)
            names.extend(ch.names)
            offs.append(ch.offsets[1:] + base)
            base += len(ch.seq)
        seq = (
            np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.int8)
        )
        return tot_n, seq, np.concatenate(offs), names

    @pytest.mark.parametrize("chunk_records", [1, 5, 1000])
    def test_matches_whole_parse(self, fasta_file, chunk_records):
        whole = native_io.parse_file(fasta_file)
        n, seq, offsets, names = self._concat(fasta_file, chunk_records)
        assert n == whole.n
        np.testing.assert_array_equal(seq, whole.seq)
        np.testing.assert_array_equal(offsets, whole.offsets)
        assert names == whole.names

    def test_gzip_and_fastq(self, tmp_path):
        gz = tmp_path / "r.fq.gz"
        gz.write_bytes(
            gzip.compress(b"@r1\nACGT\n+\n!!!!\n@r2\nGGCC\n+\n@@@@\n")
        )
        chunks = list(native_io.stream_chunks(str(gz), 1))
        assert [c.names for c in chunks] == [["r1"], ["r2"]]
        np.testing.assert_array_equal(chunks[1].record(0), encode("GGCC"))

    def test_illegal_char(self, tmp_path):
        p = tmp_path / "bad.fa"
        p.write_text(">x\nAC-GT\n")
        from seqalign.models import AlphabetError

        with pytest.raises(AlphabetError):
            list(native_io.stream_chunks(str(p), 4))

    def test_python_fallback_matches(self, fasta_file):
        import unittest.mock as mock

        want = self._concat(fasta_file, 7)
        with mock.patch.object(native_io, "_load", return_value=None):
            got = self._concat(fasta_file, 7)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[3] == want[3]


class TestNativePack:
    def test_pack_matches_python(self, fasta_file, rng):
        db = native_io.parse_file(fasta_file)
        order = np.argsort(-db.lengths, kind="stable")[:8]
        lb_pad = int(db.lengths.max()) + 5
        got = native_io.pack_batch(db, order, lanes=8, lb_pad=lb_pad)
        # python fallback path
        import seqalign.utils.native_io as nio

        lib, nio._lib = nio._lib, None
        try:
            import unittest.mock as mock

            with mock.patch.object(nio, "_load", return_value=None):
                want = nio.pack_batch(db, order, lanes=8, lb_pad=lb_pad)
        finally:
            nio._lib = lib
        np.testing.assert_array_equal(got, want)
        assert (got[lb_pad - 1] == PAD_INDEX).all()

    def test_pack_wide_ragged(self, tmp_path, rng):
        """Exercise the tiled/SIMD pack: >128 lanes, ragged 16-lane groups.

        Covers every boundary of the fast path: full 16x16 transposed
        blocks, ragged per-lane tails, partial lane groups (lanes not a
        multiple of 16), and empty trailing lanes.
        """
        p = tmp_path / "wide.fa"
        lens = [int(rng.integers(1, 300)) for _ in range(310)]
        with open(p, "w") as f:
            for k, L in enumerate(lens):
                f.write(f">r{k}\n{random_protein(rng, L)}\n")
        db = native_io.parse_file(str(p))
        order = np.argsort(-db.lengths, kind="stable")
        lanes, lb_pad = 384, int(db.lengths.max()) + 3
        got = native_io.pack_batch(db, order, lanes=lanes, lb_pad=lb_pad)
        want = np.full((lb_pad, lanes), PAD_INDEX, dtype=np.int8)
        for lane, rec in enumerate(order):
            r = db.record(int(rec))
            want[: len(r), lane] = r
        np.testing.assert_array_equal(got, want)

    def test_pack_into_out_view(self, fasta_file, rng):
        """out= writes into a view of a larger stream buffer in place."""
        db = native_io.parse_file(fasta_file)
        order = np.argsort(-db.lengths, kind="stable")[:8]
        lb_pad = int(db.lengths.max()) + 1
        big = np.full((3, lb_pad + 10, 8), 99, dtype=np.int8)
        view = big[1, 4 : 4 + lb_pad]
        ret = native_io.pack_batch(db, order, lanes=8, lb_pad=lb_pad, out=view)
        assert ret is view
        direct = native_io.pack_batch(db, order, lanes=8, lb_pad=lb_pad)
        np.testing.assert_array_equal(view, direct)
        assert (big[0] == 99).all() and (big[2] == 99).all()
        assert (big[1, :4] == 99).all() and (big[1, 4 + lb_pad :] == 99).all()

    def test_pack_bad_out(self, fasta_file):
        db = native_io.parse_file(fasta_file)
        order = np.arange(4)
        with pytest.raises(ValueError):
            native_io.pack_batch(
                db, order, lanes=8, lb_pad=16,
                out=np.empty((16, 8), dtype=np.int32),
            )
        with pytest.raises(ValueError):
            native_io.pack_batch(
                db, order, lanes=8, lb_pad=16,
                out=np.empty((8, 16), dtype=np.int8).T,
            )


class TestDbCache:
    """Persistent encoded-database cache (.sqc): parse once, mmap after."""

    def test_round_trip(self, fasta_file, tmp_path):
        db = native_io.parse_file(fasta_file)
        cp = str(tmp_path / "db.sqc")
        native_io.save_cache(db, cp, src_path=fasta_file)
        got = native_io.load_cache(cp, src_path=fasta_file)
        assert got is not None
        np.testing.assert_array_equal(np.asarray(got.seq), db.seq)
        np.testing.assert_array_equal(got.offsets, db.offsets)
        assert got.names == db.names
        assert isinstance(got.seq, np.memmap)  # zero-copy load

    def test_cached_parse_skips_reparse(self, fasta_file, monkeypatch):
        cache = fasta_file + ".sqc"
        db1 = native_io.parse_file_cached(fasta_file, "auto")
        assert os.path.exists(cache)
        calls = []
        real = native_io.parse_file
        monkeypatch.setattr(
            native_io, "parse_file",
            lambda p: calls.append(p) or real(p),
        )
        db2 = native_io.parse_file_cached(fasta_file, "auto")
        assert calls == []  # served from the cache, no reparse
        np.testing.assert_array_equal(np.asarray(db2.seq), db1.seq)
        assert db2.names == db1.names
        os.remove(cache)

    def test_stale_source_rebuilds(self, tmp_path):
        src = tmp_path / "db.fa"
        src.write_text(">a\nACDE\n")
        cp = str(tmp_path / "db.sqc")
        db1 = native_io.parse_file_cached(str(src), cp)
        assert db1.n == 1
        src.write_text(">a\nACDE\n>b\nWWYY\n")
        os.utime(src, ns=(1, 1))  # force a distinct mtime_ns
        db2 = native_io.parse_file_cached(str(src), cp)
        assert db2.n == 2  # stale cache rebuilt from the new FASTA
        db3 = native_io.load_cache(cp, src_path=str(src))
        assert db3 is not None and db3.n == 2  # cache was rewritten

    def test_cache_only_deployment(self, tmp_path):
        """The FASTA may be deleted after caching; the .sqc serves alone."""
        src = tmp_path / "db.fa"
        src.write_text(">x\nMKV\n>y\nRNDC\n")
        cp = str(tmp_path / "db.sqc")
        native_io.parse_file_cached(str(src), cp)
        os.remove(src)
        db = native_io.parse_file_cached(str(src), cp)
        assert db.n == 2 and db.names == ["x", "y"]
        assert list(np.diff(db.offsets)) == [3, 4]

    def test_corrupt_cache_rebuilds(self, fasta_file, tmp_path):
        cp = str(tmp_path / "db.sqc")
        with open(cp, "wb") as f:
            f.write(b"garbage")
        db = native_io.parse_file_cached(fasta_file, cp)
        want = native_io.parse_file(fasta_file)
        np.testing.assert_array_equal(np.asarray(db.seq), want.seq)
        # and the cache was repaired in place
        assert native_io.load_cache(cp, src_path=fasta_file) is not None

    def test_truncated_cache_rejected(self, fasta_file, tmp_path):
        cp = str(tmp_path / "db.sqc")
        db = native_io.parse_file(fasta_file)
        native_io.save_cache(db, cp, src_path=fasta_file)
        with open(cp, "r+b") as f:
            f.truncate(os.path.getsize(cp) - 3)
        assert native_io.load_cache(cp, src_path=fasta_file) is None

    def test_empty_db(self, tmp_path):
        src = tmp_path / "empty.fa"
        src.write_text("")
        cp = str(tmp_path / "e.sqc")
        try:
            db = native_io.parse_file(str(src))
        except ValueError:
            pytest.skip("parser rejects empty files")
        native_io.save_cache(db, cp, src_path=str(src))
        got = native_io.load_cache(cp, src_path=str(src))
        assert got is not None and got.n == 0 and got.names == []

    def test_pack_batch_from_memmap(self, fasta_file, tmp_path):
        """The stream packer reads straight out of the mmapped cache."""
        db = native_io.parse_file(fasta_file)
        cp = str(tmp_path / "db.sqc")
        native_io.save_cache(db, cp, src_path=fasta_file)
        got = native_io.load_cache(cp, src_path=fasta_file)
        order = np.argsort(-db.lengths, kind="stable")[:8]
        lb_pad = int(db.lengths.max()) + 1
        a = native_io.pack_batch(db, order, lanes=8, lb_pad=lb_pad)
        b = native_io.pack_batch(got, order, lanes=8, lb_pad=lb_pad)
        np.testing.assert_array_equal(a, b)

    def test_corrupt_header_fields_rejected(self, fasta_file, tmp_path):
        """Garbage header counts (e.g. n=2**40) must mean None/rebuild,
        never a giant allocation or MemoryError escaping load_cache."""
        db = native_io.parse_file(fasta_file)
        cp = str(tmp_path / "db.sqc")
        native_io.save_cache(db, cp, src_path=fasta_file)
        raw = bytearray(open(cp, "rb").read())
        for field, val in ((0, 2**40), (0, -1), (1, -5), (2, 2**50)):
            bad = bytearray(raw)
            bad[8 + 8 * field : 16 + 8 * field] = int(val).to_bytes(
                8, "little", signed=True
            )
            open(cp, "wb").write(bad)
            assert native_io.load_cache(cp, src_path=fasta_file) is None

    def test_corrupt_offsets_rejected(self, fasta_file, tmp_path):
        """Non-monotonic or out-of-range offsets are rejected before the
        native packer could dereference them."""
        db = native_io.parse_file(fasta_file)
        cp = str(tmp_path / "db.sqc")
        bad = native_io.EncodedDatabase(
            seq=db.seq, offsets=db.offsets.copy(), names=db.names
        )
        bad.offsets[1] = -7  # negative / non-monotonic
        native_io.save_cache(bad, cp, src_path=fasta_file)
        assert native_io.load_cache(cp, src_path=fasta_file) is None
        bad.offsets[:] = db.offsets
        bad.offsets[-1] = db.offsets[-1] + 9  # walks past the seq buffer
        native_io.save_cache(bad, cp, src_path=fasta_file)
        assert native_io.load_cache(cp, src_path=fasta_file) is None

    def test_unicode_names_round_trip(self, tmp_path):
        """Names survive the cache byte-exactly (UTF-8), so cold and warm
        runs print identical headers even for non-ASCII FASTA."""
        db = native_io.EncodedDatabase(
            seq=np.array([1, 2, 3], dtype=np.int8),
            offsets=np.array([0, 3], dtype=np.int64),
            names=["héllo désc"],
        )
        cp = str(tmp_path / "u.sqc")
        native_io.save_cache(db, cp)
        got = native_io.load_cache(cp)
        assert got is not None and got.names == ["héllo désc"]

    def test_gzip_source_cached(self, fasta_file, tmp_path):
        """A gzip FASTA caches like a plain one (fingerprint is on the
        .gz file); warm load skips the decompress+parse entirely."""
        import gzip as _gz

        gz = str(tmp_path / "db.fa.gz")
        with open(fasta_file, "rb") as src, _gz.open(gz, "wb") as dst:
            dst.write(src.read())
        cp = str(tmp_path / "db.sqc")
        db1 = native_io.parse_file_cached(gz, cp)
        db2 = native_io.load_cache(cp, src_path=gz)
        assert db2 is not None
        np.testing.assert_array_equal(np.asarray(db2.seq), np.asarray(db1.seq))
        assert db2.names == db1.names


def test_fifo_inputs(tmp_path):
    """Non-seekable inputs (named pipes): gzip data must survive the
    magic-byte probe (ADVICE round-3: the old probe consumed 2 bytes of a
    FIFO before reopening via gzopen, losing them). Non-seekable inputs
    now route through gzdopen on the same descriptor, which reads gzip
    AND plain data transparently."""
    import threading

    def run(name, data):
        fifo = str(tmp_path / name)
        os.mkfifo(fifo)

        def writer():
            with open(fifo, "wb") as w:
                w.write(data)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        db = native_io.parse_file(fifo)
        t.join(5)
        return db

    db = run("a.fa.gz", gzip.compress(b">r1\nACDEF\n>r2\nGHIKLMNP\n"))
    assert db.n == 2 and int(db.offsets[-1]) == 13
    got = np.asarray(db.seq[: int(db.offsets[1])])
    np.testing.assert_array_equal(got, np.array(encode("ACDEF"), np.int8))

    db = run("b.fa", b">a\nWYV\n")
    assert db.n == 1 and int(db.offsets[-1]) == 3
