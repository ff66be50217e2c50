"""The CUDA engine's host side on CPU: the NumPy model of the kernel's loop
nest against the oracle, packing and strips, the one engine-choice
function, and where the compile cache lives. The kernel itself runs on the
card only (tests/test_gpu.py)."""

import numpy as np
import pytest

from seqalign.models import ScoringModel, encode, load_builtin
from seqalign.ops import swa_cuda
from seqalign.ops.oracle import sw_score_batch
from seqalign.ops.swa_xla import make_profile
from seqalign.pipeline import _db_from_encoded

from conftest import random_protein


def _model_scores(sc, q, encoded, max_rows, long_record=None):
    db = _db_from_encoded(encoded)
    order = np.argsort(-db.lengths, kind="stable")
    pack = swa_cuda.pack_groups(db, order, long_record)
    profs = swa_cuda.query_profiles(make_profile(sc.table, q),
                                    sc.gap_open_total, max_rows)
    out = swa_cuda.reference_kernel(
        *profs, *pack.arrays, go=sc.gap_open_total, ge=sc.gap_extend,
    )
    scores = np.zeros(db.n, dtype=np.int32)
    scores[pack.ids] = out[pack.slots]
    return scores


@pytest.mark.parametrize("max_rows", [4, 8, 48])
@pytest.mark.parametrize("delta", ["one", "strip-1", "strip", "strip+1",
                                   "3strips"])
def test_model_matches_oracle(rng, blosum62, max_rows, delta):
    """Strip heights x query lengths around a strip boundary, records of
    length 0 to 40 (empty lanes and empty records included)."""
    lq = {"one": 1, "strip-1": max_rows - 1, "strip": max_rows,
          "strip+1": max_rows + 1, "3strips": 3 * max_rows - 2}[delta]
    lq = max(lq, 1)
    q = blosum62.query_indices(random_protein(rng, lq))
    encoded = [encode(random_protein(rng, int(rng.integers(0, 40))))
               for _ in range(45)]
    want = sw_score_batch(q, encoded, blosum62.table, blosum62.gap_open,
                          blosum62.gap_extend)
    np.testing.assert_array_equal(
        _model_scores(blosum62, q, encoded, max_rows), want
    )


@pytest.mark.parametrize("lq", [1, 31, 33, 144, 257])
def test_long_model_matches_oracle(rng, blosum62, lq):
    """The long kernel's model (one warp per record, the lanes splitting
    the query rows) around pass and lane boundaries: 257 rows take two
    passes. Records of length 0 to 60, all but the shortest long."""
    q = blosum62.query_indices(random_protein(rng, lq))
    encoded = [encode(random_protein(rng, int(n)))
               for n in (0, 1, 2, 11, 12, 60, *rng.integers(0, 60, 14))]
    want = sw_score_batch(q, encoded, blosum62.table, blosum62.gap_open,
                          blosum62.gap_extend)
    np.testing.assert_array_equal(
        _model_scores(blosum62, q, encoded, 48, long_record=2), want
    )


@pytest.mark.parametrize("gaps", [(0, 0), (-10, -1), (0, -3)])
def test_model_gap_systems(rng, gaps):
    sc = load_builtin("PAM250", ScoringModel(
        gap_open=gaps[0], gap_extend=gaps[1], use_match_mismatch=False))
    q = sc.query_indices(random_protein(rng, 30))
    encoded = [encode(random_protein(rng, int(rng.integers(1, 50))))
               for _ in range(40)]
    want = sw_score_batch(q, encoded, sc.table, sc.gap_open, sc.gap_extend)
    np.testing.assert_array_equal(_model_scores(sc, q, encoded, 8), want)
    np.testing.assert_array_equal(
        _model_scores(sc, q, encoded, 8, long_record=20), want
    )


def test_model_ignores_padding_scores(rng):
    """A matrix that rewards '*' must not leak into scores: the kernel
    masks positions past each record's end instead of relying on the pad
    residue scoring <= 0."""
    sc = load_builtin("BLOSUM62", ScoringModel(
        gap_open=-2, gap_extend=-1, use_match_mismatch=False))
    sc.table = sc.table.copy()
    sc.table[:, 31] = 9
    q = sc.query_indices(random_protein(rng, 12))
    encoded = [encode(random_protein(rng, n)) for n in (3, 17, 30, 1)]
    want = sw_score_batch(q, encoded, sc.table, sc.gap_open, sc.gap_extend)
    np.testing.assert_array_equal(_model_scores(sc, q, encoded, 8), want)


@pytest.mark.parametrize("lq,want", [
    (1, (1, 4)), (17, (1, 20)), (48, (1, 48)), (49, (2, 28)),
    (144, (3, 48)), (5478, (115, 48)),
])
def test_strip_shape(lq, want):
    n, r = swa_cuda.strip_shape(lq)
    assert (n, r) == want and r in swa_cuda.STRIP_HEIGHTS and n * r >= lq


@pytest.mark.parametrize("lq,want", [
    (1, (1, 1)), (17, (1, 1)), (33, (1, 2)), (144, (1, 5)), (256, (1, 8)),
    (257, (2, 5)), (1000, (4, 8)), (5478, (22, 8)),
])
def test_long_shape(lq, want):
    n, r = swa_cuda.long_shape(lq)
    assert (n, r) == want and r in swa_cuda.LONG_HEIGHTS
    assert n * r * swa_cuda.LANES >= lq


def test_long_profile_layout(blosum62):
    prof = make_profile(blosum62.table, np.arange(40) % 20 + 1)  # 40 rows
    lp = swa_cuda.long_profile(prof, -3)  # one pass, 2 rows per lane
    assert lp.shape == (1, 64, 32) and lp.dtype == np.int32
    assert lp[0, 39, 7] == prof[39, 7] + 3
    assert (lp[0, 40:] == swa_cuda.PAD_ROW).all()


def test_strip_profile_layout(blosum62):
    prof = make_profile(blosum62.table, np.arange(1, 11))
    sp = swa_cuda.strip_profile(prof, -3, max_rows=4)  # 3 strips of 4
    assert sp.shape == (3, 32, 4) and sp.dtype == np.int32
    assert sp[1, 7, 2] == prof[6, 7] + 3  # row 4*1+2, residue 7
    assert (sp[2, :, 2:] == swa_cuda.PAD_ROW).all()  # rows 10, 11 pad


def test_pack_groups_layout(rng):
    lens = [5, 40, 0, 9] + [3] * 31
    encoded = [encode(random_protein(rng, n)) for n in lens]
    db = _db_from_encoded(encoded)
    order = np.argsort(-db.lengths, kind="stable")
    pack = swa_cuda.pack_groups(db, order)
    assert pack.row_off.tolist() == [0, 40, 48]  # group lengths round to 8
    assert pack.lens.tolist()[:4] == [40, 9, 5, 3]
    rows = pack.db.reshape(-1, 32)
    np.testing.assert_array_equal(rows[:40, 0], encoded[1])
    assert (rows[9:40, 1] == 31).all()  # '*' padding
    np.testing.assert_array_equal(rows[40:43, 0], encoded[order[32]])
    assert pack.lens[35:].sum() == 0  # empty lanes of the last group


def test_pack_groups_long_records(rng):
    """Records over the cut lie back to back for the long kernel; the
    output slots put them first, then the group lanes."""
    lens = [50, 3, 70, 10, 5]
    encoded = [encode(random_protein(rng, n)) for n in lens]
    db = _db_from_encoded(encoded)
    order = np.argsort(-db.lengths, kind="stable")  # 2, 0, 3, 4, 1
    pack = swa_cuda.pack_groups(db, order, long_record=40)
    assert pack.ids.tolist() == [2, 0, 3, 4, 1]
    assert pack.long_off.tolist() == [0, 70, 120]
    np.testing.assert_array_equal(pack.long_db[:70], encoded[2])
    np.testing.assert_array_equal(pack.long_db[70:120], encoded[0])
    assert pack.slots.tolist() == [0, 1, 2, 3, 4]  # 2 long slots, lanes
    assert pack.lens.tolist()[:3] == [10, 5, 3]
    nolong = swa_cuda.pack_groups(db, order)
    assert nolong.long_off.tolist() == [0, 0]  # one empty long slot
    assert nolong.slots.tolist() == [1, 2, 3, 4, 5]


def test_bucket():
    """Eight sizes per doubling, never below n, at most 12.5% above."""
    ns = np.arange(0, (1 << 16) + 1)
    b = np.array([swa_cuda.bucket(int(n)) for n in ns])
    assert (b >= ns).all() and (b[16:] <= ns[16:] * 1.125).all()
    assert (b[:16] == ns[:16]).all()
    # (2**15, 2**16]: one doubling, eight sizes.
    assert len(np.unique(b[(1 << 15) + 1 :])) == 8


def test_chunks_of_different_sizes_share_one_kernel(rng, monkeypatch):
    """Packed shapes come in bucket sizes, so chunks that differ a little
    reuse one compiled kernel; the cache of compiled kernels is bounded."""
    import collections

    import jax

    compiles = []

    class Lowered:
        def compile(self):
            compiles.append(1)
            return object()

    class Jitted:
        def lower(self, *args, **kwargs):
            return Lowered()

    monkeypatch.setattr(swa_cuda, "ensure_registered", lambda: None)
    monkeypatch.setattr(swa_cuda, "_ffi_score", Jitted())
    monkeypatch.setattr(swa_cuda, "_COMPILED", collections.OrderedDict())
    monkeypatch.setattr(swa_cuda, "MAX_COMPILED", 2)
    profs = [jax.device_put(p)
             for p in swa_cuda.query_profiles(np.zeros((10, 32)), -3)]

    def compile_for(n, length):
        db = _db_from_encoded([np.ones(length, np.int8)] * n)
        pack = swa_cuda.pack_groups(db, np.arange(n))
        dev = [jax.device_put(x) for x in pack.arrays]
        return swa_cuda.compile_kernel(*profs, *dev, go=-3, ge=-1)

    first = compile_for(33 * 32, 10)  # 33 groups of 16 rows
    assert compile_for(34 * 32 - 5, 10) is first  # 34 groups: same bucket
    assert len(compiles) == 1
    compile_for(200, 300)
    compile_for(5000, 40)
    assert len(compiles) == 3 and len(swa_cuda._COMPILED) == 2


def test_synth_long_tail():
    """The stand-in database reaches Swiss-Prot's longest entry: its 1,000
    longest records fall from 35,213 to 3,000 residues, longest first."""
    from seqalign.utils import synth

    tail = synth.long_tail()
    assert tail[0] == 35_213 and tail[-1] == 3_000 and len(tail) == 1000
    assert (np.diff(tail) <= 0).all()
    db = synth.swissprot_like(20_000, seed=1)
    top = np.sort(db.lengths)[::-1]
    np.testing.assert_array_equal(top[:1000], tail)
    assert top[1000] < 3_000 and db.lengths.min() >= 2
    assert len(db.seq) == db.offsets[-1] == db.lengths.sum()


def test_chunk_bounds():
    lengths = np.full(100, 10)
    b = swa_cuda.chunk_bounds(lengths, 400)
    assert b == [(0, 32), (32, 64), (64, 100)]  # whole groups, <= 400
    assert swa_cuda.chunk_bounds(lengths, 10**9) == [(0, 100)]
    assert swa_cuda.chunk_bounds(np.zeros(0, int), 10) == []


class TestChooseEngine:
    @pytest.mark.parametrize("platform,go,ge,want", [
        ("cpu", -3, -1, "wavefront"),
        ("gpu", -3, -1, "cuda"),
        ("gpu", 0, 0, "cuda"),
        ("gpu", 1, -1, "wavefront"),   # gap open > 0
        ("gpu", -1, 2, "wavefront"),   # gap extend > 0
    ])
    def test_default(self, platform, go, ge, want):
        from seqalign.pipeline import choose_engine

        assert choose_engine(None, go, ge, platform=platform) == want

    @pytest.mark.parametrize("platform,go,ge", [
        ("cpu", -3, -1), ("gpu", 1, -1),
    ])
    def test_explicit_cuda_raises(self, platform, go, ge):
        from seqalign.pipeline import EngineError, choose_engine

        with pytest.raises(EngineError):
            choose_engine("cuda", go, ge, platform=platform)

    def test_unknown_engine(self):
        from seqalign.pipeline import EngineError, choose_engine

        with pytest.raises(EngineError):
            choose_engine("pallas", -3, -1, platform="gpu")
        assert choose_engine("wavefront", -3, -1, platform="gpu") == (
            "wavefront"
        )

    def test_cli_cuda_without_gpu(self, tmp_path, capsys):
        from seqalign import cli

        q = tmp_path / "q.fa"
        q.write_text(">q\nACDE\n")
        code = cli.main(["sw", "--engine", "cuda", "--files", str(q),
                         str(q)])
        assert code == 1
        assert "needs a GPU" in capsys.readouterr().err

    def test_search_routes_positive_gap_open_to_wavefront(
        self, rng, monkeypatch
    ):
        """On a GPU, a scoring system outside the G-form goes to the
        wavefront by that property of the input."""
        import jax

        from seqalign import pipeline

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(
            pipeline, "_cuda_search",
            lambda *a, **k: pytest.fail("cuda engine chosen"),
        )
        sc = load_builtin("BLOSUM62", ScoringModel(
            gap_open=2, gap_extend=-1, use_match_mismatch=False))
        q = sc.query_indices(random_protein(rng, 9))
        encoded = [encode(random_protein(rng, 12)) for _ in range(5)]
        got, _ = pipeline.search_database(
            q, _db_from_encoded(encoded), sc, lanes=8
        )
        want = sw_score_batch(q, encoded, sc.table, sc.gap_open,
                              sc.gap_extend)
        np.testing.assert_array_equal(got, want)


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self):
        import jax

        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_dir_wins(self, monkeypatch, tmp_path):
        import jax

        from seqalign.pipeline import compile_cache_dir, enable_compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", "/elsewhere")
        enable_compile_cache()
        assert compile_cache_dir() == str(tmp_path)
        # No other directory is set in code.
        assert jax.config.jax_compilation_cache_dir == "/elsewhere"

    def test_default_in_checkout(self, monkeypatch):
        from pathlib import Path

        import jax

        from seqalign.pipeline import enable_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        enable_compile_cache()
        repo = Path(__file__).resolve().parents[1]
        assert jax.config.jax_compilation_cache_dir == str(repo / ".jax_cache")
        assert ".jax_cache/" in (repo / ".gitignore").read_text()
