"""Sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from seqalign.models import encode
from seqalign.ops.swa_xla import make_profile, sw_wavefront
from seqalign.parallel import (
    host_stripe,
    make_mesh,
    merge_topk_candidates,
    shard_db,
    sharded_engine,
    sharded_topk,
)

from conftest import random_protein


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return make_mesh(jax.devices()[:8])


class TestShardedSearch:
    def test_matches_unsharded(self, rng, blosum62, mesh8):
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 19))
        prof = make_profile(sc.table, q)
        db = rng.integers(1, 27, (40, 8 * 16)).astype(np.int32)
        go, ge = sc.gap_open_total, sc.gap_extend
        run = sharded_engine(sw_wavefront, mesh8, go, ge)
        got = np.asarray(run(prof, shard_db(db, mesh8)))
        want = np.asarray(sw_wavefront(prof, db, go, ge))
        np.testing.assert_array_equal(got, want)

    def test_topk_merge(self, rng, blosum62, mesh8):
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 17))
        prof = make_profile(sc.table, q)
        db = rng.integers(1, 27, (32, 8 * 8)).astype(np.int32)
        go, ge = sc.gap_open_total, sc.gap_extend
        topk = sharded_topk(sw_wavefront, mesh8, go, ge, k=5)
        vals, idx = topk(prof, shard_db(db, mesh8))
        vals, idx = np.asarray(vals), np.asarray(idx)
        want = np.asarray(sw_wavefront(prof, db, go, ge))
        want_vals = np.sort(want)[::-1][:5]
        np.testing.assert_array_equal(np.sort(vals)[::-1], want_vals)
        # indices point at lanes with those scores
        np.testing.assert_array_equal(np.sort(want[idx])[::-1], want_vals)


class TestMultihostLogic:
    def test_host_stripe(self):
        recs = list(range(10))
        stripes = [list(host_stripe(recs, p, 3)) for p in range(3)]
        assert stripes == [[0, 3, 6, 9], [1, 4, 7], [2, 5, 8]]
        assert sorted(sum(stripes, [])) == recs

    def test_merge_topk(self):
        s0 = np.array([10, 5, 3])
        i0 = np.array([0, 3, 6])
        s1 = np.array([8, 7, 1])
        i1 = np.array([1, 4, 7])
        vals, ids = merge_topk_candidates(s0, i0, 4, [(s1, i1)])
        assert vals.tolist() == [10, 8, 7, 5]
        assert ids.tolist() == [0, 1, 4, 3]


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys

        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert np.asarray(out).shape[0] == args[1].shape[1]

    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import sys

        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestMultiDevice:
    """Data-parallel multi-device search (stream kernel per device)."""

    def test_deal_chunks_balances(self):
        from seqalign.parallel.multidevice import deal_chunks

        rng = np.random.default_rng(3)
        lengths = np.sort(rng.integers(10, 1000, 64 * 1024))[::-1]
        order = np.arange(len(lengths))
        chunks = deal_chunks(order, lengths, 4)
        assert sum(len(c) for c in chunks) == len(order)
        totals = [int(lengths[c].sum()) for c in chunks]
        assert max(totals) / min(totals) < 1.05

    @pytest.mark.slow
    def test_multi_device_search_interpret(
        self, rng, blosum62, cuda_standin, monkeypatch
    ):
        """The CUDA path of multi_device_search (deal, per-device pack and
        dispatch, scatter) over 2 CPU devices, kernel = NumPy model."""
        from seqalign import pipeline
        from seqalign.models import encode
        from seqalign.ops.swa_xla import make_profile
        from seqalign.parallel.multidevice import multi_device_search
        from seqalign.pipeline import _db_from_encoded, search_encoded
        from conftest import random_protein

        monkeypatch.setattr(pipeline, "choose_engine", lambda *a, **k: "cuda")
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 11))
        prof = make_profile(sc.table, q)
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 16))))
            for _ in range(4000)
        ]
        db = _db_from_encoded(encoded)
        got, _ = multi_device_search(
            prof, db, sc.gap_open_total, sc.gap_extend,
            devices=jax.devices()[:2],
        )
        want, _ = search_encoded(q, encoded, sc, engine="wavefront")
        np.testing.assert_array_equal(got, want)

    def test_multi_device_search_wavefront(self, rng, blosum62):
        """On CPU devices multi_device_search picks the wavefront."""
        from seqalign.models import encode
        from seqalign.ops.oracle import sw_score_batch
        from seqalign.ops.swa_xla import make_profile
        from seqalign.parallel.multidevice import multi_device_search
        from seqalign.pipeline import _db_from_encoded
        from conftest import random_protein

        sc = blosum62
        qs = [sc.query_indices(random_protein(rng, 9)) for _ in range(2)]
        encoded = [
            encode(random_protein(rng, int(rng.integers(1, 30))))
            for _ in range(1500)
        ]
        profs = np.stack([make_profile(sc.table, q) for q in qs])
        got, _ = multi_device_search(
            profs, _db_from_encoded(encoded), sc.gap_open_total,
            sc.gap_extend, devices=jax.devices()[:3],
        )
        for k, q in enumerate(qs):
            want = sw_score_batch(q, encoded, sc.table, sc.gap_open,
                                  sc.gap_extend)
            np.testing.assert_array_equal(got[k], want)


class TestLongPair:
    """Sequence-parallel single-pair alignment: query rows sharded across
    the mesh, stripe boundaries exchanged between devices
    (parallel/longpair.py) —
    the SURVEY §2 context-parallel-like stretch row."""

    def test_matches_wavefront(self, rng, blosum62, mesh8):
        from seqalign.ops.swa_xla import make_profile, sw_wavefront
        from seqalign.parallel.longpair import sw_longpair
        from conftest import random_protein

        sc = blosum62
        for lq, lb, b, jb in [(100, 333, 16, 32), (7, 500, 8, 64)]:
            q = sc.query_indices(random_protein(rng, lq))
            prof = make_profile(sc.table, q)
            db = np.full((lb, b), 31, dtype=np.int32)
            for lane in range(b):
                s = sc.query_indices(
                    random_protein(rng, int(rng.integers(1, lb)))
                )
                db[: len(s), lane] = s
            got = np.asarray(sw_longpair(prof, db, sc.gap_open_total,
                                         sc.gap_extend, mesh8, jb=jb))
            want = np.asarray(
                sw_wavefront(prof, db, sc.gap_open_total, sc.gap_extend)
            )
            np.testing.assert_array_equal(got, want)

    def test_2d_mesh_data_by_seq(self, rng, blosum62):
        """dp x sp composition: lanes sharded over 'data', query rows over
        'seq'; each data slice runs its own wavefront pipeline and the
        boundary ppermute rides only the seq subgroups."""
        import jax
        from jax.sharding import Mesh

        from seqalign.ops.swa_xla import make_profile, sw_wavefront
        from seqalign.parallel.longpair import sw_longpair
        from conftest import random_protein

        sc = blosum62
        devs = np.array(jax.devices()[:8]).reshape(2, 4)
        mesh = Mesh(devs, ("data", "seq"))
        for lq, lb, b, jb in [(100, 333, 16, 32), (50, 200, 13, 64)]:
            q = sc.query_indices(random_protein(rng, lq))
            prof = make_profile(sc.table, q)
            db = np.full((lb, b), 31, dtype=np.int32)
            for lane in range(b):
                s = sc.query_indices(
                    random_protein(rng, int(rng.integers(1, lb)))
                )
                db[: len(s), lane] = s
            got = np.asarray(
                sw_longpair(
                    prof, db, sc.gap_open_total, sc.gap_extend, mesh,
                    jb=jb, axis="seq", data_axis="data",
                )
            )
            want = np.asarray(
                sw_wavefront(prof, db, sc.gap_open_total, sc.gap_extend)
            )
            np.testing.assert_array_equal(got, want)

    def test_single_device_mesh(self, rng, blosum62):
        """Degenerate 1-device mesh: the pipeline reduces to plain blocks."""
        import jax

        from seqalign.ops.swa_xla import make_profile, sw_wavefront
        from seqalign.parallel.longpair import sw_longpair
        from seqalign.parallel.sharding import make_mesh
        from conftest import random_protein

        sc = blosum62
        mesh1 = make_mesh(jax.devices()[:1], axis="q")
        q = sc.query_indices(random_protein(rng, 23))
        prof = make_profile(sc.table, q)
        db = np.full((100, 8), 31, dtype=np.int32)
        for lane in range(8):
            s = sc.query_indices(random_protein(rng, 60))
            db[: len(s), lane] = s
        got = np.asarray(
            sw_longpair(prof, db, sc.gap_open_total, sc.gap_extend, mesh1)
        )
        want = np.asarray(
            sw_wavefront(prof, db, sc.gap_open_total, sc.gap_extend)
        )
        np.testing.assert_array_equal(got, want)
