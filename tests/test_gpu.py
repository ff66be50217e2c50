"""The CUDA engine on the card: exact against the oracle and the wavefront.

Every test here takes the ``gpu`` fixture and is marked ``gpu``; off the
card they skip. Run them on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py
"""

import numpy as np
import pytest

from seqalign.models import ScoringModel, encode, load_builtin
from seqalign.ops.oracle import sw_score_batch

from conftest import random_protein

pytestmark = pytest.mark.gpu


def _db(rng, n, lo, hi):
    from seqalign.pipeline import _db_from_encoded

    enc = [encode(random_protein(rng, int(rng.integers(lo, hi))))
           for _ in range(n)]
    return enc, _db_from_encoded(enc)


@pytest.mark.parametrize("lq", [1, 20, 21, 64, 65, 200])
@pytest.mark.parametrize("gaps", [(-2, -1), (-10, -1), (0, 0)])
def test_cuda_matches_oracle(gpu, rng, lq, gaps):
    from seqalign.pipeline import search_database

    sc = load_builtin(
        "BLOSUM62",
        ScoringModel(gap_open=gaps[0], gap_extend=gaps[1],
                     use_match_mismatch=False),
    )
    q = sc.query_indices(random_protein(rng, lq))
    enc, db = _db(rng, 70, 0, 120)
    got, _ = search_database(q, db, sc, engine="cuda")
    want = sw_score_batch(q, enc, sc.table, sc.gap_open, sc.gap_extend)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lq", [17, 144, 1000])
def test_cuda_matches_wavefront(gpu, rng, pam250, lq):
    from seqalign.pipeline import search_database

    q = pam250.query_indices(random_protein(rng, lq))
    _, db = _db(rng, 3000, 1, 700)
    got, _ = search_database(q, db, pam250, engine="cuda")
    want, _ = search_database(q, db, pam250, engine="wavefront")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lq", [17, 144])
def test_cuda_long_records(gpu, rng, pam250, lq):
    """Records as long as Swiss-Prot's longest entry (35,213 residues)
    beside short ones, against the wavefront."""
    from seqalign.pipeline import _db_from_encoded, search_database

    q = pam250.query_indices(random_protein(rng, lq))
    enc, _ = _db(rng, 60, 1, 400)
    enc += [encode(random_protein(rng, n)) for n in (35_213, 12_000, 3_001)]
    db = _db_from_encoded(enc)
    got, _ = search_database(q, db, pam250, engine="cuda")
    want, _ = search_database(q, db, pam250, engine="wavefront")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lq", [1, 33, 144, 257, 600])
def test_cuda_long_kernel_matches_oracle(gpu, rng, blosum62, monkeypatch,
                                         lq):
    """Every record but the shortest through the warp-per-record kernel,
    one to three passes."""
    from seqalign.ops import swa_cuda
    from seqalign.pipeline import search_database

    monkeypatch.setattr(swa_cuda, "LONG_RECORD", 8)
    q = blosum62.query_indices(random_protein(rng, lq))
    enc, db = _db(rng, 50, 0, 300)
    got, _ = search_database(q, db, blosum62, engine="cuda")
    want = sw_score_batch(q, enc, blosum62.table, blosum62.gap_open,
                          blosum62.gap_extend)
    np.testing.assert_array_equal(got, want)


def test_cuda_chunks_and_queries(gpu, rng, blosum62, monkeypatch):
    """Several chunks per scan and several queries per packed chunk."""
    from seqalign.ops import swa_cuda
    from seqalign.pipeline import search_database, search_database_multi

    monkeypatch.setattr(swa_cuda, "CHUNK_RESIDUES", 5000)
    qs = [blosum62.query_indices(random_protein(rng, n)) for n in (5, 90)]
    _, db = _db(rng, 1000, 1, 60)
    got, _ = search_database_multi(qs, db, blosum62, engine="cuda")
    for k, q in enumerate(qs):
        want, _ = search_database(q, db, blosum62, engine="wavefront")
        np.testing.assert_array_equal(got[k], want)
