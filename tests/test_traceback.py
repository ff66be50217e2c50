"""Traceback tests: score consistency with the oracle, valid alignments."""

import numpy as np
import pytest

from seqalign.models import ScoringModel, encode, sw_default_scoring
from seqalign.ops.oracle import sw_score_single
from seqalign.ops.traceback import sw_traceback, topk_alignments

from conftest import random_protein


def check_alignment_consistent(aln, q, d, table, gap_open, gap_extend):
    """Re-score the reported alignment path and verify invariants."""
    assert len(aln.query_aligned) == len(aln.db_aligned)
    go = gap_open + gap_extend
    ge = gap_extend
    score = 0
    qi, di = aln.query_start, aln.db_start
    prev = None
    for qc, dc in zip(aln.query_aligned, aln.db_aligned):
        assert not (qc == "-" and dc == "-")
        if qc == "-":
            score += go if prev != "D" else ge
            di += 1
            prev = "D"
        elif dc == "-":
            score += go if prev != "I" else ge
            qi += 1
            prev = "I"
        else:
            score += int(table[q[qi], d[di]])
            qi += 1
            di += 1
            prev = "M"
    assert qi == aln.query_end and di == aln.db_end
    # The path's raw score can exceed aln.score only if the zero-floor was
    # used mid-path; for the optimal path it must equal the DP score.
    assert score == aln.score, (score, aln.score)


class TestTraceback:
    def test_exact_match(self):
        sc = sw_default_scoring()
        q = encode("MKTAYI")
        aln = sw_traceback(q, q, sc.table, sc.gap_open, sc.gap_extend)
        assert aln.score == 12
        assert aln.cigar == "6M"
        assert aln.query_aligned == "MKTAYI"
        assert aln.db_aligned == "MKTAYI"

    def test_with_gap(self):
        sc = sw_default_scoring()
        q, d = encode("AAGGAA"), encode("AAAA")
        aln = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        # Two co-optimal paths exist (AA--AA with a 2-gap, or plain AA):
        # both score 4; any optimal, self-consistent path is acceptable.
        assert aln.score == 4
        check_alignment_consistent(
            aln, q, d, sc.table, sc.gap_open, sc.gap_extend
        )

    @pytest.mark.parametrize("trial", range(12))
    def test_score_matches_oracle_random(self, rng, blosum62, trial):
        sc = blosum62
        lq = int(rng.integers(2, 40))
        lb = int(rng.integers(2, 60))
        q = encode(random_protein(rng, lq))
        d = encode(random_protein(rng, lb))
        want = sw_score_single(q, d, sc.table, sc.gap_open, sc.gap_extend)
        aln = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        assert aln.score == want
        if want > 0:
            check_alignment_consistent(
                aln, q, d, sc.table, sc.gap_open, sc.gap_extend
            )

    def test_zero_score(self):
        sc = sw_default_scoring()
        aln = sw_traceback(
            encode("AAAA"), encode("TTTT"), sc.table, sc.gap_open, sc.gap_extend
        )
        assert aln.score == 0
        assert aln.cigar == ""

    def test_topk(self, rng, blosum62):
        from seqalign.pipeline import _db_from_encoded

        sc = blosum62
        q = encode(random_protein(rng, 20))
        encoded = [encode(random_protein(rng, 30)) for _ in range(12)]
        encoded[5] = q.copy()  # plant an exact match
        db = _db_from_encoded(encoded)
        scores = np.array(
            [
                sw_score_single(q, e, sc.table, sc.gap_open, sc.gap_extend)
                for e in encoded
            ]
        )
        hits = topk_alignments(
            q, db, scores, 3, sc.table, sc.gap_open, sc.gap_extend
        )
        assert hits[0][0] == 5
        assert hits[0][1].score == scores[5]
        assert [h[1].score for h in hits] == sorted(
            scores, reverse=True
        )[:3]


class TestNativeEnvelope:
    """Regressions for the native fill's table orientation and int8 range."""

    def test_asymmetric_matrix(self, rng):
        """table[q, d] orientation: an asymmetric matrix must score
        identically through native and NumPy paths (round-2 review bug:
        the native kernel read table[d][q])."""
        import seqalign.ops.traceback as tbm
        from seqalign.ops.oracle import sw_score_single

        for trial in range(10):
            table = rng.integers(-8, 12, (32, 32)).astype(np.int32)
            q = rng.integers(1, 27, int(rng.integers(5, 30)))
            d = rng.integers(1, 27, int(rng.integers(5, 60)))
            want = sw_score_single(q, d, table, -2, -1)
            aln = sw_traceback(q, d, table, -2, -1)
            assert aln.score == want, trial
            check_alignment_consistent(aln, q, d, table, -2, -1)

    def test_large_scores_skip_native(self, rng):
        """Scores beyond int8 (allowed up to the engines' 256 envelope)
        must not be wrapped by the native int8 cast."""
        import seqalign.ops.traceback as tbm
        from seqalign.ops.oracle import sw_score_single

        table = np.full((32, 32), -5, dtype=np.int32)
        np.fill_diagonal(table, 200)  # > int8 max, < bf16-exact 256
        assert tbm._native_for(table) is None
        q = rng.integers(1, 27, 12)
        d = np.concatenate([rng.integers(1, 27, 9), q, rng.integers(1, 27, 7)])
        want = sw_score_single(q, d, table, -2, -1)
        aln = sw_traceback(q, d, table, -2, -1)
        assert aln.score == want >= 200 * 12 - 100


class TestLocalizedTraceback:
    """The linear-space recompute path for huge pairs (ends + rectangle)."""

    @pytest.mark.parametrize("trial", range(6))
    def test_matches_direct(self, rng, blosum62, monkeypatch, trial):
        import seqalign.ops.traceback as tbm

        sc = blosum62
        q = encode(random_protein(rng, int(rng.integers(10, 60))))
        d = encode(random_protein(rng, int(rng.integers(10, 400))))
        direct = tbm._direct_traceback(
            q, d, sc.table, sc.gap_open, sc.gap_extend
        )
        # Force every pair through the localized path.
        monkeypatch.setattr(tbm, "_DIRECT_CELLS", 0)
        loc = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        assert loc.score == direct.score
        check_alignment_consistent(
            loc, q, d, sc.table, sc.gap_open, sc.gap_extend
        )

    def test_no_cliff(self, rng, blosum62, monkeypatch):
        """Pairs beyond the MAX_CELLS full-matrix cap now align in linear
        space (the round-1 3 GB cliff, VERDICT item): localization bounds
        the rectangle, and Myers-Miller handles whole-extent rectangles.
        Thresholds are scaled down so the test runs in seconds; the
        routing and algorithms are exactly the production ones."""
        import seqalign.ops.traceback as tbm

        sc = blosum62
        monkeypatch.setattr(tbm, "_DIRECT_CELLS", 1 << 16)
        monkeypatch.setattr(tbm, "MAX_CELLS", 1 << 18)
        # With the reference's cheap gaps (-2/-1) random pairs this size
        # have whole-extent optimal alignments -> rectangle ~= full matrix
        # > MAX_CELLS -> the Myers-Miller path.
        q = encode(random_protein(rng, 900))
        d = encode(random_protein(rng, 1000))
        assert (len(q) + 1) * (len(d) + 1) > tbm.MAX_CELLS
        aln = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        check_alignment_consistent(
            aln, q, d, sc.table, sc.gap_open, sc.gap_extend
        )
        # Same score as the (unpatched) full-matrix fill.
        monkeypatch.setattr(tbm, "MAX_CELLS", 1 << 30)
        direct = tbm._direct_traceback(
            q, d, sc.table, sc.gap_open, sc.gap_extend
        )
        assert aln.score == direct.score

    @pytest.mark.parametrize("trial", range(4))
    def test_myers_miller_matches_direct(self, rng, blosum62, monkeypatch, trial):
        """Force the Myers-Miller tier on modest pairs; bit-equal scores."""
        import seqalign.ops.traceback as tbm

        sc = blosum62
        monkeypatch.setattr(tbm, "_DIRECT_CELLS", 1 << 10)
        monkeypatch.setattr(tbm, "MAX_CELLS", 1 << 12)
        monkeypatch.setattr(tbm, "_MM_BASE_CELLS", 1 << 8)
        q = encode(random_protein(rng, int(rng.integers(40, 200))))
        d = encode(random_protein(rng, int(rng.integers(40, 300))))
        aln = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        check_alignment_consistent(
            aln, q, d, sc.table, sc.gap_open, sc.gap_extend
        )
        monkeypatch.setattr(tbm, "MAX_CELLS", 1 << 30)
        direct = tbm._direct_traceback(
            q, d, sc.table, sc.gap_open, sc.gap_extend
        )
        assert aln.score == direct.score

    def test_numpy_fallback_matches(self, rng, blosum62, monkeypatch):
        import seqalign.ops.traceback as tbm

        if not tbm.native_available():
            pytest.skip("native library not built")
        sc = blosum62
        q = encode(random_protein(rng, 40))
        d = encode(random_protein(rng, 200))
        monkeypatch.setattr(tbm, "_DIRECT_CELLS", 0)
        a = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        monkeypatch.setattr(tbm, "_lib", None)
        monkeypatch.setattr(tbm, "_tried", True)  # no native library
        b = sw_traceback(q, d, sc.table, sc.gap_open, sc.gap_extend)
        assert (a.score, a.query_start, a.db_start, a.cigar) == (
            b.score, b.query_start, b.db_start, b.cigar
        )


def test_align_pair(blosum62):
    from seqalign.ops.traceback import align_pair

    aln = align_pair("HEAGAWGHEE", "PAWHEAE", blosum62)
    assert aln.score > 0
    assert len(aln.query_aligned) == len(aln.db_aligned)
