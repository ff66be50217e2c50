"""Differential tests: XLA engines vs the NumPy oracle vs hand results.

Mirrors the reference's oracle-diff strategy (SURVEY.md §4) with our own
fixtures: every engine must produce *identical integer scores*.
"""

import numpy as np
import pytest

from seqalign.models import PAD_INDEX, ScoringModel, encode, sw_default_scoring
from seqalign.ops.oracle import sw_score_batch, sw_score_single
from seqalign.ops.swa_xla import make_profile, sw_scan, sw_wavefront

from conftest import random_protein


def pack_db(seqs, pad_to=None):
    """Pack encoded sequences (list of 1-D arrays) into (Lb, B) int32."""
    lb = max(len(s) for s in seqs)
    if pad_to is not None:
        lb = max(lb, pad_to)
    out = np.full((lb, len(seqs)), PAD_INDEX, dtype=np.int32)
    for b, s in enumerate(seqs):
        out[: len(s), b] = s
    return out


class TestOracleHandChecked:
    def test_exact_match(self):
        """Identical sequences, match=2: score = 2 * len."""
        sc = sw_default_scoring()
        q = encode("ACGT")
        assert sw_score_single(q, q, sc.table, sc.gap_open, sc.gap_extend) == 8

    def test_known_small_alignment(self):
        """Classic textbook case, hand-checked.

        q=AGC vs d=AC, match=2 mismatch=-2 gap_open=-2 gap_extend=-1:
        best local alignment is A-C/AGC with one length-1 gap
        (2+2-3 = 1) vs AG/AC (2-2=0) vs single char (2): score 2.
        Align 'AC' to 'AGC' skipping G costs open+extend=-3: 2+2-3=1 < 2.
        """
        sc = sw_default_scoring()
        q, d = encode("AGC"), encode("AC")
        assert sw_score_single(q, d, sc.table, sc.gap_open, sc.gap_extend) == 2

    def test_gap_vs_mismatch_tradeoff(self):
        """q=AAGGAA vs d=AAAA: gap of 2 (=-2-2=-4... open -2, 2 extends -2)

        Aligning AA--AA: 4 matches (8) + gap_open+2*extend (-4) = 4.
        Aligning AAGGAA vs AAAA with 2 mismatches: 2+2-2-2 = 0 + ...
        local best = 4.
        """
        sc = sw_default_scoring()
        q, d = encode("AAGGAA"), encode("AAAA")
        assert sw_score_single(q, d, sc.table, sc.gap_open, sc.gap_extend) == 4

    def test_empty_overlap_floor_zero(self):
        """All-mismatch: local alignment floor is single best cell or 0."""
        sc = sw_default_scoring()
        q, d = encode("AAAA"), encode("TTTT")
        assert sw_score_single(q, d, sc.table, sc.gap_open, sc.gap_extend) == 0

    def test_blosum62_pair(self, blosum62):
        """HEAGAWGHEE vs PAWHEAE under BLOSUM62 is a standard worked example.

        With gap open -10 extend -1 (classic EMBOSS water defaults minus
        rounding) we instead use our formulation: verified against an
        independent hand DP for gap_open=-2 gap_extend=-1.
        """
        q, d = encode("HEAGAWGHEE"), encode("PAWHEAE")
        got = sw_score_single(q, d, blosum62.table, -2, -1)
        # Independent full-matrix DP (classic Gotoh, no linear-space tricks).
        ref = full_matrix_gotoh(q, d, blosum62.table, -2, -1)
        assert got == ref


def full_matrix_gotoh(q, d, table, gap_open, gap_extend):
    """Independent O(n*m) full-matrix implementation (different formulation).

    Uses the standard Gotoh recurrence (H = max(0, H_diag + s, E, F);
    E/F opened from H) which yields the same optimal local score as the
    reference's folded variant for affine penalties with go<=ge<=0.
    """
    go = gap_open + gap_extend
    ge = gap_extend
    lq, lb = len(q), len(d)
    NEG = -(10**9)
    H = np.zeros((lb + 1, lq + 1), dtype=np.int64)
    E = np.full((lb + 1, lq + 1), NEG, dtype=np.int64)  # gap in query (vert)
    F = np.full((lb + 1, lq + 1), NEG, dtype=np.int64)  # gap in db (horiz)
    best = 0
    for j in range(1, lb + 1):
        for i in range(1, lq + 1):
            s = int(table[q[i - 1], d[j - 1]])
            E[j][i] = max(H[j - 1][i] + go, E[j - 1][i] + ge)
            F[j][i] = max(H[j][i - 1] + go, F[j][i - 1] + ge)
            H[j][i] = max(0, H[j - 1][i - 1] + s, E[j][i], F[j][i])
            best = max(best, H[j][i])
    return int(best)


class TestOracleVsIndependentDP:
    """The folded-variant oracle must agree with classic Gotoh."""

    @pytest.mark.parametrize("trial", range(10))
    def test_random(self, rng, blosum62, trial):
        lq = int(rng.integers(1, 30))
        lb = int(rng.integers(1, 40))
        q = encode(random_protein(rng, lq))
        d = encode(random_protein(rng, lb))
        for go_, ge_ in [(-2, -1), (-10, -1), (-4, -4), (0, -1)]:
            ours = sw_score_single(q, d, blosum62.table, go_, ge_)
            ref = full_matrix_gotoh(q, d, blosum62.table, go_, ge_)
            assert ours == ref, (trial, go_, ge_)


class TestXlaEnginesVsOracle:
    @pytest.mark.parametrize("engine", [sw_scan, sw_wavefront])
    def test_batch_random(self, rng, blosum62, engine):
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 25))
        seqs = [
            encode(random_protein(rng, int(rng.integers(1, 50))))
            for _ in range(17)
        ]
        db = pack_db(seqs)
        prof = make_profile(sc.table, q)
        got = np.asarray(
            engine(prof, db, sc.gap_open_total, sc.gap_extend)
        )
        want = sw_score_batch(q, seqs, sc.table, sc.gap_open, sc.gap_extend)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("engine", [sw_scan, sw_wavefront])
    def test_padding_invariance(self, rng, blosum62, engine):
        """Scores must not change when the db batch is padded longer."""
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 12))
        seqs = [encode(random_protein(rng, n)) for n in (5, 9, 13)]
        prof = make_profile(sc.table, q)
        a = np.asarray(
            engine(prof, pack_db(seqs), sc.gap_open_total, sc.gap_extend)
        )
        b = np.asarray(
            engine(
                prof, pack_db(seqs, pad_to=40), sc.gap_open_total, sc.gap_extend
            )
        )
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("engine", [sw_scan, sw_wavefront])
    def test_match_mismatch_mode(self, rng, engine):
        sc = sw_default_scoring()
        q = sc.query_indices("MKTAYIAKQR")
        seqs = [encode("MKTAYIAKQR"), encode("MKTA"), encode("QQQQQQ")]
        db = pack_db(seqs)
        prof = make_profile(sc.table, q)
        got = np.asarray(
            engine(prof, db, sc.gap_open_total, sc.gap_extend)
        )
        want = sw_score_batch(q, seqs, sc.table, sc.gap_open, sc.gap_extend)
        np.testing.assert_array_equal(got, want)
        assert got[0] == 20  # exact match, match=2, len 10

    @pytest.mark.parametrize("engine", [sw_scan, sw_wavefront])
    def test_pam250(self, rng, pam250, engine):
        sc = pam250
        q = sc.query_indices(random_protein(rng, 33))
        seqs = [
            encode(random_protein(rng, int(rng.integers(2, 64))))
            for _ in range(9)
        ]
        db = pack_db(seqs)
        prof = make_profile(sc.table, q)
        got = np.asarray(engine(prof, db, sc.gap_open_total, sc.gap_extend))
        want = sw_score_batch(q, seqs, sc.table, sc.gap_open, sc.gap_extend)
        np.testing.assert_array_equal(got, want)

    def test_engines_agree_large(self, rng, blosum62):
        sc = blosum62
        q = sc.query_indices(random_protein(rng, 64))
        seqs = [
            encode(random_protein(rng, int(rng.integers(10, 128))))
            for _ in range(32)
        ]
        db = pack_db(seqs)
        prof = make_profile(sc.table, q)
        a = np.asarray(sw_scan(prof, db, sc.gap_open_total, sc.gap_extend))
        b = np.asarray(
            sw_wavefront(prof, db, sc.gap_open_total, sc.gap_extend)
        )
        np.testing.assert_array_equal(a, b)
