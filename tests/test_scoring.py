"""Tests for the scoring layer: alphabet codec, matrices, scoring model."""

import gzip

import numpy as np
import pytest

from seqalign.models import (
    ALPHABET_SIZE,
    PAD_INDEX,
    AlphabetError,
    ScoringModel,
    decode,
    encode,
    index_to_letter,
    letter_to_index,
    load_builtin,
    load_matrix_file,
    load_substitution_matrix,
    sw_default_scoring,
    write_matrix_file,
)


class TestAlphabet:
    def test_letters(self):
        assert letter_to_index("a") == 1
        assert letter_to_index("A") == 1
        assert letter_to_index("z") == 26
        assert letter_to_index("Z") == 26
        assert letter_to_index("*") == PAD_INDEX == 31

    def test_roundtrip(self):
        for i in list(range(1, 27)) + [31]:
            assert letter_to_index(index_to_letter(i)) == i

    def test_illegal(self):
        for c in ["1", " ", "-", "@", "\n"]:
            with pytest.raises(AlphabetError):
                letter_to_index(c)
        with pytest.raises(AlphabetError):
            encode("AC-GT")

    def test_encode_decode(self):
        idx = encode("AcDeF*")
        assert idx.tolist() == [1, 3, 4, 5, 6, 31]
        assert decode(idx) == "ACDEF*"


class TestBuiltinMatrices:
    @pytest.mark.parametrize(
        "name,a,b,score",
        [
            ("BLOSUM62", "A", "A", 4),
            ("BLOSUM62", "W", "W", 11),
            ("BLOSUM62", "A", "R", -1),
            ("BLOSUM62", "A", "*", -4),
            ("BLOSUM62", "*", "*", 1),
            ("BLOSUM45", "A", "A", 5),
            ("BLOSUM45", "W", "W", 15),
            ("PAM250", "A", "A", 2),
            ("PAM250", "W", "W", 17),
            ("PAM250", "C", "W", -8),
        ],
    )
    def test_known_values(self, name, a, b, score):
        sc = load_builtin(name, ScoringModel(gap_open=-2, gap_extend=-1))
        assert sc.table[letter_to_index(a), letter_to_index(b)] == score

    def test_symmetry(self):
        for name in ("BLOSUM45", "BLOSUM62", "PAM250"):
            sc = load_builtin(name, ScoringModel(gap_open=-2, gap_extend=-1))
            assert (sc.table == sc.table.T).all(), name

    def test_padding_safety(self):
        for name in ("BLOSUM45", "BLOSUM62", "PAM250"):
            sc = load_builtin(
                name,
                ScoringModel(
                    gap_open=-2, gap_extend=-1, use_match_mismatch=False
                ),
            )
            from seqalign.models import encode

            # '*'-free queries are padding-safe ...
            assert sc.padding_safe_for_query(encode("ACDEFGHIKLMNPQRSTVWYXBZ"))
            # ... but '*'-bearing queries are not (s('*','*') = +1).
            assert not sc.padding_safe_for_query(encode("AC*DE"))

    def test_reference_matrix_files_if_present(self, tmp_path):
        """Cross-check builtin values against the reference's data files."""
        import os

        ref = "/root/reference/scoring"
        if not os.path.isdir(ref):
            pytest.skip("reference snapshot not available")
        for name in ("BLOSUM45", "BLOSUM62", "PAM250"):
            ours = load_builtin(
                name, ScoringModel(gap_open=-2, gap_extend=-1)
            )
            theirs = load_matrix_file(
                f"{ref}/{name}.txt", ScoringModel(gap_open=-2, gap_extend=-1)
            )
            assert (ours.table == theirs.table).all(), name
            assert (ours.defined == theirs.defined).all(), name


class TestMatrixFileLoader:
    def test_whitespace_roundtrip(self, tmp_path):
        path = tmp_path / "b62.txt"
        write_matrix_file(str(path), "BLOSUM62")
        sc = load_matrix_file(
            str(path), ScoringModel(gap_open=-2, gap_extend=-1)
        )
        ref = load_builtin("BLOSUM62", ScoringModel(gap_open=-2, gap_extend=-1))
        assert (sc.table == ref.table).all()

    def test_gzip(self, tmp_path):
        plain = tmp_path / "m.txt"
        write_matrix_file(str(plain), "PAM250")
        gz = tmp_path / "m.txt.gz"
        gz.write_bytes(gzip.compress(plain.read_bytes()))
        sc = load_matrix_file(str(gz), ScoringModel(gap_open=-2, gap_extend=-1))
        ref = load_builtin("PAM250", ScoringModel(gap_open=-2, gap_extend=-1))
        assert (sc.table == ref.table).all()

    def test_separator_format(self, tmp_path):
        path = tmp_path / "sep.txt"
        path.write_text(",A,C,G\nA,1,-2,-3\nC,-2,2,-4\nG,-3,-4,3\n")
        sc = load_matrix_file(
            str(path), ScoringModel(gap_open=-2, gap_extend=-1)
        )
        assert sc.table[letter_to_index("A"), letter_to_index("A")] == 1
        assert sc.table[letter_to_index("C"), letter_to_index("G")] == -4
        assert sc.table[letter_to_index("G"), letter_to_index("G")] == 3

    def test_comments_and_blanks_skipped(self, tmp_path):
        path = tmp_path / "m.txt"
        path.write_text(
            "# a comment\n\n   \n   A  C\nA  5 -1 \n# mid comment\nC -1  5\n"
        )
        sc = load_matrix_file(
            str(path), ScoringModel(gap_open=-2, gap_extend=-1)
        )
        assert sc.table[1, 1] == 5
        assert sc.table[1, 3] == -1

    def test_bad_separator(self, tmp_path):
        path = tmp_path / "bad.txt"
        path.write_text("1A1C\nA,1,2\n")
        from seqalign.models import MatrixFormatError

        with pytest.raises(MatrixFormatError):
            load_matrix_file(
                str(path), ScoringModel(gap_open=-2, gap_extend=-1)
            )

    def test_score_out_of_int8(self, tmp_path):
        path = tmp_path / "big.txt"
        path.write_text("   A  C\nA  500 -1 \nC -1  5\n")
        with pytest.raises(ValueError):
            load_matrix_file(
                str(path), ScoringModel(gap_open=-2, gap_extend=-1)
            )

    def test_builtin_by_name(self):
        sc = load_substitution_matrix(
            "blosum62", ScoringModel(gap_open=-2, gap_extend=-1)
        )
        assert sc.table[1, 1] == 4


class TestScoringModel:
    def test_sw_defaults(self):
        sc = sw_default_scoring()
        assert (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend) == (
            2,
            -2,
            -2,
            -1,
        )
        assert sc.gap_open_total == -3
        # match/mismatch fills the whole table
        assert sc.table[1, 1] == 2
        assert sc.table[1, 2] == -2

    def test_query_indices_x_replacement(self, blosum62):
        # 'O' (index 15) is not in the BLOSUM alphabet -> replaced with 'X'.
        idx = blosum62.query_indices("AOC")
        assert idx.tolist() == [
            letter_to_index("A"),
            letter_to_index("X"),
            letter_to_index("C"),
        ]

    def test_query_indices_no_replacement_in_mm_mode(self):
        sc = sw_default_scoring()
        idx = sc.query_indices("AOC")
        assert idx.tolist() == [1, 15, 3]
