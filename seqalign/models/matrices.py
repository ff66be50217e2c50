"""Substitution-matrix loading: built-in matrices and NCBI-format files.

File-format parity with the reference loader
(``src/alignment_scoring_load.c:57-215``): two on-disk formats are accepted,
optionally gzip-compressed —

1. **Whitespace-separated** (standard NCBI): a header row of column
   characters, then one row per character: ``<char> <int> <int> ...``.
   ``#`` lines and blank lines are skipped.
2. **Single-character separator**: the first non-comment line's first byte is
   the separator ``sep`` (must not be a digit or ``-``); the header is
   ``sep c sep c ...`` and each row is ``<char>(<sep><int>)*``.

Errors match the reference's fatal conditions (bad separator, missing
numbers, too many columns, out-of-int8-range scores).
"""

from __future__ import annotations

import gzip
import io

from .alphabet import AlphabetError  # noqa: F401  (re-export convenience)
from ._matrix_data import BUILTIN_MATRICES
from .scoring import ScoringModel


class MatrixFormatError(ValueError):
    """Raised on malformed substitution-matrix files."""


def _open_maybe_gzip(path: str) -> io.TextIOBase:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii")
    return io.TextIOWrapper(f, encoding="ascii")


def load_matrix_file(path: str, scoring: ScoringModel) -> ScoringModel:
    """Load substitution scores from a matrix file into ``scoring``.

    Mirrors ``align_scoring_load_matrix``: populates the table via
    ``add_mutation`` per (row_char, col_char) pair. Does not change
    ``use_match_mismatch`` — the CLI layer decides that (reference
    ``src/alignment_cmdline.c:294-297``).
    """
    with _open_maybe_gzip(path) as fh:
        lines = fh.read().split("\n")

    # Find the header line: first non-empty, non-comment, non-whitespace line.
    it = iter(enumerate(lines))
    header = None
    for line_num, line in it:
        if line and line[0] != "#" and line.strip():
            header = line
            break
    if header is None:
        raise MatrixFormatError(f"substitution matrix: Empty file: {path}")
    if len(header.strip()) < 2:
        raise MatrixFormatError(
            f"substitution matrix: Too few column headings: {path}"
        )

    sep = header[0]
    if sep.isdigit() or sep == "-":
        raise MatrixFormatError(
            "substitution pairs: Numbers (0-9) and dashes (-) do not make "
            f"good separators: {path}"
        )

    if sep.isspace():
        columns = header.split()
        for line_num, line in it:
            if not line.strip() or line.lstrip()[0] == "#":
                continue
            parts = line.split()
            from_char = parts[0]
            if len(parts) - 1 < len(columns):
                raise MatrixFormatError(
                    f"substitution matrix: Missing number value on line "
                    f"{line_num}: {path}"
                )
            if len(parts) - 1 > len(columns):
                raise MatrixFormatError(
                    f"substitution matrix: Too many columns on row "
                    f"{line_num}: {path}"
                )
            for to_char, tok in zip(columns, parts[1:]):
                try:
                    score = int(tok)
                except ValueError as e:
                    raise MatrixFormatError(
                        f"substitution matrix: Missing number value on line "
                        f"{line_num}: {path}"
                    ) from e
                scoring.add_mutation(from_char, to_char, score)
    else:
        # Single-character-separator format: header 'sep c sep c ...'.
        columns = []
        for i in range(0, len(header), 2):
            if header[i] != sep:
                raise MatrixFormatError(
                    f"substitution matrix: Separator missing from line: {path}"
                )
            if i + 1 >= len(header):
                break
            columns.append(header[i + 1])
        for line_num, line in it:
            if not line.strip() or line[0] == "#":
                continue
            from_char = line[0]
            pos = 1
            col = 0
            while pos < len(line):
                if col >= len(columns):
                    raise MatrixFormatError(
                        f"substitution matrix: Too many columns on row "
                        f"{line_num}: {path}"
                    )
                if line[pos] != sep:
                    raise MatrixFormatError(
                        f"substitution matrix: Separator missing from line "
                        f"{line_num}: {path}"
                    )
                pos += 1
                end = pos
                if end < len(line) and line[end] in "+-":
                    end += 1
                while end < len(line) and line[end].isdigit():
                    end += 1
                if end == pos or not line[pos:end].lstrip("+-"):
                    raise MatrixFormatError(
                        f"substitution matrix: Missing number value on line "
                        f"{line_num}: {path}"
                    )
                scoring.add_mutation(from_char, columns[col], int(line[pos:end]))
                col += 1
                pos = end
    return scoring


def load_builtin(name: str, scoring: ScoringModel) -> ScoringModel:
    """Load a built-in matrix (BLOSUM45, BLOSUM62, PAM250) by name."""
    key = name.upper()
    if key not in BUILTIN_MATRICES:
        raise KeyError(
            f"unknown builtin matrix {name!r}; have {sorted(BUILTIN_MATRICES)}"
        )
    alphabet, rows = BUILTIN_MATRICES[key]
    for a, row in zip(alphabet, rows):
        for b, score in zip(alphabet, row):
            scoring.add_mutation(a, b, score)
    return scoring


def load_substitution_matrix(spec: str, scoring: ScoringModel) -> ScoringModel:
    """Load from a builtin name or a file path (gzip ok)."""
    if spec.upper() in BUILTIN_MATRICES:
        return load_builtin(spec, scoring)
    return load_matrix_file(spec, scoring)


def write_matrix_file(path: str, name: str) -> None:
    """Write a built-in matrix in NCBI whitespace format (for tests/tools)."""
    alphabet, rows = BUILTIN_MATRICES[name.upper()]
    with open(path, "w") as fh:
        fh.write("# " + name.upper() + " (seqalign builtin export)\n")
        fh.write("   " + "  ".join(alphabet) + "\n")
        for a, row in zip(alphabet, rows):
            fh.write(a + " " + " ".join(f"{v:2d}" for v in row) + " \n")
