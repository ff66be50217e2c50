"""ctypes bindings for the native fastio library (see native/fastio.cc).

Provides fast parse+encode of FASTA/FASTQ files and native lane-batch
packing. The library is built from ``native/fastio.cc`` at first use; where
it cannot be built (no C++ compiler or zlib), a warning says so and the
pure-Python implementations serve instead.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from .native_build import host_library

    path = host_library("fastio")
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.fastio_parse.restype = ctypes.c_void_p
    lib.fastio_parse.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fastio_fetch.restype = None
    lib.fastio_fetch.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.fastio_free.restype = None
    lib.fastio_free.argtypes = [ctypes.c_void_p]
    lib.fastio_open.restype = ctypes.c_void_p
    lib.fastio_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.fastio_read_chunk.restype = ctypes.c_void_p
    lib.fastio_read_chunk.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.fastio_fetch_chunk.restype = None
    lib.fastio_fetch_chunk.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.fastio_close.restype = None
    lib.fastio_close.argtypes = [ctypes.c_void_p]
    lib.fastio_pack.restype = None
    lib.fastio_pack.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class EncodedDatabase:
    """A fully parsed+encoded database in flat-buffer form.

    ``seq`` holds every record's alphabet indices concatenated;
    record ``i`` spans ``seq[offsets[i]:offsets[i+1]]``.

    ``names`` may be passed as a list, or as the parser's raw
    ``'\\n'``-terminated blob — splitting 10^5+ names into Python strings
    costs more than the native parse itself, and most searches only ever
    look up the few names they print, so the split happens lazily on
    first access.
    """

    def __init__(
        self,
        seq: np.ndarray,  # (total_residues,) int8
        offsets: np.ndarray,  # (n+1,) int64
        names: list[str] | str,  # list, or raw '\n'-terminated blob
    ):
        self.seq = seq
        self.offsets = offsets
        self._names = names

    @property
    def names(self) -> list[str]:
        if not isinstance(self._names, list):
            self._names = self._names.split("\n")[:-1] if self._names else []
        return self._names

    @property
    def n(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def record(self, i: int) -> np.ndarray:
        return self.seq[self.offsets[i] : self.offsets[i + 1]]


def parse_file(path: str) -> EncodedDatabase:
    """Parse+encode a FASTA/FASTQ file (gzip ok), native if available."""
    lib = _load()
    if lib is None:
        return _parse_file_python(path)
    n = ctypes.c_int64()
    residues = ctypes.c_int64()
    names_bytes = ctypes.c_int64()
    err = ctypes.c_int()
    handle = lib.fastio_parse(
        path.encode(), ctypes.byref(n), ctypes.byref(residues),
        ctypes.byref(names_bytes), ctypes.byref(err),
    )
    if not handle:
        if err.value == -1:
            raise OSError(f"couldn't read {path}")
        if err.value == -2:
            from ..models.alphabet import AlphabetError

            raise AlphabetError(
                f"illegal character for the substitution matrix in {path}"
            )
        raise ValueError(f"unrecognized sequence file format: {path}")
    try:
        seq = np.empty(residues.value, dtype=np.int8)
        offsets = np.empty(n.value + 1, dtype=np.int64)
        names_buf = ctypes.create_string_buffer(max(names_bytes.value, 1))
        lib.fastio_fetch(
            handle,
            seq.ctypes.data_as(ctypes.c_void_p),
            offsets.ctypes.data_as(ctypes.c_void_p),
            names_buf,
        )
    finally:
        lib.fastio_free(handle)
    raw_names = names_buf.raw[: names_bytes.value].decode(
        "ascii", errors="replace"
    )
    return EncodedDatabase(seq=seq, offsets=offsets, names=raw_names)


def _parse_file_python(path: str) -> EncodedDatabase:
    from ..models.alphabet import encode
    from .fasta import read_fasta

    seqs, names, offsets = [], [], [0]
    total = 0
    for rec in read_fasta(path):
        e = encode(rec.seq)
        seqs.append(e)
        names.append(rec.name)
        total += len(e)
        offsets.append(total)
    seq = (
        np.concatenate(seqs).astype(np.int8)
        if seqs
        else np.zeros(0, dtype=np.int8)
    )
    return EncodedDatabase(
        seq=seq, offsets=np.asarray(offsets, dtype=np.int64), names=names
    )


#: Encoded-database cache format (see save_cache/load_cache):
#:   magic(8) | n | residues | names_bytes | src_size | src_mtime_ns   (int64 LE)
#:   offsets[(n+1) int64] | names blob ('\n'-terminated) | seq[residues int8]
#: The seq payload sits LAST so load_cache can expose it as a zero-copy
#: np.memmap view — a repeat search touches only the pages the kernel
#: packer actually reads, so "load" is O(header+offsets), not O(database).
_CACHE_MAGIC = b"SQCDBv1\0"
_CACHE_HEADER = 8 + 5 * 8


def save_cache(
    db: EncodedDatabase, cache_path: str, src_path: str | None = None
) -> None:
    """Write ``db`` to ``cache_path`` in the .sqc binary format.

    ``src_path`` (the FASTA file the db was parsed from) stamps the cache
    with the source's (size, mtime_ns) so load_cache can detect staleness.
    The write is atomic (tmp + rename): a crashed writer never leaves a
    half-cache that a later load would trust.
    """
    names = db._names
    if isinstance(names, list):
        blob = "".join(f"{s}\n" for s in names)
    else:
        blob = names
    names_b = blob.encode("utf-8", errors="replace")
    src_size = src_mtime = 0
    if src_path is not None and os.path.isfile(src_path):
        st = os.stat(src_path)
        src_size, src_mtime = st.st_size, st.st_mtime_ns
    head = np.array(
        [db.n, len(db.seq), len(names_b), src_size, src_mtime],
        dtype="<i8",
    )
    # Private mkstemp tmp (not a shared fixed name): concurrent writers
    # each build their own file and the LAST os.replace wins whole, so no
    # interleaved-write torn cache can ever be published.
    import tempfile

    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(cache_path)), suffix=".sqctmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_CACHE_MAGIC)
            head.tofile(f)
            np.ascontiguousarray(db.offsets, dtype="<i8").tofile(f)
            f.write(names_b)
            np.ascontiguousarray(db.seq, dtype=np.int8).tofile(f)
        os.replace(tmp, cache_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_cache(
    cache_path: str, src_path: str | None = None
) -> EncodedDatabase | None:
    """Load a .sqc cache; None if absent, unreadable, or stale.

    Staleness: when ``src_path`` names an existing file, its current
    (size, mtime_ns) must match the stamp written at save time. When the
    source is gone (a deployment shipping only the cache), the cache is
    trusted as-is.

    The residue buffer is returned as a read-only np.memmap view: pages
    fault in on first touch by the stream packer, so loading a multi-GB
    database costs milliseconds.
    """
    try:
        file_size = os.path.getsize(cache_path)
        with open(cache_path, "rb") as f:
            if f.read(8) != _CACHE_MAGIC:
                return None
            head = np.fromfile(f, dtype="<i8", count=5)
            if head.size != 5:
                return None
            n, residues, names_bytes, src_size, src_mtime = (
                int(x) for x in head
            )
            # Bound every header field by the file's actual size BEFORE
            # allocating from it: a corrupt header must mean "rebuild"
            # (return None), never a giant np allocation or a crash.
            if (
                n < 0 or residues < 0 or names_bytes < 0
                or _CACHE_HEADER + 8 * (n + 1) + names_bytes + residues
                != file_size
            ):
                return None
            offsets = np.fromfile(f, dtype="<i8", count=n + 1)
            if offsets.size != n + 1:
                return None
            # The native packer dereferences offsets raw; reject any
            # out-of-range or non-monotonic table up front.
            if (
                offsets[0] != 0
                or offsets[-1] != residues
                or (np.diff(offsets) < 0).any()
            ):
                return None
            names_blob = f.read(names_bytes)
            if len(names_blob) != names_bytes:
                return None
            seq_off = f.tell()
        if src_path is not None and os.path.isfile(src_path):
            st = os.stat(src_path)
            if (st.st_size, st.st_mtime_ns) != (src_size, src_mtime):
                return None  # source changed since the cache was written
        seq = (
            np.memmap(
                cache_path, dtype=np.int8, mode="r", offset=seq_off,
                shape=(residues,),
            )
            if residues
            else np.zeros(0, dtype=np.int8)
        )
        return EncodedDatabase(
            seq=seq,
            offsets=offsets,
            names=names_blob.decode("utf-8", errors="replace"),
        )
    except (OSError, ValueError, MemoryError, OverflowError):
        return None  # unreadable/corrupt cache: caller rebuilds


def parse_file_cached(path: str, cache: str | None) -> EncodedDatabase:
    """parse_file with a persistent encoded cache.

    ``cache`` is the .sqc path ("auto" = sidecar ``<path>.sqc``; None =
    plain parse). A fresh cache is loaded zero-copy; otherwise the FASTA
    is parsed and the cache (re)written. If the FASTA itself is missing
    but a cache exists, the cache serves alone — a production deployment
    can ship only the .sqc.
    """
    if cache is None:
        return parse_file(path)
    cache_path = path + ".sqc" if cache == "auto" else cache
    db = load_cache(cache_path, src_path=path)
    if db is not None:
        return db
    db = parse_file(path)
    try:
        save_cache(db, cache_path, src_path=path)
    except OSError as e:
        import sys

        print(
            f"Warning: couldn't write database cache {cache_path}: {e}",
            file=sys.stderr,
        )
    return db


def iter_cache_chunks(db: EncodedDatabase, chunk_records: int):
    """Yield <= chunk_records-record EncodedDatabase views of ``db``.

    With a load_cache database the views stay zero-copy slices of the
    mmap, so a streaming search over a cache touches each residue page
    once and the OS evicts behind it — bounded memory without the FASTA
    re-read that stream_chunks needs.
    """
    for s in range(0, db.n, chunk_records):
        e = min(db.n, s + chunk_records)
        yield EncodedDatabase(
            seq=db.seq[db.offsets[s] : db.offsets[e]],
            offsets=db.offsets[s : e + 1] - db.offsets[s],
            names=db.names[s:e],
        )


def _raise_parse_error(err: int, path: str):
    if err == -1:
        raise OSError(f"couldn't read {path}")
    if err == -2:
        from ..models.alphabet import AlphabetError

        raise AlphabetError(
            f"illegal character for the substitution matrix in {path}"
        )
    raise ValueError(f"unrecognized sequence file format: {path}")


def stream_chunks(path: str, chunk_records: int):
    """Yield EncodedDatabase chunks of <= chunk_records records.

    Bounded-memory ingest at native parse speed (the whole-file
    ``parse_file`` is O(database) RAM). Falls back to the pure-Python
    reader when the native library is absent or the input is not a
    regular file (e.g. '-').
    """
    lib = _load()
    if lib is None or path == "-" or not os.path.isfile(path):
        yield from _stream_chunks_python(path, chunk_records)
        return
    err = ctypes.c_int()
    handle = lib.fastio_open(path.encode(), ctypes.byref(err))
    if not handle:
        raise OSError(f"couldn't read {path}")
    try:
        n = ctypes.c_int64()
        residues = ctypes.c_int64()
        names_bytes = ctypes.c_int64()
        while True:
            chunk = lib.fastio_read_chunk(
                handle, chunk_records, ctypes.byref(n),
                ctypes.byref(residues), ctypes.byref(names_bytes),
                ctypes.byref(err),
            )
            if not chunk:
                if err.value != 0:
                    _raise_parse_error(err.value, path)
                return  # clean EOF
            seq = np.empty(residues.value, dtype=np.int8)
            offsets = np.empty(n.value + 1, dtype=np.int64)
            names_buf = ctypes.create_string_buffer(
                max(names_bytes.value, 1)
            )
            lib.fastio_fetch_chunk(
                chunk,
                seq.ctypes.data_as(ctypes.c_void_p),
                offsets.ctypes.data_as(ctypes.c_void_p),
                names_buf,
            )
            raw_names = names_buf.raw[: names_bytes.value].decode(
                "ascii", errors="replace"
            )
            yield EncodedDatabase(seq=seq, offsets=offsets, names=raw_names)
    finally:
        lib.fastio_close(handle)


def _stream_chunks_python(path: str, chunk_records: int):
    from ..models.alphabet import encode
    from .fasta import read_fasta

    def build(records):
        seqs = [encode(r.seq) for r in records]
        offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        total = 0
        for i, e in enumerate(seqs):
            total += len(e)
            offsets[i + 1] = total
        seq = (
            np.concatenate(seqs).astype(np.int8)
            if seqs
            else np.zeros(0, dtype=np.int8)
        )
        return EncodedDatabase(
            seq=seq, offsets=offsets, names=[r.name for r in records]
        )

    buf = []
    for rec in read_fasta(path):
        buf.append(rec)
        if len(buf) >= chunk_records:
            yield build(buf)
            buf = []
    if buf:
        yield build(buf)


def pack_batch(
    db: EncodedDatabase,
    order: np.ndarray,
    lanes: int,
    lb_pad: int,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Pack the records selected by ``order`` into a (lb_pad, lanes) batch.

    ``out`` may supply a preallocated C-contiguous int8 destination of shape
    (lb_pad, lanes) — e.g. a view into a larger stream buffer — to skip the
    intermediate copy; it is fully overwritten (including '*' padding).
    """
    if out is None:
        out = np.empty((lb_pad, lanes), dtype=np.int8)
    elif (
        out.shape != (lb_pad, lanes)
        or out.dtype != np.int8
        or not out.flags.c_contiguous
    ):
        raise ValueError("out must be a C-contiguous int8 (lb_pad, lanes) array")
    lib = _load()
    order = np.ascontiguousarray(order, dtype=np.int64)
    if lib is None:
        from ..models.alphabet import PAD_INDEX

        out[:] = PAD_INDEX
        for lane, rec in enumerate(order):
            r = db.record(int(rec))
            out[: len(r), lane] = r
        return out
    lib.fastio_pack(
        db.seq.ctypes.data_as(ctypes.c_void_p),
        db.offsets.ctypes.data_as(ctypes.c_void_p),
        order.ctypes.data_as(ctypes.c_void_p),
        len(order),
        lanes,
        lb_pad,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
