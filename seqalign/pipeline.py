"""Query-vs-database search driver.

Equivalent of the reference's ``align_from_query_and_db``
(``src/alignment_cmdline.c:343-539``): stream the query and database FASTA,
encode, pack lane-batches, dispatch the DP engine, and report per-record
scores plus kernel-only timing (the reference times only the OpenMP kernel
region, ``src/alignment_cmdline.c:503-509`` — we time engine dispatch +
device execution, excluding parsing and packing, for the same measurement
boundary).

Differences from the reference (all strictly-better, score-identical):
- the database is actually length-sorted and bucketed (the reference assumes
  pre-sorted input, SURVEY.md §7.3); scores are scattered back to stream
  order;
- partial final batches are padded with all-'*' lanes and masked out (the
  reference reads uninitialized memory for them, SURVEY.md §7.1-7.2);
- scores are int32 (no 16-bit wraparound, SURVEY.md §7.4);
- parsing/encoding/packing run in native C++ when built (utils/native_io),
  the analog of the reference's C seq_file layer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Sequence

import numpy as np

from .models.alphabet import encode
from .models.scoring import ScoringModel
from .utils.fasta import SeqRecord, read_fasta, read_first
from .utils.native_io import (
    EncodedDatabase, pack_batch, parse_file_cached,
)
from .utils.packing import lattice_round_up


@dataclasses.dataclass
class SearchResult:
    """Scores for one query against a database, in database stream order."""

    query_name: str
    query_seq: str
    names: list[str]
    seqs: list[str] | None
    scores: np.ndarray  # (N,) int32
    kernel_time: float  # seconds spent in engine dispatch+execution
    total_entries: int


ENGINES = ("cuda", "wavefront", "scan", "oracle")


class EngineError(RuntimeError):
    """The requested engine cannot run on this backend or scoring system."""


def choose_engine(
    engine: str | None, go: int, ge: int, platform: str | None = None
) -> str:
    """The one place that picks the DP engine.

    ``engine=None`` picks the CUDA kernel on a GPU when its G-form
    precondition holds (``go <= ge <= 0``), and the XLA wavefront otherwise
    (the CPU, or a scoring system outside the precondition). An explicit
    engine that cannot run here raises :class:`EngineError`; nothing falls
    back silently. ``platform`` defaults to JAX's default backend.
    """
    from .ops.swa_cuda import precondition

    if platform is None:
        import jax

        platform = jax.default_backend()
    if engine is None:
        return (
            "cuda" if platform == "gpu" and precondition(go, ge)
            else "wavefront"
        )
    if engine not in ENGINES:
        raise EngineError(
            f"unknown engine {engine!r} (choose from {', '.join(ENGINES)})"
        )
    if engine == "cuda" and platform != "gpu":
        raise EngineError(
            f"the cuda engine needs a GPU; JAX's backend is {platform!r}"
        )
    if engine == "cuda" and not precondition(go, ge):
        raise EngineError(
            "the cuda engine needs gap_open <= 0 and gap_extend <= 0"
        )
    return engine


def get_engine(name: str) -> Callable:
    """Resolve an XLA engine name to fn(profile, db, go, ge) -> scores."""
    from .ops.swa_xla import sw_scan, sw_wavefront

    return {"wavefront": sw_wavefront, "scan": sw_scan}[name]


WAVEFRONT_LANES = 512


def _wavefront_prepare(profile, db, ids, go, ge, engine, lanes, device=None):
    """Pack ``ids`` into (Lb, lanes) batches on ``device`` for an XLA engine.

    Returns (groups of record ids, run) where ``run()`` enqueues every
    batch and returns the device results.
    """
    import jax

    engine_fn = get_engine(engine)
    lengths = db.lengths
    groups, batches = [], []
    for start in range(0, len(ids), lanes):
        g = ids[start : start + lanes]
        lb_pad = lattice_round_up(int(lengths[g].max(initial=1)))
        groups.append(g)
        batches.append(
            jax.device_put(pack_batch(db, g, lanes, lb_pad).astype(np.int32),
                           device)
        )
    prof = jax.device_put(profile, device)
    jax.block_until_ready(batches + [prof])
    return groups, lambda: [engine_fn(prof, b, go, ge) for b in batches]


def _cuda_prepare(profiles, db, ids, go, ge, device=None):
    """Pack ``ids`` into warp groups on ``device`` and compile the CUDA
    kernel for each query's shape, outside any timed region.

    Returns (pack, run) where ``run()`` enqueues one dispatch per query and
    returns the device results, each in the layout of ``pack`` (record
    ``pack.ids[i]`` at ``pack.slots[i]``).
    """
    import jax

    from .ops import swa_cuda

    pack = swa_cuda.pack_groups(db, ids)
    dev = [jax.device_put(x, device) for x in pack.arrays]
    profs = [
        [jax.device_put(x, device) for x in swa_cuda.query_profiles(p, go)]
        for p in profiles
    ]
    jax.block_until_ready([dev, profs])
    runs = [swa_cuda.compile_kernel(*p, *dev, go=go, ge=ge) for p in profs]
    return pack, lambda: [r(*p, *dev) for r, p in zip(runs, profs)]


def _cuda_search(profiles, db, go, ge, order, checkpoint_dir=None):
    """Score ``profiles`` (a list of (Lq, 32) profiles) against the whole
    database with the CUDA kernel: one dispatch per query and chunk of at
    most ``swa_cuda.CHUNK_RESIDUES`` residues.

    Returns ((NQ, N) int32 scores in stream order, kernel seconds). The
    timer covers dispatch, device execution and the score fetch; packing,
    host-to-device transfer and compilation stay outside it, the
    reference's own boundary (``src/alignment_cmdline.c:503-509``).
    """
    from .ops import swa_cuda

    scores = np.zeros((len(profiles), db.n), dtype=np.int32)
    ckpt = (
        _ScanCheckpoint(checkpoint_dir, profiles, db, go, ge, order)
        if checkpoint_dir
        else None
    )
    kernel_time = 0.0
    bounds = swa_cuda.chunk_bounds(
        db.lengths[order], swa_cuda.CHUNK_RESIDUES
    )
    for start, stop in bounds:
        chunk = order[start:stop]
        done = ckpt.load(start) if ckpt is not None else None
        if done is not None:
            scores[:, chunk] = done
            continue
        pack, run = _cuda_prepare(profiles, db, chunk, go, ge)
        t0 = time.perf_counter()
        outs = [np.asarray(o) for o in run()]
        kernel_time += time.perf_counter() - t0
        scores[:, pack.ids] = np.stack([o[pack.slots] for o in outs])
        if ckpt is not None:
            ckpt.save(start, scores[:, chunk])
    return scores, kernel_time


def search_database(
    query_idx: np.ndarray,
    db: EncodedDatabase,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
    checkpoint_dir: str | None = None,
) -> tuple[np.ndarray, float]:
    """Score an encoded query against an EncodedDatabase.

    Returns (scores in database stream order (N,) int32, kernel seconds).
    ``lanes`` sets the XLA engines' batch width; ``checkpoint_dir`` makes
    the CUDA engine's chunked scan resumable.
    """
    enable_compile_cache()
    go, ge = scoring.gap_open_total, scoring.gap_extend
    eng = choose_engine(engine, go, ge)
    n = db.n
    scores = np.zeros(n, dtype=np.int32)
    if n == 0 or len(query_idx) == 0:
        return scores, 0.0

    if eng == "oracle":
        from .ops.oracle import sw_score_batch

        t0 = time.perf_counter()
        scores = sw_score_batch(
            query_idx,
            [db.record(i) for i in range(n)],
            scoring.table,
            scoring.gap_open,
            scoring.gap_extend,
        ).astype(np.int32)
        return scores, time.perf_counter() - t0

    from .ops.swa_xla import make_profile

    profile = make_profile(scoring.table, query_idx)
    order = np.argsort(-db.lengths, kind="stable") if sort else np.arange(n)
    if eng == "cuda":
        multi, dt = _cuda_search(
            [profile], db, go, ge, order, checkpoint_dir=checkpoint_dir
        )
        return multi[0], dt

    groups, run = _wavefront_prepare(
        profile, db, order, go, ge, eng, lanes or WAVEFRONT_LANES
    )
    t0 = time.perf_counter()
    outs = [np.asarray(o) for o in run()]
    kernel_time = time.perf_counter() - t0
    for ids, out in zip(groups, outs):
        scores[ids] = out[: len(ids)]
    return scores, kernel_time


def search_database_multi(
    query_idxs: Sequence[np.ndarray],
    db: EncodedDatabase,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
) -> tuple[np.ndarray, float]:
    """Score MANY queries against a database.

    Returns ((NQ, N) int32 scores in database stream order, kernel seconds).

    On the CUDA engine the database is packed and uploaded once and every
    query is one dispatch over the same device arrays. Other engines run
    one search per query. The reference scores one query per run
    (``src/alignment_cmdline.c:355-360``).
    """
    nq = len(query_idxs)
    if nq == 0:
        return np.zeros((0, db.n), dtype=np.int32), 0.0
    enable_compile_cache()
    go, ge = scoring.gap_open_total, scoring.gap_extend
    if choose_engine(engine, go, ge) == "cuda" and db.n > 0:
        from .ops.swa_xla import make_profile

        order = (
            np.argsort(-db.lengths, kind="stable") if sort
            else np.arange(db.n)
        )
        profiles = [make_profile(scoring.table, q) for q in query_idxs]
        return _cuda_search(profiles, db, go, ge, order)

    scores = np.zeros((nq, db.n), dtype=np.int32)
    kernel_time = 0.0
    for k, q in enumerate(query_idxs):
        scores[k], dt = search_database(
            q, db, scoring, engine=engine, lanes=lanes, sort=sort
        )
        kernel_time += dt
    return scores, kernel_time


class _ScanCheckpoint:
    """Chunk-level resume for huge database scans (SURVEY.md §5).

    Each chunk's scores persist to ``dir/chunk_<start>.npy`` under a
    manifest keyed by a fingerprint of (query profiles, database, penalties,
    record order); re-running the same scan skips completed chunks. The
    reference has no recovery story (single pass, exit(1) on error).
    """

    def __init__(self, path, profiles, db, go, ge, order):
        import hashlib
        import json
        import os

        self.dir = path
        os.makedirs(path, exist_ok=True)
        h = hashlib.sha256()
        for p in profiles:
            h.update(str(np.shape(p)).encode())
            h.update(np.ascontiguousarray(p).tobytes())
        h.update(np.ascontiguousarray(db.offsets).tobytes())
        # Sampled content fingerprint: cheap but catches edits.
        h.update(np.ascontiguousarray(db.seq[:: max(1, len(db.seq) // 65536)]).tobytes())
        # The chunk->record mapping depends on the sort order: a scan saved
        # with sort=True must not resume a --no-sort scan (or vice versa) —
        # the same chunk index would hold a different record permutation.
        h.update(np.ascontiguousarray(order).tobytes())
        h.update(str((int(go), int(ge))).encode())
        self.key = h.hexdigest()[:16]
        self.manifest = os.path.join(path, "manifest.json")
        try:
            with open(self.manifest) as f:
                state = json.load(f)
            if state.get("key") != self.key:
                state = {"key": self.key, "chunks": []}
        except (OSError, ValueError):
            state = {"key": self.key, "chunks": []}
        self.state = state
        self._flush()

    def _flush(self):
        import json

        with open(self.manifest, "w") as f:
            json.dump(self.state, f)

    def _file(self, start):
        import os

        return os.path.join(self.dir, f"chunk_{start}.npy")

    def load(self, start):
        if start not in self.state["chunks"]:
            return None
        try:
            return np.load(self._file(start))
        except OSError:
            return None

    def save(self, start, chunk_scores):
        np.save(self._file(start), chunk_scores)
        self.state["chunks"].append(start)
        self._flush()


def compile_cache_dir() -> str:
    """Where JAX keeps compiled programs: ``$JAX_COMPILATION_CACHE_DIR``
    when set, else ``.jax_cache`` in the checkout."""
    import os

    from .utils.native_build import REPO

    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        REPO / ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache at
    :func:`compile_cache_dir`. When the environment names a directory, JAX
    reads it itself and no other is set here."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())


def _db_from_encoded(encoded: Sequence[np.ndarray], names=None) -> EncodedDatabase:
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    total = 0
    for i, e in enumerate(encoded):
        total += len(e)
        offsets[i + 1] = total
    seq = (
        np.concatenate([np.asarray(e, dtype=np.int8) for e in encoded])
        if encoded
        else np.zeros(0, dtype=np.int8)
    )
    return EncodedDatabase(
        seq=seq,
        offsets=offsets,
        names=list(names) if names else [""] * len(encoded),
    )


def search_encoded(
    query_idx: np.ndarray,
    encoded_db: Sequence[np.ndarray],
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
) -> tuple[np.ndarray, float]:
    """Score an encoded query against a list of encoded sequences."""
    return search_database(
        query_idx,
        _db_from_encoded(encoded_db),
        scoring,
        engine=engine,
        lanes=lanes,
        sort=sort,
    )


def _warn_padding(scoring: ScoringModel, query_idx: np.ndarray) -> None:
    if not scoring.padding_safe_for_query(query_idx):
        import sys

        print(
            "Warning: query contains characters with positive '*' scores; "
            "padded batches may not be score-invariant (same limitation as "
            "the reference engine).",
            file=sys.stderr,
        )


def search(
    query: SeqRecord,
    db_records: Iterable[SeqRecord],
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
) -> SearchResult:
    """Search from in-memory records (records kept for output)."""
    query_idx = scoring.query_indices(query.seq)
    names, seqs, encoded = [], [], []
    for rec in db_records:
        names.append(rec.name)
        seqs.append(rec.seq)
        encoded.append(encode(rec.seq))
    _warn_padding(scoring, query_idx)
    scores, kernel_time = search_encoded(
        query_idx, encoded, scoring, engine=engine, lanes=lanes, sort=sort
    )
    return SearchResult(
        query_name=query.name,
        query_seq=query.seq,
        names=names,
        seqs=seqs,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=len(names),
    )


@dataclasses.dataclass
class MultiSearchResult:
    """Scores for several queries against one database."""

    query_names: list[str]
    query_seqs: list[str]
    names: list[str]
    scores: np.ndarray  # (NQ, N) int32
    kernel_time: float
    total_entries: int


def search_files_multi(
    query_path: str,
    db_path: str,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    db_cache: str | None = None,
) -> MultiSearchResult:
    """Search EVERY record of a query FASTA against a database FASTA.

    On the CUDA engine the queries share one packed, uploaded database.
    The reference reads only the first query record
    (``src/alignment_cmdline.c:355-360``); this is the batched extension its
    north star asks for.
    """
    queries = list(read_fasta(query_path))
    if not queries:
        raise ValueError(f"no sequences in {query_path}")
    query_idxs = [scoring.query_indices(q.seq) for q in queries]
    for q in query_idxs:
        _warn_padding(scoring, q)
    db = parse_file_cached(db_path, db_cache)
    scores, kernel_time = search_database_multi(
        query_idxs, db, scoring, engine=engine, lanes=lanes
    )
    return MultiSearchResult(
        query_names=[q.name for q in queries],
        query_seqs=[q.seq for q in queries],
        names=db.names,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=db.n,
    )


def search_files_streaming(
    query_path: str,
    db_path: str,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    chunk_records: int = 512 * 1024,
    checkpoint_dir: str | None = None,
    db_cache: str | None = None,
) -> SearchResult:
    """Bounded-memory search: stream the database in record chunks.

    The reference streams records with O(batch) memory
    (``src/alignment_cmdline.c:422-457``); ``search_files``'s flat-buffer
    parse is O(database) instead, which a larger-than-RAM database breaks.
    This variant reads/encodes/scores ``chunk_records`` at a time (the
    per-chunk sort keeps padding low within each chunk) and keeps only
    names + scores — the ingest runs through the native chunked reader
    (``native_io.stream_chunks``) at the same rate as the whole-file
    parser. Scores are identical to the non-streaming path.

    ``db_cache``: when a FRESH .sqc cache exists ("auto" = sidecar), the
    chunks are zero-copy views of the mmap (``iter_cache_chunks``) — the
    OS pages residues in and evicts behind the scan, so memory stays
    bounded AND the FASTA is never re-read (cache-only deployments
    stream too). A missing/stale cache falls back to the FASTA reader;
    it is NOT built here (building one needs a whole-file parse, which
    would defeat this mode's memory bound — run a plain search once, or
    save_cache explicitly, to create it).
    """
    import os

    from .utils.native_io import iter_cache_chunks, load_cache, stream_chunks

    query = read_first(query_path)
    query_idx = scoring.query_indices(query.seq)
    _warn_padding(scoring, query_idx)

    chunk_iter = None
    if db_cache is not None:
        cache_path = db_path + ".sqc" if db_cache == "auto" else db_cache
        cached = load_cache(cache_path, src_path=db_path)
        if cached is not None:
            chunk_iter = iter_cache_chunks(cached, chunk_records)
        else:
            import sys

            print(
                f"Note: database cache {cache_path} absent or stale; "
                "streaming from the FASTA (a streaming run does not "
                "build caches).",
                file=sys.stderr,
            )
    if chunk_iter is None:
        chunk_iter = stream_chunks(db_path, chunk_records)

    names: list[str] = []
    chunks: list[np.ndarray] = []
    kernel_time = 0.0

    # One-deep ingest prefetch: the host parses/encodes chunk k+1 while
    # the device scores chunk k. Both sides release the GIL (ctypes C
    # calls; device fetches), so a plain thread genuinely overlaps them —
    # the measured host ingest rate is ~3x slower than the lq=144 kernel
    # consumes residues, so this hides most of the host cost. Memory
    # bound becomes two chunks (one scoring + one staged).
    import queue as _queue
    import threading as _threading

    _q: _queue.Queue = _queue.Queue(maxsize=1)
    # Consumer-driven cancellation: if the consume loop dies mid-iteration
    # (compile error, checkpoint IO failure, KeyboardInterrupt), the
    # producer must not block forever on a full queue — that would leak
    # the thread, the open native stream/gzip handle, and two parsed
    # chunks per failed streaming search in library use.
    _cancel = _threading.Event()

    def _put(item) -> bool:
        while not _cancel.is_set():
            try:
                _q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                continue
        return False

    def _producer():
        try:
            for item in chunk_iter:
                if not _put(item):
                    break
            else:
                _put(None)
        except BaseException as e:  # surface parse errors on the consumer
            _put(e)
        finally:
            if _cancel.is_set():
                close = getattr(chunk_iter, "close", None)
                if close is not None:
                    close()

    _threading.Thread(target=_producer, daemon=True).start()

    def _consume():
        try:
            while True:
                item = _q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Runs on normal exhaustion AND when the for-loop closes the
            # generator after a body exception — releases the producer.
            _cancel.set()

    for k, db in enumerate(_consume()):
        ck = (
            os.path.join(checkpoint_dir, f"part{k}") if checkpoint_dir else None
        )
        s, dt = search_database(
            query_idx, db, scoring, engine=engine, lanes=lanes,
            checkpoint_dir=ck,
        )
        kernel_time += dt
        names.extend(db.names)
        chunks.append(s)

    scores = (
        np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int32)
    )
    return SearchResult(
        query_name=query.name,
        query_seq=query.seq,
        names=names,
        seqs=None,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=len(names),
    )


def search_files(
    query_path: str,
    db_path: str,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    keep_seqs: bool = False,
    checkpoint_dir: str | None = None,
    db_cache: str | None = None,
) -> SearchResult:
    """Search a query FASTA (first record) against a database FASTA.

    Uses the native parser when built. ``keep_seqs`` retains the original
    sequence strings (needed for ``--printseq``) via the Python reader.
    """
    query = read_first(query_path)
    query_idx = scoring.query_indices(query.seq)
    _warn_padding(scoring, query_idx)
    if keep_seqs:
        return search(
            query, read_fasta(db_path), scoring, engine=engine, lanes=lanes
        )
    db = parse_file_cached(db_path, db_cache)
    scores, kernel_time = search_database(
        query_idx, db, scoring, engine=engine, lanes=lanes,
        checkpoint_dir=checkpoint_dir,
    )
    return SearchResult(
        query_name=query.name,
        query_seq=query.seq,
        names=db.names,
        seqs=None,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=db.n,
    )
