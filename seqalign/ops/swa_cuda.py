"""Smith-Waterman database scoring on an NVIDIA Hopper GPU.

The DP kernel is CUDA (``native/swa_cuda.cu``), compiled for ``sm_90a`` at
first use and called through ``jax.ffi``. Records up to ``LONG_RECORD``
residues get one thread each, in warp groups of similar length; longer
ones get a warp each, the lanes splitting the query's rows, so that the
longest record does not set the kernel's time. This module owns
everything around the kernels: the build, the packing, the two query
profiles, the call, and :func:`reference_kernel`, a NumPy model of the
kernels' own loop nests that the CPU tests run in their place.

**The G-form recurrence.** The reference's formulation
(``src/alignment.c:122-161``, floors included) is:

    H = max(0, H_d+s, E_d+s, F_d+s)         (d = diagonal)
    E = max(0, H_u+go, E_u+ge, F_u+go)      (u = previous db position)
    F = max(0, H_l+go, E_l+go, F_l+ge)      (l = previous query position)

Define G = max(H, E, F). Because H >= 0 pointwise, G = max(H', E, F, 0) with
H' = G_d + s unfloored. Given ge >= go (gap_open <= 0), the E/F updates
collapse onto G:

    max(H_u, F_u) + go  ==  max(H_u+go, E_u+go, F_u+go)   [E_u+go <= E_u+ge]
                        ==  G_u + go
    E = max(G_u + go, E_u + ge)
    F = max(G_l + go, F_l + ge)
    H' = G_d + s
    G = max(max(H', E), max(F, 0))

The E/F zero floors are dropped: with ge <= 0 too, an E or F value below
zero can only ever be observed through G, whose own 0 dominates it. (A
positive gap-extend would let a gap grow from the floor, so the kernel
requires go <= ge <= 0, :func:`precondition`; other scoring systems run on
the wavefront engine.) The score is max(0, max H') over real cells. Rows
store Gg = G + go, and the ``-go`` bias is folded into the profile,
P'[i, c] = table[q_i, c] - go, so H' = Gg_d + P'[i, c] is a single add. A
cell is then 4 adds and 6 maxes, issued as 2 ``__viaddmax_s32``, 1
``__vimax3_s32_relu``, 2 adds and 1 max on Hopper's DPX units.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.native_build import BUILD, NATIVE, make

LANES = 32  # records per group: one warp, one record per thread
STRIP_HEIGHTS = (4, 8, 12, 16, 20, 24, 28, 32, 48)  # compiled in .cu
# Tallest strip: 48 rows beat 32 and 24 at lq=144 and lq=1000 over the
# database's body (bench.py --kernel, medians of 7; docs/DESIGN.md); 64
# rows ran slower than 32 at lq=1000 (register pressure).
MAX_STRIP = 48
# Records longer than this get a warp each (sw_long_kernel) instead of a
# thread: one thread's walk down a 35,000-residue record would otherwise
# set the whole kernel's time.
LONG_RECORD = 3072
LONG_HEIGHTS = range(1, 9)  # rows per lane in the long kernel, in .cu
PAD_ROW = -(1 << 29)  # profile value of rows past the query's end
# Residues per dispatch. The boundary scratch of a striped query is
# 8 bytes per packed residue, so this bounds it at about 2.5 GB.
CHUNK_RESIDUES = 1 << 28
TARGET = "seqalign_sw_score"


def precondition(go: int, ge: int) -> bool:
    """True if the G-form is exact for these penalties (go <= ge <= 0)."""
    return go <= ge <= 0


def strip_shape(lq: int, max_rows: int = MAX_STRIP) -> tuple[int, int]:
    """(number of strips, rows per strip) covering ``lq`` query rows with
    the fewest strips of at most ``max_rows`` and the fewest padded rows."""
    n = max(1, -(-lq // max_rows))
    need = -(-lq // n)
    return n, min(h for h in STRIP_HEIGHTS if h >= need)


def long_shape(lq: int) -> tuple[int, int]:
    """(number of passes, rows per lane) of the long kernel: the fewest
    passes of 32 lanes x at most 8 rows, then the fewest rows per lane."""
    top = LANES * max(LONG_HEIGHTS)
    n = max(1, -(-lq // top))
    return n, max(1, -(-lq // (n * LANES)))


def _biased(profile, go, rows):
    profile = np.asarray(profile, dtype=np.int32)
    p = np.full((rows, 32), PAD_ROW, dtype=np.int32)
    p[: profile.shape[0]] = profile - np.int32(go)
    return p


def strip_profile(
    profile: np.ndarray, go: int, max_rows: int = MAX_STRIP
) -> np.ndarray:
    """(Lq, 32) profile -> (nstrips, 32, R) biased profile P' = P - go,
    residue-major within each strip; padded rows hold PAD_ROW."""
    n, r = strip_shape(np.shape(profile)[0], max_rows)
    p = _biased(profile, go, n * r)
    return np.ascontiguousarray(p.reshape(n, r, 32).transpose(0, 2, 1))


def long_profile(profile: np.ndarray, go: int) -> np.ndarray:
    """(Lq, 32) profile -> (npasses, 32 * R, 32) biased profile for the
    long kernel, row-major; padded rows hold PAD_ROW."""
    n, r = long_shape(np.shape(profile)[0])
    return _biased(profile, go, n * LANES * r).reshape(n, LANES * r, 32)


def query_profiles(profile, go: int, max_rows: int = MAX_STRIP):
    """Both kernels' profiles of one query: the kernel's first two
    arguments."""
    return strip_profile(profile, go, max_rows), long_profile(profile, go)


@dataclasses.dataclass
class GroupPack:
    """Records packed for the kernel.

    Records up to ``LONG_RECORD`` residues go in warp groups: group g holds
    ``ids[nlong + 32g : nlong + 32g + 32]`` in rows
    ``row_off[g] : row_off[g+1]`` of ``db`` viewed as (rows, 32), position-
    major and lane-minor ('*'-padded, as ``native_io.pack_batch`` writes).
    Longer records, ``ids[:nlong]``, lie back to back in ``long_db`` at
    ``long_off``. The kernel's output holds ``len(long_off) - 1`` long
    scores, then one score per group lane; record ``ids[i]``'s score is at
    ``slots[i]``.
    """

    db: np.ndarray  # (rows * 32,) int8
    row_off: np.ndarray  # (ngroups + 1,) int32
    lens: np.ndarray  # (ngroups * 32,) int32, 0 for empty lanes
    long_db: np.ndarray  # (long residues,) int8
    long_off: np.ndarray  # (nlong + 1,) int32
    ids: np.ndarray  # (n,) record ids: long records, then lane order
    slots: np.ndarray  # (n,) their places in the kernel's output

    @property
    def arrays(self) -> tuple:
        """The kernel's arguments after the two profiles."""
        return self.db, self.row_off, self.lens, self.long_db, self.long_off


def bucket(n: int) -> int:
    """``n`` rounded up to the next of 8..16 x 2**k (exact below 16).

    Packed shapes are rounded to these sizes, eight per doubling and at
    most 12.5% over, so that a few compiled kernels serve every chunk.
    """
    k = max(0, int(n).bit_length() - 4)
    return -(-int(n) >> k) << k


def pack_groups(db, ids: np.ndarray, long_record: int | None = None) -> GroupPack:
    """Pack records ``ids`` (length-sorted by the caller) for the kernel.

    Records longer than ``long_record`` (default ``LONG_RECORD``) go to the
    long kernel; the rest in groups of 32, each group's length its longest
    record rounded up to 8. Every count and size is rounded up by
    :func:`bucket` (at least 1): the extra groups and long records are
    empty and the extra residues are never read.
    """
    from ..utils.native_io import pack_batch

    cut = LONG_RECORD if long_record is None else long_record
    ids = np.asarray(ids, dtype=np.int64)
    is_long = db.lengths[ids] > cut
    long_ids, ids = ids[is_long], ids[~is_long]

    nl = len(long_ids)
    long_off = np.zeros(bucket(max(nl, 1)) + 1, dtype=np.int64)
    np.cumsum(db.lengths[long_ids], out=long_off[1 : nl + 1])
    long_off[nl + 1 :] = long_off[nl]
    long_db = np.zeros(bucket(max(int(long_off[-1]), 1)), dtype=np.int8)
    for k, i in enumerate(long_ids):
        long_db[long_off[k] : long_off[k + 1]] = db.record(int(i))

    n = len(ids)
    ngroups = -(-n // LANES)
    lens = np.zeros(bucket(max(ngroups, 1)) * LANES, dtype=np.int32)
    lens[:n] = db.lengths[ids]
    glen = lens.reshape(-1, LANES).max(axis=1, initial=0)
    glen = -(-glen // 8) * 8
    row_off = np.zeros(len(glen) + 1, dtype=np.int64)
    np.cumsum(glen, out=row_off[1:])
    rows = bucket(max(int(row_off[-1]), 1))
    if max(rows * LANES, len(long_db)) >= 2**31:
        raise ValueError("chunk too large for int32 offsets")
    flat = np.empty(rows * LANES, dtype=np.int8)
    rows = flat.reshape(-1, LANES)
    for g in range(ngroups):
        a, b = int(row_off[g]), int(row_off[g + 1])
        if b > a:
            pack_batch(db, ids[g * LANES : (g + 1) * LANES], LANES, b - a,
                       out=rows[a:b])
    nlong_slots = len(long_off) - 1
    return GroupPack(
        db=flat, row_off=row_off.astype(np.int32), lens=lens,
        long_db=long_db, long_off=long_off.astype(np.int32),
        ids=np.concatenate([long_ids, ids]),
        slots=np.concatenate([np.arange(nl), nlong_slots + np.arange(n)]),
    )


def chunk_bounds(lengths: np.ndarray, max_residues: int) -> list[tuple[int, int]]:
    """Split records (in scan order) into runs of whole groups holding at
    most ``max_residues`` residues each (at least one group per run)."""
    n = len(lengths)
    csum = np.cumsum(lengths, dtype=np.int64)
    bounds, s = [], 0
    while s < n:
        base = csum[s - 1] if s else 0
        e = int(np.searchsorted(csum, base + max_residues, side="right"))
        if e < n:  # end on a group boundary
            e = max(s + LANES, e // LANES * LANES)
        e = min(e, n)
        bounds.append((s, e))
        s = e
    return bounds


# ---------------------------------------------------------------- the build

_LOCK = threading.Lock()
_REGISTERED = False


def library_path():
    """Build output path, keyed by a hash of the kernel source and its
    build rule."""
    h = hashlib.sha256()
    for f in ("swa_cuda.cu", "Makefile"):
        h.update((NATIVE / f).read_bytes())
    return BUILD / "cuda" / f"libswa_cuda-{h.hexdigest()[:16]}.so"


def ensure_registered() -> None:
    """Build the CUDA library if needed and register its FFI target.

    A failed build raises: on a GPU there is no silent fallback.
    """
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        import ctypes

        lib_path = library_path()
        make(
            lib_path,
            [NATIVE / "swa_cuda.cu", NATIVE / "Makefile"],
            ["cuda", f"CUDA_LIB={lib_path}", f"PYTHON={sys.executable}"],
        )
        lib = ctypes.cdll.LoadLibrary(str(lib_path))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.SwScore), platform="CUDA"
        )
        _REGISTERED = True


@functools.partial(jax.jit, static_argnames=("go", "ge"))
def _ffi_score(prof, lprof, db, row_off, lens, long_db, long_off, *, go, ge):
    nb = 2 * db.shape[0] if prof.shape[0] > 1 else 2
    nlb = 2 * long_db.shape[0] if lprof.shape[0] > 1 else 2
    out, _, _ = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct(
                (long_off.shape[0] - 1 + lens.shape[0],), jnp.int32
            ),
            jax.ShapeDtypeStruct((nb,), jnp.int32),  # strip boundaries
            jax.ShapeDtypeStruct((nlb,), jnp.int32),  # long pass boundaries
        ),
    )(prof, lprof, db, row_off, lens, long_db, long_off,
      go=np.int32(go), ge=np.int32(ge))
    return out


# Compiled kernels, least recently used first. Packed shapes come in
# bucket() sizes, so a scan reuses a handful of entries; the bound keeps a
# long-lived process from holding one per query length forever.
_COMPILED: collections.OrderedDict = collections.OrderedDict()
MAX_COMPILED = 32


def compile_kernel(*args, go: int, ge: int):
    """The kernel compiled for these device arrays' shapes and device.

    ``args`` are :func:`query_profiles`' two profiles and a GroupPack's
    ``arrays``. Returns ``run(*args)``, the int32 scores in the layout
    GroupPack describes. The CPU tests replace this function with one
    returning :func:`reference_kernel`.
    """
    ensure_registered()
    key = (
        tuple(a.shape for a in args), str(args[0].devices()),
        int(go), int(ge),
    )
    run = _COMPILED.get(key)
    if run is None:
        run = _ffi_score.lower(*args, go=int(go), ge=int(ge)).compile()
        _COMPILED[key] = run
        if len(_COMPILED) > MAX_COMPILED:
            _COMPILED.popitem(last=False)
    _COMPILED.move_to_end(key)
    return run


def reference_kernel(
    prof, lprof, db, row_off, lens, long_db, long_off, *, go: int, ge: int
):
    """NumPy model of the CUDA kernels' loop nests, in the output layout
    of GroupPack: :func:`_reference_long`, then :func:`_reference_groups`."""
    return np.concatenate([
        _reference_long(lprof, long_db, long_off, go, ge),
        _reference_groups(prof, db, row_off, lens, go, ge),
    ])


def _reference_groups(prof, db, row_off, lens, go, ge):
    """sw_score_kernel, vectorized over lanes.

    Same strips, same register state per strip (Gg, E per row), same
    boundary array layout (``bnd[(row_off[g] + j) * 32 + lane]`` holds the
    strip's last-row (Gg, F)), same int32 G-form arithmetic and masking.
    """
    prof = np.asarray(prof, dtype=np.int32)
    db = np.asarray(db)
    row_off = np.asarray(row_off, dtype=np.int64)
    lens = np.asarray(lens)
    nstrips, _, rr = prof.shape
    ngroups = len(row_off) - 1
    glen = np.repeat(np.diff(row_off), LANES)
    base = (
        np.repeat(row_off[:-1], LANES) * LANES
        + np.tile(np.arange(LANES), ngroups)
    )
    lmax = int(glen.max(initial=0))
    go, ge = np.int32(go), np.int32(ge)
    neg = np.int32(-(1 << 29))
    bnd = np.zeros((db.size, 2), dtype=np.int32)
    best = np.zeros(ngroups * LANES, dtype=np.int32)
    for s in range(nstrips):
        p = prof[s]
        gg = np.full((rr, best.size), go, dtype=np.int32)
        e = np.full((rr, best.size), neg, dtype=np.int32)
        diag_top = np.full(best.size, go, dtype=np.int32)
        for j in range(lmax):
            act = j < glen
            idx = np.where(act, base + j * LANES, 0)
            c = db[idx].astype(np.int64)
            if s == 0:
                above = np.full(best.size, go, dtype=np.int32)
                f = np.full(best.size, neg, dtype=np.int32)
            else:
                above, f = bnd[idx, 0].copy(), bnd[idx, 1].copy()
            diag, diag_top = diag_top, above
            cb = np.full(best.size, neg, dtype=np.int32)
            for k in range(rr):
                h = diag + p[c, k]
                diag = gg[k].copy()
                e[k] = np.maximum(e[k] + ge, gg[k])
                f = np.maximum(f + ge, above)
                gg[k] = np.maximum(np.maximum(h, e[k]), np.maximum(f, 0)) + go
                above = gg[k]
                cb = np.maximum(cb, h)
            best = np.where(j < lens, np.maximum(best, cb), best)
            if s < nstrips - 1:
                bnd[idx[act], 0] = above[act]
                bnd[idx[act], 1] = f[act]
    return best


def _reference_long(lprof, long_db, long_off, go, ge):
    """sw_long_kernel, one record at a time, vectorized over the lanes.

    Same passes, same per-lane rows, the same step t at which lane l works
    on position t - l, the same shuffle of (Gg, F') from lane l - 1, the
    same pass boundary and the same rearranged G-form.
    """
    lprof = np.asarray(lprof, dtype=np.int32)
    long_db = np.asarray(long_db)
    npasses, rows, _ = lprof.shape
    rr = rows // LANES
    go, ge = np.int32(go), np.int32(ge)
    neg = np.int32(-(1 << 29))
    lane = np.arange(LANES)
    out = np.zeros(len(long_off) - 1, dtype=np.int32)
    for r in range(len(out)):
        o, n = int(long_off[r]), int(long_off[r + 1] - long_off[r])
        if n == 0:
            continue
        rec = long_db[o : o + n].astype(np.int64)
        bnd = np.zeros((n, 2), dtype=np.int32)
        best = np.zeros(LANES, dtype=np.int32)
        for s in range(npasses):
            p = lprof[s].reshape(LANES, rr, 32)
            gg = np.full((rr, LANES), go, dtype=np.int32)
            e = np.full((rr, LANES), neg, dtype=np.int32)
            diag_top = np.full(LANES, go, dtype=np.int32)
            bot_g = np.full(LANES, go, dtype=np.int32)
            bot_f = np.full(LANES, go, dtype=np.int32)
            for t in range(n + LANES - 1):
                j = t - lane
                act = (j >= 0) & (j < n)
                above, f = np.roll(bot_g, 1), np.roll(bot_f, 1)
                above[0] = f[0] = go
                if s > 0 and t < n:
                    above[0], f[0] = bnd[t]
                c = rec[np.clip(j, 0, n - 1)]
                diag = diag_top
                diag_top = np.where(act, above, diag_top)
                cb = np.full(LANES, neg, dtype=np.int32)
                for k in range(rr):
                    h = diag + p[lane, k, c]
                    diag = gg[k].copy()
                    e[k] = np.where(act, np.maximum(e[k] + ge, gg[k]), e[k])
                    x = np.maximum(np.maximum(h, e[k]), 0) + go
                    gg[k] = np.where(act, np.maximum(f + go, x), gg[k])
                    f = np.maximum(f + ge, x)
                    cb = np.maximum(cb, h)
                best = np.where(act, np.maximum(best, cb), best)
                bot_g = np.where(act, gg[rr - 1], bot_g)
                bot_f = np.where(act, f, bot_f)
                if s < npasses - 1 and 0 <= t - (LANES - 1) < n:
                    bnd[t - (LANES - 1)] = bot_g[-1], bot_f[-1]
        out[r] = best.max()
    return out
