"""Pure-JAX (XLA) Smith-Waterman affine-gap scoring engines.

Two lane-batched engines, both score-exact to the NumPy oracle
(:mod:`seqalign.ops.oracle`) and thus to the reference C kernel
(``src/alignment.c:122-161``):

- :func:`sw_scan`: outer ``lax.scan`` over database positions, inner
  ``lax.scan`` over query positions carrying the rolling H/E/F rows — the
  direct analog of the reference's loop nest. Exact work, very sequential;
  used as a readable second implementation and for small inputs.

- :func:`sw_wavefront`: marches anti-diagonals ``d = i + j``; every cell on a
  diagonal is independent, so each step is one vector op over
  ``(Lq, B)`` — the idiomatic XLA formulation (no per-cell loop). This is
  the CPU engine, the GPU's for scoring systems outside the CUDA kernel's
  precondition, and the shape the multi-device dry-run compiles.

Conventions (shared by all engines in this package):
- ``profile``: ``(Lq, 32)`` int32 query profile, ``profile[i, c] =
  table[query[i], c]`` — the query-side substitution gather is hoisted out of
  the hot loop (the vector answer to the reference's ``scoring_lookup`` row
  pointer, ``src/alignment.c:31-44``).
- ``db``: ``(Lb, B)`` int32 database batch, position-major / lane-minor (the
  reference's lane-major layout ``idx[pos*16 + lane]``,
  ``src/alignment_cmdline.c:445``), padded with ``PAD_INDEX`` ('*').
- ``go``/``ge``: *total* gap-open (``gap_open + gap_extend``) and gap-extend
  penalties, negative ints.
- returns ``(B,)`` int32 best local-alignment score per lane.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def make_profile(table: np.ndarray, query_idx: np.ndarray) -> np.ndarray:
    """Build the (Lq, 32) int32 query profile: ``P[i, c] = table[q_i, c]``."""
    return np.asarray(table, dtype=np.int32)[np.asarray(query_idx)]


@partial(jax.jit, static_argnames=("go", "ge"))
def sw_scan(profile: jax.Array, db: jax.Array, go: int, ge: int) -> jax.Array:
    """Exact-work double-scan engine. See module docstring for conventions."""
    profile = profile.astype(jnp.int32)
    db = db.astype(jnp.int32)
    lq = profile.shape[0]
    b = db.shape[1]
    zero = jnp.zeros((b,), jnp.int32)

    def inner(carry, x):
        h_diag, e_diag, f_diag, h_left, e_left, f_left, best = carry
        h_up, e_up, f_up, s = x
        diag = jnp.maximum(jnp.maximum(h_diag, e_diag), f_diag)
        h_new = jnp.maximum(diag + s, 0)
        e_new = jnp.maximum(
            jnp.maximum(jnp.maximum(h_up, f_up) + go, e_up + ge), 0
        )
        f_new = jnp.maximum(
            jnp.maximum(jnp.maximum(h_left, e_left) + go, f_left + ge), 0
        )
        best = jnp.maximum(best, h_new)
        return (
            (h_up, e_up, f_up, h_new, e_new, f_new, best),
            (h_new, e_new, f_new),
        )

    def outer(carry, db_j):
        h_rows, e_rows, f_rows, best = carry
        s_rows = jnp.take(profile, db_j, axis=1)  # (Lq, B)
        (_, _, _, _, _, _, best), (h_rows, e_rows, f_rows) = jax.lax.scan(
            inner,
            (zero, zero, zero, zero, zero, zero, best),
            (h_rows, e_rows, f_rows, s_rows),
        )
        return (h_rows, e_rows, f_rows, best), None

    rows0 = jnp.zeros((lq, b), jnp.int32)
    (_, _, _, best), _ = jax.lax.scan(
        outer, (rows0, rows0, rows0, zero), db
    )
    return best


def _wavefront_scan(profile, db, go, ge, track_ends: bool):
    """Shared anti-diagonal wavefront body (see sw_wavefront docstring).

    ``track_ends`` additionally carries per-lane argmax coordinates.
    """
    profile = profile.astype(jnp.int32)
    db = db.astype(jnp.int32)
    lq = profile.shape[0]
    lb, b = db.shape
    iota_i = jnp.arange(lq, dtype=jnp.int32)

    def shift(x):  # x (Lq, B): out[i] = x[i-1], out[0] = 0
        return jnp.concatenate([jnp.zeros((1, b), jnp.int32), x[:-1]], axis=0)

    def step(carry, d):
        if track_ends:
            h1, e1, f1, t2, best, bj, bi = carry
        else:
            h1, e1, f1, t2, best = carry  # 1 = diag d-1, t2 = max3 at d-2
        j = d - iota_i  # (Lq,)
        valid = (j >= 0) & (j < lb)
        db_diag = jnp.take(db, jnp.clip(j, 0, lb - 1), axis=0)  # (Lq, B)
        s = jnp.take_along_axis(profile, db_diag, axis=1)  # (Lq, B)

        h_new = jnp.maximum(shift(t2) + s, 0)
        e_new = jnp.maximum(
            jnp.maximum(jnp.maximum(h1, f1) + go, e1 + ge), 0
        )
        sh_h, sh_e, sh_f = shift(h1), shift(e1), shift(f1)
        f_new = jnp.maximum(
            jnp.maximum(jnp.maximum(sh_h, sh_e) + go, sh_f + ge), 0
        )
        mask = valid[:, None]
        h_new = jnp.where(mask, h_new, 0)
        e_new = jnp.where(mask, e_new, 0)
        f_new = jnp.where(mask, f_new, 0)
        # The next step's "two-diagonals-back" max3 is this step's d-1 max3.
        t1 = jnp.maximum(jnp.maximum(h1, e1), f1)
        if track_ends:
            colbest = h_new.max(axis=0)
            coli = jnp.argmax(h_new, axis=0).astype(jnp.int32)  # first max
            upd = colbest > best
            best = jnp.where(upd, colbest, best)
            bi = jnp.where(upd, coli + 1, bi)
            bj = jnp.where(upd, d - coli + 1, bj)
            return (h_new, e_new, f_new, t1, best, bj, bi), None
        best = jnp.maximum(best, h_new.max(axis=0))
        return (h_new, e_new, f_new, t1, best), None

    z = jnp.zeros((lq, b), jnp.int32)
    z1 = jnp.zeros((b,), jnp.int32)
    carry0 = (z, z, z, z, z1) + ((z1, z1) if track_ends else ())
    final, _ = jax.lax.scan(
        step, carry0, jnp.arange(lq + lb - 1, dtype=jnp.int32)
    )
    if track_ends:
        return final[4], final[5], final[6]
    return final[4]


@partial(jax.jit, static_argnames=("go", "ge"))
def sw_wavefront(
    profile: jax.Array, db: jax.Array, go: int, ge: int
) -> jax.Array:
    """Anti-diagonal wavefront engine: one vector step per diagonal.

    On diagonal ``d``, query position ``i`` holds cell ``(i, j=d-i)``.
    Dependencies: F needs ``(i-1, j)`` = diagonal ``d-1`` shifted by one in
    ``i``; E needs ``(i, j-1)`` = diagonal ``d-1`` unshifted; H needs
    ``max(H,E,F)`` at ``(i-1, j-1)`` = diagonal ``d-2`` shifted. Invalid
    cells (``j`` outside ``[0, Lb)``) are masked to zero, which reproduces
    the zero boundary row/column of local alignment for free.
    """
    return _wavefront_scan(profile, db, go, ge, track_ends=False)


@partial(jax.jit, static_argnames=("go", "ge"))
def sw_wavefront_ends(
    profile: jax.Array, db: jax.Array, go: int, ge: int
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Wavefront engine variant that also reports a best cell per lane.

    Returns ``(best, end_j, end_i)`` — 1-based coordinates (db position,
    query position) of a maximal H cell, 0 where ``best == 0``. Tie-breaks
    follow diagonal order (first diagonal, then smallest query index), which
    may differ from the row-major fill's rule; any maximal cell localizes an
    optimal alignment, so downstream traceback is unaffected.

    Serves the top-k re-alignment phase: one batched dispatch localizes the
    alignment END for every hit, after which the host-side traceback only
    runs its reverse window + rectangle (ops/traceback.py) instead of a
    full forward pass over each pair.
    """
    return _wavefront_scan(profile, db, go, ge, track_ends=True)
