"""Sequence-parallel alignment of ONE long query across the device mesh.

The reference handles long sequences only by letting RAM grow
(``src/alignment.c:227-230``); every other parallel axis in this framework
is data parallelism over independent database records. This module covers
the remaining SURVEY §2 row — the context-parallel-like decomposition of a
SINGLE alignment: the query's DP rows are sharded across devices, and the
only coupling — the (H, E, F) values at each stripe's last row — flows
device-to-device with ``lax.ppermute``.

The device pipeline marches database blocks: at step ``t`` device ``k``
processes block ``t - k`` of its row stripe, so after ``D`` fill steps all
devices compute concurrently on successive blocks (a classic wavefront
pipeline; per-step device-to-device traffic is ``jb * B * 3`` int32 — kilobytes).
``ppermute`` delivers zeros to device 0, which is exactly the local-
alignment zero boundary above the first stripe.

Exact recurrence (reference ``src/alignment.c:122-161``):
    H(i,j) = max(0, max(H,E,F)(i-1,j-1) + s)
    E(i,j) = max(0, max(H,F)(i,j-1) + go, E(i,j-1) + ge)   [along db]
    F(i,j) = max(0, max(H,E)(i-1,j) + go, F(i-1,j) + ge)   [along query]
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.alphabet import PAD_INDEX


def _max3(x):
    return jnp.maximum(jnp.maximum(x[..., 0], x[..., 1]), x[..., 2])


def sw_longpair(
    profile: np.ndarray,
    db: np.ndarray,
    go: int,
    ge: int,
    mesh: Mesh,
    jb: int = 128,
    axis: str | None = None,
    data_axis: str | None = None,
) -> jax.Array:
    """Score one (long) query against ``db`` lanes, query rows sharded.

    Args:
      profile: (Lq, 32) int query profile (``make_profile``).
      db: (Lb, B) int database lanes, '*'-padded.
      mesh: mesh whose axis ``axis`` shards the query rows (sequence
        parallel). With a 2-D mesh, ``data_axis`` additionally shards the
        database lanes (data parallel): each data-axis slice runs its own
        seq-axis wavefront pipeline over its lane shard, and the boundary
        ``ppermute`` rides only the ``axis`` subgroups, so the two kinds of
        parallelism compose without any cross-axis collective.
      jb: db positions per pipeline block (message granularity).

    Returns (B,) int32 best local-alignment scores — identical to the
    single-device engines (zero-profile row padding and '*' db padding are
    score-invariant, same argument as the batched kernels).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    if axis is None:
        axis = mesh.axis_names[0]
    seq_count = mesh.shape[axis]
    data_count = mesh.shape[data_axis] if data_axis is not None else 1
    if seq_count * data_count != mesh.devices.size:
        raise ValueError(
            f"mesh axes {axis!r}/{data_axis!r} must cover all "
            f"{mesh.devices.size} devices"
        )
    lq = profile.shape[0]
    rows = -(-lq // seq_count)
    prof = np.zeros((rows * seq_count, 32), dtype=np.int32)
    prof[:lq] = np.asarray(profile, dtype=np.int32)
    lb, b = db.shape
    lb_pad = -(-lb // jb) * jb
    b_pad = -(-b // data_count) * data_count
    dbp = np.full((lb_pad, b_pad), PAD_INDEX, dtype=np.int32)
    dbp[:lb, :b] = np.asarray(db, dtype=np.int32)
    n_blocks = lb_pad // jb
    steps = n_blocks + seq_count - 1
    go_i = jnp.int32(go)
    ge_i = jnp.int32(ge)
    d_count = seq_count
    db_spec = P(None, data_axis) if data_axis is not None else P(None, None)
    out_spec = P(data_axis) if data_axis is not None else P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), db_spec),
        out_specs=out_spec,
        check_vma=False,
    )
    def _run(prof_stripe, db_all):
        r = prof_stripe.shape[0]
        b = db_all.shape[1]  # local lane shard width
        rank = jax.lax.axis_index(axis)

        def row_step(rcarry, rx):
            up, ul = rcarry  # (B,3) at (i-1, jc) and (i-1, jc-1)
            s_i, left = rx  # (B,), (B,3) at (i, jc-1)
            h = jnp.maximum(_max3(ul) + s_i, 0)
            e = jnp.maximum(
                jnp.maximum(
                    jnp.maximum(left[..., 0], left[..., 2]) + go_i,
                    left[..., 1] + ge_i,
                ),
                0,
            )
            f = jnp.maximum(
                jnp.maximum(
                    jnp.maximum(up[..., 0], up[..., 1]) + go_i,
                    up[..., 2] + ge_i,
                ),
                0,
            )
            new = jnp.stack([h, e, f], axis=-1)
            return (new, left), new

        def col_step(carry, x):
            col_prev, bnd_pc = carry  # (R,B,3), (B,3) top boundary at jc-1
            s_col, bnd_c = x  # (R,B), (B,3) top boundary at jc
            (last, _), newcol = jax.lax.scan(
                row_step, (bnd_c, bnd_pc), (s_col, col_prev)
            )
            return (newcol, bnd_c), (newcol[..., 0].max(axis=0), last)

        def step(carry, t):
            col_state, bnd_pc, bnd_in, best = carry
            block_j = t - rank
            valid = (block_j >= 0) & (block_j < n_blocks)
            jstart = jnp.clip(block_j, 0, n_blocks - 1) * jb
            db_blk = jax.lax.dynamic_slice(db_all, (jstart, 0), (jb, b))
            # s(i, col, lane) = prof_stripe[i, db char]: (R, jb, B)->(jb, R, B)
            s_cols = jnp.take(prof_stripe, db_blk, axis=1).transpose(1, 0, 2)
            (cs2, bl2), (hmaxes, lasts) = jax.lax.scan(
                col_step, (col_state, bnd_pc), (s_cols, bnd_in)
            )
            col_state = jnp.where(valid, cs2, col_state)
            bnd_pc = jnp.where(valid, bl2, bnd_pc)
            best = jnp.where(
                valid, jnp.maximum(best, hmaxes.max(axis=0)), best
            )
            # My stripe's bottom row per column seeds the next device's top
            # boundary for this block at step t+1. Device 0 receives zeros
            # (no source) — the local-alignment boundary.
            bnd_next = jax.lax.ppermute(
                lasts, axis, perm=[(k, k + 1) for k in range(d_count - 1)]
            )
            return (col_state, bnd_pc, bnd_next, best), None

        z3 = jnp.zeros((r, b, 3), jnp.int32)
        zb = jnp.zeros((b, 3), jnp.int32)
        zbb = jnp.zeros((jb, b, 3), jnp.int32)
        (_, _, _, best), _ = jax.lax.scan(
            step,
            (z3, zb, zbb, jnp.zeros((b,), jnp.int32)),
            jnp.arange(steps, dtype=jnp.int32),
        )
        return jax.lax.pmax(best, axis)

    prof_dev = jax.device_put(prof, NamedSharding(mesh, P(axis, None)))
    db_dev = jax.device_put(dbp, NamedSharding(mesh, db_spec))
    out = jax.jit(_run)(prof_dev, db_dev)
    return out[:b] if b_pad != b else out
