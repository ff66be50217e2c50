"""Device-mesh sharding for database search.

The reference's coarse parallelism is an OpenMP ``parallel for`` over
independent vector-batches on one CPU (``src/alignment_cmdline.c:504-507``).
The device equivalent is data parallelism over the database: lanes are
sharded across devices on a 1-D mesh, the query profile is replicated, and
the per-shard best scores (or top-k candidates) are merged with XLA
collectives (NCCL over NVLink on GPUs). A database scan has no cross-sequence dependencies, so this
sharding needs zero communication during compute — the collective appears
only in the final top-k merge.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis: str = "db") -> Mesh:
    """1-D mesh over all (or given) devices; axis name 'db'."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), (axis,))


def sharded_engine(
    engine_fn: Callable, mesh: Mesh, go: int, ge: int, axis: str = "db"
) -> Callable:
    """Wrap a lane-batched engine to run sharded over mesh lanes.

    The returned fn takes (profile (Lq,32), db (Lb, B_total)) with B_total a
    multiple of ``mesh.size * engine lane width``; lanes are sharded across
    devices, the profile is replicated, and per-lane scores come back sharded
    (B_total,).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    def _run(profile, db):
        return engine_fn(profile, db, go, ge)

    return jax.jit(_run)


def sharded_topk(
    engine_fn: Callable,
    mesh: Mesh,
    go: int,
    ge: int,
    k: int,
    axis: str = "db",
) -> Callable:
    """Sharded scoring + in-graph global top-k merge via all-gather.

    Each device scores its lane shard and selects its local top-k, then the
    (k, values+indices) candidates are all-gathered and reduced to
    the global top-k — the merge pattern the BASELINE north star describes.
    Returns fn(profile, db) -> (values (k,), global lane indices (k,)).
    """
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def _run(profile, db):
        scores = engine_fn(profile, db, go, ge)
        local_k = min(k, scores.shape[0])
        vals, idx = jax.lax.top_k(scores, local_k)
        shard = jax.lax.axis_index(axis)
        gidx = idx + shard * scores.shape[0]
        all_vals = jax.lax.all_gather(vals, axis, tiled=True)
        all_idx = jax.lax.all_gather(gidx, axis, tiled=True)
        top_vals, pos = jax.lax.top_k(all_vals, k)
        return top_vals, jnp.take(all_idx, pos)

    return jax.jit(_run)


def shard_db(db: np.ndarray, mesh: Mesh, axis: str = "db"):
    """Device-put a (Lb, B_total) batch sharded over lanes."""
    return jax.device_put(db, NamedSharding(mesh, P(None, axis)))
