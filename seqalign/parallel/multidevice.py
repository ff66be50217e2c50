"""Multi-device (single-host) database search: data parallelism over records.

The production scale-out path for throughput workloads. A database scan has
zero cross-record dependencies, so the multi-device decomposition is pure
data parallelism: deal record groups to devices, score each device's share
with the engine its platform gets (``pipeline.choose_engine``: the CUDA
kernel on GPUs, the XLA wavefront on CPU meshes), and concatenate scores on
the host — no collectives in the scoring path at all. Collectives appear
only for top-k reduction (``sharding.sharded_topk``) or cross-host merges
(``multihost``).

This replaces the reference's OpenMP thread pool (``src/alignment_cmdline.c:
504-507``) at device granularity: OpenMP's dynamic scheduling balances
variable-length batches across cores; here the length-sorted deal balances
residues across devices ahead of time (within one group of records).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np


def deal_chunks(order: np.ndarray, lengths: np.ndarray, n_devices: int, win: int = 1024):
    """Deal groups of sorted records to devices, balancing residues.

    ``order`` must be length-sorted descending. Groups of ``win`` records go
    to the device with the least residues so far (greedy — groups arrive in
    descending size, the classic LPT schedule).
    """
    totals = [0] * n_devices
    chunks: list[list[np.ndarray]] = [[] for _ in range(n_devices)]
    for start in range(0, len(order), win):
        ids = order[start : start + win]
        d = min(range(n_devices), key=totals.__getitem__)
        chunks[d].append(ids)
        totals[d] += int(lengths[ids].sum())
    return [
        np.concatenate(c) if c else np.zeros(0, dtype=order.dtype)
        for c in chunks
    ]


def multi_device_search(
    profile: np.ndarray,
    db,
    go: int,
    ge: int,
    devices: Sequence | None = None,
    engine: str | None = None,
) -> tuple[np.ndarray, float]:
    """Score a query (or stacked queries) across all local devices.

    Args:
      profile: (Lq, 32) or (NQ, Lq, 32) int query profile(s).
      db: EncodedDatabase.
      engine: as in ``pipeline.choose_engine``, for the devices' platform.

    Returns (scores in stream order — (N,) or (NQ, N) — and kernel seconds).
    Every device's dispatches are enqueued before any result is fetched, so
    the devices run together; the timed region covers dispatch to last
    fetch (packing and host->device transfer excluded, the reference's own
    timing boundary, ``src/alignment_cmdline.c:503-509``).
    """
    import jax

    from .. import pipeline
    from ..ops import swa_cuda

    devices = list(jax.devices() if devices is None else devices)
    eng = pipeline.choose_engine(engine, go, ge, platform=devices[0].platform)
    multi = np.ndim(profile) == 3
    profiles = list(profile) if multi else [profile]
    n = db.n
    scores = np.zeros((len(profiles), n), dtype=np.int32)
    if n == 0:
        return (scores if multi else scores[0]), 0.0

    lengths = db.lengths
    order = np.argsort(-lengths, kind="stable")
    win = swa_cuda.LANES if eng == "cuda" else pipeline.WAVEFRONT_LANES
    shares = deal_chunks(order, lengths, len(devices), win=win)
    # Rounds of at most CHUNK_RESIDUES per device: every device scores its
    # k-th chunk in round k.
    rounds: list[list[tuple]] = []
    for dev, ids in zip(devices, shares):
        if eng != "cuda":
            bounds = [(0, len(ids))] if len(ids) else []
        else:
            bounds = swa_cuda.chunk_bounds(
                lengths[ids], swa_cuda.CHUNK_RESIDUES
            )
        for k, (s, e) in enumerate(bounds):
            if k == len(rounds):
                rounds.append([])
            rounds[k].append((dev, ids[s:e]))

    kernel_time = 0.0
    for work in rounds:
        prepared = []
        for dev, ids in work:
            if eng == "cuda":
                prepared.append(pipeline._cuda_prepare(
                    profiles, db, ids, go, ge, device=dev
                ))
            else:
                runs = [
                    pipeline._wavefront_prepare(
                        p, db, ids, go, ge, eng, win, device=dev
                    )
                    for p in profiles
                ]
                prepared.append((
                    [g for g, _ in runs],
                    lambda runs=runs: [r() for _, r in runs],
                ))
        t0 = time.perf_counter()
        outs = [run() for _, run in prepared]  # enqueue on every device
        outs = [[np.asarray(o) for o in out] for out in outs]
        kernel_time += time.perf_counter() - t0
        for (layout, _), out in zip(prepared, outs):
            if eng == "cuda":  # layout: the GroupPack
                for q, o in enumerate(out):
                    scores[q, layout.ids] = o[layout.slots]
            else:  # layout: each query's batches of record ids
                for q, (ids_q, batches) in enumerate(zip(layout, out)):
                    for ids, o in zip(ids_q, batches):
                        scores[q, ids] = o[: len(ids)]
    return (scores if multi else scores[0]), kernel_time
