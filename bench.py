"""Time searches of a seeded Swiss-Prot-scale database on the GPU.

    python bench.py [--entries N] [--lq 144 17] [--engines cuda wavefront]
                    [--repeats 2]
    python bench.py --kernel [--lq 144 17 1000] [--max-strip 24 32 48]
                    [--long-record 1024 3072 8192] [--repeats 7]

Generates the database of ``seqalign.utils.synth`` (565,247 records by
default) in memory. PAM250, gap open -2, extend -1.

Default mode: ``pipeline.search_database`` once per repeat, engine and
query length, alternating the engine order between repeats. Every engine
must return the same scores. Each run prints one JSON line: end-to-end
seconds (pack, upload, compile on a cold run, kernel, fetch), the kernel
seconds the pipeline reports (dispatch to fetched scores), and GCUPS over
real residues. The first repeat of each engine includes compilation and
the first-use build.

``--kernel``: the CUDA kernel alone on the whole database packed once, one
warm-up call and then ``--repeats`` timed calls (dispatch to
``block_until_ready``) per configuration, the configurations interleaved
and their order reversed on odd repeats. It sweeps the tallest strip
(``--max-strip``) over the whole database and over its body (the database
without the 1,000 longest records of its tail), sweeps the length above which
records go to the warp-per-record kernel (``--long-record``), and times
the 32 longest records alone: their share of the whole is the long
tail's cost. Each configuration prints the median, minimum and maximum;
scores must agree across configurations.

Every line carries the device and the card's name and power limit. Exits
with status 2, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def search_mode(args, db, sc, device) -> None:
    import numpy as np

    from seqalign.pipeline import search_database
    from seqalign.utils import synth

    residues = int(db.offsets[-1])
    for lq in args.lq:
        q = sc.query_indices(synth.query(lq, seed=lq))
        want = None
        for rep in range(args.repeats):
            engines = args.engines if rep % 2 == 0 else args.engines[::-1]
            for eng in engines:
                t0 = time.perf_counter()
                scores, kt = search_database(q, db, sc, engine=eng)
                e2e = time.perf_counter() - t0
                if want is None:
                    want = scores
                elif not np.array_equal(scores, want):
                    raise SystemExit(f"{eng} scores differ at lq={lq}")
                cells = lq * residues
                print(json.dumps({
                    "engine": eng, "lq": lq, "repeat": rep,
                    "entries": db.n, "residues": residues,
                    "e2e_s": e2e, "kernel_s": kt,
                    "gcups_e2e": cells / e2e / 1e9,
                    "gcups_kernel": cells / kt / 1e9,
                    "device": device,
                }), flush=True)


def kernel_mode(args, db, sc, device) -> None:
    import jax
    import numpy as np

    from seqalign.ops import swa_cuda
    from seqalign.ops.swa_xla import make_profile
    from seqalign.utils import synth

    go, ge = sc.gap_open_total, sc.gap_extend
    order = np.argsort(-db.lengths, kind="stable")
    parts = {f"all_long>{c}": (order, c) for c in args.long_record}
    body = f"without_{synth.TAIL_RECORDS}_longest"
    parts[body] = (order[synth.TAIL_RECORDS :], None)
    parts[f"longest_{swa_cuda.LANES}"] = (order[: swa_cuda.LANES], None)
    main = f"all_long>{swa_cuda.LONG_RECORD}"
    packs = {}
    for name, (ids, cut) in parts.items():
        pack = swa_cuda.pack_groups(db, ids, cut)
        dev = [jax.device_put(x) for x in pack.arrays]
        packs[name] = (pack, dev, int(db.lengths[ids].sum()))
    jax.block_until_ready([dev for _, dev, _ in packs.values()])

    for lq in args.lq:
        prof = make_profile(sc.table, sc.query_indices(synth.query(lq, lq)))
        configs = [
            (name, m) for name in parts for m in (
                args.max_strip if name in (main, body)
                else [swa_cuda.MAX_STRIP]
            )
        ]
        runs, want = {}, None
        for name, m in configs:
            pack, dev, _ = packs[name]
            p = [jax.device_put(x) for x in swa_cuda.query_profiles(prof, go, m)]
            run = swa_cuda.compile_kernel(*p, *dev, go=go, ge=ge)
            out = np.asarray(run(*p, *dev))  # warm-up
            scores = np.zeros(db.n, dtype=np.int32)
            scores[pack.ids] = out[pack.slots]
            if want is None:
                want = scores
            elif not np.array_equal(scores[pack.ids], want[pack.ids]):
                raise SystemExit(f"{name} max_strip={m}: scores differ")
            runs[name, m] = (run, p, dev, [])
        for rep in range(args.repeats):
            for key in configs if rep % 2 == 0 else configs[::-1]:
                run, p, dev, times = runs[key]
                t0 = time.perf_counter()
                jax.block_until_ready(run(*p, *dev))
                times.append(time.perf_counter() - t0)
        full = runs.get((main, swa_cuda.MAX_STRIP))
        full = statistics.median(full[3]) if full else None
        for (name, m), (_, _, _, times) in runs.items():
            med = statistics.median(times)
            pack, _, res = packs[name]
            print(json.dumps({
                "kernel": name, "lq": lq, "max_strip": m,
                "strips": swa_cuda.strip_shape(lq, m),
                "long_passes": swa_cuda.long_shape(lq),
                "records": len(pack.ids), "residues": res,
                "long_records": int((pack.slots < len(pack.long_off) - 1).sum()),
                "longest": int(db.lengths[parts[name][0][0]]),
                "repeats": len(times), "median_s": med,
                "min_s": min(times), "max_s": max(times),
                "share_of_all": med / full if full else None,
                "gcups": lq * res / med / 1e9,
                "device": device,
            }), flush=True)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--entries", type=int, default=None)
    p.add_argument("--lq", type=int, nargs="+", default=[144, 17])
    p.add_argument("--engines", nargs="+", default=["cuda"])
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--kernel", action="store_true",
                   help="time the CUDA kernel alone (see above)")
    p.add_argument("--max-strip", type=int, nargs="+", default=None,
                   help="tallest query strips to sweep (--kernel)")
    p.add_argument("--long-record", type=int, nargs="+", default=None,
                   help="long-kernel cuts to sweep (--kernel)")
    args = p.parse_args(argv)

    from seqalign.utils.device import card, require_gpu

    devices = require_gpu("bench.py")

    from seqalign.models import ScoringModel, load_builtin
    from seqalign.ops import swa_cuda
    from seqalign.utils import synth

    for m in args.max_strip or ():
        if m not in swa_cuda.STRIP_HEIGHTS:
            p.error(f"--max-strip {m}: choose from {swa_cuda.STRIP_HEIGHTS}")
    args.max_strip = args.max_strip or [swa_cuda.MAX_STRIP]
    args.long_record = sorted(
        {*(args.long_record or ()), swa_cuda.LONG_RECORD})
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": card(),
    }
    print(json.dumps({"device": device}), flush=True)
    db = synth.swissprot_like(args.entries or synth.SWISSPROT_RECORDS)
    sc = load_builtin(
        "PAM250",
        ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
    )
    (kernel_mode if args.kernel else search_mode)(args, db, sc, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
