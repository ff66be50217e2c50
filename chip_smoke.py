"""End-to-end smoke run on one NVIDIA GPU (``--four-cards``: four).

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the multi-card paths only

One process holds the card(s); every search goes through the entry points a
user calls (``cli.main``, ``pipeline``), in this process. Phases:

1. device: JAX's devices and the card's name and power limit (GPU only);
2. build: the native ingest/traceback libraries and the CUDA kernel, from
   the repo's sources;
3. compile: the kernel at the full database's shapes, memory analysis;
4. main path: a seeded Swiss-Prot-scale FASTA (565,247 records) searched
   through the CLI at query lengths 144 and 17 (PAM250, gap -2/-1); the
   scores must equal the XLA wavefront's on the GPU over a stratified
   sample (with the 1,000 longest records, up to 35,213 residues) and the
   NumPy oracle's on a random sample plus the longest record, exactly;
5. long queries (1,000 and 5,478 residues) on a slice of the database;
6. other CLI paths: --align, a multi-record query file, --db-cache with
   --stream-chunk; each equal to the plain run;
7. timings, each with the card's name and power limit (informational).

The last line of standard output is ``{"ok": true, "device": {...}}``. A
failed phase raises, and the script exits non-zero without that line; it
exits with status 2 when JAX finds no GPU. Files go to ``build/smoke/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time
from pathlib import Path

WORK = Path(__file__).resolve().parent / "build" / "smoke"
GAPS = ["--substitution_matrix", "PAM250", "--gapopen", "-2",
        "--gapextend", "-1"]
SLICE = 50_000  # records for the long-query phase


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run_cli(args: list[str]) -> tuple[dict, float, float]:
    """cli.main in this process. Returns ({query#: {entry: score}}, kernel
    seconds from 'Total Time', wall seconds)."""
    from seqalign import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        code = cli.main(["smith_waterman", *args])
    wall = time.perf_counter() - t0
    if code != 0:
        raise RuntimeError(f"cli exited {code}: {args}")
    scores: dict = {}
    q, entry, kernel = 0, None, None
    for line in buf.getvalue().splitlines():
        if line.startswith("Query #"):
            q = int(line[7:].split(":")[0])
        elif line.startswith("Entry #"):
            entry = int(line[7:-1])
        elif line.startswith("score: "):
            scores.setdefault(q, {})[entry] = int(line[7:])
        elif line.startswith("Total Time: "):
            kernel = float(line[12:])
    if kernel is None:
        raise RuntimeError(f"no Total Time line: {args}")
    return scores, kernel, wall


def as_array(block: dict, n: int):
    import numpy as np

    out = np.full(n, -1, dtype=np.int64)
    out[list(block)] = list(block.values())
    if (out < 0).any():
        raise RuntimeError("CLI output misses entries")
    return out


def write_query(path: Path, seqs: list[str]) -> str:
    path.write_text("".join(f">q{i}\n{s}\n" for i, s in enumerate(seqs)))
    return str(path)


def stratified(db, every: int, longest: int):
    """Every ``every``-th record by length rank plus the ``longest``."""
    import numpy as np

    rank = np.argsort(-db.lengths, kind="stable")
    return np.unique(np.concatenate([rank[::every], rank[:longest]]))


def subset(db, ids):
    from seqalign.pipeline import _db_from_encoded

    return _db_from_encoded([db.record(int(i)) for i in ids])


def check_equal(phase: str, what: str, got, want) -> None:
    import numpy as np

    bad = np.flatnonzero(np.asarray(got) != np.asarray(want))
    if len(bad):
        raise AssertionError(
            f"{what}: {len(bad)} of {len(want)} scores differ, first at "
            f"{bad[:5].tolist()}"
        )
    say(phase, f"{what}: {len(want)} scores equal")


def one_card(card: str) -> None:
    import numpy as np

    from seqalign.models import ScoringModel, load_builtin
    from seqalign.ops import swa_cuda, traceback
    from seqalign.ops.oracle import sw_score_batch
    from seqalign.ops.swa_xla import make_profile
    from seqalign.pipeline import search_database
    from seqalign.utils import native_io, synth

    # 2. build
    t0 = time.perf_counter()
    if not native_io.available() or not traceback.native_available():
        raise RuntimeError("native ingest/traceback libraries did not build")
    swa_cuda.ensure_registered()
    say("build", f"native fastio + traceback + {swa_cuda.library_path().name}"
        f" ready in {time.perf_counter() - t0:.1f}s")

    sc = load_builtin("PAM250", ScoringModel(
        gap_open=-2, gap_extend=-1, use_match_mismatch=False))
    go, ge = sc.gap_open_total, sc.gap_extend
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    db = synth.swissprot_like()
    db_path = str(WORK / "swissprot_like.fa")
    synth.write_fasta(db, db_path)
    residues = int(db.offsets[-1])
    say("main", f"database {db.n} records, {residues} residues, written in "
        f"{time.perf_counter() - t0:.1f}s")
    queries = {lq: synth.query(lq, seed=lq) for lq in (144, 17, 1000, 5478)}

    # 3. compile at the full database's shapes
    import jax

    order = np.argsort(-db.lengths, kind="stable")
    pack = swa_cuda.pack_groups(db, order)
    dev = [jax.device_put(x) for x in pack.arrays]
    nlong = int((pack.slots < len(pack.long_off) - 1).sum())
    for lq in (144, 17):
        profs = [jax.device_put(x) for x in swa_cuda.query_profiles(
            make_profile(sc.table, sc.query_indices(queries[lq])), go)]
        t0 = time.perf_counter()
        compiled = swa_cuda._ffi_score.lower(
            *profs, *dev, go=go, ge=ge).compile()
        say("compile", f"lq={lq} strips={swa_cuda.strip_shape(lq)} "
            f"groups={len(pack.row_off) - 1} (bucketed), long records "
            f"{nlong} (> {swa_cuda.LONG_RECORD}) in passes x rows "
            f"{swa_cuda.long_shape(lq)}, in "
            f"{time.perf_counter() - t0:.2f}s; memory_analysis: "
            f"{compiled.memory_analysis()}")
    del dev, pack

    # 4. main path through the CLI
    plain = {}
    sample = stratified(db, every=100, longest=1000)
    rng = np.random.default_rng(7)
    longest = int(np.argmax(db.lengths))
    oracle_ids = np.append(rng.choice(db.n, 250, replace=False), longest)
    for lq in (144, 17):
        qf = write_query(WORK / f"q{lq}.fa", [queries[lq]])
        out, kt, wall = run_cli([*GAPS, "--files", qf, db_path])
        scores = as_array(out[0], db.n)
        plain[lq] = scores
        say("time", f"cli lq={lq}: {db.n} records, e2e {wall:.3f}s, kernel "
            f"{kt:.4f}s, {lq * residues / kt / 1e9:.1f} GCUPS kernel, "
            f"{lq * residues / wall / 1e9:.1f} GCUPS e2e [{card}]")
        q = sc.query_indices(queries[lq])
        want, _ = search_database(q, subset(db, sample), sc,
                                   engine="wavefront")
        check_equal("main", f"lq={lq} vs wavefront on GPU, stratified "
                    f"sample incl. 1000 longest (max len "
                    f"{int(db.lengths[sample].max())})",
                    scores[sample], want)
        want = sw_score_batch(q, [db.record(int(i)) for i in oracle_ids],
                              sc.table, sc.gap_open, sc.gap_extend)
        check_equal("main", f"lq={lq} vs NumPy oracle, random sample and "
                    f"the longest record ({int(db.lengths[longest])})",
                    scores[oracle_ids], want)

    # 5. long queries on a slice
    from seqalign.utils.native_io import EncodedDatabase

    sl = EncodedDatabase(seq=db.seq[: db.offsets[SLICE]],
                         offsets=db.offsets[: SLICE + 1],
                         names=db.names[:SLICE])
    sl_path = str(WORK / "slice.fa")
    synth.write_fasta(sl, sl_path)
    sl_res = int(sl.offsets[-1])
    say("long", f"cut: slice of the first {SLICE} of {db.n} records "
        f"({sl_res} residues)")
    for lq in (1000, 5478):
        qf = write_query(WORK / f"q{lq}.fa", [queries[lq]])
        out, kt, wall = run_cli([*GAPS, "--files", qf, sl_path])
        scores = as_array(out[0], SLICE)
        say("time", f"cli lq={lq}: {SLICE} records, e2e {wall:.3f}s, kernel "
            f"{kt:.4f}s, {lq * sl_res / kt / 1e9:.1f} GCUPS kernel [{card}]")
        ids = stratified(sl, every=200, longest=16)
        want, _ = search_database(sc.query_indices(queries[lq]),
                                  subset(sl, ids), sc, engine="wavefront")
        check_equal("long", f"lq={lq} ({swa_cuda.strip_shape(lq)[0]} strips) "
                    "vs wavefront on GPU, stratified sample",
                    scores[ids], want)

    # 6. other CLI paths
    q144 = str(WORK / "q144.fa")
    out, kt, wall = run_cli([*GAPS, "--align", "10", "--files", q144,
                             db_path])
    top = np.argsort(-plain[144], kind="stable")[:10]
    got = out[0]
    if sorted(got.values(), reverse=True) != sorted(
            plain[144][top].tolist(), reverse=True):
        raise AssertionError(f"--align scores {got} != top-10 "
                             f"{plain[144][top].tolist()}")
    if any(plain[144][e] != s for e, s in got.items()):
        raise AssertionError("--align hit scores differ from the plain run")
    say("cli", f"--align 10 at lq=144: hit scores equal the plain run "
        f"(e2e {wall:.3f}s) [{card}]")

    qm = write_query(WORK / "qmulti.fa", [queries[144], queries[17]])
    out, kt, wall = run_cli([*GAPS, "--files", qm, db_path])
    check_equal("cli", "multi-record query file, query 0 (lq=144) vs plain",
                as_array(out[0], db.n), plain[144])
    check_equal("cli", "multi-record query file, query 1 (lq=17) vs plain",
                as_array(out[1], db.n), plain[17])
    say("time", f"cli 2 queries (144+17): e2e {wall:.3f}s, kernel {kt:.4f}s "
        f"[{card}]")

    cache = str(WORK / "swissprot_like.sqc")
    out, _, wall = run_cli([*GAPS, "--db-cache", cache, "--files", q144,
                            db_path])
    check_equal("cli", "--db-cache (cold: builds the .sqc) vs plain",
                as_array(out[0], db.n), plain[144])
    out, kt, wall = run_cli([*GAPS, "--db-cache", cache, "--stream-chunk",
                             "100000", "--files", q144, db_path])
    check_equal("cli", "--stream-chunk 100000 over the .sqc vs plain",
                as_array(out[0], db.n), plain[144])
    say("time", f"cli --stream-chunk over .sqc lq=144: e2e {wall:.3f}s, "
        f"kernel {kt:.4f}s [{card}]")


def four_cards(card: str) -> None:
    import jax
    import numpy as np

    from seqalign.models import ScoringModel, load_builtin
    from seqalign.ops.swa_xla import make_profile, sw_wavefront
    from seqalign.parallel import (
        make_mesh, multi_device_search, multihost_search, shard_db,
        sharded_topk,
    )
    from seqalign.pipeline import search_database
    from seqalign.utils import synth
    from seqalign.utils.native_io import pack_batch

    devices = jax.devices()
    if len(devices) != 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, JAX has {devices}")
    sc = load_builtin("PAM250", ScoringModel(
        gap_open=-2, gap_extend=-1, use_match_mismatch=False))
    go, ge = sc.gap_open_total, sc.gap_extend
    db = synth.swissprot_like()
    residues = int(db.offsets[-1])
    q = sc.query_indices(synth.query(144, seed=144))
    prof = make_profile(sc.table, q)

    single, kt1 = search_database(q, db, sc, engine="cuda")
    say("4cards", f"single card: {db.n} records, kernel {kt1:.4f}s "
        f"[{card}]")
    multi, kt4 = multi_device_search(prof, db, go, ge, devices=devices)
    check_equal("4cards", "multi_device_search over 4 GPUs vs one card",
                multi, single)
    say("time", f"multi_device_search lq=144: kernel {kt4:.4f}s, "
        f"{144 * residues / kt4 / 1e9:.1f} GCUPS; one card {kt1:.4f}s, "
        f"{144 * residues / kt1 / 1e9:.1f} GCUPS [{card} x4]")

    # sharded_topk: wavefront shards of a dense batch over a 1-D mesh.
    rng = np.random.default_rng(3)
    short = np.flatnonzero(db.lengths <= 600)
    ids = np.sort(rng.choice(short, min(4 * 4096, len(short) // 4 * 4),
                             replace=False))
    batch = pack_batch(db, ids, len(ids), 600).astype(np.int32)
    mesh = make_mesh(devices)
    vals, idx = sharded_topk(sw_wavefront, mesh, go, ge, k=20)(
        prof, shard_db(batch, mesh))
    vals, idx = np.asarray(vals), np.asarray(idx)
    want = np.sort(single[ids])[::-1][:20]
    check_equal("4cards", "sharded_topk values (4-device mesh) vs one card",
                np.sort(vals)[::-1], want)
    check_equal("4cards", "sharded_topk indices score their values",
                single[ids][idx], vals)

    WORK.mkdir(parents=True, exist_ok=True)
    db_path = str(WORK / "swissprot_like.fa")
    synth.write_fasta(db, db_path)
    hosts, kth = multihost_search(q, db_path, sc,
                                  db_cache=str(WORK / "swissprot_like.sqc"))
    check_equal("4cards", "multihost_search (1 process, 4 local GPUs) vs "
                "one card", hosts, single)
    say("time", f"multihost_search lq=144: kernel {kth:.4f}s [{card} x4]")


def main(argv: list[str]) -> int:
    four = "--four-cards" in argv
    from seqalign.utils.device import card, require_gpu

    devices = require_gpu("chip_smoke.py")
    info = card()
    say("device", f"{devices} kind={devices[0].device_kind!r}")
    print(info, flush=True)
    (four_cards if four else one_card)(info)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
