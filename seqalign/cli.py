"""``smith_waterman``-compatible command-line tool.

Behavioral parity with the reference binary (``src/tools/sw_cmdline.c`` +
``cmdline_new``, ``src/alignment_cmdline.c:177-308``):

- case-insensitive flags, same names and arity;
- defaults match=2, mismatch=-2, gapopen=-2, gapextend=-1;
- loading a substitution matrix without ``--match`` disables match/mismatch
  mode (``src/alignment_cmdline.c:294-297``);
- ``--files <query> <db>`` prints the "Query File=... and Database File=..."
  line exactly like the reference (``src/alignment_cmdline.c:274``);
- per-entry output ``Entry #N:`` / ``score: S`` and the trailing
  ``Total Time:`` / ``Total Entries:`` lines are parse-compatible with the
  reference's test and benchmark harnesses (``test/tests.py:44-56``,
  ``benchmarks/benchmark.py:31``);
- error messages and nonzero exits for the same invalid invocations.

Extensions (new flags, all optional): ``--engine``, ``--lanes``,
``--no-sort``, ``--topk N`` (print only the N best entries),
``--json`` (machine-readable output).
"""

from __future__ import annotations

import sys

from .models.matrices import load_substitution_matrix
from .models.scoring import ScoringModel, sw_default_scoring

USAGE = """usage: {prog} [OPTIONS] [seq1 seq2]
  Smith-Waterman optimal local alignment (maximises score).
  Takes a query FASTA and a database FASTA and scores the query against
  every database record. Can read gzip files, FASTA and FASTQ.

  OPTIONS:
    --file <file>        Sequence file reading with gzip support - read two
                         sequences at a time and align them
    --files <f1> <f2>    Read one sequence from each file to align at one time
    --stdin              Read from STDIN (same as '--file -')

    --match <score>      [default: {match}]
    --mismatch <score>   [default: {mismatch}]
    --gapopen <score>    [default: {gapopen}]
    --gapextend <score>  [default: {gapextend}]

    --substitution_matrix <file>  see details for formatting

    --minscore <score>   Only print entries scoring at least this
                         (documented but unimplemented in the reference)

    --printseq           Print sequences before local alignments
    --printmatrices      Print dynamic programming matrices
    --printfasta         Print fasta header lines
    --pretty             Print with a descriptor line
    --colour             Print with colour

  EXTENSIONS (seqalign):
    --engine <name>      cuda | wavefront | scan | oracle  [default: cuda
                         on a GPU, else wavefront]
    --lanes <n>          lane-batch width of the XLA engines
    --no-sort            do not length-sort the database (assume pre-sorted)
    --topk <n>           print only the n best-scoring entries
    --all-queries        score EVERY query-file record (batched on-device;
                         on by default for multi-record query files)
    --first-query        strict reference behavior: score only the first
                         query record (src/alignment_cmdline.c:355-360)
    --align <k>          print gapped alignments + CIGAR for the k best hits
    --checkpoint <dir>   chunk-level resume state for huge scans
    --db-cache <path>    persistent encoded-database cache (.sqc): parse
                         the FASTA once, mmap thereafter ('auto' = sidecar
                         <db>.sqc; rebuilt when the FASTA changes)
    --stream-chunk <n>   bounded-memory mode: process n db records at a time
    --trace <dir>        write a jax.profiler trace of the search
    --json               print results as one JSON object
    --hosts <n>          multi-host run: total jax processes (with
                         --host-id and --coordinator; DB striped per host,
                         scores merged over the network)
    --host-id <i>        this process's id (0-based)
    --coordinator <a:p>  jax.distributed coordinator address

 DETAILS:
  * Gap (of length N) penalty is: (open+N*extend)
  * To do alignment without affine gap penalty, set '--gapopen 0'.
  * Scoring files should be matrices, with entries separated by a single
    character or whitespace, or a builtin name (BLOSUM45, BLOSUM62, PAM250).
"""


def _usage_exit(prog: str, scoring: ScoringModel, err: str | None) -> int:
    if err is not None:
        sys.stderr.write("Error: " + err + ("\n" if not err.endswith("\n") else ""))
    sys.stderr.write(
        USAGE.format(
            prog=prog,
            match=scoring.match,
            mismatch=scoring.mismatch,
            gapopen=scoring.gap_open,
            gapextend=scoring.gap_extend,
        )
    )
    return 1


def _parse_int(s: str):
    try:
        return int(s)
    except ValueError:
        return None


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    prog = argv[0] if argv else "smith_waterman"
    args = argv[1:]
    scoring = sw_default_scoring()

    if not args:
        return _usage_exit(prog, scoring, None)
    for a in args:
        if a.lower() in ("--help", "-help", "-h"):
            return _usage_exit(prog, scoring, None)

    file1 = file2 = None
    substitutions_set = match_set = False
    print_seq = print_fasta = False
    engine = None
    lanes = None
    sort = True
    topk = None
    minscore = None
    checkpoint = None
    stream_chunk = None
    trace_dir = None
    align_k = None
    as_json = False
    all_queries = False
    first_query = False
    matrix_spec = None
    db_cache = None
    hosts = None
    host_id = None
    coordinator = None

    i = 0
    n = len(args)
    while i < n:
        a = args[i]
        al = a.lower()
        if a.startswith("-"):
            if al == "--printseq":
                print_seq = True
            elif al == "--printmatrices":
                pass  # parsed but inert, like the reference (sw_cmdline.c:40-42)
            elif al == "--printfasta":
                print_fasta = True
            elif al == "--pretty" or al == "--colour":
                pass  # parsed but inert, like the reference
            elif al == "--stdin":
                file1, file2 = "", None
            elif al == "--no-sort":
                sort = False
            elif al == "--all-queries":
                all_queries = True
            elif al == "--first-query":
                first_query = True
            elif al == "--json":
                as_json = True
            elif i == n - 1:
                return _usage_exit(
                    prog, scoring, f"Unknown argument without parameter: {a}"
                )
            elif al == "--scoring":
                # Vestigial flag: the reference swallows --scoring plus its
                # argument with no effect (alignment_cmdline.c:226-228, the
                # "This handled above" branch — nothing handles it above);
                # as the last argument it still hits the generic
                # "Unknown argument without parameter" path, matched here
                # by the i == n - 1 check preceding this branch.
                i += 1
            elif al == "--substitution_matrix":
                matrix_spec = args[i + 1]
                substitutions_set = True
                i += 1
            elif al == "--match":
                v = _parse_int(args[i + 1])
                if v is None:
                    return _usage_exit(
                        prog,
                        scoring,
                        f"Invalid --match argument ('{args[i+1]}') must be an int",
                    )
                scoring.match = v
                match_set = True
                i += 1
            elif al == "--mismatch":
                v = _parse_int(args[i + 1])
                if v is None:
                    return _usage_exit(
                        prog,
                        scoring,
                        f"Invalid --mismatch argument ('{args[i+1]}') must be an int",
                    )
                scoring.mismatch = v
                i += 1
            elif al == "--gapopen":
                v = _parse_int(args[i + 1])
                if v is None:
                    return _usage_exit(
                        prog,
                        scoring,
                        f"Invalid --gapopen argument ('{args[i+1]}') must be an int",
                    )
                scoring.gap_open = v
                i += 1
            elif al == "--gapextend":
                v = _parse_int(args[i + 1])
                if v is None:
                    return _usage_exit(
                        prog,
                        scoring,
                        f"Invalid --gapextend argument ('{args[i+1]}') must be an int",
                    )
                scoring.gap_extend = v
                i += 1
            elif al == "--file":
                file1, file2 = args[i + 1], None
                i += 1
            elif al == "--engine":
                engine = args[i + 1]
                i += 1
            elif al == "--lanes":
                lanes = _parse_int(args[i + 1])
                if lanes is None or lanes <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --lanes argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                i += 1
            elif al == "--topk":
                topk = _parse_int(args[i + 1])
                if topk is None or topk <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --topk argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                i += 1
            elif al == "--minscore":
                minscore = _parse_int(args[i + 1])
                if minscore is None:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --minscore argument ('{args[i+1]}') must be an int",
                    )
                i += 1
            elif al == "--checkpoint":
                checkpoint = args[i + 1]
                i += 1
            elif al == "--db-cache":
                db_cache = args[i + 1]
                i += 1
            elif al == "--stream-chunk":
                stream_chunk = _parse_int(args[i + 1])
                if stream_chunk is None or stream_chunk <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --stream-chunk argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                i += 1
            elif al == "--trace":
                trace_dir = args[i + 1]
                i += 1
            elif al == "--hosts":
                hosts = _parse_int(args[i + 1])
                if hosts is None or hosts <= 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --hosts argument ('{args[i+1]}') "
                        "must be a positive int",
                    )
                i += 1
            elif al == "--host-id":
                host_id = _parse_int(args[i + 1])
                if host_id is None or host_id < 0:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --host-id argument ('{args[i+1]}') "
                        "must be a nonnegative int",
                    )
                i += 1
            elif al == "--coordinator":
                coordinator = args[i + 1]
                i += 1
            elif al == "--align":
                align_k = _parse_int(args[i + 1])
                if align_k is None:
                    return _usage_exit(
                        prog, scoring,
                        f"Invalid --align argument ('{args[i+1]}') must be an int",
                    )
                i += 1
            elif al == "--files":
                if i >= n - 2:
                    return _usage_exit(prog, scoring, "--files option takes 2 arguments")
                print(f"Query File={args[i+1]} and Database File={args[i+2]}")
                if args[i + 1] == "-" and args[i + 2] == "-":
                    file1, file2 = args[i + 1], None
                else:
                    file1, file2 = args[i + 1], args[i + 2]
                i += 2
            else:
                return _usage_exit(prog, scoring, f"Unknown argument '{a}'")
        else:
            if n - i != 2:
                return _usage_exit(prog, scoring, f"Unknown options: '{a}'")
            break
        i += 1

    if matrix_spec is not None:
        try:
            load_substitution_matrix(matrix_spec, scoring)
        except OSError:
            return _usage_exit(prog, scoring, f"Couldn't read: {matrix_spec}")

    if substitutions_set and not match_set:
        scoring.use_match_mismatch = False
    scoring.finalize()

    if scoring.use_match_mismatch and scoring.match < scoring.mismatch:
        return _usage_exit(
            prog, scoring, "Match value should not be less than mismatch penalty"
        )
    if file1 is None or file2 is None:
        if file1 is not None and file2 is None and file1 == "":
            sys.stderr.write(
                "Error: Both query and database files must be provided\n"
            )
            return 0  # reference main returns EXIT_SUCCESS here
        return _usage_exit(prog, scoring, "No input specified")

    from .pipeline import (
        EngineError, choose_engine, enable_compile_cache, search_files,
    )

    enable_compile_cache()
    if hosts is not None and hosts > 1:
        if host_id is None or coordinator is None:
            return _usage_exit(
                prog, scoring,
                "--hosts requires --host-id and --coordinator",
            )
        return _run_multihost(
            file1, file2, scoring, topk, minscore, as_json,
            hosts, host_id, coordinator, db_cache=db_cache,
        )

    # After the multi-host branch: jax.distributed must start before
    # anything touches the backend.
    try:
        choose_engine(engine, scoring.gap_open_total, scoring.gap_extend)
    except EngineError as e:
        return _usage_exit(prog, scoring, str(e))

    if not all_queries and not first_query and file1 != "-":
        # Multi-record query files batch automatically (the reference reads
        # only the first record, src/alignment_cmdline.c:355-360; batching
        # every query through shared kernel dispatches is strictly more
        # useful and the per-query output blocks keep parsers working).
        # --first-query opts back into strict reference behavior. Modes
        # tied to single-query semantics keep first-record behavior.
        single_only = (
            align_k is not None or stream_chunk is not None
            or checkpoint is not None or print_seq or trace_dir is not None
        )
        if not single_only:
            try:
                from .utils.fasta import read_fasta

                it = read_fasta(file1)
                try:
                    next(it)
                    has_second = next(it, None) is not None
                finally:
                    it.close()  # release the file handle from the probe
            except (OSError, ValueError, StopIteration):
                has_second = False
            if has_second:
                all_queries = True
    if all_queries:
        return _run_multi(
            file1, file2, scoring, engine, lanes, topk, as_json, print_fasta,
            minscore=minscore, db_cache=db_cache,
        )
    if align_k is not None:
        return _run_align(
            file1, file2, scoring, engine, lanes, align_k, as_json,
            db_cache=db_cache,
        )

    if db_cache is not None and print_seq:
        # --printseq needs the original sequence strings, which the
        # encoded cache does not keep. Say so rather than silently
        # dropping the flag (a cache-only deployment would otherwise fail
        # confusingly here).
        sys.stderr.write(
            "Note: --db-cache is ignored with --printseq (it needs the "
            "FASTA's original sequence text).\n"
        )
        db_cache = None

    tracing = False
    if trace_dir is not None:
        try:
            import jax

            jax.profiler.start_trace(trace_dir)
            tracing = True
        except Exception as e:  # profiling is best-effort observability
            sys.stderr.write(f"Note: profiler unavailable ({e})\n")
    try:
        if stream_chunk is not None:
            from .pipeline import search_files_streaming

            result = search_files_streaming(
                file1, file2, scoring, engine=engine, lanes=lanes,
                chunk_records=stream_chunk, checkpoint_dir=checkpoint,
                db_cache=db_cache,
            )
        else:
            result = search_files(
                file1, file2, scoring, engine=engine, lanes=lanes,
                keep_seqs=print_seq, checkpoint_dir=checkpoint,
                db_cache=db_cache,
            )
    except ValueError as e:
        sys.stderr.write(str(e) + "\n")
        return 0  # reference prints the error and exits successfully
    finally:
        if tracing:
            try:
                import jax

                jax.profiler.stop_trace()
            except Exception:
                pass

    out = sys.stdout
    if as_json:
        import json

        order = range(result.total_entries)
        if topk is not None:
            import numpy as np

            order = list(np.argsort(-result.scores, kind="stable")[:topk])
        if minscore is not None:
            order = [k for k in order if result.scores[k] >= minscore]
        json.dump(
            {
                "query": result.query_name,
                "entries": [
                    {
                        "entry": int(k),
                        "name": result.names[k],
                        "score": int(result.scores[k]),
                    }
                    for k in order
                ],
                "total_time": result.kernel_time,
                "total_entries": result.total_entries,
                "entries_per_s": (
                    result.total_entries / result.kernel_time
                    if result.kernel_time
                    else None
                ),
            },
            out,
        )
        out.write("\n")
        return 0

    if print_fasta:
        out.write(result.query_name + "\n")
    if print_seq:
        out.write(result.query_seq + "\n")

    order = range(result.total_entries)
    if topk is not None:
        import numpy as np

        order = list(np.argsort(-result.scores, kind="stable")[:topk])
    if minscore is not None:
        order = [k for k in order if result.scores[k] >= minscore]
    for k in order:
        out.write(f"Entry #{k}:\n")
        if print_fasta:
            out.write(result.names[k] + "\n")
        if print_seq:
            out.write(result.seqs[k] + "\n")
        out.write(f"score: {int(result.scores[k])}\n\n")

    out.write(f"Total Time: {result.kernel_time:f}\n")
    out.write(f"Total Entries: {result.total_entries}\n")
    return 0


def _run_align(
    file1, file2, scoring, engine, lanes, k, as_json, db_cache=None
) -> int:
    """--align mode: score-only scan, then re-align the k best hits with a
    full traceback (the two-phase design the reference's north star asks
    for; the reference itself is score-only, SURVEY.md §0)."""
    from .ops.traceback import topk_alignments
    from .pipeline import _warn_padding, search_database
    from .utils.fasta import read_first
    from .utils.native_io import parse_file_cached

    try:
        query = read_first(file1)
        query_idx = scoring.query_indices(query.seq)
        _warn_padding(scoring, query_idx)
        db = parse_file_cached(file2, db_cache)
        scores, kernel_time = search_database(
            query_idx, db, scoring, engine=engine, lanes=lanes
        )
    except (ValueError, OSError) as e:
        sys.stderr.write(str(e) + "\n")
        return 0

    hits = topk_alignments(
        query_idx, db, scores, k, scoring.table,
        scoring.gap_open, scoring.gap_extend, query_str=query.seq,
    )
    out = sys.stdout
    if as_json:
        import json

        json.dump(
            {
                "query": query.name,
                "alignments": [
                    {
                        "entry": rec,
                        "name": db.names[rec],
                        "score": aln.score,
                        "query_start": aln.query_start,
                        "query_end": aln.query_end,
                        "db_start": aln.db_start,
                        "db_end": aln.db_end,
                        "query_aligned": aln.query_aligned,
                        "db_aligned": aln.db_aligned,
                        "cigar": aln.cigar,
                    }
                    for rec, aln in hits
                ],
                "total_time": kernel_time,
                "total_entries": db.n,
            },
            out,
        )
        out.write("\n")
        return 0
    for rec, aln in hits:
        out.write(f"Entry #{rec}:\n")
        if db.names[rec]:
            out.write(db.names[rec] + "\n")
        out.write(f"score: {aln.score}\n")
        out.write(
            f"query {aln.query_start}..{aln.query_end}  "
            f"db {aln.db_start}..{aln.db_end}  CIGAR {aln.cigar}\n"
        )
        out.write(aln.query_aligned + "\n")
        out.write(aln.db_aligned + "\n\n")
    out.write(f"Total Time: {kernel_time:f}\n")
    out.write(f"Total Entries: {db.n}\n")
    return 0


def _run_multihost(
    file1, file2, scoring, topk, minscore, as_json, hosts, host_id,
    coordinator,
    db_cache=None,
) -> int:
    """--hosts mode: this process joins a multi-host search as one worker.

    Every host reads its database stripe, scores it on its local chips, and
    the merged global result (identical on every host) is printed by host 0
    only. The cluster-scale replacement for the reference's OpenMP loop
    (src/alignment_cmdline.c:504-507).
    """
    from .parallel.multihost import multihost_search
    from .utils.fasta import read_first

    query = read_first(file1)
    query_idx = scoring.query_indices(query.seq)
    scores, kernel_time = multihost_search(
        query_idx, file2, scoring,
        coordinator_address=coordinator, num_processes=hosts,
        process_id=host_id, db_cache=db_cache,
    )
    if host_id != 0:
        return 0
    out = sys.stdout
    order = range(len(scores))
    if topk is not None:
        import numpy as np

        order = list(np.argsort(-scores, kind="stable")[:topk])
    if minscore is not None:
        order = [k for k in order if scores[k] >= minscore]
    if as_json:
        import json

        json.dump(
            {
                "query": query.name,
                "hosts": hosts,
                "entries": [
                    {"entry": int(k), "score": int(scores[k])} for k in order
                ],
                "total_time": kernel_time,
                "total_entries": len(scores),
            },
            out,
        )
        out.write("\n")
        return 0
    for k in order:
        out.write(f"Entry #{k}:\n")
        out.write(f"score: {int(scores[k])}\n\n")
    out.write(f"Total Time: {kernel_time:f}\n")
    out.write(f"Total Entries: {len(scores)}\n")
    return 0


def _run_multi(
    file1, file2, scoring, engine, lanes, topk, as_json, print_fasta,
    minscore=None, db_cache=None,
) -> int:
    """--all-queries mode: one block of entries per query record."""
    from .pipeline import search_files_multi

    try:
        result = search_files_multi(
            file1, file2, scoring, engine=engine, lanes=lanes,
            db_cache=db_cache,
        )
    except ValueError as e:
        sys.stderr.write(str(e) + "\n")
        return 0

    out = sys.stdout
    nq = len(result.query_names)

    def order_for(qi):
        order = range(result.total_entries)
        if topk is not None:
            import numpy as np

            order = list(np.argsort(-result.scores[qi], kind="stable")[:topk])
        if minscore is not None:
            order = [k for k in order if result.scores[qi, k] >= minscore]
        return order

    if as_json:
        import json

        json.dump(
            {
                "queries": [
                    {
                        "query": result.query_names[qi],
                        "entries": [
                            {
                                "entry": int(k),
                                "name": result.names[k],
                                "score": int(result.scores[qi, k]),
                            }
                            for k in order_for(qi)
                        ],
                    }
                    for qi in range(nq)
                ],
                "total_time": result.kernel_time,
                "total_entries": result.total_entries,
            },
            out,
        )
        out.write("\n")
        return 0

    for qi in range(nq):
        out.write(f"Query #{qi}: {result.query_names[qi]}\n")
        for k in order_for(qi):
            out.write(f"Entry #{k}:\n")
            if print_fasta:
                out.write(result.names[k] + "\n")
            out.write(f"score: {int(result.scores[qi, k])}\n\n")

    out.write(f"Total Time: {result.kernel_time:f}\n")
    out.write(f"Total Entries: {result.total_entries}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
