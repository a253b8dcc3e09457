"""Command-line interface mirroring the reference's flags and wiring
(Mapper.java:37-468,639-887).

Usage matches the reference jar:

    python -m mapper_tpu --reference ref.fasta --queries reads.fastq \
        --out-sam out.sam --out-vcf out.vcf [options]
"""

from __future__ import annotations

import os
import sys
import time

from mapper_tpu import basepairs
from mapper_tpu.align.cache import AlignmentCache
from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu.align.worker import AlignerWorker
from mapper_tpu.api import ReferenceIndex
from mapper_tpu.index.database import (
    HashBlockDatabase,
    choose_max_duplication_length,
    choose_min_duplication_length,
)
from mapper_tpu.index.dircache import DirCache
from mapper_tpu.index.duplication import DuplicationDetector
from mapper_tpu.io import fastx
from mapper_tpu.io.mutations import MutationDetectionParameters, MutationsWriter
from mapper_tpu.io.refcounts import ReferenceAlignmentCounter, UnalignedQueryWriter
from mapper_tpu.io.sam import SamWriter
from mapper_tpu.io.vcf import VcfWriter
from mapper_tpu.pileup import MatchDatabase
from mapper_tpu.providers import (
    PairedEndQueryProvider,
    QueriesIterator,
    SimpleQueryProvider,
    SequenceSplitter,
)
from mapper_tpu.sequence import SequenceDatabase, sort_and_complement
from mapper_tpu.stats import (
    AlignmentCounter,
    DisplayTable,
    IndelSummarizer,
    PenaltySummarizer,
    format_histogram_column,
)

DEFAULT_EXPECTED_PAIR_DISTANCE = 100
DEFAULT_SPACING_DEVIATION = 50
_INT_MAX = 2**31 - 1


def usage_error(message: str) -> None:
    print(message, file=sys.stderr)
    sys.exit(1)


def _parse_threshold_subflags(args: list[str], i: int, params: MutationDetectionParameters) -> int:
    """The context-sensitive --snp-threshold family binding to the preceding
    --out-vcf / --out-mutations (Mapper.java:149-239)."""
    while i < len(args):
        arg = args[i]
        if arg == "--snp-threshold":
            params.min_snp_total_depth = float(args[i + 1])
            params.min_snp_depth_fraction = float(args[i + 2])
            i += 3
        elif arg == "--indel-start-threshold":
            params.min_indel_total_start_depth = float(args[i + 1])
            params.min_indel_start_depth_fraction = float(args[i + 2])
            i += 3
        elif arg == "--indel-continue-threshold":
            params.min_indel_continuation_total_depth = float(args[i + 1])
            params.min_indel_continuation_depth_fraction = float(args[i + 2])
            i += 3
        elif arg == "--indel-threshold":
            params.min_indel_total_start_depth = float(args[i + 1])
            params.min_indel_continuation_total_depth = float(args[i + 1])
            params.min_indel_start_depth_fraction = float(args[i + 2])
            params.min_indel_continuation_depth_fraction = float(args[i + 2])
            i += 3
        else:
            break
    return i


class _PeekedQueries:
    """A QueryProvider view that re-serves one builder peeked off `inner`
    (used to learn the read shape for the device warmup without perturbing
    the stream order)."""

    def __init__(self, inner, first):
        self.inner = inner
        self._first = first

    def get_next_query_builder(self):
        if self._first is not None:
            first, self._first = self._first, None
            return first
        return self.inner.get_next_query_builder()

    def get_contains_paired_end_reads(self) -> bool:
        return self.inner.get_contains_paired_end_reads()

    def all_reads_contain_quality_information(self) -> bool:
        return self.inner.all_reads_contain_quality_information()

    def __iter__(self):
        while True:
            builder = self.get_next_query_builder()
            if builder is None:
                return
            yield builder


def main(argv: list[str] | None = None) -> int:
    start_time = time.time()
    args = list(sys.argv[1:] if argv is None else argv)

    reference_paths: list[str] = []
    query_providers = []
    cache_dir = None
    out_vcf_path = None
    out_sam_path = None
    out_unaligned_path = None
    out_ancestor_path = None
    enable_gapmers = True
    vcf_include_non_mutations = True
    vcf_show_support_read = True
    out_refs_map_count_path = None
    out_mutations_path = None
    mutation_filter = MutationDetectionParameters.default_filter()
    vcf_filter = MutationDetectionParameters.empty_filter()
    allow_no_output = False
    allow_duplicate_contig_names = False
    guess_reference_ancestors = False
    verify_consistent_database = False

    mutation_penalty = -1.0
    indel_start_penalty = 1.5
    indel_extension_penalty = 0.5
    additional_insertion_extension_penalty = -1.0
    max_error_rate = -1.0
    ambiguity_penalty = -1.0
    max_num_matches = None
    max_penalty_span = -1.0
    num_threads = 1
    query_end_fraction = 0.1
    split_queries_past_size = -1
    has_paired_without_spacing = False
    engine = "batch"  # "batch" = device pipeline with exact fallback; "exact" = sequential
    num_devices = "auto"  # "auto" = all visible chips; N = first N devices
    alignment_verbosity = 0
    reference_verbosity = 0
    auto_verbose = False
    num_processes = 1
    process_id = 0
    coordinator = None

    i = 0
    while i < len(args):
        arg = args[i]
        if arg == "--reference":
            reference_paths.append(args[i + 1])
            i += 2
        elif arg == "--queries":
            provider = fastx.load_from(args[i + 1], keep_quality=True)
            if split_queries_past_size > 0:
                provider = SequenceSplitter(split_queries_past_size, provider)
            query_providers.append(SimpleQueryProvider(provider))
            i += 2
        elif arg == "--paired-queries":
            if split_queries_past_size > 0:
                usage_error("--paired-queries is not supported with --split-queries-past-size")
            lefts = fastx.load_from(args[i + 1], keep_quality=True)
            rights = fastx.load_from(args[i + 2], keep_quality=True)
            i += 3
            expected = DEFAULT_EXPECTED_PAIR_DISTANCE
            deviation = DEFAULT_SPACING_DEVIATION
            if i < len(args) and args[i] == "--spacing":
                expected = float(args[i + 1])
                deviation = float(args[i + 2])
                i += 3
            else:
                has_paired_without_spacing = True
            query_providers.append(PairedEndQueryProvider(lefts, rights, expected, deviation))
        elif arg == "--cache-dir":
            cache_dir = args[i + 1]
            i += 2
        elif arg == "--split-queries-past-size":
            if query_providers:
                usage_error("--split-queries-past-size is only supported before --queries")
            split_queries_past_size = int(args[i + 1])
            i += 2
        elif arg == "--out-vcf":
            out_vcf_path = args[i + 1]
            i = _parse_threshold_subflags(args, i + 2, vcf_filter)
        elif arg == "--out-mutations":
            out_mutations_path = args[i + 1]
            i = _parse_threshold_subflags(args, i + 2, mutation_filter)
        elif arg == "--out-sam":
            out_sam_path = args[i + 1]
            i += 2
        elif arg == "--out-unaligned":
            out_unaligned_path = args[i + 1]
            i += 2
        elif arg == "--out-refs-map-count":
            out_refs_map_count_path = args[i + 1]
            i += 2
        elif arg == "--out-ancestor":
            out_ancestor_path = args[i + 1]
            i += 2
        elif arg == "--no-gapmers":
            enable_gapmers = False
            i += 1
        elif arg == "--verify-consistent-db":
            verify_consistent_database = True
            i += 1
        elif arg == "--no-output":
            allow_no_output = True
            i += 1
        elif arg == "--allow-duplicate-contig-names":
            allow_duplicate_contig_names = True
            i += 1
        elif arg in ("--verbose", "-v"):
            # verbosity semantics per Mapper.java:261-281
            alignment_verbosity = max(alignment_verbosity, 1)
            i += 1
        elif arg == "--verbose-alignment":
            alignment_verbosity = max(alignment_verbosity, _INT_MAX)
            i += 1
        elif arg == "--verbose-reference":
            reference_verbosity = max(reference_verbosity, 1)
            i += 1
        elif arg == "-vv":
            alignment_verbosity = max(alignment_verbosity, _INT_MAX)
            reference_verbosity = max(reference_verbosity, 1)
            i += 1
        elif arg == "--verbosity-auto":
            auto_verbose = True
            i += 1
        elif arg == "--new-indel-penalty":
            indel_start_penalty = float(args[i + 1])
            i += 2
        elif arg == "--extend-indel-penalty":
            indel_extension_penalty = float(args[i + 1])
            i += 2
        elif arg == "--additional-extend-insertion-penalty":
            additional_insertion_extension_penalty = float(args[i + 1])
            i += 2
        elif arg == "--snp-penalty":
            mutation_penalty = float(args[i + 1])
            if mutation_penalty <= 0:
                usage_error("--snp-penalty must be > 0")
            i += 2
        elif arg == "--max-penalty":
            max_error_rate = float(args[i + 1])
            if max_error_rate < 0:
                usage_error("--max-penalty must be >= 0")
            i += 2
        elif arg == "--max-penalty-span":
            max_penalty_span = float(args[i + 1])
            if max_penalty_span < 0:
                usage_error("--max-penalty-span must be >= 0")
            i += 2
        elif arg == "--ambiguity-penalty":
            ambiguity_penalty = float(args[i + 1])
            if ambiguity_penalty < 0:
                usage_error("--ambiguity-penalty must be >= 0")
            i += 2
        elif arg == "--max-num-matches":
            max_num_matches = int(args[i + 1])
            if max_num_matches < 1:
                usage_error("--max-num-matches must be >= 1")
            i += 2
        elif arg == "--num-threads":
            num_threads = int(args[i + 1])
            i += 2
        elif arg == "--num-processes":
            # multi-process / multi-host data parallelism: each process
            # aligns a round-robin share of the query stream and process 0
            # merges outputs in exact 1-process order (parallel/multihost.py)
            num_processes = int(args[i + 1])
            if num_processes < 1:
                usage_error("--num-processes must be >= 1")
            i += 2
        elif arg == "--process-id":
            process_id = int(args[i + 1])
            i += 2
        elif arg == "--coordinator":
            coordinator = args[i + 1]
            i += 2
        elif arg == "--devices":
            # the device analog of --num-threads: shard candidate scoring
            # over a data mesh of N chips (the reference's scale knob is N
            # worker threads, Mapper.java:154,640)
            if args[i + 1] != "auto":
                num_devices = int(args[i + 1])
                if num_devices < 1:
                    usage_error("--devices must be >= 1 or 'auto'")
            i += 2
        elif arg == "--engine":
            engine = args[i + 1]
            if engine not in ("batch", "exact"):
                usage_error("--engine must be 'batch' or 'exact'")
            i += 2
        elif arg == "--distinguish-query-ends":
            query_end_fraction = float(args[i + 1])
            i += 2
        elif arg == "--vcf-exclude-non-mutations":
            vcf_include_non_mutations = False
            i += 1
        elif arg == "--vcf-omit-support-reads":
            vcf_show_support_read = False
            i += 1
        elif arg == "--infer-ancestors":
            guess_reference_ancestors = True
            i += 1
        elif arg == "--no-infer-ancestors":
            guess_reference_ancestors = False
            i += 1
        elif arg == "--help":
            print(__doc__)
            return 0
        elif arg == "--version":
            from mapper_tpu import __version__

            print("mapper_tpu version " + __version__)
            if len(args) == 1:
                return 0
            i += 1
        else:
            usage_error(f"Unrecognized argument: {arg}")

    if not reference_paths:
        usage_error("--reference is required")
    if not query_providers:
        usage_error("--queries or --paired-queries is required")
    if (
        out_vcf_path is None
        and out_sam_path is None
        and out_refs_map_count_path is None
        and out_unaligned_path is None
        and out_mutations_path is None
        and not allow_no_output
    ):
        usage_error("No output specified. Try --out-vcf <path>, or --no-output")
    if max_error_rate >= 0 and mutation_penalty >= 0 and has_paired_without_spacing:
        usage_error(
            "Customized penalties with paired queries require explicit --spacing"
        )

    if max_error_rate < 0:
        max_error_rate = 0.1
    if mutation_penalty <= 0:
        mutation_penalty = 1.0
    if query_end_fraction < 0 or query_end_fraction >= 1:
        usage_error("--distinguish-query-ends must be >= 0 and < 1")

    parameters = AlignmentParameters.defaults(
        mutation_penalty=mutation_penalty,
        indel_start_penalty=indel_start_penalty,
        indel_extension_penalty=indel_extension_penalty,
        additional_insertion_extension_penalty=(
            None
            if additional_insertion_extension_penalty < 0
            else additional_insertion_extension_penalty
        ),
        max_error_rate=max_error_rate,
        ambiguity_penalty=None if ambiguity_penalty < 0 else ambiguity_penalty,
        max_num_matches=max_num_matches,
        max_penalty_span=None if max_penalty_span < 0 else max_penalty_span,
    )

    if not (0 <= process_id < num_processes):
        usage_error("--process-id must be in [0, --num-processes)")

    return run(
        engine=engine,
        num_devices=num_devices,
        num_processes=num_processes,
        process_id=process_id,
        coordinator=coordinator,
        alignment_verbosity=alignment_verbosity,
        reference_verbosity=reference_verbosity,
        auto_verbose=auto_verbose,
        reference_paths=reference_paths,
        query_providers=query_providers,
        cache_dir=cache_dir,
        allow_duplicate_contig_names=allow_duplicate_contig_names,
        out_vcf_path=out_vcf_path,
        vcf_include_non_mutations=vcf_include_non_mutations,
        vcf_show_support_read=vcf_show_support_read,
        out_sam_path=out_sam_path,
        out_refs_map_count_path=out_refs_map_count_path,
        out_mutations_path=out_mutations_path,
        mutation_filter=mutation_filter,
        vcf_filter=vcf_filter,
        out_unaligned_path=out_unaligned_path,
        parameters=parameters,
        num_threads=num_threads,
        query_end_fraction=query_end_fraction,
        guess_reference_ancestors=guess_reference_ancestors,
        out_ancestor_path=out_ancestor_path,
        enable_gapmers=enable_gapmers,
        verify_consistent_database=verify_consistent_database,
        start_time=start_time,
    )


def run(
    reference_paths,
    query_providers,
    engine,
    cache_dir,
    allow_duplicate_contig_names,
    out_vcf_path,
    vcf_include_non_mutations,
    vcf_show_support_read,
    out_sam_path,
    out_refs_map_count_path,
    out_mutations_path,
    mutation_filter,
    vcf_filter,
    out_unaligned_path,
    parameters,
    num_threads,
    query_end_fraction,
    guess_reference_ancestors,
    out_ancestor_path,
    enable_gapmers,
    verify_consistent_database,
    start_time,
    num_devices="auto",
    num_processes=1,
    process_id=0,
    coordinator=None,
    alignment_verbosity=0,
    reference_verbosity=0,
    auto_verbose=False,
) -> int:
    from mapper_tpu.logging import BufferedWriter, Logger, StderrWriter

    log = lambda message: print(message, file=sys.stderr)
    stderr_writer = StderrWriter()
    reference_logger = Logger(stderr_writer, 0, reference_verbosity)

    distributed = num_processes > 1
    if distributed:
        from mapper_tpu.parallel import multihost

        log(f"Process {process_id}/{num_processes} (round-robin query sharding)")
        # without a coordinator the processes share this host's filesystem
        # barrier, so they share its cards too
        try:
            card = multihost.card_for_process(
                process_id, num_processes, multihost.local_card_count(),
                single_host=not coordinator,
            )
        except ValueError as e:
            usage_error(str(e))
        if coordinator:
            multihost.initialize(coordinator, num_processes, process_id, card)
        else:
            multihost.bind_card(card)

    def shard_path(base: str, k: int) -> str:
        return f"{base}.shard{k}"
    log("Loading reference")
    reference_provider = fastx.load_from(reference_paths, keep_quality=False)
    sorted_reference = sort_and_complement(b.build() for b in reference_provider)
    sequence_database = SequenceDatabase(sorted_reference)
    if not allow_duplicate_contig_names:
        duplicates = sequence_database.get_duplicate_names()
        if duplicates:
            log(
                f" Warning: {len(duplicates)} contig names appear multiple times, "
                f"including {duplicates[0]}. Add --allow-duplicate-contig-names to continue"
            )
            return 1

    queries = QueriesIterator(query_providers)
    scoring_warmup = None
    # single-chip native window scoring never touches the device, so the
    # warmup thread skips the reference upload + scoring-program compile for
    # such runs.  The decision needs jax.devices(), so the warmup thread
    # makes the call (backend initialization stays off the main thread).
    # An explicit --devices N>1 or MAPPER_TPU_HOST_SCORING=0 keeps the
    # device warmup.
    host_scoring = os.environ.get("MAPPER_TPU_HOST_SCORING", "1") != "0"
    if host_scoring and num_devices != "auto" and num_devices > 1:
        host_scoring = False  # explicit multi-device run: mesh scoring
    if host_scoring:
        from mapper_tpu.native import get_library

        host_scoring = get_library() is not None
    if engine == "batch":
        # peek the first query's shape and start the one-time device costs
        # (reference upload + scoring-program compile) on a background
        # thread now, overlapping the index build and query parsing
        peeked = queries.get_next_query_builder()
        if peeked is not None:
            queries = _PeekedQueries(queries, peeked)
            from mapper_tpu.batch.engine import host_scoring_max_len, start_scoring_warmup

            # the splitter already applied: peeked builders carry the
            # engine-visible (post-split) lengths
            peek_len = max(b.get_length() for b in peeked.builders)
            scoring_warmup = start_scoring_warmup(
                sequence_database,
                parameters,
                peek_len,
                paired=len(peeked.builders) == 2,
                # long reads keep the device path (engine gate mirrors this)
                skip_single_device=host_scoring and peek_len <= host_scoring_max_len(),
            )

    dir_cache = DirCache(cache_dir) if cache_dir else None
    min_dup = choose_min_duplication_length(sequence_database)
    max_dup = choose_max_duplication_length(sequence_database)

    if guess_reference_ancestors:
        from mapper_tpu.index.ancestry import AncestryDetector

        original_db = HashBlockDatabase(
            sequence_database,
            min_interesting_size=min_dup,
            hint_max_interesting_size=max_dup,
            max_num_short_matches=8,
            enable_gapmers=enable_gapmers,
            cache_dir=dir_cache,
            logger=reference_logger,
        )
        if verify_consistent_database:
            original_db.verify_matches(
                HashBlockDatabase(
                    sequence_database,
                    min_interesting_size=min_dup,
                    hint_max_interesting_size=max_dup,
                    max_num_short_matches=8,
                    enable_gapmers=enable_gapmers,
                )
            )
        ancestry_dups = DuplicationDetector(
            original_db, min_dup, max_dup, min_num_interesting_copies=3, window_size=1
        )
        dissimilarity = parameters.max_error_rate / parameters.mutation_penalty
        provider = AncestryDetector(
            ancestry_dups, sorted_reference, dissimilarity, out_ancestor_path
        )
        hashblock_database = provider.get_hashblock_database()
        reference_index = ReferenceIndex(sequence_database, hashblock_database, None)
        reference_index.get_original_sequence = provider.get_original_sequence
    else:
        hashblock_database = HashBlockDatabase(
            sequence_database,
            hint_max_interesting_size=max_dup,
            enable_gapmers=enable_gapmers,
            cache_dir=dir_cache,
            logger=reference_logger,
        )
        if verify_consistent_database:
            log("Verifying database consistency (double build)")
            hashblock_database.verify_matches(
                HashBlockDatabase(
                    sequence_database,
                    hint_max_interesting_size=max_dup,
                    enable_gapmers=enable_gapmers,
                )
            )
        reference_index = ReferenceIndex(sequence_database, hashblock_database, None)

    if os.environ.get("MAPPER_TPU_TRACE") == "1":
        log(f"[cli] reference index ready: {time.time() - start_time:.1f}s")
    approximate_dups = DuplicationDetector(
        hashblock_database,
        min_dup,
        max_dup,
        min_num_interesting_copies=2,
        window_size=1000,
    )
    reference_index.duplication_detector = approximate_dups
    # run the hash-bin duplication scan on a background thread: it overlaps
    # query-provider setup and the backend initialization the engine
    # creation blocks on; the batch loop joins it
    # before the first alignment (no lazy-init races)
    import threading as _threading

    dup_thread = _threading.Thread(
        target=approximate_dups.ensure_detected, daemon=True
    )
    dup_thread.start()

    listeners = []
    match_database = MatchDatabase(query_end_fraction)
    match_database.set_contig_order(sequence_database.get_all())
    refs_counter = ReferenceAlignmentCounter()
    if out_refs_map_count_path is not None:
        listeners.append(refs_counter)
    match_counter = AlignmentCounter()
    if out_vcf_path is not None or out_mutations_path is not None:
        listeners.append(match_database)
    penalty_summarizer = PenaltySummarizer(parameters)
    listeners.append(penalty_summarizer)
    indel_summarizer = IndelSummarizer()
    listeners.append(indel_summarizer)
    sam_writer = None
    sam_stream = None
    sam_shard = None
    if out_sam_path is not None:
        contains_paired = queries.get_contains_paired_end_reads()
        if distributed:
            from mapper_tpu.parallel.multihost import ShardedResultWriter

            sam_shard = ShardedResultWriter(
                lambda stream: SamWriter(sequence_database, stream, contains_paired)
            )
            listeners.append(sam_shard)
        else:
            sam_stream = sys.stdout if out_sam_path == "-" else open(out_sam_path, "wt")
            sam_writer = SamWriter(sequence_database, sam_stream, contains_paired)
            listeners.append(sam_writer)
    unaligned_writer = None
    if out_unaligned_path is not None:
        unaligned_path = (
            shard_path(out_unaligned_path, process_id)
            if distributed
            else out_unaligned_path
        )
        unaligned_writer = UnalignedQueryWriter(
            unaligned_path, queries.all_reads_contain_quality_information()
        )
        listeners.append(unaligned_writer)
    listeners.append(match_counter)

    if distributed:
        from mapper_tpu.parallel.multihost import RoundRobinQueries

        queries = RoundRobinQueries(queries, process_id, num_processes)

    cache = AlignmentCache()
    worker = AlignerWorker(reference_index, parameters, listeners, cache)
    if engine == "batch":
        from mapper_tpu.batch.engine import BatchAligner

        mesh = None
        import jax

        available = jax.devices()
        if num_devices == "auto":
            use_devices = available if len(available) > 1 else []
        else:
            if num_devices > len(available):
                usage_error(
                    f"--devices {num_devices} requested but only "
                    f"{len(available)} visible ({jax.default_backend()} backend)"
                )
            use_devices = available[:num_devices] if num_devices > 1 else []
        if use_devices:
            from mapper_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(use_devices)
            log(f"Sharding candidate scoring over {len(use_devices)} devices")
        engine_obj = BatchAligner(
            reference_index, parameters, listeners=listeners, mesh=mesh
        )
        if (
            scoring_warmup is not None
            and scoring_warmup.concat_dev is not None
            and mesh is None
            # the ancestral engine aligns against the overridden sequences —
            # same shapes (so the warmed program is reused) but different
            # bytes, so its buffer must not be adopted
            and not guess_reference_ancestors
        ):
            # adopt the warmup's uploaded reference buffer (same seq_db, same
            # bytes) instead of paying a second multi-MB H2D transfer
            engine_obj._concat_dev = scoring_warmup.concat_dev
        engine_obj.fallback_worker = AlignerWorker(reference_index, parameters)
        # the engine probes/stores the cache at chunk intake (covering the
        # batch fast path, not just worker fallbacks); the inner worker runs
        # cache-less so hits/stores are not double-counted
        engine_obj.cache = cache
        worker_stats = engine_obj.fallback_worker.stats
        # device-side pileup (opt-in): clean emissions scatter-add on the
        # device per chunk (SURVEY §2.2; Mapper.java:760-784).  The host
        # differential accumulation in pileup.py::_flush_fast (O(endpoints +
        # mismatches) per read) is the production default.
        if (
            os.environ.get("MAPPER_TPU_DEVICE_PILEUP") == "1"
            and (out_vcf_path is not None or out_mutations_path is not None)
            and not guess_reference_ancestors
        ):
            from mapper_tpu.batch.device_pileup import DevicePileup

            try:
                engine_obj.device_pileup = DevicePileup(
                    sequence_database, query_end_fraction, mesh=mesh
                )
            except ValueError:
                pass  # reference too large for int32 device pileup
    else:
        engine_obj = worker
        worker_stats = worker.stats

    num_loaded = 0
    batch: list = []
    batch_bases = 0
    # the reference batches 50 kb per worker thread (Mapper.java:926); the
    # batch engine amortizes per-launch cost over much larger batches and
    # pipelines two batches so host candidate generation overlaps device
    # scoring (numpy and device waits release the GIL)
    max_bases_per_batch = 2_000_000 if engine == "batch" else 50_000
    last_report = 0.0

    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if reference_index.duplication_detector is not None:
        dup_thread.join()  # detection complete before any worker consults it

    # --num-threads scales the number of batches in flight (the reference's
    # worker-count knob, Mapper.java:154); two is the floor so host candidate
    # generation always overlaps device scoring
    pool_workers = max(2, min(int(num_threads), 16))
    pool = ThreadPoolExecutor(max_workers=pool_workers)
    pending: deque = deque()

    # verbose alignment tracing: each chunk logs into a BufferedWriter
    # replayed under a header after the chunk completes (the reference's
    # per-worker buffered log replay, Mapper.java:1014-1019); verbose runs
    # process chunks serially so the shared engine logger cannot race
    verbose_alignment = alignment_verbosity > 0 or auto_verbose
    chunk_counter = 0

    def submit_batch(chunk_batch) -> None:
        nonlocal chunk_counter
        writer = None
        if verbose_alignment:
            writer = BufferedWriter(
                stderr_writer, f"\nOutput from chunk {chunk_counter}:", 100000
            )
            verbosity = alignment_verbosity
            if auto_verbose and chunk_counter == 0:
                verbosity = max(verbosity, _INT_MAX)
            chunk_logger = Logger(writer, 0, verbosity)
            if engine == "batch":
                engine_obj.logger = chunk_logger
                engine_obj.fallback_worker.set_logger(chunk_logger)
            else:
                engine_obj.set_logger(chunk_logger)
        chunk_counter += 1
        pending.append(
            (pool.submit(engine_obj.process_batch, chunk_batch, notify=False), writer)
        )

    def drain(limit: int) -> None:
        nonlocal last_report
        while len(pending) > limit:
            future, writer = pending.popleft()
            results = future.result()
            if writer is not None:
                writer.flush()
            for listener in listeners:
                listener.add_alignments(results)
            now = time.time()
            if now - last_report >= 1.0:
                elapsed = now - start_time
                rate = num_loaded / elapsed if elapsed > 0 else 0
                log(f"Processing query {num_loaded} at {elapsed:.0f}s ({rate:.0f} q/s)")
                last_report = now

    for query_builder in queries:
        num_loaded += 1
        if not distributed:  # RoundRobinQueries already set the global id
            query_builder.set_id(num_loaded)
        batch.append(query_builder.build())
        batch_bases += batch[-1].get_length()
        if batch_bases >= max_bases_per_batch:
            submit_batch(batch)
            batch, batch_bases = [], 0
            # verbose runs serialize chunks (shared chunk logger); otherwise
            # keep at most two batches in flight
            drain(0 if verbose_alignment else pool_workers - 1)
    if batch:
        submit_batch(batch)
    drain(0)
    pool.shutdown()
    log(f"Aligned {num_loaded} queries at {time.time() - start_time:.0f}s")

    # --- outputs ---------------------------------------------------------

    if getattr(engine_obj, "device_pileup", None) is not None:
        engine_obj.device_pileup.merge_into(match_database)

    needs_pileup = out_vcf_path is not None or out_mutations_path is not None
    if distributed:
        # cross-process merge (parallel/multihost.py): every process saves its
        # shards + a done marker; process 0 waits and merges in global order
        from mapper_tpu.parallel import multihost

        if sam_shard is not None:
            sam_shard.save_shard(shard_path(out_sam_path, process_id) + ".pkl")
        if needs_pileup and process_id != 0:
            base = out_vcf_path or out_mutations_path
            multihost.save_pileup_shard(
                match_database, shard_path(base, process_id) + ".pkl"
            )
        marker_base = out_sam_path or out_vcf_path or out_mutations_path or out_unaligned_path
        if marker_base is not None:
            with open(shard_path(marker_base, process_id) + ".done", "w") as f:
                f.write("done\n")
        if coordinator:
            multihost.barrier("mapper_tpu_outputs")
        if process_id != 0:
            log(f"Process {process_id} done (shards saved; process 0 merges)")
            if unaligned_writer is not None:
                unaligned_writer.close()
            return 0
        # process 0: wait for every shard, then merge
        if marker_base is not None:
            multihost.wait_for_files(
                [shard_path(marker_base, k) + ".done" for k in range(1, num_processes)]
            )
        if sam_shard is not None:
            sam_stream = (
                sys.stdout if out_sam_path == "-" else open(out_sam_path, "wt")
            )
            multihost.merge_sam_shards(
                [shard_path(out_sam_path, k) + ".pkl" for k in range(num_processes)],
                sam_stream,
            )
        if needs_pileup:
            base = out_vcf_path or out_mutations_path
            multihost.merge_pileup_shards(
                match_database,
                [shard_path(base, k) + ".pkl" for k in range(1, num_processes)],
            )

    if out_refs_map_count_path is not None:
        refs_counter.sum_alignments(out_refs_map_count_path)
        log(f"Saved {out_refs_map_count_path}")
    display_coverage = None
    if out_vcf_path is not None:
        t_pileup = time.time()
        pileups = match_database.group_by_position()
        writer = VcfWriter(out_vcf_path, vcf_include_non_mutations, vcf_filter, vcf_show_support_read)
        writer.write(pileups, num_threads)
        log(
            f"Saved {out_vcf_path}"
            f" (pileup+write {time.time() - t_pileup:.0f}s)"
        )
        matched = writer.get_num_reference_positions_matched()
        total = sequence_database.get_total_forward_size()
        coverage = matched / total if total else 0.0
        text = f"{int(coverage * 100)}%"
        if text == "0%" and coverage > 0:
            text = "<1%"
        display_coverage = (
            f" Coverage                      : {text} of the reference ({matched}/{total}) was matched"
        )
    if out_mutations_path is not None:
        pileups = match_database.group_by_position()
        writer = MutationsWriter(out_mutations_path, mutation_filter)
        writer.write(pileups, num_threads)
        log(f"Saved {out_mutations_path}")

    # --- statistics block (Mapper.java:786-869) ---------------------------

    log("")
    log("Statistics: ")
    if match_counter.get_distance_weight() > 0:
        log(
            f" Query pair separation distance: avg: {match_counter.get_distance_mean():.1f}"
            f" stddev: {match_counter.get_distance_stddev():.1f} (adjust via --spacing)"
        )
    num_queries = match_counter.num_queries
    num_aligned = match_counter.num_aligned_queries
    percent = num_aligned * 100 // num_queries if num_queries else 0
    log(f" Alignment rate                : {percent}% of queries ({num_aligned}/{num_queries})")
    if display_coverage:
        log(display_coverage)
    total_len = match_counter.total_aligned_query_length
    total_pen = match_counter.total_aligned_penalty
    avg = total_pen / total_len if total_len else 0.0
    log(
        f" Average penalty               : {avg:.4g} per base ({int(total_pen)}/{int(total_len)}) in aligned queries"
    )
    num_indels = sum(indel_summarizer.extension_counts)
    indels_per_base = num_indels / total_len if total_len else 0.0
    log(
        f" Num indels                    : {indels_per_base:.4g} per base ({num_indels}/{int(total_len)}) in aligned queries"
    )
    table = DisplayTable()
    table.add_short_column(" ")
    table.add_column(
        format_histogram_column(
            "Alignment Penalties Graph:",
            "Count",
            "Penalty/Basepair",
            0,
            parameters.max_error_rate,
            20,
            penalty_summarizer.get_counts(),
        )
    )
    table.add_short_column(" ")
    indel_counts = indel_summarizer.get_interesting_indel_length_counts()
    table.add_column(
        format_histogram_column(
            "Indel Lengths Graph:",
            "Count",
            "Length",
            0,
            len(indel_counts) + 1,
            20,
            indel_counts,
        )
    )
    log(table.format())
    # fast-path fraction (Mapper.java:843-845): batch-resolved queries plus
    # the exact worker's optimistic immediate accepts
    num_immediate = worker_stats.num_immediately_accepted + getattr(
        engine_obj, "stats_batch_resolved", 0
    )
    log(
        f" Immediately accepted          : "
        f"{num_immediate * 100 // max(1, num_queries)}% alignments "
        f"({num_immediate}/{num_queries})"
    )
    log(
        f" Alignment cache usage         : {worker_stats.num_cache_hits} loaded, "
        f"{cache.get_usage()} stored, {worker_stats.num_cache_skips} skipped"
    )
    if worker_stats.query_at_random_moment is not None:
        # Mapper.java:835-837
        q = worker_stats.query_at_random_moment
        log(f" Query at random moment: #{q.get_id()} : {q.format()}")
    if worker_stats.slowest_query_name is not None:
        # reference: per-worker slowest-query timers (AlignerWorker.java:58-71)
        log(
            f" Slowest query                 : {worker_stats.slowest_query_name} took "
            f"{worker_stats.slowest_query_seconds * 1000:.0f}ms "
            f"({worker_stats.slowest_query_num_alignments} alignments)"
        )
    try:
        import resource

        # ru_maxrss is KiB on Linux; the reference prints post-GC heap usage
        # (Mapper.java:812-820) — peak RSS is the closest process-level analog
        peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        log(f" Ending memory usage           : {peak_mb:.0f}mb peak RSS")
    except Exception:
        pass

    if sam_stream is not None and sam_stream is not sys.stdout:
        sam_stream.close()
    if unaligned_writer is not None:
        unaligned_writer.close()
    log("")
    log(f"Done in {time.time() - start_time:.1f}s.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
