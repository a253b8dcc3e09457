"""Broad randomized agreement test between the batch engine and the sequential
engine: SNPs, indels, reverse strand, ambiguous bases, unalignable reads."""

import numpy as np
import pytest

from mapper_tpu import Api, AlignmentParameters, basepairs
from mapper_tpu.align.query import Query
from mapper_tpu.align.worker import AlignerWorker
from mapper_tpu.batch.engine import BatchAligner
from mapper_tpu.sequence import Sequence


def random_text(n, rng):
    return "".join(rng.choice(list("ACGT"), size=n))


def summarize(result):
    out = []
    for choice in result.get_first_alignments():
        comp = choice.get_component(0)
        out.append(
            (
                comp.get_sequence_b().name,
                comp.get_start_index_b(),
                comp.is_reference_reversed(),
                round(choice.get_penalty(), 6),
                tuple(
                    (s.start_a, s.start_b, s.length_a, s.length_b)
                    for s in comp.sections
                ),
            )
        )
    return sorted(out)


def test_randomized_engine_agreement():
    rng = np.random.default_rng(777)
    ref_text = random_text(30000, rng)
    index = Api.new_database({"chrA": ref_text[:18000], "chrB": ref_text[18000:]})
    params = AlignmentParameters.defaults()

    reads = []
    for i in range(60):
        contig_start = 0 if rng.random() < 0.6 else 18000
        contig_len = 18000 if contig_start == 0 else 12000
        pos = int(rng.integers(0, contig_len - 200))
        length = int(rng.integers(120, 180))
        read = list(ref_text[contig_start + pos : contig_start + pos + length])
        kind = rng.random()
        if kind < 0.5:
            for _ in range(int(rng.integers(0, 3))):
                j = int(rng.integers(0, len(read)))
                read[j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[read[j]]
        elif kind < 0.65:
            j = int(rng.integers(10, len(read) - 10))
            del read[j : j + int(rng.integers(1, 3))]
        elif kind < 0.75:
            j = int(rng.integers(10, len(read) - 10))
            read.insert(j, str(rng.choice(list("ACGT"))))
        elif kind < 0.85:
            j = int(rng.integers(0, len(read)))
            read[j] = "N"
        else:
            read = list(random_text(length, rng))  # unalignable
        text = "".join(read)
        if rng.random() < 0.5:
            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append(Sequence.from_text(f"r{i}", text))

    sequential = AlignerWorker(index, params)
    engine = BatchAligner(index, params)
    batch_results = engine.process_batch([Query(r) for r in reads])
    mismatches = []
    for i, read in enumerate(reads):
        expected = summarize(sequential.align(Query(read)))
        got = summarize(batch_results[i])
        if got != expected:
            mismatches.append((i, got, expected))
    assert not mismatches, mismatches[:3]


def test_wide_band_indel_read_matches_exact_engine():
    """A read whose indel budget exceeds the banded window (length 400 ->
    max_indel 77 > band//2 = 64) carrying a 70bp deletion near its tail: the
    full-length ungapped placement can be viable (tail mismatches within
    budget) while the exact engine finds the far cheaper out-of-band deletion.
    The batch engine must defer such reads to the exact worker (the wide-band
    gate) rather than emit the ungapped placement."""
    rng = np.random.default_rng(31)
    n = 4000
    ref_list = list(random_text(n, rng))
    # read = ref[100:447] + ref[517:570]  (70bp deletion at read offset 347)
    # craft the skipped-over region so the ungapped tail stays within budget:
    # make ref[447:500] agree with ref[517:570] except at 30 positions
    tail_src = ref_list[517:570]
    ref_list[447:500] = list(tail_src)
    mism_positions = rng.choice(53, size=39, replace=False)
    for j in mism_positions:
        old = ref_list[447 + j]
        ref_list[447 + j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[old]
    ref_text = "".join(ref_list)
    read_text = ref_text[100:447] + ref_text[517:570]
    assert len(read_text) == 400

    index = Api.new_database({"chr": ref_text})
    params = AlignmentParameters.defaults()
    query = Query(Sequence.from_text("wide", read_text))

    exact = AlignerWorker(index, params).align(query)
    engine = BatchAligner(index, params)
    batch = engine.process_batch([Query(Sequence.from_text("wide", read_text))])[0]
    assert summarize(batch) == summarize(exact)
    # scenario sanity: the winning alignment is the deletion (penalty 36.5),
    # not the viable-but-worse ungapped placement (39 mismatches <= budget 40)
    assert any(
        any(s.length_a != s.length_b for s in choice.get_component(0).sections)
        for choice in batch.get_first_alignments()
    )


def test_long_read_agreement():
    """Split-length reads (~1400bp, the --split-queries-past-size regime) ride
    the batch path; SNP-only, indel-carrying, reverse-strand, and unalignable
    long reads must agree with the exact worker."""
    rng = np.random.default_rng(99)
    ref_text = random_text(60000, rng)
    index = Api.new_database({"chr": ref_text})
    params = AlignmentParameters.defaults()
    worker = AlignerWorker(index, params)
    engine = BatchAligner(index, params)

    reads = []
    for i in range(24):
        pos = int(rng.integers(0, 60000 - 1500))
        text = list(ref_text[pos : pos + 1400])
        kind = i % 4
        if kind == 0:  # spread SNPs (sound under the wide-band gate)
            for j in rng.choice(1400, size=12, replace=False):
                text[j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[text[j]]
        elif kind == 1:  # deletion of 40 (in-band for band 128)
            text = list(ref_text[pos : pos + 700]) + list(
                ref_text[pos + 740 : pos + 1440]
            )
        elif kind == 2:  # dense mutated tail (falls back via gate or banded)
            for j in range(1300, 1400):
                if rng.random() < 0.6:
                    text[j] = {"A": "C", "C": "G", "G": "T", "T": "A"}[text[j]]
        else:  # random (unalignable)
            text = list(random_text(1400, rng))
        s = "".join(text)
        if rng.random() < 0.5:
            s = basepairs.decode(basepairs.reverse_complement(basepairs.encode(s)))
        reads.append(s)

    queries = [Query(Sequence.from_text(f"L{i}", s)) for i, s in enumerate(reads)]
    batch_results = engine.process_batch(
        [Query(Sequence.from_text(f"L{i}", s)) for i, s in enumerate(reads)]
    )
    for i, q in enumerate(queries):
        exact = worker.align(q)
        assert summarize(batch_results[i]) == summarize(exact), i


def test_agreement_fuzz_large():
    """Large randomized agreement fuzz (VERDICT r2 item 5): thousands of
    reads with SNPs, indels, N bases, RC and unalignable junk through both
    engines; every summarized alignment set must match.  CI runs 2500 reads;
    set MAPPER_TPU_FUZZ_N=10000 for the full sweep."""
    import os

    n_reads = int(os.environ.get("MAPPER_TPU_FUZZ_N", "2500"))
    rng = np.random.default_rng(20260820)
    ref_text = random_text(60000, rng)
    index = Api.new_database({"f1": ref_text[:35000], "f2": ref_text[35000:]})
    params = AlignmentParameters.defaults()

    reads = []
    for i in range(n_reads):
        if rng.random() < 0.6:
            contig_start, contig_len = 0, 35000
        else:
            contig_start, contig_len = 35000, 25000
        length = int(rng.integers(100, 190))
        pos = int(rng.integers(0, contig_len - length - 20))
        read = list(ref_text[contig_start + pos : contig_start + pos + length + 10])
        kind = rng.random()
        if kind < 0.45:  # SNP-laden (0-6)
            for _ in range(int(rng.integers(0, 7))):
                j = int(rng.integers(0, len(read)))
                read[j] = "ACGT"[int(rng.integers(0, 4))]
        elif kind < 0.70:  # indel rich (1-3 events)
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(10, len(read) - 12))
                if rng.random() < 0.5:
                    del read[j : j + int(rng.integers(1, 4))]
                else:
                    for _k in range(int(rng.integers(1, 4))):
                        read.insert(j, "ACGT"[int(rng.integers(0, 4))])
        elif kind < 0.80:  # SNPs + an N
            read[int(rng.integers(0, len(read)))] = "N"
            for _ in range(int(rng.integers(0, 3))):
                j = int(rng.integers(0, len(read)))
                read[j] = "ACGT"[int(rng.integers(0, 4))]
        elif kind < 0.90:  # heavy error (8-14 SNPs): near the accept boundary
            for _ in range(int(rng.integers(8, 15))):
                j = int(rng.integers(0, len(read)))
                read[j] = "ACGT"[int(rng.integers(0, 4))]
        else:  # junk
            read = list(random_text(length, rng))
        text = "".join(read[:length])
        if rng.random() < 0.5:
            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append(Sequence.from_text(f"z{i}", text))

    sequential = AlignerWorker(index, params)
    engine = BatchAligner(index, params)
    batch_results = engine.process_batch([Query(r) for r in reads])
    mismatches = []
    for i, read in enumerate(reads):
        expected = summarize(sequential.align(Query(read)))
        got = summarize(batch_results[i])
        if got != expected:
            mismatches.append((i, got, expected))
    assert not mismatches, (len(mismatches), mismatches[:3])


def test_paired_engine_agreement_fuzz():
    """Paired-end analog of the SE fuzz: the batch engine (vectorized
    pairing + certificates + exact-combo deferral) must match the sequential
    worker on randomized pairs with SNPs, indels, overlapping mates,
    contig-edge fragments and both orientations."""
    from tests.test_paired_batch import simulate_pairs

    rng = np.random.default_rng(4242)
    ref_text = random_text(40000, rng)
    index = Api.new_database({"pA": ref_text[:26000], "pB": ref_text[26000:]})
    params = AlignmentParameters.defaults()
    queries = simulate_pairs(ref_text[:26000], 200, seed=97)

    sequential = AlignerWorker(index, params)
    engine = BatchAligner(index, params)
    batch_results = engine.process_batch(list(queries))

    def summarize_pair(result):
        rows = []
        for alist in result.get_alignments():
            rows.append(
                tuple(
                    sorted(
                        (
                            round(a.get_penalty(), 9),
                            a.spacing_penalty,
                            tuple(c.content_key() for c in a.get_components()),
                        )
                        for a in alist
                    )
                )
            )
        return tuple(rows)

    mismatches = []
    for i, q in enumerate(queries):
        expected = summarize_pair(sequential.align(q))
        got = summarize_pair(batch_results[i])
        if got != expected:
            mismatches.append((i, got, expected))
    assert not mismatches, (len(mismatches), mismatches[:2])


def test_paired_engine_agreement_fuzz_hard():
    """Hard paired fuzz with the bench_hard_pe error model (3% SNP + up to two
    1-3 bp indel events per mate, inner distance N(100, 30),
    spacing_deviation_per_unit_penalty=50): this is the regime that exercises
    the exact-combo offset-invariance gate and its lockstep fast path —
    equal-penalty indel tracebacks steered by the voted diagonal, plus
    offset-dependent spacing penalties.  CI runs 160 pairs; MAPPER_TPU_FUZZ_N
    scales it (pairs = max(160, MAPPER_TPU_FUZZ_N // 8))."""
    import os

    from benchmarks.bench_hard_pe import simulate

    n_pairs = max(160, int(os.environ.get("MAPPER_TPU_FUZZ_N", "0")) // 8)
    import benchmarks.bench_hard_pe as hpe

    old = (hpe.NUM_PAIRS, hpe.REFERENCE_SIZE)
    hpe.NUM_PAIRS = n_pairs
    hpe.REFERENCE_SIZE = 150_000  # CI-sized; the bench itself runs 1 Mb
    try:
        ref_text, pairs = simulate(seed=1203)
    finally:
        hpe.NUM_PAIRS, hpe.REFERENCE_SIZE = old
    index = Api.new_database({"chr1": ref_text})
    params = AlignmentParameters.defaults()
    queries = [
        Query(
            [a, b],
            expected_inner_distance=100,
            spacing_deviation_per_unit_penalty=50,
        )
        for a, b in pairs
    ]

    def summarize_pair(result):
        rows = []
        for alist in result.get_alignments():
            rows.append(
                tuple(
                    sorted(
                        (
                            round(a.get_penalty(), 9),
                            a.spacing_penalty,
                            tuple(c.content_key() for c in a.get_components()),
                        )
                        for a in alist
                    )
                )
            )
        return tuple(rows)

    sequential = AlignerWorker(index, params)
    engine = BatchAligner(index, params)
    batch_results = engine.process_batch(
        [
            Query(
                [a, b],
                expected_inner_distance=100,
                spacing_deviation_per_unit_penalty=50,
            )
            for a, b in pairs
        ]
    )
    mismatches = []
    for i, q in enumerate(queries):
        expected = summarize_pair(sequential.align(q))
        got = summarize_pair(batch_results[i])
        if got != expected:
            mismatches.append((i, got, expected))
    assert not mismatches, (len(mismatches), mismatches[:2])


def test_batch_engine_alignment_cache():
    """The AlignmentCache wired at process_batch intake (VERDICT r3 #5):
    duplicate reads replay the cached alignment onto the new Query with
    byte-identical output, hits are counted on the worker stats, and the
    cache-less engine agrees."""
    from mapper_tpu.align.cache import AlignmentCache

    rng = np.random.default_rng(808)
    ref_text = random_text(30000, rng)
    index = Api.new_database({"c": ref_text})
    params = AlignmentParameters.defaults()

    molecules = []
    for i in range(40):
        pos = int(rng.integers(0, 30000 - 160))
        read = list(ref_text[pos : pos + 150])
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, 150))
            read[j] = "ACGT"[int(rng.integers(0, 4))]
        if rng.random() < 0.3:  # some indel molecules (exact-path results)
            j = int(rng.integers(10, 140))
            del read[j : j + 2]
        molecules.append("".join(read))
    texts = [molecules[int(rng.integers(0, 40))] for _ in range(400)]

    def make_queries():
        return [Query(Sequence.from_text(f"d{i}", t)) for i, t in enumerate(texts)]

    plain = BatchAligner(index, params)
    expected = [summarize(r) for r in plain.process_batch(make_queries())]

    cached_engine = BatchAligner(index, params)
    cached_engine.cache = AlignmentCache()
    # the adaptive enable fraction (AlignerWorker.java:129-155) self-starts
    # from accumulated skips, so stores ramp over the first few batches
    outputs = [cached_engine.process_batch(make_queries()) for _ in range(4)]
    stats = cached_engine.fallback_worker.stats
    assert stats.num_cache_hits > 0
    assert cached_engine.cache.get_usage() > 0
    for got in outputs:
        assert [summarize(r) for r in got] == expected


def test_paired_mate_spends_pair_budget():
    """One mate over its own per-mate budget but within the pair budget:
    the exact algebra re-allocates (QueryMatch_Aligner.java:207-239), so the
    batch engine must not cap the scoring DP at mate level.  Regression for
    the host-scoring bug where such pairs emitted affirmatively empty
    results (7/4096 on the hard-PE bench) while the worker aligned them."""
    rng = np.random.default_rng(17)
    bases = "ACGT"
    ref_text = "".join(bases[int(b)] for b in rng.integers(0, 4, size=20000))
    params = AlignmentParameters.defaults()
    index = Api.new_database({"chr1": ref_text})

    def rc(t):
        return basepairs.decode(basepairs.reverse_complement(basepairs.encode(t)))

    queries = []
    for i in range(8):
        pos = 1000 + 1700 * i
        inner = 100
        frag = 300 + inner
        m1 = list(ref_text[pos : pos + 150])  # clean mate: penalty 0
        # gapped mate: 3 bp deletion (penalty 3.3) + 13 SNPs = 16.3, which
        # exceeds the per-mate budget (15) but fits the pair budget (30).
        # Its UNGAPPED penalty is finite but far over budget (frameshifted
        # tail), reproducing the finite-best + inf-banded empty-emit bug.
        m2 = list(ref_text[pos + frag - 153 : pos + frag])
        del m2[75:78]
        for j in range(3, 70, 6):
            cur = m2[j]
            m2[j] = bases[(bases.index(cur) + 1) % 4]
        for j in range(85, 95, 6):
            cur = m2[j]
            m2[j] = bases[(bases.index(cur) + 1) % 4]
        queries.append(
            Query(
                [
                    Sequence.from_text(f"b{i}/1", "".join(m1)),
                    Sequence.from_text(f"b{i}/2", rc("".join(m2))),
                ],
                expected_inner_distance=inner,
                spacing_deviation_per_unit_penalty=50,
            )
        )

    engine = BatchAligner(index, params)
    worker = AlignerWorker(index, params)
    results = engine.process_batch(queries, notify=False)
    for q, r in zip(queries, results):
        w = worker.align(q)
        assert any(w.get_alignments()), "fixture must be worker-alignable"
        got = sorted(
            (a.get_penalty(), tuple(c.content_key() for c in a.get_components()))
            for comp in r.get_alignments()
            for a in comp
        )
        want = sorted(
            (a.get_penalty(), tuple(c.content_key() for c in a.get_components()))
            for comp in w.get_alignments()
            for a in comp
        )
        assert got == want
