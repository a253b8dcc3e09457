"""Diagnostic: for hard-SE reads rejected by the gap-finalization's
offset-invariance probe (probe_blocks), which alignment does the sequential
worker actually emit — the wave-1 alignment (batch voted offset o), one of
the probes, or something else entirely?  Decides whether the batch path can
pick the right offset instead of deferring."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def main():
    from benchmarks import bench_hard
    from mapper_tpu import Api, AlignmentParameters
    from mapper_tpu.align.query import Query
    from mapper_tpu.batch.engine import BatchAligner

    n = int(os.environ.get("PROBE_READS", 4096))
    bench_hard.NUM_READS = n
    ref_text, reads = bench_hard.simulate()
    index = Api.new_database({"chr1": ref_text})
    params = AlignmentParameters.defaults()
    engine = BatchAligner(index, params)
    queries = [Query(r) for r in reads]
    engine.process_batch(queries)  # warmup

    # capture the gap jobs of one pass
    captured = []
    orig = engine._finalize_gap_jobs

    def capturing(jobs, results, best_per_read, gap_margin):
        captured.extend(jobs)
        return orig(jobs, results, best_per_read, gap_margin)

    engine._finalize_gap_jobs = capturing
    engine.stats_fallback_reasons = {}
    results = engine.process_batch(queries, notify=False)
    engine._finalize_gap_jobs = orig

    from mapper_tpu.align.candidates import QueryMatch, SequenceMatch
    from mapper_tpu.align.query_aligner import QueryMatchAligner

    # jobs whose read still fell back (gap_dp_fail)
    failed = [j for j in captured if not j.get("ok", False)]
    print(f"captured {len(captured)} gap jobs, {len(failed)} not ok")
    agree_wave1 = agree_probe = neither = multi = none_w = 0
    for j in failed[:300]:
        query, seq_a, ref, o = j["query"], j["seq_a"], j["ref"], j["o"]
        qma = QueryMatchAligner(query, params, index)
        qa = qma.align(QueryMatch([SequenceMatch(seq_a, ref, o, True)], 1))
        if qa is None:
            continue
        choices = qma.get_best_alignments()
        if len(choices) != 1:
            continue
        k_wave1 = (choices[0].content_key(), choices[0].get_penalty())
        wr = engine.fallback_worker.align(query)
        comps = wr.get_alignments()
        if len(comps) != 1 or len(comps[0]) != 1:
            multi += 1
            continue
        wa = comps[0][0]
        k_worker = (wa.content_key(), wa.get_penalty())
        if k_worker == k_wave1:
            agree_wave1 += 1
        else:
            # does any probe offset reproduce it?
            offs = set(j["locus"])
            comp = choices[0].get_component(0)
            for s in comp.sections:
                if s.length_a == s.length_b and s.length_a > 0:
                    offs.add(int(s.start_b - s.start_a))
            offs.discard(o)
            hit = False
            for o2 in offs:
                alt = QueryMatchAligner(query, params, index).align(
                    QueryMatch([SequenceMatch(seq_a, ref, o2, True)], 1)
                )
                if alt is not None and (alt.content_key(), alt.get_penalty()) == k_worker:
                    hit = True
                    break
            if hit:
                agree_probe += 1
            else:
                neither += 1
    print(
        f"worker == wave1 alignment: {agree_wave1}; == some probe: {agree_probe}; "
        f"neither: {neither}; multi-choice worker result: {multi}"
    )


if __name__ == "__main__":
    main()
