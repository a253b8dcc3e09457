"""cProfile of the sequential fallback worker over the hard-SE reads that
the batch path defers — decides whether the next hard-SE lever is a C++
counting-layer port (walk-bound) or aligner work (DP-driver-bound)."""

import cProfile
import io
import os
import pstats
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


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

    # find which reads fall back
    fb_queries = []
    orig_align = engine.fallback_worker.align

    def rec(q):
        fb_queries.append(q)
        return orig_align(q)

    engine.fallback_worker.align = rec
    engine.process_batch(queries, notify=False)
    engine.fallback_worker.align = orig_align
    print(f"{len(fb_queries)} fallback reads")

    pr = cProfile.Profile()
    pr.enable()
    for q in fb_queries:
        orig_align(q)
    pr.disable()
    s = io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(35)
    print(s.getvalue())


if __name__ == "__main__":
    main()
