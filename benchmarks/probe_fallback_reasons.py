"""Diagnostic: why do hard-SE reads leave the batch path for the exact
sequential worker?  Prints stats_fallback_reasons and per-category timing
for one hard pass (CPU backend is fine: the categories are backend-
independent; only the absolute wall time differs)."""

import os
import sys
import time

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
    engine.stats_fallback_reads = 0
    engine.stats_fallback_reasons = {}
    from collections import Counter

    engine._gap_debug = Counter()

    # timed pass with a per-read fallback timer
    orig_align = engine.fallback_worker.align
    t_fb = [0.0, 0]

    def timed_align(q):
        t0 = time.perf_counter()
        r = orig_align(q)
        t_fb[0] += time.perf_counter() - t0
        t_fb[1] += 1
        return r

    engine.fallback_worker.align = timed_align
    t0 = time.perf_counter()
    engine.process_batch(queries)
    wall = time.perf_counter() - t0
    print(f"pass: {wall:.3f}s for {n} reads ({n / wall:.0f} reads/s)")
    print(
        f"fallback: {t_fb[1]} reads, {t_fb[0]:.3f}s total "
        f"({1e3 * t_fb[0] / max(1, t_fb[1]):.2f} ms/read)"
    )
    total = sum(engine.stats_fallback_reasons.values())
    for k, v in sorted(engine.stats_fallback_reasons.items(), key=lambda kv: -kv[1]):
        print(f"  {k:16s} {v:5d}  ({100.0 * v / max(1, total):.1f}%)")
    print("gap-finalization reject sub-reasons (_gap_debug):")
    for k, v in engine._gap_debug.most_common():
        print(f"  {k:16s} {v:5d}")


if __name__ == "__main__":
    main()
