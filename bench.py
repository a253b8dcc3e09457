"""Benchmark: reads aligned per second on simulated Illumina-style data.

Runs the batch engine (batched candidate generation + banded-DP scoring +
vectorized finalization) end-to-end over simulated 150bp single-end reads
against a 1 Mb random reference, and prints ONE JSON line:

    {"metric": "reads_per_second_per_chip", "value": N, "unit": "reads/s",
     "vs_baseline": R}

vs_baseline is measured against BASELINE_JAVA_READS_PER_SECOND, the
single-core throughput class of the reference Java engine on comparable data
(the repo publishes no numbers — BASELINE.md; this constant is the order of
magnitude reported for X-Mapper-class aligners and is revisited once the jar
can be run).  The value is the best of PASSES steady-state passes; the
median is reported beside it.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_JAVA_READS_PER_SECOND = 10_000.0

NUM_READS = 8192
READ_LENGTH = 150
REFERENCE_SIZE = 1_000_000
SNP_RATE = 0.01

PASSES = int(os.environ.get("BENCH_PASSES", 12))


def simulate(seed=0):
    from mapper_tpu.sequence import Sequence

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    ref_text = "".join(rng.choice(bases, size=REFERENCE_SIZE))
    reads = []
    for i in range(NUM_READS):
        pos = int(rng.integers(0, REFERENCE_SIZE - READ_LENGTH))
        read = np.array(list(ref_text[pos : pos + READ_LENGTH]))
        snps = rng.random(READ_LENGTH) < SNP_RATE
        read[snps] = bases[rng.integers(0, 4, size=int(snps.sum()))]
        text = "".join(read)
        if rng.random() < 0.5:
            from mapper_tpu import basepairs

            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append(Sequence.from_text(f"r{i}", text))
    return ref_text, reads


def main():
    from mapper_tpu import Api, AlignmentParameters
    from mapper_tpu.align.query import Query
    from mapper_tpu.batch.engine import BatchAligner

    def note(message):
        print(f"[bench {time.time() - t_start:7.1f}s] {message}", file=sys.stderr, flush=True)

    t_start = time.time()
    ref_text, reads = simulate()
    note("simulated reads")
    t_index0 = time.time()
    index = Api.new_database({"chr1": ref_text})
    index_seconds = time.time() - t_index0
    note(f"index built in {index_seconds:.1f}s")

    params = AlignmentParameters.defaults()
    engine = BatchAligner(index, params)
    queries = [Query(r) for r in reads]

    # warmup with the same shapes as the measured pass (compiles the kernel
    # for this shape bucket); the measurement is steady-state throughput
    engine.process_batch(queries)
    note("warmup done (kernel compiled)")

    pass_seconds = []
    results = None
    for _ in range(PASSES):
        t0 = time.time()
        results = engine.process_batch(queries)
        pass_seconds.append(time.time() - t0)
    note(f"passes {[round(t, 2) for t in pass_seconds]}s")
    elapsed = min(pass_seconds)
    median = float(np.median(pass_seconds))

    aligned = sum(1 for r in results if r.get_total_of_all_components() > 0)
    reads_per_second = len(queries) / elapsed
    print(
        json.dumps(
            {
                "metric": "reads_per_second_per_chip",
                "value": round(reads_per_second, 1),
                "unit": "reads/s",
                "vs_baseline": round(reads_per_second / BASELINE_JAVA_READS_PER_SECOND, 3),
                "detail": {
                    "num_reads": len(queries),
                    "aligned_fraction": round(aligned / len(queries), 4),
                    "fallback_reads": engine.stats_fallback_reads,
                    "index_build_seconds": round(index_seconds, 2),
                    "align_seconds": round(elapsed, 2),
                    "methodology": "min_of_passes",
                    "median_reads_per_second": round(len(queries) / median, 1),
                    "pass_seconds": [round(t, 3) for t in pass_seconds],
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
