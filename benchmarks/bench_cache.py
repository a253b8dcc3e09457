"""High-depth benchmark for the batch-path alignment cache (VERDICT r3 #5):
8192 simulated 150 bp reads at ~4x duplication (2048 distinct molecules),
1% SNPs, 1 Mb reference.  Measures batch-engine throughput with and without
the AlignmentCache wired at chunk intake and reports the hit rate.
Prints one JSON line like bench.py."""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_READS = int(__import__("os").environ.get("CACHE_READS", 8192))
DUPLICATION = 4
READ_LENGTH = 150
REFERENCE_SIZE = 1_000_000
SNP_RATE = 0.01


def simulate(seed=11):
    from mapper_tpu import basepairs
    from mapper_tpu.sequence import Sequence

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    ref_text = "".join(rng.choice(bases, size=REFERENCE_SIZE))
    distinct = NUM_READS // DUPLICATION
    molecules = []
    for i in range(distinct):
        pos = int(rng.integers(0, REFERENCE_SIZE - READ_LENGTH - 8))
        read = list(ref_text[pos : pos + READ_LENGTH + 4])
        for j in range(len(read)):
            if rng.random() < SNP_RATE:
                read[j] = str(bases[int(rng.integers(0, 4))])
        if rng.random() < 0.3:  # indel molecules: the expensive exact path
            j = int(rng.integers(10, len(read) - 12))
            if rng.random() < 0.5:
                del read[j : j + int(rng.integers(1, 4))]
            else:
                for _k in range(int(rng.integers(1, 4))):
                    read.insert(j, str(bases[int(rng.integers(0, 4))]))
        text = "".join(read[:READ_LENGTH])
        if rng.random() < 0.5:
            text = basepairs.decode(
                basepairs.reverse_complement(basepairs.encode(text))
            )
        molecules.append(text)
    reads = []
    for i in range(NUM_READS):
        # PCR-style duplication: identical copies of each molecule
        reads.append(
            Sequence.from_text(f"r{i}", molecules[int(rng.integers(0, distinct))])
        )
    return ref_text, reads


def main():
    from mapper_tpu import Api, AlignmentParameters
    from mapper_tpu.align.cache import AlignmentCache
    from mapper_tpu.align.query import Query
    from mapper_tpu.batch.engine import BatchAligner

    t_start = time.time()

    def note(msg):
        print(f"[cache {time.time() - t_start:6.1f}s] {msg}", file=sys.stderr, flush=True)

    ref_text, reads = simulate()
    note(f"simulated {NUM_READS} reads at {DUPLICATION}x duplication")
    index = Api.new_database({"chr1": ref_text})
    note("index built")
    params = AlignmentParameters.defaults()

    CHUNK = 2048  # the CLI's pipeline chunk: the adaptive fraction ramps per chunk

    def run(with_cache):
        engine = BatchAligner(index, params)
        if with_cache:
            engine.cache = AlignmentCache()

        def one_pass():
            qs = [Query(r) for r in reads]
            t0 = time.time()
            for s in range(0, len(qs), CHUNK):
                engine.process_batch(qs[s : s + CHUNK])
            return time.time() - t0

        one_pass()  # warmup (and cache fill)
        passes = [one_pass() for _ in range(3)]
        return min(passes), engine

    cold, _ = run(False)
    note(f"no cache: {NUM_READS / cold:.0f} reads/s")
    warm, engine = run(True)
    stats = engine.fallback_worker.stats
    note(
        f"cached: {NUM_READS / warm:.0f} reads/s, hits={stats.num_cache_hits}, "
        f"entries={engine.cache.get_usage()}"
    )
    print(
        json.dumps(
            {
                "metric": "cached_reads_per_second_per_chip",
                "value": round(NUM_READS / warm, 1),
                "unit": "reads/s",
                "detail": {
                    "num_reads": NUM_READS,
                    "duplication": DUPLICATION,
                    "uncached_reads_per_second": round(NUM_READS / cold, 1),
                    "speedup": round(cold / warm, 2),
                    "cache_hits_total": stats.num_cache_hits,
                    "cache_entries": engine.cache.get_usage(),
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
