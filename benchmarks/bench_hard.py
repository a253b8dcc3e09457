"""Hard-data benchmark: indel-rich, high-error single-end reads (VERDICT r2
item 5) — measures throughput AND the batch path's fallback fraction where
the host certificate's economics degrade.

Error model per read (150 bp, 1 Mb reference): 3% per-base SNP rate plus up
to 3 indel events of 1-3 bp, 50% reverse strand.  Prints one JSON line like
bench.py.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_READS = 8192
READ_LENGTH = 150
REFERENCE_SIZE = 1_000_000
SNP_RATE = 0.03
INDEL_EVENTS = 3  # up to 3 indel events per read


def simulate(seed=1):
    from mapper_tpu import basepairs
    from mapper_tpu.sequence import Sequence

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    ref_text = "".join(rng.choice(bases, size=REFERENCE_SIZE))
    reads = []
    for i in range(NUM_READS):
        pos = int(rng.integers(0, REFERENCE_SIZE - READ_LENGTH - 20))
        read = list(ref_text[pos : pos + READ_LENGTH + 10])
        # SNPs
        for j in range(len(read)):
            if rng.random() < SNP_RATE:
                read[j] = str(bases[int(rng.integers(0, 4))])
        # indels
        for _ in range(int(rng.integers(0, INDEL_EVENTS + 1))):
            j = int(rng.integers(10, len(read) - 10))
            if rng.random() < 0.5:
                del read[j : j + int(rng.integers(1, 4))]
            else:
                for _k in range(int(rng.integers(1, 4))):
                    read.insert(j, str(bases[int(rng.integers(0, 4))]))
        text = "".join(read[:READ_LENGTH])
        if rng.random() < 0.5:
            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append(Sequence.from_text(f"h{i}", text))
    return ref_text, reads


def main():
    from mapper_tpu import Api, AlignmentParameters
    from mapper_tpu.align.query import Query
    from mapper_tpu.batch.engine import BatchAligner

    t_start = time.time()

    def note(msg):
        print(f"[hard {time.time() - t_start:7.1f}s] {msg}", file=sys.stderr, flush=True)

    ref_text, reads = simulate()
    note("simulated hard reads (3% SNP + <=3 indel events)")
    index = Api.new_database({"chr1": ref_text})
    note("index built")
    params = AlignmentParameters.defaults()
    engine = BatchAligner(index, params)
    queries = [Query(r) for r in reads]
    engine.process_batch(queries)
    note("warmup done")
    engine.stats_fallback_reads = 0
    import os as _os

    pass_seconds = []
    for i in range(int(_os.environ.get("HARD_PASSES", 6))):
        t0 = time.time()
        results = engine.process_batch(queries)
        pass_seconds.append(time.time() - t0)
        note(f"pass {i}: {pass_seconds[-1]:.1f}s")
    elapsed = min(pass_seconds)
    aligned = sum(1 for r in results if r.get_total_of_all_components() > 0)
    fallback_fraction = engine.stats_fallback_reads / (len(pass_seconds) * len(queries))
    print(
        json.dumps(
            {
                "metric": "hard_reads_per_second_per_chip",
                "value": round(len(queries) / elapsed, 1),
                "unit": "reads/s",
                "detail": {
                    "num_reads": len(queries),
                    "aligned_fraction": round(aligned / len(queries), 4),
                    "fallback_fraction": round(fallback_fraction, 4),
                    "error_model": "3% SNP + up to 3 indel events (1-3 bp) per 150 bp read",
                    "pass_seconds": [round(t, 3) for t in pass_seconds],
                    "methodology": "min_of_passes_across_spread_groups",
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
