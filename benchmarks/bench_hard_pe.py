"""Hard-data PAIRED benchmark: indel-rich, high-error 2x150 pairs — measures
throughput plus how much of the paired batch path defers to the exact
per-pair driver (combos with indel winners / overlap algebra) and how much
falls back to the full sequential worker.

Error model per mate: 3% per-base SNP rate plus up to 2 indel events of
1-3 bp; inner distance N(100, 30); half the fragments on the reverse strand.
Prints one JSON line like bench.py.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_PAIRS = int(__import__("os").environ.get("HARDPE_PAIRS", 4096))
READ_LENGTH = 150
REFERENCE_SIZE = 1_000_000
SNP_RATE = 0.03
INDEL_EVENTS = 2


def _mutate(rng, bases, text):
    read = list(text)
    for j in range(len(read)):
        if rng.random() < SNP_RATE:
            read[j] = str(bases[int(rng.integers(0, 4))])
    for _ in range(int(rng.integers(0, INDEL_EVENTS + 1))):
        j = int(rng.integers(10, len(read) - 10))
        if rng.random() < 0.5:
            del read[j : j + int(rng.integers(1, 4))]
        else:
            for _k in range(int(rng.integers(1, 4))):
                read.insert(j, str(bases[int(rng.integers(0, 4))]))
    return "".join(read[:READ_LENGTH])


def simulate(seed=3):
    from mapper_tpu import basepairs
    from mapper_tpu.sequence import Sequence

    def rc(t):
        return basepairs.decode(basepairs.reverse_complement(basepairs.encode(t)))

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    ref_text = "".join(rng.choice(bases, size=REFERENCE_SIZE))
    pairs = []
    for i in range(NUM_PAIRS):
        inner = max(-READ_LENGTH // 2, int(rng.normal(100, 30)))
        frag = 2 * READ_LENGTH + inner
        pos = int(rng.integers(0, REFERENCE_SIZE - frag - 40))
        m1 = _mutate(rng, bases, ref_text[pos : pos + READ_LENGTH + 10])
        m2 = rc(_mutate(rng, bases, ref_text[pos + frag - READ_LENGTH - 10 : pos + frag]))
        if rng.random() < 0.5:
            m1, m2 = m2, m1
        pairs.append(
            (
                Sequence.from_text(f"p{i}/1", m1),
                Sequence.from_text(f"p{i}/2", m2),
            )
        )
    return ref_text, pairs


def main():
    from mapper_tpu import Api, AlignmentParameters
    from mapper_tpu.align.query import Query
    from mapper_tpu.batch.engine import BatchAligner

    t_start = time.time()

    def note(msg):
        print(f"[hardpe {time.time() - t_start:7.1f}s] {msg}", file=sys.stderr, flush=True)

    ref_text, pairs = simulate()
    note("simulated hard pairs (3% SNP + <=2 indel events per mate)")
    index = Api.new_database({"chr1": ref_text})
    note("index built")
    params = AlignmentParameters.defaults()
    engine = BatchAligner(index, params)
    queries = [
        Query([a, b], expected_inner_distance=100, spacing_deviation_per_unit_penalty=50)
        for a, b in pairs
    ]
    engine.process_batch(queries)
    note("warmup done")
    engine.stats_fallback_reads = 0
    import os as _os

    pass_seconds = []
    for i in range(int(_os.environ.get("HARDPE_PASSES", 6))):
        t0 = time.time()
        results = engine.process_batch(queries)
        pass_seconds.append(time.time() - t0)
        note(f"pass {i}: {pass_seconds[-1]:.1f}s")
    elapsed = min(pass_seconds)
    aligned = sum(1 for r in results if r.get_total_of_all_components() > 0)
    via_exact = sum(1 for r in results if getattr(r, "via_exact", False))
    fallback_fraction = engine.stats_fallback_reads / (len(pass_seconds) * len(queries))
    print(
        json.dumps(
            {
                "metric": "hard_pairs_per_second_per_chip",
                "value": round(len(queries) / elapsed, 1),
                "unit": "pairs/s",
                "detail": {
                    "num_pairs": len(queries),
                    "aligned_fraction": round(aligned / len(queries), 4),
                    "fallback_fraction": round(fallback_fraction, 4),
                    "exact_combo_fraction": round(via_exact / len(queries), 4),
                    "error_model": "3% SNP + up to 2 indel events (1-3 bp) per 150 bp mate",
                    "pass_seconds": [round(t, 3) for t in pass_seconds],
                    "methodology": "min_of_passes_across_spread_groups",
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
