"""BASELINE config 4: multi-reference metagenomic mode — paired reads drawn
from a mixture of reference genomes, --out-refs-map-count, full CLI.

Usage: python benchmarks/bench_config4_metagenomic.py [num_pairs] [num_genomes] [genome_mb]
Default scale is the BASELINE.json config (1M pairs); pass a smaller count for
quick runs — the JSON records the actual scale used.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import simlib


def main(argv):
    num_pairs = int(argv[1]) if len(argv) > 1 else 1_000_000
    num_genomes = int(argv[2]) if len(argv) > 2 else 4
    genome_mb = float(argv[3]) if len(argv) > 3 else 1.0
    import numpy as np

    work = simlib.ensure_dir(os.path.join(tempfile.gettempdir(), "mapper_bench_c4"))
    ref_path = os.path.join(work, "refs.fasta")
    q1 = os.path.join(work, "reads_1.fasta")
    q2 = os.path.join(work, "reads_2.fasta")
    t0 = time.time()
    rng = np.random.default_rng(4)
    genomes = {
        f"genome{g}": simlib.random_reference(rng, int(genome_mb * 1e6))
        for g in range(num_genomes)
    }
    simlib.write_reference(ref_path, genomes)
    # abundance-skewed mixture (2^-g), pairs simulated per genome then interleaved
    weights = np.array([2.0 ** -g for g in range(num_genomes)])
    weights /= weights.sum()
    counts = np.floor(weights * num_pairs).astype(int)
    counts[0] += num_pairs - counts.sum()
    tmp1, tmp2 = [], []
    for g, (name, text) in enumerate(genomes.items()):
        p1 = os.path.join(work, f"g{g}_1.fasta")
        p2 = os.path.join(work, f"g{g}_2.fasta")
        simlib.simulate_paired(p1, p2, text, int(counts[g]), seed=40 + g)
        tmp1.append(p1)
        tmp2.append(p2)
    for out, parts in ((q1, tmp1), (q2, tmp2)):
        with open(out, "w") as f:
            for part in parts:
                f.write(open(part).read())
    print(f"[c4] simulated {num_pairs} pairs vs {num_genomes}x{genome_mb} Mb in "
          f"{time.time()-t0:.0f}s", file=sys.stderr, flush=True)

    from mapper_tpu.cli import main as cli_main

    refcounts = os.path.join(work, "refs_map_count.txt")
    t1 = time.time()
    cli_main([
        "--reference", ref_path,
        "--paired-queries", q1, q2,
        "--spacing", "100", "50",
        "--out-refs-map-count", refcounts,
    ])
    wall = time.time() - t1
    print(json.dumps({
        "metric": "metagenomic_pairs_per_second_e2e",
        "value": round(num_pairs / wall, 1),
        "unit": "pairs/s",
        "detail": {
            "num_pairs": num_pairs,
            "num_genomes": num_genomes,
            "genome_mb": genome_mb,
            "wall_seconds": round(wall, 1),
            "refcount_lines": sum(1 for _ in open(refcounts)),
        },
    }))


if __name__ == "__main__":
    main(sys.argv)
