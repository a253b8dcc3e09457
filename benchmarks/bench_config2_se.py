"""BASELINE config 2: E. coli-scale single-end — 100k simulated 150 bp reads
vs a 4.6 Mb reference, --out-mutations with default thresholds, full CLI.

Usage: python benchmarks/bench_config2_se.py [num_reads] [ref_mb]
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import simlib


def main(argv):
    num_reads = int(argv[1]) if len(argv) > 1 else 100_000
    ref_mb = float(argv[2]) if len(argv) > 2 else 4.6
    import numpy as np

    work = simlib.ensure_dir(os.path.join(tempfile.gettempdir(), "mapper_bench_c2"))
    ref_path = os.path.join(work, "ref.fasta")
    reads_path = os.path.join(work, "reads.fasta")
    t0 = time.time()
    rng = np.random.default_rng(2)
    ref_text = simlib.random_reference(rng, int(ref_mb * 1e6))
    simlib.write_reference(ref_path, {"chr1": ref_text})
    simlib.simulate_single(reads_path, ref_text, num_reads, seed=2)
    print(f"[c2] simulated {num_reads} reads vs {ref_mb} Mb in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)

    from mapper_tpu.cli import main as cli_main

    mutations = os.path.join(work, "out_mutations.txt")
    t1 = time.time()
    cli_main([
        "--reference", ref_path,
        "--queries", reads_path,
        "--out-mutations", mutations,
    ])
    wall = time.time() - t1
    print(json.dumps({
        "metric": "se_reads_per_second_e2e",
        "value": round(num_reads / wall, 1),
        "unit": "reads/s",
        "detail": {
            "num_reads": num_reads,
            "reference_mb": ref_mb,
            "wall_seconds": round(wall, 1),
            "mutation_rows": sum(
                1 for line in open(mutations) if not line.startswith(("#", "CHR"))
            ),
        },
    }))


if __name__ == "__main__":
    main(sys.argv)
