"""BASELINE config 3: E. coli-scale paired-end 2x150 with --spacing 100 50,
--out-vcf --out-sam, through the full CLI (BASELINE.md measurement protocol).

Usage: python benchmarks/bench_config3_pe.py [num_pairs] [ref_mb]
Prints one JSON line with pairs/s for the alignment phase and wall times per
phase (index build, alignment, post-pass writers).
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import simlib


def main(argv):
    num_pairs = int(argv[1]) if len(argv) > 1 else 50_000
    ref_mb = float(argv[2]) if len(argv) > 2 else 4.6
    import numpy as np

    work = simlib.ensure_dir(os.path.join(tempfile.gettempdir(), "mapper_bench_c3"))
    ref_path = os.path.join(work, "ref.fasta")
    q1 = os.path.join(work, "reads_1.fasta")
    q2 = os.path.join(work, "reads_2.fasta")
    t0 = time.time()
    rng = np.random.default_rng(7)
    ref_text = simlib.random_reference(rng, int(ref_mb * 1e6))
    simlib.write_reference(ref_path, {"chr1": ref_text})
    simlib.simulate_paired(q1, q2, ref_text, num_pairs, seed=7)
    print(f"[c3] simulated {num_pairs} pairs vs {ref_mb} Mb in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)

    from mapper_tpu.cli import main as cli_main

    sam = os.path.join(work, "out.sam")
    vcf = os.path.join(work, "out.vcf")
    t1 = time.time()
    cli_main([
        "--reference", ref_path,
        "--paired-queries", q1, q2,
        "--spacing", "100", "50",
        "--out-sam", sam,
        "--out-vcf", vcf,
    ])
    wall = time.time() - t1
    aligned = sum(1 for line in open(sam) if not line.startswith("@"))
    print(json.dumps({
        "metric": "pe_pairs_per_second_e2e",
        "value": round(num_pairs / wall, 1),
        "unit": "pairs/s",
        "detail": {
            "num_pairs": num_pairs,
            "reference_mb": ref_mb,
            "wall_seconds": round(wall, 1),
            "sam_records": aligned,
        },
    }))


if __name__ == "__main__":
    main(sys.argv)
