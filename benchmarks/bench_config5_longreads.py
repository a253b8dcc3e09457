"""BASELINE config 5: long reads via --split-queries-past-size plus
--infer-ancestors on a 10 Mb reference with duplication structure, full CLI.

Usage: python benchmarks/bench_config5_longreads.py [num_reads] [read_kb] [ref_mb]
(The BASELINE config says multi-host; one host/one chip here — the multi-chip
sharding path is exercised separately by __graft_entry__.dryrun_multichip.)
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import simlib


def main(argv):
    num_reads = int(argv[1]) if len(argv) > 1 else 2_000
    read_kb = float(argv[2]) if len(argv) > 2 else 10.0
    ref_mb = float(argv[3]) if len(argv) > 3 else 10.0
    import numpy as np

    work = simlib.ensure_dir(os.path.join(tempfile.gettempdir(), "mapper_bench_c5"))
    ref_path = os.path.join(work, "ref.fasta")
    reads_path = os.path.join(work, "reads.fasta")
    t0 = time.time()
    rng = np.random.default_rng(5)
    # reference with ancestral duplication structure: a base genome plus
    # mutated repeats of a 50 kb segment (gives --infer-ancestors real work)
    base = simlib.random_reference(rng, int(ref_mb * 1e6) - 150_000)
    segment = np.array(list(base[:50_000]))
    copies = []
    for _ in range(3):
        copies.append("".join(simlib.mutate(rng, segment, 0.02)))
    ref_text = base + "".join(copies)
    simlib.write_reference(ref_path, {"chr1": ref_text})
    read_length = int(read_kb * 1000)
    simlib.simulate_single(
        reads_path, ref_text, num_reads, read_length=read_length,
        snp_rate=0.02, seed=5,
    )
    print(f"[c5] simulated {num_reads} x {read_kb} kb reads vs {ref_mb} Mb in "
          f"{time.time()-t0:.0f}s", file=sys.stderr, flush=True)

    from mapper_tpu.cli import main as cli_main

    sam = os.path.join(work, "out.sam")
    t1 = time.time()
    cli_main([
        "--reference", ref_path,
        # the reference's context-sensitive flag order: the split flag must
        # precede the --queries it applies to (Mapper.java:102-104)
        "--split-queries-past-size", "1500",
        "--queries", reads_path,
        "--infer-ancestors",
        "--out-sam", sam,
    ])
    wall = time.time() - t1
    bases = num_reads * read_length
    print(json.dumps({
        "metric": "longread_bases_per_second_e2e",
        "value": round(bases / wall, 1),
        "unit": "bases/s",
        "detail": {
            "num_reads": num_reads,
            "read_kb": read_kb,
            "reference_mb": ref_mb,
            "wall_seconds": round(wall, 1),
            "sam_records": sum(1 for line in open(sam) if not line.startswith("@")),
        },
    }))


if __name__ == "__main__":
    main(sys.argv)
