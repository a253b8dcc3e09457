"""Itemize the fused on-device candidate program's device time by stage
by timing stage-truncated variants of _device_candidates_core with the
queued-call method of bench_fused.py.

Stages: 1 pyramid+gapmers, 2 +seed compaction+counts gather, 3 +values
gather, 4 +strand fold / vote keys, 5 +compaction to P slots, 6 +O(P^2)
vote counting, 99 full (top-K + output).
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
STAGES = [int(s) for s in sys.argv[2].split(",")] if len(sys.argv) > 2 else [1, 2, 3, 4, 5, 6, 99]
# FUSED_LEVELS=4,8,16 sweeps the pyramid level count at each stage
LEVELS = [int(x) for x in os.environ.get("FUSED_LEVELS", "").split(",") if x] or [None]

from benchmarks.bench_fused import build, NUM_READS


def main():
    from mapper_tpu.batch import device_candidates as dc

    t0 = time.time()
    print("backend:", jax.default_backend(), flush=True)
    index, batch, params = build()
    db = index.hashblock_database
    print(f"[{time.time()-t0:.0f}s] index built", flush=True)

    dev = dc.device_index_arrays(db)
    seq_db = db.get_sequence_database()
    n_seqs = seq_db.get_num_sequences()
    max_len = int(batch.lengths.max())
    longest = int(max(len(s) for s in seq_db.get_all()))
    span = longest + 2 * max_len + 2
    bias = max_len + 1
    b = batch.num_reads
    l = -(-max_len // 64) * 64
    codes = np.zeros((b, l), dtype=np.uint8)
    for r in range(b):
        codes[r, : batch.lengths[r]] = batch.codes[batch.starts[r] : batch.starts[r + 1]]
    lengths = batch.lengths.astype(np.int32)

    dyn = (
        codes, lengths,
        dev["capacities"], dev["caps"], dev["bases"], dev["counts"],
        dev["offsets"], dev["values"],
        dev["rev_flags"], dev["fwd_index"], dev["seq_lengths"],
        dev["rc_index"], dev["seq_starts"],
        np.int32(db.get_hashed_length()), np.int32(n_seqs),
        np.int32(span), np.int32(bias),
    )
    results = {}
    fn = functools.partial(
        jax.jit,
        static_argnames=(
            "min_size", "max_matches", "num_levels", "v_slots", "p_slots",
            "k_out", "stage",
        ),
    )(dc._device_candidates_core)
    for stage in STAGES:
      for levels in LEVELS:
        static = dict(
            min_size=int(db.get_min_interesting_size()),
            max_matches=12,
            num_levels=dc.NUM_LEVELS if levels is None else levels,
            v_slots=dc.V_SLOTS,
            p_slots=dc.P_SLOTS, k_out=8, stage=stage,
        )
        label = f"{stage}" if levels is None else f"{stage}@L{levels}"
        t0 = time.time()
        np.asarray(fn(*dyn, **static))
        print(f"stage {label}: compile+first {time.time()-t0:.1f}s", flush=True)
        times = []
        for _ in range(3):
            t0 = time.time()
            outs = [fn(*dyn, **static) for _ in range(ITERS)]
            for o in outs:
                np.asarray(o)
            times.append(time.time() - t0)
        best = min(times)
        per_iter = max(best - 0.025 * ITERS, 1e-9) / ITERS
        results[label] = round(per_iter * 1000, 1)
        print(f"stage {label}: {per_iter*1000:.1f} ms per {NUM_READS}-read chunk", flush=True)
    print(json.dumps({"metric": "fused_stage_ms_per_chunk", "value": results.get("99"),
                      "unit": "ms", "detail": results}))


if __name__ == "__main__":
    sys.exit(main())
