"""Back-to-back measurement of the fully-fused device path (candidates +
scoring, batch/device_candidates.py): N queued calls of one compiled program
and one fetch at the end, so total / N bounds the per-chunk device time.
"""

import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

ITERS = int(sys.argv[1]) if len(sys.argv) > 1 else 4
NUM_READS = 2048
READ_LENGTH = 150
REFERENCE_SIZE = 1_000_000


def build():
    from mapper_tpu import Api, AlignmentParameters, basepairs
    from mapper_tpu.batch.candidates import ReadBatch
    from mapper_tpu.sequence import Sequence

    rng = np.random.default_rng(7)
    bases = np.array(list("ACGT"))
    ref_text = "".join(rng.choice(bases, size=REFERENCE_SIZE))
    reads = []
    for i in range(NUM_READS):
        pos = int(rng.integers(0, REFERENCE_SIZE - READ_LENGTH))
        read = np.array(list(ref_text[pos : pos + READ_LENGTH]))
        snps = rng.random(READ_LENGTH) < 0.01
        read[snps] = bases[rng.integers(0, 4, size=int(snps.sum()))]
        text = "".join(read)
        if rng.random() < 0.5:
            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append(Sequence.from_text(f"r{i}", text))
    index = Api.new_database({"chr1": ref_text})
    batch = ReadBatch.from_sequences(reads)
    return index, batch, AlignmentParameters.defaults()


def main():
    from mapper_tpu.batch import device_candidates as dc
    from mapper_tpu.align import banded_dp
    from mapper_tpu.align.banded_dp import _params_tuple

    t0 = time.time()
    print("backend:", jax.default_backend(), flush=True)
    index, batch, params = build()
    db = index.hashblock_database
    print(f"[{time.time()-t0:.0f}s] index built", flush=True)

    dev = dc.device_index_arrays(db)
    seq_db = db.get_sequence_database()
    concat_dev = jax.device_put(seq_db.concatenated_codes())
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
    shift = np.full(b, 15, dtype=np.int32)
    band, tile = 64, 1024
    k_out = 8
    c_slots = -(-int(b * 1.5) // tile) * tile
    params_vec = np.array([[float(v) for v in _params_tuple(params)]], dtype=np.float32)
    scorer, quant = banded_dp.choose_scorer(None, params, l, band)
    if scorer == "kernel":
        banded_dp._register_kernel()

    static = dict(
        min_size=int(db.get_min_interesting_size()),
        max_matches=12, num_levels=dc.NUM_LEVELS, v_slots=dc.V_SLOTS,
        p_slots=dc.P_SLOTS, k_out=k_out, c_slots=c_slots, band=band,
        scorer=scorer, quant=quant,
    )
    dyn = (
        lengths, shift,
        dev["capacities"], dev["caps"], dev["bases"], dev["counts"],
        dev["offsets"], dev["values"],
        dev["rev_flags"], dev["fwd_index"], dev["seq_lengths"],
        dev["rc_index"], dev["seq_starts"],
        concat_dev, params_vec,
        np.int32(db.get_hashed_length()), np.int32(n_seqs),
        np.int32(span), np.int32(bias),
    )

    # dispatch ITERS back-to-back calls of the single compiled program and
    # fetch at the end: total/ITERS bounds per-chunk device time
    fused = functools.partial(jax.jit, static_argnames=tuple(static))(dc._fused_core)
    t0 = time.time()
    np.asarray(fused(codes, *dyn, **static))
    print(f"compile+first: {time.time()-t0:.1f}s", flush=True)
    times = []
    for _ in range(3):
        t0 = time.time()
        outs = [fused(codes, *dyn, **static) for _ in range(ITERS)]
        for o in outs:
            np.asarray(o)
        times.append(time.time() - t0)
    best = min(times)
    per_iter = max(best - 0.025 * ITERS, 1e-9) / ITERS
    print(
        f"fused candidates+scoring: best-of-3 {best*1000:.0f} ms / {ITERS} "
        f"queued calls -> {per_iter*1000:.1f} ms per 2048-read chunk = "
        f"{NUM_READS/per_iter:.0f} reads/s/chip (device-only)",
        flush=True,
    )


if __name__ == "__main__":
    sys.exit(main())
