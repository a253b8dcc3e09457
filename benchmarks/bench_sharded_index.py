"""Sharded-index lookup rate (VERDICT r3 #6): 4.6 Mb reference, hash-range
shards over an 8-virtual-device CPU mesh (JAX_PLATFORMS=cpu +
xla_force_host_platform_device_count=8; the value-balanced layout and psum
merge are exactly what a multi-device mesh runs).  Prints one JSON line."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip(),
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    from mapper_tpu import Api
    from mapper_tpu.batch.candidates import ReadBatch, collect_batch_seeds
    from mapper_tpu.parallel.mesh import make_mesh
    from mapper_tpu.parallel.sharded_index import ShardedIndex
    from mapper_tpu.sequence import Sequence

    t_start = time.time()

    def note(msg):
        print(f"[shard {time.time() - t_start:6.1f}s] {msg}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(46)
    ref_text = "".join(rng.choice(list("ACGT"), size=4_600_000))
    index = Api.new_database({"chr": ref_text})
    db = index.hashblock_database
    note("4.6 Mb index built")

    reads = [
        Sequence.from_text(
            f"r{i}", ref_text[(p := int(rng.integers(0, 4_600_000 - 160))) : p + 150]
        )
        for i in range(2048)
    ]
    batch = ReadBatch.from_sequences(reads)
    seg, _, _, num_bp, key, _ = collect_batch_seeds(batch, db)
    note(f"{seg.shape[0]} seeds from 2048 reads")

    mesh = make_mesh()
    sharded = ShardedIndex(db, mesh, k_match=12)
    note(
        f"sharded over {mesh.devices.size} devices, values memory ratio "
        f"{sharded.values_memory_ratio:.3f} (1.0 = no padding waste)"
    )
    sharded.lookup(num_bp, key)  # compile + warm
    passes = []
    for _ in range(3):
        t0 = time.time()
        vals, counts, valid = sharded.lookup(num_bp, key)
        passes.append(time.time() - t0)
    elapsed = min(passes)
    elements = int(valid.sum())
    print(
        json.dumps(
            {
                "metric": "sharded_index_lookup_seeds_per_second",
                "value": round(seg.shape[0] / elapsed, 1),
                "unit": "seeds/s",
                "detail": {
                    "num_seeds": int(seg.shape[0]),
                    "elements_returned": elements,
                    "elements_per_second": round(elements / elapsed, 1),
                    "devices": int(mesh.devices.size),
                    "values_memory_ratio": round(float(sharded.values_memory_ratio), 3),
                    "reference_mb": 4.6,
                    "backend": "cpu-virtual-mesh",
                    "pass_seconds": [round(t, 4) for t in passes],
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
