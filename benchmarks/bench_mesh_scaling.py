"""Mesh scaling measurement (VERDICT r3 #4): the sharded banded-scoring step
at 1 / 2 / 4 / 8 shards on the virtual CPU mesh, host stages excluded.

The 8 "devices" are XLA host-platform threads sharing the host's cores, so
wall-clock scaling is bounded by the core count — the scaling evidence is
(a) per-shard work drops linearly (the sharded program's per-device cost is
measured via single-device runs on the same-sized shard), and
(b) the sharded dispatch adds no per-device overhead beyond the collective-
free scoring program itself.

Prints one JSON line."""

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

import mapper_tpu  # noqa: E402,F401  (configures the persistent compile cache)

import numpy as np  # noqa: E402


def main():
    from mapper_tpu.align.params import AlignmentParameters
    from mapper_tpu.parallel.mesh import make_mesh, sharded_banded_scores

    rng = np.random.default_rng(0)
    B, N, BAND = 2048, 192, 64
    q = rng.integers(1, 16, size=(B, N), dtype=np.int32)
    w = rng.integers(1, 16, size=(B, N + BAND), dtype=np.int32)
    n = np.full(B, 150, dtype=np.int32)
    m = np.full(B, 150 + BAND, dtype=np.int32)
    params = AlignmentParameters.defaults()

    results = {}
    for n_dev in (1, 2, 4, 8):
        mesh = make_mesh(jax.devices()[:n_dev])
        run = sharded_banded_scores(mesh, params, BAND)
        out = run(q, w, n, m)
        np.asarray(out)  # warm compile + execute
        passes = []
        for _ in range(3):
            t0 = time.time()
            np.asarray(run(q, w, n, m))
            passes.append(time.time() - t0)
        results[n_dev] = min(passes)
        print(
            f"[mesh] {n_dev} shard(s): {results[n_dev]*1000:.0f} ms / {B}-row chunk",
            file=sys.stderr,
            flush=True,
        )

    # per-shard work check: a 1-device mesh over a 1/8 slice
    mesh1 = make_mesh(jax.devices()[:1])
    run1 = sharded_banded_scores(mesh1, params, BAND)
    s = B // 8
    np.asarray(run1(q[:s], w[:s], n[:s], m[:s]))
    passes = []
    for _ in range(3):
        t0 = time.time()
        np.asarray(run1(q[:s], w[:s], n[:s], m[:s]))
        passes.append(time.time() - t0)
    slice_time = min(passes)
    print(
        f"[mesh] 1 device on a 1/8 slice: {slice_time*1000:.0f} ms "
        f"(per-shard work at 8 shards)",
        file=sys.stderr,
        flush=True,
    )

    print(
        json.dumps(
            {
                "metric": "mesh_scoring_ms_per_2048_chunk",
                "value": round(results[8] * 1000, 1),
                "unit": "ms",
                "detail": {
                    "ms_by_shards": {str(k): round(v * 1000, 1) for k, v in results.items()},
                    "one_device_eighth_slice_ms": round(slice_time * 1000, 1),
                    "per_shard_work_ratio_8x": round(slice_time / results[1], 3),
                    "backend": "cpu-virtual-mesh (2 vCPUs)",
                    "band": BAND,
                    "rows": B,
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
