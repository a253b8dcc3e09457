"""Multi-chip scaling: data-parallel sharding of the alignment pipeline.

The reference's only parallelism is intra-JVM worker threads over read batches
(SURVEY.md §2.2).  The device equivalent is a 1-D `data` mesh:

- read batches shard over the `data` axis (each chip scores its candidates);
- the packed index / reference arrays replicate (bacterial genomes are far
  below device memory; hash-range sharding + all-to-all is the planned path for
  reference sets beyond HBM);
- per-position pileup accumulators merge with `psum` — the listener fan-in of
  the reference (AlignmentListener.addAlignments) becomes pure addition.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map with the varying-manual-axes check disabled: the scoring
    loops initialize carries from constants, which the checker types as
    unvarying even though the loop outputs vary over `data`."""
    return jax.shard_map(
        f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), axis_names=("data",))


def shard_batch(mesh: Mesh, *arrays):
    """Place batch-major arrays with the leading axis sharded over `data`."""
    sharding = NamedSharding(mesh, P("data"))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def replicate(mesh: Mesh, *arrays):
    sharding = NamedSharding(mesh, P())
    return tuple(jax.device_put(a, sharding) for a in arrays)


def sharded_banded_scores(mesh: Mesh, params, band: int):
    """A jit-compiled, data-sharded version of the banded scoring step: inputs
    sharded on the batch axis, scores sharded the same way (no collectives
    needed — scoring is embarrassingly parallel; the pileup reduction below is
    where psum appears)."""
    from mapper_tpu.align.banded_dp import _banded_scores_jnp, _params_tuple

    batch_sharding = NamedSharding(mesh, P("data"))

    @jax.jit
    def scores(q_codes, w_codes, n, m):
        return _banded_scores_jnp(
            q_codes, w_codes, n.reshape(-1, 1), m.reshape(-1, 1), _params_tuple(params), band
        )

    def run(q_codes, w_codes, n, m):
        q_codes, w_codes, n, m = shard_batch(
            mesh,
            jnp.asarray(q_codes, jnp.int32),
            jnp.asarray(w_codes, jnp.int32),
            jnp.asarray(n, jnp.int32),
            jnp.asarray(m, jnp.int32),
        )
        return scores(q_codes, w_codes, n, m)

    return run


def reduce_pileup(mesh: Mesh, shard_counts):
    """All-reduce per-shard pileup count arrays (the VCF/mutations
    "groupByPosition" merge) across the data axis with a psum."""
    @jax.jit
    def reduced(counts):
        def inner(c):
            return jax.lax.psum(c, axis_name="data")

        return _shard_map(inner, mesh, P("data"), P())(counts)

    return reduced(shard_counts)
