"""Hash-range sharding of the packed index across a device mesh.

For reference sets whose index exceeds a single device's memory, the merged
PackedIndex bins (index/database.py::merged_index) split into contiguous
bin ranges, one per device along the mesh's ``data`` axis.  Seed keys are
small and replicate to every device; each device answers only the bins it
owns and the per-seed contributions merge with a ``psum`` (non-owners
contribute zeros).  This is the "shard by hash range + all-to-all" design
from SURVEY.md §7 stage 6 — with replicated queries the all-to-all
degenerates into one psum over the device interconnect.

The reference has no equivalent (its PackedMaps live in one JVM heap;
HashBlock_Database.java:682-683); this is the device scale-out path.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class ShardedIndex:
    """Device-sharded view of a database's merged index.

    Lookup semantics mirror the host path (batch/candidates.py): a seed's bin
    is ``bases[num_bp] + key mod capacities[num_bp]``; bins whose count
    exceeds the per-size cap are "too popular" and report their count but no
    positions.
    """

    def __init__(self, database, mesh: Mesh, k_match: int = 12):
        merged = database.merged_index()
        counts = np.asarray(merged["counts"], dtype=np.int32)
        offsets = np.asarray(merged["offsets"], dtype=np.int64)
        values = np.asarray(merged["values"], dtype=np.int64)
        self.capacities = merged["capacities"]
        self.caps = merged["caps"]
        self.bases = merged["bases"]
        self.mesh = mesh
        self.k_match = k_match

        n_dev = mesh.devices.size
        num_bins = counts.shape[0]
        n_values = values.shape[0]
        # Value-balanced contiguous bin ranges: shard boundaries sit where the
        # cumulative value count crosses d/n_dev of the total, so every
        # shard's values slice is ~n_values/n_dev and the pad-to-max below
        # costs only the boundary imbalance (the previous equal-bin split
        # could give one shard most of the values and replicate that memory
        # to every device through the padding).
        targets = (np.arange(1, n_dev, dtype=np.int64) * n_values) // n_dev
        bounds = np.searchsorted(offsets[:num_bins], targets, side="left")
        bounds = np.concatenate(([0], bounds, [num_bins]))
        bounds = np.maximum.accumulate(bounds)
        self.bins_per_shard = max(
            1, int(np.max(bounds[1:] - bounds[:-1], initial=1))
        )

        shard_counts, shard_offsets, shard_values, base_bins = [], [], [], []
        for d in range(n_dev):
            lo = int(bounds[d])
            hi = int(bounds[d + 1])
            v_lo = int(offsets[lo]) if lo < num_bins else n_values
            v_hi = int(offsets[hi]) if hi < num_bins else n_values
            c = np.zeros(self.bins_per_shard, dtype=np.int32)
            o = np.zeros(self.bins_per_shard, dtype=np.int64)
            c[: hi - lo] = counts[lo:hi]
            o[: hi - lo] = offsets[lo:hi] - v_lo
            shard_counts.append(c)
            shard_offsets.append(o)
            shard_values.append(values[v_lo:v_hi])
            base_bins.append(lo)
        vmax = max((v.shape[0] for v in shard_values), default=0) or 1
        # total device memory for values = n_dev * vmax ~= n_values + slack
        self.values_memory_ratio = (n_dev * vmax) / max(1, n_values)
        shard_values = [
            np.pad(v, (0, vmax - v.shape[0]), constant_values=0) for v in shard_values
        ]

        data = NamedSharding(mesh, P("data"))
        self.counts = jax.device_put(
            jnp.asarray(np.stack(shard_counts)), data
        )  # [D, bins_per_shard]
        self.offsets = jax.device_put(jnp.asarray(np.stack(shard_offsets)), data)
        self.values = jax.device_put(jnp.asarray(np.stack(shard_values)), data)
        self.base_bins = jax.device_put(
            jnp.asarray(np.asarray(base_bins, dtype=np.int64)[:, None]), data
        )  # [D, 1]

        bins_per_shard = self.bins_per_shard
        k = self.k_match

        def shard_lookup(counts_s, offsets_s, values_s, base_s, bins, limits):
            # counts_s: [1, bins_per_shard] (this shard's slice); bins: [S]
            counts_s = counts_s[0]
            offsets_s = offsets_s[0]
            values_s = values_s[0]
            base = base_s[0, 0]
            local = bins - base
            mine = (local >= 0) & (local < bins_per_shard)
            local_c = jnp.clip(local, 0, bins_per_shard - 1)
            c = jnp.where(mine, counts_s[local_c], 0)
            start = offsets_s[local_c]
            j = jnp.arange(k, dtype=jnp.int64)[None, :]
            take = jnp.minimum(c, jnp.minimum(limits, k))
            valid = mine[:, None] & (j < take[:, None])
            vidx = jnp.clip(start[:, None] + j, 0, values_s.shape[0] - 1)
            vals = jnp.where(valid, values_s[vidx], 0)
            # owners contribute; everyone else adds zeros
            return (
                jax.lax.psum(vals, "data"),
                jax.lax.psum(jnp.where(mine, c, 0), "data"),
                jax.lax.psum(valid.astype(jnp.int32), "data"),
            )

        self._lookup = jax.jit(
            shard_map(
                shard_lookup,
                mesh=mesh,
                in_specs=(P("data"), P("data"), P("data"), P("data"), P(), P()),
                out_specs=(P(), P(), P()),
            )
        )

    def lookup(self, num_bp: np.ndarray, keys: np.ndarray):
        """Batched sharded lookup.  Returns (positions [S, k_match], counts
        [S], valid [S, k_match]) — count reflects the bin even when too
        popular to enumerate (cap semantics as the host path)."""
        num_bp = np.asarray(num_bp, dtype=np.int64)
        keys = np.asarray(keys, dtype=np.int64)
        cap_per_seed = self.capacities[num_bp]
        bins = self.bases[num_bp] + np.remainder(keys, cap_per_seed)
        limits = self.caps[num_bp]
        vals, counts, valid = self._lookup(
            self.counts,
            self.offsets,
            self.values,
            self.base_bins,
            jnp.asarray(bins),
            jnp.asarray(limits),
        )
        return np.asarray(vals), np.asarray(counts), np.asarray(valid).astype(bool)
