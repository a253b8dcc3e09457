"""Device-side pileup accumulation for the batch engine's fast path.

The reference's MatchDatabase.groupByPosition (Mapper.java:760-784) is a
host-side post-pass; SURVEY §2.2 maps it to a position-sharded scatter-add.
This module keeps [2, 6, N] allele/depth accumulators resident on the device
and scatter-adds each chunk's clean ungapped emissions (the overwhelmingly
common alignment shape) as they are decided, overlapped with the next chunk's
host work.  At write time the host fetches the accumulators once and merges
them into the MatchDatabase pileups; only the rare complex alignments
(indels, mate overlap, fractional multi-choice weights, fallback reads)
still go through the host accumulation path.

Exactness: the device path only takes weight-1.0 and weight-0.5 emissions,
so every accumulated value is a sum of 0.5 steps — exact in float32 below
2^23 and independent of scatter order, which keeps output byte-identical
across device counts and pipeline orderings.  Fractional 1/num_choices
weights (inexact in binary, order-sensitive) stay on the host float64 path.
"""

from __future__ import annotations

import numpy as np

ROWS = 6  # A C G T ambiguous deletion (pileup.py row order)

_READ_BUCKET = 2048  # row-count bucket (compile-size stability)
_LQ_BUCKET = 64
_CODES_BUCKET = 1 << 18


class DevicePileup:
    """Per-run device accumulator over a compact forward-only coordinate
    space (the batch engine's candidate tables fold every match onto forward
    contigs, so RC segments are never hit — excluding them halves the HBM
    footprint and the merge-time fetch)."""

    def __init__(self, seq_db, query_end_fraction: float, device=None, mesh=None):
        self.seq_db = seq_db
        self.query_end_fraction = float(query_end_fraction)
        self.mesh = mesh  # shard scatter rows over the data axis; psum at merge
        # compact coordinates: forward sequences only, packed in db order.
        # _delta maps a db-global position to its compact position
        # (compact = global + _delta[seq_index]; RC rows keep INT64_MIN so an
        # accidental RC emission fails loudly rather than corrupting counts)
        starts = seq_db.starts
        fwd = [s.complemented_from is None for s in seq_db.get_all()]
        delta = np.full(len(fwd), np.iinfo(np.int64).min, dtype=np.int64)
        compact = 0
        self._fwd_compact_starts: list[tuple[int, int, int]] = []  # (db_i, lo, hi)
        for i, is_fwd in enumerate(fwd):
            if is_fwd:
                length = int(starts[i + 1] - starts[i])
                delta[i] = compact - int(starts[i])
                self._fwd_compact_starts.append((i, compact, compact + length))
                compact += length
        self._delta = delta
        self.n_concat = compact  # compact forward-only size
        # int32 flat indices, and ~25 bytes/position of device accumulators
        # (2 x 6 rows x f32 over the forward space): cap at 64 Mb of
        # reference (~1.6 GB HBM); larger references keep the host path
        if self.n_concat > 2**26 or ROWS * self.n_concat >= 2**31 - 1:
            raise ValueError("reference too large for device pileup")
        import threading

        self._state = None  # lazily created [2, 6*N] f32 on device
        self._device = device
        self._update_fns: dict[int, object] = {}  # lq bucket -> jitted update
        self._fetch_fn = None
        self.num_rows_accumulated = 0
        # the CLI pipelines chunks on a thread pool; the donated state buffer
        # must be threaded through updates strictly one at a time
        self._lock = threading.Lock()
        self._merged = False

    # -- jitted update ---------------------------------------------------

    def _build_update(self, lq_static: int):
        import functools

        import jax
        import jax.numpy as jnp

        n_concat = self.n_concat
        qef = np.float32(self.query_end_fraction)

        def core(state, codes_concat, read_starts, read_id, reversed_, gstart, n, weight):
            b = read_id.shape[0]
            pos = jax.lax.broadcasted_iota(jnp.int32, (b, lq_static), 1)
            src = read_starts[read_id][:, None] + pos
            src = jnp.minimum(src, codes_concat.shape[0] - 1)
            q = codes_concat[src].astype(jnp.int32)  # [B, LQ]
            # reverse complement (same arithmetic as banded_dp._gathered_core)
            comp = (
                ((q & 1) << 3) | ((q & 2) << 1) | ((q & 4) >> 1) | ((q & 8) >> 3)
            )
            rc_idx = jnp.clip(n[:, None] - 1 - pos, 0, lq_static - 1)
            rc = jnp.take_along_axis(comp, rc_idx, axis=1)
            codes = jnp.where(reversed_[:, None], rc, q)
            # code -> allele row: A/C/G/T are one-hot nibbles; anything else
            # (incl. IUPAC codes, which the batch path filters out anyway)
            # lands on the ambiguous row
            row = jnp.select(
                [codes == 1, codes == 2, codes == 4, codes == 8],
                [
                    jnp.zeros_like(codes),
                    jnp.ones_like(codes),
                    jnp.full_like(codes, 2),
                    jnp.full_like(codes, 3),
                ],
                jnp.full_like(codes, 4),
            )
            gpos = gstart[:, None] + pos
            valid = pos < n[:, None]
            dist_end = jnp.minimum(pos, n[:, None] - 1 - pos).astype(jnp.float32)
            is_end = dist_end < qef * n[:, None].astype(jnp.float32)
            flat = row * np.int32(n_concat) + gpos
            flat = jnp.where(valid, flat, 0)
            w = weight[:, None] * jnp.where(valid, 1.0, 0.0)
            mid = state[0].at[flat.reshape(-1)].add(
                jnp.where(is_end, 0.0, w).reshape(-1)
            )
            end = state[1].at[flat.reshape(-1)].add(
                jnp.where(is_end, w, 0.0).reshape(-1)
            )
            return jnp.stack([mid, end])

        if self.mesh is None:
            return jax.jit(core, donate_argnums=(0,))

        # mesh: rows shard over the data axis, each device scatters into its
        # own accumulator copy ([D, 2, 6N] sharded on axis 0); the psum merge
        # happens once at fetch time (parallel/mesh.reduce_pileup)
        from jax.sharding import PartitionSpec as P

        from mapper_tpu.parallel.mesh import _shard_map

        row = P("data")
        rep = P()

        def sharded(state, codes_concat, read_starts, read_id, reversed_, gstart, n, weight):
            def inner(st, codes_c, rs, rid, rev, gs, nn, wt):
                return core(st[0], codes_c, rs, rid, rev, gs, nn, wt)[None]

            return _shard_map(
                inner,
                self.mesh,
                in_specs=(P("data"), rep, rep, row, row, row, row, row),
                out_specs=P("data"),
            )(state, codes_concat, read_starts, read_id, reversed_, gstart, n, weight)

        return jax.jit(sharded, donate_argnums=(0,))

    def add_rows(self, batch, read_id, reversed_, gstart, n, weight) -> None:
        """Scatter one chunk's clean ungapped emissions.  `batch` is the
        engine's ReadBatch (concatenated uint8 codes + per-read starts); the
        remaining arrays are per-emitted-row host vectors."""
        b = len(read_id)
        if b == 0:
            return
        import jax
        import jax.numpy as jnp

        n = np.asarray(n, dtype=np.int32)
        # remap db-global start positions into the compact forward space
        gstart = np.asarray(gstart, dtype=np.int64)
        seq_idx = np.searchsorted(self.seq_db.starts, gstart, side="right") - 1
        gstart = gstart + self._delta[seq_idx]
        lq = -(-int(n.max()) // _LQ_BUCKET) * _LQ_BUCKET
        update_fn = self._update_fns.get(lq)
        if update_fn is None:
            update_fn = self._update_fns[lq] = self._build_update(lq)
        bp = -(-b // _READ_BUCKET) * _READ_BUCKET
        if self.mesh is not None and bp % self.mesh.size:
            bp = -(-bp // self.mesh.size) * self.mesh.size
        codes = batch.codes
        cp = -(-codes.shape[0] // _CODES_BUCKET) * _CODES_BUCKET
        # monotone bucket: a run's tail chunk is smaller than the full chunks
        # before it — pad up to the largest size seen so it reuses the
        # already-loaded program instead of compiling a new shape
        cp = max(cp, getattr(self, "_codes_pad", 0))
        self._codes_pad = cp
        if cp != codes.shape[0]:
            codes = np.pad(codes, (0, cp - codes.shape[0]))

        def pad1(a, dtype, fill=0):
            out = np.full(bp, fill, dtype=dtype)
            out[:b] = np.asarray(a)
            return out

        args = (
            codes,
            np.asarray(batch.starts[:-1], dtype=np.int32),
            pad1(read_id, np.int32),
            pad1(reversed_, bool),
            pad1(gstart, np.int32),
            pad1(n, np.int32, fill=0),  # n=0 rows contribute nothing
            pad1(weight, np.float32, fill=0.0),
        )
        with self._lock:
            if self._state is None:
                if self.mesh is not None:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    self._state = jax.device_put(
                        jnp.zeros(
                            (self.mesh.size, 2, ROWS * self.n_concat), jnp.float32
                        ),
                        NamedSharding(self.mesh, P("data")),
                    )
                else:
                    self._state = jax.device_put(
                        jnp.zeros((2, ROWS * self.n_concat), jnp.float32),
                        self._device,
                    )
            self._state = update_fn(self._state, *args)
            self.num_rows_accumulated += int(b)

    # -- merge into MatchDatabase -----------------------------------------

    def merge_into(self, match_database) -> None:
        """Fetch the accumulators once and add them into the MatchDatabase's
        per-contig pileups (float64 host arrays).

        The raw f32 state is 48 bytes/position — hundreds of MB for a
        bacterial genome.  Every accumulated value is a sum of 0.5 steps (exact in f32),
        so doubling on-device yields small exact integers; the fetch ships
        them as uint16 (4x fewer bytes) with an on-device max as the overflow
        guard, falling back to the full f32 fetch only if any doubled count
        exceeds 65535 (depth > 32767 at one position)."""
        if self._state is None or self._merged:
            return
        self._merged = True
        import jax
        import jax.numpy as jnp

        if self.mesh is not None:
            # the per-device accumulator copies merge with a psum over the
            # data axis — the listener fan-in of SURVEY §2.2
            from mapper_tpu.parallel.mesh import reduce_pileup

            flat_dev = reduce_pileup(self.mesh, self._state)[0]
        else:
            flat_dev = self._state  # [2, 6*N] on device

        if self._fetch_fn is None:

            def fetch(state):
                doubled = state * np.float32(2.0)
                mx = jnp.max(doubled)
                u16 = jnp.minimum(doubled, np.float32(65535.0)).astype(jnp.uint16)
                return u16, mx

            self._fetch_fn = jax.jit(fetch)
        u16_dev, mx_dev = self._fetch_fn(flat_dev)
        if float(np.asarray(mx_dev)) <= 65535.0:
            flat = np.asarray(u16_dev).astype(np.float64) * 0.5
        else:  # pragma: no cover - depth > 32767 at one position
            flat = np.asarray(flat_dev).astype(np.float64)
        state = flat.reshape(2, ROWS, self.n_concat)
        for i, lo, hi in self._fwd_compact_starts:
            if not state[:, :, lo:hi].any():
                continue
            pileup = match_database._pileup_for(self.seq_db.get_sequence(i))
            pileup.middle += state[0, :, lo:hi]
            pileup.end += state[1, :, lo:hi]
