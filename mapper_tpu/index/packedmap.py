"""Flat-array hash->positions multimap: the device-ready index store.

Equivalent of the reference's PackedMap + ByteKeyStore (PackedMap.java):
an open-addressed multimap keyed by `hash mod capacity` that stores *no keys* —
a lookup returns every position in the bin (hash collisions included; the query
path filters collisions downstream with a cheap sampling check, see
Counting_HashBlockPath.java:98-153).  Bins holding more than
`max_interesting_count` positions report "too popular" and return nothing
(PackedMap.get, java:160-172).

The layout is CSR over bins: `offsets[capacity+1]` into a single sorted int64
`values` array of encoded global positions — exactly the two arrays the device
seed-lookup gather consumes.  Values within a bin are sorted ascending, which is
the canonical, insertion-order-independent order (the reference's
ByteKeyStore.pack; audited by PackedMap.verifyMatches / --verify-consistent-db).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_INT_MAX = 2**31 - 1
_LONG_MAX = 2**63 - 1


def _java_long_cast(x: float) -> int:
    """Java (long) cast of a double: truncate toward zero, saturate."""
    if x != x:  # NaN
        return 0
    if x >= _LONG_MAX:
        return _LONG_MAX
    if x <= -(2**63):
        return -(2**63)
    return int(x)


def _java_int_cast(x: float) -> int:
    if x != x:
        return 0
    if x >= _INT_MAX:
        return _INT_MAX
    if x <= -(2**31):
        return -(2**31)
    return int(x)


def estimate_required_capacity(
    num_basepairs_used: int, total_forward_size: int, enable_gapmers: bool
) -> int:
    """HashBlock_Database.estimateRequiredCapacity (java:620-665), ported with
    Java double semantics so bin layouts (and hence collision sets) match."""
    if enable_gapmers:
        anchor_block_size = num_basepairs_used * 2 // 3
    else:
        anchor_block_size = num_basepairs_used
    size_probability = min(1.0, 2.0 / anchor_block_size) if anchor_block_size else 1.0
    offset_probability = size_probability
    block_possibility_probability = size_probability * offset_probability

    if num_basepairs_used <= 16:
        max_num_sequences = 1 << (num_basepairs_used * 2)
    else:
        max_num_sequences = 1 << 32
    max_stored = max_num_sequences // 2
    max_num_existent_hashcodes = _java_long_cast(max_stored * block_possibility_probability)
    num_blocks = _java_long_cast(total_forward_size * block_possibility_probability)
    if max_num_existent_hashcodes != 0:
        base = (max_num_existent_hashcodes - 1.0) / max_num_existent_hashcodes
    else:
        base = float("-inf")
    existence_fraction = 1.0 - base**num_blocks
    unique_count = _java_int_cast(max_num_existent_hashcodes * existence_fraction)

    result = unique_count
    if result % 2 == 0:
        result += 1
    return result


def max_interesting_count_per_key(num_basepairs_used: int, max_num_short_matches: int) -> int:
    """HashBlock_Database.addHashblocks cap formula (java:566-577)."""
    cap = num_basepairs_used * num_basepairs_used
    if cap < max_num_short_matches:
        cap = max_num_short_matches
    if cap > 32766:
        cap = 32766
    if cap < 1:
        cap = 1
    return cap


@dataclass
class PackedIndex:
    """One CSR multimap for one block size (numBasepairsUsed)."""

    num_basepairs_used: int
    capacity: int
    max_interesting_count: int
    counts: np.ndarray  # int32[capacity]: total items added per bin
    offsets: np.ndarray  # int64[capacity+1]: CSR offsets into values
    values: np.ndarray  # int64[nnz]: encoded positions, ascending per bin

    @staticmethod
    def build(
        num_basepairs_used: int,
        keys: np.ndarray,
        positions: np.ndarray,
        capacity: int,
        max_interesting_count: int,
        dedup_mask: np.ndarray | None = None,
    ) -> "PackedIndex":
        """Build from parallel (key, encoded position) arrays.

        `dedup_mask` marks entries that came from ambiguity expansion; within
        that subset, (bin, position) duplicates are dropped (the reference's
        preventDuplicates path, PackedMap.java:124-138 — a MultiHashBlock can
        produce the same position twice).
        """
        if capacity < 1:
            capacity = 1
        max_array = _INT_MAX // 2
        if capacity > max_array:
            capacity = max_array

        keys = np.asarray(keys, dtype=np.int64)
        positions = np.asarray(positions, dtype=np.int64)
        bins = np.mod(keys, capacity)  # python % is nonnegative, same as Java's fixup

        if dedup_mask is not None and np.any(dedup_mask):
            amb_idx = np.nonzero(dedup_mask)[0]
            pairs = np.stack([bins[amb_idx], positions[amb_idx]], axis=1)
            _, unique_first = np.unique(pairs, axis=0, return_index=True)
            keep = np.ones(len(keys), dtype=bool)
            keep[amb_idx] = False
            keep[amb_idx[np.sort(unique_first)]] = True
            bins = bins[keep]
            positions = positions[keep]

        counts = np.bincount(bins, minlength=capacity).astype(np.int32)

        # drop values of overflowed bins (reads return nothing for them anyway;
        # the reference's ByteKeyStore stops storing past the cap)
        overflowed = counts > max_interesting_count
        keep_value = ~overflowed[bins]
        kept_bins = bins[keep_value]
        kept_positions = positions[keep_value]
        order = np.lexsort((kept_positions, kept_bins))
        kept_bins = kept_bins[order]
        kept_positions = kept_positions[order]

        stored_counts = np.where(overflowed, 0, counts).astype(np.int64)
        offsets = np.zeros(capacity + 1, dtype=np.int64)
        np.cumsum(stored_counts, out=offsets[1:])

        return PackedIndex(
            num_basepairs_used=num_basepairs_used,
            capacity=capacity,
            max_interesting_count=max_interesting_count,
            counts=counts,
            offsets=offsets,
            values=kept_positions,
        )

    @staticmethod
    def empty(num_basepairs_used: int) -> "PackedIndex":
        """The capacity-1 placeholder for sizes with no stored blocks
        (HashBlock_Database.helpHashOnce, java:385-393)."""
        return PackedIndex(
            num_basepairs_used=num_basepairs_used,
            capacity=1,
            max_interesting_count=1,
            counts=np.zeros(1, dtype=np.int32),
            offsets=np.zeros(2, dtype=np.int64),
            values=np.zeros(0, dtype=np.int64),
        )

    # --- queries ---------------------------------------------------------

    def bin_of(self, key) -> np.ndarray:
        return np.mod(np.asarray(key, dtype=np.int64), self.capacity)

    def num_matches_lower_bound(self, key) -> np.ndarray | int:
        """PackedMap.getNumMatchesLowerBound (java:228-236): MAX_VALUE when the
        bin overflowed, else the bin count."""
        if isinstance(key, int):  # scalar fast path (the sequential walk)
            c = int(self.counts[key % self.capacity])
            return _INT_MAX if c > self.max_interesting_count else c
        b = self.bin_of(key)
        counts = self.counts[b].astype(np.int64)
        return np.where(counts > self.max_interesting_count, _INT_MAX, counts)

    def get(self, key: int, max_interesting_count: int = _INT_MAX) -> np.ndarray | None:
        """Positions for one key, or None when the bin is too popular
        (PackedMap.get, java:160-172)."""
        b = int(self.bin_of(key))
        count = int(self.counts[b])
        if count > max_interesting_count or count > self.max_interesting_count:
            return None
        return self.values[self.offsets[b] : self.offsets[b + 1]]

    def get_bin(self, bin_index: int) -> np.ndarray | None:
        count = int(self.counts[bin_index])
        if count > self.max_interesting_count:
            return None
        return self.values[self.offsets[bin_index] : self.offsets[bin_index + 1]]

    def knows_all_matches(self, key: int) -> bool:
        b = int(self.bin_of(key))
        return int(self.counts[b]) <= self.max_interesting_count

    def num_overfilled_keys(self) -> int:
        return int(np.count_nonzero(self.counts > self.max_interesting_count))

    def num_items_added(self) -> int:
        return int(self.counts.sum())

    def verify_matches(self, other: "PackedIndex") -> None:
        """Structural equality audit (PackedMap.verifyMatches, java:282-300;
        powers --verify-consistent-db)."""
        if self.capacity != other.capacity:
            raise AssertionError(f"capacity {self.capacity} != {other.capacity}")
        if self.max_interesting_count != other.max_interesting_count:
            raise AssertionError("max_interesting_count differs")
        if not np.array_equal(self.counts, other.counts):
            raise AssertionError("bin counts differ")
        if not np.array_equal(self.offsets, other.offsets):
            raise AssertionError("offsets differ")
        if not np.array_equal(self.values, other.values):
            raise AssertionError("values differ")

    # --- serialization (the DirCache "length-N" files) -------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            num_basepairs_used=self.num_basepairs_used,
            capacity=self.capacity,
            max_interesting_count=self.max_interesting_count,
            counts=self.counts,
            offsets=self.offsets,
            values=self.values,
        )

    @staticmethod
    def load(path: str) -> "PackedIndex":
        data = np.load(path)
        return PackedIndex(
            num_basepairs_used=int(data["num_basepairs_used"]),
            capacity=int(data["capacity"]),
            max_interesting_count=int(data["max_interesting_count"]),
            counts=data["counts"],
            offsets=data["offsets"],
            values=data["values"],
        )
