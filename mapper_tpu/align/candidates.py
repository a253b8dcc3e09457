"""Candidate generation: the adaptive hashblock path and offset voting.

Faithful port of the query-side search of the reference:

- HashBlockPath (HashBlockPath.java): walks the query's pyramid picking blocks
  whose gapmer has a useful number of index matches — too few (<6) move down to
  smaller blocks, too many move up to larger, otherwise move right.
- Counting_HashBlockPath (Counting_HashBlockPath.java): for every interesting
  block match, a cheap +-20bp sampling check rejects hash collisions, matches
  on reverse-strand contigs are re-expressed as (reverse-complement query vs
  forward contig), and evidence accrues to per-(strand, contig, offset)
  counters with neighbor links within half the maximum plausible indel length.
- HashBlockPaths_Counter (HashBlockPaths_Counter.java): combines 1-2 component
  paths into QueryMatches; for pairs, candidates are bucketed by strand and
  joined within the spacing window.

This is the per-query sequential control path; the batch pipeline replaces
the inner loops (index lookup -> gather, voting -> segment-sum) while this
module remains the semantic reference.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from mapper_tpu import basepairs
from mapper_tpu.index import scalar
from mapper_tpu.index.database import HashBlockDatabase
from mapper_tpu.index.hashblock import max_gapmer_num_basepairs_used
from mapper_tpu.sequence import Sequence, SequenceDatabase

USUAL_MATCHES_BEFORE_INVESTIGATING = 1  # Counting_HashBlockPath.java:18
_INT_MAX = 2**31 - 1


class QueryPyramid:
    """Lazy pyramid over a query sequence.

    Clean (unambiguous) queries compute each row with the vectorized
    whole-row kernels (index/hashblock.py — field-for-field identical to the
    scalar model by tests/test_hashblock.py's differential) and convert the
    arrays to ScalarHashBlock objects for the path walker; ambiguous queries
    keep the scalar object model (MultiBlock expansion)."""

    def __init__(self, sequence: Sequence):
        import os as _os

        self.sequence = sequence
        codes = sequence.codes
        self._vector_rows = None
        self._native_levels = None
        # clean queries defer the native whole-pyramid row build until a row
        # is actually requested: with the native walk + native counting the
        # Python walker never materializes rows at all, and mapper_query_walk
        # recomputes rows internally from the codes (the eager build was ~8% of
        # the fallback worker's time in a CPU profile)
        self._native_pending = False
        if codes.shape[0] and not np.any(basepairs.POPCOUNT_TABLE[codes] != 1):
            if _os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
                self._native_pending = True
                self.rows: list[list[scalar.Slot]] = []
                return
            from mapper_tpu.index import hashblock as _hb

            self._hb = _hb
            self._vector_rows = [_hb.base_row(codes)]
            self.rows = [_convert_block_row(self._vector_rows[0])]
        else:
            self.rows = [scalar.scalar_base_row(codes)]

    def native_eligible(self) -> bool:
        """True when the clean-query native row builder will serve get();
        the walk gate (HashBlockPath) keys off this without forcing the
        eager row build."""
        return self._native_pending or self._native_levels is not None

    def _force_native(self) -> None:
        if not self._native_pending:
            return
        self._native_pending = False
        codes = self.sequence.codes
        from mapper_tpu.native import native_query_rows

        nat = native_query_rows(codes)
        if nat is not None:
            counts, fields = nat
            levels = []
            off = 0
            for c in counts.tolist():
                levels.append(fields[off : off + c])
                off += c
            self._native_levels = levels
        else:
            from mapper_tpu.index import hashblock as _hb

            self._hb = _hb
            self._vector_rows = [_hb.base_row(codes)]
            self.rows = [_convert_block_row(self._vector_rows[0])]

    def get(self, level: int) -> list[scalar.Slot]:
        if self._native_pending:
            self._force_native()
        while len(self.rows) <= level:
            if self._native_levels is not None:
                idx = len(self.rows)
                if idx < len(self._native_levels):
                    self.rows.append(_convert_fields_row(self._native_levels[idx]))
                else:
                    # the native builder stops at the first <2-block row;
                    # every deeper merge is empty
                    self.rows.append([])
            elif self._vector_rows is not None:
                nxt = self._hb.merge_row(self._vector_rows[-1])
                self._vector_rows.append(nxt)
                self.rows.append(_convert_block_row(nxt))
            else:
                self.rows.append(scalar.scalar_merge_row(self.rows[-1]))
        return self.rows[level]


def _convert_fields_row(fields: np.ndarray) -> list[scalar.Slot]:
    """Native row fields ([k, 10] int32: start, length, fwd, rev, extra,
    gap_dir, req_l, req_r, next_l, next_r) -> ScalarHashBlock objects."""
    out = []
    for start, length, fwd, rev, extra, gap_dir, req_l, req_r, next_l, next_r in (
        fields.tolist()
    ):
        b = scalar.ScalarHashBlock(start, length)
        b.fwd = fwd
        b.rev = rev
        b.req_l = bool(req_l)
        b.req_r = bool(req_r)
        b.next_l = bool(next_l)
        b.next_r = bool(next_r)
        b.gap_dir = gap_dir
        b.extra_gapmer = extra
        out.append(b)
    return out


def _convert_block_row(row) -> list[scalar.Slot]:
    """BlockRow (struct-of-arrays) -> ScalarHashBlock objects."""
    n = len(row)
    if n == 0:
        return []
    starts = row.start.tolist()
    lengths = row.length.tolist()
    fwds = row.fwd.tolist()
    revs = row.rev.tolist()
    req_ls = row.req_l.tolist()
    req_rs = row.req_r.tolist()
    next_ls = row.next_l.tolist()
    next_rs = row.next_r.tolist()
    gap_dirs = row.gap_dir.tolist()
    extras = row.extra_gapmer.tolist()
    out = []
    for k in range(n):
        b = scalar.ScalarHashBlock(starts[k], lengths[k])
        b.fwd = fwds[k]
        b.rev = revs[k]
        b.req_l = req_ls[k]
        b.req_r = req_rs[k]
        b.next_l = next_ls[k]
        b.next_r = next_rs[k]
        b.gap_dir = gap_dirs[k]
        b.extra_gapmer = extras[k]
        out.append(b)
    return out


def _slot_start(slot: scalar.Slot) -> int:
    return slot.start


def _row_get_after(row: list[scalar.Slot], position: int) -> scalar.Slot | None:
    """First slot with start > position (HashBlock_Row.getAfter)."""
    lo, hi = 0, len(row)
    while lo < hi:
        mid = (lo + hi) // 2
        if row[mid].start > position:
            hi = mid
        else:
            lo = mid + 1
    return row[lo] if lo < len(row) else None


def _row_get(row: list[scalar.Slot], position: int) -> scalar.Slot | None:
    slot = _row_get_after(row, position - 1)
    if slot is not None and _slot_start(slot) == position:
        return slot
    return None


class HashBlockPath:
    """HashBlockPath.java: adaptive walk emitting interesting gapmers."""

    def __init__(self, pyramid: QueryPyramid, database: HashBlockDatabase, query: Sequence):
        import os as _os

        self.pyramid = pyramid
        self.database = database
        self.query = query
        self.batch_index = -1
        self.current: scalar.Slot | None = scalar.ScalarHashBlock(0, 0)
        self.current_gapmer: scalar.ScalarHashBlock | None = None
        self.current_gapmer_computed = False
        self.prev_interesting: scalar.ScalarHashBlock | None = None
        self.prev_prev_interesting: scalar.ScalarHashBlock | None = None
        # precomputed native walk: the interesting-block sequence is a pure
        # function of (query, index counts) — no feedback from match results —
        # so one C call replaces the per-block Python navigation; blocks are
        # materialized lazily as they are consumed.  The Python walk below is
        # the oracle (MAPPER_TPU_NATIVE=0) and the fallback.
        self._native_seq = None
        self._native_pos = 0
        if (
            pyramid.native_eligible()
            and _os.environ.get("MAPPER_TPU_NATIVE", "1") != "0"
            and _os.environ.get("MAPPER_TPU_NATIVE_WALK", "1") != "0"
        ):
            from mapper_tpu.native import native_query_walk

            self._native_seq = native_query_walk(query.codes, database)

    # --- navigation (java:99-140) ----------------------------------------

    def _move_down(self) -> None:
        self.batch_index -= 1
        start = _slot_start(self.current)
        self.current = _row_get_after(self.pyramid.get(self.batch_index), start)
        self._clear_gapmer()

    def _move_up_or_right(self) -> None:
        left = self.current.getSingle() if hasattr(self.current, "getSingle") else self.current
        start = _slot_start(self.current)
        up = _row_get(self.pyramid.get(self.batch_index + 1), start)
        if up is not None and _slot_start(up) <= start:
            self.batch_index += 1
            self.current = up
            self._clear_gapmer()
        else:
            self._move_right()

    def _move_right(self) -> None:
        self.current = _row_get_after(
            self.pyramid.get(self.batch_index), _slot_start(self.current)
        )
        self._clear_gapmer()

    def _clear_gapmer(self) -> None:
        self.current_gapmer = None
        self.current_gapmer_computed = False

    def _skip_multiblocks(self) -> None:
        while True:
            if self.current is None or isinstance(self.current, scalar.ScalarHashBlock):
                return
            if self.batch_index > 0:
                self._move_down()
            else:
                self._move_right()

    def _with_gap(self) -> scalar.ScalarHashBlock | None:
        if not self.database.get_enable_gapmers():
            return self.current
        if not self.current_gapmer_computed:
            self.current_gapmer = self.current.with_gap_and_extension(self.query.codes)
            self.current_gapmer_computed = True
        return self.current_gapmer

    # --- match-count thresholds (java:205-223) ----------------------------

    def _max_num_matches_allowed(self, block: scalar.ScalarHashBlock) -> int:
        if block.length >= len(self.query) // 6:
            return self.database.get_max_num_matches_allowed(block.num_basepairs_used)
        if block.req_r:
            return 5
        return block.num_basepairs_used + 1

    def _num_matches_lower_bound(self, block: scalar.ScalarHashBlock) -> int:
        return self.database.num_matches_lower_bound(
            block.num_basepairs_used, block.lookup_key()
        )

    # --- stepping (java:143-195) ------------------------------------------

    def _advance_to_next_position(self) -> scalar.ScalarHashBlock | None:
        single = (
            self.current if isinstance(self.current, scalar.ScalarHashBlock) else None
        )
        enable_gapmers = self.database.get_enable_gapmers()
        if (
            single is not None
            and enable_gapmers
            and max_gapmer_num_basepairs_used(single.length)
            < self.database.get_min_interesting_size()
        ):
            self._move_up_or_right()
        else:
            extended = self._with_gap()
            if extended is not None:
                num_matches = self._num_matches_lower_bound(extended)
                if num_matches < 6:
                    if self.batch_index > 0:
                        self._move_down()
                    else:
                        self._move_right()
                elif num_matches > self._max_num_matches_allowed(extended):
                    self._move_up_or_right()
                else:
                    self._move_right()
            else:
                typical = single.length * 3 // 2
                if typical <= self.database.get_min_interesting_size() and enable_gapmers:
                    self._move_up_or_right()
                else:
                    if self.batch_index > 0:
                        self._move_down()
                    else:
                        self._move_right()
        self._skip_multiblocks()
        if self.current is None:
            return None
        return self.current

    def _get_next_block_with_good_number_of_matches(self) -> scalar.ScalarHashBlock | None:
        while True:
            nxt = self._advance_to_next_position()
            if nxt is None:
                return None
            extended = self._with_gap()
            if extended is None:
                continue
            if self._num_matches_lower_bound(extended) > self._max_num_matches_allowed(
                extended
            ):
                continue
            return extended

    def _recently_seen(self, block: scalar.ScalarHashBlock) -> bool:
        result = False
        if self.prev_interesting is not None and block.fwd == self.prev_interesting.fwd:
            result = True
        elif (
            self.prev_prev_interesting is not None
            and block.fwd == self.prev_prev_interesting.fwd
        ):
            result = True
        self.prev_prev_interesting = self.prev_interesting
        self.prev_interesting = block
        return result

    def get_next_interesting_block(self) -> scalar.ScalarHashBlock | None:
        seq = self._native_seq
        if seq is not None:
            if self._native_pos >= seq.shape[0]:
                return None
            start, total_len, num_bp, fwd, rev, req_l, req_r, b1, gap = seq[
                self._native_pos
            ].tolist()
            self._native_pos += 1
            b = scalar.ScalarHashBlock(start, total_len)
            b.num_basepairs_used = num_bp
            b.fwd = fwd
            b.rev = rev
            b.req_l = bool(req_l)
            b.req_r = bool(req_r)
            b.gapped_block1_length = b1
            b.gapped_gap_length = gap
            b.walk_index = self._native_pos - 1
            return b
        if self.current is None:
            return None
        while True:
            result = self._get_next_block_with_good_number_of_matches()
            if result is None:
                return None
            if self._recently_seen(result):
                continue
            return result


@dataclass
class SequenceMatch:
    """SequenceMatch.java: query sequence A matches contig B at an offset."""

    sequence_a: Sequence
    sequence_b: Sequence
    offset: int
    from_hashblock_match: bool = True

    @property
    def start_index_b(self) -> int:
        return max(0, self.offset)

    @property
    def end_index_b(self) -> int:
        return min(self.offset + len(self.sequence_a), len(self.sequence_b))

    @property
    def reversed(self) -> bool:
        return self.sequence_a.complemented_from is not None

    def same_as(self, other: "SequenceMatch") -> bool:
        return (
            self.offset == other.offset
            and self.sequence_a is other.sequence_a
            and self.sequence_b is other.sequence_b
        )

    def summarize_position_b(self) -> str:
        return f"{self.sequence_b.name} offset {self.offset}"


class MatchCounter:
    """HashBlockMatch_Counter.java: evidence for one (strand, contig, offset)."""

    __slots__ = (
        "match",
        "history",
        "num_matches",
        "num_distinct_mismatches",
        "last_mismatched_position",
        "last_matched_block",
        "history_index",
        "good",
        "priority",
        "prev_counter",
        "next_counter",
    )

    def __init__(self, match: SequenceMatch, history: list, initial_mismatches: int, last_pos: int):
        self.match = match
        self.history = history
        self.num_matches = 0
        self.num_distinct_mismatches = initial_mismatches
        self.last_mismatched_position = last_pos
        self.last_matched_block = None
        self.history_index = len(history) - 1
        self.good = False
        self.priority = 0
        self.prev_counter: MatchCounter | None = None
        self.next_counter: MatchCounter | None = None

    def add_match(self, block) -> None:
        self.num_matches += 1
        self.last_matched_block = block

    def update(self) -> None:
        while self.history_index < len(self.history):
            block = self.history[self.history_index]
            if block is not self.last_matched_block:
                if block.start >= self.last_mismatched_position:
                    if self.match.offset + block.end <= len(self.match.sequence_b):
                        self.num_distinct_mismatches += 1
                        self.last_mismatched_position = block.end
            self.history_index += 1

    def get_num_distinct_mismatches(self) -> int:
        self.update()
        return self.num_distinct_mismatches

    def set_good(self) -> None:
        self.good = True
        self.priority = self.get_num_distinct_mismatches()


class CountingHashBlockPath:
    """Counting_HashBlockPath.java: step the path, vote offsets."""

    def __init__(
        self,
        database: HashBlockDatabase,
        query: Sequence,
        params,
        name: str = "seq",
    ):
        self.database = database
        self.seq_db: SequenceDatabase = database.get_sequence_database()
        self.query = query
        self.reverse_complement_query = query.reverse_complement()
        self.name = name
        self.pyramid = QueryPyramid(query)
        self.path = HashBlockPath(self.pyramid, database, query)
        # with a precomputed native walk, every interesting block's index
        # lookup (bin count, positions, secondary-polarity strand fold) is
        # known up front — batch them in one vectorized pass instead of one
        # PackedIndex.get + decode per block (the walk sequence already
        # triggered any lazy growth, so merged_index is final here)
        self._prefetched = None
        # fully-resolved prefetch: positions decoded, collision checks run
        # natively, strand fold applied — step() just replays arrays
        self._prefetched2 = None
        self._raw_counts = None
        seq_arr = self.path._native_seq
        if seq_arr is not None and seq_arr.shape[0]:
            import os as _os

            fold_enabled = _os.environ.get("MAPPER_TPU_NATIVE_FOLD", "1") != "0"
            if fold_enabled:
                # single native call for the whole walk's lookups + collision
                # checks + strand folds (candidates.cpp::mapper_prefetch_fold;
                # _prefetch_matches + _fold_and_filter are the oracle —
                # tests/test_native_walk.py::test_prefetch_fold_native_equals_python)
                from mapper_tpu.native import native_prefetch_fold

                nf = native_prefetch_fold(seq_arr, database, query.codes)
                if nf is not None:
                    popular, raw_counts, bounds, fi, fo, ir = nf
                    self._raw_counts = raw_counts
                    self._prefetched2 = (fi, fo, ir, bounds, popular)
            if self._prefetched2 is None:
                self._prefetched = self._prefetch_matches(seq_arr)
                if fold_enabled:
                    self._prefetched2 = self._fold_and_filter(
                        seq_arr, self._prefetched
                    )
        max_possible_indel = int(
            (len(query) * params.max_error_rate - params.deletion_start_penalty)
            / params.deletion_extension_penalty
        )
        self.max_indel_length_to_consider = max_possible_indel // 2
        # {(reversed, id(ref_seq)): sorted offsets list + dict offset->counter}
        self.counters: dict[tuple[bool, int], tuple[list[int], dict[int, MatchCounter]]] = {}
        self.ref_by_key: dict[tuple[bool, int], Sequence] = {}
        self.good_counters: list[MatchCounter] = []
        self.found_good_counter = False
        self.history: list = []
        self.num_blocks_matching_anywhere = 0
        self.num_match_counters = 0
        self.max_nonoverlapping_block_visited = 0
        self.num_nonoverlapping_blocks_visited = 0
        self.min_num_distinct_mismatches = -1
        self.done = False
        self.pending_blocks: list = []
        self._prev_high_priority: list[MatchCounter] | None = None
        self._all_positions_memo: list[MatchCounter] | None = None

    def _prefetch_matches(self, seq_arr: np.ndarray):
        """Vectorized match_block for every block of the native walk sequence.
        Returns a list parallel to the walk: None where the bin is too popular
        (match_block's None), else the encoded global positions with the
        secondary-polarity strand fold applied — element-for-element what
        database.match_block returns (pinned by tests/test_native_walk.py)."""
        db = self.database
        merged = db.merged_index()
        num_bp = seq_arr[:, 2].astype(np.int64)
        fwd = seq_arr[:, 3].astype(np.int64)
        rev = seq_arr[:, 4].astype(np.int64)
        req_l = seq_arr[:, 5] != 0
        req_r = seq_arr[:, 6] != 0
        total_len = seq_arr[:, 1].astype(np.int64)
        primary = np.where(req_l != req_r, req_l, fwd >= rev)
        key = np.where(primary, fwd, rev)
        caps = merged["caps"][num_bp]
        bins = merged["bases"][num_bp] + np.remainder(key, merged["capacities"][num_bp])
        cnt = merged["counts"][bins]
        popular = cnt > caps
        take = np.where(popular, 0, cnt).astype(np.int64)
        total = int(take.sum())
        if total:
            starts = merged["offsets"][bins]
            run_starts = np.cumsum(take) - take
            flat = (
                np.repeat(starts, take)
                + np.arange(total, dtype=np.int64)
                - np.repeat(run_starts, take)
            )
            vals = merged["values"][flat]
            sec = np.repeat(~primary, take)
            if np.any(sec):
                seq_db = db.get_sequence_database()
                lens_per = np.repeat(total_len, take)[sec]
                seq_idx, offs = seq_db.decode_positions(vals[sec])
                rc_idx = db._rc_index[seq_idx]
                vals[sec] = (
                    seq_db.starts[rc_idx]
                    + db._seq_lengths[seq_idx]
                    - offs
                    - lens_per
                )
            pieces = np.split(vals, np.cumsum(take)[:-1]) if take.shape[0] > 1 else [vals]
        else:
            pieces = [np.zeros(0, dtype=np.int64)] * take.shape[0]
        return [
            None if popular[k] else pieces[k] for k in range(seq_arr.shape[0])
        ]

    def _fold_and_filter(self, seq_arr: np.ndarray, pieces):
        """Resolve the prefetched match lists all the way to what
        _update_matches consumes: decode every encoded position once, run the
        +-20bp collision checks in one native call
        (candidates.cpp::mapper_collision_batch; _passes_collision_check is
        the oracle), and apply the reverse-strand fold — so step() only
        replays (fold_seq_idx, fold_offset, is_rc) rows for the survivors.
        Returns (fold_idx, fold_off, is_rc, bounds, popular) or None when the
        native library is unavailable (step() then uses the per-match Python
        path)."""
        from mapper_tpu.native import native_collision_batch

        db = self.database
        seq_db = self.seq_db
        qn = len(self.query)
        nb = seq_arr.shape[0]
        popular = np.fromiter((p is None for p in pieces), dtype=bool, count=nb)
        take = np.fromiter(
            (0 if p is None else p.shape[0] for p in pieces), dtype=np.int64, count=nb
        )
        total = int(take.sum())
        if total == 0:
            empty = np.zeros(0, dtype=np.int64)
            return (
                empty,
                empty,
                np.zeros(0, dtype=bool),
                np.zeros(nb + 1, dtype=np.int64),
                popular,
            )
        vals = np.concatenate([p for p in pieces if p is not None and p.shape[0]])
        seq_idx, offs = seq_db.decode_positions(vals)
        bstart = np.repeat(seq_arr[:, 0].astype(np.int64), take)
        blen = np.repeat(seq_arr[:, 1].astype(np.int64), take)
        bnbp = np.repeat(seq_arr[:, 2].astype(np.int64), take)
        seq_lens = db._seq_lengths[seq_idx]
        starts = seq_db.starts
        ok = native_collision_batch(
            self.query.codes,
            seq_db.concatenated_codes(),
            starts[seq_idx] + offs,
            offs,
            seq_lens,
            bstart,
            blen,
            bnbp,
        )
        if ok is None:
            return None
        rc_flags = getattr(db, "_rc_flags_arr", None)
        if rc_flags is None:
            rc_flags = np.fromiter(
                (s.complemented_from is not None for s in seq_db.sequences),
                dtype=bool,
                count=len(seq_db.sequences),
            )
            db._rc_flags_arr = rc_flags
        sel = ok != 0
        seq_idx = seq_idx[sel]
        offs = offs[sel]
        bstart_s = bstart[sel]
        blen_s = blen[sel]
        seq_lens_s = seq_lens[sel]
        is_rc = rc_flags[seq_idx]
        fold_idx = np.where(is_rc, db._rc_index[seq_idx], seq_idx)
        # RC fold (java:154-166): offset in forward coordinates
        fold_off = np.where(
            is_rc,
            (seq_lens_s - (offs + blen_s)) - (qn - (bstart_s + blen_s)),
            offs - bstart_s,
        )
        block_ids = np.repeat(np.arange(nb, dtype=np.int64), take)[sel]
        counts_ok = np.bincount(block_ids, minlength=nb)
        bounds = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(counts_ok, out=bounds[1:])
        return fold_idx, fold_off, is_rc, bounds, popular

    # --- block feed (java:344-384) ----------------------------------------

    def _get_next_interesting_block(self):
        self._all_positions_memo = None
        while True:
            block = self.path.get_next_interesting_block()
            if block is None:
                if not self.pending_blocks:
                    return None
                return self.pending_blocks.pop(0)
            if block.start < self.max_nonoverlapping_block_visited:
                self.pending_blocks.append(block)
                continue
            return block

    def step(self) -> bool:
        """Advance one interesting block; returns False when exhausted
        (java:40-179)."""
        if self.done:
            return False
        pre2 = self._prefetched2
        use2 = False
        while True:
            block = self._get_next_interesting_block()
            if block is None:
                self.done = True
                if self.num_blocks_matching_anywhere < USUAL_MATCHES_BEFORE_INVESTIGATING:
                    self.try_ensure_good_match_counter()
                return False
            if pre2 is not None and block.walk_index >= 0:
                if pre2[4][block.walk_index]:
                    continue  # too-popular bin (match_block None)
                matches = None
                use2 = True
                break
            if self._prefetched is not None and block.walk_index >= 0:
                matches = self._prefetched[block.walk_index]
            else:
                matches = self.database.match_block(
                    block.num_basepairs_used,
                    block.length,
                    block.lookup_key(),
                    block.is_primary_polarity(),
                )
            if matches is None:
                continue
            break

        self.history.append(block)
        if use2:
            # fully-resolved prefetch: replay the collision-filtered,
            # strand-folded rows (bit-identical to the branch below —
            # tests/test_native_walk.py::test_fold_and_filter_matches_python)
            fold_idx, fold_off, is_rc, bounds, _ = pre2
            w = block.walk_index
            if self._raw_counts is not None:
                num_block_matches = int(self._raw_counts[w])
            else:
                raw = self._prefetched[w]
                num_block_matches = 0 if raw is None else int(raw.shape[0])
            for k in range(int(bounds[w]), int(bounds[w + 1])):
                ref_b = self.seq_db.get_sequence(int(fold_idx[k]))
                seq_a = self.reverse_complement_query if is_rc[k] else self.query
                self._update_matches(
                    SequenceMatch(seq_a, ref_b, int(fold_off[k])),
                    block,
                    num_block_matches,
                )
        else:
            num_block_matches = len(matches)
            if num_block_matches:
                seq_idx, offsets = self.seq_db.decode_positions(matches)
                concat = self.seq_db.concatenated_codes()
                for k in range(num_block_matches):
                    ref_seq = self.seq_db.get_sequence(int(seq_idx[k]))
                    ref_start = int(offsets[k])
                    if not self._passes_collision_check(block, ref_seq, ref_start):
                        continue
                    if ref_seq.complemented_from is not None:
                        forward_ref = ref_seq.complemented_from
                        rev_query_block_start = len(self.query) - block.end
                        rev_ref_block_start = len(ref_seq) - (ref_start + block.length)
                        offset = rev_ref_block_start - rev_query_block_start
                        full_match = SequenceMatch(
                            self.reverse_complement_query, forward_ref, offset
                        )
                    else:
                        full_match = SequenceMatch(
                            self.query, ref_seq, ref_start - block.start
                        )
                    self._update_matches(full_match, block, num_block_matches)

        if block.start >= self.max_nonoverlapping_block_visited:
            self.max_nonoverlapping_block_visited = block.end
            self.num_nonoverlapping_blocks_visited += 1
        self.num_blocks_matching_anywhere += 1
        self.min_num_distinct_mismatches = -1
        return True

    def _passes_collision_check(
        self, block: scalar.ScalarHashBlock, ref_seq: Sequence, ref_start: int
    ) -> bool:
        """The +-20bp sampling check rejecting hash collisions (java:95-153)."""
        q = self.query.codes_bytes
        r = ref_seq.codes_bytes
        qn = len(q)
        rn = len(r)
        bs = block.start
        right = bs + block.length - 1
        n_mismatch = 0
        n_match = 0
        for distance in range(1, 20):
            for qi in (bs - distance, right + distance):
                if 0 <= qi < qn:
                    ri = qi - bs + ref_start
                    if 0 <= ri < rn:
                        # scalar can_match inlined: (a & b) != 0 on raw ints
                        if not (q[qi] & r[ri]):
                            n_mismatch += 1
                        else:
                            n_match += 1
            if n_match < n_mismatch:
                break
            if n_match >= n_mismatch + block.num_basepairs_used:
                break
        return n_mismatch <= n_match

    def _update_matches(
        self, match: SequenceMatch, block: scalar.ScalarHashBlock, num_block_matches: int
    ) -> None:
        """Counting_HashBlockPath.updateMatches (java:193-252)."""
        key = (match.reversed, id(match.sequence_b))
        if key not in self.counters:
            self.counters[key] = ([], {})
            self.ref_by_key[key] = match.sequence_b
        offsets_sorted, by_offset = self.counters[key]
        offset = match.offset

        counter = by_offset.get(offset)
        if counter is None:
            counter = MatchCounter(
                match,
                self.history,
                self.num_nonoverlapping_blocks_visited,
                block.start,
            )
            self.num_match_counters += 1
            i = bisect.bisect_left(offsets_sorted, offset)
            # link neighbors within the indel window (java:214-233)
            if i > 0:
                prev_off = offsets_sorted[i - 1]
                if abs(prev_off - offset) <= self.max_indel_length_to_consider:
                    prev_counter = by_offset[prev_off]
                    counter.prev_counter = prev_counter
                    prev_counter.next_counter = counter
            if i < len(offsets_sorted):
                next_off = offsets_sorted[i]
                if abs(next_off - offset) <= self.max_indel_length_to_consider:
                    next_counter = by_offset[next_off]
                    counter.next_counter = next_counter
                    next_counter.prev_counter = counter
            offsets_sorted.insert(i, offset)
            by_offset[offset] = counter

        if counter.prev_counter is not None:
            self._add_match(match, block, counter.prev_counter, num_block_matches)
        if counter.next_counter is not None:
            self._add_match(match, block, counter.next_counter, num_block_matches)
        update_this_one = True
        if (counter.prev_counter is not None and counter.prev_counter.good) or (
            counter.next_counter is not None and counter.next_counter.good
        ):
            if not counter.good:
                update_this_one = False
        if update_this_one:
            self._add_match(match, block, counter, num_block_matches)

    def _add_match(
        self,
        match: SequenceMatch,
        block: scalar.ScalarHashBlock,
        counter: MatchCounter,
        num_block_matches: int,
    ) -> None:
        counter.add_match(block)
        counter.update()
        if counter.num_matches == USUAL_MATCHES_BEFORE_INVESTIGATING:
            self.found_good_counter = True
            self._declare_good(counter)

    def _declare_good(self, counter: MatchCounter) -> None:
        if not counter.good:
            self.good_counters.append(counter)
            counter.set_good()

    def try_ensure_good_match_counter(self) -> None:
        """java:291-308: for tiny queries, declare everything good."""
        if not self.found_good_counter and self.num_match_counters <= len(self.query):
            for offsets_sorted, by_offset in self.counters.values():
                for counter in by_offset.values():
                    self._declare_good(counter)
            self.found_good_counter = True

    # --- queries over the counters ----------------------------------------

    def find_good_positions_having_priority_up_to(self, priority: int) -> list[MatchCounter]:
        while True:
            if (
                self.num_nonoverlapping_blocks_visited
                >= priority + USUAL_MATCHES_BEFORE_INVESTIGATING
            ):
                break
            if not self.step():
                break
        if self._prev_high_priority is not None and len(self._prev_high_priority) == len(
            self.good_counters
        ):
            return self._prev_high_priority
        matches = [c for c in self.good_counters if c.priority <= priority]
        self._prev_high_priority = matches
        return matches

    def get_all_positions(self) -> list[MatchCounter]:
        if self._all_positions_memo is None:
            results: list[MatchCounter] = []
            for offsets_sorted, by_offset in self.counters.values():
                for off in offsets_sorted:
                    results.append(by_offset[off])
            self._all_positions_memo = results
        return self._all_positions_memo

    def get_num_blocks(self) -> int:
        return self.num_blocks_matching_anywhere

    def _get_num_good_distinct_mismatches(self) -> int:
        if self.min_num_distinct_mismatches < 0:
            minimum = self.num_nonoverlapping_blocks_visited - 1
            for counter in self.good_counters:
                count = counter.get_num_distinct_mismatches()
                if minimum >= count:
                    minimum = count
            self.min_num_distinct_mismatches = minimum
        return self.min_num_distinct_mismatches

    def get_best_matches(self) -> list[MatchCounter]:
        if self.num_blocks_matching_anywhere < USUAL_MATCHES_BEFORE_INVESTIGATING:
            return []
        minimum = self._get_num_good_distinct_mismatches()
        return [
            c for c in self.good_counters if c.get_num_distinct_mismatches() <= minimum
        ]

    def is_done(self) -> bool:
        return self.done


@dataclass
class QueryMatch:
    """QueryMatch.java: 1-2 SequenceMatches + priority + order hint."""

    components: list[SequenceMatch]
    priority: int
    hint_forward_order: bool = True

    def get_num_sequences(self) -> int:
        return len(self.components)

    def get_component(self, i: int) -> SequenceMatch:
        return self.components[i]

    def get_query_total_length(self) -> int:
        return sum(len(m.sequence_a) for m in self.components)

    def get_start_index_b(self) -> int:
        return min(self.components[0].start_index_b, self.components[-1].start_index_b)

    def get_end_index_b(self) -> int:
        return max(self.components[0].start_index_b, self.components[-1].start_index_b)

    def get_total_distance_across(self) -> int:
        """QueryMatch.getTotalDistanceAcross (java:60-67)."""
        first, last = self.components[0], self.components[-1]
        if self.components[0].reversed:
            return first.end_index_b - last.start_index_b
        return last.end_index_b - first.start_index_b

    def get_total_distance_between_components(self) -> int:
        """QueryMatch.getTotalDistanceBetweenComponents (java:70-79)."""
        total = 0
        prev = self.components[0]
        reversed_ = self.components[0].reversed
        for i in range(1, len(self.components)):
            cur = self.components[i]
            if prev.sequence_b is not cur.sequence_b:
                return _INT_MAX
            if reversed_:
                total += prev.start_index_b - cur.end_index_b
            else:
                total += cur.start_index_b - prev.end_index_b
            prev = cur
        return total

    def same_position(self, other: "QueryMatch") -> bool:
        if len(self.components) != len(other.components):
            return False
        return all(
            a.same_as(b) for a, b in zip(self.components, other.components)
        )

    def summarize_position_b(self) -> str:
        return " / ".join(c.summarize_position_b() for c in self.components)


class PathsCounter:
    """HashBlockPaths_Counter.java: combine 1-2 component paths."""

    def __init__(
        self,
        components: list[CountingHashBlockPath],
        expected_inner_distance: int,
        max_inner_distance: int,
    ):
        if len(components) > 2:
            raise ValueError("at most 2 query components supported")
        self.components = components
        self.max_offset_between_components = max_inner_distance + len(
            components[0].query
        )
        self.found_nonempty_result = False
        self._prev_components: list[list[MatchCounter]] | None = None
        self._prev_matches: list[QueryMatch] | None = None

    def find_good_positions_having_priority(self, num_mismatches: int) -> list[QueryMatch]:
        all_matches = self._find_good_positions_with_priority_up_to(num_mismatches)
        return [m for m in all_matches if m.priority == num_mismatches]

    def _find_good_positions_with_priority_up_to(self, num_mismatches: int) -> list[QueryMatch]:
        pieces = []
        for component in self.components:
            matches_here = component.find_good_positions_having_priority_up_to(num_mismatches)
            if matches_here:
                self.found_nonempty_result = True
            pieces.append(matches_here)
        return self._match(pieces)

    def optimistic_get_best_matches(self) -> list[QueryMatch]:
        """java:84-98 + the max-priority filter of filterMatchesHavingMinPriority."""
        pieces = []
        for component in self.components:
            while True:
                best = component.get_best_matches()
                if len(best) == 1 or not component.step():
                    pieces.append(best)
                    break
        all_matches = self._match(pieces)
        # filterMatchesHavingMinPriority actually computes the MAX priority
        # (java:296-304) — reproduced as-is
        peak = -1
        for m in all_matches:
            if peak < 0 or peak < m.priority:
                peak = m.priority
        return [m for m in all_matches if m.priority == peak]

    def find_partially_good_positions(self) -> list[QueryMatch]:
        """java:26-49: pair one good side with all positions of a bad side."""
        if len(self.components) != 2:
            return []
        if not self.found_nonempty_result:
            return []
        pieces = []
        found_good = found_bad = False
        for component in self.components:
            matches_here = component.find_good_positions_having_priority_up_to(_INT_MAX)
            if not matches_here:
                found_bad = True
                matches_here = component.get_all_positions()
            else:
                found_good = True
            pieces.append(matches_here)
        if found_good and found_bad:
            return self._match_without_cache(pieces)
        return []

    def find_good_component_matches(
        self, sequence_index: int, max_priority: int
    ) -> list[SequenceMatch]:
        counters = self.components[sequence_index].find_good_positions_having_priority_up_to(
            max_priority
        )
        return [c.match for c in counters]

    def get_num_blocks(self) -> int:
        return sum(c.get_num_blocks() for c in self.components)

    def _match(self, pieces: list[list[MatchCounter]]) -> list[QueryMatch]:
        if self._prev_components is not None and all(
            a is b for a, b in zip(self._prev_components, pieces)
        ):
            return self._prev_matches
        self._prev_matches = self._match_without_cache(pieces)
        self._prev_components = pieces
        return self._prev_matches

    def _match_without_cache(self, pieces: list[list[MatchCounter]]) -> list[QueryMatch]:
        """java:136-247."""
        if len(pieces) == 1:
            return [QueryMatch([c.match], c.priority) for c in pieces[0]]

        last_component_is_largest = len(pieces[0]) <= len(pieces[1])
        # keyed by (query-match-reversed, id(ref)): sorted offsets + counters
        saved: dict[tuple[bool, int], tuple[list[int], dict[int, MatchCounter]]] = {}
        matched_groups: list[list[MatchCounter]] = []
        for i in range(2):
            component_index = i if last_component_is_largest else 1 - i
            choices = pieces[component_index]
            for counter in choices:
                match = counter.match
                query_len = len(match.sequence_a)
                max_reverse_offset = query_len // 2
                query_match_reversed = match.reversed == (component_index % 2 == 0)
                key = (query_match_reversed, id(match.sequence_b))
                offsets_sorted, by_offset = saved.setdefault(key, ([], {}))
                offset = match.offset
                if i == 0:
                    j = bisect.bisect_left(offsets_sorted, offset)
                    offsets_sorted.insert(j, offset)
                    by_offset[offset] = counter
                else:
                    if query_match_reversed == last_component_is_largest:
                        search_start = offset - max_reverse_offset
                        search_end = offset + self.max_offset_between_components
                    else:
                        search_start = offset - self.max_offset_between_components
                        search_end = offset + max_reverse_offset
                    lo = bisect.bisect_left(offsets_sorted, search_start)
                    hi = bisect.bisect_right(offsets_sorted, search_end)
                    nearby = offsets_sorted[lo:hi]
                    if query_match_reversed and len(nearby) > 1:
                        nearby = list(reversed(nearby))
                    for other_offset in nearby:
                        other = by_offset[other_offset]
                        if last_component_is_largest:
                            matched_groups.append([other, counter])
                        else:
                            matched_groups.append([counter, other])
        return self._assemble(matched_groups)

    def _assemble(self, groups: list[list[MatchCounter]]) -> list[QueryMatch]:
        results = []
        for group in groups:
            if len(group) > 1:
                hint_forward = (
                    group[0].get_num_distinct_mismatches()
                    < group[1].get_num_distinct_mismatches()
                )
            else:
                hint_forward = True
            priority = self._count_priority(group)
            results.append(
                QueryMatch([c.match for c in group], priority, hint_forward)
            )
        return results

    @staticmethod
    def _count_priority(group: list[MatchCounter]) -> int:
        """java:314-334: sum of priorities, or max when ref-overlapping."""
        if len(group) == 2:
            m1, m2 = group[0].match, group[1].match
            if m1.start_index_b < m2.end_index_b and m1.end_index_b > m2.start_index_b:
                return max(c.priority for c in group)
        return sum(c.priority for c in group)


class _NativeCounter:
    """MatchCounter-compatible proxy over one native counter (stable per
    (path, id) so list-identity memos behave like the Python oracle's).
    `priority` reads the live native value: like the Python attribute it is
    0 until the counter is declared good, then frozen — a proxy created
    before the declaration must still see the later value."""

    __slots__ = ("_path", "_id", "match")

    def __init__(self, path: "NativeCountingPath", cid: int, match: SequenceMatch):
        self._path = path
        self._id = cid
        self.match = match

    @property
    def priority(self) -> int:
        return int(self._path._lib.mapper_counting_priority(self._path._h, self._id))

    def get_num_distinct_mismatches(self) -> int:
        return int(
            self._path._lib.mapper_counting_distinct(self._path._h, self._id)
        )


class NativeCountingPath(CountingHashBlockPath):
    """CountingHashBlockPath with the counter state machine in C++
    (native/counting.cpp; this Python class is the oracle —
    tests/test_native_counting.py runs the step-for-step differential).
    Falls back to the Python machinery when the native library, walk, or
    fully-resolved prefetch is unavailable (ambiguous queries, tiny
    queries, MAPPER_TPU_NATIVE_COUNTING=0)."""

    def __init__(self, database: HashBlockDatabase, query: Sequence, params, name: str = "seq"):
        super().__init__(database, query, params, name)
        import ctypes
        import os as _os

        self._h = None
        if _os.environ.get("MAPPER_TPU_NATIVE_COUNTING", "1") == "0":
            return
        if self._prefetched2 is None:
            return
        seq_arr = self.path._native_seq
        if seq_arr is None or not seq_arr.shape[0]:
            return
        from mapper_tpu.native import get_counting_library

        lib = get_counting_library()
        if lib is None:
            return
        fi, fo, ir, bounds, popular = self._prefetched2
        # borrowed buffers: keep references alive for the handle's lifetime
        self._keep = (
            np.ascontiguousarray(seq_arr[:, 0].astype(np.int32, copy=False)),
            np.ascontiguousarray(
                (seq_arr[:, 0].astype(np.int64) + seq_arr[:, 1].astype(np.int64)).astype(np.int32)
            ),
            np.ascontiguousarray(popular.astype(np.uint8)),
            np.ascontiguousarray(bounds.astype(np.int64, copy=False)),
            np.ascontiguousarray(fi.astype(np.int64, copy=False)),
            np.ascontiguousarray(fo.astype(np.int64, copy=False)),
            np.ascontiguousarray(ir.astype(np.uint8)),
            np.ascontiguousarray(database._seq_lengths.astype(np.int64, copy=False)),
        )
        bstart, bend, pop_u8, bounds64, fi64, fo64, ir8, slen = self._keep
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        self._lib = lib
        self._h = lib.mapper_counting_create(
            bstart.ctypes.data_as(p_i32),
            bend.ctypes.data_as(p_i32),
            pop_u8.ctypes.data_as(p_u8),
            int(seq_arr.shape[0]),
            bounds64.ctypes.data_as(p_i64),
            fi64.ctypes.data_as(p_i64),
            fo64.ctypes.data_as(p_i64),
            ir8.ctypes.data_as(p_u8),
            slen.ctypes.data_as(p_i64),
            int(len(query)),
            int(self.max_indel_length_to_consider),
            USUAL_MATCHES_BEFORE_INVESTIGATING,
        )
        self._proxies: dict[int, _NativeCounter] = {}
        self._ids_buf = np.zeros(64, dtype=np.int32)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h is not None:
            try:
                self._lib.mapper_counting_destroy(h)
            except Exception:
                pass
            self._h = None

    # --- proxy plumbing ---------------------------------------------------

    def _proxy_list(self, ids: np.ndarray) -> list[_NativeCounter]:
        import ctypes

        proxies = self._proxies
        missing = [cid for cid in ids.tolist() if cid not in proxies]
        if missing:
            arr = np.asarray(missing, dtype=np.int32)
            info = np.empty((len(missing), 4), dtype=np.int64)
            self._lib.mapper_counting_info(
                self._h,
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(missing),
                info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            get_seq = self.seq_db.get_sequence
            for j, cid in enumerate(missing):
                rc = bool(info[j, 0])
                seq_a = self.reverse_complement_query if rc else self.query
                match = SequenceMatch(seq_a, get_seq(int(info[j, 1])), int(info[j, 2]))
                proxies[cid] = _NativeCounter(self, cid, match)
        return [proxies[cid] for cid in ids.tolist()]

    def _fetch_ids(self, fn, *args) -> np.ndarray:
        cap = int(self._lib.mapper_counting_num_counters(self._h))
        if self._ids_buf.shape[0] < cap:
            self._ids_buf = np.zeros(max(cap, 2 * self._ids_buf.shape[0]), dtype=np.int32)
        import ctypes

        n = int(fn(self._h, *args, self._ids_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))))
        return self._ids_buf[:n]

    # --- CountingHashBlockPath API over the native state machine ----------

    def step(self) -> bool:
        if self._h is None:
            return super().step()
        if not self._lib.mapper_counting_is_done(self._h):
            self._all_positions_memo = None
        return bool(self._lib.mapper_counting_step(self._h))

    def find_good_positions_having_priority_up_to(self, priority: int) -> list:
        if self._h is None:
            return super().find_good_positions_having_priority_up_to(priority)
        target = int(priority) + USUAL_MATCHES_BEFORE_INVESTIGATING
        # memo invalidation mirrors the oracle: only an actual step() call
        # (not-done, below target) clears the all-positions memo
        if not self._lib.mapper_counting_is_done(self._h) and (
            int(self._lib.mapper_counting_num_nonoverlap(self._h)) < target
        ):
            self._all_positions_memo = None
        self._lib.mapper_counting_run_until_nonoverlap(self._h, target)
        num_good = int(self._lib.mapper_counting_num_good(self._h))
        if (
            self._prev_high_priority is not None
            and len(self._prev_high_priority) == num_good
        ):
            return self._prev_high_priority
        ids = self._fetch_ids(self._lib.mapper_counting_good_upto, int(priority))
        matches = self._proxy_list(ids)
        self._prev_high_priority = matches
        return matches

    def get_best_matches(self) -> list:
        if self._h is None:
            return super().get_best_matches()
        ids = self._fetch_ids(self._lib.mapper_counting_best)
        return self._proxy_list(ids)

    def get_all_positions(self) -> list:
        if self._h is None:
            return super().get_all_positions()
        if self._all_positions_memo is None:
            ids = self._fetch_ids(self._lib.mapper_counting_all_positions)
            self._all_positions_memo = self._proxy_list(ids)
        return self._all_positions_memo

    def get_num_blocks(self) -> int:
        if self._h is None:
            return super().get_num_blocks()
        return int(self._lib.mapper_counting_num_blocks(self._h))

    def is_done(self) -> bool:
        if self._h is None:
            return super().is_done()
        return bool(self._lib.mapper_counting_is_done(self._h))
