"""Fully on-device candidate generation: pyramid -> gapmers -> index lookup ->
offset voting -> per-read top-K, as one jitted plain-XLA program.

This is the on-device replacement for the host candidate pass
(batch/candidates.py numpy path, native/candidates.cpp): the per-read
content-defined pyramid (HashBlock.java's merge rules, reproduced bit-for-bit)
is computed for a whole padded [B, L] read batch with masked dense rows —
blocks never compact, they just invalidate, and each block finds its next
valid neighbor with a suffix-min scan.  Seed lookup gathers into the
device-resident merged index, and offset voting replaces the host sort with an
O(P^2) equality-count (mode finding) plus an argmax top-K — no XLA sorts or
data-dependent shapes anywhere, which keeps compiles short (a sort-based
voting attempt compiled for more than ten minutes).

64-bit-free hashing: JAX runs with x64 disabled, so HashBlock.mergeHashes'
Java-long arithmetic (HashBlock.java:261-269)
is emulated exactly in uint32 limbs (_mul32x32 / _merge_hashes_u32); the
differential tests pin bit-identity against index/hashblock.py's int64 numpy
implementation.

Output parity: the candidate table equals batch/candidates.py's
generate_candidates for ambiguity-free reads (same keys, votes, top-K order,
noise filter) — pinned by tests/test_device_candidates.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mapper_tpu.index.hashblock import (
    GAPMER_MULTIPLIER,
    _GAPMER_MULTIPLIER_INVERSE,
    MERGE_LENGTH_MULTIPLIER,
    MERGE_MULTIPLIER,
)

# ---------------------------------------------------------------------------
# uint32-limb arithmetic (Java long semantics without int64)
# ---------------------------------------------------------------------------


def _u32(x):
    return x.astype(jnp.uint32)


def _i32(x):
    return x.astype(jnp.int32)


def _mul32x32(a, b):
    """Full 64-bit product of two uint32 arrays as (hi, lo) uint32 pairs."""
    a = _u32(a)
    b = _u32(b)
    mask = jnp.uint32(0xFFFF)
    a0 = a & mask
    a1 = a >> 16
    b0 = b & mask
    b1 = b >> 16
    ll = a0 * b0  # < 2^32
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    # mid sum with carry: lh + hl can overflow uint32
    mid = lh + hl
    mid_carry = (mid < lh).astype(jnp.uint32)  # 1 if wrapped
    lo = ll + (mid << 16)
    lo_carry = (lo < ll).astype(jnp.uint32)
    hi = hh + (mid >> 16) + (mid_carry << 16) + lo_carry
    return hi, lo


def _add64(hi1, lo1, hi2, lo2):
    lo = lo1 + lo2
    carry = (lo < lo1).astype(jnp.uint32)
    return hi1 + hi2 + carry, lo


def _sign_ext_hi(x_i32):
    """High uint32 word of sign-extending int32 -> int64."""
    return _u32(jnp.where(x_i32 < 0, jnp.int32(-1), jnp.int32(0)))


def _mul_signed_small(x_i32, y_u32):
    """(hi, lo) of sign-extended int32 x times nonnegative 32-bit y, mod 2^64."""
    x_lo = _u32(x_i32)
    x_hi = _sign_ext_hi(x_i32)
    hi, lo = _mul32x32(x_lo, y_u32)
    # add (x_hi * y) << 32: only the low 32 bits of x_hi*y land in hi
    hi = hi + x_hi * _u32(y_u32)
    return hi, lo


def _merge_hashes_device(l_len, l_hash, r_len, r_hash):
    """HashBlock.mergeHashes (HashBlock.java:261-269) in uint32 limbs.

    rotated_left  = (long)(l_hash) + 1) * (54323 + 323 * r_len)
    rotated_right = (long)(int)(r_hash + 1) * (long) l_len
    result        = (int)(sum + (sum >> 32))   [arithmetic shift]
    """
    # (l_hash + 1) as int64: compute in int32 then fix the one overflow case
    # (l_hash == INT32_MAX wraps to INT32_MIN in int32 but must be 2^31):
    # as (hi, lo) limbs, lo is the wrapped value either way and hi is the sign
    # extension of the TRUE value: 0 for l_hash + 1 >= 0, i.e. l_hash >= -1.
    a_lo = _u32(l_hash) + jnp.uint32(1)
    a_hi = _u32(jnp.where(l_hash < -1, jnp.int32(-1), jnp.int32(0)))
    c = _u32(jnp.int32(MERGE_MULTIPLIER) + jnp.int32(MERGE_LENGTH_MULTIPLIER) * _i32(r_len))
    hi1, lo1 = _mul32x32(a_lo, c)
    hi1 = hi1 + a_hi * c
    # (int)(r_hash + 1): int32 wrap, then sign-extend
    b = _i32(_u32(r_hash) + jnp.uint32(1))
    hi2, lo2 = _mul_signed_small(b, _u32(_i32(l_len)))
    hi, lo = _add64(hi1, lo1, hi2, lo2)
    # (int)(sum + (sum >> 32)): arithmetic shift keeps hi as signed int32
    return _i32(_u32(_i32(lo)) + _u32(hi))


# ---------------------------------------------------------------------------
# masked dense pyramid rows
# ---------------------------------------------------------------------------

# nibble -> 2-bit code (A=0 C=1 G=2 T=3); ambiguity must be pre-filtered
_TWO_BIT = np.full(16, -1, dtype=np.int32)
_TWO_BIT[1] = 0  # A
_TWO_BIT[2] = 1  # C
_TWO_BIT[4] = 2  # G
_TWO_BIT[8] = 3  # T
# nibble -> gapmer char value (A..T -> 1..4) and complemented value
_GAP_VAL = np.zeros(16, dtype=np.int32)
_GAP_VAL[[1, 2, 4, 8]] = [1, 2, 3, 4]
_GAP_VAL_COMP = np.zeros(16, dtype=np.int32)
_GAP_VAL_COMP[[1, 2, 4, 8]] = [4, 3, 2, 1]


def _base_row_device(codes_u8, valid):
    """Level-0 row over [B, L] nibble codes: one 1-bp block per position."""
    v = jnp.asarray(_TWO_BIT)[codes_u8.astype(jnp.int32)]
    row = {
        "start": jax.lax.broadcasted_iota(jnp.int32, codes_u8.shape, 1),
        "length": jnp.ones(codes_u8.shape, jnp.int32),
        "fwd": v,
        "rev": jnp.int32(3) - v,
        "req_l": v < 2,
        "req_r": v >= 2,
        "next_l": (v & 1) == 0,
        "next_r": (v & 1) == 1,
        "gap_dir": jnp.zeros(codes_u8.shape, jnp.int32),
        "extra": jnp.zeros(codes_u8.shape, jnp.int32),
        "valid": valid,
    }
    return row


def _shl(a, k, fill):
    """Shift lanes left by k (slot i takes slot i+k's value)."""
    b = a.shape[0]
    return jnp.concatenate(
        [a[:, k:], jnp.full((b, k), fill, a.dtype)], axis=1
    )


def _propagate_next_valid(fields: list, valid):
    """For each slot i, each field's value at the smallest valid slot j > i.

    Log-step (Hillis-Steele) propagation with shifts and selects only — no
    gathers along the lane dimension, though every pyramid level needs 7
    neighbor fields."""
    l = valid.shape[1]
    vals = []
    for f in fields:
        fill = False if f.dtype == jnp.bool_ else 0
        vals.append(_shl(f, 1, fill))
    has = _shl(valid, 1, False)
    k = 1
    while k < l:
        need = ~has
        vals = [
            jnp.where(need, _shl(v, k, False if v.dtype == jnp.bool_ else 0), v)
            for v in vals
        ]
        has = has | _shl(has, k, False)
        k *= 2
    return vals, has


def _merge_row_device(row):
    """One pyramid level: each valid block merges with its next valid neighbor
    when the pair requests it (HashBlock_ParentRow.shouldMergeBlocks +
    HashBlock's merging constructor; same flag algebra as
    index/hashblock.py::merge_row).  The merged block keeps the left parent's
    slot; everything else invalidates."""
    valid = row["valid"]
    (
        (r_len, r_fwd, r_rev, r_start, r_req_l, r_next_l, r_next_r),
        has_r,
    ) = _propagate_next_valid(
        [
            row["length"], row["fwd"], row["rev"], row["start"],
            row["req_l"], row["next_l"], row["next_r"],
        ],
        valid,
    )
    l_len = row["length"]
    l_fwd = row["fwd"]
    l_rev = row["rev"]

    end_l = row["start"] + l_len
    should = (end_l >= r_start) & (row["req_r"] | r_req_l)
    new_valid = valid & has_r & should

    length = r_start + r_len - row["start"]
    fwd = _merge_hashes_device(l_len, l_fwd, r_len, r_fwd)
    rev = _merge_hashes_device(r_len, r_rev, l_len, l_rev)

    anchor_exists = l_fwd != r_rev
    anchor_is_right = l_fwd > r_rev
    asym = anchor_exists & (fwd != rev)
    is_reverse = fwd < rev
    invert = is_reverse == anchor_is_right

    a_nl = jnp.where(anchor_is_right, r_next_l, row["next_l"])
    a_nr = jnp.where(anchor_is_right, r_next_r, row["next_r"])
    both = a_nl & a_nr
    a_nr = jnp.where(both & anchor_is_right, False, a_nr)
    a_nl = jnp.where(both & ~anchor_is_right, False, a_nl)

    o_nl = jnp.where(anchor_is_right, row["next_l"], r_next_l)
    o_nr = jnp.where(anchor_is_right, row["next_r"], r_next_r)
    both_o = o_nl & o_nr
    o_nl = jnp.where(both_o & ~anchor_is_right, False, o_nl)
    o_nr = jnp.where(both_o & anchor_is_right, False, o_nr)

    t = jnp.ones_like(asym)
    req_l = jnp.where(asym, a_nl != invert, t)
    req_r = jnp.where(asym, a_nr != invert, t)
    next_l = jnp.where(asym, o_nl != invert, t)
    next_r = jnp.where(asym, o_nr != invert, t)

    diff_len = l_len != r_len
    lg = l_len > r_len
    req_l = jnp.where(diff_len, lg, req_l)
    req_r = jnp.where(diff_len, ~lg, req_r)
    next_l = jnp.where(diff_len, ~lg, next_l)
    next_r = jnp.where(diff_len, lg, next_r)

    asym_hash = fwd != rev
    both_req = req_l & req_r
    fg = fwd > rev
    req_l = jnp.where(asym_hash & both_req, fg, req_l)
    req_r = jnp.where(asym_hash & both_req, ~fg, req_r)
    both_next = next_l & next_r
    next_l = jnp.where(asym_hash & both_next, req_l, next_l)
    next_r = jnp.where(asym_hash & both_next, ~req_l, next_r)

    gap_dir = jnp.zeros_like(fwd)
    req_differ = req_l != req_r
    gap_dir = jnp.where(req_differ, jnp.where(req_l, 1, -1), gap_dir)
    gap_dir = jnp.where(
        ~req_differ & anchor_exists, jnp.where(anchor_is_right, 1, -1), gap_dir
    )

    # extraGapmerLength: Java int division truncates toward zero
    extra_raw = l_len + r_len - length
    extra = jnp.where(extra_raw >= 0, extra_raw // 4, -((-extra_raw) // 4))

    return {
        "start": row["start"],
        "length": length,
        "fwd": fwd,
        "rev": rev,
        "req_l": req_l,
        "req_r": req_r,
        "next_l": next_l,
        "next_r": next_r,
        "gap_dir": gap_dir,
        "extra": extra,
        "valid": new_valid,
    }


# ---------------------------------------------------------------------------
# gapmer expansion (HashBlock.withGapAndExtension, HashBlock.java:67-150)
# ---------------------------------------------------------------------------


def _gapmer_prefixes_device(codes_u8, lengths):
    """Per-read modular prefix tables [B, L+1] (uint32 as int32 bit patterns)
    and the shared power tables [L+1]."""
    b, l = codes_u8.shape
    idx = codes_u8.astype(jnp.int32)
    fwd_vals = _u32(jnp.asarray(_GAP_VAL)[idx])
    comp_vals = _u32(jnp.asarray(_GAP_VAL_COMP)[idx])
    # power tables are position-indexed and shared across the batch
    pow_host = np.empty(l + 2, dtype=np.uint32)
    inv_host = np.empty(l + 2, dtype=np.uint32)
    pb, ib = np.uint32(1), np.uint32(1)
    gm = np.uint32(GAPMER_MULTIPLIER)
    igm = np.uint32(_GAPMER_MULTIPLIER_INVERSE)
    with np.errstate(over="ignore"):
        for i in range(l + 2):
            pow_host[i] = pb
            inv_host[i] = ib
            pb = np.uint32(pb * gm)
            ib = np.uint32(ib * igm)
    pow_b = jnp.asarray(pow_host)
    inv_pow_b = jnp.asarray(inv_host)
    # prefix sums mod 2^32 (uint32 adds wrap)
    r_terms = fwd_vals * pow_b[:l][None, :]
    s_terms = comp_vals * inv_pow_b[:l][None, :]
    zero_col = jnp.zeros((b, 1), jnp.uint32)
    pref_fwd = jnp.concatenate([zero_col, jnp.cumsum(r_terms, axis=1, dtype=jnp.uint32)], axis=1)
    pref_comp = jnp.concatenate([zero_col, jnp.cumsum(s_terms, axis=1, dtype=jnp.uint32)], axis=1)
    return pref_fwd, pref_comp, pow_b, inv_pow_b


def _expand_gapmers_device(row, pref_fwd, pref_comp, pow_b, inv_pow_b, lengths):
    """Per-block gapmer for one row: (key, num_bp, start, length, primary,
    valid).  Blocks whose extension would leave the read are invalidated
    (the reference returns null for them)."""
    length = row["length"]
    # targetExtraLength = length + |max(fwd, rev)| % 3 + extra, Java semantics
    m = jnp.maximum(row["fwd"], row["rev"])
    abs_m = jnp.where(m < 0, _i32(jnp.uint32(0) - _u32(m)), m)  # abs(MIN) stays MIN
    rem = jax.lax.rem(abs_m, jnp.int32(3))  # truncated, sign follows abs_m
    target_extra = length + rem + row["extra"]
    gap = length // 2
    ext_len = target_extra - gap

    left_gap = row["gap_dir"] < 0
    right_gap = row["gap_dir"] > 0
    no_gap = row["gap_dir"] == 0

    ext_end_l = row["start"] - gap
    ext_start_l = ext_end_l - ext_len
    ext_start_r = row["start"] + length + gap
    ext_end_r = ext_start_r + ext_len
    ext_start = jnp.where(left_gap, ext_start_l, jnp.where(right_gap, ext_start_r, 0))
    ext_end = jnp.where(left_gap, ext_end_l, jnp.where(right_gap, ext_end_r, 0))

    n = lengths[:, None]  # per-read length bound
    in_bounds = no_gap | (left_gap & (ext_start >= 0)) | (right_gap & (ext_end <= n))
    valid = row["valid"] & in_bounds

    lmax = pref_fwd.shape[1] - 1
    cs = jnp.clip(ext_start, 0, lmax)
    ce = jnp.clip(ext_end, 0, lmax)
    d_fwd = jnp.take_along_axis(pref_fwd, ce, axis=1) - jnp.take_along_axis(
        pref_fwd, cs, axis=1
    )
    left_hash = d_fwd * inv_pow_b[cs]
    d_comp = jnp.take_along_axis(pref_comp, ce, axis=1) - jnp.take_along_axis(
        pref_comp, cs, axis=1
    )
    e1 = jnp.maximum(ce, 1) - 1
    right_hash = d_comp * pow_b[e1]
    ext_hash = _i32(jnp.where(left_gap, left_hash, right_hash))

    fwd = jnp.where(no_gap, row["fwd"], _i32(_u32(row["fwd"]) + _u32(ext_hash)))
    rev = jnp.where(no_gap, row["rev"], _i32(_u32(row["rev"]) + _u32(ext_hash)))

    total_len = jnp.where(no_gap, length, length + gap + ext_len)
    num_bp = jnp.where(no_gap, length, length + ext_len)
    start = jnp.where(left_gap, ext_start, row["start"])

    flags_differ = row["req_l"] != row["req_r"]
    primary = jnp.where(no_gap & flags_differ, row["req_l"], fwd >= rev)
    key = jnp.where(primary, fwd, rev)
    return {
        "key": key,
        "num_bp": num_bp,
        "start": start,
        "length": total_len,
        "primary": primary,
        "valid": valid,
    }


# ---------------------------------------------------------------------------
# lookup + voting + top-K (no sorts: rank-compaction scatters, O(P^2) mode
# counting, K argmax rounds)
# ---------------------------------------------------------------------------


def _rank_compact(fields, valid, width, fill=0):
    """Compact each row's valid entries (in order) into `width` slots via a
    cumulative-sum rank and a unique-index scatter.  Returns (compacted fields,
    per-row valid-entry counts)."""
    b = valid.shape[0]
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
    counts = jnp.where(valid.shape[1] > 0, rank[:, -1] + 1, 0)
    # invalid entries and overflow ranks scatter out of bounds (mode: drop)
    rank = jnp.where(valid, rank, jnp.int32(width))
    b_idx = jax.lax.broadcasted_iota(jnp.int32, valid.shape, 0)
    out = []
    for f in fields:
        tgt = jnp.full((b, width), fill, f.dtype)
        out.append(
            tgt.at[b_idx, rank].set(f, mode="drop", unique_indices=True)
        )
    return out, counts


def _device_candidates_core(
    codes_u8,  # [B, L] nibble codes, 0-padded
    lengths,  # [B] int32
    # merged index, device-resident int32
    capacities, caps, bases, counts, offsets, values,
    # strand tables over db sequences, int32
    rev_flags, fwd_index, seq_lengths, rc_index, seq_starts,
    # traced scalars (don't shape the program)
    max_size, n_seqs, span, bias,
    *, min_size: int, max_matches: int, num_levels: int, v_slots: int,
    p_slots: int, k_out: int, stage: int = 99,
):
    # `stage` truncates the program after a pipeline phase and returns a
    # data-dependent checksum — used only by benchmarks/bench_fused_stages.py
    # to itemize where the fused program's device time goes.  99 = the full
    # program.
    def _probe(x):
        return jnp.sum(x.astype(jnp.int32)).reshape(1, 1)

    b, l = codes_u8.shape
    valid0 = jax.lax.broadcasted_iota(jnp.int32, (b, l), 1) < lengths[:, None]
    row0 = _base_row_device(codes_u8, valid0)
    pref_fwd, pref_comp, pow_b, inv_pow_b = _gapmer_prefixes_device(codes_u8, lengths)

    # all levels share one compiled body (lax.scan): merge, expand gapmers,
    # emit the level's seeds — ~10x faster to compile than unrolled levels
    def _level(row, _):
        row = _merge_row_device(row)
        g = _expand_gapmers_device(row, pref_fwd, pref_comp, pow_b, inv_pow_b, lengths)
        ok = g["valid"] & (g["num_bp"] >= min_size) & (g["num_bp"] <= max_size)
        out = (g["key"], g["num_bp"], g["start"], g["length"], g["primary"], ok)
        return row, out

    row, per_level = jax.lax.scan(_level, row0, None, length=num_levels)

    # reads the fixed level count didn't finish: the numpy path would keep
    # merging (host fallback flag)
    unconverged = jnp.any(
        row["valid"] & (row["length"] <= max_size), axis=1
    ) & (jnp.sum(row["valid"].astype(jnp.int32), axis=1) >= 2)

    def _flat(a):  # [NLEV, B, L] -> [B, NLEV * L], level-major per read
        return jnp.transpose(a, (1, 0, 2)).reshape(b, num_levels * l)

    if stage == 1:
        return _probe(jnp.where(_flat(per_level[5]), _flat(per_level[0]), 0))
    keys = _flat(per_level[0])
    num_bp = _flat(per_level[1])
    starts = _flat(per_level[2])
    lens = _flat(per_level[3])
    primary = _flat(per_level[4])
    svalid = _flat(per_level[5])

    # ---- compact valid seeds to V slots, THEN look up bin counts ----
    # (the counts gather is random access into device memory, so it runs
    # on the ~300 compacted seeds per read, not the ~2700 slots)
    (c_key, c_nb, c_start, c_len, c_primary), seed_counts = _rank_compact(
        [keys, num_bp, starts, lens, primary], svalid, v_slots
    )
    seed_overflow = seed_counts > v_slots
    c_valid = jax.lax.broadcasted_iota(jnp.int32, (b, v_slots), 1) < jnp.minimum(
        seed_counts, v_slots
    )[:, None]
    nb = jnp.clip(c_nb, 0, capacities.shape[0] - 1)
    cap = capacities[nb]
    c_bin = bases[nb] + jnp.mod(c_key, cap)  # floor-mod (numpy semantics)
    c_bin = jnp.where(c_valid, c_bin, 0)
    cnt = counts[c_bin]
    limit = jnp.minimum(caps[nb], jnp.int32(max_matches))
    usable = c_valid & (cnt > 0) & (cnt <= limit)
    c_cnt = jnp.where(usable, cnt, 0)

    if stage == 2:
        return _probe(jnp.where(usable, cnt, 0))
    # ---- expand matches: [B, V, M] encoded global positions ----
    m = max_matches
    j = jax.lax.broadcasted_iota(jnp.int32, (b, v_slots, m), 2)
    pos_idx = offsets[c_bin][:, :, None] + j
    pos_valid = c_valid[:, :, None] & (j < c_cnt[:, :, None])
    pos_idx = jnp.where(pos_valid, pos_idx, 0)
    pos = values[pos_idx]

    if stage == 3:
        return _probe(jnp.where(pos_valid, pos, 0))
    # ---- fold to (strand, forward contig, offset) vote keys ----
    # decode global position: seq = #(seq_starts[1:] <= pos), offset = rest
    seq = jnp.sum(
        pos[:, :, :, None] >= seq_starts[None, None, None, 1:], axis=3
    ).astype(jnp.int32)
    pos_off = pos - seq_starts[seq]
    prim3 = c_primary[:, :, None]
    len3 = c_len[:, :, None]
    start3 = c_start[:, :, None]
    rc_seq = rc_index[seq]
    folded_seq = jnp.where(prim3, seq, rc_seq)
    folded_off = jnp.where(
        prim3, pos_off, seq_lengths[rc_seq] - pos_off - len3
    )
    mrev = rev_flags[folded_seq] != 0
    fwd_idx = fwd_index[folded_seq]
    contig_len = seq_lengths[fwd_idx]
    read_len3 = lengths[:, None, None]
    offv = jnp.where(
        mrev,
        (contig_len - (folded_off + len3)) - (read_len3 - (start3 + len3)),
        folded_off - start3,
    )
    vote_key = (mrev.astype(jnp.int32) * n_seqs + fwd_idx) * span + (offv + bias)

    if stage == 4:
        return _probe(jnp.where(pos_valid, vote_key, 0))
    # ---- compact vote entries to P slots ----
    flat_key = vote_key.reshape(b, v_slots * m)
    flat_valid = pos_valid.reshape(b, v_slots * m)
    (p_key,), entry_counts = _rank_compact([flat_key], flat_valid, p_slots)
    entry_overflow = entry_counts > p_slots
    p_valid = jax.lax.broadcasted_iota(jnp.int32, (b, p_slots), 1) < jnp.minimum(
        entry_counts, p_slots
    )[:, None]

    if stage == 5:
        return _probe(jnp.where(p_valid, p_key, 0))
    # ---- O(P^2) vote counting (mode finding without a sort) ----
    # chunked over the query axis so the pairwise compare stays a fused
    # reduce of [B, CH, P] instead of materializing [B, P, P]
    ch = 64

    def _count_chunk(_, i):
        kc = jax.lax.dynamic_slice_in_dim(p_key, i, ch, axis=1)
        eq = (kc[:, :, None] == p_key[:, None, :]) & p_valid[:, None, :]
        return None, jnp.sum(eq, axis=2, dtype=jnp.int32)

    _, vote_chunks = jax.lax.scan(
        _count_chunk, None, jnp.arange(0, p_slots, ch)
    )  # [P/CH, B, CH]
    votes = jnp.transpose(vote_chunks, (1, 0, 2)).reshape(b, p_slots)
    votes = jnp.where(p_valid, votes, 0)

    if stage == 6:
        return _probe(votes)
    # ---- top-K rounds: votes desc, key asc (the numpy lexsort order) ----
    int_max = jnp.int32(2**31 - 1)
    remaining = p_valid
    out_keys = []
    out_votes = []
    for _ in range(k_out):
        cnt_masked = jnp.where(remaining, votes, 0)
        best_cnt = jnp.max(cnt_masked, axis=1)
        is_best = remaining & (votes == best_cnt[:, None]) & (best_cnt[:, None] > 0)
        key_masked = jnp.where(is_best, p_key, int_max)
        best_key = jnp.min(key_masked, axis=1)
        out_keys.append(best_key)
        out_votes.append(best_cnt)
        remaining = remaining & (p_key != best_key[:, None])
    keys_out = jnp.stack(out_keys, axis=1)
    votes_out = jnp.stack(out_votes, axis=1)
    fallback = unconverged | seed_overflow | entry_overflow
    # one stacked int32 output -> one device-to-host fetch
    return jnp.concatenate(
        [keys_out, votes_out, fallback.astype(jnp.int32)[:, None]], axis=1
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "min_size", "max_matches", "num_levels", "v_slots", "p_slots", "k_out"
    ),
)
def _device_candidates_jit(
    *args, min_size, max_matches, num_levels, v_slots, p_slots, k_out
):
    return _device_candidates_core(
        *args,
        min_size=min_size,
        max_matches=max_matches,
        num_levels=num_levels,
        v_slots=v_slots,
        p_slots=p_slots,
        k_out=k_out,
    )


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

NUM_LEVELS = 16
# a clean 150 bp read yields ~300 usable seeds (every block of every level in
# the interesting-size window), nearly all single-match
V_SLOTS = 512
P_SLOTS = 1024


def device_index_arrays(database):
    """The merged index + strand tables as device-resident int32 arrays,
    cached on the database object and invalidated on lazy index growth.
    Returns None when any component exceeds int32 (host paths handle those)."""
    merged = database.merged_index()
    cached = getattr(database, "_device_index_cache", None)
    if cached is not None and cached["through"] == merged["through"]:
        return cached
    values = merged["values"]
    if (
        values.shape[0] >= 2**31
        or merged["counts"].shape[0] >= 2**31
        or (values.shape[0] and int(values.max()) >= 2**31)
    ):
        database._device_index_cache = None
        return None
    from mapper_tpu.batch.candidates import _strand_tables

    rev_flags, fwd_index, seq_lengths = _strand_tables(database)
    seq_db = database.get_sequence_database()
    if seq_db.starts[-1] >= 2**31 or int(seq_lengths.max(initial=0)) >= 2**31:
        database._device_index_cache = None
        return None
    dev = {
        "through": merged["through"],
        "capacities": jax.device_put(merged["capacities"].astype(np.int32)),
        "caps": jax.device_put(
            np.minimum(merged["caps"], 2**31 - 1).astype(np.int32)
        ),
        "bases": jax.device_put(merged["bases"].astype(np.int32)),
        "counts": jax.device_put(merged["counts"].astype(np.int32)),
        "offsets": jax.device_put(merged["offsets"].astype(np.int32)),
        "values": jax.device_put(merged["values"].astype(np.int32)),
        "rev_flags": jax.device_put(rev_flags.astype(np.int32)),
        "fwd_index": jax.device_put(fwd_index.astype(np.int32)),
        "seq_lengths": jax.device_put(seq_lengths.astype(np.int32)),
        "rc_index": jax.device_put(database._rc_index.astype(np.int32)),
        "seq_starts": jax.device_put(seq_db.starts.astype(np.int32)),
    }
    database._device_index_cache = dev
    return dev


def generate_candidates_device(
    batch,
    database,
    max_candidates_per_read: int = 8,
    max_matches_per_seed: int = 12,
    length_bucket: int = 64,
    stacked: bool = False,
):
    """Device candidate generation for an ambiguity-free ReadBatch.

    Returns (CandidateTable, fallback_read_ids) — reads the fixed device
    budgets couldn't finish (pyramid unconverged after NUM_LEVELS, >V usable
    seeds, >P vote entries) are listed for the host path.  Returns None when
    the database/geometry doesn't fit the device program (int32 key space,
    oversized index), or, with stacked=True, the raw [B, 2K+1] device array
    (host copy already started) plus the decode closure — the fused engine
    path uses that to overlap the fetch with other host work."""
    dev = device_index_arrays(database)
    if dev is None:
        return None
    seq_db = database.get_sequence_database()
    n_seqs = seq_db.get_num_sequences()
    if n_seqs == 0 or batch.num_reads == 0:
        return None
    max_len = int(batch.lengths.max())
    longest_contig = int(max((len(s) for s in seq_db.get_all()), default=1))
    span = longest_contig + 2 * max_len + 2
    bias = max_len + 1
    if 2 * n_seqs * span + bias >= 2**31:
        return None
    min_size = database.get_min_interesting_size()
    max_size = database.get_hashed_length()

    b = batch.num_reads
    l = -(-max_len // length_bucket) * length_bucket
    codes = np.zeros((b, l), dtype=np.uint8)
    for r in range(b):
        codes[r, : batch.lengths[r]] = batch.codes[
            batch.starts[r] : batch.starts[r + 1]
        ]
    lengths = batch.lengths.astype(np.int32)

    out = _device_candidates_jit(
        codes,
        lengths,
        dev["capacities"], dev["caps"], dev["bases"], dev["counts"],
        dev["offsets"], dev["values"],
        dev["rev_flags"], dev["fwd_index"], dev["seq_lengths"],
        dev["rc_index"], dev["seq_starts"],
        np.int32(max_size), np.int32(n_seqs), np.int32(span), np.int32(bias),
        min_size=int(min_size),
        max_matches=int(max_matches_per_seed),
        num_levels=NUM_LEVELS,
        v_slots=V_SLOTS,
        p_slots=P_SLOTS,
        k_out=int(max_candidates_per_read),
    )

    def decode(out_host):
        return _decode_output(
            np.asarray(out_host), int(max_candidates_per_read), n_seqs, span, bias
        )

    if stacked:
        try:
            out.copy_to_host_async()
        except AttributeError:
            pass
        return out, decode
    return decode(out)


# ---------------------------------------------------------------------------
# fused candidates + banded scoring: one device program, one fetch per chunk
# ---------------------------------------------------------------------------


def _fused_core(
    codes_u8, lengths, shift,
    capacities, caps, bases, counts, offsets, values,
    rev_flags, fwd_index, seq_lengths, rc_index, seq_starts,
    concat_u8, params_vec,
    max_size, n_seqs, span, bias,
    *, min_size, max_matches, num_levels, v_slots, p_slots, k_out,
    c_slots, band, scorer, quant,
):
    """Candidates (stage A) + per-candidate banded scoring (stage B) fused.

    Returns one flat int32 vector: [B*(2K+1)] candidate table (keys, votes,
    fallback flag) ++ [2*C] bitcast float32 scores (banded, ungapped-at-lane)
    for the keep-compacted candidate rows in read-major, vote-rank-minor
    order — the exact order the host reproduces with numpy from the decoded
    table, so no row metadata needs to cross the link."""
    from mapper_tpu.align import banded_dp

    b, lq = codes_u8.shape
    table = _device_candidates_core(
        codes_u8, lengths,
        capacities, caps, bases, counts, offsets, values,
        rev_flags, fwd_index, seq_lengths, rc_index, seq_starts,
        max_size, n_seqs, span, bias,
        min_size=min_size, max_matches=max_matches, num_levels=num_levels,
        v_slots=v_slots, p_slots=p_slots, k_out=k_out,
    )  # [B, 2K+1]

    keys = table[:, :k_out]
    votes = table[:, k_out : 2 * k_out]
    top = votes[:, 0:1]
    keep = (votes > 0) & ((top < 6) | (votes * 3 >= top))

    # decode candidate fields
    offv = jnp.mod(keys, span) - bias
    rest = keys // span
    seq = jnp.mod(rest, n_seqs)
    mrev = rest // n_seqs

    # rank-compact keep rows (read-major, rank-minor) to C slots
    read_id2 = jax.lax.broadcasted_iota(jnp.int32, (b, k_out), 0)
    flat_keep = keep.reshape(-1)
    (c_read, c_mrev, c_seq, c_offv), _total = _rank_compact(
        [
            read_id2.reshape(1, -1)[0][None, :],
            mrev.reshape(1, -1)[0][None, :],
            seq.reshape(1, -1)[0][None, :],
            offv.reshape(1, -1)[0][None, :],
        ],
        flat_keep[None, :],
        c_slots,
    )
    c_read = c_read[0]
    c_mrev = c_mrev[0]
    c_seq = c_seq[0]
    c_offv = c_offv[0]
    rank_all = jnp.cumsum(flat_keep.astype(jnp.int32)) - 1
    row_scored = flat_keep & (rank_all < c_slots)
    # reads whose rows fell past the C budget: fallback
    dropped = flat_keep & ~row_scored
    row_valid_count = jnp.sum(row_scored.astype(jnp.int32))
    c_valid = jax.lax.broadcasted_iota(jnp.int32, (c_slots,), 0) < row_valid_count
    overflow_reads = jnp.any(dropped.reshape(b, k_out), axis=1)
    table = table.at[:, 2 * k_out].set(
        table[:, 2 * k_out] | overflow_reads.astype(jnp.int32)
    )

    # scoring geometry (all int32; the host replays this exactly in numpy)
    n_row = lengths[c_read]
    shift_row = shift[c_read]
    contig_len = seq_lengths[c_seq]
    win_start_local = jnp.maximum(0, c_offv - shift_row)
    win_end_local = jnp.minimum(contig_len, c_offv + n_row + shift_row)
    w_len = jnp.maximum(win_end_local - win_start_local, 1)
    lane = c_offv - win_start_local
    win_start_global = seq_starts[c_seq] + win_start_local
    n_row = jnp.where(c_valid, jnp.maximum(n_row, 1), 1)

    scores2 = banded_dp._gathered_core(
        codes_u8, concat_u8, c_read, c_mrev != 0, win_start_global,
        jnp.clip(lane, 0, band - 1), n_row[:, None], w_len[:, None], params_vec,
        band=band, scorer=scorer, quant=quant,
    )  # [2, C] float32

    flat_scores = jax.lax.bitcast_convert_type(
        scores2.reshape(-1), jnp.int32
    )
    return jnp.concatenate([table.reshape(-1), flat_scores])


@functools.partial(
    jax.jit,
    static_argnames=(
        "min_size", "max_matches", "num_levels", "v_slots", "p_slots",
        "k_out", "c_slots", "band", "scorer", "quant",
    ),
)
def _fused_jit(*args, **kw):
    return _fused_core(*args, **kw)


def fused_candidates_scores(
    batch,
    database,
    concat_dev,
    params,
    shift,
    band: int,
    tile: int = 1024,
    max_candidates_per_read: int = 8,
    max_matches_per_seed: int = 12,
    length_bucket: int = 64,
    c_per_read: float = 1.5,
    scorer: str | None = None,
):
    """One-call fused candidates + scoring for an ambiguity-free ReadBatch.

    Returns (out_dev, finish) where finish(np_out) -> (CandidateTable,
    fallback_read_ids, banded [rows], ungapped [rows]) with rows in the same
    keep-order as the table — or None when the database doesn't fit the
    device program.  The device-to-host copy is started before returning.
    `scorer` selects the banded scorer as in banded_dp.banded_scores_gathered."""
    from mapper_tpu.align import banded_dp

    dev = device_index_arrays(database)
    if dev is None:
        return None
    seq_db = database.get_sequence_database()
    n_seqs = seq_db.get_num_sequences()
    if n_seqs == 0 or batch.num_reads == 0:
        return None
    max_len = int(batch.lengths.max())
    longest_contig = int(max((len(s) for s in seq_db.get_all()), default=1))
    span = longest_contig + 2 * max_len + 2
    bias = max_len + 1
    if 2 * n_seqs * span + bias >= 2**31:
        return None
    if int(concat_dev.shape[0]) + max_len + band >= 2**31:
        return None
    min_size = database.get_min_interesting_size()
    max_size = database.get_hashed_length()
    k_out = int(max_candidates_per_read)

    b = batch.num_reads
    l = -(-max_len // length_bucket) * length_bucket
    codes = np.zeros((b, l), dtype=np.uint8)
    for r in range(b):
        codes[r, : batch.lengths[r]] = batch.codes[
            batch.starts[r] : batch.starts[r + 1]
        ]
    lengths = batch.lengths.astype(np.int32)
    c_slots = -(-int(b * c_per_read) // tile) * tile

    scorer, quant = banded_dp.choose_scorer(scorer, params, l, band)
    if scorer == "kernel":
        banded_dp._register_kernel()
    params_vec = np.array(
        [[float(v) for v in banded_dp._params_tuple(params)]], dtype=np.float32
    )
    out = _fused_jit(
        codes, lengths, shift.astype(np.int32),
        dev["capacities"], dev["caps"], dev["bases"], dev["counts"],
        dev["offsets"], dev["values"],
        dev["rev_flags"], dev["fwd_index"], dev["seq_lengths"],
        dev["rc_index"], dev["seq_starts"],
        concat_dev, params_vec,
        np.int32(max_size), np.int32(n_seqs), np.int32(span), np.int32(bias),
        min_size=int(min_size), max_matches=int(max_matches_per_seed),
        num_levels=NUM_LEVELS, v_slots=V_SLOTS, p_slots=P_SLOTS,
        k_out=k_out, c_slots=c_slots, band=band, scorer=scorer, quant=quant,
    )
    out.copy_to_host_async()

    def finish(out_host):
        out_host = np.asarray(out_host)
        table_flat = out_host[: b * (2 * k_out + 1)].reshape(b, 2 * k_out + 1)
        scores = out_host[b * (2 * k_out + 1) :].view(np.float32).reshape(2, c_slots)
        table, fallback_ids = _decode_output(table_flat, k_out, n_seqs, span, bias)
        rows = len(table)
        # rows past the C budget weren't scored (their reads carry the
        # fallback flag); inf keeps them out of every decision
        banded = np.full(rows, np.inf, dtype=np.float64)
        ungapped = np.full(rows, np.inf, dtype=np.float64)
        k = min(rows, c_slots)
        banded[:k] = scores[0, :k]
        ungapped[:k] = scores[1, :k]
        return table, fallback_ids, banded, ungapped

    return out, finish


def _decode_output(out, k_out, n_seqs, span, bias):
    """[B, 2K+1] int32 -> (CandidateTable, fallback_read_ids)."""
    from mapper_tpu.batch.candidates import CandidateTable

    b = out.shape[0]
    keys = out[:, :k_out].astype(np.int64)
    votes = out[:, k_out : 2 * k_out]
    fallback = out[:, 2 * k_out] != 0
    present = votes > 0
    # the vote-noise filter (filtered ranks still consume top-K slots, as in
    # the numpy/native paths)
    top = votes[:, 0:1]
    keep = present & ((top < 6) | (votes * 3 >= top))
    read_idx, rank_idx = np.nonzero(keep)
    key = keys[read_idx, rank_idx]
    offv = key % span - bias
    rest = key // span
    seq = (rest % n_seqs).astype(np.int32)
    mrev = (rest // n_seqs).astype(bool)
    table = CandidateTable(
        read_idx.astype(np.int32),
        mrev,
        seq,
        offv,
        votes[read_idx, rank_idx].astype(np.int32),
    )
    return table, np.nonzero(fallback)[0]

