"""Banded affine-gap DP scoring on the device: the extend scorer.

Scores a batch of (query, reference-window) pairs under the reference's penalty
model (AlignmentParameters.java): per-base mismatch/ambiguity penalties,
separate insertion/deletion open+extend costs, free leading/trailing reference
overhang within the window (the glocal semantics of PathAligner.java restricted
to the candidate band).  Scoring only — the few accepted candidates get their
block structure from the exact host DP (mapper_tpu.align.dp), which is the
output-parity reference.

Formulation:
- band coordinate k = y - x in [0, BAND); all DP state is [B, BAND];
- one sequential loop over query positions x (the only true dependency);
  deletion chains within a row are resolved with a log2(BAND)-step min-plus
  (Kogge-Stone) scan instead of a sequential walk;
- the per-base penalty is computed arithmetically from the 4-bit codes
  (popcount of the union nibble), so there are no table gathers:
      match    -> AmbiguityPenalty * (popcount(q|w) - 1) / 3
      mismatch -> MutationPenalty
- per-pair query/window lengths are handled by masking and by capturing the
  result at x == n_i, so one compiled program serves the whole batch.

Two scorers compute this for the gathered (device-resident reference) path,
chosen by the `scorer` argument:
- "xla": the plain jnp form (`_banded_scores_jnp` plus a diagonal-sum scan),
  which XLA compiles for any backend; `banded_scores_reference` is the same
  math on host-built windows and is the oracle for everything else;
- "kernel": the CUDA kernel in native/banded_dp.cu, called through jax.ffi.
  It keeps each row's band in registers across the whole x loop, which a
  compiled XLA while loop cannot.  It works in exact fixed-point units
  (`_quantize_params`); parameters that do not quantize get the XLA scorer.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

BIG = 1e9

# the kernel's "unreachable" value in fixed-point units (banded_dp.cu kInf)
KERNEL_INF = 1 << 30
KERNEL_BANDS = (32, 64, 128)
SCORERS = ("kernel", "xla")


def _base_penalty(q, w, mutation, ambiguity):
    """Vectorized penalty between 4-bit codes (int32 arrays)."""
    union = q | w
    can_match = (q & w) != 0
    popcount = (
        (union & 1) + ((union >> 1) & 1) + ((union >> 2) & 1) + ((union >> 3) & 1)
    )
    amb = ambiguity * (popcount - 1).astype(jnp.float32) / 3.0
    return jnp.where(can_match, amb, mutation)


def _roll_minus_one(arr):
    """Shift lanes left by one (lane j takes lane j+1's value; garbage wraps to
    the last lane and is masked by validity checks): the loop carries the
    query and window arrays and rolls them one lane per step, so every slice
    it takes is static."""
    return jnp.roll(arr, shift=-1, axis=1)


def _dp_step(x, state, n, m, params_tuple, band):
    """One query-position step of the plain scorer.

    state: (best, ins_x, result, q_cur, w_cur); best/ins_x [B, BAND],
    result [B], q_cur [B, LQ] with the current query char in lane 0,
    w_cur [B, LW] with window index x in lane 0; n/m [B, 1] int32.
    """
    best, ins_x, result, q_cur, w_cur = state
    mutation, ambiguity, ins_open, ins_ext, del_open, del_ext = params_tuple
    tile = best.shape[0]

    k_range = jax.lax.broadcasted_iota(jnp.int32, (tile, band), 1)

    # window chars consumed by a diagonal step to x+1 at band k: index x + k
    w_slice = w_cur[:, :band]
    q_char = q_cur[:, :1]
    pen = _base_penalty(q_char, w_slice, mutation, ambiguity)
    w_valid = (x + k_range) < m  # window char exists
    active = x < n  # this pair still has query chars
    diag_new = jnp.where(w_valid & active, best + pen, BIG)

    # query insertion: (x, y) -> (x+1, y): band shifts down by one
    ins_candidates = jnp.minimum(ins_x + ins_ext, best + ins_open)
    ins_shifted = jnp.concatenate(
        [ins_candidates[:, 1:], jnp.full((tile, 1), BIG, jnp.float32)], axis=1
    )
    ins_new = jnp.where(active, ins_shifted, BIG)

    best_after = jnp.minimum(diag_new, ins_new)

    # deletion chain within the new row: min-plus scan along the band
    shifted = jnp.concatenate(
        [jnp.full((tile, 1), BIG, jnp.float32), best_after[:, :-1]], axis=1
    )
    chain = shifted + del_open
    step = 1
    while step < band:
        moved = jnp.concatenate(
            [jnp.full((tile, step), BIG, jnp.float32), chain[:, :-step]], axis=1
        )
        chain = jnp.minimum(chain, moved + step * del_ext)
        step *= 2
    # deletions consume window chars: mask where the consumed char is invalid
    chain = jnp.where(w_valid & active, chain, BIG)

    best_new = jnp.minimum(best_after, chain)
    best_new = jnp.where(active, best_new, best)
    ins_x_new = jnp.where(active, ins_new, ins_x)

    # capture the score when this pair's query is fully consumed at x+1 == n
    finished = (x + 1) == n  # [B, 1]
    tail_valid = ((x + 1) + k_range) <= m  # window skip after the query is free
    finals = jnp.where(tail_valid, best_new, BIG)
    captured = jnp.min(finals, axis=1)  # [B]
    result = jnp.where(finished[:, 0], captured, result)

    return best_new, ins_x_new, result, _roll_minus_one(q_cur), _roll_minus_one(w_cur)


def _quantize_params(params, lq: int, band: int):
    """Fixed-point units for the kernel: the smallest integer scale <= 1024
    making every penalty unit an exact integer (defaults are 1/30-rational:
    mutation 1, ambiguity/3 = 1/30, ins open 2.1, ...).  Returns
    (scale, int unit tuple), or None when the parameters are not exactly
    representable or a reachable score could reach the kernel's int32
    ceiling — then the XLA scorer runs instead.

    Exactness: every score the kernel produces is an integer count of
    1/scale units, so comparisons between kernel outputs (banded vs
    ungapped-diagonal) are exact — better than f32 accumulation order."""
    # quantize the exact float64 parameter values (the f32-rounded tuple the
    # float scorer uses is off integer multiples by ~1e-6: f32(2.1)*30 != 63)
    units = (
        float(params.mutation_penalty),
        float(params.ambiguity_penalty) / 3.0,
        float(params.insertion_start_penalty) + float(params.insertion_extension_penalty),
        float(params.insertion_extension_penalty),
        float(params.deletion_start_penalty) + float(params.deletion_extension_penalty),
        float(params.deletion_extension_penalty),
    )
    for scale in range(1, 1025):
        scaled = [u * scale for u in units]
        if all(abs(s - round(s)) < 1e-6 for s in scaled):
            ints = tuple(int(round(s)) for s in scaled)
            if min(ints) < 0:
                return None
            # a reachable path costs at most (2 * lq + band) units of the
            # largest penalty; keep 2x headroom under the ceiling, which also
            # bounds every pre-clamp int32 add (ceiling + band * unit)
            if 2 * (2 * lq + band) * max(ints) >= KERNEL_INF:
                return None
            return scale, ints
    return None


def _params_tuple(params):
    # plain host floats (np.float32-rounded), so building the tuple issues no
    # eager device ops
    return tuple(
        float(np.float32(v))
        for v in (
            params.mutation_penalty,
            params.ambiguity_penalty,
            params.insertion_start_penalty + params.insertion_extension_penalty,
            params.insertion_extension_penalty,
            params.deletion_start_penalty + params.deletion_extension_penalty,
            params.deletion_extension_penalty,
        )
    )


@functools.partial(jax.jit, static_argnames=("band",))
def _banded_scores_jnp(q_codes, w_codes, n, m, params_tuple, band: int):
    tile = q_codes.shape[0]
    lq = q_codes.shape[1]
    k_range = jax.lax.broadcasted_iota(jnp.int32, (tile, band), 1)
    best0 = jnp.where(k_range <= m, 0.0, BIG).astype(jnp.float32)
    ins0 = jnp.full((tile, band), BIG, jnp.float32)
    res0 = jnp.full((tile,), BIG, jnp.float32)

    def body(x, state):
        return _dp_step(x, state, n, m, params_tuple, band)

    state0 = (best0, ins0, res0, q_codes, w_codes)
    _, _, result, _, _ = jax.lax.fori_loop(0, lq, body, state0)
    return result


def _pad_window(q_codes, w_codes, band: int):
    """The scorer slices w[x : x+band] for x < LQ; pad the window array so the
    slice never clamps (clamping would silently misalign the band)."""
    needed = q_codes.shape[1] + band
    if w_codes.shape[1] < needed:
        w_codes = jnp.pad(w_codes, ((0, 0), (0, needed - w_codes.shape[1])))
    return w_codes


def banded_scores_reference(q_codes, w_codes, n, m, params, band: int):
    """Pure-jnp banded DP scores: [B] float32 (BIG where no alignment fits the
    band).  Runs on any backend; the oracle for the kernel."""
    q_codes = jnp.asarray(q_codes, jnp.int32)
    w_codes = _pad_window(q_codes, jnp.asarray(w_codes, jnp.int32), band)
    return _banded_scores_jnp(
        q_codes,
        w_codes,
        jnp.asarray(n, jnp.int32).reshape(-1, 1),
        jnp.asarray(m, jnp.int32).reshape(-1, 1),
        _params_tuple(params),
        band,
    )


def default_scorer(platform: str | None = None) -> str:
    """The scorer a platform gets: the CUDA kernel on a GPU, plain XLA on the
    CPU.  Any other platform is an error, not a silent default."""
    if platform is None:
        platform = jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no banded scorer for platform {platform!r}")


def choose_scorer(scorer, params, lq: int, band: int):
    """Resolve the scorer for one call: (scorer, quant).  The kernel needs
    exact fixed-point units and one of its compiled bands; when either is
    missing the XLA scorer runs — a choice made from the parameters and shapes
    alone."""
    if scorer is None:
        scorer = default_scorer()
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}; expected one of {SCORERS}")
    if scorer == "kernel":
        quant = _quantize_params(params, lq, band) if band in KERNEL_BANDS else None
        if quant is not None:
            return "kernel", quant
    return "xla", None


_KERNEL_TARGET = "mapper_banded_scores"
_kernel_lock = threading.Lock()
_kernel_registered = False


def _register_kernel() -> None:
    """Build (first use) and register the CUDA scorer as an FFI target; the
    CLI's warmup thread and the engine may race here."""
    global _kernel_registered
    with _kernel_lock:
        if _kernel_registered:
            return
        from mapper_tpu.native import get_cuda_library

        lib = get_cuda_library()
        jax.ffi.register_ffi_target(
            _KERNEL_TARGET, jax.ffi.pycapsule(lib.MapperBandedScores), platform="CUDA"
        )
        _kernel_registered = True


def _kernel_scores(reads_u8, concat_u8, read_id, reversed_, win_start, lane, n, m,
                   *, band, quant):
    """The CUDA scorer as a JAX operation: [2, B] float32 (banded, ungapped at
    lane), the same stacked layout as the XLA form."""
    scale, ints = quant
    b = read_id.shape[0]
    call = jax.ffi.ffi_call(
        _KERNEL_TARGET, jax.ShapeDtypeStruct((2, b), jnp.float32)
    )
    return call(
        reads_u8.astype(jnp.uint8),
        concat_u8.astype(jnp.uint8),
        read_id.astype(jnp.int32),
        reversed_.astype(jnp.uint8),
        win_start.astype(jnp.int32),
        lane.astype(jnp.int32),
        n.reshape(-1).astype(jnp.int32),
        m.reshape(-1).astype(jnp.int32),
        band=np.int64(band),
        scale=np.int64(scale),
        mutation=np.int64(ints[0]),
        ambiguity=np.int64(ints[1]),
        ins_open=np.int64(ints[2]),
        ins_ext=np.int64(ints[3]),
        del_open=np.int64(ints[4]),
        del_ext=np.int64(ints[5]),
    )


def _gathered_core(
    reads_u8, concat_u8, read_id, reversed_, win_start, lane, n, m, params_vec,
    *, band, scorer, quant=None,
):
    """Fused candidate scoring against a device-resident reference.

    reads_u8 [R, LQ] uint8 (0-padded rows, forward orientation only);
    concat_u8 [N] uint8: the concatenated reference codes, uploaded once;
    read_id/reversed_/win_start/lane/n/m: per-candidate int32/bool arrays.

    Everything the host would otherwise precompute per candidate — RC'd query
    codes, gathered reference windows, the voted diagonal's ungapped penalty —
    is computed on the device, so one call moves only the read matrix plus
    O(B) index vectors and returns one stacked [2, B] float32 array.
    scorer="kernel" (with `quant` from _quantize_params) runs the CUDA
    kernel, which fuses all of it; scorer="xla" runs the same math on plain
    XLA ops (any backend)."""
    if scorer == "kernel":
        return _kernel_scores(
            reads_u8, concat_u8, read_id, reversed_, win_start, lane, n, m,
            band=band, quant=quant,
        )
    lq = reads_u8.shape[1]
    b = read_id.shape[0]
    q_fwd = reads_u8[read_id].astype(jnp.int32)  # [B, LQ]
    # reverse complement on device: complement = nibble bit-reversal
    # (basepairs.COMPLEMENT_TABLE), order reversed over the first n chars
    comp = (
        ((q_fwd & 1) << 3) | ((q_fwd & 2) << 1) | ((q_fwd & 4) >> 1) | ((q_fwd & 8) >> 3)
    )
    pos = jax.lax.broadcasted_iota(jnp.int32, (b, lq), 1)
    rc_idx = jnp.clip(n - 1 - pos, 0, lq - 1)
    rc = jnp.take_along_axis(comp, rc_idx, axis=1)
    rc = jnp.where(pos < n, rc, 0)
    q_codes = jnp.where(reversed_[:, None], rc, q_fwd)

    w_idx = win_start[:, None] + jnp.arange(lq + band, dtype=win_start.dtype)[None, :]
    w_idx = jnp.minimum(w_idx, concat_u8.shape[0] - 1)
    w_codes = concat_u8[w_idx].astype(jnp.int32)

    params_tuple = tuple(params_vec[0, i] for i in range(6))
    scores = _banded_scores_jnp(q_codes, w_codes, n, m, params_tuple, band)

    def pen_step(acc, x):
        q_char = jax.lax.dynamic_slice_in_dim(q_codes, x, 1, axis=1)
        w_slice = jax.lax.dynamic_slice_in_dim(w_codes, x, band, axis=1)
        pen_x = _base_penalty(q_char, w_slice, params_vec[0, 0], params_vec[0, 1])
        return acc + jnp.where(x < n, pen_x, 0.0), None

    diag_sums, _ = jax.lax.scan(
        pen_step, jnp.zeros((b, band), jnp.float32), jnp.arange(lq)
    )  # diag_sums [B, BAND]: ungapped penalty per window diagonal
    ungapped = diag_sums[jnp.arange(b), jnp.clip(lane, 0, band - 1)]
    # one stacked output -> one device-to-host fetch
    return jnp.stack([scores, ungapped])


_GATHERED_FNS: dict = {}


def _gathered_fn(mesh, band, scorer, quant=None):
    """The jitted (and, under a mesh, shard_mapped over the data axis)
    gathered-scoring callable, cached per configuration."""
    key = (mesh, band, scorer, quant)
    fn = _GATHERED_FNS.get(key)
    if fn is not None:
        return fn
    if scorer == "kernel":
        _register_kernel()
    core = functools.partial(_gathered_core, band=band, scorer=scorer, quant=quant)
    if mesh is None:
        fn = jax.jit(core)
    else:
        from jax.sharding import PartitionSpec as P

        row = P("data")
        rep = P()
        # the varying-manual-axes check is off: the scoring loops initialize
        # carries from constants, which the checker types as unvarying even
        # though the loop outputs vary over `data`
        fn = jax.jit(
            jax.shard_map(
                core,
                mesh=mesh,
                in_specs=(rep, rep, row, row, row, row, P("data", None), P("data", None), rep),
                out_specs=P(None, "data"),
                check_vma=False,
            )
        )
    _GATHERED_FNS[key] = fn
    return fn


def banded_scores_gathered(
    reads_u8,
    concat_dev,
    read_id,
    reversed_,
    win_start,
    lane,
    n,
    m,
    params,
    band: int,
    tile: int = 1024,
    read_bucket: int = 256,
    mesh=None,
    scorer: str | None = None,
    stacked: bool = False,
):
    """Host wrapper for the gathered scorer: pads the candidate count to a
    tile (× mesh size) multiple and the read count to `read_bucket` (stable
    compile-size buckets), builds the params vector, returns
    numpy-convertible device futures (banded [B], ungapped-at-lane [B]).
    `concat_dev` must be a device-resident uint8 array (jax.device_put once
    per index; replicated over the mesh when one is given).  With a mesh the
    candidate rows shard over its `data` axis — scoring is embarrassingly
    parallel, so no collectives appear.  `scorer` is "kernel" or "xla"
    (default: from the platform, see default_scorer).

    With stacked=True, returns the single [2, padded_B] device array
    (row 0 banded, row 1 ungapped-at-lane, padded tail included) with its
    device-to-host copy already started, so a caller that fetches it after
    later host work (batch/engine.py's pipeline) pays one fetch."""
    reads_u8 = np.asarray(reads_u8, dtype=np.uint8)
    r, lq = reads_u8.shape
    scorer, quant = choose_scorer(scorer, params, lq, band)
    padded_r = -(-r // read_bucket) * read_bucket
    if padded_r != r:
        reads_host = np.zeros((padded_r, lq), dtype=np.uint8)
        reads_host[:r] = reads_u8
    else:
        reads_host = reads_u8
    b = int(np.asarray(read_id).shape[0])
    quantum = tile * (mesh.size if mesh is not None else 1)
    padded_b = -(-b // quantum) * quantum

    def pad1(a, dtype, fill):
        out = np.full(padded_b, fill, dtype=dtype)
        out[:b] = np.asarray(a)
        return out

    # int32 window indices: callers must fall back to the host-window path
    # for references beyond 2^31 bases (JAX x64 is off; int64 would truncate)
    if int(concat_dev.shape[0]) + lq + band > 2**31 - 1:
        raise ValueError("reference too large for int32 device gather")
    read_id_p = pad1(read_id, np.int32, 0)
    reversed_p = pad1(reversed_, bool, False)
    win_start_p = pad1(win_start, np.int32, 0)
    lane_p = pad1(lane, np.int32, 0)
    n_p = pad1(n, np.int32, 1).reshape(-1, 1)
    m_p = pad1(m, np.int32, 1).reshape(-1, 1)
    params_vec = np.array([[float(v) for v in _params_tuple(params)]], dtype=np.float32)
    fn = _gathered_fn(mesh, band, scorer, quant)
    out = fn(
        reads_host, concat_dev, read_id_p, reversed_p, win_start_p, lane_p,
        n_p, m_p, params_vec,
    )
    if stacked:
        out.copy_to_host_async()
        return out
    return out[0, :b], out[1, :b]
