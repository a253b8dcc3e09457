"""Native (C++) runtime components, bound via ctypes.

The device compute path is JAX/XLA plus one CUDA kernel (banded_dp.cu, built
with nvcc by get_cuda_library); the rest are the host-side hot loops around
it — the exact glocal DP (dp.cpp) used by the sequential engine's extend step
and the batch engine's traceback finalization, candidate generation and the
counting layer.  The host libraries are compiled on first use (g++ is part
of the toolchain) and cached OUTSIDE the source tree in a directory keyed by
the source content hash (no stale-binary risk, no build artifacts in git);
everything degrades gracefully to the numpy implementation when a compiler
is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(__file__)


def _cache_dir() -> str:
    base = os.environ.get("MAPPER_TPU_NATIVE_CACHE")
    if not base:
        xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(
            os.path.expanduser("~"), ".cache"
        )
        base = os.path.join(xdg, "mapper_tpu", "native")
    os.makedirs(base, exist_ok=True)
    return base


def _library_path(source: str, stem: str) -> str:
    """Cache path for a compiled source: keyed by the source content hash so a
    source edit can never load a stale binary."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_cache_dir(), f"{stem}-{digest}.so")


_SOURCE = os.path.join(_HERE, "dp.cpp")
_CAND_SOURCE = os.path.join(_HERE, "candidates.cpp")
_TEXT_SOURCE = os.path.join(_HERE, "textrows.cpp")
_COUNTING_SOURCE = os.path.join(_HERE, "counting.cpp")

_lock = threading.Lock()
_lib = None
_load_failed = False
_cand_lib = None
_cand_load_failed = False
_text_lib = None
_text_load_failed = False
_counting_lib = None
_counting_load_failed = False


def _build(source: str, library: str, extra=()) -> bool:
    try:
        subprocess.run(
            [
                "g++",
                "-O3",
                "-march=native",
                "-shared",
                "-fPIC",
                *extra,
                source,
                "-o",
                library + ".tmp",
            ],
            check=True,
            capture_output=True,
        )
        os.replace(library + ".tmp", library)
        return True
    except Exception:
        return False


_CUDA_SOURCE = os.path.join(_HERE, "banded_dp.cu")
_cuda_lib = None
# seconds the last nvcc build took (None when the cached library was loaded)
cuda_build_seconds = None


def _find_nvcc() -> str:
    import shutil

    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def get_cuda_library():
    """The Hopper scorer kernel (banded_dp.cu), compiled with nvcc for sm_90a
    on first use into the source-hash-keyed native cache and loaded.  Unlike
    the host libraries there is no fallback: a failed build raises, so a GPU
    run never silently scores elsewhere."""
    global _cuda_lib, cuda_build_seconds
    if _cuda_lib is not None:
        return _cuda_lib
    with _lock:
        if _cuda_lib is not None:
            return _cuda_lib
        import time

        import jax
        import jax.ffi

        include = jax.ffi.include_dir()
        # the FFI ABI follows jaxlib: key the binary on its version too
        stem = f"libmapperbanded-jax{jax.__version__}"
        library = _library_path(_CUDA_SOURCE, stem)
        if not os.path.exists(library):
            t0 = time.perf_counter()
            tmp = f"{library}.{os.getpid()}.tmp"
            cmd = [
                _find_nvcc(),
                "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", include, _CUDA_SOURCE, "-o", tmp,
            ]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"cannot run nvcc to build {_CUDA_SOURCE}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {_CUDA_SOURCE}:\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, library)
            cuda_build_seconds = time.perf_counter() - t0
        _cuda_lib = ctypes.CDLL(library)
    return _cuda_lib


def get_library():
    """The loaded native library, or None when unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        library = _library_path(_SOURCE, "libmapperdp")
        if not os.path.exists(library):
            # -ffp-contract=off: the batched local-align path's penalty sums
            # must match numpy bit-for-bit; FMA contraction of a+b*c would
            # change last-ulp results
            if not _build(_SOURCE, library, extra=("-ffp-contract=off", "-fopenmp")):
                if not _build(_SOURCE, library, extra=("-ffp-contract=off",)):
                    _load_failed = True
                    return None
        try:
            lib = ctypes.CDLL(library)
            lib.mapper_dp_align.restype = ctypes.c_int
            lib.mapper_dp_align.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
            ]
            p_u8 = ctypes.POINTER(ctypes.c_uint8)
            p_i8 = ctypes.POINTER(ctypes.c_int8)
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            p_i64 = ctypes.POINTER(ctypes.c_int64)
            p_f64 = ctypes.POINTER(ctypes.c_double)
            lib.mapper_local_align_one.restype = ctypes.c_int
            lib.mapper_local_align_one.argtypes = [
                ctypes.c_void_p, ctypes.c_int,    # q, qn
                ctypes.c_void_p, ctypes.c_int,    # w, wn
                ctypes.c_int64, ctypes.c_int,     # r_start_abs, pred_local
                ctypes.c_int, ctypes.c_int, ctypes.c_int,  # at_start, at_end, confident
                ctypes.c_double,                  # rate
                p_f64,                            # params8
                p_i32, ctypes.c_int,              # blocks_out, max_blocks
                p_f64, p_f64,                     # total, aligned
            ]
            lib.mapper_local_align_batch.restype = None
            lib.mapper_local_align_batch.argtypes = [
                p_u8, p_i64, p_i32,  # qbuf, q_off, q_len
                p_u8, p_i64, p_i32,  # wbuf, w_off, w_len
                p_i64, p_i32,        # r_start_abs, pred_local
                p_u8, p_u8, p_u8,    # at_ref_start, at_ref_end, confident
                p_f64, ctypes.c_int,  # rates, k
                p_f64,               # params8
                p_i8, p_i32, p_i32, ctypes.c_int32,  # status, nblocks, blocks, max_blocks_per
                p_f64, p_f64,        # total, aligned
            ]
            lib.mapper_pair_driver_batch.restype = None
            lib.mapper_pair_driver_batch.argtypes = [
                p_u8, p_i64, p_i64,   # concat, ref_starts, ref_lens
                p_u8, p_i64, p_i32,   # mate_codes, mate_off, mate_len
                p_f64, p_f64,         # expected_inner, spacing_dev
                p_i64, p_i64, p_i64,  # combo_bounds, combo_row0, combo_row1
                p_i64, p_i32, p_u8,   # row_off, row_ref, row_rev
                p_u8,                 # complement16
                ctypes.c_int64,       # npairs
                p_f64, ctypes.c_double, ctypes.c_double,  # params8, rate, span
                ctypes.c_int32, ctypes.c_int32,  # max_choices, max_blocks_out
                p_i8, p_i32,          # out_status, out_nchoices
                p_f64, p_f64, p_i64,  # out_spacing, out_total, out_inner
                p_u8, p_i32,          # out_comp_s, out_comp_ref
                p_f64, p_f64, p_i32,  # out_comp_total, out_comp_aligned, out_comp_nb
                p_i32,                # out_blocks
            ]
            _lib = lib
        except Exception:
            _load_failed = True
    return _lib


def get_candidates_library():
    """The loaded native candidates library, or None when unavailable."""
    global _cand_lib, _cand_load_failed
    if _cand_lib is not None or _cand_load_failed:
        return _cand_lib
    with _lock:
        if _cand_lib is not None or _cand_load_failed:
            return _cand_lib
        library = _library_path(_CAND_SOURCE, "libmappercand")
        if not os.path.exists(library):
            if not _build(_CAND_SOURCE, library, extra=("-fopenmp",)):
                # retry without OpenMP (still correct, single-threaded)
                if not _build(_CAND_SOURCE, library):
                    _cand_load_failed = True
                    return None
        try:
            lib = ctypes.CDLL(library)
            i64 = ctypes.c_int64
            i32 = ctypes.c_int32
            p_i64 = ctypes.POINTER(ctypes.c_int64)
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            p_u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.mapper_collect_blocks.restype = i64
            lib.mapper_collect_blocks.argtypes = [
                p_u8, i64, i32, i32, i32,
                p_i32, p_i32, p_i32, p_u8, p_u8, p_i64, p_i32, i64,
            ]
            lib.mapper_query_rows.restype = i32
            lib.mapper_query_rows.argtypes = [
                ctypes.c_void_p, i64, i32, p_i32, p_i32, i64,
            ]
            lib.mapper_query_walk.restype = i64
            lib.mapper_query_walk.argtypes = [
                ctypes.c_void_p, i64,      # codes, len
                i32, i32, i32,             # min_interesting, enable_gapmers, max_set_up
                ctypes.c_void_p,           # size_exists (uint8)
                p_i64, p_i64, p_i64,       # size_capacity, size_base, size_cap
                p_i64,                     # bin_counts (int64)
                p_i32, i64,                # out, max_out
                p_i64,                     # need_size
            ]
            lib.mapper_collect_emit.restype = i64
            lib.mapper_collect_emit.argtypes = [
                p_u8, i64, i32, i32, i32,  # codes, n, min_interesting, lo, hi
                i64, i64, i64, i64,        # seq_start, rc_start, window, pad
                p_i32, p_i32, p_i64, p_i64, i64,  # sizes, keys, pos, size_counts, max_out
            ]
            lib.mapper_collect_emit_range.restype = i64
            lib.mapper_collect_emit_range.argtypes = [
                p_u8, i64, i64, i64,       # codes, seg_len, pos_offset, full_n
                i64, i64,                  # keep_lo, keep_hi
                i32, i32, i32,             # min_interesting, lo, hi
                i64, i64, i64, i64,        # seq_start, rc_start, window, pad
                p_i32, p_i32, p_i64, p_i64, i64,
            ]
            lib.mapper_ungapped_counts.restype = None
            lib.mapper_ungapped_counts.argtypes = [
                p_u8, p_i64,               # read codes concat, read starts
                p_i32, p_u8, p_i64, i64,   # row read id, reversed, diag start, k
                p_u8,                      # ref concat
                p_i32, p_u8,               # out counts, out clean
            ]
            lib.mapper_scalar_entries.restype = i64
            lib.mapper_scalar_entries.argtypes = [
                p_u8, i64, i32, i32, i32, i32,  # codes, n, min_interesting, lo, hi, gapmers
                i64, i64,                  # keep_lo, keep_hi (window-local)
                p_i32, p_i32, p_i32, p_u8, p_u8, p_i64, p_i32, p_u8, i64,
            ]
            lib.mapper_prefetch_fold.restype = i64
            lib.mapper_prefetch_fold.argtypes = [
                p_i32, i64,                      # seq_arr, nb
                p_i64, p_i64, p_i64,             # capacities, caps, bases
                p_i64, p_i64, p_i64,             # counts, offsets, values
                p_i64, i64, p_i64,               # seq_starts, n_seqs, seq_lengths
                p_i64, p_u8,                     # rc_index, rc_flags
                p_u8, i64, p_u8,                 # q, qn, concat
                p_u8, p_i64, p_i64,              # popular, raw_counts, bounds
                p_i64, p_i64, p_u8,              # fold_idx, fold_off, is_rc
                i64,                             # cap
            ]
            lib.mapper_collision_batch.restype = None
            lib.mapper_collision_batch.argtypes = [
                p_u8, i64, p_u8,           # q, qn, concat
                p_i64, p_i64, p_i64,       # ref_global, ref_off, ref_len
                p_i64, p_i64, p_i64,       # bstart, blen, bnbp
                i64, p_u8,                 # k, out_ok
            ]
            lib.mapper_generate_candidates.restype = i64
            lib.mapper_generate_candidates.argtypes = [
                p_u8, p_i64, i64,          # codes, read_starts, num_reads
                i32, i32,                  # min_size, max_size
                p_i64, p_i64, p_i64,       # capacities, caps, bases
                p_i64, p_i64, p_i64,       # counts, offsets, values
                p_u8, p_i64, p_i64, p_i64, # rev_flags, fwd_index, seq_lengths, rc_index
                p_i64, i64,                # seq_starts, n_seqs
                i64, i64, i32, i32,        # span, bias, max_matches_per_seed, k_out
                p_i32, p_u8, p_i32, p_i64, p_i32,  # outputs
            ]
            _cand_lib = lib
        except Exception:
            _cand_load_failed = True
    return _cand_lib


def get_textrows_library():
    """The loaded native text-row formatter, or None when unavailable."""
    global _text_lib, _text_load_failed
    if _text_lib is not None or _text_load_failed:
        return _text_lib
    with _lock:
        if _text_lib is not None or _text_load_failed:
            return _text_lib
        library = _library_path(_TEXT_SOURCE, "libmappertext")
        if not os.path.exists(library):
            if not _build(_TEXT_SOURCE, library):
                _text_load_failed = True
                return None
        try:
            lib = ctypes.CDLL(library)
            lib.mapper_format_rows.restype = ctypes.c_int64
            lib.mapper_format_rows.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_char),
                ctypes.c_int64,
            ]
            _text_lib = lib
        except Exception:
            _text_load_failed = True
    return _text_lib


def get_counting_library():
    """The loaded native counting layer (counting.cpp: the
    Counting_HashBlockPath state machine), or None when unavailable."""
    global _counting_lib, _counting_load_failed
    if _counting_lib is not None or _counting_load_failed:
        return _counting_lib
    with _lock:
        if _counting_lib is not None or _counting_load_failed:
            return _counting_lib
        library = _library_path(_COUNTING_SOURCE, "libmappercounting")
        if not os.path.exists(library):
            if not _build(_COUNTING_SOURCE, library):
                _counting_load_failed = True
                return None
        try:
            lib = ctypes.CDLL(library)
            p_u8 = ctypes.POINTER(ctypes.c_uint8)
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            p_i64 = ctypes.POINTER(ctypes.c_int64)
            lib.mapper_counting_create.restype = ctypes.c_void_p
            lib.mapper_counting_create.argtypes = [
                p_i32, p_i32, p_u8, ctypes.c_int64,  # bstart, bend, popular, nb
                p_i64, p_i64, p_i64, p_u8,           # bounds, fold_idx, fold_off, is_rc
                p_i64, ctypes.c_int64,               # seq_lengths, query_len
                ctypes.c_int64, ctypes.c_int64,      # max_indel, usual
            ]
            lib.mapper_counting_destroy.restype = None
            lib.mapper_counting_destroy.argtypes = [ctypes.c_void_p]
            lib.mapper_counting_step.restype = ctypes.c_int32
            lib.mapper_counting_step.argtypes = [ctypes.c_void_p]
            lib.mapper_counting_run_until_nonoverlap.restype = None
            lib.mapper_counting_run_until_nonoverlap.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
            ]
            for name in (
                "mapper_counting_num_blocks",
                "mapper_counting_num_nonoverlap",
                "mapper_counting_num_good",
                "mapper_counting_num_counters",
            ):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p]
            lib.mapper_counting_is_done.restype = ctypes.c_int32
            lib.mapper_counting_is_done.argtypes = [ctypes.c_void_p]
            lib.mapper_counting_good_upto.restype = ctypes.c_int64
            lib.mapper_counting_good_upto.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, p_i32,
            ]
            lib.mapper_counting_best.restype = ctypes.c_int64
            lib.mapper_counting_best.argtypes = [ctypes.c_void_p, p_i32]
            lib.mapper_counting_all_positions.restype = ctypes.c_int64
            lib.mapper_counting_all_positions.argtypes = [ctypes.c_void_p, p_i32]
            lib.mapper_counting_info.restype = None
            lib.mapper_counting_info.argtypes = [
                ctypes.c_void_p, p_i32, ctypes.c_int64, p_i64,
            ]
            lib.mapper_counting_distinct.restype = ctypes.c_int64
            lib.mapper_counting_distinct.argtypes = [ctypes.c_void_p, ctypes.c_int32]
            lib.mapper_counting_priority.restype = ctypes.c_int64
            lib.mapper_counting_priority.argtypes = [ctypes.c_void_p, ctypes.c_int32]
            _counting_lib = lib
        except Exception:
            _counting_load_failed = True
    return _counting_lib


def native_format_rows(
    prefix: str, positions: np.ndarray, suffix_ids: np.ndarray, suffixes: list[str]
) -> str | None:
    """Assemble `prefix + str(position) + suffixes[id]` for every row into one
    string, or None when the native library is unavailable."""
    lib = get_textrows_library()
    if lib is None or positions.shape[0] == 0:
        return None
    # utf-8: the native assembly is byte-level, so non-ASCII contig names and
    # insertion texts pass through unchanged instead of raising.
    prefix_b = prefix.encode("utf-8")
    suffix_bytes = [s.encode("utf-8") for s in suffixes]
    lens = np.array([len(s) for s in suffix_bytes], dtype=np.int64)
    offsets = np.zeros(len(suffix_bytes) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    blob = b"".join(suffix_bytes)
    positions = np.ascontiguousarray(positions, dtype=np.int64)
    suffix_ids = np.ascontiguousarray(suffix_ids, dtype=np.int32)
    n = positions.shape[0]
    capacity = int(n * (len(prefix_b) + 20) + lens[suffix_ids].sum())
    out = np.empty(capacity, dtype=np.uint8)
    written = lib.mapper_format_rows(
        prefix_b,
        len(prefix_b),
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        suffix_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        capacity,
    )
    if written < 0:
        return None
    return out[:written].tobytes().decode("utf-8")


def native_generate_candidates(
    codes: np.ndarray,
    read_starts: np.ndarray,
    min_size: int,
    max_size: int,
    merged: dict,
    rev_flags: np.ndarray,
    fwd_index: np.ndarray,
    seq_lengths: np.ndarray,
    rc_index: np.ndarray,
    seq_starts: np.ndarray,
    n_seqs: int,
    span: int,
    bias: int,
    max_matches_per_seed: int,
    k_out: int,
):
    """Run the native candidate generator.  Returns (read, reversed, seq,
    offset, votes) arrays or None when the library is unavailable or the batch
    contains ambiguity (caller falls back to the numpy path)."""
    lib = get_candidates_library()
    if lib is None:
        return None
    num_reads = read_starts.shape[0] - 1
    if num_reads <= 0:
        return None

    def as64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    read_starts = as64(read_starts)
    rev_u8 = np.ascontiguousarray(rev_flags, dtype=np.uint8)
    cap_out = num_reads * k_out
    out_read = np.empty(cap_out, dtype=np.int32)
    out_rev = np.empty(cap_out, dtype=np.uint8)
    out_seq = np.empty(cap_out, dtype=np.int32)
    out_offset = np.empty(cap_out, dtype=np.int64)
    out_votes = np.empty(cap_out, dtype=np.int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    arrs = {
        "capacities": as64(merged["capacities"]),
        "caps": as64(merged["caps"]),
        "bases": as64(merged["bases"]),
        "counts": as64(merged["counts"]),
        "offsets": as64(merged["offsets"]),
        "values": as64(merged["values"]),
    }
    n = lib.mapper_generate_candidates(
        codes.ctypes.data_as(p_u8),
        read_starts.ctypes.data_as(p_i64),
        num_reads,
        min_size,
        max_size,
        arrs["capacities"].ctypes.data_as(p_i64),
        arrs["caps"].ctypes.data_as(p_i64),
        arrs["bases"].ctypes.data_as(p_i64),
        arrs["counts"].ctypes.data_as(p_i64),
        arrs["offsets"].ctypes.data_as(p_i64),
        arrs["values"].ctypes.data_as(p_i64),
        rev_u8.ctypes.data_as(p_u8),
        as64(fwd_index).ctypes.data_as(p_i64),
        as64(seq_lengths).ctypes.data_as(p_i64),
        as64(rc_index).ctypes.data_as(p_i64),
        as64(seq_starts).ctypes.data_as(p_i64),
        n_seqs,
        span,
        bias,
        max_matches_per_seed,
        k_out,
        out_read.ctypes.data_as(p_i32),
        out_rev.ctypes.data_as(p_u8),
        out_seq.ctypes.data_as(p_i32),
        out_offset.ctypes.data_as(p_i64),
        out_votes.ctypes.data_as(p_i32),
    )
    if n < 0:
        return None
    return (
        out_read[:n],
        out_rev[:n].astype(bool),
        out_seq[:n],
        out_offset[:n],
        out_votes[:n],
    )


def native_collect_blocks(
    codes: np.ndarray, min_interesting: int, lo: int, hi: int
):
    """All index-insertable gapmers of one non-ambiguous sequence: arrays
    (num_bp, fwd, rev, primary, secondary, start, length), or None when the
    library is unavailable / the sequence has ambiguity codes."""
    lib = get_candidates_library()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    cap = 6 * n + 64  # pyramid block count is ~4n (3/4 decay per row)
    out_num_bp = np.empty(cap, dtype=np.int32)
    out_fwd = np.empty(cap, dtype=np.int32)
    out_rev = np.empty(cap, dtype=np.int32)
    out_primary = np.empty(cap, dtype=np.uint8)
    out_secondary = np.empty(cap, dtype=np.uint8)
    out_start = np.empty(cap, dtype=np.int64)
    out_length = np.empty(cap, dtype=np.int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    k = lib.mapper_collect_blocks(
        codes.ctypes.data_as(p_u8),
        n,
        min_interesting,
        lo,
        hi,
        out_num_bp.ctypes.data_as(p_i32),
        out_fwd.ctypes.data_as(p_i32),
        out_rev.ctypes.data_as(p_i32),
        out_primary.ctypes.data_as(p_u8),
        out_secondary.ctypes.data_as(p_u8),
        out_start.ctypes.data_as(p_i64),
        out_length.ctypes.data_as(p_i32),
        cap,
    )
    if k < 0:
        return None
    return (
        out_num_bp[:k],
        out_fwd[:k],
        out_rev[:k],
        out_primary[:k].astype(bool),
        out_secondary[:k].astype(bool),
        out_start[:k],
        out_length[:k],
    )


def native_scalar_entries(
    codes: np.ndarray,
    min_interesting: int,
    lo: int,
    hi: int,
    enable_gapmers: bool,
    keep=None,
):
    """Entry columns of the scalar conditional (IUPAC) pyramid over one code
    window — native port of HashBlockDatabase._scalar_entries; same entries in
    the same order.  Returns (num_bp, fwd, rev, primary, secondary, start,
    length, amb) with window-local starts, or None when the library is
    unavailable."""
    lib = get_candidates_library()
    if lib is None or not hasattr(lib, "mapper_scalar_entries"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    keep_lo, keep_hi = keep if keep is not None else (-(1 << 62), 1 << 62)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    cap = 8 * n + 64
    while True:
        out_num_bp = np.empty(cap, dtype=np.int32)
        out_fwd = np.empty(cap, dtype=np.int32)
        out_rev = np.empty(cap, dtype=np.int32)
        out_primary = np.empty(cap, dtype=np.uint8)
        out_secondary = np.empty(cap, dtype=np.uint8)
        out_start = np.empty(cap, dtype=np.int64)
        out_length = np.empty(cap, dtype=np.int32)
        out_amb = np.empty(cap, dtype=np.uint8)
        k = lib.mapper_scalar_entries(
            codes.ctypes.data_as(p_u8),
            n,
            min_interesting,
            lo,
            hi,
            1 if enable_gapmers else 0,
            keep_lo,
            keep_hi,
            out_num_bp.ctypes.data_as(p_i32),
            out_fwd.ctypes.data_as(p_i32),
            out_rev.ctypes.data_as(p_i32),
            out_primary.ctypes.data_as(p_u8),
            out_secondary.ctypes.data_as(p_u8),
            out_start.ctypes.data_as(p_i64),
            out_length.ctypes.data_as(p_i32),
            out_amb.ctypes.data_as(p_u8),
            cap,
        )
        if k == -1:
            cap *= 4
            continue
        if k < 0:
            return None
        return (
            out_num_bp[:k],
            out_fwd[:k],
            out_rev[:k],
            out_primary[:k].astype(bool),
            out_secondary[:k].astype(bool),
            out_start[:k],
            out_length[:k],
            out_amb[:k].astype(bool),
        )


def native_collect_emit(
    codes: np.ndarray,
    min_interesting: int,
    lo: int,
    hi: int,
    seq_start: int,
    rc_start: int,
    window: int = 1 << 16,
    pad: int = 4096,
):
    """Parallel fused collect+emit for one non-ambiguous sequence: the
    dual-polarity (key, encoded position) index inserts, grouped by block
    size.  Returns (size_counts int64[hi+1], keys int32[k], positions
    int64[k]) with rows ordered size-major, or None when the library is
    unavailable / the sequence has ambiguity codes."""
    lib = get_candidates_library()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    cap = 2 * n + 4096  # measured ~1.2 rows/base; retries double on overflow
    while True:
        out_sizes = np.empty(cap, dtype=np.int32)
        out_keys = np.empty(cap, dtype=np.int32)
        out_pos = np.empty(cap, dtype=np.int64)
        out_counts = np.zeros(hi + 1, dtype=np.int64)
        k = lib.mapper_collect_emit(
            codes.ctypes.data_as(p_u8),
            n,
            min_interesting,
            lo,
            hi,
            seq_start,
            rc_start,
            window,
            pad,
            out_sizes.ctypes.data_as(p_i32),
            out_keys.ctypes.data_as(p_i32),
            out_pos.ctypes.data_as(p_i64),
            out_counts.ctypes.data_as(p_i64),
            cap,
        )
        if k == -1:
            cap *= 2
            continue
        if k < 0:
            return None
        return out_counts, out_keys[:k], out_pos[:k]


def native_collect_emit_range(
    codes: np.ndarray,
    pos_offset: int,
    full_n: int,
    keep_lo: int,
    keep_hi: int,
    min_interesting: int,
    lo: int,
    hi: int,
    seq_start: int,
    rc_start: int,
    window: int = 1 << 16,
    pad: int = 4096,
):
    """native_collect_emit over one clean SEGMENT of an ambiguous sequence:
    ``codes`` is the segment slice (standalone pyramid, matching the hybrid
    partition rule), placed at ``pos_offset`` in a full sequence of length
    ``full_n``; only blocks whose full-sequence start lies in [keep_lo,
    keep_hi) are emitted.  Returns (size_counts, keys, positions) or None."""
    lib = get_candidates_library()
    if lib is None or not hasattr(lib, "mapper_collect_emit_range"):
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    cap = 2 * n + 4096
    while True:
        out_sizes = np.empty(cap, dtype=np.int32)
        out_keys = np.empty(cap, dtype=np.int32)
        out_pos = np.empty(cap, dtype=np.int64)
        out_counts = np.zeros(hi + 1, dtype=np.int64)
        k = lib.mapper_collect_emit_range(
            codes.ctypes.data_as(p_u8),
            n,
            pos_offset,
            full_n,
            keep_lo,
            keep_hi,
            min_interesting,
            lo,
            hi,
            seq_start,
            rc_start,
            window,
            pad,
            out_sizes.ctypes.data_as(p_i32),
            out_keys.ctypes.data_as(p_i32),
            out_pos.ctypes.data_as(p_i64),
            out_counts.ctypes.data_as(p_i64),
            cap,
        )
        if k == -1:
            cap *= 2
            continue
        if k < 0:
            return None
        return out_counts, out_keys[:k], out_pos[:k]


def native_ungapped_counts(
    read_codes: np.ndarray,
    read_starts: np.ndarray,
    row_read_id: np.ndarray,
    row_reversed: np.ndarray,
    row_diag_start: np.ndarray,
    ref_concat: np.ndarray,
):
    """Exact ungapped mismatch counts per candidate row.  Returns (counts
    int32[k], clean bool[k]) where clean marks rows whose read and reference
    diagonal are pure ACGT (for those, penalty == counts * mutation_penalty
    exactly), or None when the library is unavailable."""
    lib = get_candidates_library()
    if lib is None:
        return None
    k = int(np.asarray(row_read_id).shape[0])
    read_codes = np.ascontiguousarray(read_codes, dtype=np.uint8)
    read_starts = np.ascontiguousarray(read_starts, dtype=np.int64)
    row_read_id = np.ascontiguousarray(row_read_id, dtype=np.int32)
    row_reversed = np.ascontiguousarray(row_reversed, dtype=np.uint8)
    row_diag_start = np.ascontiguousarray(row_diag_start, dtype=np.int64)
    ref_concat = np.ascontiguousarray(ref_concat, dtype=np.uint8)
    out_counts = np.empty(k, dtype=np.int32)
    out_clean = np.empty(k, dtype=np.uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.mapper_ungapped_counts(
        read_codes.ctypes.data_as(p_u8),
        read_starts.ctypes.data_as(p_i64),
        row_read_id.ctypes.data_as(p_i32),
        row_reversed.ctypes.data_as(p_u8),
        row_diag_start.ctypes.data_as(p_i64),
        k,
        ref_concat.ctypes.data_as(p_u8),
        out_counts.ctypes.data_as(p_i32),
        out_clean.ctypes.data_as(p_u8),
    )
    return out_counts, out_clean.astype(bool)


def _params_array(params) -> np.ndarray:
    """The 8-double Params block, cached on the params object (clones share
    all fields except max_error_rate, which is passed separately)."""
    arr = params.__dict__.get("_native_params")
    if arr is None:
        arr = np.array(
            [
                params.mutation_penalty,
                params.ambiguity_penalty,
                params.insertion_start_penalty,
                params.insertion_extension_penalty,
                params.deletion_start_penalty,
                params.deletion_extension_penalty,
                params.unaligned_penalty,
                params.get_starting_insertion_start_penalty(),
            ],
            dtype=np.float64,
        )
        params.__dict__["_native_params"] = arr
    return arr


_dp_scratch = threading.local()


def native_dp_align(
    q_codes: np.ndarray,
    w_codes: np.ndarray,
    params,
    may_extend: bool,
    max_ins_ext: float,
    max_interesting: float,
):
    """Run the native DP.  Returns (blocks ndarray [k,4] in traceback order
    goal->start, goal_penalty) or None when the library is unavailable.
    Returns ([], goal_penalty) when no goal state fits the budget."""
    lib = get_library()
    if lib is None:
        return None
    q = np.ascontiguousarray(q_codes, dtype=np.uint8)
    w = np.ascontiguousarray(w_codes, dtype=np.uint8)
    params_arr = _params_array(params)
    max_blocks = q.shape[0] + w.shape[0] + 4
    # NOTE: deliberately a different attribute than native_local_align_one's
    # `blocks` — that function caches a ctypes pointer alongside its buffer,
    # and sharing the attribute could leave the pointer dangling at a freed
    # buffer (and skipped its pens init) when this function resized it first
    buf = getattr(_dp_scratch, "dp_blocks", None)
    if buf is None or buf.shape[0] < max_blocks:
        buf = np.empty((max(max_blocks, 512), 4), dtype=np.int32)
        _dp_scratch.dp_blocks = buf
    goal_penalty = ctypes.c_double(0.0)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    count = lib.mapper_dp_align(
        q.ctypes.data_as(p_u8),
        q.shape[0],
        w.ctypes.data_as(p_u8),
        w.shape[0],
        params_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        1 if may_extend else 0,
        float(max_ins_ext),
        float(max_interesting),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_blocks,
        ctypes.byref(goal_penalty),
    )
    if count == -2:
        return None  # block overflow; numpy path decides
    if count < 0:
        return np.zeros((0, 4), dtype=np.int32), goal_penalty.value
    return buf[:count], goal_penalty.value


def native_query_rows(codes: np.ndarray):
    """All pyramid row levels of one clean query as flat int32 arrays.
    Returns (counts int32[levels], fields int32[total, 10]) — fields are the
    ScalarHashBlock field set (start, length, fwd, rev, extra, gap_dir,
    req_l, req_r, next_l, next_r) — or None (ambiguous query or library
    unavailable; caller uses the Python row kernels)."""
    lib = get_candidates_library()
    if lib is None or not hasattr(lib, "mapper_query_rows"):
        return None
    n = int(codes.shape[0])
    if n == 0:
        return None
    if not codes.flags.c_contiguous:
        codes = np.ascontiguousarray(codes)
    max_levels = n + 2
    counts = np.zeros(max_levels, dtype=np.int32)
    cap = 6 * n + 64
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    while True:
        fields = np.empty((cap, 10), dtype=np.int32)
        r = lib.mapper_query_rows(
            codes.ctypes.data,
            n,
            max_levels,
            counts.ctypes.data_as(p_i32),
            fields.ctypes.data_as(p_i32),
            cap,
        )
        if r == -1:
            return None
        if r == -2:
            worst = n * (n + 1) // 2 + 8
            if cap >= worst:
                return None
            cap = worst
            continue
        return counts[:r], fields


def native_query_walk(codes: np.ndarray, database):
    """The interesting-gapmer walk of one clean query
    (HashBlockPath.get_next_interesting_block precomputed; see
    candidates.cpp::mapper_query_walk).  Returns a [n, 9] int32 array
    (start, total_len, num_bp, fwd, rev, req_l, req_r, gapped_b1, gap_len)
    or None (ambiguity / library unavailable; caller walks in Python).
    Triggers the database's lazy growth exactly where the Python walk
    would (a probe of a size beyond max_fully_set_up_size) and re-runs."""
    lib = get_candidates_library()
    if lib is None or not hasattr(lib, "mapper_query_walk"):
        return None
    n = int(codes.shape[0])
    if n == 0:
        return None
    if not codes.flags.c_contiguous:
        codes = np.ascontiguousarray(codes)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    max_out = 4 * n + 64
    while True:
        merged = database.merged_index()
        exists = merged.get("exists")
        if exists is None:
            return None
        counts = merged["counts"]
        if counts.dtype != np.int64:
            counts = counts.astype(np.int64)
        out = np.empty((max_out, 9), dtype=np.int32)
        need = ctypes.c_int64(0)
        r = lib.mapper_query_walk(
            codes.ctypes.data,
            n,
            int(database.get_min_interesting_size()),
            1 if database.get_enable_gapmers() else 0,
            int(database.max_fully_set_up_size),
            exists.ctypes.data,
            merged["capacities"].ctypes.data_as(p_i64),
            merged["bases"].ctypes.data_as(p_i64),
            merged["caps"].ctypes.data_as(p_i64),
            counts.ctypes.data_as(p_i64),
            out.ctypes.data_as(p_i32),
            max_out,
            ctypes.byref(need),
        )
        if r == -1:
            return None
        if r == -2:
            max_out *= 4
            if max_out > 64 * n + 4096:
                return None
            continue
        if r == -3:
            database.require_set_up_through_size(int(need.value))
            continue
        return out[:r]


def native_prefetch_fold(seq_arr: np.ndarray, database, query_codes: np.ndarray):
    """Fused walk prefetch: index lookups + secondary-polarity fold +
    collision checks + reverse-strand fold for a whole native-walk sequence
    (candidates._prefetch_matches + _fold_and_filter are the oracle).
    Returns (popular bool[nb], raw_counts int64[nb], bounds int64[nb+1],
    fold_idx, fold_off, is_rc) or None when unavailable."""
    lib = get_candidates_library()
    if lib is None or not hasattr(lib, "mapper_prefetch_fold"):
        return None
    merged = database.merged_index()
    if merged.get("counts") is None:
        return None
    seq_db = database.get_sequence_database()
    rc_flags = getattr(database, "_rc_flags_arr", None)
    if rc_flags is None:
        rc_flags = np.fromiter(
            (s.complemented_from is not None for s in seq_db.sequences),
            dtype=bool,
            count=len(seq_db.sequences),
        )
        database._rc_flags_arr = rc_flags
    nb = int(seq_arr.shape[0])
    c = np.ascontiguousarray
    seq_arr = c(seq_arr, dtype=np.int32)
    query_codes = c(query_codes, dtype=np.uint8)
    concat = c(seq_db.concatenated_codes(), dtype=np.uint8)
    arrs = {
        "capacities": c(merged["capacities"], dtype=np.int64),
        "caps": c(merged["caps"], dtype=np.int64),
        "bases": c(merged["bases"], dtype=np.int64),
        "counts": c(merged["counts"], dtype=np.int64),
        "offsets": c(merged["offsets"], dtype=np.int64),
        "values": c(merged["values"], dtype=np.int64),
    }
    seq_starts = c(seq_db.starts, dtype=np.int64)
    seq_lengths = c(database._seq_lengths, dtype=np.int64)
    rc_index = c(database._rc_index, dtype=np.int64)
    rc_flags_u8 = c(rc_flags, dtype=np.uint8)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    cap = 16 * nb + 1024
    while True:
        popular = np.empty(nb, dtype=np.uint8)
        raw_counts = np.empty(nb, dtype=np.int64)
        bounds = np.empty(nb + 1, dtype=np.int64)
        fold_idx = np.empty(cap, dtype=np.int64)
        fold_off = np.empty(cap, dtype=np.int64)
        is_rc = np.empty(cap, dtype=np.uint8)
        n = lib.mapper_prefetch_fold(
            seq_arr.ctypes.data_as(p_i32),
            nb,
            arrs["capacities"].ctypes.data_as(p_i64),
            arrs["caps"].ctypes.data_as(p_i64),
            arrs["bases"].ctypes.data_as(p_i64),
            arrs["counts"].ctypes.data_as(p_i64),
            arrs["offsets"].ctypes.data_as(p_i64),
            arrs["values"].ctypes.data_as(p_i64),
            seq_starts.ctypes.data_as(p_i64),
            seq_db.get_num_sequences(),
            seq_lengths.ctypes.data_as(p_i64),
            rc_index.ctypes.data_as(p_i64),
            rc_flags_u8.ctypes.data_as(p_u8),
            query_codes.ctypes.data_as(p_u8),
            query_codes.shape[0],
            concat.ctypes.data_as(p_u8),
            popular.ctypes.data_as(p_u8),
            raw_counts.ctypes.data_as(p_i64),
            bounds.ctypes.data_as(p_i64),
            fold_idx.ctypes.data_as(p_i64),
            fold_off.ctypes.data_as(p_i64),
            is_rc.ctypes.data_as(p_u8),
            cap,
        )
        if n == -2:
            cap *= 4
            continue
        return (
            popular.astype(bool),
            raw_counts,
            bounds,
            fold_idx[:n],
            fold_off[:n],
            is_rc[:n].astype(bool),
        )


def native_collision_batch(
    query_codes: np.ndarray,
    concat: np.ndarray,
    ref_global: np.ndarray,
    ref_off: np.ndarray,
    ref_len: np.ndarray,
    bstart: np.ndarray,
    blen: np.ndarray,
    bnbp: np.ndarray,
):
    """Batched +-20bp hash-collision sampling check
    (candidates._passes_collision_check is the oracle).  Returns uint8[k]
    pass flags, or None when the library is unavailable."""
    lib = get_candidates_library()
    if lib is None or not hasattr(lib, "mapper_collision_batch"):
        return None
    k = int(ref_global.shape[0])
    c = np.ascontiguousarray
    query_codes = c(query_codes, dtype=np.uint8)
    concat = c(concat, dtype=np.uint8)
    ref_global = c(ref_global, dtype=np.int64)
    ref_off = c(ref_off, dtype=np.int64)
    ref_len = c(ref_len, dtype=np.int64)
    bstart = c(bstart, dtype=np.int64)
    blen = c(blen, dtype=np.int64)
    bnbp = c(bnbp, dtype=np.int64)
    out = np.empty(k, dtype=np.uint8)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.mapper_collision_batch(
        query_codes.ctypes.data_as(p_u8),
        query_codes.shape[0],
        concat.ctypes.data_as(p_u8),
        ref_global.ctypes.data_as(p_i64),
        ref_off.ctypes.data_as(p_i64),
        ref_len.ctypes.data_as(p_i64),
        bstart.ctypes.data_as(p_i64),
        blen.ctypes.data_as(p_i64),
        bnbp.ctypes.data_as(p_i64),
        k,
        out.ctypes.data_as(p_u8),
    )
    return out


def native_local_align_one(
    query_codes: np.ndarray,
    ref_codes: np.ndarray,
    r_start: int,
    r_end: int,
    pred_abs: int,
    at_ref_start: bool,
    at_ref_end: bool,
    confident: bool,
    rate: float,
    params,
):
    """Single-problem full local_align (dp.py::local_align in C++).  Returns
    (status, blocks_int32[n,4] local coords, total, aligned) or None when the
    library is unavailable; status -2 means fall back to the Python path."""
    lib = get_library()
    if lib is None:
        return None
    qn = query_codes.shape[0]
    wn = r_end - r_start
    max_blocks = qn + wn + 4
    scratch = _dp_scratch
    buf = getattr(scratch, "blocks", None)
    if buf is None or buf.shape[0] < max_blocks:
        buf = np.empty((max(max_blocks, 512), 4), dtype=np.int32)
        scratch.blocks = buf
        scratch.blocks_ptr = ctypes.cast(
            buf.ctypes.data, ctypes.POINTER(ctypes.c_int32)
        )
        pens = np.empty(2, dtype=np.float64)
        scratch.pens = pens
        p_f64 = ctypes.POINTER(ctypes.c_double)
        scratch.pens_ptr0 = ctypes.cast(pens.ctypes.data, p_f64)
        scratch.pens_ptr1 = ctypes.cast(pens.ctypes.data + 8, p_f64)
    pens = scratch.pens
    # the params pointer is stable for the lifetime of the cached array
    p_ptr = params.__dict__.get("_native_params_ptr")
    if p_ptr is None:
        p_ptr = ctypes.cast(
            _params_array(params).ctypes.data, ctypes.POINTER(ctypes.c_double)
        )
        params.__dict__["_native_params_ptr"] = p_ptr
    if not query_codes.flags.c_contiguous:
        query_codes = np.ascontiguousarray(query_codes)
    if not ref_codes.flags.c_contiguous:
        ref_codes = np.ascontiguousarray(ref_codes)
    status = lib.mapper_local_align_one(
        query_codes.ctypes.data,
        qn,
        ref_codes.ctypes.data + r_start,
        wn,
        r_start,
        pred_abs - r_start,
        1 if at_ref_start else 0,
        1 if at_ref_end else 0,
        1 if confident else 0,
        rate,
        p_ptr,
        scratch.blocks_ptr,
        max_blocks,
        scratch.pens_ptr0,
        scratch.pens_ptr1,
    )
    if status == -2:
        return None
    if status == -1:
        return -1, None, 0.0, 0.0
    nb = 1 if status == 0 else status
    return status, buf[:nb], float(pens[0]), float(pens[1])


def native_local_align_batch(
    qbuf: np.ndarray,
    q_off: np.ndarray,
    q_len: np.ndarray,
    wbuf: np.ndarray,
    w_off: np.ndarray,
    w_len: np.ndarray,
    r_start_abs: np.ndarray,
    pred_local: np.ndarray,
    at_ref_start: np.ndarray,
    at_ref_end: np.ndarray,
    confident: np.ndarray,
    rates: np.ndarray,
    params,
):
    """Batched full local_align (dp.py::local_align semantics in C++, OpenMP
    over problems).  Returns (status int8[k], nblocks int32[k],
    blocks int32[k, max_blocks_per, 4], total f64[k], aligned f64[k]) or None
    when the library is unavailable.  status: -1 none, 0 straight, 1 gapped,
    -2 fall back to the Python path for that problem."""
    lib = get_library()
    if lib is None or not hasattr(lib, "mapper_local_align_batch"):
        return None
    k = int(q_off.shape[0])
    qbuf = np.ascontiguousarray(qbuf, dtype=np.uint8)
    wbuf = np.ascontiguousarray(wbuf, dtype=np.uint8)
    q_off = np.ascontiguousarray(q_off, dtype=np.int64)
    q_len = np.ascontiguousarray(q_len, dtype=np.int32)
    w_off = np.ascontiguousarray(w_off, dtype=np.int64)
    w_len = np.ascontiguousarray(w_len, dtype=np.int32)
    r_start_abs = np.ascontiguousarray(r_start_abs, dtype=np.int64)
    pred_local = np.ascontiguousarray(pred_local, dtype=np.int32)
    at_ref_start = np.ascontiguousarray(at_ref_start, dtype=np.uint8)
    at_ref_end = np.ascontiguousarray(at_ref_end, dtype=np.uint8)
    confident = np.ascontiguousarray(confident, dtype=np.uint8)
    rates = np.ascontiguousarray(rates, dtype=np.float64)
    max_blocks_per = int(q_len.max(initial=0) + w_len.max(initial=0) + 4)
    status = np.empty(k, dtype=np.int8)
    nblocks = np.empty(k, dtype=np.int32)
    blocks = np.empty((k, max_blocks_per, 4), dtype=np.int32)
    total = np.empty(k, dtype=np.float64)
    aligned = np.empty(k, dtype=np.float64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.mapper_local_align_batch(
        qbuf.ctypes.data_as(p_u8),
        q_off.ctypes.data_as(p_i64),
        q_len.ctypes.data_as(p_i32),
        wbuf.ctypes.data_as(p_u8),
        w_off.ctypes.data_as(p_i64),
        w_len.ctypes.data_as(p_i32),
        r_start_abs.ctypes.data_as(p_i64),
        pred_local.ctypes.data_as(p_i32),
        at_ref_start.ctypes.data_as(p_u8),
        at_ref_end.ctypes.data_as(p_u8),
        confident.ctypes.data_as(p_u8),
        rates.ctypes.data_as(p_f64),
        k,
        _params_array(params).ctypes.data_as(p_f64),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        nblocks.ctypes.data_as(p_i32),
        blocks.ctypes.data_as(p_i32),
        max_blocks_per,
        total.ctypes.data_as(p_f64),
        aligned.ctypes.data_as(p_f64),
    )
    return status, nblocks, blocks, total, aligned


def native_pair_driver_batch(
    concat: np.ndarray,
    ref_starts: np.ndarray,
    ref_lens: np.ndarray,
    mate_codes: np.ndarray,
    mate_off: np.ndarray,
    mate_len: np.ndarray,
    expected_inner: np.ndarray,
    spacing_dev: np.ndarray,
    combo_bounds: np.ndarray,
    combo_row0: np.ndarray,
    combo_row1: np.ndarray,
    row_off: np.ndarray,
    row_ref: np.ndarray,
    row_rev: np.ndarray,
    complement16: np.ndarray,
    params,
    max_choices: int = 16,
    max_blocks_out: int = 16,
):
    """Batched exact paired-combo driver (engine._align_paired_pair_exact_inner
    in C++, OpenMP across pairs).  Returns a dict of output arrays or None
    when the library is unavailable.  Per pair: status 0 = ok with
    nchoices[i] choices, 1 = sequential worker owns the pair, 2 = fall back
    to the Python driver."""
    lib = get_library()
    if lib is None or not hasattr(lib, "mapper_pair_driver_batch"):
        return None
    npairs = int(expected_inner.shape[0])
    c = np.ascontiguousarray
    concat = c(concat, dtype=np.uint8)
    ref_starts = c(ref_starts, dtype=np.int64)
    ref_lens = c(ref_lens, dtype=np.int64)
    mate_codes = c(mate_codes, dtype=np.uint8)
    mate_off = c(mate_off, dtype=np.int64)
    mate_len = c(mate_len, dtype=np.int32)
    expected_inner = c(expected_inner, dtype=np.float64)
    spacing_dev = c(spacing_dev, dtype=np.float64)
    combo_bounds = c(combo_bounds, dtype=np.int64)
    combo_row0 = c(combo_row0, dtype=np.int64)
    combo_row1 = c(combo_row1, dtype=np.int64)
    row_off = c(row_off, dtype=np.int64)
    row_ref = c(row_ref, dtype=np.int32)
    row_rev = c(row_rev, dtype=np.uint8)
    complement16 = c(complement16, dtype=np.uint8)
    out = {
        "status": np.empty(npairs, dtype=np.int8),
        "nchoices": np.empty(npairs, dtype=np.int32),
        "spacing": np.empty(npairs * max_choices, dtype=np.float64),
        "total": np.empty(npairs * max_choices, dtype=np.float64),
        "inner": np.empty(npairs * max_choices, dtype=np.int64),
        "comp_s": np.empty(npairs * max_choices * 2, dtype=np.uint8),
        "comp_ref": np.empty(npairs * max_choices * 2, dtype=np.int32),
        "comp_total": np.empty(npairs * max_choices * 2, dtype=np.float64),
        "comp_aligned": np.empty(npairs * max_choices * 2, dtype=np.float64),
        "comp_nb": np.empty(npairs * max_choices * 2, dtype=np.int32),
        "blocks": np.empty(npairs * max_choices * 2 * max_blocks_out * 4, dtype=np.int32),
    }
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i8 = ctypes.POINTER(ctypes.c_int8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.mapper_pair_driver_batch(
        concat.ctypes.data_as(p_u8),
        ref_starts.ctypes.data_as(p_i64),
        ref_lens.ctypes.data_as(p_i64),
        mate_codes.ctypes.data_as(p_u8),
        mate_off.ctypes.data_as(p_i64),
        mate_len.ctypes.data_as(p_i32),
        expected_inner.ctypes.data_as(p_f64),
        spacing_dev.ctypes.data_as(p_f64),
        combo_bounds.ctypes.data_as(p_i64),
        combo_row0.ctypes.data_as(p_i64),
        combo_row1.ctypes.data_as(p_i64),
        row_off.ctypes.data_as(p_i64),
        row_ref.ctypes.data_as(p_i32),
        row_rev.ctypes.data_as(p_u8),
        complement16.ctypes.data_as(p_u8),
        npairs,
        _params_array(params).ctypes.data_as(p_f64),
        float(params.max_error_rate),
        float(params.max_penalty_span),
        max_choices,
        max_blocks_out,
        out["status"].ctypes.data_as(p_i8),
        out["nchoices"].ctypes.data_as(p_i32),
        out["spacing"].ctypes.data_as(p_f64),
        out["total"].ctypes.data_as(p_f64),
        out["inner"].ctypes.data_as(p_i64),
        out["comp_s"].ctypes.data_as(p_u8),
        out["comp_ref"].ctypes.data_as(p_i32),
        out["comp_total"].ctypes.data_as(p_f64),
        out["comp_aligned"].ctypes.data_as(p_f64),
        out["comp_nb"].ctypes.data_as(p_i32),
        out["blocks"].ctypes.data_as(p_i32),
    )
    out["max_choices"] = max_choices
    out["max_blocks_out"] = max_blocks_out
    return out
