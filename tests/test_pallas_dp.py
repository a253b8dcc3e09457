"""Device banded-DP scoring tests: the jnp reference must agree with the exact
host DP on in-band alignments, the gathered XLA scorer with the reference on
host-built windows, and (on a GPU) the CUDA kernel with the reference.  On the
CPU the kernel's wrapper is tested without the card: scorer selection, fixed
point units, padding, and the [2, B] layout of the lowered FFI call."""

import numpy as np
import pytest

from mapper_tpu import basepairs
from mapper_tpu.align import banded_dp
from mapper_tpu.align.dp import _forward_dp
from mapper_tpu.align.params import AlignmentParameters


def make_params():
    return AlignmentParameters.defaults(max_error_rate=1.0)


def random_pair(rng, n, shift, num_snps=0, indel=0):
    ref = rng.integers(0, 4, size=n + 2 * shift)
    ref_codes = np.array([1, 2, 4, 8], dtype=np.uint8)[ref]
    q = list(ref_codes[shift : shift + n])
    for _ in range(num_snps):
        pos = int(rng.integers(0, len(q)))
        q[pos] = int(np.array([1, 2, 4, 8])[rng.integers(0, 4)])
    if indel > 0:
        pos = int(rng.integers(5, len(q) - 5))
        if rng.random() < 0.5:
            for _ in range(indel):
                q.insert(pos, int(np.array([1, 2, 4, 8])[rng.integers(0, 4)]))
            q = q[:n]
        else:
            del q[pos : pos + indel]
    return np.array(q, dtype=np.uint8), ref_codes


def host_exact_score(q, w, params):
    best, _, _ = _forward_dp(q, w, params, may_extend=False, max_ins_ext=0.0)
    return float(best[q.shape[0]].min())


@pytest.mark.parametrize("seed", range(6))
def test_jnp_scores_match_host_dp(seed):
    rng = np.random.default_rng(seed)
    params = make_params()
    batch_q, batch_w, ns, ms, expected = [], [], [], [], []
    lq, shift = 48, 8
    band = 32
    for case in range(8):
        n = int(rng.integers(20, lq))
        q, w = random_pair(rng, n, shift, num_snps=int(rng.integers(0, 3)), indel=int(rng.integers(0, 2)))
        n = q.shape[0]
        m = w.shape[0]
        expected.append(host_exact_score(q, w, params))
        batch_q.append(np.pad(q, (0, lq - n)))
        batch_w.append(np.pad(w, (0, lq + band - m)))
        ns.append(n)
        ms.append(m)
    scores = np.asarray(
        banded_dp.banded_scores_reference(
            np.stack(batch_q), np.stack(batch_w), np.array(ns), np.array(ms), params, band
        )
    )
    for i in range(8):
        assert scores[i] == pytest.approx(expected[i], abs=1e-4), f"case {i}"


def test_perfect_match_scores_zero():
    params = make_params()
    rng = np.random.default_rng(7)
    q, w = random_pair(rng, 40, 8)
    scores = np.asarray(
        banded_dp.banded_scores_reference(
            q[None, :], w[None, :], np.array([40]), np.array([w.shape[0]]), params, 32
        )
    )
    assert scores[0] == pytest.approx(0.0, abs=1e-6)


def test_snp_scores_mutation_penalty():
    params = make_params()
    rng = np.random.default_rng(8)
    q, w = random_pair(rng, 40, 8, num_snps=1)
    scores = np.asarray(
        banded_dp.banded_scores_reference(
            q[None, :], w[None, :], np.array([40]), np.array([w.shape[0]]), params, 32
        )
    )
    # one SNP -> penalty 1.0 (unless the random SNP hit the same base)
    assert scores[0] in (pytest.approx(0.0), pytest.approx(1.0))


def _gathered_case(seed=11, band=32, lq=64, shift=12, num_reads=24, num_cands=40):
    rng = np.random.default_rng(seed)
    concat = np.array([1, 2, 4, 8], dtype=np.uint8)[rng.integers(0, 4, size=4000)]
    reads = np.zeros((num_reads, lq), dtype=np.uint8)
    n_read = rng.integers(lq // 2, lq + 1, size=num_reads)
    for r in range(num_reads):
        start = int(rng.integers(0, concat.shape[0] - lq))
        reads[r, : n_read[r]] = concat[start : start + int(n_read[r])]
    read_id = rng.integers(0, num_reads, size=num_cands).astype(np.int32)
    reversed_ = rng.random(num_cands) < 0.5
    n = n_read[read_id].astype(np.int64)
    win_start = rng.integers(0, concat.shape[0] - lq - band, size=num_cands).astype(np.int64)
    w_len = np.minimum(n + 2 * shift, concat.shape[0] - win_start).astype(np.int64)
    lane = rng.integers(0, band, size=num_cands).astype(np.int64)
    return concat, reads, read_id, reversed_, win_start, lane, n, w_len


def test_gathered_scoring_matches_host_windows():
    """banded_scores_gathered's plain XLA scorer (device-resident reference,
    on-device RC + window gather + lane pick) must equal the reference scorer
    on host-built windows, and its ungapped lane sums the float64 host sums."""
    import jax

    params = AlignmentParameters.defaults()
    band, lq = 32, 64
    concat, reads, read_id, reversed_, win_start, lane, n, w_len = _gathered_case(
        band=band, lq=lq
    )
    num_cands = read_id.shape[0]

    # host-window reference computation
    q_codes = np.zeros((num_cands, lq), dtype=np.uint8)
    for c in range(num_cands):
        codes = reads[read_id[c], : n[c]]
        if reversed_[c]:
            codes = basepairs.reverse_complement(codes)
        q_codes[c, : n[c]] = codes
    w_idx = win_start[:, None] + np.arange(lq + band, dtype=np.int64)[None, :]
    w_idx = np.minimum(w_idx, concat.shape[0] - 1)
    w_codes = concat[w_idx]
    banded_ref = np.asarray(
        banded_dp.banded_scores_reference(q_codes, w_codes, n, w_len, params, band)
    )
    ung_ref = np.zeros(num_cands)
    for c in range(num_cands):
        for x in range(int(n[c])):
            q, w = int(q_codes[c, x]), int(w_codes[c, x + lane[c]])
            ung_ref[c] += (
                params.ambiguity_penalty * (bin(q | w).count("1") - 1) / 3.0
                if q & w
                else params.mutation_penalty
            )

    concat_dev = jax.device_put(concat)
    banded_got, ung_got = banded_dp.banded_scores_gathered(
        reads, concat_dev, read_id, reversed_, win_start, lane, n, w_len,
        params, band=band, tile=8, read_bucket=8, scorer="xla",
    )
    np.testing.assert_array_equal(np.asarray(banded_got), banded_ref)
    np.testing.assert_allclose(np.asarray(ung_got), ung_ref, atol=1e-4)


def test_quantize_params():
    """Fixed-point units: defaults are 1/30-rational; irrational parameter
    sets and units that could reach the kernel's int32 ceiling give None (the
    XLA scorer)."""
    p = AlignmentParameters.defaults()
    quant = banded_dp._quantize_params(p, 192, 64)
    assert quant == (30, (30, 1, 63, 18, 60, 15))
    # the int32 kernel has room for split-long-read lengths
    assert banded_dp._quantize_params(p, 2048, 128) == quant
    # not exactly representable at any scale <= 1024
    import math

    p_pi = AlignmentParameters.defaults(mutation_penalty=math.pi)
    assert banded_dp._quantize_params(p_pi, 192, 64) is None
    # representable, but a reachable score could pass the int32 ceiling
    p_huge = AlignmentParameters.defaults(mutation_penalty=1e6)
    assert banded_dp._quantize_params(p_huge, 2048, 128) is None


@pytest.mark.parametrize(
    "platform, expected",
    [("gpu", "kernel"), ("cpu", "xla"), ("rocm", ValueError), ("metal", ValueError)],
)
def test_default_scorer_by_platform(platform, expected):
    if expected is ValueError:
        with pytest.raises(ValueError):
            banded_dp.default_scorer(platform)
    else:
        assert banded_dp.default_scorer(platform) == expected


def test_default_scorer_on_this_backend_is_xla():
    assert banded_dp.default_scorer() == "xla"
    assert banded_dp.choose_scorer(None, AlignmentParameters.defaults(), 192, 64) == (
        "xla",
        None,
    )


def test_kernel_refused_gives_xla_scorer():
    """The kernel needs exact fixed-point units and one of its bands; without
    them the XLA scorer runs, decided from the parameters and shapes alone."""
    import math

    p = AlignmentParameters.defaults()
    assert banded_dp.choose_scorer("kernel", p, 192, 64) == (
        "kernel",
        (30, (30, 1, 63, 18, 60, 15)),
    )
    p_pi = AlignmentParameters.defaults(mutation_penalty=math.pi)
    assert banded_dp.choose_scorer("kernel", p_pi, 192, 64) == ("xla", None)
    assert banded_dp.choose_scorer("kernel", p, 192, 16) == ("xla", None)
    with pytest.raises(ValueError):
        banded_dp.choose_scorer("pallas", p, 192, 64)


def test_kernel_wrapper_pads_to_tile_quantum(monkeypatch):
    """The host wrapper pads candidates to the tile quantum and reads to the
    read bucket, hands the kernel scorer its fixed-point units, and cuts the
    [2, padded_B] result back to B rows."""
    import jax.numpy as jnp

    seen = {}

    def fake_fn(mesh, band, scorer, quant=None):
        def run(reads, concat, read_id, reversed_, win_start, lane, n, m, params_vec):
            seen.update(
                reads=reads.shape, rows=read_id.shape, n=n.shape, m=m.shape,
                scorer=scorer, quant=quant, pad_n=int(n[-1, 0]), pad_rev=bool(reversed_[-1]),
            )
            b = read_id.shape[0]
            return jnp.stack([jnp.arange(b, dtype=jnp.float32), -jnp.arange(b, dtype=jnp.float32)])

        return run

    monkeypatch.setattr(banded_dp, "_gathered_fn", fake_fn)
    concat, reads, read_id, reversed_, win_start, lane, n, w_len = _gathered_case(
        band=64, lq=192, num_reads=10, num_cands=37
    )
    banded, ungapped = banded_dp.banded_scores_gathered(
        reads, np.zeros(4000, np.uint8), read_id, reversed_, win_start, lane, n, w_len,
        AlignmentParameters.defaults(), band=64, tile=16, read_bucket=8, scorer="kernel",
    )
    assert seen["reads"] == (16, 192)
    assert seen["rows"] == (48,)
    assert seen["n"] == seen["m"] == (48, 1)
    assert seen["scorer"] == "kernel"
    assert seen["quant"] == (30, (30, 1, 63, 18, 60, 15))
    assert seen["pad_n"] == 1 and seen["pad_rev"] is False
    np.testing.assert_array_equal(np.asarray(banded), np.arange(37, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(ungapped), -np.arange(37, dtype=np.float32))


def test_kernel_lowers_to_one_ffi_call_for_cuda():
    """Lowered for CUDA (no card needed), the kernel scorer is one FFI custom
    call with the [2, B] float32 result and the fixed-point units as
    attributes — the same stacked layout as the XLA form."""
    import functools

    import jax
    import jax.numpy as jnp

    band, lq, rows = 64, 192, 48
    quant = (30, (30, 1, 63, 18, 60, 15))
    core = functools.partial(banded_dp._gathered_core, band=band, scorer="kernel", quant=quant)
    args = (
        jnp.zeros((16, lq), jnp.uint8), jnp.zeros(4096, jnp.uint8),
        jnp.zeros(rows, jnp.int32), jnp.zeros(rows, bool), jnp.zeros(rows, jnp.int32),
        jnp.zeros(rows, jnp.int32), jnp.ones((rows, 1), jnp.int32),
        jnp.ones((rows, 1), jnp.int32), jnp.zeros((1, 6), jnp.float32),
    )
    assert jax.eval_shape(core, *args) == jax.ShapeDtypeStruct((2, rows), jnp.float32)
    text = jax.jit(core).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("stablehlo.custom_call @mapper_banded_scores") == 1
    assert f"tensor<2x{rows}xf32>" in text
    for attr in ("band = 64", "scale = 30", "ins_open = 63", "del_ext = 15"):
        assert attr in text, attr


@pytest.mark.gpu
@pytest.mark.parametrize("lq, band", [(64, 32), (192, 64), (192, 128), (1536, 128)])
def test_kernel_matches_reference_on_gpu(lq, band):
    """The CUDA kernel against banded_scores_reference on the CPU device:
    SNPs, indels, strands, contig edges, band-edge lanes and unreachable
    rows; unreachable rows come back exactly BIG (chip_smoke.kernel_check
    states the tolerances)."""
    import chip_smoke

    report = chip_smoke.kernel_check(lq, band, rows=1024, check_rows=1024)
    assert report["exact_params"]["max_err_banded"] <= 1e-4
    assert report["default_params"]["rows_in_budget"] > 0
    assert report["unreachable_rows"] > 0


@pytest.mark.gpu
def test_gpu_default_scorer_is_kernel():
    assert banded_dp.default_scorer() == "kernel"
