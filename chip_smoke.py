#!/usr/bin/env python3
"""Smoke run of the aligner on an NVIDIA GPU: proves the main path starts,
runs its device kernel as compiled for the card, and produces the same bytes
as the host path.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --four-cards  # phase 7 only, on four cards

Phases (one card):
  0  the card (nvidia-smi) and jax.devices(); fails unless JAX is on a GPU
  2  the tests marked `gpu`, in a subprocess that runs before this process
     touches JAX (one JAX process per card)
  1  the CUDA scorer against banded_scores_reference (CPU device) at
     lq in {192, 1536}, band in {64, 128}, B in {4096, 32768}, with build
     time, compiled memory analysis, and kernel vs plain-XLA timings
  3  config 2: 100,000 x 150 bp SE reads on 4.6 Mb, host scoring vs device
     scoring (MAPPER_TPU_HOST_SCORING=0): byte-identical SAM/VCF/mutations
  4  config 3: 20,000 2x150 pairs on 4.6 Mb, the same two runs
  5  config 5: 500 x 10 kb reads on 10 Mb split at 1500 bp: device runs
     with the kernel and with plain XLA (in turns, twice each) and a
     host-scored run, byte-identical
  6  MAPPER_TPU_DEVICE_CANDIDATES=1 and MAPPER_TPU_DEVICE_PILEUP=1 on 4,096
     config-2 reads, byte-identical to the default run
  7  (--four-cards) --devices 4 vs --devices 1 on configs 3 and 5, a
     ShardedIndex lookup vs the host lookup, per-device memory_stats

Every result line carries the card's name and power limit.  The last line of
standard output is one JSON object, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "unknown card"


def say(message: str) -> None:
    print(f"[{CARD}] {message}", flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(condition: bool, message: str) -> None:
    if not condition:
        raise PhaseFailed(message)


# ---------------------------------------------------------------------------
# phase 0 / 2: the card, and the gpu-marked tests (before JAX in this process)
# ---------------------------------------------------------------------------


def phase0_card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    if not lines:
        raise PhaseFailed("nvidia-smi lists no card")
    print(out, flush=True)
    return lines[0]


def phase2_gpu_tests() -> None:
    env = dict(os.environ, MAPPER_TPU_TESTS_ON_DEVICE="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    say(f"phase 2: gpu tests: {tail} ({time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0 or "skipped" in tail or "passed" not in tail:
        print(proc.stdout[-6000:], proc.stderr[-3000:], file=sys.stderr)
        raise PhaseFailed("gpu-marked tests did not all pass on the card")


# ---------------------------------------------------------------------------
# phase 1: the kernel against the reference
# ---------------------------------------------------------------------------


def kernel_case(seed: int, lq: int, band: int, rows: int, ref_len: int = 1 << 20):
    """Candidate rows at real widths against a random reference: exact
    placements, SNPs, indels, reverse strands, full-length reads, windows
    clamped at the reference end, lanes at the band edge, and unreachable
    rows (a window too short for the read).  Returns the gathered scorer's
    inputs as numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    codes = np.array([1, 2, 4, 8], dtype=np.uint8)
    concat = codes[rng.integers(0, 4, size=ref_len)]
    num_reads = max(1, rows // 4)
    shift = band // 2
    reads = np.zeros((num_reads, lq), dtype=np.uint8)
    n_read = rng.integers(lq // 2, lq + 1, size=num_reads)
    n_read[::7] = lq
    pos_read = rng.integers(shift, ref_len - 2 * lq - band, size=num_reads)
    rev_read = rng.random(num_reads) < 0.5
    for r in range(num_reads):
        n, pos = int(n_read[r]), int(pos_read[r])
        frag = list(concat[pos : pos + n + 8])
        for _ in range(int(rng.integers(0, 6))):  # SNPs
            frag[int(rng.integers(0, n))] = int(codes[rng.integers(0, 4)])
        if r % 3 == 0 and n > 40:  # one indel
            j = int(rng.integers(10, n - 10))
            if rng.random() < 0.5:
                del frag[j : j + int(rng.integers(1, 4))]
            else:
                frag[j:j] = [int(c) for c in codes[rng.integers(0, 4, size=int(rng.integers(1, 4)))]]
        read = np.array(frag[:n], dtype=np.uint8)
        if rev_read[r]:
            read = ((read & 1) << 3) | ((read & 2) << 1) | ((read & 4) >> 1) | ((read & 8) >> 3)
            read = read[::-1]
        reads[r, :n] = read
    read_id = rng.integers(0, num_reads, size=rows).astype(np.int32)
    reversed_ = rev_read[read_id].copy()
    n = n_read[read_id].astype(np.int32)
    jitter = rng.integers(-2, 3, size=rows)
    win_start = (pos_read[read_id] - shift + jitter).astype(np.int64)
    lane = (pos_read[read_id] - win_start).astype(np.int32)
    m = (n + 2 * shift).astype(np.int32)
    k = np.arange(rows)
    # wrong strand or a random window: reachable, high scores
    reversed_[k % 11 == 3] ^= True
    rand_rows = k % 13 == 5
    win_start[rand_rows] = rng.integers(0, ref_len - lq - band, size=int(rand_rows.sum()))
    # windows clamped at the reference end (contig edge)
    edge = k % 17 == 7
    win_start[edge] = ref_len - (n[edge] // 2)
    m[edge] = np.maximum(ref_len - win_start[edge], 1)
    # lanes at the band edge
    lane[k % 19 == 9] = band - 1
    # unreachable: the window is shorter than the read can fit
    dead = k % 23 == 11
    m[dead] = 1
    win_start = np.clip(win_start, 0, ref_len - 1).astype(np.int32)
    return reads, concat, read_id, reversed_, win_start, lane, n, m


def host_reference(reads, concat, read_id, reversed_, win_start, lane, n, m, params, band):
    """banded_scores_reference on host-built windows (CPU device) and the
    ungapped diagonal sum in float64 numpy."""
    import jax
    import numpy as np

    from mapper_tpu.align import banded_dp

    lq = reads.shape[1]
    q = reads[read_id].astype(np.uint8)
    comp = ((q & 1) << 3) | ((q & 2) << 1) | ((q & 4) >> 1) | ((q & 8) >> 3)
    pos = np.arange(lq)[None, :]
    rc_idx = np.clip(n[:, None] - 1 - pos, 0, lq - 1)
    rc = np.where(pos < n[:, None], np.take_along_axis(comp, rc_idx, axis=1), 0)
    q = np.where(reversed_[:, None], rc, q).astype(np.uint8)
    w_idx = np.minimum(win_start[:, None].astype(np.int64) + np.arange(lq + band)[None, :],
                       concat.shape[0] - 1)
    w = concat[w_idx]
    with jax.default_device(jax.devices("cpu")[0]):
        banded = np.asarray(banded_dp.banded_scores_reference(q, w, n, m, params, band))
    ln = np.clip(lane, 0, band - 1)
    wd = np.take_along_axis(w, ln[:, None] + pos, axis=1)
    union = (q | wd).astype(np.int32)
    popc = sum((union >> b) & 1 for b in range(4))
    pen = np.where((q & wd) != 0, params.ambiguity_penalty * (popc - 1) / 3.0,
                   params.mutation_penalty)
    ungapped = np.where(pos < n[:, None], pen, 0.0).sum(axis=1)
    return banded, ungapped


# penalties whose float32 values and sums are exact (ambiguity/3 = 0.25,
# insertion extension 1.25, ...), so the float32 reference itself is exact
EXACT_PARAMS = dict(max_error_rate=0.25, ambiguity_penalty=0.75)


def budget_agreement(got, ref, n, max_error_rate):
    """Agreement of two banded score vectors under inexact float32 penalties:
    within 1e-4 on rows within their accept budget (n * max_error_rate),
    within 1e-4 relative above it, and exactly BIG where `ref` is
    unreachable.  Returns (ok, errors)."""
    import numpy as np

    from mapper_tpu.align import banded_dp

    dead = ref >= banded_dp.BIG / 2
    diff = np.abs(got - ref)
    budget = ~dead & (ref <= n * max_error_rate)
    above = ~dead & ~budget
    err = float(np.max(diff[budget], initial=0.0))
    rel = float(np.max(diff[above] / ref[above], initial=0.0))
    ok = err <= 1e-4 and rel <= 1e-4 and bool(np.all(got[dead] == banded_dp.BIG))
    return ok, {"max_err_in_budget": err, "max_rel_err_above": rel,
                "rows_in_budget": int(budget.sum())}


def kernel_check(lq: int, band: int, rows: int, check_rows: int, seed: int = 0,
                 scorer: str = "kernel") -> dict:
    """Score `rows` candidates with `scorer` on the default device and compare
    the first `check_rows` with the reference, under two parameter sets:

    - exactly representable penalties: every live row within 1e-4;
    - the defaults (2.1, 0.6, ... are inexact in float32, and the reference
      rounds as it accumulates while the kernel's fixed-point sums are exact):
      rows within their accept budget (n * max_error_rate, the scores the
      engine decides on) within 1e-4, rows above it within 1e-4 relative;
      the same for the ungapped sums, which the reference takes in float64.

    Unreachable rows must come back exactly BIG.  Returns the errors."""
    import jax
    import numpy as np

    from mapper_tpu.align import banded_dp
    from mapper_tpu.align.params import AlignmentParameters

    case = kernel_case(seed, lq, band, rows)
    reads, concat = case[0], case[1]
    concat_dev = jax.device_put(concat)
    sub = tuple(a[:check_rows] for a in case[2:])
    n = sub[4]
    report = {}
    for label, params in (("exact_params", AlignmentParameters.defaults(**EXACT_PARAMS)),
                          ("default_params", AlignmentParameters.defaults())):
        got_b, got_u = banded_dp.banded_scores_gathered(
            reads, concat_dev, *case[2:], params, band=band,
            read_bucket=max(1, reads.shape[0]), scorer=scorer,
        )
        got_b = np.asarray(got_b)[:check_rows]
        got_u = np.asarray(got_u)[:check_rows]
        ref_b, ref_u = host_reference(reads, concat, *sub, params, band)
        dead = ref_b >= banded_dp.BIG / 2
        check(np.all(got_b[dead] == banded_dp.BIG),
              f"unreachable rows must be exactly BIG (lq={lq} band={band} {label})")
        err_u = float(np.max(np.abs(got_u - ref_u), initial=0.0))
        if label == "exact_params":
            err = float(np.max(np.abs(got_b - ref_b)[~dead], initial=0.0))
            ok = err <= 1e-4
            report[label] = {"max_err_banded": err, "max_err_ungapped": err_u}
        else:
            ok, report[label] = budget_agreement(got_b, ref_b, n, params.max_error_rate)
            ok_u, report[label]["ungapped"] = budget_agreement(
                got_u, ref_u, n, params.max_error_rate)
            err_u = 0.0 if ok_u else err_u
        check(ok and err_u <= 1e-4,
              f"{scorer} scorer off the reference (lq={lq} band={band} {label}): "
              f"{report[label]}")
        report["unreachable_rows"] = int(dead.sum())
    return report


def _timed(fn, args, reps: int = 5) -> float:
    """Median seconds of fn(*args) after a warm-up call, to block_until_ready."""
    fn(*args).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _memory(analysis) -> dict:
    """compiled.memory_analysis() as a dict of its byte counts."""
    return {k: getattr(analysis, k) for k in dir(analysis) if k.endswith("_in_bytes")}


def phase1_kernel(results: dict) -> None:
    import jax
    import numpy as np

    from mapper_tpu import native
    from mapper_tpu.align import banded_dp
    from mapper_tpu.align.params import AlignmentParameters

    t0 = time.perf_counter()
    banded_dp._register_kernel()
    build = native.cuda_build_seconds
    say(f"phase 1: kernel library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc build {'cached' if build is None else f'{build:.2f} s'})")
    params = AlignmentParameters.defaults()
    params_vec = np.array([[float(v) for v in banded_dp._params_tuple(params)]], np.float32)
    timings = []
    for lq in (192, 1536):
        for band in (64, 128):
            for rows in (4096, 32768):
                errors = kernel_check(lq, band, rows, check_rows=1024,
                                      seed=lq + band + rows)
                reads, concat, read_id, rev, ws, lane, n, m = kernel_case(
                    lq + band + rows, lq, band, rows)
                dev = jax.device_put((reads, concat, read_id, rev, ws, lane,
                                      n.reshape(-1, 1), m.reshape(-1, 1), params_vec))
                quant = banded_dp._quantize_params(params, lq, band)
                k_fn = banded_dp._gathered_fn(None, band, "kernel", quant)
                x_fn = banded_dp._gathered_fn(None, band, "xla", None)
                mem = k_fn.lower(*dev).compile().memory_analysis()
                t_k = _timed(k_fn, dev)
                t_x = _timed(x_fn, dev, reps=3)
                k_out = np.asarray(k_fn(*dev))
                x_out = np.asarray(x_fn(*dev))
                ok, agree = budget_agreement(k_out[0], x_out[0], n, params.max_error_rate)
                check(ok, f"kernel and XLA scorer disagree on the card: {agree}")
                x_mem = x_fn.lower(*dev).compile().memory_analysis()
                row = {
                    "lq": lq, "band": band, "rows": rows,
                    "kernel_ms": t_k * 1e3, "xla_ms": t_x * 1e3,
                    "speedup": t_x / t_k, "errors": errors,
                    "kernel_vs_xla_on_card": agree,
                    "kernel_memory": _memory(mem), "xla_memory": _memory(x_mem),
                }
                timings.append(row)
                say("phase 1: " + json.dumps(row))
    results["kernel"] = {"nvcc_build_s": build, "shapes": timings}


# ---------------------------------------------------------------------------
# phases 3-7: the CLI end to end
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def xla_scorer():
    """Route the device scorer to plain XLA for one run (the comparison the
    kernel has to win); the CLI itself always takes the platform default."""
    from mapper_tpu.align import banded_dp

    saved = banded_dp.default_scorer
    banded_dp.default_scorer = lambda platform=None: "xla"
    try:
        yield
    finally:
        banded_dp.default_scorer = saved


def run_cli(args: list[str], outputs: dict[str, str], tag: str):
    """One CLI run writing each output flag to <tag>.<name>; returns (wall
    seconds, {name: bytes})."""
    from mapper_tpu.cli import main as cli_main

    argv = list(args)
    paths = {}
    for name, flag in outputs.items():
        paths[name] = f"{tag}.{name}"
        argv += [flag, paths[name]]
    t0 = time.perf_counter()
    rc = cli_main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"CLI run {tag} exited {rc}")
    blobs = {}
    for name, path in paths.items():
        with open(path, "rb") as f:
            blobs[name] = f.read()
        os.remove(path)
    return wall, blobs


def compare_runs(label: str, runs: dict, results: dict) -> None:
    """Every run's outputs must equal the first run's, byte for byte."""
    names = list(runs)
    _, base = runs[names[0]]
    for other in names[1:]:
        for out_name, blob in runs[other][1].items():
            check(blob == base[out_name],
                  f"{label}: {out_name} differs between {names[0]} and {other}")
    sizes = {k: len(v) for k, v in base.items()}
    check(all(sizes.values()), f"{label}: empty output {sizes}")
    walls = {name: round(runs[name][0], 3) for name in names}
    results[label] = {"wall_s": walls, "output_bytes": sizes}
    say(f"{label}: byte-identical {', '.join(names)}; wall s {walls}; bytes {sizes}")


def make_config2(work: str, num_reads: int, ref_bp: int = 4_600_000):
    import numpy as np

    from benchmarks import simlib

    ref = os.path.join(work, "c2_ref.fasta")
    reads = os.path.join(work, f"c2_reads_{num_reads}.fasta")
    if not os.path.exists(ref):
        simlib.write_reference(ref, {"chr1": simlib.random_reference(np.random.default_rng(2), ref_bp)})
    if not os.path.exists(reads):
        text = _read_reference(ref)
        simlib.simulate_single(reads, text, num_reads, seed=2)
    return ref, reads


def make_config3(work: str, num_pairs: int, ref_bp: int = 4_600_000):
    import numpy as np

    from benchmarks import simlib

    ref = os.path.join(work, "c3_ref.fasta")
    q1 = os.path.join(work, f"c3_{num_pairs}_1.fasta")
    q2 = os.path.join(work, f"c3_{num_pairs}_2.fasta")
    if not os.path.exists(ref):
        simlib.write_reference(ref, {"chr1": simlib.random_reference(np.random.default_rng(7), ref_bp)})
    if not os.path.exists(q1):
        simlib.simulate_paired(q1, q2, _read_reference(ref), num_pairs, seed=7)
    return ref, q1, q2


def make_config5(work: str, num_reads: int, read_bp: int = 10_000, ref_bp: int = 10_000_000):
    """A base genome plus three mutated copies of a 50 kb segment (the
    duplication structure of BASELINE config 5), and long SE reads."""
    import numpy as np

    from benchmarks import simlib

    ref = os.path.join(work, "c5_ref.fasta")
    reads = os.path.join(work, f"c5_reads_{num_reads}.fasta")
    if not os.path.exists(ref):
        rng = np.random.default_rng(5)
        base = simlib.random_reference(rng, ref_bp - 150_000)
        segment = np.array(list(base[:50_000]))
        copies = "".join("".join(simlib.mutate(rng, segment, 0.02)) for _ in range(3))
        simlib.write_reference(ref, {"chr1": base + copies})
    if not os.path.exists(reads):
        simlib.simulate_single(reads, _read_reference(ref), num_reads,
                               read_length=read_bp, snp_rate=0.02, seed=5)
    return ref, reads


def _read_reference(path: str) -> str:
    with open(path) as f:
        return "".join(line.strip() for line in f if not line.startswith(">"))


SE_OUTPUTS = {"sam": "--out-sam", "vcf": "--out-vcf", "mutations": "--out-mutations"}
PE_OUTPUTS = {"sam": "--out-sam", "vcf": "--out-vcf"}


def phase3_config2(work: str, results: dict, num_reads: int = 100_000,
                   ref_bp: int = 4_600_000) -> None:
    ref, reads = make_config2(work, num_reads, ref_bp)
    args = ["--reference", ref, "--queries", reads]
    tag = os.path.join(work, "c2")
    runs = {"host": run_cli(args, SE_OUTPUTS, tag)}
    with env(MAPPER_TPU_HOST_SCORING="0"):
        runs["device"] = run_cli(args, SE_OUTPUTS, tag)
    compare_runs(f"phase 3: config 2 ({num_reads} x 150 bp SE)", runs, results)


def phase4_config3(work: str, results: dict, num_pairs: int = 20_000,
                   ref_bp: int = 4_600_000) -> None:
    ref, q1, q2 = make_config3(work, num_pairs, ref_bp)
    args = ["--reference", ref, "--paired-queries", q1, q2, "--spacing", "100", "50"]
    tag = os.path.join(work, "c3")
    runs = {"host": run_cli(args, PE_OUTPUTS, tag)}
    with env(MAPPER_TPU_HOST_SCORING="0"):
        runs["device"] = run_cli(args, PE_OUTPUTS, tag)
    compare_runs(f"phase 4: config 3 ({num_pairs} 2x150 pairs)", runs, results)


def phase5_config5(work: str, results: dict, num_reads: int = 500,
                   read_bp: int = 10_000, ref_bp: int = 10_000_000,
                   repeat: bool = True) -> None:
    ref, reads = make_config5(work, num_reads, read_bp, ref_bp)
    args = ["--reference", ref, "--split-queries-past-size", "1500", "--queries", reads]
    tag = os.path.join(work, "c5")
    # kernel and XLA in turns (kernel, xla, host, xla, kernel), so neither
    # side carries all of the first run's compiles
    runs = {"kernel": run_cli(args, PE_OUTPUTS, tag)}
    with xla_scorer():
        runs["xla"] = run_cli(args, PE_OUTPUTS, tag)
    with env(MAPPER_TPU_HOST_SCORING_MAX_LEN=str(10 * read_bp)):
        runs["host"] = run_cli(args, PE_OUTPUTS, tag)
    if repeat:
        with xla_scorer():
            runs["xla_2"] = run_cli(args, PE_OUTPUTS, tag)
        runs["kernel_2"] = run_cli(args, PE_OUTPUTS, tag)
    compare_runs(f"phase 5: config 5 ({num_reads} x {read_bp} bp, split 1500)", runs, results)


def phase6_opt_in(work: str, results: dict, num_reads: int = 4096) -> None:
    ref, reads = make_config2(work, num_reads)
    args = ["--reference", ref, "--queries", reads]
    tag = os.path.join(work, "c6")
    runs = {"default": run_cli(args, SE_OUTPUTS, tag)}
    with env(MAPPER_TPU_DEVICE_CANDIDATES="1"):
        runs["device_candidates"] = run_cli(args, SE_OUTPUTS, tag)
    with env(MAPPER_TPU_DEVICE_PILEUP="1"):
        runs["device_pileup"] = run_cli(args, SE_OUTPUTS, tag)
    compare_runs(f"phase 6: opt-in device paths ({num_reads} config-2 reads)", runs, results)


def phase7_four_cards(work: str, results: dict, num_pairs: int = 20_000,
                      num_long: int = 500, ref_bp: int = 4_600_000,
                      long_read_bp: int = 10_000, long_ref_bp: int = 10_000_000) -> None:
    import jax
    import numpy as np

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 devices, have {len(jax.devices())}")
    ref, q1, q2 = make_config3(work, num_pairs, ref_bp)
    args = ["--reference", ref, "--paired-queries", q1, q2, "--spacing", "100", "50"]
    tag = os.path.join(work, "c7")
    runs = {f"devices_{d}": run_cli(args + ["--devices", str(d)], PE_OUTPUTS, tag)
            for d in (1, 4)}
    compare_runs(f"phase 7: config 3 ({num_pairs} pairs) --devices 4 vs 1", runs, results)
    ref5, reads5 = make_config5(work, num_long, long_read_bp, long_ref_bp)
    args5 = ["--reference", ref5, "--split-queries-past-size", "1500", "--queries", reads5]
    runs = {f"devices_{d}": run_cli(args5 + ["--devices", str(d)], PE_OUTPUTS, tag)
            for d in (1, 4)}
    compare_runs(f"phase 7: config 5 ({num_long} x {long_read_bp} bp) --devices 4 vs 1",
                 runs, results)

    from mapper_tpu import Api
    from mapper_tpu.batch.candidates import ReadBatch, collect_batch_seeds
    from mapper_tpu.parallel.mesh import make_mesh
    from mapper_tpu.parallel.sharded_index import ShardedIndex
    from mapper_tpu.sequence import Sequence

    text = _read_reference(ref)
    db = Api.new_database({"chr1": text}).hashblock_database
    rng = np.random.default_rng(46)
    reads = []
    for i in range(512):
        pos = int(rng.integers(0, len(text) - 160))
        reads.append(Sequence.from_text(f"r{i}", text[pos : pos + 150]))
    _, _, _, num_bp, key, _ = collect_batch_seeds(ReadBatch.from_sequences(reads), db)
    sharded = ShardedIndex(db, make_mesh(jax.devices()[:4]), k_match=12)
    vals, counts, valid = sharded.lookup(num_bp, key)
    merged = db.merged_index()
    bins = merged["bases"][num_bp] + np.remainder(key, merged["capacities"][num_bp])
    host_counts = merged["counts"][bins]
    take = np.minimum(host_counts, np.minimum(merged["caps"][num_bp], 12))
    j = np.arange(12)[None, :]
    sel = j < take[:, None]
    vidx = np.minimum(merged["offsets"][bins][:, None] + j, len(merged["values"]) - 1)
    expected = np.where(sel, merged["values"][vidx], 0)
    check(np.array_equal(counts, host_counts) and np.array_equal(sel, valid)
          and np.array_equal(np.where(valid, vals, 0), expected),
          "ShardedIndex lookup differs from the host lookup")
    say(f"phase 7: ShardedIndex lookup of {key.shape[0]} seeds over 4 devices "
        "matches the host lookup")
    peaks = {str(d): (d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:4]}
    results["four_card_peak_bytes"] = peaks
    say(f"phase 7: peak bytes in use per device {peaks}")
    check(sum(1 for v in peaks.values() if v) == 4, "work did not reach all four devices")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only phase 7, on four cards")
    opts = parser.parse_args(argv)
    sys.path.insert(0, REPO)
    results: dict = {}
    try:
        CARD = phase0_card()
        if not opts.four_cards:
            phase2_gpu_tests()
        import jax

        devices = jax.devices()
        say(f"phase 0: jax.devices() = {devices}")
        check(devices[0].platform == "gpu",
              f"JAX runs on {devices[0].platform}, not on a GPU")
        with tempfile.TemporaryDirectory() as work:
            if opts.four_cards:
                phase7_four_cards(work, results)
            else:
                phase1_kernel(results)
                phase3_config2(work, results)
                phase4_config3(work, results)
                phase5_config5(work, results)
                phase6_opt_in(work, results)
    except Exception as e:  # any failed phase fails the run, with no result line
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    results["card"] = CARD
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    name = "chip_smoke_four_cards.json" if opts.four_cards else "chip_smoke.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(results, f, indent=1)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
