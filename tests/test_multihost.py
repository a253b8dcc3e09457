"""Multi-process skeleton (parallel/multihost.py): a 2-process CPU run must
produce byte-identical SAM and VCF to the 1-process run (VERDICT r2 item 4;
SURVEY §2.2's multi-host mapping)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mapper_tpu import basepairs
from mapper_tpu.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = """
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from mapper_tpu.cli import main
sys.exit(main({args!r}))
"""


def run_cli_subprocess(args, repo=REPO):
    return subprocess.Popen(
        [sys.executable, "-c", DRIVER.format(repo=repo, args=args)],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )


def random_text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def rc_text(t):
    return basepairs.decode(basepairs.reverse_complement(basepairs.encode(t)))


def test_two_process_run_matches_single(tmp_path):
    rng = np.random.default_rng(41)
    ref_text = random_text(20000, 43)
    ref = tmp_path / "ref.fasta"
    ref.write_text(">k1\n" + ref_text[:11000] + "\n>k2\n" + ref_text[11000:] + "\n")
    reads = tmp_path / "reads.fasta"
    lines = []
    for i in range(240):
        pos = int(rng.integers(0, 20000 - 140))
        frag = list(ref_text[pos : pos + 140])
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, 130))] = "ACGT"[int(rng.integers(0, 4))]
        if i % 4 == 0:  # indel reads exercise the gapped finalization path
            j = int(rng.integers(15, 110))
            if rng.random() < 0.5:
                del frag[j : j + int(rng.integers(1, 3))]
            else:
                frag.insert(j, "ACGT"[int(rng.integers(0, 4))])
        text = "".join(frag[:130])
        if rng.random() < 0.5:
            text = rc_text(text)
        lines.append(f">r{i}\n{text}\n")
    reads.write_text("".join(lines))

    def base_args(tag):
        return [
            "--reference", str(ref),
            "--queries", str(reads),
            "--out-sam", str(tmp_path / f"{tag}.sam"),
            "--out-vcf", str(tmp_path / f"{tag}.vcf"),
        ]

    # serial run (in-subprocess too, to keep float environments identical)
    p = run_cli_subprocess(base_args("serial"))
    _, err = p.communicate(timeout=600)
    assert p.returncode == 0, err.decode()[-2000:]

    # 2-process run: both processes concurrently, file-based barrier
    procs = [
        run_cli_subprocess(
            base_args("multi")
            + ["--num-processes", "2", "--process-id", str(k)]
        )
        for k in range(2)
    ]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]

    serial_sam = (tmp_path / "serial.sam").read_text()
    multi_sam = (tmp_path / "multi.sam").read_text()
    assert multi_sam == serial_sam, "SAM diverged across process counts"
    serial_vcf = (tmp_path / "serial.vcf").read_text()
    multi_vcf = (tmp_path / "multi.vcf").read_text()
    assert multi_vcf == serial_vcf, "VCF diverged across process counts"


@pytest.mark.parametrize(
    "process_id, num_processes, num_cards, single_host, card",
    [
        (0, 2, 4, True, 0),
        (3, 4, 4, True, 3),
        (5, 8, 4, False, 1),  # one process per card on each of two hosts
        (1, 2, 0, True, None),  # no card: CPU processes share the host
    ],
)
def test_card_for_process(process_id, num_processes, num_cards, single_host, card):
    assert (
        multihost.card_for_process(process_id, num_processes, num_cards, single_host)
        == card
    )


def test_more_processes_than_cards_is_a_usage_error():
    with pytest.raises(ValueError, match="one GPU per process"):
        multihost.card_for_process(0, 3, 2, single_host=True)


def test_local_card_count(monkeypatch):
    assert multihost.local_card_count() == 0  # the tests hold JAX to the CPU
    assert multihost.local_card_count("cpu") == 0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,2,3")
    assert multihost.local_card_count("cuda") == 3
    assert multihost.local_card_count("") == 3
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "-1")
    assert multihost.local_card_count("cuda,cpu") == 0
