"""Device-side pileup accumulation (batch/device_pileup.py): the scatter-add
path must reproduce the host MatchDatabase accumulation exactly, and the CLI
with the batch engine (device pileup on) must write byte-identical VCF to the
exact engine (host pileup only)."""

import numpy as np

from mapper_tpu import basepairs


def random_text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def rc_text(t):
    return basepairs.decode(basepairs.reverse_complement(basepairs.encode(t)))


def test_device_pileup_matches_host_fast_path():
    from mapper_tpu.align.blocks import AlignedBlock, QueryAlignment, QueryAlignments
    from mapper_tpu.align.params import AlignmentParameters
    from mapper_tpu.align.blocks import new_sequence_alignment
    from mapper_tpu.batch.candidates import ReadBatch
    from mapper_tpu.batch.device_pileup import DevicePileup
    from mapper_tpu.pileup import MatchDatabase
    from mapper_tpu.sequence import Sequence, SequenceDatabase, sort_and_complement

    rng = np.random.default_rng(3)
    params = AlignmentParameters.defaults()
    contigs = sort_and_complement(
        [
            Sequence.from_text("c1", random_text(3000, 1)),
            Sequence.from_text("c2", random_text(2000, 2)),
        ]
    )
    seq_db = SequenceDatabase(contigs)
    forward = [s for s in contigs if s.complemented_from is None]

    # random clean full-length ungapped emissions (incl. RC reads and SNPs)
    reads, rows = [], []
    for i in range(200):
        contig_i = int(rng.integers(0, len(forward)))
        contig = forward[contig_i]
        n = int(rng.integers(80, 150))
        off = int(rng.integers(0, len(contig) - n))
        frag = list(contig.get_range(off, n))
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, n))] = "ACGT"[int(rng.integers(0, 4))]
        text = "".join(frag)
        reversed_ = bool(rng.random() < 0.5)
        read_text = rc_text(text) if reversed_ else text
        reads.append(Sequence.from_text(f"r{i}", read_text))
        rows.append((i, reversed_, contig, off, n))

    batch = ReadBatch.from_sequences(reads)
    qef = 0.1

    # host accumulation via MatchDatabase's documented path
    host_db = MatchDatabase(qef)
    results = []
    for i, reversed_, contig, off, n in rows:
        seq_a = reads[i].reverse_complement() if reversed_ else reads[i]
        block = AlignedBlock(seq_a, contig, 0, off, n, n)
        alignment = new_sequence_alignment([block], False, params)
        qa = QueryAlignments.single_component(
            [reads[i]], [QueryAlignment(alignment)]
        )
        results.append(qa)
    host_db.add_alignments(results)
    host_pileups = host_db.group_by_position()

    # device accumulation
    dp = DevicePileup(seq_db, qef)
    starts = seq_db.starts
    idx = {id(s): k for k, s in enumerate(contigs)}
    dp.add_rows(
        batch,
        np.array([r[0] for r in rows]),
        np.array([r[1] for r in rows], dtype=bool),
        np.array([int(starts[idx[id(r[2])]]) + r[3] for r in rows]),
        np.array([r[4] for r in rows]),
        np.ones(len(rows), dtype=np.float32),
    )
    dev_db = MatchDatabase(qef)
    dp.merge_into(dev_db)
    dev_pileups = dev_db.group_by_position()

    assert set(s.name for s in dev_pileups) == set(s.name for s in host_pileups)
    for seq, host_p in host_pileups.items():
        dev_p = next(p for s, p in dev_pileups.items() if s.name == seq.name)
        np.testing.assert_array_equal(dev_p.middle, host_p.middle)
        np.testing.assert_array_equal(dev_p.end, host_p.end)


def test_cli_batch_device_pileup_matches_exact_vcf(tmp_path, monkeypatch):
    # the device scatter path is opt-in in production (host differential
    # accumulation is the default)
    monkeypatch.setenv("MAPPER_TPU_DEVICE_PILEUP", "1")
    from mapper_tpu.cli import main

    rng = np.random.default_rng(23)
    ref_text = random_text(20000, 31)
    ref = tmp_path / "ref.fasta"
    ref.write_text(">cA\n" + ref_text[:12000] + "\n>cB\n" + ref_text[12000:] + "\n")
    reads = tmp_path / "reads.fasta"
    lines = []
    for i in range(250):
        pos = int(rng.integers(0, 20000 - 140))
        frag = list(ref_text[pos : pos + 140])
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, 140))] = "ACGT"[int(rng.integers(0, 4))]
        text = "".join(frag)
        if rng.random() < 0.5:
            text = rc_text(text)
        lines.append(f">r{i}\n{text}\n")
    reads.write_text("".join(lines))

    outs = {}
    for engine in ("batch", "exact"):
        vcf = tmp_path / f"out_{engine}.vcf"
        mut = tmp_path / f"out_{engine}.tsv"
        rc = main(
            [
                "--reference", str(ref),
                "--queries", str(reads),
                "--out-vcf", str(vcf),
                "--out-mutations", str(mut),
                "--engine", engine,
            ]
        )
        assert rc == 0
        outs[engine] = (vcf.read_text(), mut.read_text())
    assert outs["batch"][0] == outs["exact"][0], "VCF diverged (device pileup)"
    assert outs["batch"][1] == outs["exact"][1], "mutations diverged"


def test_cli_paired_device_pileup_matches_exact_vcf(tmp_path, monkeypatch):
    monkeypatch.setenv("MAPPER_TPU_DEVICE_PILEUP", "1")
    from mapper_tpu.cli import main

    rng = np.random.default_rng(29)
    ref_text = random_text(25000, 37)
    ref = tmp_path / "ref.fasta"
    ref.write_text(">p1\n" + ref_text + "\n")
    r1 = tmp_path / "r1.fasta"
    r2 = tmp_path / "r2.fasta"
    l1, l2 = [], []
    for i in range(150):
        pos = int(rng.integers(0, 25000 - 400))
        frag = list(ref_text[pos : pos + 350])
        for _ in range(int(rng.integers(0, 4))):
            frag[int(rng.integers(0, 350))] = "ACGT"[int(rng.integers(0, 4))]
        frag = "".join(frag)
        l1.append(f">p{i}/1\n{frag[:120]}\n")
        l2.append(f">p{i}/2\n{rc_text(frag[-120:])}\n")
    r1.write_text("".join(l1))
    r2.write_text("".join(l2))

    outs = {}
    for engine in ("batch", "exact"):
        vcf = tmp_path / f"pout_{engine}.vcf"
        rc = main(
            [
                "--reference", str(ref),
                "--paired-queries", str(r1), str(r2),
                "--spacing", "110", "50",
                "--out-vcf", str(vcf),
                "--engine", engine,
            ]
        )
        assert rc == 0
        outs[engine] = vcf.read_text()
    assert outs["batch"] == outs["exact"], "paired VCF diverged (device pileup)"
