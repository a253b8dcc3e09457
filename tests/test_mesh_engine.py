"""Data-parallel engine over a device mesh: results must be identical to the
single-device engine (scoring is embarrassingly parallel over the candidate
rows; the reference replicates)."""

import jax
import numpy as np
import pytest

from mapper_tpu import Api, AlignmentParameters, basepairs
from mapper_tpu.align.query import Query
from mapper_tpu.batch.engine import BatchAligner
from mapper_tpu.parallel.mesh import make_mesh
from mapper_tpu.sequence import Sequence


def random_text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def rc_text(t):
    return basepairs.decode(basepairs.reverse_complement(basepairs.encode(t)))


@pytest.fixture(scope="module")
def setup():
    ref_text = random_text(20000, 3)
    index = Api.new_database({"c1": ref_text})
    return ref_text, index


def summarize(qa):
    if qa is None:
        return None
    return tuple(
        tuple(
            (a.get_penalty(), tuple(c.content_key() for c in a.get_components()))
            for a in alist
        )
        for alist in qa.get_alignments()
    )


def test_gathered_scores_shard_over_mesh(setup):
    from mapper_tpu.align import banded_dp

    ref_text, index = setup
    mesh = make_mesh(jax.devices())
    assert mesh.size == 8
    params = AlignmentParameters.defaults()
    concat = index.hashblock_database.get_sequence_database().concatenated_codes()
    concat_dev = jax.device_put(concat)
    rng = np.random.default_rng(5)
    lq, band = 64, 32
    reads = np.zeros((16, lq), dtype=np.uint8)
    n_read = rng.integers(40, lq + 1, size=16)
    for r in range(16):
        start = int(rng.integers(0, concat.shape[0] - lq))
        reads[r, : n_read[r]] = concat[start : start + int(n_read[r])]
    B = 50
    read_id = rng.integers(0, 16, size=B).astype(np.int32)
    args = dict(
        read_id=read_id,
        reversed_=rng.random(B) < 0.5,
        win_start=rng.integers(0, concat.shape[0] - lq - band, size=B).astype(np.int64),
        lane=rng.integers(0, band, size=B).astype(np.int64),
        n=n_read[read_id].astype(np.int64),
        m=np.full(B, lq + band, dtype=np.int64),
        params=params,
        band=band,
        tile=8,
        scorer="xla",
    )
    s0, u0 = banded_dp.banded_scores_gathered(reads, concat_dev, **args)
    from jax.sharding import NamedSharding, PartitionSpec

    concat_rep = jax.device_put(concat, NamedSharding(mesh, PartitionSpec()))
    s1, u1 = banded_dp.banded_scores_gathered(reads, concat_rep, mesh=mesh, **args)
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))
    np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))


def test_engine_results_identical_on_mesh(setup):
    ref_text, index = setup
    params = AlignmentParameters.defaults()
    mesh = make_mesh(jax.devices())
    rng = np.random.default_rng(9)
    bases = list("ACGT")
    queries = []
    for i in range(200):  # SE + PE mix with SNPs
        pos = int(rng.integers(0, 20000 - 400))
        frag = list(ref_text[pos : pos + 300])
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, 300))
            frag[j] = bases[int(rng.integers(0, 4))]
        frag = "".join(frag)
        if i % 2 == 0:
            text = frag[:120]
            if rng.random() < 0.5:
                text = rc_text(text)
            queries.append(Query(Sequence.from_text(f"s{i}", text)))
        else:
            queries.append(
                Query(
                    Sequence.from_text(f"p{i}/1", frag[:120]),
                    Sequence.from_text(f"p{i}/2", rc_text(frag[-120:])),
                    expected_inner_distance=60,
                    spacing_deviation_per_unit_penalty=30,
                )
            )
    single = BatchAligner(index, params)
    multi = BatchAligner(index, params, mesh=mesh)
    r0 = single.process_batch(queries, notify=False)
    r1 = multi.process_batch(queries, notify=False)
    for i, (a, b) in enumerate(zip(r0, r1)):
        assert summarize(a) == summarize(b), f"query {i} diverged"


def test_cli_devices_flag_byte_identical(tmp_path):
    """The production CLI run with --devices 8 (8-way virtual CPU mesh) must
    produce byte-identical SAM/VCF to --devices 1 (VERDICT r2 item 1; the
    reference's scale knob is N worker threads, Mapper.java:943-1101)."""
    from mapper_tpu.cli import main

    rng = np.random.default_rng(17)
    ref_text = random_text(30000, 13)
    ref = tmp_path / "ref.fasta"
    ref.write_text(">chr1\n" + ref_text[:18000] + "\n>chr2\n" + ref_text[18000:] + "\n")
    reads = tmp_path / "reads.fasta"
    bases = list("ACGT")
    lines = []
    for i in range(300):
        pos = int(rng.integers(0, 30000 - 160))
        frag = list(ref_text[pos : pos + 160])
        for _ in range(int(rng.integers(0, 4))):
            frag[int(rng.integers(0, 150))] = bases[int(rng.integers(0, 4))]
        if i % 4 == 0:  # indel reads exercise the gapped finalization path
            j = int(rng.integers(15, 130))
            if rng.random() < 0.5:
                del frag[j : j + int(rng.integers(1, 3))]
            else:
                frag.insert(j, bases[int(rng.integers(0, 4))])
        text = "".join(frag[:150])
        if rng.random() < 0.5:
            text = rc_text(text)
        lines.append(f">r{i}\n{text}\n")
    reads.write_text("".join(lines))

    outputs = {}
    for n_dev in (1, 8):
        sam = tmp_path / f"out{n_dev}.sam"
        vcf = tmp_path / f"out{n_dev}.vcf"
        rc = main(
            [
                "--reference", str(ref),
                "--queries", str(reads),
                "--out-sam", str(sam),
                "--out-vcf", str(vcf),
                "--devices", str(n_dev),
            ]
        )
        assert rc == 0
        outputs[n_dev] = (sam.read_text(), vcf.read_text())
    assert outputs[1][0] == outputs[8][0], "SAM diverged across device counts"
    assert outputs[1][1] == outputs[8][1], "VCF diverged across device counts"
