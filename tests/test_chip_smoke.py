"""chip_smoke.py's phase functions at a tiny size on the CPU: the same code
paths the smoke run drives on the card (data generation, the CLI runs with
their environment switches, the byte-for-byte comparison, the scorer check
against the reference), with the XLA scorer in place of the kernel."""

import numpy as np
import pytest

import chip_smoke


def test_kernel_check_with_xla_scorer():
    report = chip_smoke.kernel_check(64, 32, rows=96, check_rows=96, scorer="xla")
    assert report["exact_params"]["max_err_banded"] <= 1e-4
    assert report["default_params"]["rows_in_budget"] > 0
    assert report["unreachable_rows"] > 0


def test_kernel_case_covers_edge_rows():
    reads, concat, read_id, reversed_, win_start, lane, n, m = chip_smoke.kernel_case(
        3, 64, 32, rows=256, ref_len=1 << 14
    )
    assert reads.shape == (64, 64) and read_id.shape == (256,)
    assert (m == 1).any()  # unreachable rows
    assert (win_start + m >= concat.shape[0]).any()  # clamped at the reference end
    assert (lane == 31).any() and reversed_.any() and (n == 64).any()


@pytest.mark.parametrize("phase", ["config2", "config3", "config5"])
def test_cli_phase_tiny(phase, tmp_path):
    results = {}
    work = str(tmp_path)
    if phase == "config2":
        chip_smoke.phase3_config2(work, results, num_reads=96, ref_bp=30_000)
    elif phase == "config3":
        chip_smoke.phase4_config3(work, results, num_pairs=48, ref_bp=30_000)
    else:
        chip_smoke.phase5_config5(
            work, results, num_reads=3, read_bp=2_000, ref_bp=200_000, repeat=False
        )
    (label, summary), = results.items()
    assert len(summary["wall_s"]) >= 2
    assert all(v > 0 for v in summary["output_bytes"].values())


def test_budget_agreement():
    big = 1e9
    n = np.array([100, 100, 100, 100])
    ref = np.array([1.0, 50.0, big, 3.0])
    ok, errors = chip_smoke.budget_agreement(ref + [5e-5, 4e-3, 0.0, 0.0], ref, n, 0.1)
    assert ok and errors["rows_in_budget"] == 2
    ok, _ = chip_smoke.budget_agreement(ref + [2e-4, 0.0, 0.0, 0.0], ref, n, 0.1)
    assert not ok
    ok, _ = chip_smoke.budget_agreement(np.array([1.0, 50.0, big - 64, 3.0]), ref, n, 0.1)
    assert not ok  # unreachable rows must be exactly BIG


def test_compare_runs_detects_a_difference():
    runs = {"a": (1.0, {"sam": b"x"}), "b": (1.0, {"sam": b"y"})}
    with pytest.raises(chip_smoke.PhaseFailed):
        chip_smoke.compare_runs("t", runs, {})
    runs["b"] = (2.0, {"sam": b"x"})
    results = {}
    chip_smoke.compare_runs("t", runs, results)
    assert results["t"]["wall_s"] == {"a": 1.0, "b": 2.0}


def test_main_fails_without_a_card(monkeypatch, capsys):
    """No card: non-zero exit and no result line."""

    def no_card():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(chip_smoke, "phase0_card", no_card)
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out
    np.testing.assert_equal(chip_smoke.CARD, "unknown card")
