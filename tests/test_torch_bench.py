"""The port's benchmark (`quantpy_tpu_torch.bench`, the twin of bench.py)
on the CPU at small sizes: the work count behind `tflops` and
`mfu_f32_pct`, the card's FP32 peak read at run time, the JSON line's keys,
a failed section recorded in `skipped`, and a module that imports neither
JAX nor the JAX package nor the repository's root scripts.

The sizes shrink by monkeypatching the module's constants: a 2-qubit
headline of 64 resamples at 10 iterations, one 2-qubit scaling row and
2-qubit 6q/10q/process rows of a few resamples.
"""

import json
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quantpy_tpu_torch import bench  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

REPO = pathlib.Path(__file__).resolve().parents[1]

# the extras keys bench.py writes (bench.py:181-187, 200, 214, 268, 294,
# 306, 324, 353) less mfu_exposed_pct, and the twin's own four
BENCH_PY_KEYS = {
    "mfu_f32_pct", "mfu_exposed_pct", "tflops", "mle_iters", "n_points", "state_lin_6q_ms",
    "state_boot_6q_mle_rec_s", "state_scaling_kron", "state_boot_10q_mle_rec_s",
    "kernel_lane_rec_s", "kernel_flat_rec_s", "process_boot_4q_rec_s",
}
EXTRAS_KEYS = BENCH_PY_KEYS - {"mfu_exposed_pct"} | {"skipped", "times_ms", "spread", "device"}
PEAK_STAND_IN = 1.0  # TFLOP/s: the CPU has no card to read a peak from


@pytest.fixture
def small(monkeypatch):
    for name, value in (("N_QUBITS", 2), ("N_POINTS", 64), ("MLE_ITERS", 10),
                        ("SCALING_QUBITS", (2,)), ("STATE_6Q", (2, 8)), ("STATE_10Q", (2, 4)),
                        ("PROCESS_BOOT", (2, 1_000, 4))):
        monkeypatch.setattr(bench, name, value)


@pytest.fixture
def peak(monkeypatch):
    monkeypatch.setattr(bench, "fp32_peak_tflops", lambda device: PEAK_STAND_IN)


def _run(capsys, argv=("--device", "cpu")):
    result = bench.main(list(argv))
    out, err = capsys.readouterr()
    last = json.loads(out.splitlines()[-1])
    assert last == result
    return result, err


def test_work_count_at_the_flagship_shape():
    assert bench.macs_per_resample_iteration(4, 81, 16) == 688_128
    flop = bench.flops_per_resample(4, 81, 16, 60) * 16_384
    np.testing.assert_allclose(flop, 1.353e12, rtol=1e-3)
    # 1.353 TFLOP in 101 ms on a 66.9 TFLOP/s card: 20.02 %
    np.testing.assert_allclose(bench.fp32_share_pct(flop, 101.0, 66.9),
                               100 * flop / 0.101 / 66.9e12, rtol=1e-12)
    assert bench.spread([2.0, 3.0, 2.5]) == 0.5


def test_fp32_peak_is_read_from_the_card(monkeypatch):
    """SMs x 128 FP32 lanes x 2 x clocks.max.sm on Hopper; no guess where
    the card or its compute capability is unknown."""
    props = SimpleNamespace(major=9, minor=0, multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    monkeypatch.setattr(bench, "_nvidia_smi", lambda device, query: "1980 MHz")
    np.testing.assert_allclose(bench.fp32_peak_tflops(torch.device("cuda", 0)), 66.908,
                               rtol=1e-4)
    props.major = 8
    with pytest.raises(ValueError, match="compute capability"):
        bench.fp32_peak_tflops(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="no card"):
        bench.fp32_peak_tflops(torch.device("cpu"))
    assert bench.device_label(torch.device("cpu")) == "cpu"


def test_main_prints_bench_py_keys(small, peak, capsys):
    line, err = _run(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extras"}
    extras = line["extras"]
    assert set(extras) == EXTRAS_KEYS
    assert extras["skipped"] == {}
    assert "(all finite: True)" in err
    assert line["value"] > 0
    np.testing.assert_allclose(line["vs_baseline"] / line["value"], 18.0, rtol=1e-4)
    assert line["metric"] == ("bootstrapped 2-qubit MLE reconstructions/sec (proj-set, "
                              "10k shots/POVM, RrhoR-10)")
    assert extras["device"] == "cpu" and (extras["mle_iters"], extras["n_points"]) == (10, 64)
    best = min(extras["times_ms"]["value"])
    assert len(extras["times_ms"]["value"]) == bench.HEADLINE_REPS
    flop = bench.flops_per_resample(2, 9, 4, 10) * 64
    assert abs(extras["mfu_f32_pct"] - bench.fp32_share_pct(flop, best, PEAK_STAND_IN)) <= 0.051
    for key in ("kernel_lane_rec_s", "kernel_flat_rec_s", "state_boot_10q_mle_rec_s"):
        assert len(extras["times_ms"][key]) == bench.VARIANT_REPS
        assert extras["spread"][key] >= 0
    assert set(extras["times_ms"]) == set(extras["spread"]) == {
        "value", "kernel_lane_rec_s", "kernel_flat_rec_s", "state_boot_10q_mle_rec_s"}
    (row,) = extras["state_scaling_kron"].values()
    assert set(row) == {"lin_ms", "mle60_ms", "mle_hs"} and 0 <= row["mle_hs"] < 0.05
    for key in ("state_boot_6q_mle_rec_s", "kernel_flat_rec_s", "process_boot_4q_rec_s"):
        assert extras[key] > 0


def test_scaling_rows_time_both_draws_from_11_qubits(small, peak, capsys, monkeypatch):
    """bench.py's 11-qubit row times the chunked draw (`simulate_chunked_s`);
    the twin's times it beside the fused one (`simulate_s`)."""
    monkeypatch.setattr(bench, "SIMULATE_ROW_QUBITS", 2)
    line, _ = _run(capsys)
    (row,) = line["extras"]["state_scaling_kron"].values()
    assert set(row) == {"simulate_s", "simulate_chunked_s", "lin_ms", "mle60_ms", "mle_hs"}
    assert row["simulate_s"] >= 0 and row["simulate_chunked_s"] >= 0
    assert 0 <= row["mle_hs"] < 0.05


def test_a_failed_section_is_named_in_skipped(small, peak, capsys, monkeypatch):
    error = RuntimeError("injected")

    def fail(device, label):
        raise error

    monkeypatch.setattr(bench, "process_boot_4q", fail)
    line, err = _run(capsys)
    assert line["value"] > 0
    assert line["extras"]["skipped"] == {"process_boot_4q": repr(error)}
    assert "process_boot_4q_rec_s" not in line["extras"]
    assert "kernel_flat_rec_s" in line["extras"]
    assert "secondary process_boot_4q skipped: RuntimeError('injected')" in err


def test_no_peak_no_share(small, capsys, monkeypatch):
    """Without a card the FP32 peak cannot be read: `mfu_f32_pct` is left
    out and `skipped` says why."""
    for name in ("state_6q", "state_scaling_kron", "state_boot_10q", "kernel_variants",
                 "process_boot_4q"):
        monkeypatch.setattr(bench, name, lambda *args: {})
    line, _ = _run(capsys)
    extras = line["extras"]
    assert "mfu_f32_pct" not in extras and extras["tflops"] >= 0
    assert list(extras["skipped"]) == ["mfu_f32_pct"]
    assert "no card" in extras["skipped"]["mfu_f32_pct"]


def test_the_default_device_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_imports_nothing_of_jax_or_the_root_scripts():
    code = ("import sys, quantpy_tpu_torch.bench, quantpy_tpu_torch.entry; "
            "print(sorted(m for m in ('jax', 'quantpy_tpu', 'bench', '__graft_entry__') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
