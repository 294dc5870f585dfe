"""Port parity for the console entry points (`quantpy_tpu_torch.cli`).

The port's `state_interval.run` and `process_interval.run` are held against
the JAX package's on the same JSON records, in float64: the bundled records
of examples/data, and records whose counts are drawn once with numpy (a
1-qubit state, a 2-qubit kron-mode state forced by lowering
`DENSE_POVM_MAX_ELEMENTS` in both packages, a 1-qubit channel). Every
deterministic output (point estimates, moment and Sugiyama radii, the
moment-fidelity and polytope bands with equal `lp_iterations`) agrees at
1e-8; 'mle' is held by likelihood, as in tests/test_torch_cholesky_mle.py
(each estimate's NLL no worse than the JAX package's + 1e-9); the random
intervals ('bootstrap', 'mhmc') by invariants.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu.cli import common as jcommon  # noqa: E402
from quantpy_tpu.cli import process_interval as jproc  # noqa: E402
from quantpy_tpu.cli import state_interval as jstate  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config  # noqa: E402
from quantpy_tpu_torch.cli import common, process_interval, state_interval  # noqa: E402
from quantpy_tpu_torch.measurements import _single_qubit_preset  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA = REPO / "examples" / "data"
ATOL = 1e-8
LEVELS = [0.5, 0.9, 0.99]


def _probs(povm, bloch):
    n = int(round(np.log2(povm.shape[-1]) / 2))
    p = np.clip(np.einsum("mod,d->mo", povm, bloch) * 2**n, 0, None)
    return p / p.sum(-1, keepdims=True)


def _draw(rng, probs, shots):
    return np.stack([rng.multinomial(shots, p) for p in probs]).astype(int)


def _plus_record():
    """A pure |+> state, proj-set, 10^4 shots (tests/test_cli.py's fixture)."""
    state = qtt.Qobj(np.array([1, 1], dtype=float) / np.sqrt(2), is_ket=True)
    povm = qtt.generate_measurement_matrix("proj-set", 1)
    rng = np.random.default_rng(33)
    return {
        "povm_matrix": povm.tolist(),
        "outcomes": _draw(rng, _probs(povm, state.bloch), 10_000).tolist(),
        "target_state": state.bloch.tolist(),
        "conf_levels": LEVELS,
    }


def _kron_record():
    """A 2-qubit GHZ mixture as a kron-mode record (uniform shots)."""
    bloch = 0.9 * qtt.GHZ(2).bloch
    bloch[0] = 0.25
    povm = qtt.generate_measurement_matrix("proj-set", 2)
    rng = np.random.default_rng(55)
    return {
        "povm_kron": _single_qubit_preset("proj-set").tolist(),
        "n_qubits": 2,
        "outcomes": _draw(rng, _probs(povm, bloch), 2_000).tolist(),
        "target_state": qtt.GHZ(2).bloch.tolist(),
        "conf_levels": LEVELS,
    }


def _depolarizing_record():
    """depolarizing(0.35) on one qubit, proj4 inputs, proj-set, 4,000 shots."""
    channel = qtt.depolarizing(0.35)
    rows = qtt.generate_measurement_matrix("proj4", 1)[0]
    states = rows / (2 * rows[:, :1])  # unit-trace bloch vectors
    povm = qtt.generate_measurement_matrix("proj-set", 1)
    rng = np.random.default_rng(71)
    outcomes = [
        _draw(rng, _probs(povm, channel.transform(qtt.Qobj(s)).bloch), 4_000).tolist()
        for s in states
    ]
    return {
        "povm_matrix": povm.tolist(),
        "input_states": states.tolist(),
        "outcomes": outcomes,
        "target_process": channel.choi.bloch.tolist(),
        "conf_levels": [0.5, 0.9],
    }


def _bundled(name):
    with open(DATA / name) as fp:
        return json.load(fp)


STATE_RECORDS = {
    "ghz2": lambda: _bundled("ghz2_state_record.json"),
    "plus": _plus_record,
    "kron2": _kron_record,
}
PROCESS_RECORDS = {
    "cnot2": lambda: _bundled("cnot2_process_record.json"),
    "depolarizing1": _depolarizing_record,
}


@pytest.fixture
def float64():
    prev = config.rdtype()
    config.set_dtype(torch.float64)
    yield
    config.set_dtype(prev)


@pytest.fixture
def kron_budget(monkeypatch):
    """Both packages' tomographs read the 2-qubit kron record in kron mode
    (the CLI builds it from `povm_kron` whatever the budget; the budget
    keeps the intervals on the same path in both)."""
    monkeypatch.setattr(qt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)
    monkeypatch.setattr(qtt.StateTomograph, "DENSE_POVM_MAX_ELEMENTS", 100)


def _recording(monkeypatch, module, name):
    """Replace `module.name` (an interval class) by a subclass that keeps
    its instances; returns the list."""
    made = []
    base = getattr(module, name)

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(module, name, Recorded)
    return made


def _assert_outputs_match(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("record", sorted(STATE_RECORDS))
@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
@pytest.mark.parametrize("interval", ["moment", "sugiyama", "polytope"])
def test_state_cli_matches_jax(float64, kron_budget, monkeypatch, record, method, interval):
    """Point estimate, radius and band: the moment-fidelity band with
    'moment' and 'sugiyama', the polytope band (500 margins, equal
    `lp_iterations`) with the moment radius with 'polytope'."""
    doc = STATE_RECORDS[record]()
    ours_lp = _recording(monkeypatch, state_interval, "PolytopeStateInterval")
    ref_lp = _recording(monkeypatch, jstate, "PolytopeStateInterval")
    ref = jstate.run(doc, method=method, interval=interval)
    ours = state_interval.run(doc, method=method, interval=interval, device="cpu")
    assert set(ours) == {"state", "fidelity_min", "fidelity_max", "hs_radius"}
    assert len(ours["state"]) == len(doc["target_state"])
    assert len(ours["hs_radius"]) == len(doc["conf_levels"])
    _assert_outputs_match(ours, ref)
    assert [iv.lp_iterations for iv in ours_lp] == [
        tuple(int(i) for i in iv.lp_iterations) for iv in ref_lp
    ]


@pytest.mark.parametrize("record, interval", [
    ("cnot2", "moment"), ("depolarizing1", "moment"), ("depolarizing1", "polytope"),
])
def test_process_cli_matches_jax(float64, monkeypatch, record, interval):
    """'lifp' Choi vector, moment radius, and the moment-fidelity band or
    the polytope band (8 margins, equal `lp_iterations`; the 2-qubit
    two-factor LPs take ten seconds on the CPU, so the polytope runs on the
    1-qubit record)."""
    doc = PROCESS_RECORDS[record]()
    ours_lp = _recording(monkeypatch, process_interval, "PolytopeProcessInterval")
    ref_lp = _recording(monkeypatch, jproc, "PolytopeProcessInterval")
    ref = jproc.run(doc, method="lifp", interval=interval, n_points=8)
    ours = process_interval.run(doc, method="lifp", interval=interval, n_points=8,
                                device="cpu")
    assert set(ours) == {"process", "fidelity_min", "fidelity_max", "hs_radius"}
    _assert_outputs_match(ours, ref)
    assert [iv.lp_iterations for iv in ours_lp] == [
        tuple(int(i) for i in iv.lp_iterations) for iv in ref_lp
    ]


def _nll(bloch, doc):
    povm = np.asarray(doc["povm_matrix"], dtype=float)
    counts = np.asarray(doc["outcomes"], dtype=float)
    return -np.sum(counts * np.log(np.clip(_probs(povm, np.asarray(bloch)), 1e-300, None)))


@pytest.mark.parametrize("record", ["ghz2", "plus"])
@pytest.mark.parametrize("method", ["mle", "mle-constr"])
def test_state_cli_mle_by_likelihood(float64, record, method):
    doc = STATE_RECORDS[record]()
    ref = jstate.run(doc, no_ci=True, method=method)["state"]
    ours = state_interval.run(doc, no_ci=True, method=method, device="cpu")["state"]
    assert _nll(ours, doc) <= _nll(ref, doc) + 1e-9
    assert qtt.Qobj(np.asarray(ours)).is_density_matrix(verbose=False)


def test_state_cli_kron_mle_is_rhor(float64, kron_budget):
    """Kron records estimate every MLE method by RrhoR, in both packages."""
    doc = _kron_record()
    ref = jstate.run(doc, no_ci=True, method="mle")
    ours = state_interval.run(doc, no_ci=True, method="mle", device="cpu")
    rhor = state_interval.run(doc, no_ci=True, method="mle-rhor", device="cpu")
    np.testing.assert_allclose(ours["state"], ref["state"], rtol=0, atol=ATOL)
    assert ours == rhor


@pytest.mark.parametrize("method", ["pgdb", "states", "dys"])
def test_process_cli_methods_match_jax(float64, method):
    doc = _depolarizing_record()
    ref = jproc.run(doc, no_ci=True, method=method)
    ours = process_interval.run(doc, no_ci=True, method=method, device="cpu")
    np.testing.assert_allclose(ours["process"], ref["process"], rtol=0, atol=ATOL)
    assert abs(ours["process"][0] - 0.5) < 1e-6  # the TP coordinate


def _check_random_interval(out, n_levels):
    r = np.asarray(out["hs_radius"])
    assert r.shape == (n_levels,)
    assert np.all(np.isfinite(r)) and np.all(r >= 0) and np.all(np.diff(r) >= 0)
    fmin, fmax = np.asarray(out["fidelity_min"]), np.asarray(out["fidelity_max"])
    assert np.all(fmin <= fmax + 1e-9) and np.all(np.isfinite(fmin))


@pytest.mark.parametrize("record, method, interval", [
    ("ghz2", "mle-rhor", "bootstrap"),
    ("ghz2", "mle", "bootstrap"),
    ("kron2", "mle-rhor", "bootstrap"),
    ("plus", "lin", "mhmc"),
])
def test_state_cli_random_intervals(kron_budget, record, method, interval):
    doc = STATE_RECORDS[record]()
    out = state_interval.run(doc, method=method, interval=interval, n_points=64,
                             device="cpu")
    assert set(out) == {"state", "fidelity_min", "fidelity_max", "hs_radius"}
    assert len(out["state"]) == len(doc["target_state"])
    _check_random_interval(out, len(doc["conf_levels"]))


@pytest.mark.parametrize("method, interval", [("lifp", "bootstrap"), ("states", "bootstrap"),
                                              ("lifp", "mhmc")])
def test_process_cli_random_intervals(method, interval):
    doc = _depolarizing_record()
    out = process_interval.run(doc, method=method, interval=interval, n_points=32,
                               device="cpu")
    assert set(out) == {"process", "fidelity_min", "fidelity_max", "hs_radius"}
    assert abs(out["process"][0] - 0.5) < 0.05
    _check_random_interval(out, 2)


def test_state_cli_mhmc_refuses_kron_records(kron_budget):
    doc = _kron_record()
    with pytest.raises(ValueError, match="mhmc") as ref:
        jstate.run(doc, interval="mhmc")
    with pytest.raises(ValueError, match="mhmc") as ours:
        state_interval.run(doc, interval="mhmc", device="cpu")
    assert str(ours.value) == str(ref.value)


def _malformed():
    povm2 = qtt.generate_measurement_matrix("proj-set", 2).tolist()
    block = _single_qubit_preset("proj-set").tolist()
    uneven = np.full((9, 4), 5)
    uneven[0, 0] = 6
    return {
        "state outcomes": ("state", {"povm_matrix": [[[0.5, 0.5, 0, 0], [0.5, -0.5, 0, 0]]],
                                     "outcomes": [[1, 2, 3]]}),
        "state povm 2-D": ("state", {"povm_matrix": [[0.5, 0.5, 0, 0]], "outcomes": [[1, 2]]}),
        "kron block": ("state", {"povm_kron": [[0.5, 0.5, 0]], "n_qubits": 2,
                                 "outcomes": [[1]]}),
        "kron n_qubits": ("state", {"povm_kron": block, "outcomes": [[1]]}),
        "kron outcomes": ("state", {"povm_kron": block, "n_qubits": 2,
                                    "outcomes": np.ones((3, 4)).tolist()}),
        "kron totals": ("state", {"povm_kron": block, "n_qubits": 2,
                                  "outcomes": uneven.tolist()}),
        "process outcomes": ("process", {"povm_matrix": povm2, "input_states": np.eye(16).tolist(),
                                         "outcomes": np.ones((16, 9, 3)).tolist()}),
        "process input_states": ("process", {"povm_matrix": povm2,
                                             "input_states": np.eye(4).tolist(),
                                             "outcomes": np.ones((4, 9, 4)).tolist()}),
        "process blocks": ("process", {"povm_matrix": povm2, "input_states": np.eye(16).tolist(),
                                       "outcomes": np.ones((15, 9, 4)).tolist()}),
    }


@pytest.mark.parametrize("case", sorted(_malformed()))
def test_malformed_records_fail_with_the_jax_messages(case):
    kind, doc = _malformed()[case]
    with pytest.raises(ValueError) as ref:
        jcommon.validate_record(doc, kind)
    with pytest.raises(ValueError) as ours:
        common.validate_record(doc, kind)
    assert str(ours.value) == str(ref.value)
    run = state_interval.run if kind == "state" else process_interval.run
    with pytest.raises(ValueError, match=str(ref.value)[:12]):
        run(doc, device="cpu")


def test_cli_main_writes_json_and_parses_device(tmp_path):
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(_plus_record()))
    out_path = tmp_path / "out.json"
    state_interval.main(["-i", str(path), "-o", str(out_path), "--device", "cpu",
                         "--interval", "sugiyama"])
    out = json.loads(out_path.read_text())
    assert out == state_interval.run(_plus_record(), interval="sugiyama", device="cpu")
    parser = common.build_parser("x")
    assert parser.parse_args(["-i", "r.json"]).device == "cuda"


def test_cli_as_module_on_the_cpu(tmp_path):
    """`python -m quantpy_tpu_torch.cli.state_interval --device cpu` works
    as a console tool (no jax in the subprocess)."""
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(_plus_record()))
    out_path = tmp_path / "out.json"
    res = subprocess.run(
        [sys.executable, "-m", "quantpy_tpu_torch.cli.state_interval",
         "-i", str(path), "-o", str(out_path), "--no-ci", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=dict(os.environ),
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(out_path.read_text())
    expected = state_interval.run(_plus_record(), no_ci=True, device="cpu")
    np.testing.assert_allclose(out["state"], expected["state"], atol=1e-7)
