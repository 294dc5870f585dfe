"""The route of `process_core._dykstra_run` on the CPU: which steps it would
replay from a captured CUDA graph (float32 'eigh' steps on the card of Choi
matrices up to 64 x 64, and no others), the eager loop's counters with
`graph` 0, and the replay loop itself on a CPU stand-in of the captured
step: the same iterates, stop step and counters as the eager loop, one
capture per shape, and results that are the run's own tensors. The card's
capture and replay are held to the eager loop in tests/test_torch_cuda.py."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from quantpy_tpu_torch.ops import kernels  # noqa: E402
from quantpy_tpu_torch.tomography import process_core  # noqa: E402
from quantpy_tpu_torch.utils import profiling  # noqa: E402

from ._torch_cpu import on_cpu  # noqa: E402, F401

F32, F64 = torch.float32, torch.float64


def _like(device: str, dtype, d2: int, batch: int = 64):
    """A batch of Choi bloch vectors as the route reads it: a CPU tensor, or
    a stand-in with a card's device, dtype and shape."""
    if device == "cpu":
        return torch.zeros(batch, d2, dtype=dtype)
    return SimpleNamespace(device=torch.device(device, 0), dtype=dtype, shape=(batch, d2),
                           numel=lambda: batch * d2)


@pytest.mark.parametrize("device, dtype, d2, cp, batch, graphed", [
    ("cuda", F32, 16**3, "eigh", 64, True),  # 3 qubits: 64 x 64 Choi matrices
    ("cuda", F32, 16**3, "eigh", 1, True),  # a point estimate
    ("cuda", F32, 16, "eigh", 64, True),
    ("cuda", F32, 16**4, "eigh", 64, False),  # 4 qubits: 256 x 256, past the kernel
    ("cuda", F64, 16**3, "eigh", 64, False),
    ("cuda", F32, 16**3, "ns", 64, False),
    ("cuda", F32, 16**3, "eigh", 0, False),  # nothing to project
    ("cpu", F32, 16**3, "eigh", 64, False),
    ("cpu", F64, 16, "eigh", 64, False),
])
def test_graph_route(device, dtype, d2, cp, batch, graphed):
    assert process_core._graph_route(_like(device, dtype, d2, batch), cp) is graphed


def _choi(n, batch, seed, dtype):
    """Bloch vectors near a CPTP point, off both sets."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 16**n)) * 0.3 / 4**n
    x[:, 0] = 1.0 / 2**n
    return torch.as_tensor(x, dtype=dtype)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _dykstra_counts():
    (dykstra,) = [s for s in profiling.recorded() if s.name == "qt.dykstra"]
    return dykstra.counts


@pytest.mark.parametrize("cp, dtype", [("eigh", F32), ("eigh", F64), ("ns", F32)])
def test_eager_loop_carries_graph_zero(cp, dtype):
    x = _choi(1, 5, seed=3, dtype=dtype)
    with _profile():
        process_core.cptp_project_bloch(x, max_iter=300, cp=cp)
    counts = _dykstra_counts()
    assert 1 < counts["iters"] < 300
    assert counts == {"iters": counts["iters"], "graph": 0, "host_sync": counts["iters"]}


def _cpu_capture(self):
    """`_StepGraph._capture`'s stand-in on the CPU: the eager first step, then
    a 'graph' whose replay runs the step on the static state, as the card's
    replays do."""
    *new, crit = process_core._dykstra_step(*self.state)
    self._store(new)

    def replay():
        *new, self.crit = process_core._dykstra_step(*self.state)
        self._store(new)

    self.graph = SimpleNamespace(replay=replay)
    profiling.count("captures")
    return (*self.state, crit)


@pytest.mark.parametrize("chunk, tol", [(1, 1e-9), (3, 1e-9), (4, None)])
def test_replay_loop_runs_the_eager_steps(monkeypatch, chunk, tol):
    x = _choi(1, 6, seed=5, dtype=F64)
    zeros = torch.zeros_like(x)
    with _profile():
        eager = process_core._dykstra_run(x, zeros, zeros, 40, chunk, tol, "eigh", 19)
    eager_counts = _dykstra_counts()
    monkeypatch.setattr(process_core, "_graphs", {})
    monkeypatch.setattr(process_core, "_graph_route", lambda x, cp: cp == "eigh")
    monkeypatch.setattr(process_core._StepGraph, "_capture", _cpu_capture)
    for captures in (1, 0):  # the second run at the shape replays the first one's graph
        launches = kernels.psd_project.launches
        with _profile():
            out = process_core._dykstra_run(x, zeros, zeros, 40, chunk, tol, "eigh", 19)
        counts = _dykstra_counts()
        iters = eager_counts["iters"]
        assert counts.pop("captures", 0) == captures
        assert counts == dict(eager_counts, graph=iters - captures)
        assert kernels.psd_project.launches - launches == iters - captures
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
    (graph,) = process_core._graphs[x.device][1].values()
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(out, graph.state))
    assert out[3].data_ptr() != graph.crit.data_ptr()
