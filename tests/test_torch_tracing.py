"""The port's spans and counters (`quantpy_tpu_torch.utils.profiling`) on
the CPU: they record only while a profiler session records, as one tree
per call on the profiler's own clock, as host ranges but for the mesh's
shards; Dykstra counts its steps and reads, the mesh's shards are children
of the call in their worker threads, and a new session drops the last
one's spans."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch.parallel import mesh  # noqa: E402
from quantpy_tpu_torch.tomography import bootstrap_core, process_core  # noqa: E402
from quantpy_tpu_torch.utils import StageTimer, profiling  # noqa: E402

from ._torch_cpu import on_cpu, on_cpu_module  # noqa: E402, F401

LIN_SPANS = {"qt.interval", "qt.interval.inputs", "qt.sample", "qt.lin.solve", "qt.lin.clip",
             "qt.interval.readback", "qt.interval.sort"}


def profile(all_threads: bool = False):
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=all_threads)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  experimental_config=config)


@pytest.fixture(scope="module")
def tmg():
    t = qtt.StateTomograph(qtt.GHZ(2), key=1, device="cpu", dtype=torch.float32)
    t.experiment(1000, "proj-set")
    t.point_estimate("lin")
    return t


def lin_call(tmg, key=3):
    qtt.BootstrapStateInterval(tmg, n_points=50, key=key).setup()


def test_without_a_profiler_nothing_is_recorded(tmg):
    before = profiling.recorded()
    lin_call(tmg)
    after = profiling.recorded()
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    assert profiling.span("qt.interval") is profiling.span("qt.sample")  # the shared no-op
    assert profiling.current() is None


def test_a_traced_call_is_one_tree_on_the_profilers_clock(tmg):
    lin_call(tmg)  # warm
    with profile() as prof:
        t0 = time.time_ns()
        lin_call(tmg)
        t1 = time.time_ns()
    spans = profiling.recorded()
    assert {s.name for s in spans} == LIN_SPANS
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "qt.interval" and root.device == torch.device("cpu")
    ids = {s.id for s in spans}
    assert len(ids) == len(spans)
    for s in spans:
        assert s.root == root.id and (s is root or s.parent in ids)
        assert s.thread == threading.get_ident()
        assert t0 <= s.start_ns <= s.end_ns <= t1
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
    assert {s.name: s.counts for s in spans}["qt.interval.readback"] == {"host_sync": 1}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in LIN_SPANS and e.device_type() == torch.autograd.DeviceType.CPU:
            # host ranges, not annotations: they take no kernels from a caller's annotation
            assert not e.is_user_annotation()
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in LIN_SPANS:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs)
        for (a0, a1), (b0, b1) in zip(mine, theirs):
            assert abs(a0 - b0) < 1_000_000 and abs(a1 - b1) < 1_000_000


def test_dykstra_counts_its_steps_and_reads(monkeypatch):
    steps = []
    step = process_core._dykstra_step

    def counted(*args, **kwargs):
        steps.append(1)
        return step(*args, **kwargs)

    monkeypatch.setattr(process_core, "_dykstra_step", counted)
    rng = np.random.default_rng(7)
    choi = torch.as_tensor(rng.normal(size=(5, 16)) * 0.3, dtype=torch.float64)
    choi[:, 0] = 0.5
    with profile():
        process_core.cptp_project_bloch(choi, max_iter=200)
    (dykstra,) = [s for s in profiling.recorded() if s.name == "qt.dykstra"]
    reads = [s for s in profiling.recorded() if s.name == "qt.dykstra.read"]
    assert 1 < len(steps) < 200
    assert dykstra.counts == {"iters": len(steps), "graph": 0, "host_sync": len(steps)}
    assert len(reads) == len(steps) and all(r.parent == dykstra.id for r in reads)


def test_mesh_shards_are_children_of_the_call(tmg, monkeypatch):
    both = threading.Barrier(2, timeout=30)
    draw = bootstrap_core.bootstrap_distances

    def together(*args, **kwargs):
        both.wait()  # each device's first shard waits for the other's: two threads
        return draw(*args, **kwargs)

    monkeypatch.setattr(bootstrap_core, "bootstrap_distances", together)
    m = mesh.make_mesh(devices=(torch.device("cpu", 0), torch.device("cpu", 1)) * 2)
    est, povm, n_meas = (torch.as_tensor(x, dtype=torch.float32) for x in (
        tmg.reconstructed_state.bloch, tmg.povm_matrix, tmg.n_measurements))
    with profile(all_threads=True) as prof:  # as the benchmark's traced run profiles
        mesh.sharded_bootstrap_distances(m, 5, est, povm, n_meas, n_points=8)
    spans = profiling.recorded()
    annotated = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert annotated == {"qt.mesh.shard"}  # the one program span with a device range
    (root,) = [s for s in spans if s.parent is None]
    shards = [s for s in spans if s.name == "qt.mesh.shard"]
    assert root.name == "qt.mesh.call" and root.thread == threading.get_ident()
    assert len(shards) == 4 and all(s.parent == root.id for s in shards)
    assert len({s.thread for s in shards}) == 2 and root.thread not in {s.thread for s in shards}
    assert sorted(s.device.index for s in shards) == [0, 0, 1, 1]
    assert {s.name for s in spans if s.parent == root.id} == {
        "qt.mesh.setup", "qt.mesh.shard", "qt.mesh.gather"}
    assert all(s.root == root.id for s in spans)


def test_a_new_session_drops_the_last_ones_spans(tmg):
    with profile():
        lin_call(tmg)
    first = {s.id for s in profiling.recorded()}
    with profile():
        lin_call(tmg, key=4)
    second = profiling.recorded()
    assert len(second) == len(first) and not first & {s.id for s in second}
    assert len([s for s in second if s.parent is None]) == 1


def test_stage_timer_stages_are_spans():
    t = StageTimer()
    with profile():
        with t.stage("simulate"):
            with profiling.span("qt.sample"):
                pass
    spans = {s.name: s for s in profiling.recorded()}
    assert set(spans) == {"simulate", "qt.sample"}
    assert spans["qt.sample"].parent == spans["simulate"].id
    assert spans["simulate"].device == torch.device("cpu")
