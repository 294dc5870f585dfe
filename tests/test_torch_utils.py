"""The port's utilities (`quantpy_tpu_torch.utils`), its package exports and
the `geometry` alias.

`ChunkedAccumulator` files are exchanged with the JAX package's in both
directions; `resumable_bootstrap` is held to the cases of
tests/test_utils_and_api.py (a resumed run equals an uninterrupted one
exactly, on the same device; a partial chunk never repeats a stream).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import quantpy_tpu as qt  # noqa: E402
from quantpy_tpu import utils as jutils  # noqa: E402

import quantpy_tpu_torch as qtt  # noqa: E402
from quantpy_tpu_torch import config, utils  # noqa: E402
from quantpy_tpu_torch.utils import ChunkedAccumulator, StageTimer, resumable_bootstrap  # noqa: E402

from ._torch_cpu import cpu_one_thread, on_cpu  # noqa: E402, F401


def test_cpu_files_run_each_test_on_the_cpu_and_one_thread():
    """`on_cpu`, the autouse fixture of the port's CPU test files
    (tests/_torch_cpu.py), holds this test on the CPU and one torch thread;
    its `cpu_one_thread` restores whatever it found."""
    assert config.get_device() == torch.device("cpu")
    assert torch.get_num_threads() == 1
    config.set_device("cuda")  # only recorded: no CUDA call is made
    torch.set_num_threads(3)
    try:
        with cpu_one_thread():
            assert config.get_device() == torch.device("cpu")
            assert torch.get_num_threads() == 1
        assert config.get_device() == torch.device("cuda")
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(1)
        config.set_device("cpu")


def test_stage_timer(capsys):
    t = StageTimer()
    assert t.device.type == "cpu"  # the package default, set by `on_cpu`
    with t.stage("a"):
        sum(range(1000))
    with t.stage("b"):
        pass
    with t.stage("a"):
        pass
    report = t.report()
    assert set(report) == {"a", "b"}
    assert all(v >= 0 for v in report.values())
    lines = [json.loads(x) for x in capsys.readouterr().err.splitlines()]
    assert {x["name"] for x in lines} == {"a", "b"}
    assert all(x["event"] == "stage" for x in lines)


def test_stage_timer_on_cuda_syncs_the_card(monkeypatch):
    """A `cuda` timer synchronizes that device around every stage (counted
    here through a stand-in, as the CPU host has no card)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    t = StageTimer(device="cuda")
    with t.stage("x"):
        pass
    assert calls == [torch.device("cuda")] * 2
    with StageTimer(device="cuda", sync=False).stage("y"):
        pass
    assert len(calls) == 2


def test_log_is_one_json_line(capsys):
    utils.log("event-name", a=1, b="x")
    assert json.loads(capsys.readouterr().err) == {"event": "event-name", "a": 1, "b": "x"}


def test_chunked_accumulator_roundtrip(tmp_path):
    path = str(tmp_path / "acc.npz")
    acc = ChunkedAccumulator(path)
    acc.append(np.arange(5.0))
    acc.append(np.arange(5.0, 8.0))
    acc2 = ChunkedAccumulator(path)
    assert acc2.n_done == 8 and acc2.n_chunks == 2
    np.testing.assert_allclose(acc2.samples, np.arange(8.0))
    assert [p.name for p in tmp_path.iterdir()] == ["acc.npz"]  # no temporary left


@pytest.mark.parametrize("writer, reader", [
    (jutils.ChunkedAccumulator, ChunkedAccumulator),
    (ChunkedAccumulator, jutils.ChunkedAccumulator),
])
def test_chunked_accumulator_files_cross_packages(tmp_path, writer, reader):
    path = str(tmp_path / "acc.npz")
    acc = writer(path)
    acc.append(np.arange(4.0))
    acc.append(np.arange(4.0, 6.0))
    resumed = reader(path)
    assert (resumed.n_done, resumed.n_chunks) == (6, 2)
    resumed.append(np.arange(6.0, 7.0))
    back = writer(path)
    assert (back.n_done, back.n_chunks) == (7, 3)
    np.testing.assert_array_equal(back.samples, np.arange(7.0))


def test_chunked_accumulator_legacy_file(tmp_path):
    """A file without `n_chunks` counts one chunk per sample, as in the
    JAX package."""
    path = str(tmp_path / "old.npz")
    np.savez(path, samples=np.arange(3.0))
    assert ChunkedAccumulator(path).n_chunks == jutils.ChunkedAccumulator(path).n_chunks == 3


@pytest.fixture
def tmg():
    t = qtt.StateTomograph(qtt.GHZ(1), key=9)
    t.experiment(1000, "proj-set")
    t.point_estimate("lin")
    return t


@pytest.mark.parametrize("method", ["lin", "mle-rhor"])
def test_resumable_bootstrap_matches_uninterrupted(tmp_path, tmg, method):
    full = resumable_bootstrap(
        str(tmp_path / "a.npz"), tmg, n_points=48, chunk_size=16, method=method, seed=3
    )
    # interrupted run: 2 chunks into file b, then resume
    resumable_bootstrap(
        str(tmp_path / "b.npz"), tmg, n_points=32, chunk_size=16, method=method, seed=3
    )
    resumed = resumable_bootstrap(
        str(tmp_path / "b.npz"), tmg, n_points=48, chunk_size=16, method=method, seed=3
    )
    np.testing.assert_array_equal(resumed, full)
    assert full.shape == (48,) and np.all(np.diff(full) >= 0) and np.all(np.isfinite(full))
    other = resumable_bootstrap(
        str(tmp_path / "c.npz"), tmg, n_points=48, chunk_size=16, method=method, seed=4
    )
    assert not np.array_equal(other, full)


def test_resumable_bootstrap_partial_chunk_no_duplicates(tmp_path, tmg):
    """A run interrupted mid-chunk must not replay a chunk's stream on
    resume."""
    path = str(tmp_path / "c.npz")
    # 10 points with chunk_size 8 -> chunks of 8 and 2 (partial final chunk)
    resumable_bootstrap(path, tmg, n_points=10, chunk_size=8, seed=3)
    assert ChunkedAccumulator(path).n_chunks == 2
    # extend to 18: chunk 2 draws a fresh stream, not chunk 1's again
    resumed = resumable_bootstrap(path, tmg, n_points=18, chunk_size=8, seed=3)
    assert len(np.unique(np.round(resumed, 12))) == 18
    assert ChunkedAccumulator(path).n_chunks == 3


def test_resumable_bootstrap_distances_match_the_interval(tmp_path, tmg):
    """One chunk is one `bootstrap_distances` call: the same distribution
    as `BootstrapStateInterval` (medians within 25% at 512 resamples)."""
    d = resumable_bootstrap(str(tmp_path / "d.npz"), tmg, n_points=512, chunk_size=256)
    iv = qtt.BootstrapStateInterval(tmg, n_points=512)
    iv.setup()
    assert abs(np.median(d) / np.median(iv.distances) - 1) < 0.25


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with utils.trace(str(tmp_path)):
        torch.ones(64).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::sum" in str(e.get("name")) for e in events)


def test_package_exports_match_the_jax_package():
    """Every name of `quantpy_tpu.__all__` is exported by the port, modules
    as the port's own modules; the mesh layer, `parallel`, is a subpackage
    of both with the same names."""
    import quantpy_tpu.parallel
    import quantpy_tpu_torch.parallel

    missing = [name for name in qt.__all__ if name not in qtt.__all__ or not hasattr(qtt, name)]
    assert not missing
    assert sorted(quantpy_tpu_torch.parallel.__all__) == sorted(quantpy_tpu.parallel.__all__)
    for name in ("geometry", "measurements", "ops", "basis", "stats", "mhmc"):
        assert getattr(qtt, name).__name__ == f"quantpy_tpu_torch.{name}"


def test_geometry_alias():
    from quantpy_tpu_torch import geometry
    from quantpy_tpu_torch.ops import geometry as ops_geometry

    assert set(geometry.__all__) == set(qt.geometry.__all__)
    for name in geometry.__all__ + ["DISTANCES", "resolve_distance"]:
        assert getattr(geometry, name) is getattr(ops_geometry, name)
    a, b = qtt.GHZ(2), qtt.fully_mixed(2)
    assert abs(geometry.hs_dst(a, b) - float(qt.geometry.hs_dst(qt.GHZ(2), qt.fully_mixed(2)))) < 1e-12
