"""Confidence intervals for state and process tomography (port of the
bootstrap part of quantpy_tpu/tomography/interval.py).

Every interval is a functor: `interval(conf_levels) -> (distances, levels)`
after a lazily invoked `setup()`. Ported: the base class and the parametric
bootstraps of states and of channels; the moment, polytope, MHMC and Holder
families are not ported yet (ROADMAP queue A).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum, auto

import numpy as np
import torch

from ..ops.geometry import hs_dst, if_dst, trace_dst
from ..ops.paulis import np_bloch_to_matrix
from ..qobj import Qobj
from . import bootstrap_core, kron_core, process_core, state_core
from .state import make_generator

__all__ = [
    "ConfidenceInterval",
    "BootstrapStateInterval",
    "BootstrapProcessInterval",
    "Mode",
]

_DST_NAMES = {hs_dst: "hs", trace_dst: "trace", if_dst: "if"}


class Mode(Enum):
    STATE = auto()
    CHANNEL = auto()


def _interp1d(x, y):
    """Monotone linear interpolant that clamps at the range ends."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    order = np.argsort(x)
    xs, ys = x[order], y[order]

    def f(q):
        return np.interp(np.asarray(q, dtype=np.float64), xs, ys)

    return f


def _require_uniform_kron_shots(tmg, what: str):
    """The kron-factored paths weight every POVM by 1/m, which holds only
    for uniform shots. Counts injected through the `results` setter make
    n_measurements the row sums, which may differ: reject those."""
    n = np.asarray(tmg.n_measurements, dtype=np.float64)
    if n.ndim and not np.allclose(n, n.flat[0]):
        raise NotImplementedError(
            f"{what} on the kron-factored path assumes uniform per-POVM "
            "shot counts; non-uniform injected results need a dense design"
        )


class ConfidenceInterval(ABC):
    """Functor base: detects STATE/CHANNEL mode from the tomograph and maps
    confidence levels to distances."""

    EPS = 1e-15

    def __init__(self, tmg, **kwargs):
        self.tmg = tmg
        if hasattr(tmg, "state"):
            self.mode = Mode.STATE
        elif hasattr(tmg, "channel"):
            self.mode = Mode.CHANNEL
        else:
            raise ValueError("Tomograph must expose `state` or `channel`")
        for name, value in kwargs.items():
            setattr(self, name, value)

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "cl_to_dist"):
            self.setup()
        return self.cl_to_dist(conf_levels), conf_levels

    @abstractmethod
    def setup(self):
        """Compute the confidence-level -> distance map."""


class BootstrapStateInterval(ConfidenceInterval):
    """Empirical CDF of the distances of re-simulated, re-estimated
    experiments to the estimate, all resamples in one batched call.

    `key` is an int seed or a torch.Generator on the tomograph's device
    (default: seed 17). After `setup`, `distances` holds the sorted
    distances.
    """

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        tol: float = 1e-3,
        max_iter: int = 100,
        state=None,
        key=None,
    ):
        super().__init__(
            tmg, n_points=n_points, method=method, physical=physical,
            init=init, tol=tol, max_iter=max_iter, state=state, key=key,
        )

    def setup(self):
        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("This interval works only for state tomography")
        if self.state is None:
            if hasattr(self.tmg, "reconstructed_state"):
                self.state = self.tmg.reconstructed_state
            else:
                self.state = self.tmg.point_estimate(
                    method=self.method, physical=self.physical,
                    init=self.init, tol=self.tol, max_iter=self.max_iter,
                )
        dst_name = _DST_NAMES.get(self.tmg.dst)
        device, dtype = self.tmg.device, self.tmg.dtype
        generator = make_generator(17 if self.key is None else self.key, device)
        bloch_est = torch.as_tensor(self.state.bloch, dtype=dtype, device=device)
        if self.tmg.kron_mode:
            if dst_name is None:
                raise NotImplementedError(
                    "custom distance callables are not supported on the "
                    "kron-factored bootstrap path (hs/trace/if only)"
                )
            _require_uniform_kron_shots(self.tmg, "BootstrapStateInterval")
            dist = kron_core.kron_bootstrap_distances(
                generator, bloch_est,
                torch.as_tensor(self.tmg.povm_kron, dtype=dtype, device=device),
                self.tmg.state.n_qubits, float(self.tmg.n_measurements[0]),
                n_points=self.n_points, method=self.method, dst=dst_name,
                max_iter=self.max_iter, physical=self.physical, init=self.init,
            )
            dist = dist.cpu().numpy().astype(np.float64)
        else:
            dist = self._dense_distances(generator, bloch_est, dst_name)
        self.distances = np.sort(dist)
        self.cl_to_dist = _interp1d(
            np.linspace(0, 1, len(self.distances)), self.distances
        )

    def _dense_distances(self, generator, bloch_est, dst_name):
        """The bootstrap distances on the materialized design, as float64
        numpy; a custom distance runs on the host."""
        device, dtype = self.tmg.device, self.tmg.dtype
        args = (
            generator,
            bloch_est,
            torch.as_tensor(self.tmg.povm_matrix, dtype=dtype, device=device),
            torch.as_tensor(self.tmg.n_measurements, dtype=dtype, device=device),
        )
        options = dict(
            n_points=self.n_points, method=self.method, max_iter=self.max_iter,
            physical=self.physical, init=self.init, tol=self.tol,
        )
        if dst_name is not None:
            dist = bootstrap_core.bootstrap_distances(*args, dst=dst_name, **options)
            return dist.cpu().numpy().astype(np.float64)
        blochs = bootstrap_core.bootstrap_blochs(*args, **options)
        blochs = blochs.cpu().numpy().astype(np.float64)
        return np.asarray([self.tmg.dst(Qobj(b), self.state) for b in blochs])


class BootstrapProcessInterval(ConfidenceInterval):
    """Process bootstrap: simulate, re-estimate (lifp with the CPTP
    projection by default) and measure the Choi distance of every resample
    in one batch.

    From 4 qubits up the lifp re-estimation projects all resamples at once
    with the Newton-Schulz Dykstra engine (`cp_engine='ns'`, matrix
    products only) for a capped count of iterations: 50 up to 4 qubits, 100
    above. The resample distances lie far above the projection's residual
    at that depth, and the JAX package measured the distance quantiles
    equal to the full-tolerance eigh path's there. `cp_engine` forces the
    engine ('eigh' or 'ns'); `cptp_iter` caps the Dykstra iterations of the
    projection (default with 'eigh': 2000).

    The stop criteria of the iterative estimators are maxima over the whole
    batch of resamples, which is re-estimated at once.

    `key` is an int seed or a torch.Generator on the tomograph's device
    (default: seed 19). After `setup`, `distances` holds the sorted
    distances.
    """

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        method: str = "lifp",
        cptp: bool = True,
        tol: float = 1e-10,
        channel=None,
        states_est_method: str = "lin",
        states_physical: bool = True,
        states_init: str = "lin",
        key=None,
        cp_engine: str | None = None,
        cptp_iter: int | None = None,
    ):
        super().__init__(
            tmg, n_points=n_points, method=method, cptp=cptp, tol=tol,
            channel=channel, states_est_method=states_est_method,
            states_physical=states_physical, states_init=states_init, key=key,
            cp_engine=cp_engine, cptp_iter=cptp_iter,
        )

    def _center(self):
        """The channel the resamples are drawn from and measured against:
        the one given, else the tomograph's estimate."""
        if self.mode == Mode.STATE:
            raise NotImplementedError("This interval works only for process tomography")
        if self.channel is None:
            if hasattr(self.tmg, "reconstructed_channel"):
                self.channel = self.tmg.reconstructed_channel
            else:
                self.channel = self.tmg.point_estimate(
                    method=self.method, cptp=self.cptp,
                    states_est_method=self.states_est_method,
                    states_physical=self.states_physical,
                    states_init=self.states_init,
                )
        return self.channel

    def setup(self):
        self._center()
        generator = make_generator(19 if self.key is None else self.key, self.tmg.device)
        self.distances = np.sort(self.distances_of(self.simulate(generator)))
        self.cl_to_dist = _interp1d(
            np.linspace(0, 1, len(self.distances)), self.distances
        )

    def simulate(self, generator):
        """Counts (n_points, S, m, p) of `n_points` experiments on the
        bootstrap channel, as a tensor on the tomograph's device."""
        channel, tmg = self._center(), self.tmg
        out_blochs = np.stack(
            [channel.transform(s).bloch for s in tmg.input_basis.elements]
        )
        t0 = tmg.tomographs[0]
        out_blochs = tmg._tensor(out_blochs)
        return process_core.simulate_process_experiment(
            generator, tmg._tensor(t0.povm_matrix),
            out_blochs.expand((self.n_points,) + tuple(out_blochs.shape)),
            tmg._tensor(t0.n_measurements),
        )

    def estimate(self, counts):
        """Choi bloch vectors (B, 16^n) re-estimated from counts
        (B, S, m, p) by the interval's method."""
        tmg = self.tmg
        counts = tmg._tensor(counts)
        design = tmg._design()[1:]  # input blochs, POVM, shots
        n_ch = tmg.channel.n_qubits
        cp = self.cp_engine or ("ns" if n_ch >= 4 else "eigh")
        if self.method == "lifp":
            if cp != "ns":
                return process_core.estimate_lifp_factored(
                    counts, *design, cptp=self.cptp, cptp_iter=self.cptp_iter or 2000
                )
            raw = process_core.estimate_lifp_factored(counts, *design, cptp=False)
            if not self.cptp:
                return raw
            # the criterion is read every `it_chunk` iterations: the budget
            # of 12,800 iteration-resamples at dimension 256, scaled by the
            # cubed dimension ratio
            dim_factor = (2.0 ** (2 * n_ch) / 256.0) ** 3
            it_chunk = int(np.clip(12800.0 / (max(counts.shape[0], 1) * dim_factor), 1, 100))
            return process_core.cptp_project_bloch_host(
                raw, max_iter=self.cptp_iter or (50 if n_ch <= 4 else 100),
                chunk=it_chunk, cp="ns",
            )
        if self.method == "pgdb":
            return process_core.estimate_pgdb_factored(counts, *design)
        if self.method == "dys":
            return process_core.estimate_dys_factored(counts, *design)
        if self.method == "states":
            est_blochs = state_core.estimate(
                counts, design[1], design[2], method=self.states_est_method,
                physical=self.states_physical, init=self.states_init,
            )
            blochs = process_core.states_to_choi_bloch(
                est_blochs, tmg._decomposed_single_entries
            )
            # every resample is projected (projecting a CPTP point changes
            # it by no more than the tolerance)
            return process_core.cptp_project_bloch(blochs) if self.cptp else blochs
        raise ValueError("Incorrect value for argument `method`")

    def distances_of(self, counts):
        """Unsorted distances, as float64 numpy, of the re-estimates of
        `counts` (B, S, m, p) to the bootstrap channel; a custom distance
        runs on the host."""
        choi_blochs = self.estimate(counts)
        channel = self._center()
        n2 = 2 * self.tmg.channel.n_qubits
        dst_name = _DST_NAMES.get(self.tmg.dst)
        if dst_name is not None:
            dist = bootstrap_core._distance_batch(
                dst_name, choi_blochs, self.tmg._tensor(channel.choi.bloch), n2
            )
            return dist.cpu().numpy().astype(np.float64)
        mats = np_bloch_to_matrix(choi_blochs.cpu().numpy().astype(np.float64), n2)
        return np.asarray([self.tmg.dst(Qobj(m), channel.choi) for m in mats])
