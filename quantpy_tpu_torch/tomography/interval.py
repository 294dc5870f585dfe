"""Confidence intervals for state tomography (port of the bootstrap part of
quantpy_tpu/tomography/interval.py).

Every interval is a functor: `interval(conf_levels) -> (distances, levels)`
after a lazily invoked `setup()`. This slice ports the base class and the
parametric bootstrap; the moment, polytope, MHMC and Holder families wait
for later slices (ROADMAP queue A).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from enum import Enum, auto

import numpy as np
import torch

from ..ops.geometry import hs_dst, if_dst, trace_dst
from ..qobj import Qobj
from . import bootstrap_core, kron_core
from .state import make_generator

__all__ = ["ConfidenceInterval", "BootstrapStateInterval", "Mode"]


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
        dst_name = {hs_dst: "hs", trace_dst: "trace", if_dst: "if"}.get(self.tmg.dst)
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
