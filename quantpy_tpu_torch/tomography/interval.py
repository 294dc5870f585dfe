"""Confidence intervals for state and process tomography (port of
quantpy_tpu/tomography/interval.py).

Every interval is a functor: `interval(conf_levels) -> (distances, levels)`
after a lazily invoked `setup()`. Ported:

- MomentInterval and MomentFidelityState/ProcessInterval: the exact
  multinomial moments of the L2 error (float64 on the tomograph's device),
  fidelity bands in closed form over the sliced ball;
- SugiyamaInterval: Hoeffding's bound (arXiv:1306.4191);
- PolytopeState/ProcessInterval: confidence polytopes (arXiv:2109.04734),
  batched PDHG linear programs in the tomograph's dtype on its device;
- BootstrapState/ProcessInterval: parametric bootstraps, all resamples in
  one batched call;
- MHMCState/ProcessInterval: likelihood sampling with the device chains of
  `mhmc` (Cholesky, projected-bloch and kraus-factor parametrizations);
- HolderInterval: a process bound composed from per-input-state intervals.
"""

from __future__ import annotations

import functools
from abc import ABC, abstractmethod
from enum import Enum, auto

import numpy as np
import scipy.stats as sts
import torch

from ..convex import (
    linear_bounds_on_ball_slice,
    solve_lp_batch,
    solve_lp_batch_factors,
    solve_lp_batch_kron,
)
from ..mhmc import (
    MHMC,
    autograd_drift,
    basic_update,
    effective_sample_size,
    maximize_logpdf,
    normalized_update,
    split_rhat,
)
from ..ops.cholesky import np_matrix_to_real_tril_vec, np_real_tril_vec_to_matrix
from ..ops.geometry import hs_dst, if_dst, trace_dst
from ..ops.paulis import np_bloch_to_matrix
from ..qobj import Qobj
from ..routines import _left_inv as _left_inv_np
from ..stats import l2_moments_from_factor
from ..utils import profiling
from . import bootstrap_core, kron_analytic, kron_core, process_core, state_core
from .polytopes.utils import count_confidence, count_delta
from .state import make_generator

__all__ = [
    "ConfidenceInterval",
    "MomentInterval",
    "MomentFidelityStateInterval",
    "MomentFidelityProcessInterval",
    "SugiyamaInterval",
    "PolytopeStateInterval",
    "PolytopeProcessInterval",
    "BootstrapStateInterval",
    "BootstrapProcessInterval",
    "MHMCStateInterval",
    "MHMCProcessInterval",
    "HolderInterval",
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


def _readback(dist):
    """Distances on the device as float64 numpy: the host waits for the
    card here."""
    with profiling.span("qt.interval.readback"):
        profiling.count("host_sync")
        return dist.cpu().numpy().astype(np.float64)


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


# --------------------------------------------------------------------------
# Moment-based intervals
# --------------------------------------------------------------------------


#: above this many (states x Mp-block) elements the channel moment path
#: switches to the fully factored exact-mean + Hutchinson-variance recipe
#: (5 qubits = 2^30 stays exact; 6 qubits = 2^36 would need ~26 PFLOP and
#: ~275 GB on the exact Gram)
_CHANNEL_EXACT_GRAM_MAX = 1 << 32


class MomentInterval(ConfidenceInterval):
    """CI from the exact multinomial moments of the weighted L2 error,
    fitted by a 'gamma', 'norm' or 'exp' distribution; hs and trace
    distances. The moments are float64 on the tomograph's device; after
    `setup`, `mean` and `variance` hold them."""

    def __init__(self, tmg, distr_type: str = "gamma"):
        super().__init__(tmg, distr_type=distr_type)

    def setup(self):
        device = self.tmg.device
        if self.mode == Mode.STATE:
            dim = 2**self.tmg.state.n_qubits
            n_measurements = self.tmg.n_measurements
            freq = self.tmg.results / n_measurements[:, None]
            if self.tmg.povm_matrix is None:
                if getattr(self.tmg, "povm_kron", None) is None:
                    raise NotImplementedError(
                        "moment intervals need a measurement design; run "
                        "`experiment` or set `results` first"
                    )
                # kron-factored design: exact factored moments, no POVM,
                # pseudo-inverse or weights tensor
                _require_uniform_kron_shots(self.tmg, "MomentInterval")
                mean, variance = kron_analytic.kron_l2_moments(
                    self.tmg.povm_kron, self.tmg.state.n_qubits, freq, n_measurements[0],
                    device=device,
                )
            else:
                # `_design_inv` lets a caller that builds many intervals on
                # one design (HolderInterval: one per input state) share one
                # pseudo-inverse on the device
                inv = getattr(self, "_design_inv", None)
                if inv is None:
                    inv = _design_inverse(self.tmg)
                inv = inv.reshape(-1, freq.shape[0], freq.shape[1])
                mean, variance = l2_moments_from_factor(inv, freq, n_measurements[0])
        else:
            n_ch = self.tmg.channel.n_qubits
            dim = 4**n_ch
            t0 = self.tmg.tomographs[0]
            n_measurements = t0.n_measurements
            # the process design is kron(states_matrix, povm_flat); the
            # factored moments never build it or its (S K, 16^n)
            # pseudo-inverse
            freq3 = np.stack(
                [t.results / t.n_measurements[:, None] for t in self.tmg.tomographs]
            )
            if freq3.shape[0] * dim * dim > _CHANNEL_EXACT_GRAM_MAX:
                # 6+ qubits: even the per-state moment blocks are (4^n)^2;
                # the fully factored path needs the single-qubit design
                # factors
                states1_t = getattr(self.tmg, "_states1_t", None)
                povm1 = getattr(self.tmg, "_povm1", None)
                if states1_t is None or povm1 is None:
                    raise NotImplementedError(
                        "channel moment intervals at this size need a "
                        "tensor-power design (preset input states and a "
                        "single-qubit POVM block)"
                    )
                mean, variance = kron_analytic.channel_l2_moments_kron(
                    states1_t, povm1, n_ch, freq3, n_measurements[0], device=device
                )
            else:
                mean, variance = kron_analytic.channel_l2_moments(
                    self.tmg._input_blochs_t(), t0.povm_matrix, freq3, n_measurements[0],
                    device=device,
                )
        self.mean, self.variance = mean, variance
        if self.distr_type == "norm":
            distr = sts.norm(loc=mean, scale=np.sqrt(variance))
        elif self.distr_type == "gamma":
            scale = variance / mean
            distr = sts.gamma(a=mean / scale, scale=scale)
        elif self.distr_type == "exp":
            distr = sts.expon(scale=mean)
        else:
            raise NotImplementedError(f"Unsupported distribution type {self.distr_type}")
        if self.tmg.dst is hs_dst:
            alpha = np.sqrt(dim / 2)
        elif self.tmg.dst is trace_dst:
            alpha = dim / 2
        else:
            raise NotImplementedError("MomentInterval supports hs/trace distances")
        self.cl_to_dist = lambda cl: np.sqrt(distr.ppf(cl)) * alpha


def _design_inverse(tmg):
    """The dense design's pseudo-inverse / 2^n, (D, m p), as a float64
    tensor on the tomograph's device (the factor of MomentInterval)."""
    povm_flat = tmg.povm_matrix.reshape(-1, tmg.povm_matrix.shape[-1])
    inv = _left_inv_np(povm_flat) / 2**tmg.state.n_qubits
    return torch.as_tensor(inv, dtype=torch.float64, device=tmg.device)


class _MomentFidelityBase(MomentInterval):
    """Shared fidelity-band logic: for each confidence radius, bound
    <target, x> over the ball of bloch vectors around the point estimate,
    intersected with the trace/TP affine slice, in closed form."""

    #: confidence-level grid of the bands
    _GRID = np.concatenate(
        (np.arange(1e-7, 0.8, 0.01), np.linspace(0.8, 1 - 1e-7, 200))
    )

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "cl_to_dist_max"):
            self.setup()
        return (
            (self.cl_to_dist_min(conf_levels), self.cl_to_dist_max(conf_levels)),
            conf_levels,
        )

    def _setup_bands(self, c, center, alpha, fixed_idx, fixed_vals, scale):
        dist_list = self.cl_to_dist(self._GRID)
        mins, maxs = linear_bounds_on_ball_slice(
            c, center, dist_list * alpha, fixed_idx, fixed_vals
        )
        # an infeasible slice reports 1, as the reference's degenerate solves
        mins = np.where(np.isnan(mins), 1.0, mins * scale)
        maxs = np.where(np.isnan(maxs), 1.0, maxs * scale)
        self.cl_to_dist_min = _interp1d(self._GRID, mins)
        self.cl_to_dist_max = _interp1d(self._GRID, maxs)


class MomentFidelityStateInterval(_MomentFidelityBase):
    """Fidelity band with respect to a target state (default: the
    unprojected linear-inversion estimate)."""

    def __init__(self, tmg, distr_type: str = "gamma", target_state=None):
        self.target_state = target_state
        super().__init__(tmg, distr_type=distr_type)

    def setup(self):
        MomentInterval.setup(self)
        if not hasattr(self.tmg, "reconstructed_state"):
            self.tmg.point_estimate(physical=False)
        if self.target_state is None:
            self.target_state = self.tmg.reconstructed_state
        dim = 2**self.tmg.state.n_qubits
        self._setup_bands(
            c=self.target_state.bloch,
            center=self.tmg.reconstructed_state.bloch,
            alpha=np.sqrt(2 / dim),
            fixed_idx=np.array([0]),
            fixed_vals=np.array([1 / dim]),
            scale=dim,
        )


class MomentFidelityProcessInterval(_MomentFidelityBase):
    """Fidelity band with respect to a target process (default: the
    linear-inversion estimate without the CPTP projection)."""

    def __init__(self, tmg, distr_type: str = "gamma", target_process=None):
        self.target_process = target_process
        super().__init__(tmg, distr_type=distr_type)

    def setup(self):
        MomentInterval.setup(self)
        if not hasattr(self.tmg, "reconstructed_channel"):
            self.tmg.point_estimate(cptp=False)
        if self.target_process is None:
            self.target_process = self.tmg.reconstructed_channel
        dim_in = dim_out = 2**self.tmg.channel.n_qubits
        dim = dim_in * dim_out
        trivial = np.arange(0, dim**2, dim_out**2)
        fixed_vals = np.zeros(trivial.shape[0])
        fixed_vals[0] = 1 / dim_in
        self._setup_bands(
            c=self.target_process.choi.bloch,
            center=self.tmg.reconstructed_channel.choi.bloch,
            alpha=np.sqrt(2 / dim),
            fixed_idx=trivial,
            fixed_vals=fixed_vals,
            scale=1.0,
        )


# --------------------------------------------------------------------------
# Sugiyama (Hoeffding) interval
# --------------------------------------------------------------------------


class SugiyamaInterval(ConfidenceInterval):
    """Non-asymptotic CI from Hoeffding's inequality, arXiv:1306.4191.
    State tomography only."""

    def __init__(self, tmg, n_points: int = 1000, max_confidence: float = 0.999):
        super().__init__(tmg, n_points=n_points, max_confidence=max_confidence)

    def setup(self):
        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("Sugiyama interval works only for state tomography")
        dim = 2**self.tmg.state.n_qubits
        dist = np.linspace(0, 1, self.n_points)
        if self.tmg.povm_matrix is None:
            if getattr(self.tmg, "povm_kron", None) is None:
                raise NotImplementedError(
                    "Sugiyama intervals need a measurement design; run "
                    "`experiment` or set `results` first"
                )
            # kron-factored design: exact c_alpha from the per-qubit
            # interval-arithmetic fold (uniform shots: constant ratio m)
            _require_uniform_kron_shots(self.tmg, "SugiyamaInterval")
            m = self.tmg.n_measurements.shape[0]
            c_alpha = (
                kron_analytic.kron_sugiyama_c_alpha(
                    self.tmg.povm_kron, self.tmg.state.n_qubits, device=self.tmg.device
                )
                * m
                + self.EPS
            )
        else:
            # the pseudo-inverse of the design scaled by dim / sqrt(2 dim) is
            # MomentInterval's factor times sqrt(2 dim); `_design_inv` shares
            # it as there
            m, p, _ = self.tmg.povm_matrix.shape
            inv = getattr(self, "_design_inv", None)
            if inv is None:
                inv = _design_inverse(self.tmg)
            inv = (inv * np.sqrt(2 * dim)).reshape(-1, m, p)
            ratios = self.tmg.n_measurements.sum() / self.tmg.n_measurements
            weights = torch.as_tensor(ratios, dtype=inv.dtype, device=inv.device)
            c_alpha = ((inv.amax(-1) - inv.amin(-1)) ** 2 @ weights).cpu().numpy() + self.EPS
        if self.tmg.dst is hs_dst:
            b = 8 / (dim**2 - 1)
        elif self.tmg.dst is trace_dst:
            b = 16 / (dim**2 - 1) / dim
        elif self.tmg.dst is if_dst:
            b = 4 / (dim**2 - 1) / dim
        else:
            raise NotImplementedError("Unsupported distance")
        conf_levels = 1 - 2 * np.sum(
            np.exp(-b * dist[:, None] ** 2 * self.tmg.n_measurements.sum() / c_alpha[None]),
            axis=1,
        )
        self.cl_to_dist = _interp1d(conf_levels, dist)


# --------------------------------------------------------------------------
# Confidence polytopes (arXiv:2109.04734)
# --------------------------------------------------------------------------


class _PolytopeBase(ConfidenceInterval):
    LP_ITERS = 20000
    #: dense constraint-matrix element budget; beyond it the process LP
    #: runs on the two-factor matvec path (solve_lp_batch_factors)
    DENSE_LP_MAX_ELEMENTS = 2**25

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "cl_to_dist_max"):
            self.setup()
        return (
            (self.cl_to_dist_min(conf_levels), self.cl_to_dist_max(conf_levels)),
            conf_levels,
        )

    def _deltas(self, freq, n_measurements):
        """The margins of the polytopes (n_points,) from the confidence 0
        to 1 - 1e-7, in the tomograph's dtype on its device."""
        freq, n = self.tmg._tensor(freq), self.tmg._tensor(n_measurements)
        lo_hi = count_delta(np.array([0.0, 1 - 1e-7]), freq, n).tolist()
        deltas = np.linspace(lo_hi[0], lo_hi[1], self.n_points)
        conf = count_confidence(deltas, freq, n).cpu().numpy().astype(np.float64)
        return deltas, conf

    def _solve_with(self, solver, c, lo_affine, scale):
        """Min/max of <c, x> through a one-sided LP `solver`, mapping
        degenerate solves to 1. Keeps the PDHG iteration counts as
        `lp_iterations` (min-solve, max-solve)."""
        _, obj_min, viol_min, it_min = solver(c)
        _, obj_max_neg, viol_max, it_max = solver(-np.asarray(c))
        self.lp_iterations = (int(it_min), int(it_max))
        obj_min, obj_max_neg, viol_min, viol_max = (
            torch.stack([obj_min, obj_max_neg, viol_min, viol_max])
            .cpu().numpy().astype(np.float64)
        )
        bad = (viol_min > 1e-3) | (viol_max > 1e-3)
        dist_min = np.where(bad, 1.0, lo_affine + obj_min * scale)
        dist_max = np.where(bad, 1.0, lo_affine - obj_max_neg * scale)
        return dist_min, dist_max


class PolytopeStateInterval(_PolytopeBase):
    """Fidelity bounds from confidence polytopes, dense or kron-factored."""

    def __init__(self, tmg, n_points: int = 1000, target_state=None):
        super().__init__(tmg, n_points=n_points, target_state=target_state)

    def setup(self):
        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("This interval works only for state tomography")
        tmg = self.tmg
        kron_mode = tmg.povm_matrix is None
        if kron_mode and getattr(tmg, "povm_kron", None) is None:
            raise NotImplementedError(
                "polytope intervals need a measurement design (dense or "
                "kron-factored); run experiment() or set results first"
            )
        if self.target_state is None:
            self.target_state = tmg.state
        n = tmg.state.n_qubits
        dim = 2**n
        c = np.asarray(self.target_state.bloch[1:], dtype=np.float64)
        freq = np.clip(tmg.results / tmg.n_measurements[:, None], self.EPS, 1 - self.EPS)
        if kron_mode:
            # uniform shots: the weighted row scaling is the identity
            # (n_m / sum * m == 1), and the factored LP applies
            # 2^n * rows[:, 1:] as the forward/adjoint chains
            _require_uniform_kron_shots(tmg, "PolytopeStateInterval")
            row0 = kron_core.kron_row_component(tmg.povm_kron, n)
        else:
            m = tmg.povm_matrix.shape[0]
            povm_flat = (
                tmg.povm_matrix * tmg.n_measurements[:, None, None] / tmg.n_measurements.sum()
            ).reshape(-1, tmg.povm_matrix.shape[-1]) * m
            a_matrix = povm_flat[:, 1:] * dim
            row0 = povm_flat[:, 0]
        deltas, conf = self._deltas(freq, tmg.n_measurements)
        b_batch = tmg._tensor(
            np.clip(freq.reshape(-1)[None, :] + deltas[:, None], self.EPS, 1 - self.EPS)
            - row0[None, :]
        )
        if kron_mode:
            def solver(cc):
                return solve_lp_batch_kron(cc, tmg.povm_kron, n, b_batch, self.LP_ITERS)
        else:
            def solver(cc):
                return solve_lp_batch(cc, a_matrix, b_batch, self.LP_ITERS)
        dist_min, dist_max = self._solve_with(solver, c, 1 / dim, dim)
        self.cl_to_dist_min = _interp1d(conf, dist_min)
        self.cl_to_dist_max = _interp1d(conf, dist_max)


class PolytopeProcessInterval(_PolytopeBase):
    """Process fidelity bounds from confidence polytopes: a dense LP up to
    `DENSE_LP_MAX_ELEMENTS`, the two-factor operator above."""

    def __init__(self, tmg, n_points: int = 1000, target_channel=None):
        super().__init__(tmg, n_points=n_points, target_channel=target_channel)

    def setup(self):
        tmg = self.tmg
        channel = tmg.channel
        dim_in = dim_out = 2**channel.n_qubits
        dim = dim_in * dim_out
        bloch_indices = [i for i in range(dim**2) if i % dim_out**2 != 0]
        if self.target_channel is None:
            self.target_channel = channel
        t0 = tmg.tomographs[0]
        povm_matrix, n_meas = t0.povm_matrix, t0.n_measurements
        freq = np.stack([
            np.clip(t.results / t.n_measurements[:, None], self.EPS, 1 - self.EPS)
            for t in tmg.tomographs
        ])
        m = povm_matrix.shape[0]
        meas_flat = (
            povm_matrix * n_meas[:, None, None] / n_meas.sum()
        ).reshape(-1, povm_matrix.shape[-1]) * m
        states_matrix = tmg._input_blochs_t()
        c = np.asarray(self.target_channel.choi.bloch, dtype=np.float64)[bloch_indices]
        deltas, conf = self._deltas(freq, n_meas)
        b_base = freq.reshape(-1) - np.tile(meas_flat[:, 0], states_matrix.shape[0])
        b_batch = b_base[None, :] + deltas[:, None]
        n_rows = states_matrix.shape[0] * meas_flat.shape[0]
        if n_rows * (dim**2 - dim) > self.DENSE_LP_MAX_ELEMENTS:
            # the constraint matrix is kron(states, weighted POVM rows);
            # dense at 4 qubits it would be 86 GB: apply it as the
            # two-factor operator instead
            b3 = tmg._tensor(
                b_batch.reshape(len(deltas), states_matrix.shape[0], meas_flat.shape[0]))
            right = meas_flat[:, 1:] * dim

            def solver(cc):
                return solve_lp_batch_factors(
                    np.asarray(cc).reshape(dim, dim - 1), states_matrix, right, b3,
                    self.LP_ITERS,
                )
        else:
            a_matrix = (
                np.einsum("ia,jb->ijab", states_matrix, meas_flat[:, 1:]) * dim
            ).reshape(n_rows, -1)
            b_t = tmg._tensor(b_batch)

            def solver(cc):
                return solve_lp_batch(cc, a_matrix, b_t, self.LP_ITERS)
        dist_min, dist_max = self._solve_with(solver, c, 1 / dim, 1.0)
        self.cl_to_dist_min = _interp1d(conf, dist_min)
        self.cl_to_dist_max = _interp1d(conf, dist_max)


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
        with profiling.span("qt.interval", self.tmg.device):
            dst_name = _DST_NAMES.get(self.tmg.dst)
            device, dtype = self.tmg.device, self.tmg.dtype
            with profiling.span("qt.interval.inputs"):
                if self.state is None:
                    if hasattr(self.tmg, "reconstructed_state"):
                        self.state = self.tmg.reconstructed_state
                    else:
                        self.state = self.tmg.point_estimate(
                            method=self.method, physical=self.physical,
                            init=self.init, tol=self.tol, max_iter=self.max_iter,
                        )
                generator = make_generator(17 if self.key is None else self.key, device)
                bloch_est = profiling.to_device(self.state.bloch, dtype, device)
            if self.tmg.kron_mode:
                if dst_name is None:
                    raise NotImplementedError(
                        "custom distance callables are not supported on the "
                        "kron-factored bootstrap path (hs/trace/if only)"
                    )
                _require_uniform_kron_shots(self.tmg, "BootstrapStateInterval")
                with profiling.span("qt.interval.inputs"):
                    povm_kron = profiling.to_device(self.tmg.povm_kron, dtype, device)
                dist = _readback(kron_core.kron_bootstrap_distances(
                    generator, bloch_est, povm_kron,
                    self.tmg.state.n_qubits, float(self.tmg.n_measurements[0]),
                    n_points=self.n_points, method=self.method, dst=dst_name,
                    max_iter=self.max_iter, physical=self.physical, init=self.init,
                ))
            else:
                dist = self._dense_distances(generator, bloch_est, dst_name)
            with profiling.span("qt.interval.sort"):
                self.distances = np.sort(dist)
                self.cl_to_dist = _interp1d(
                    np.linspace(0, 1, len(self.distances)), self.distances
                )

    def _dense_distances(self, generator, bloch_est, dst_name):
        """The bootstrap distances on the materialized design, as float64
        numpy; a custom distance runs on the host."""
        device, dtype = self.tmg.device, self.tmg.dtype
        with profiling.span("qt.interval.inputs"):
            args = (
                generator,
                bloch_est,
                profiling.to_device(self.tmg.povm_matrix, dtype, device),
                profiling.to_device(self.tmg.n_measurements, dtype, device),
            )
        options = dict(
            n_points=self.n_points, method=self.method, max_iter=self.max_iter,
            physical=self.physical, init=self.init, tol=self.tol,
        )
        if dst_name is not None:
            return _readback(bootstrap_core.bootstrap_distances(*args, dst=dst_name, **options))
        blochs = _readback(bootstrap_core.bootstrap_blochs(*args, **options))
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
        with profiling.span("qt.interval", self.tmg.device):
            with profiling.span("qt.interval.inputs"):
                self._center()
                generator = make_generator(19 if self.key is None else self.key, self.tmg.device)
            dist = self.distances_of(self.simulate(generator))
            with profiling.span("qt.interval.sort"):
                self.distances = np.sort(dist)
                self.cl_to_dist = _interp1d(
                    np.linspace(0, 1, len(self.distances)), self.distances
                )

    def simulate(self, generator):
        """Counts (n_points, S, m, p) of `n_points` experiments on the
        bootstrap channel, as a tensor on the tomograph's device."""
        channel, tmg = self._center(), self.tmg
        with profiling.span("qt.interval.inputs"):
            out_blochs = np.stack(
                [channel.transform(s).bloch for s in tmg.input_basis.elements]
            )
            t0 = tmg.tomographs[0]
            out_blochs = tmg._tensor(out_blochs)
            povm, n_meas = tmg._tensor(t0.povm_matrix), tmg._tensor(t0.n_measurements)
        return process_core.simulate_process_experiment(
            generator, povm, out_blochs.expand((self.n_points,) + tuple(out_blochs.shape)),
            n_meas,
        )

    def estimate(self, counts):
        """Choi bloch vectors (B, 16^n) re-estimated from counts
        (B, S, m, p) by the interval's method."""
        tmg = self.tmg
        with profiling.span("qt.interval.inputs"):
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
            with profiling.span("qt.interval.inputs"):
                center = self.tmg._tensor(channel.choi.bloch)
            return _readback(bootstrap_core._distance_batch(dst_name, choi_blochs, center, n2))
        mats = np_bloch_to_matrix(_readback(choi_blochs), n2)
        return np.asarray([self.tmg.dst(Qobj(m), channel.choi) for m in mats])


# --------------------------------------------------------------------------
# MHMC likelihood-sampling intervals
# --------------------------------------------------------------------------

#: split-R-hat above this triggers the non-convergence warning of the MHMC
#: intervals (the practical thresholds of Vehtari et al. are 1.01-1.1; 1.2
#: flags only decisively unmixed chains)
RHAT_WARN_THRESHOLD = 1.2

#: the CPTP projection inside a process proposal or target reads its stop
#: criterion every this many Dykstra iterations: at most 10 host reads per
#: 100-iteration projection, against 100 when it is read after every one. A
#: projection may run up to 9 iterations past the first one under its
#: tolerance, which only tightens it.
PROJECTION_READ_EVERY = 10


def _warn_if_nonconverged(interval_name: str, r_hat: float, ess: float):
    """Warn loudly when the chains have not mixed: the distances are then
    quantiles of a non-stationary sample, not a confidence interval. The
    4+ qubit process posterior is the known case (R-hat 1.9-3.5 in the JAX
    package's records)."""
    import warnings

    if np.isfinite(r_hat) and r_hat > RHAT_WARN_THRESHOLD:
        warnings.warn(
            f"{interval_name}: chains have NOT converged "
            f"(split R-hat {r_hat:.2f} > {RHAT_WARN_THRESHOLD}, "
            f"ESS {ess:.0f}); the returned distances are quantiles of a "
            "non-stationary sample and are not a valid confidence "
            "interval. Increase n_points/burn_steps, use "
            "parametrization='kraus' with proposal='mala' (<= 3 qubits), "
            "or prefer the bootstrap interval (the recommended 4+ qubit "
            "process CI).",
            RuntimeWarning,
            stacklevel=3,
        )


def _draw_chains(chain, n_points, n_chains, thinning, verbose):
    """(samples (n_chains * per_chain, dim), acceptance, (n_chains,
    per_chain)) of a sampler: `n_chains` chains side by side, or one."""
    if n_chains > 1:
        per_chain = -(-n_points // n_chains)
        samples, rate = chain.sample_chains(per_chain, n_chains, thinning)
        shape = samples.shape[:2]
        return samples.reshape(-1, samples.shape[-1]), rate, shape
    samples, rate = chain.sample(n_points, thinning, verbose=verbose)
    return samples, rate, (1, samples.shape[0])


def _require_symmetric(chain):
    """The mesh-sharded chains run the plain Metropolis ratio: refuse a
    proposal that needs the Hastings correction."""
    if chain.jump_logpdf is not None:
        raise NotImplementedError("mesh-sharded chains support symmetric proposals only")


def _finite_distances(dist, what):
    dist = np.asarray(dist, dtype=np.float64)
    if not np.all(np.isfinite(dist)):
        raise FloatingPointError(f"{what}: {int(np.sum(~np.isfinite(dist)))} sample "
                                 "distances are not finite")
    return dist


class MHMCStateInterval(ConfidenceInterval):
    """Distances of likelihood samples (Cholesky parametrization) to the
    point estimate.

    `temper=True` (default) samples exp(-NLL) with the frequency-normalized
    NLL, as the reference does: a posterior flattened by the total shot
    count. `temper=False` samples the count-weighted likelihood.
    `adapt_step=True` tunes the proposal scale during burn-in
    (`MHMC.adapt_step`). `n_chains > 1` runs that many chains side by side,
    each with its own burn-in, and `r_hat`, `ess` hold the diagnostics of
    the distance series. `jump_distr` selects the proposal (see `MHMC`); an
    asymmetric one needs `jump_logpdf` (callable(delta (..., dim)) ->
    (...)). `key` is an int seed or a torch.Generator on the tomograph's
    device (default seed 0). `mesh` (a `parallel.Mesh`) shards the chains
    of an `n_chains > 1` run over its devices (`sharded_mhmc_state_chains`;
    dense designs and symmetric proposals only); `adapt_step` still tunes
    the proposal locally first, and the shards' generators are seeded from
    one draw of the chain's.
    """

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        step: float = 0.01,
        burn_steps: int = 1000,
        thinning: int = 1,
        warm_start: bool = False,
        use_new_estimate: bool = False,
        state=None,
        verbose: bool = False,
        key=None,
        temper: bool = True,
        adapt_step: bool = False,
        n_chains: int = 1,
        jump_distr=None,
        mesh=None,
        jump_logpdf=None,
    ):
        super().__init__(
            tmg, n_points=n_points, step=step, burn_steps=burn_steps,
            thinning=thinning, warm_start=warm_start,
            use_new_estimate=use_new_estimate, state=state, verbose=verbose,
            key=key, temper=temper, adapt_step=adapt_step,
            n_chains=n_chains, jump_distr=jump_distr, mesh=mesh,
            jump_logpdf=jump_logpdf,
        )

    def setup(self):
        if self.mode == Mode.CHANNEL:
            raise NotImplementedError("This interval works only for state tomography")
        tmg = self.tmg
        if not self.use_new_estimate:
            self.state = tmg.reconstructed_state
        elif self.state is None:
            self.state = tmg.point_estimate(method="mle", physical=True)
        n = tmg.state.n_qubits
        if not (self.warm_start and hasattr(self, "chain")):
            # a jitter for a strictly positive-definite Cholesky start
            mat = self.state.matrix + 1e-7 * np.eye(self.state.matrix.shape[0])
            mat = mat / np.trace(mat).real
            scale = 1.0 if self.temper else float(np.sum(tmg.n_measurements))
            self.chain = MHMC(
                lambda x: -scale * tmg._nll(x),
                jump_distr=self.jump_distr,
                step=self.step,
                burn_steps=self.burn_steps,
                dim=4**n,
                update_rule=normalized_update,
                symmetric=self.jump_logpdf is None,
                jump_logpdf=self.jump_logpdf,
                x_init=tmg._tensor(np_matrix_to_real_tril_vec(mat)),
                key=self.key,
            )
            if self.adapt_step:
                self.chain.adapt_step()
        if self.n_chains > 1 and self.mesh is not None:
            if tmg.povm_matrix is None:
                raise NotImplementedError("mesh-sharded MHMC chains need a dense design")
            _require_symmetric(self.chain)
            from ..parallel import sharded_mhmc_state_chains

            per_chain = -(-self.n_points // self.n_chains)
            freq, povm_w = tmg._nll_operands()
            scale = 1.0 if self.temper else float(np.sum(tmg.n_measurements))
            samples, self.acceptance_rate = sharded_mhmc_state_chains(
                self.mesh, self.chain.generator, self.chain.x_t, povm_w, freq, n, scale,
                self.chain.step, self.n_chains, per_chain, burn_steps=self.burn_steps,
                thinning=self.thinning, jump_distr=self.chain.jump_fn,
            )
            chain_shape = samples.shape[:2]
            samples = samples.reshape(-1, samples.shape[-1])
        else:
            samples, self.acceptance_rate, chain_shape = _draw_chains(
                self.chain, self.n_points, self.n_chains, self.thinning, self.verbose
            )
        dst_name = _DST_NAMES.get(tmg.dst)
        if dst_name is not None:
            dist = bootstrap_core.tril_samples_distance(
                dst_name, tmg._tensor(samples), tmg._tensor(self.state.bloch), n
            ).cpu().numpy()
        else:  # a custom distance runs on the host
            rho = np_real_tril_vec_to_matrix(np.asarray(samples, dtype=np.float64))
            rho = rho / np.trace(rho, axis1=-2, axis2=-1).real[..., None, None]
            dist = [tmg.dst(Qobj(r), self.state) for r in rho]
        dist = _finite_distances(dist, type(self).__name__)
        per_chain_dist = dist.reshape(chain_shape)
        self.r_hat = split_rhat(per_chain_dist)
        self.ess = effective_sample_size(per_chain_dist)
        _warn_if_nonconverged(type(self).__name__, self.r_hat, self.ess)
        dist = np.sort(dist)
        self.cl_to_dist = _interp1d(np.linspace(0, 1, len(dist)), dist)


def _hutchinson_diagonal(target, dim: int, n_probes: int, dtype, device, seed: int = 2024):
    """Hutchinson estimate of the diagonal of the Hessian of -target at 0:
    the mean of v * (H v) over `n_probes` Rademacher probes v from a
    generator seeded `seed`, the Hessian-vector products by double
    backward, probes in batches of at most 2^20 / dim."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    acc = torch.zeros(dim, dtype=dtype, device=device)
    batch = max(1, min(int(n_probes), (1 << 20) // dim))
    done = 0
    while done < n_probes:
        k = min(batch, n_probes - done)
        v = torch.randint(0, 2, (k, dim), generator=gen, device=device).to(dtype) * 2 - 1
        with torch.enable_grad():
            z = torch.zeros((k, dim), dtype=dtype, device=device, requires_grad=True)
            (g,) = torch.autograd.grad(-target(z).sum(), z, create_graph=True)
            (hv,) = torch.autograd.grad(g, z, grad_outputs=v)
        acc += (v * hv).sum(0)
        done += k
    return acc / n_probes


class MHMCProcessInterval(ConfidenceInterval):
    """Likelihood sampling over Choi matrices.

    'bloch' (default) at 1-3 qubits samples Choi bloch vectors with
    CPTP-projected proposals (`ProcessTomograph._cptp_update_rule`; the
    projection reads its criterion every `PROJECTION_READ_EVERY`
    iterations). From `PROJECTED_TARGET_QUBITS` up it samples unconstrained
    y against exp(-NLL(P(y))), P the Newton-Schulz CPTP projection, and
    reports P(y): the project-the-proposal scheme freezes there (the JAX
    package measured acceptance 0 at step 1e-9). `proposal='mala'` (this
    mode only) takes the gradient through the fixed-length differentiable
    projection; `precondition=True` runs the chain in Kronecker-Fisher
    whitened coordinates (`process_core.kron_fisher_whitener`), and
    `precondition=False` with the random walk takes the legacy diagonal
    Fisher proposal.

    'kraus' samples a smooth, exactly CPTP factor M
    (`process_core.kraus_param_to_choi_bloch`) with either proposal; with
    `precondition=True` in design-whitened coordinates
    (`process_core.kraus_design_whitener`). `mode_seek` (default 500 in
    kraus mode) first ascends the target with that many Adam steps.
    `anchored=True` (default) evaluates the target as an exact delta from a
    float64 anchor (`process_core.np_kraus_anchor_pack`), re-anchored at
    the mode after `mode_seek`; `curv_probes` (anchored only; 0 disables)
    rescales the coordinates by a Hutchinson estimate of the Hessian
    diagonal at the anchor, from Rademacher probes of a generator seeded
    2024. Non-anchored float32 kraus targets evaluate the current state's
    log-density afresh every step (`refresh_logp`).

    `temper=True` divides the NLL by the total count. `return_samples=True`
    makes `setup()` return (distances, levels, acceptance, Choi matrices).
    At 4+ qubits the chains do not converge in the JAX package either (its
    docs/benchmarks.md): use `BootstrapProcessInterval` there; the R-hat
    warning fires when chains move but do not mix (a chain that accepts
    nothing reads R-hat 1.0). `key` is an int seed or a torch.Generator on
    the tomograph's device (default seed 0). `mesh` (a `parallel.Mesh`)
    shards the chains of an `n_chains > 1` random-walk run over its devices:
    the 1-3 qubit 'bloch' chains (`sharded_mhmc_process_chains`) and the
    anchored 'kraus' chains (`sharded_mhmc_kraus_chains`); MALA, asymmetric
    proposals, non-anchored kraus targets and the projected-target 'bloch'
    chains raise.
    """

    #: from this qubit count on, 'bloch' samples the projected-likelihood target
    PROJECTED_TARGET_QUBITS = 4

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        step: float = 0.01,
        burn_steps: int = 1000,
        thinning: int = 1,
        warm_start: bool = False,
        method: str = "lifp",
        states_est_method: str = "lin",
        states_physical: bool = True,
        states_init: str = "lin",
        use_new_estimate: bool = False,
        channel=None,
        verbose: bool = False,
        return_samples: bool = False,
        key=None,
        adapt_step: bool = False,
        n_chains: int = 1,
        jump_distr=None,
        mesh=None,
        jump_logpdf=None,
        temper: bool = False,
        proposal: str = "rw",
        precondition: bool = True,
        parametrization: str = "bloch",
        mode_seek: int | None = None,
        anchored: bool = True,
        curv_probes: int = 32,
    ):
        super().__init__(
            tmg, n_points=n_points, step=step, burn_steps=burn_steps,
            thinning=thinning, warm_start=warm_start, method=method,
            states_est_method=states_est_method,
            states_physical=states_physical, states_init=states_init,
            use_new_estimate=use_new_estimate, channel=channel,
            verbose=verbose, return_samples=return_samples, key=key,
            adapt_step=adapt_step, n_chains=n_chains, jump_distr=jump_distr,
            mesh=mesh, jump_logpdf=jump_logpdf, temper=temper,
            proposal=proposal, precondition=precondition,
            parametrization=parametrization, mode_seek=mode_seek,
            anchored=anchored, curv_probes=curv_probes,
        )
        if parametrization not in ("bloch", "kraus"):
            raise ValueError(
                "parametrization must be 'bloch' (projected chains) or "
                "'kraus' (smooth exactly-CPTP factor chains)"
            )

    def _design_arrays(self):
        """(input blochs B, weighted POVM rows W, flattened counts) as
        float64 numpy."""
        tmg = self.tmg
        t0 = tmg.tomographs[0]
        povm = np.asarray(t0.povm_matrix, dtype=np.float64)
        n_meas = np.asarray(t0.n_measurements, dtype=np.float64)
        # state_core.weighted_povm_flat on the host
        w = (povm * (n_meas / n_meas.sum())[:, None, None]).reshape(-1, povm.shape[-1])
        flat = np.concatenate([t.flat_results for t in tmg.tomographs])
        return np.asarray(tmg._input_blochs_t(), np.float64), w, flat

    def _kraus_target(self, x_init, scale):
        """The kraus chain's target and start (see the class docstring)."""
        tmg = self.tmg
        d_choi = 4**tmg.channel.n_qubits
        b_np, w_np, flat_np = self._design_arrays()
        b_dev, w_dev, flat_dev = (tmg._tensor(a) for a in (b_np, w_np, flat_np))
        self._decode_kraus = d_choi
        self._kraus_whiten = self._kraus_anchor = self._kraus_uscale = None
        y0 = process_core.np_kraus_param_from_choi_bloch(x_init)
        a_l_np = a_r_np = None
        if self.precondition:
            a_l, a_r, a_l_inv, a_r_inv = process_core.kraus_design_whitener(
                b_np, w_np, flat_np, x_init
            )
            z0 = a_l_inv @ (y0[0] + 1j * y0[1]) @ a_r_inv
            # unit-rms coordinates: the Gram factors carry the raw count
            # scale, which leaves z0 where float32 cannot resolve
            # posterior-sized moves
            s_norm = float(np.sqrt(np.mean(np.abs(z0) ** 2)))
            if s_norm > 0:
                a_l = a_l * s_norm
                z0 = z0 / s_norm
            y0 = np.stack([z0.real, z0.imag], axis=0)
            a_l_np, a_r_np = a_l, a_r
            whiten = tuple(process_core._complex_like(a, b_dev) for a in (a_l, a_r))
            self._kraus_whiten = whiten

            def decode(zf):
                return process_core.kraus_param_to_choi_bloch_whitened(
                    zf.reshape(tuple(zf.shape[:-1]) + (2, d_choi, d_choi)), *whiten
                )
        else:

            def decode(zf):
                return process_core.kraus_param_to_choi_bloch(
                    zf.reshape(tuple(zf.shape[:-1]) + (2, d_choi, d_choi))
                )

        seek = 500 if self.mode_seek is None else int(self.mode_seek)
        if not self.anchored:
            x_ref_dev = tmg._tensor(x_init)
            # p_ref with the chain's own dtype and forward, so p = p_ref + dp
            p_ref = d_choi * (b_dev @ x_ref_dev.reshape(d_choi, d_choi) @ w_dev.T).reshape(-1)

            def target(yf):
                return -scale * process_core.process_nll_factored_rel(
                    decode(yf), b_dev, w_dev, flat_dev, x_ref_dev, p_ref
                )

            x_init = y0.reshape(-1)
            if seek > 0:
                rms0 = float(np.sqrt(np.mean(x_init**2))) or 1.0
                x_init = maximize_logpdf(target, tmg._tensor(x_init), seek, lr=3e-3 * rms0)
            return target, x_init

        counts64 = torch.as_tensor(flat_np, dtype=torch.float64, device=tmg.device)

        def make_anchor(z_ref_c):
            pack, x_ref_b = process_core.np_kraus_anchor_pack(z_ref_c, a_l_np, a_r_np)
            pack_t = process_core.anchor_pack_to(pack, b_dev)
            p_ref = torch.as_tensor(
                d_choi * (b_np @ x_ref_b.reshape(d_choi, d_choi) @ w_np.T).reshape(-1),
                dtype=torch.float64, device=tmg.device,
            )

            def anchored_target(dzf):
                return -scale * process_core.process_nll_anchored(
                    dzf, b_dev, w_dev, counts64, pack_t, p_ref
                )

            return pack, x_ref_b, anchored_target, p_ref

        z_ref = y0[0] + 1j * y0[1]
        pack, x_ref_b, target, p_ref = make_anchor(z_ref)
        rms_ref = float(np.sqrt(np.mean(y0**2))) or 1.0
        x_init = np.zeros(2 * d_choi * d_choi)
        if seek > 0:
            dz = maximize_logpdf(target, tmg._tensor(x_init), seek, lr=3e-3 * rms_ref)
            dz = dz.cpu().numpy().astype(np.float64).reshape(2, d_choi, d_choi)
            pack, x_ref_b, target, p_ref = make_anchor(z_ref + dz[0] + 1j * dz[1])
        self._kraus_anchor = (pack, x_ref_b)
        # the operands of the mesh-sharded chains (`sharded_mhmc_kraus_chains`)
        self._kraus_sharded_ctx = (pack, b_dev, w_dev, counts64, p_ref, scale)
        if self.curv_probes:
            h_diag = _hutchinson_diagonal(
                target, x_init.shape[0], int(self.curv_probes), tmg.dtype, tmg.device
            ).cpu().numpy().astype(np.float64)
            pos = h_diag[h_diag > 0]
            med = float(np.median(pos)) if pos.size else 1.0
            # Hutchinson noise leaves some entries near 0 or negative (and
            # the gauge directions M -> M U carry no curvature): cap the
            # scale at 100x the median direction's
            s_u = 1.0 / np.sqrt(np.clip(h_diag, 1e-4 * med, None))
            s_dev = tmg._tensor(s_u)
            anchored_target = target

            def target(uf):
                return anchored_target(uf * s_dev)

            self._kraus_uscale = s_u
        return target, x_init

    def _projected_target(self, x_init, scale):
        """The 4+ qubit 'bloch' target exp(-NLL(P(y))) and its start (see
        the class docstring)."""
        tmg = self.tmg
        cptp_tol = process_core.default_cptp_tol(1e-12, tmg.dtype)

        def proj(y):
            return process_core.cptp_project_bloch_host(
                y, 100, cptp_tol, chunk=PROJECTION_READ_EVERY, cp="ns"
            )

        self._proj = proj
        b_np, w_np, flat_np = self._design_arrays()
        unwhiten = None
        if self.precondition:
            a_b, a_w, l_b, l_w = process_core.kron_fisher_whitener(b_np, w_np, flat_np, x_init)
            d1 = a_b.shape[0]
            a_b_dev, a_w_t_dev = tmg._tensor(a_b), tmg._tensor(a_w.T)

            def unwhiten(z):
                zm = z.reshape(tuple(z.shape[:-1]) + (d1, d1))
                return (a_b_dev @ zm @ a_w_t_dev).reshape(z.shape)

            def to_x(zs):
                z3 = np.asarray(zs, np.float64).reshape(-1, d1, d1)
                return (a_b @ (z3 @ a_w.T)).reshape(z3.shape[0], -1)

            self._to_x = to_x
            x_init = (l_b.T @ x_init.reshape(d1, d1) @ l_w).reshape(-1)
        coords = unwhiten or (lambda y: y)
        if self.proposal == "mala":
            # the drift and the log-density take the same differentiable
            # projection, so the chain is exact for its target

            def target(z):
                return -scale * tmg._nll(process_core.cptp_project_bloch_diff(coords(z), 100))
        else:

            def target(z):
                return -scale * tmg._nll(proj(coords(z)))

            if not self.precondition and self.jump_distr is None:
                # the legacy diagonal Fisher proposal: per-axis scales
                # ~ 1/sqrt(diag(A^T A)), diag(A^T A) = 16^n colsq(B) (x)
                # colsq(W); fixed scales, so still symmetric
                fisher_diag = np.kron(np.sum(b_np**2, axis=0), np.sum(w_np**2, axis=0))
                scales = 1.0 / np.sqrt(fisher_diag + 1e-6 * fisher_diag.max())
                scales_dev = tmg._tensor(scales / np.median(scales))

                def diagonal_jump(gen, shape, dtype, device):
                    normal = torch.randn(shape, generator=gen, dtype=dtype, device=device)
                    return normal * scales_dev

                self.jump_distr = diagonal_jump
        return target, x_init

    def _build_chain(self):
        tmg = self.tmg
        big = tmg.channel.n_qubits >= self.PROJECTED_TARGET_QUBITS
        self._to_x = self._decode_kraus = self._proj = self._kraus_sharded_ctx = None
        x_init = np.asarray(self.channel.choi.bloch, dtype=np.float64)
        scale = (
            1.0 / float(sum(np.sum(t.n_measurements) for t in tmg.tomographs))
            if self.temper
            else 1.0
        )
        update_rule = basic_update
        if self.parametrization == "kraus":
            target, x_init = self._kraus_target(x_init, scale)
        elif big:
            target, x_init = self._projected_target(x_init, scale)
        else:
            if self.proposal == "mala":
                raise NotImplementedError(
                    "proposal='mala' is the projected-target mode "
                    f"(>= {self.PROJECTED_TARGET_QUBITS} qubits)"
                )

            def target(y):
                return -scale * tmg._nll(y)

            update_rule = functools.partial(tmg._cptp_update_rule, chunk=PROJECTION_READ_EVERY)
        # non-anchored float32 kraus targets carry O(1) evaluation noise:
        # the current state's log-density is evaluated afresh every step
        refresh = (
            self.parametrization == "kraus" and not self.anchored
            and tmg.dtype == torch.float32
        )
        self.chain = MHMC(
            target,
            jump_distr=self.jump_distr,
            step=self.step,
            burn_steps=self.burn_steps,
            dim=int(x_init.shape[-1]),
            update_rule=update_rule,
            symmetric=self.jump_logpdf is None,
            jump_logpdf=self.jump_logpdf,
            x_init=tmg._tensor(x_init),
            key=self.key,
            drift_fn=autograd_drift(target) if self.proposal == "mala" else None,
            refresh_logp=refresh,
        )
        if self.adapt_step:
            # windows around the 25% random-walk optimum and MALA's 57%
            if self.proposal == "mala":
                bounds = (0.4, 0.7)
            elif big or self.parametrization == "kraus":
                bounds = (0.15, 0.4)
            else:
                bounds = (0.05, 0.5)
            self.chain.adapt_step(segment=100, max_rounds=24, confirm=2, bounds=bounds)

    def _decode(self, samples):
        """Choi bloch vectors (float64 numpy) of the chain's samples."""
        tmg = self.tmg
        if self._decode_kraus:
            d_choi = self._decode_kraus
            ys = np.asarray(samples, dtype=np.float64)
            if self._kraus_uscale is not None:
                ys = ys * self._kraus_uscale  # the chain runs in u = dz / s
            ys = ys.reshape(-1, 2, d_choi, d_choi)
            if self._kraus_anchor is not None:
                pack, x_ref = self._kraus_anchor

                def decode(zz):
                    return x_ref + process_core.kraus_delta_choi_bloch(
                        tmg._tensor(zz), pack).cpu().numpy().astype(np.float64)
            elif self._kraus_whiten is not None:

                def decode(zz):
                    return process_core.kraus_param_to_choi_bloch_whitened(
                        tmg._tensor(zz), *self._kraus_whiten).cpu().numpy().astype(np.float64)
            else:

                def decode(zz):
                    return process_core.kraus_param_to_choi_bloch(
                        tmg._tensor(zz)).cpu().numpy().astype(np.float64)

            chunk = max(1, (1 << 24) // (d_choi * d_choi))
            samples = np.concatenate(
                [decode(ys[lo : lo + chunk]) for lo in range(0, ys.shape[0], chunk)]
            )
        if self._to_x is not None:
            samples = self._to_x(samples)  # whitened z back to Choi bloch
        if self._proj is not None:
            # projected-likelihood samples are reported as their projections
            samples = process_core.cptp_project_bloch_host(
                tmg._tensor(samples), max_iter=100, chunk=25, cp="ns"
            ).cpu().numpy().astype(np.float64)
        return np.asarray(samples, dtype=np.float64)

    def _sharded_chains(self):
        """The chains of an `n_chains > 1` run over `mesh`, with the
        rejections of the JAX package; returns what `_draw_chains` does."""
        from ..parallel import sharded_mhmc_kraus_chains, sharded_mhmc_process_chains

        _require_symmetric(self.chain)
        if self.proposal == "mala":
            raise NotImplementedError(
                "mesh-sharded chains run the random-walk proposal; MALA chains "
                "run side by side with n_chains alone"
            )
        chain = self.chain
        per_chain = -(-self.n_points // self.n_chains)
        common = dict(
            burn_steps=self.burn_steps, thinning=self.thinning, jump_distr=chain.jump_fn
        )
        if self.parametrization == "kraus":
            if not self.anchored:
                raise NotImplementedError(
                    "mesh-sharded kraus chains run the anchored-delta target "
                    "(anchored=True); the full-decode target runs side by side "
                    "with n_chains alone"
                )
            pack, b, w, counts, p_ref, scale = self._kraus_sharded_ctx
            samples, rate = sharded_mhmc_kraus_chains(
                self.mesh, chain.generator, chain.x_t, pack, b, w, counts, p_ref, scale,
                chain.step, self.n_chains, per_chain, u_scale=self._kraus_uscale, **common,
            )
        elif self.tmg.channel.n_qubits >= self.PROJECTED_TARGET_QUBITS:
            raise NotImplementedError(
                "mesh-sharded bloch chains implement the project-the-proposal "
                f"scheme, which freezes at >= {self.PROJECTED_TARGET_QUBITS} qubits; "
                "use parametrization='kraus' (anchored, mesh-shardable) or "
                "n_chains without a mesh there"
            )
        else:
            b, _, flat = self._design_arrays()
            t0 = self.tmg.tomographs[0]
            temper = (
                1.0 / float(sum(np.sum(t.n_measurements) for t in self.tmg.tomographs))
                if self.temper
                else 1.0
            )
            samples, rate = sharded_mhmc_process_chains(
                self.mesh, chain.generator, chain.x_t, b, t0.povm_matrix, t0.n_measurements,
                flat, chain.step, self.n_chains, per_chain, scale=temper, **common,
            )
        return samples.reshape(-1, samples.shape[-1]), rate, samples.shape[:2]

    def setup(self):
        if self.mode == Mode.STATE:
            raise NotImplementedError("This interval works only for process tomography")
        tmg = self.tmg
        if not self.use_new_estimate:
            self.channel = tmg.reconstructed_channel
        elif self.channel is None:
            self.channel = tmg.point_estimate(
                self.method,
                states_est_method=self.states_est_method,
                states_physical=self.states_physical,
                states_init=self.states_init,
            )
        if not (self.warm_start and hasattr(self, "chain")):
            self._build_chain()
        if self.n_chains > 1 and self.mesh is not None:
            samples, self.acceptance_rate, chain_shape = self._sharded_chains()
        else:
            samples, self.acceptance_rate, chain_shape = _draw_chains(
                self.chain, self.n_points, self.n_chains, self.thinning, self.verbose
            )
        samples = self._decode(samples)
        n2 = 2 * tmg.channel.n_qubits
        dst_name = _DST_NAMES.get(tmg.dst)
        if dst_name is not None:
            dist = bootstrap_core._distance_batch(
                dst_name, tmg._tensor(samples), tmg._tensor(self.channel.choi.bloch), n2
            ).cpu().numpy()
        else:
            dist = [tmg.dst(Qobj(m), self.channel.choi)
                    for m in np_bloch_to_matrix(samples, n2)]
        dist = _finite_distances(dist, type(self).__name__)
        per_chain_dist = dist.reshape(chain_shape)
        self.r_hat = split_rhat(per_chain_dist)
        self.ess = effective_sample_size(per_chain_dist)
        _warn_if_nonconverged(type(self).__name__, self.r_hat, self.ess)
        dist = np.sort(dist)
        conf_levels = np.linspace(0, 1, len(dist))
        self.cl_to_dist = _interp1d(conf_levels, dist)
        if self.return_samples:
            return dist, conf_levels, self.acceptance_rate, list(np_bloch_to_matrix(samples, n2))


# --------------------------------------------------------------------------
# Holder composition interval
# --------------------------------------------------------------------------


class HolderInterval(ConfidenceInterval):
    """Process CI composed from per-input-state intervals by a Holder-type
    bound.

    `kind` selects the per-state interval family: 'moment', 'mhmc',
    'sugiyama' or 'bootstrap' (alias 'boot'); `step`, `burn_steps` and
    `thinning` go to the 'mhmc' children, which sample around their own
    'mle' estimates. 'wang', which the reference advertises but never
    implemented, is rejected.
    """

    def __init__(
        self,
        tmg,
        n_points: int = 1000,
        kind: str = "moment",
        max_confidence: float = 0.999,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        tol: float = 1e-3,
        max_iter: int = 100,
        step: float = 0.01,
        burn_steps: int = 1000,
        thinning: int = 1,
    ):
        super().__init__(
            tmg, n_points=n_points, kind=kind, max_confidence=max_confidence,
            method=method, physical=physical, init=init, tol=tol, max_iter=max_iter,
            step=step, burn_steps=burn_steps, thinning=thinning,
        )

    def __call__(self, conf_levels=None):
        if conf_levels is None:
            conf_levels = np.linspace(1e-3, 1 - 1e-3, 1000)
        if not hasattr(self, "intervals"):
            self.setup()
        state_results = [interval(conf_levels) for interval in self.intervals]
        state_deltas = np.asarray([r[0] for r in state_results])
        conf_levels = np.asarray(state_results[0][1]) ** self.tmg.input_basis.dim
        dec = self.tmg._decomposed_single_entries
        coef = np.abs(np.einsum("ij,ik->jk", dec, dec.conj()))
        composition = np.einsum("ik,jk->ijk", state_deltas, state_deltas)
        dist = np.sqrt(np.einsum("ijk,ij->k", composition, coef))
        return dist, conf_levels

    def setup(self):
        if self.mode == Mode.STATE:
            raise NotImplementedError("Holder interval works only for process tomography")
        kind = "bootstrap" if self.kind == "boot" else self.kind
        tomographs = self.tmg.tomographs
        if kind == "moment":
            self.intervals = [MomentInterval(t) for t in tomographs]
        elif kind == "mhmc":
            if any(t.povm_matrix is None for t in tomographs):
                raise NotImplementedError(
                    "kind='mhmc' needs dense per-state POVMs; use "
                    "kind='moment'/'sugiyama'/'bootstrap' for kron-mode child tomographs"
                )
            self.intervals = [
                MHMCStateInterval(
                    t, self.n_points, self.step, self.burn_steps, self.thinning,
                    use_new_estimate=True,
                )
                for t in tomographs
            ]
        elif kind == "bootstrap":
            self.intervals = [
                BootstrapStateInterval(
                    t, self.n_points, self.method, physical=self.physical,
                    init=self.init, tol=self.tol, max_iter=self.max_iter,
                )
                for t in tomographs
            ]
        elif kind == "sugiyama":
            self.intervals = [
                SugiyamaInterval(t, self.n_points, self.max_confidence) for t in tomographs
            ]
        else:
            raise ValueError("Incorrect value for argument `kind`.")
        if kind in ("moment", "sugiyama") and tomographs[0].povm_matrix is not None:
            # all children share one design: one pseudo-inverse on the
            # device for all of them
            shared_inv = _design_inverse(tomographs[0])
            for iv in self.intervals:
                iv._design_inv = shared_inv
        for interval in self.intervals:
            interval.setup()
