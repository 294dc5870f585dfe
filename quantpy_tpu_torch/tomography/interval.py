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
- HolderInterval: a process bound composed from per-input-state intervals.

Not ported yet: the MHMC family (ROADMAP A14).
"""

from __future__ import annotations

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
from ..ops.geometry import hs_dst, if_dst, trace_dst
from ..ops.paulis import np_bloch_to_matrix
from ..qobj import Qobj
from ..routines import _left_inv as _left_inv_np
from ..stats import l2_moments_from_factor
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


# --------------------------------------------------------------------------
# Holder composition interval
# --------------------------------------------------------------------------


class HolderInterval(ConfidenceInterval):
    """Process CI composed from per-input-state intervals by a Holder-type
    bound.

    `kind` selects the per-state interval family: 'moment', 'sugiyama' or
    'bootstrap' (alias 'boot'). 'mhmc' waits for the MHMC intervals
    (ROADMAP A14); 'wang', which the reference advertises but never
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
    ):
        super().__init__(
            tmg, n_points=n_points, kind=kind, max_confidence=max_confidence,
            method=method, physical=physical, init=init, tol=tol, max_iter=max_iter,
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
            raise NotImplementedError(
                "HolderInterval(kind='mhmc') needs the MHMC intervals, which are "
                "not ported yet (ROADMAP A14)"
            )
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
