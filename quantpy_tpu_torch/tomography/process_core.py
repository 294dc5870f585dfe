"""Functional core of quantum process tomography (port of
quantpy_tpu/tomography/process_core.py).

Everything runs in the Choi bloch representation: the Choi matrix of an
n-qubit channel is a Hermitian operator on 2n qubits, hence a real vector
of length 16^n. In the Pauli product basis P_a (x) P_b (input factor
first) the TP constraint Tr_out(C) = I fixes the 4^n coefficients c[(a, 0)]
(1/2^n at a = 0, zero elsewhere), and the measurement model is one real
product: p[s, o] = A[s, o] . c with rows 4^n kron(bloch(rho_s^T), w_o).

Batch-first functions on tensors. Each follows the dtype and device of its
main tensor argument; numpy inputs get the port's defaults (see `config`).
Loops whose length depends on the data run on the host and read their stop
criterion from the device: once per iteration, or once per `chunk`
iterations where the function takes a `chunk`.

Shape conventions:
- input_blochs_t: (S, D) bloch vectors of the transposed input states,
  D = 4^n
- povm_matrix: (m, p, D); counts: (..., S, m, p)
- choi_bloch: (..., D2) with D2 = 16^n
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math
import threading

import numpy as np
import torch

from ..config import as_real, complex_dtype, rdtype
from ..ops import kernels
from ..ops.paulis import (
    bloch_to_matrix,
    matrix_to_bloch,
    np_bloch_to_matrix,
    np_matrix_to_bloch,
    pauli_transpose_signs,
)
from ..utils import profiling
from . import state_core

__all__ = [
    "measurement_operator",
    "process_probabilities",
    "simulate_process_experiment",
    "choi_apply_bloch",
    "np_choi_apply_bloch",
    "tp_project_bloch",
    "cp_project_bloch",
    "cp_project_bloch_ns",
    "default_cptp_tol",
    "cptp_project_bloch",
    "cptp_project_bloch_host",
    "estimate_lifp",
    "estimate_lifp_factored",
    "process_nll",
    "process_nll_factored",
    "states_to_choi_bloch",
    "pgdb_prepare",
    "pgdb_factored_step",
    "estimate_pgdb",
    "estimate_pgdb_factored",
    "estimate_pgdb_factored_host",
    "dys_factored_chunk",
    "estimate_dys_factored",
    "cptp_project_bloch_diff",
    "kraus_param_to_choi_bloch",
    "kraus_param_to_choi_bloch_whitened",
    "kraus_design_whitener",
    "np_kraus_param_from_choi_bloch",
    "np_kraus_anchor_pack",
    "kraus_delta_choi_bloch",
    "process_nll_anchored",
    "process_nll_factored_rel",
    "kron_fisher_whitener",
]

_CP_EPS = 1e-12  # eigenvalue floor of the CP projection, probability floor of the logs


def _n_from_d2(d2: int) -> int:
    n = int(round(math.log(d2, 16)))
    if 16**n != d2:
        raise ValueError(f"Invalid Choi bloch dimension {d2}")
    return n


def measurement_operator(input_blochs_t, povm_matrix, n_measurements):
    """The real process-measurement matrix A: (S*K, 16^n), with rows
    4^n * kron(bloch(rho_s^T), w_o) over (input state s, weighted flattened
    POVM row o)."""
    input_blochs_t = as_real(input_blochs_t)
    w = state_core.weighted_povm_flat(as_real(povm_matrix, like=input_blochs_t), n_measurements)
    d = input_blochs_t.shape[-1]
    s, k = input_blochs_t.shape[0], w.shape[0]
    rows = torch.einsum("sd,ke->skde", input_blochs_t, w).reshape(s * k, -1)
    return rows * d


def process_probabilities(a_matrix, choi_bloch):
    """p = A @ c, batched over the leading axes of choi_bloch."""
    return choi_bloch @ a_matrix.T


def simulate_process_experiment(generator, povm_matrix, output_blochs, n_measurements):
    """Simulate state tomography of every channel output state in one call.

    output_blochs: (..., S, D) bloch vectors of the channel applied to each
    input state. Returns counts (..., S, m, p) on their device; `generator`
    must live there too."""
    return state_core.simulate_experiment(generator, povm_matrix, output_blochs, n_measurements)


def _choi_apply_core(choi_bloch, in_blochs, signs):
    """The channel action in bloch space, for numpy arrays and tensors.

    C = sum_ab c[a,b] P_a (x) P_b acts by Phi(rho) = Tr_in[(rho^T (x) I) C];
    with rho = sum_x r_x P_x and Tr(rho^T P_a) = s_a r_a 2^n (s the Pauli
    transpose signs) this is bloch_out[b] = 2^n sum_a s_a r_a c[a, b]."""
    d2 = choi_bloch.shape[-1]
    d1 = int(round(math.sqrt(d2)))
    n = int(round(math.log(d1, 4)))
    c = choi_bloch.reshape(tuple(choi_bloch.shape[:-1]) + (d1, d1))
    return (2**n) * ((in_blochs * signs)[..., None, :] @ c)[..., 0, :]


def choi_apply_bloch(choi_bloch, in_blochs):
    """Apply channel(s) to state(s), all in bloch space.

    choi_bloch: (..., 16^n) Choi bloch vector(s); in_blochs: (..., 4^n)
    state bloch vector(s); the batch axes broadcast. Returns (..., 4^n)."""
    choi_bloch = as_real(choi_bloch)
    in_blochs = as_real(in_blochs, like=choi_bloch)
    n = int(round(math.log(in_blochs.shape[-1], 4)))
    signs = as_real(pauli_transpose_signs(n), like=choi_bloch)
    return _choi_apply_core(choi_bloch, in_blochs, signs)


def np_choi_apply_bloch(choi_bloch, in_blochs):
    """Host-numpy twin of :func:`choi_apply_bloch` (Channel.transform uses
    it for a channel held as a Choi matrix)."""
    choi_bloch = np.asarray(choi_bloch, dtype=np.float64)
    in_blochs = np.asarray(in_blochs, dtype=np.float64)
    n = int(round(math.log(in_blochs.shape[-1], 4)))
    return _choi_apply_core(choi_bloch, in_blochs, pauli_transpose_signs(n))


# -- projections --------------------------------------------------------------


def tp_project_bloch(choi_bloch):
    """Orthogonal projection onto trace-preserving Choi matrices: the
    coordinates c[(a, 0)] are set to 1/2^n at a = 0 and to 0 elsewhere."""
    choi_bloch = as_real(choi_bloch)
    n = _n_from_d2(choi_bloch.shape[-1])
    d1 = 4**n
    c = choi_bloch.reshape(tuple(choi_bloch.shape[:-1]) + (d1, d1)).clone()
    c[..., :, 0] = 0.0
    # fill_, not a setitem: on one unbatched vector that would copy a host scalar,
    # which a CUDA graph cannot capture
    c[..., 0, 0].fill_(1.0 / (2**n))
    return c.reshape(choi_bloch.shape)


def _eigh_psd_mat(a):
    """PSD projection of Hermitian matrices (their lower triangles): eigh,
    eigenvalues floored at 1e-12, recomposed.

    A complex64 batch on the card of matrices up to 64 x 64 (the Choi
    matrices of 1-3 qubits) goes to `kernels.psd_project`, which does all
    three in one launch and reads nothing back; everything else (4 qubits,
    complex128, the CPU) to `torch.linalg.eigh`, whose error check on the
    card is one `host_sync`. The span `qt.psd` counts the routes:
    `launches` and `eigh`."""
    with profiling.span("qt.psd", a.device):
        d = a.shape[-1]
        if a.is_cuda and a.dtype == torch.complex64 and d <= kernels.PSD_MAX_DIM:
            return kernels.psd_project(a.reshape(-1, d, d).contiguous()).reshape(a.shape)
        profiling.count("eigh")
        evals, evecs = torch.linalg.eigh(a)
        if a.is_cuda:  # the error check reads the card's info back
            profiling.count("host_sync")
        evals = evals.clamp(min=_CP_EPS)
        return (evecs * evals[..., None, :].to(evecs.dtype)) @ evecs.conj().transpose(-1, -2)


def cp_project_bloch(choi_bloch):
    """Projection onto completely positive (PSD-Choi) maps by eigh."""
    choi_bloch = as_real(choi_bloch)
    n2 = 2 * _n_from_d2(choi_bloch.shape[-1])  # the Choi matrix lives on 2n qubits
    return matrix_to_bloch(_eigh_psd_mat(bloch_to_matrix(choi_bloch, n2)))


_NS_SAFETY = 0.99  # keep t * u_max <= 0.99 * sqrt(3): g_t sign-preserving


@functools.lru_cache(maxsize=None)
def _ns_schedule(ns_iter: int) -> tuple:
    """Per-step scaling factors t_k for the scaled cubic Newton-Schulz sign
    iteration S <- g_t(S) with g_t(x) = (t x)(3 - (t x)^2)/2.

    Unscaled NS grows small eigenvalues by 1.5x per step; pre-scaling by t
    grows them by 1.5 t (up to ~2.57x at t ~= 0.99*sqrt(3)) while the cap
    t*u <= 0.99*sqrt(3) keeps g_t sign-preserving on the whole spectral
    envelope [l, u]. The schedule comes from a greedy envelope
    optimization: at each step pick the t that maximizes the worst-case
    image min(g_t(l), g_t(u)), then append two unscaled polish steps. The
    resolvable floor l0 is chosen by bisection so that the schedule has
    ns_iter steps; at the default 19 the floor is ~7e-7 * ||A||_F.
    """
    if ns_iter <= 2:
        return (1.0,) * ns_iter

    def g(x, t):
        y = t * x
        return 0.5 * y * (3.0 - y * y)

    def greedy(l0):
        l, u = l0, 1.0
        ts = []
        for _ in range(4 * ns_iter + 8):
            cand = np.linspace(1.0, np.sqrt(3.0) * _NS_SAFETY / u, 2001)
            worst = np.minimum(g(l, cand), g(u, cand))
            t = float(cand[np.argmax(worst)])
            xs = np.linspace(l, u, 2001)
            ys = g(xs, t)
            l, u = float(ys.min()), float(ys.max())
            ts.append(t)
            if l >= 0.97:
                break
        return ts

    lo, hi = -40.0, np.log10(0.97)  # log10 of the resolvable floor
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if len(greedy(10.0**mid)) > ns_iter - 2:
            lo = mid
        else:
            hi = mid
    ts = greedy(10.0**hi)[: ns_iter - 2]
    return tuple(ts) + (1.0,) * (ns_iter - len(ts))


def _ns_sign(s, eye, ns_iter: int):
    """Scaled-schedule cubic Newton-Schulz sign iteration (see
    `_ns_schedule`): S <- Y (3 I - Y Y) / 2 with Y = t_k S, written as
    S (1.5 t I - 0.5 t^3 S S): two matrix products and one elementwise pass
    per step."""
    for t in _ns_schedule(ns_iter):
        s = s @ torch.add(eye * (1.5 * t), s @ s, alpha=-0.5 * t**3)
    return s


def _ns_psd_mat(a, ns_iter: int):
    """PSD projection of Hermitian matrices by the matrix sign function,
    matrix products only: max(A, 0) = (A + A sign(A)) / 2, with sign(A) from
    the scaled Newton-Schulz iteration started at A / ||A||_F. Eigenvalues
    under the schedule's floor (~7e-7 ||A||_F at 19 steps) keep about half
    their magnitude."""
    fro = torch.linalg.matrix_norm(a, keepdim=True)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    sign = _ns_sign(a / fro.clamp(min=1e-30), eye, ns_iter)
    psd = 0.5 * (a + a @ sign)
    return 0.5 * (psd + psd.conj().transpose(-1, -2))


def cp_project_bloch_ns(choi_bloch, ns_iter: int = 19):
    """CP projection by the Newton-Schulz sign iteration (`_ns_psd_mat`)
    instead of an eigendecomposition; equal to `cp_project_bloch` to about
    1e-5 * ||A||."""
    choi_bloch = as_real(choi_bloch)
    n2 = 2 * _n_from_d2(choi_bloch.shape[-1])
    return matrix_to_bloch(_ns_psd_mat(bloch_to_matrix(choi_bloch, n2), ns_iter))


def default_cptp_tol(tol: float | None = None, dtype=None) -> float:
    """The Dykstra tolerance floored at the working precision of `dtype`
    (default: `config.rdtype()`). The stop criterion is the squared
    correction increment, so the floor is eps^1.5; under it a float32 run
    never stops before its iteration cap."""
    eps = float(torch.finfo(dtype or rdtype()).eps)
    return max(eps**1.5, 0.0 if tol is None else tol)


def _tp_project_mat(c):
    """Matrix-space twin of `tp_project_bloch`: the orthogonal projection
    onto Tr_out(C) = I is C + ((I - Tr_out C)/d_out) (x) I_out, input factor
    first."""
    d_in = int(round(math.sqrt(c.shape[-1])))
    c4 = c.reshape(tuple(c.shape[:-2]) + (d_in, d_in, d_in, d_in))
    tr_out = torch.diagonal(c4, dim1=-3, dim2=-1).sum(-1)
    eye = torch.eye(d_in, dtype=c.dtype, device=c.device)
    corr = (eye - tr_out) / d_in
    return (c4 + corr[..., :, None, :, None] * eye[:, None, :]).reshape(c.shape)


def _dykstra_step(x, p, q, cp_fn=None):
    """One textbook two-set Dykstra update in bloch space; returns
    (x, p, q, max crit over the batch)."""
    cp_fn = cp_fn or cp_project_bloch
    s = x + p
    y = tp_project_bloch(s)
    p_new = s - y
    t = y + q
    x_new = cp_fn(t)
    q_new = t - x_new
    crit = ((p_new - p) ** 2).sum(-1) + ((q_new - q) ** 2).sum(-1)
    return x_new, p_new, q_new, crit.max()


def _dykstra_step_mat(xm, pm, qm, ns_iter: int, scale: float):
    """The same update on the Choi matrices, with the Newton-Schulz CP
    projection; the criterion is scaled by `scale` = 2^-2n to the bloch
    form's."""
    s = xm + pm
    y = _tp_project_mat(s)
    pm_new = s - y
    t = y + qm
    xm_new = _ns_psd_mat(t, ns_iter)
    qm_new = t - xm_new
    crit = ((pm_new - pm).abs() ** 2).sum((-2, -1)) + ((qm_new - qm).abs() ** 2).sum((-2, -1))
    return xm_new, pm_new, qm_new, crit.max() * scale


def _dykstra_run(x, p, q, n_steps: int, chunk: int, tol, cp: str, ns_iter: int):
    """At most `n_steps` Dykstra iterations from the bloch-space state
    (x, p, q). After every `chunk` of them the criterion of the last one is
    read on the host, and the run ends once it is not above `tol` (`tol`
    None: never read, all `n_steps` run). The 'eigh' engine steps in bloch
    space; the 'ns' engine steps on the matrices and maps back at the end.
    Where `_graph_route` holds, each 'eigh' step is a replay of the step
    captured as a CUDA graph (`_StepGraph`), with the same arithmetic and
    the same reads. Returns (x, p, q, crit) in bloch space. Its span
    `qt.dykstra` counts the steps run (`iters`), those of them replayed
    (`graph`, 0 on the eager routes) and the graphs captured
    (`captures`)."""
    with profiling.span("qt.dykstra", x.device):
        profiling.count("graph", 0)
        crit = torch.full((), math.inf, dtype=x.dtype, device=x.device)
        if cp == "ns":
            n2 = 2 * _n_from_d2(x.shape[-1])
            state = tuple(bloch_to_matrix(v, n2) for v in (x, p, q))
            step = functools.partial(_dykstra_step_mat, ns_iter=ns_iter, scale=1.0 / 2**n2)
            *state, crit = _dykstra_loop(state, step, crit, n_steps, chunk, tol)
            return (*(matrix_to_bloch(v) for v in state), crit)
        if _graph_route(x, cp):
            with _step_graph(x) as graph, torch.no_grad():
                out = _dykstra_loop(graph.load(x, p, q), graph.step, crit, n_steps, chunk, tol)
                return tuple(v.clone() for v in out)  # the graph's next run overwrites them
        return _dykstra_loop((x, p, q), _dykstra_step, crit, n_steps, chunk, tol)


def _dykstra_loop(state, step, crit, n_steps: int, chunk: int, tol):
    """`_dykstra_run`'s loop over `step`, from `state` and the criterion
    `crit`; returns (*state, crit)."""
    done = 0
    while done < n_steps:
        steps = min(chunk, n_steps - done)
        for _ in range(steps):
            *state, crit = step(*state)
        profiling.count("iters", steps)
        done += chunk
        if tol is not None:
            profiling.count("host_sync")
            with profiling.span("qt.dykstra.read"):
                stop = float(crit) <= tol
            if stop:
                break
    return (*state, crit)


def _dykstra_chunk(x, p, q, n_steps: int, cp: str = "eigh", ns_iter: int = 19):
    """Exactly `n_steps` Dykstra iterations from (x, p, q) with the 'eigh'
    or 'ns' CP engine; returns (x, p, q, crit of the last step)."""
    return _dykstra_run(x, p, q, n_steps, n_steps, None, cp, ns_iter)


def cptp_project_bloch_host(
    choi_bloch,
    max_iter: int = 2000,
    tol: float | None = None,
    chunk: int | None = None,
    cp: str = "eigh",
):
    """Dykstra alternating projections onto CPTP, batched:

        y_k     = P_TP(x_k + p_k);   p_{k+1} = x_k + p_k - y_k
        x_{k+1} = P_CP(y_k + q_k);   q_{k+1} = y_k + q_k - x_{k+1}

    Stop: the squared change of both correction increments, maximized over
    the batch, not above `tol` (floored at the precision of the dtype, see
    `default_cptp_tol`), or `max_iter` iterations. The criterion is read on
    the host once every `chunk` iterations (one device sync per chunk), so
    the iteration count is a multiple of `chunk` unless `max_iter` cuts it.
    `chunk=None` is 10 for Choi matrices of dimension 4096 and more, else
    100. `cp` selects the CP engine: exact 'eigh', or 'ns', the
    Newton-Schulz sign iteration of matrix products (`cp_project_bloch_ns`),
    which runs on the matrices throughout."""
    x = as_real(choi_bloch)
    if chunk is None:
        mat_dim = int(round(math.sqrt(x.shape[-1])))
        chunk = 10 if mat_dim >= 4096 else 100
    zeros = torch.zeros_like(x)
    tol = default_cptp_tol(tol, x.dtype)
    return _dykstra_run(x, zeros, zeros, max_iter, chunk, tol, cp, 19)[0]


def cptp_project_bloch(
    choi_bloch, max_iter: int = 2000, tol: float | None = None, cp: str = "eigh"
):
    """`cptp_project_bloch_host` with the criterion read after every
    iteration: it stops at the first iteration whose criterion is not above
    `tol`."""
    return cptp_project_bloch_host(choi_bloch, max_iter, tol, chunk=1, cp=cp)


# -- the 'eigh' step as a captured CUDA graph --------------------------------------

#: step graphs kept per card, the least recently used dropped first
GRAPHS_PER_DEVICE = 8


def _graph_route(x, cp: str) -> bool:
    """Whether `_dykstra_run` replays its steps from a CUDA graph: 'eigh'
    steps of float32 Choi bloch vectors on the card whose Choi matrices the
    PSD kernel takes (up to `kernels.PSD_MAX_DIM`, 1-3 qubits), the steps
    whose CP half `_eigh_psd_mat` sends to `kernels.psd_project`. Such a
    step is ~45 small operations around one launch, which the card waits
    for the host to issue; a replay issues them at once. Every other step
    (the CPU, float64, the 'ns' engine, 4 qubits) runs eagerly."""
    return (cp == "eigh" and x.device.type == "cuda" and x.dtype == torch.float32
            and x.numel() > 0 and math.isqrt(x.shape[-1]) <= kernels.PSD_MAX_DIM)


def _cp_project_recorded(choi_bloch):
    """`cp_project_bloch` as a captured step records it: the PSD kernel's
    launch alone, without the span `qt.psd` and the launch counters, which
    each replay adds itself (`_StepGraph.step`)."""
    n2 = 2 * _n_from_d2(choi_bloch.shape[-1])
    a = bloch_to_matrix(choi_bloch, n2)
    d = a.shape[-1]
    return matrix_to_bloch(kernels._psd_launch(a.reshape(-1, d, d).contiguous()).reshape(a.shape))


class _StepGraph:
    """One 'eigh' Dykstra step at one shape, captured as a CUDA graph: the
    static state (x, p, q), which each replay advances in place, and the
    step's criterion `crit`. The first step it runs is eager, on a side
    stream: it warms up every operation (the Pauli bases' upload, cuBLAS's
    workspace, the kernel's module) before the capture records them on
    that stream."""

    def __init__(self, like):
        self.state = tuple(torch.empty_like(like) for _ in range(3))
        self.graph = None
        self.crit = None

    def _store(self, values):
        for buf, v in zip(self.state, values):
            buf.copy_(v)

    def load(self, x, p, q):
        """The static state set to (x, p, q)."""
        self._store((x, p, q))
        return self.state

    def step(self, x, p, q):
        """One step from the static state (x, p, q), as `_dykstra_step`
        counts it: a replay, or the first step and the capture."""
        if self.graph is None:
            return self._capture()
        with profiling.span("qt.psd", x.device):
            self.graph.replay()
            profiling.count("launches")
        kernels._count_launch(kernels.psd_project)
        profiling.count("graph")
        return (*self.state, self.crit)

    def _capture(self):
        device = self.state[0].device
        with torch.cuda.device(device):
            main = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                *new, crit = _dykstra_step(*self.state)
                self._store(new)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the mesh's worker threads drive the other cards meanwhile
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                *new, self.crit = _dykstra_step(*self.state, cp_fn=_cp_project_recorded)
                self._store(new)
        self.graph = graph
        profiling.count("captures")
        return (*self.state, crit)


_graphs_lock = threading.Lock()
_graphs: dict = {}  # device -> (its lock, {(shape, dtype): _StepGraph}, oldest first)


@contextlib.contextmanager
def _step_graph(x):
    """The step graph of x's shape and dtype on x's card, created where there
    is none, held for one run under the card's lock: a run fills its static
    state, so two threads may not run one graph at once."""
    with _graphs_lock:
        lock, graphs = _graphs.setdefault(x.device, (threading.Lock(), collections.OrderedDict()))
    with lock:
        key = (tuple(x.shape), x.dtype)
        graph = graphs.pop(key, None) or _StepGraph(x)
        graphs[key] = graph
        while len(graphs) > GRAPHS_PER_DEVICE:
            graphs.popitem(last=False)
        yield graph


# -- model and linear inversion -----------------------------------------------


def _frequencies(counts):
    """(..., S, m, p) counts -> (..., S, K) fractions, normalized per input
    state."""
    freq = counts.reshape(tuple(counts.shape[:-2]) + (-1,))
    return freq / freq.sum(-1, keepdim=True)


def estimate_lifp(
    counts, a_matrix, cptp: bool = True, cptp_iter: int = 2000, cptp_tol: float = 1e-11
):
    """Linear-inversion process estimate on the materialized operator A.

    counts: (..., S, m, p); frequencies are normalized per input state.
    Returns the Choi bloch vector(s)."""
    counts = as_real(counts)
    freq = _frequencies(counts)
    freq = freq.reshape(tuple(freq.shape[:-2]) + (-1,))  # (..., S*K)
    rhs = freq @ a_matrix
    d2 = a_matrix.shape[-1]
    # one factorization of the Gram matrix for every right-hand side
    sol = torch.linalg.solve(a_matrix.T @ a_matrix, rhs.reshape(-1, d2).T).T
    choi_bloch = sol.reshape(rhs.shape)
    if cptp:
        choi_bloch = cptp_project_bloch(choi_bloch, cptp_iter, cptp_tol)
    return choi_bloch


def process_nll(choi_bloch, a_matrix, unnorm_counts):
    """Poisson-style NLL: -sum(n_j log(p_j + eps))."""
    probs = process_probabilities(a_matrix, choi_bloch)
    return -(unnorm_counts * torch.log(probs + _CP_EPS)).sum(-1)


def _pgdb_forward(x, b, w):
    """A x = 4^n vec(B X W^T): (..., D2) -> (..., S*K), never building A."""
    d1 = b.shape[-1]
    xm = x.reshape(tuple(x.shape[:-1]) + (d1, d1))
    p = d1 * (b @ xm @ w.T)
    return p.reshape(tuple(x.shape[:-1]) + (-1,))


def _pgdb_adjoint(y, b, w):
    """A^T y = 4^n vec(B^T Y W): (..., S*K) -> (..., D2)."""
    d1 = b.shape[-1]
    ym = y.reshape(tuple(y.shape[:-1]) + (b.shape[0], w.shape[0]))
    g = d1 * (b.T @ ym @ w)
    return g.reshape(tuple(y.shape[:-1]) + (d1 * d1,))


def process_nll_factored(choi_bloch, input_blochs_t, w_flat, unnorm_counts):
    """Process NLL with the factored measurement product: the same value as
    `process_nll` on the materialized operator, since p[s,k] = 4^n (B X
    W^T)[s,k] with B the transposed-input blochs, W the weighted flattened
    POVM rows and X the (D1, D1)-reshaped Choi bloch. `unnorm_counts`:
    flattened (S*K,) counts in the row order of `measurement_operator`.
    Batched over the leading axes of choi_bloch."""
    choi_bloch = as_real(choi_bloch)
    b = as_real(input_blochs_t, like=choi_bloch)
    w = as_real(w_flat, like=choi_bloch)
    probs = _pgdb_forward(choi_bloch, b, w)
    return -(as_real(unnorm_counts, like=choi_bloch) * torch.log(probs + _CP_EPS)).sum(-1)


def states_to_choi_bloch(output_blochs, dec):
    """Recombine per-input-state reconstructions into Choi bloch vectors.

    The 'states' method composes each single-entry matrix E_(r,c) in the
    input basis and its image in the basis of reconstructed output states
    with the same coefficients dec[e, s]; composition is linear, so

        choi[b, r*d+i, c*d+j] = sum_s dec[(r,c), s] * O[b, s, i, j]

    output_blochs: (..., S, D) reconstructed output-state bloch vectors;
    dec: (d^2, S) complex decomposition of the single entries in the input
    basis. Returns (..., D^2) real Choi bloch vectors."""
    output_blochs = as_real(output_blochs)
    dec = torch.as_tensor(
        dec, dtype=complex_dtype(output_blochs.dtype), device=output_blochs.device
    )
    d = int(round(math.sqrt(dec.shape[0])))
    n = int(round(math.log2(d)))
    o_mats = bloch_to_matrix(output_blochs, n)  # (..., S, d, d)
    batch = tuple(o_mats.shape[:-3])
    t = (dec @ o_mats.reshape(batch + (dec.shape[1], d * d))).reshape(batch + (d, d, d, d))
    # axes (r, c, i, j) -> (r, i, c, j)
    choi = t.transpose(-3, -2).reshape(batch + (d * d, d * d))
    return matrix_to_bloch(choi)


def estimate_lifp_factored(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    cptp: bool = True,
    cptp_iter: int = 2000,
    cptp_tol: float = 1e-11,
    cp: str = "eigh",
):
    """Linear-inversion process estimate without the (S*K, 16^n) operator.

    A = 4^n (B (x) W) with B the input blochs and W the weighted POVM rows,
    so its Gram splits, (A^T A) = 16^n (B^T B) (x) (W^T W), and the
    normal-equation solution is

        Choi[a, b] = (1/4^n) [(B^T B)^{-1} B^T  F  W (W^T W)^{-1}]

    with F the (S, K) frequency table. The same estimate as
    `estimate_lifp`."""
    counts = as_real(counts)
    b = as_real(input_blochs_t, like=counts)  # (S, D1)
    w = state_core.weighted_povm_flat(as_real(povm_matrix, like=counts), n_measurements)
    d1 = b.shape[-1]  # 4^n, also the probability trace scale
    freq = _frequencies(counts)  # (..., S, K)
    with profiling.span("qt.lin.solve"):
        b_pinv = torch.linalg.solve(b.T @ b, b.T)  # (D1, S)
        w_pinv = torch.linalg.solve(w.T @ w, w.T).T  # (K, D1)
        if b.is_cuda:  # each error check reads the card's info back
            profiling.count("host_sync", 2)
    choi_mat = b_pinv @ (freq @ w_pinv) / d1
    choi_bloch = choi_mat.reshape(tuple(choi_mat.shape[:-2]) + (d1 * d1,))
    if cptp:
        choi_bloch = cptp_project_bloch(choi_bloch, cptp_iter, cptp_tol, cp)
    return choi_bloch


# -- the likelihood estimators --------------------------------------------------


def _pgdb_nll(x, flat, b, w):
    """The NLL with probabilities capped at 1: exact on the CPTP set, and
    without the unbounded descent through infeasible iterates."""
    p = _pgdb_forward(x, b, w).clamp(_CP_EPS, 1.0)
    return -(flat * torch.log(p)).sum(-1)


def _capped_nll_grad(p, flat, adjoint):
    """Gradient of the capped NLL from the probabilities `p`: terms with
    p >= 1 contribute nothing."""
    c = torch.where(p < 1.0, flat / p.clamp(min=_CP_EPS), torch.zeros_like(p))
    return -adjoint(c)


_PGDB_GAMMA = 0.3


def _backtrack(nll, x, d_dir, grad):
    """Armijo halving line search, at most 30 halvings; the whole batch
    shares one step, halved while any of its members fails the test."""
    slope = (d_dir * grad).sum(-1)
    f0 = nll(x)
    alpha = torch.ones_like(f0)
    for _ in range(30):
        if not bool((nll(x + alpha[..., None] * d_dir) - f0 > _PGDB_GAMMA * alpha * slope).any()):
            break
        alpha = alpha / 2
    return alpha


def _pgd_step(x, nll, grad_of, mu: float, cptp_iter: int, cptp_tol):
    """One projected-gradient step (projection and line search) on `nll`;
    returns (x_new, the largest NLL decrease over the batch)."""
    grad = grad_of(x)
    d_dir = cptp_project_bloch(x - grad / mu, cptp_iter, cptp_tol) - x
    alpha = _backtrack(nll, x, d_dir, grad)
    x_new = x + alpha[..., None] * d_dir
    return x_new, (nll(x) - nll(x_new)).max()


def _pgd_descend(x, nll, grad_of, mu, max_iter, tol, cptp_iter, cptp_tol):
    """Projected-gradient descent from `x`: stops once the NLL decrease of a
    step, maximized over the batch, is not above `tol`. The returned iterate
    x + alpha*d is not exactly CPTP, so it is projected once more."""
    for _ in range(int(max_iter)):
        x, delta = _pgd_step(x, nll, grad_of, mu, cptp_iter, cptp_tol)
        if not float(delta) > tol:
            break
    return cptp_project_bloch(x, cptp_iter, cptp_tol)


def _factored_objective(flat, b, w):
    """(nll, gradient) of the capped NLL through the factored products."""

    def nll(x):
        return _pgdb_nll(x, flat, b, w)

    def grad_of(x):
        return _capped_nll_grad(_pgdb_forward(x, b, w), flat, lambda c: _pgdb_adjoint(c, b, w))

    return nll, grad_of


def pgdb_factored_step(x, flat, b, w, cptp_iter: int = 1000, cptp_tol=1e-10):
    """One projected-gradient step with the factored products. Returns
    (x_new, nll_decrease)."""
    return _pgd_step(x, *_factored_objective(flat, b, w), 1.5 / b.shape[-1], cptp_iter, cptp_tol)


def pgdb_prepare(counts, input_blochs_t, povm_matrix, n_measurements):
    """Shared setup of the pgdb and dys estimators: (flat frequencies
    normalized over the whole experiment, B, W, x0), x0 being the Choi bloch
    of the fully depolarizing channel."""
    counts = as_real(counts)
    b = as_real(input_blochs_t, like=counts)  # (S, D1)
    w = state_core.weighted_povm_flat(as_real(povm_matrix, like=counts), n_measurements)
    d1 = b.shape[-1]
    flat = counts.reshape(tuple(counts.shape[:-3]) + (-1,))
    flat = flat / flat.sum(-1, keepdim=True)
    x0 = counts.new_zeros(tuple(flat.shape[:-1]) + (d1 * d1,))
    x0[..., 0] = 1.0 / d1
    return flat, b, w, x0


def estimate_pgdb_factored(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    max_iter: int = 1000,
    tol: float = 1e-10,
    cptp_iter: int = 1000,
    cptp_tol: float = 1e-10,
    init_bloch=None,
):
    """Projected-gradient process MLE with factored measurement products.

    The algorithm and fixed point of `estimate_pgdb`, but the operator
    A = 4^n (B (x) W) is never materialized: with the Choi bloch x viewed
    as a (D1, D1) matrix X,

        A x   = 4^n vec(B X W^T)        (probabilities)
        A^T y = 4^n vec(B^T Y W)        (gradient pullback)

    Batched over the leading axes of `counts`. `init_bloch` starts the
    descent there instead of at the fully depolarizing channel (for
    instance at the lifp estimate)."""
    flat, b, w, x = pgdb_prepare(counts, input_blochs_t, povm_matrix, n_measurements)
    if init_bloch is not None:
        x = as_real(init_bloch, like=x).expand(x.shape)
    return _pgd_descend(
        x, *_factored_objective(flat, b, w), 1.5 / b.shape[-1], max_iter, tol, cptp_iter,
        cptp_tol,
    )


def estimate_pgdb_factored_host(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    max_iter: int = 1000,
    tol: float = 1e-10,
    cptp_iter: int = 1000,
    cptp_tol: float = 1e-10,
    init_bloch=None,
):
    """pgdb with the outer descent loop on the host, one
    `pgdb_factored_step` per iteration and the NLL decrease read between
    steps. The JAX package keeps this loop apart from its fused on-device
    `estimate_pgdb_factored` for the TPU's single-execution time cap; here
    `estimate_pgdb_factored` already runs this loop, so this is that call.
    `init_bloch` warm-starts the descent (for instance at the lifp
    estimate)."""
    return estimate_pgdb_factored(
        counts, input_blochs_t, povm_matrix, n_measurements, max_iter, tol, cptp_iter,
        cptp_tol, init_bloch,
    )


def estimate_pgdb(
    counts,
    a_matrix,
    max_iter: int = 1000,
    tol: float = 1e-10,
    cptp_iter: int = 1000,
    cptp_tol: float = 1e-10,
):
    """Projected gradient descent with backtracking on the process NLL, on
    the materialized operator A ('pgdb').

    The frequencies are normalized over the whole experiment and the step
    is mu = 1.5/4^n (arXiv:1803.10062, eq. 6); the log is capped at p = 1
    (see `_pgdb_nll`); the loop stops when the NLL decrease of a step is not
    above `tol`, and starts at the fully depolarizing channel."""
    counts = as_real(counts)
    flat = counts.reshape(tuple(counts.shape[:-3]) + (-1,))
    flat = flat / flat.sum(-1, keepdim=True)
    d2 = a_matrix.shape[-1]
    n = _n_from_d2(d2)
    x0 = counts.new_zeros(tuple(flat.shape[:-1]) + (d2,))
    x0[..., 0] = 1.0 / (4**n)

    def nll(x):
        probs = process_probabilities(a_matrix, x).clamp(_CP_EPS, 1.0)
        return -(flat * torch.log(probs)).sum(-1)

    def grad_of(x):
        return _capped_nll_grad(process_probabilities(a_matrix, x), flat, lambda c: c @ a_matrix)

    return _pgd_descend(x0, nll, grad_of, 1.5 / (4**n), max_iter, tol, cptp_iter, cptp_tol)


def dys_factored_chunk(z, flat, b, w, gamma, n_steps: int, cp: str = "eigh"):
    """`n_steps` Davis-Yin three-operator-splitting iterations.

    Solves min NLL(x) + I_CP(x) + I_TP(x) with one CP projection per
    iteration (arXiv:1504.01032):

        x_g = P_CP(z)
        x_h = P_TP(2 x_g - z - gamma * grad NLL(x_g))
        z  += x_h - x_g

    Returns (z, x_g, nll(x_g)). `cp='ns'` takes the Newton-Schulz CP
    projection: its inexactness enters the splitting additively, and the
    caller's closing Dykstra projection restores feasibility."""
    cp_fn = cp_project_bloch_ns if cp == "ns" else cp_project_bloch
    nll, grad_of = _factored_objective(flat, b, w)
    for _ in range(int(n_steps)):
        x_g = cp_fn(z)
        x_h = tp_project_bloch(2 * x_g - z - gamma * grad_of(x_g))
        z = z + (x_h - x_g)
    x_g = cp_fn(z)
    return z, x_g, nll(x_g)


def estimate_dys_factored(
    counts,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    max_iter: int = 10000,
    tol: float | None = None,
    chunk: int | None = None,
    gamma: float | None = None,
    init_bloch=None,
    cp: str | None = None,
):
    """Process MLE by Davis-Yin splitting with factored products: the
    constrained optimum of pgdb with one CP projection per iteration
    instead of a Dykstra loop per gradient step.

    The NLL, maximized over the batch, is read every `chunk` iterations,
    and the loop stops when its decrease over a chunk is not above
    `tol * chunk` (`tol` default: 1e-13 in float64, 1e-9 in float32).
    `chunk` defaults to 500 below 5 qubits; from 5 qubits up to 200 with
    'eigh', and with 'ns' to 500 at 5 qubits and 20 above. `gamma` is the
    splitting step (default 0.5/4^n). `cp` selects the CP engine; the
    default is 'ns' from 5 qubits up and 'eigh' below. A closing Dykstra
    projection of 200 iterations squares away the TP residual."""
    flat, b, w, x0 = pgdb_prepare(counts, input_blochs_t, povm_matrix, n_measurements)
    d1 = b.shape[-1]
    big = d1 >= 1024  # 5+ qubits
    if cp is None:
        cp = "ns" if big else "eigh"
    if chunk is None:
        if cp == "ns":
            chunk = 500 if d1 <= 1024 else 20
        else:
            chunk = 200 if big else 500
    if gamma is None:
        gamma = 0.5 / d1
    if tol is None:
        tol = 1e-13 if flat.dtype == torch.float64 else 1e-9
    z = as_real(init_bloch, like=x0).expand(x0.shape) if init_bloch is not None else x0
    last_nll = math.inf
    x_g = z
    for _ in range(0, max_iter, chunk):
        z, x_g, nll = dys_factored_chunk(z, flat, b, w, gamma, chunk, cp)
        nll_now = float(nll.max())
        if last_nll - nll_now <= tol * chunk:
            break
        last_nll = nll_now
    if big:
        return cptp_project_bloch_host(x_g, max_iter=200, cp="ns")
    return cptp_project_bloch(x_g, 200)


# -- the likelihood-sampling (MHMC) part ---------------------------------------


def _dykstra_step_diff(xm, pm, qm, ns_iter: int):
    """One matrix-space Dykstra step with the Newton-Schulz CP projection."""
    s = xm + pm
    y = _tp_project_mat(s)
    t = y + qm
    xm_new = _ns_psd_mat(t, ns_iter)
    return xm_new, s - y, t - xm_new


class _RecomputedDykstraStep(torch.autograd.Function):
    """`_dykstra_step_diff` whose backward pass recomputes the step from its
    inputs instead of keeping the ns_iter sign iterations' products."""

    @staticmethod
    def forward(ctx, xm, pm, qm, ns_iter):
        ctx.ns_iter = ns_iter
        ctx.save_for_backward(xm, pm, qm)
        return _dykstra_step_diff(xm, pm, qm, ns_iter)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outputs = _dykstra_step_diff(*inputs, ctx.ns_iter)
        return (*torch.autograd.grad(outputs, inputs, grads), None)


def cptp_project_bloch_diff(choi_bloch, n_steps: int = 100, ns_iter: int = 19):
    """Fixed-length, reverse-differentiable CPTP projection: `n_steps`
    matrix-space Dykstra iterations with the Newton-Schulz CP engine (the
    'ns' branch of `cptp_project_bloch` without its stop criterion), so
    that autograd flows through it. The MALA drift of the projected-
    likelihood process target needs it. The backward pass recomputes each
    Dykstra step from its inputs (the JAX package checkpoints the step)."""
    x = as_real(choi_bloch)
    n2 = 2 * _n_from_d2(x.shape[-1])
    xm = bloch_to_matrix(x, n2)
    pm = torch.zeros_like(xm)
    qm = torch.zeros_like(xm)
    for _ in range(int(n_steps)):
        xm, pm, qm = _RecomputedDykstraStep.apply(xm, pm, qm, ns_iter)
    return matrix_to_bloch(xm)


def _mh(a):
    return a.conj().transpose(-1, -2)


def _trace_out(g, d_in: int):
    """Tr_out of (..., D, D) matrices, D = d_in * d_out, input factor
    first."""
    d_out = g.shape[-1] // d_in
    g4 = g.reshape(tuple(g.shape[:-2]) + (d_in, d_out, d_in, d_out))
    return torch.diagonal(g4, dim1=-3, dim2=-1).sum(-1)


def kraus_param_to_choi_bloch(y):
    """Smooth, surjective, exactly TP parametrization of CPTP Choi
    matrices, the projection-free route for MCMC over processes.

    `y`: real (..., 2, D, D) re/im pair of a complex factor M, D = 4^n the
    Choi dimension. With G = M M^H, rho = Tr_out G = L L^H (Cholesky, with a
    relative 1e-9 ridge), the Choi matrix is

        X = (L^{-1} (x) I_out) G (L^{-H} (x) I_out),

    so Tr_out X = I exactly and X is PSD. Returns real Choi bloch vectors
    (..., D^2); differentiable by autograd."""
    y = as_real(y)
    return _kraus_m_to_choi_bloch(torch.complex(y[..., 0, :, :], y[..., 1, :, :]))


def _cholesky(a):
    """Lower Cholesky factors of a batch, without a host read: a factor
    whose factorization failed is NaN, so a target built on it is NaN and a
    chain rejects the proposal, as the JAX package's NaN factor does."""
    l_chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.full_like(l_chol, math.nan), l_chol)


def _kraus_m_to_choi_bloch(m):
    """Complex-matrix core of :func:`kraus_param_to_choi_bloch`."""
    d = m.shape[-1]
    d_in = int(round(math.sqrt(d)))
    g = m @ _mh(m)
    rho = _trace_out(g, d_in)
    tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
    eye = torch.eye(d_in, dtype=rho.dtype, device=rho.device)
    lam = (1e-9 * tr / d_in + 1e-30).to(rho.dtype)
    l_chol = _cholesky(rho + lam[..., None, None] * eye)
    m_rows = m.reshape(tuple(m.shape[:-2]) + (d_in, d_in * d))
    n_mat = torch.linalg.solve_triangular(l_chol, m_rows, upper=False).reshape(m.shape)
    return matrix_to_bloch(n_mat @ _mh(n_mat))


def _complex_like(a, like):
    """`a` (array or tensor) as a complex tensor of `like`'s precision on
    its device; a tensor already there is returned as it is."""
    return torch.as_tensor(a, dtype=complex_dtype(like.dtype), device=like.device)


def kraus_param_to_choi_bloch_whitened(z, a_l, a_r):
    """Whitened-coordinate kraus decode: M = A_L Z A_R, then the kraus map.
    `z`: real (..., 2, D, D) re/im chain state; `a_l`, `a_r`: the complex
    whitening matrices of :func:`kraus_design_whitener` (arrays or
    tensors)."""
    z = as_real(z)
    m0 = torch.complex(z[..., 0, :, :], z[..., 1, :, :])
    return _kraus_m_to_choi_bloch(_complex_like(a_l, z) @ m0 @ _complex_like(a_r, z))


def kraus_design_whitener(
    input_blochs_t,
    w_flat,
    flat_counts,
    choi_bloch_hat,
    ridge: float = 1e-6,
    x_floor: float = 1e-2,
):
    """M-space curvature whitener for kraus-parametrized process chains,
    host float64.

    The NLL's Gauss-Newton form in the factor M (X ~ M M^H, rows
    p_k = Tr(A_k X), A_k = rho_s^T (x) E_o) is bounded by two structured
    averages: on the left index the measured-operator Gram G_B (x) G_W with
    G_B = sum_s u_s (rho_s^T)^2 and G_W = sum_o v_o E_o^2 (the rank-1 weight
    fit c_k / p_k^2 ~ u_s v_o of :func:`kron_fisher_whitener`), and on the
    right index the estimate X_hat, floored at `x_floor * tr(X)/D`.
    Sampling Z with M = A_L Z A_R, A_L = (G_B (x) G_W)^{-1/2} and
    A_R = (X_hat + eps I)^{-1/2}, runs the chain in about isotropic
    curvature coordinates. Returns complex (a_l, a_r, a_l_inv, a_r_inv);
    the start is z0 = a_l_inv M0 a_r_inv."""
    b = np.asarray(input_blochs_t, dtype=np.float64)
    w = np.asarray(w_flat, dtype=np.float64)
    d1 = b.shape[-1]
    n = int(round(math.log(d1, 4)))
    c = np.asarray(flat_counts, dtype=np.float64).reshape(b.shape[0], -1)
    x_hat = np.asarray(choi_bloch_hat, dtype=np.float64).reshape(d1, d1)
    p_hat = d1 * (b @ x_hat @ w.T)
    floor = 0.5 / max(float(c.sum(axis=-1).max()), 1.0)
    p_hat = np.maximum(p_hat, floor)
    r = c / (p_hat * p_hat)
    total = float(r.sum())
    u = r.sum(axis=1)
    v = r.sum(axis=0) / max(total, 1e-30)
    rho_mats = np_bloch_to_matrix(b, n)
    e_mats = np_bloch_to_matrix(w, n)
    g_b = np.einsum("s,sij,sjk->ik", u, rho_mats, rho_mats)
    g_w = np.einsum("o,oij,ojk->ik", v, e_mats, e_mats)

    def _sqrt_pair(g, lam):
        evals, evecs = np.linalg.eigh(g)
        evals = np.clip(evals, 0.0, None) + lam
        inv_s = (evecs / np.sqrt(evals)) @ evecs.conj().T
        s = (evecs * np.sqrt(evals)) @ evecs.conj().T
        return inv_s, s

    inv_b, sq_b = _sqrt_pair(g_b, ridge * np.trace(g_b).real / g_b.shape[0])
    inv_w, sq_w = _sqrt_pair(g_w, ridge * np.trace(g_w).real / g_w.shape[0])
    x_mat = np_bloch_to_matrix(choi_bloch_hat, 2 * n)
    a_r, a_r_inv = _sqrt_pair(x_mat, x_floor * np.trace(x_mat).real / d1)
    return np.kron(inv_b, inv_w), a_r, np.kron(sq_b, sq_w), a_r_inv


def np_kraus_param_from_choi_bloch(choi_bloch):
    """Host inverse of :func:`kraus_param_to_choi_bloch` at a CPTP point:
    the Hermitian square root M = X^{1/2} (eigenvalues clipped at 0) as a
    real (2, D, D) re/im pair. At a CPTP X, rho = Tr_out X = I, so the map
    takes this M back to X."""
    choi_bloch = np.asarray(choi_bloch, dtype=np.float64)
    x = np_bloch_to_matrix(choi_bloch, 2 * _n_from_d2(choi_bloch.shape[-1]))
    w, v = np.linalg.eigh(x)
    w = np.sqrt(np.clip(w, 0.0, None))
    m = (v * w[..., None, :]) @ np.swapaxes(v.conj(), -1, -2)
    return np.stack([m.real, m.imag], axis=-3)


def np_kraus_anchor_pack(z_ref, a_l=None, a_r=None):
    """Host float64 anchor constants for the anchored exact-delta kraus
    decode (:func:`kraus_delta_choi_bloch`).

    The chain state is the offset dz = z - z_ref from the anchor, and the
    decode writes every state-dependent quantity as an exact function of
    dz, never as a difference of two full-size float32 results: the
    rounding then scales with the posterior-sized |dX| instead of |X|. With
    U0 = L_ref^{-1} (x) I and E' = (L^{-1} - L_ref^{-1}) (x) I:

        dM    = A_L dz A_R
        dG    = M_ref dM^H + dM M_ref^H + dM dM^H
        A     = L_ref^{-1} (Tr_out dG + ridge delta) L_ref^{-H}
        L     = L_ref (I + S),  S + S^H + S S^H = A
        E     = -S (I + S)^{-1} L_ref^{-1}
        dX    = U dG U^H + E' C_ref + (E' C_ref)^H + E' G_ref E'^H,
                U = L^{-1} (x) I,  C_ref = G_ref (L_ref^{-H} (x) I)

    At dz = 0 every term is exactly zero. `z_ref`: complex (D, D) whitened
    anchor; `a_l`, `a_r`: the whitening matrices (None: identity).
    Returns (pack, x_ref_bloch): `pack` a dict of complex128 arrays (bind it
    to the chain's device and precision once with `anchor_pack_to`), and
    the float64 anchor Choi bloch."""
    z_ref = np.asarray(z_ref, dtype=np.complex128)
    d = z_ref.shape[-1]
    d_in = int(round(math.sqrt(d)))
    eye = np.eye(d, dtype=np.complex128)
    a_l = eye if a_l is None else np.asarray(a_l, dtype=np.complex128)
    a_r = eye if a_r is None else np.asarray(a_r, dtype=np.complex128)
    m_ref = a_l @ z_ref @ a_r
    g_ref = m_ref @ m_ref.conj().T
    rho = np.einsum("ibjb->ij", g_ref.reshape(d_in, d_in, d_in, d_in))
    tr = float(np.trace(rho).real)
    lam = 1e-9 * tr / d_in + 1e-30
    l_ref = np.linalg.cholesky(rho + lam * np.eye(d_in))
    l_ref_inv = np.linalg.solve(l_ref, np.eye(d_in))
    t = (l_ref_inv @ g_ref.reshape(d_in, d_in * d)).reshape(d, d)
    x_ref = (l_ref_inv @ t.conj().T.reshape(d_in, d_in * d)).reshape(d, d).conj().T
    c_ref = (l_ref_inv @ g_ref.conj().T.reshape(d_in, d_in * d)).reshape(d, d).conj().T
    pack = {
        "a_l": a_l,
        "a_r": a_r,
        "m_ref": m_ref,
        "g_ref": g_ref,
        "c_ref": c_ref,
        "l_ref_inv": l_ref_inv,
        "z_ref": z_ref,
    }
    return pack, np_matrix_to_bloch(x_ref)


def anchor_pack_to(pack, like):
    """The anchor constants as complex tensors of `like`'s precision on its
    device."""
    return {k: _complex_like(v, like) for k, v in pack.items()}


def _apply_left_factor(mat, y, d_in: int):
    """(mat (x) I) y for y (..., D, D), mat (..., d_in, d_in),
    D = d_in * d_out: mat acts on the first row-index factor (the Choi
    input space)."""
    d = y.shape[-1]
    rows = y.reshape(tuple(y.shape[:-2]) + (d_in, (d // d_in) * d))
    return (mat @ rows).reshape(y.shape)


def kraus_delta_choi_bloch(dz_pair, pack, s_iters: int = 12):
    """Anchored exact-delta decode: the Choi bloch offset dX from the anchor
    of the whitened chain offset dz, X = X_ref + dX (see
    :func:`np_kraus_anchor_pack` for the algebra).

    `dz_pair`: real (..., 2, D, D) re/im pair of Z - Z_ref; `pack`: the
    anchor constants (arrays, or tensors from `anchor_pack_to`). The
    factor chol(I + A) - I is a fixed `s_iters`-step contraction
    S <- Phi(A - S S^H) where max|A| < 0.25 (the posterior bulk), and the
    direct Cholesky elsewhere; each branch runs on a zeroed stand-in where
    it is not selected, so neither leaks NaN into the other or into its
    gradient. Differentiable by autograd."""
    dz_pair = as_real(dz_pair)
    dz = torch.complex(dz_pair[..., 0, :, :], dz_pair[..., 1, :, :])
    c = {k: _complex_like(v, dz_pair) for k, v in pack.items()}
    l_ref_inv = c["l_ref_inv"]
    d_in = l_ref_inv.shape[-1]
    eye = torch.eye(d_in, dtype=dz.dtype, device=dz.device)

    dm = c["a_l"] @ dz @ c["a_r"]
    dmh = _mh(dm)
    dg = c["m_ref"] @ dmh + dm @ _mh(c["m_ref"]) + dm @ dmh
    drho = _trace_out(dg, d_in)
    # the delta of the plain decode's ridge 1e-9 * tr(rho) / d_in
    dtr = torch.diagonal(drho, dim1=-2, dim2=-1).sum(-1).real
    drho = drho + (1e-9 * dtr / d_in).to(drho.dtype)[..., None, None] * eye
    a = l_ref_inv @ drho @ _mh(l_ref_inv)

    def phi(h):
        return torch.tril(h, -1) + 0.5 * eye * h

    small = a.abs().amax(dim=(-2, -1))[..., None, None] < 0.25
    a_h = 0.5 * (a + _mh(a))
    zeros = torch.zeros_like(a_h)
    a_it = torch.where(small, a_h, zeros)
    a_ch = torch.where(small, zeros, a_h)
    s_it = phi(a_it)
    for _ in range(int(s_iters)):
        s_it = phi(a_it - s_it @ _mh(s_it))
    s_ch = _cholesky(eye + a_ch) - eye
    s = torch.where(small, s_it, s_ch)
    # L^{-1} = (I + S)^{-1} L_ref^{-1};  E = -S (I + S)^{-1} L_ref^{-1}
    l_inv = torch.linalg.solve_triangular(
        eye + s, l_ref_inv.expand(s.shape), upper=False
    )
    e = -(s @ l_inv)
    t1 = _apply_left_factor(l_inv, dg, d_in)
    t1 = _mh(_apply_left_factor(l_inv, _mh(t1), d_in))
    t2 = _apply_left_factor(e, c["c_ref"].expand(dz.shape), d_in)
    t4 = _apply_left_factor(e, c["g_ref"].expand(dz.shape), d_in)
    t4 = _mh(_apply_left_factor(e, _mh(t4), d_in))
    return matrix_to_bloch(t1 + t2 + _mh(t2) + t4)


def _rel_nll_from_dp(dp, unnorm_counts, p_ref):
    """-sum n log1p(dp / p_ref), the shared reduction of the anchored and
    relative NLLs, in float64 (the card's native double) whatever the
    chain's dtype, returned in dp's dtype.

    The JAX package runs it in double-float f32 arithmetic because the
    TPU's f32 divide and log1p are a few ulp off and the count-weighted sum
    amplifies that (+-3.6 at 4 qubits on the TPU); float64 carries ~1e-16 relative
    per element. `unnorm_counts` and `p_ref` are best bound as float64
    tensors on dp's device once (`torch.as_tensor` passes them through)."""
    f64 = torch.float64
    p = torch.as_tensor(p_ref, dtype=f64, device=dp.device).clamp(min=_CP_EPS)
    n = torch.as_tensor(unnorm_counts, dtype=f64, device=dp.device)
    ratio = (dp.to(f64) / p).clamp(min=-1.0 + 1e-7)
    return (-(n * torch.log1p(ratio)).sum(-1)).to(dp.dtype)


def _delta_probs(dm, b, w):
    """dp = D1 * B dM W^T for (..., D1, D1) offsets, flattened (..., S*K)."""
    dp = b.shape[-1] * (b @ dm @ w.T)
    return dp.reshape(tuple(dm.shape[:-2]) + (-1,))


def process_nll_anchored(dz_flat, input_blochs_t, w_flat, unnorm_counts, pack, p_ref,
                         s_iters: int = 12):
    """Anchored delta-form process NLL of the kraus chains, NLL(X(z)) -
    NLL(X_ref), without ever forming the full-size X: dp = D B dX W^T runs
    on the exact delta of :func:`kraus_delta_choi_bloch`. `dz_flat`:
    (..., 2*D*D) flattened re/im offset Z - Z_ref; `p_ref`: the anchor's
    probabilities (S*K,)."""
    dz_flat = as_real(dz_flat)
    b = as_real(input_blochs_t, like=dz_flat)
    w = as_real(w_flat, like=dz_flat)
    d1 = b.shape[-1]
    d = int(round(math.sqrt(dz_flat.shape[-1] // 2)))
    dbloch = kraus_delta_choi_bloch(
        dz_flat.reshape(tuple(dz_flat.shape[:-1]) + (2, d, d)), pack, s_iters
    )
    dm = dbloch.reshape(tuple(dbloch.shape[:-1]) + (d1, d1))
    return _rel_nll_from_dp(_delta_probs(dm, b, w), unnorm_counts, p_ref)


def process_nll_factored_rel(choi_bloch, input_blochs_t, w_flat, unnorm_counts, x_ref_bloch,
                             p_ref):
    """Process NLL relative to an anchor, in delta form:
    -sum n log1p(dp / p_ref) with dp = D B (X - X_ref) W^T. The same as
    :func:`process_nll_factored` less a constant, so every acceptance
    ratio is unchanged; the delta form keeps the float32 target's rounding
    at the size of the offset. `p_ref` = D B X_ref W^T (S*K,)."""
    choi_bloch = as_real(choi_bloch)
    b = as_real(input_blochs_t, like=choi_bloch)
    w = as_real(w_flat, like=choi_bloch)
    d1 = b.shape[-1]
    delta = choi_bloch - as_real(x_ref_bloch, like=choi_bloch)
    dm = delta.reshape(tuple(delta.shape[:-1]) + (d1, d1))
    return _rel_nll_from_dp(_delta_probs(dm, b, w), unnorm_counts, p_ref)


def kron_fisher_whitener(input_blochs_t, w_flat, flat_counts, choi_bloch_hat,
                         ridge: float = 1e-4):
    """Kronecker-factored Gauss-Newton whitener of the process NLL at a
    point estimate (K-FAC for the bilinear design), host float64.

    p[s, k] = D1 (B X W^T)[s, k], so the Gauss-Newton matrix is
    D1^2 sum r[s,k] (b_s b_s^T) (x) (w_k w_k^T) with r = c / p_hat^2; the
    rank-1 fit r ~ u v / sum(r) makes it F_B (x) F_W with F_B = B^T diag(u) B
    and F_W = W^T diag(v) W. Each factor gets a relative ridge
    `ridge * tr(F) / D1` before its Cholesky F = L L^T. Returns
    (a_b, a_w, l_b, l_w): the chain runs in z = (L_B^T (x) L_W^T) x and
    maps back by x = (A_B (x) A_W) z with A = L^{-T}."""
    from scipy.linalg import solve_triangular

    b = np.asarray(input_blochs_t, dtype=np.float64)
    w = np.asarray(w_flat, dtype=np.float64)
    d1 = b.shape[-1]
    c = np.asarray(flat_counts, dtype=np.float64).reshape(b.shape[0], -1)
    x_hat = np.asarray(choi_bloch_hat, dtype=np.float64).reshape(d1, d1)
    p_hat = d1 * (b @ x_hat @ w.T)
    # floor at half a count of the busiest row: a boundary estimate
    # (p_hat ~ 0 where c > 0) cannot blow up one weight
    floor = 0.5 / max(float(c.sum(axis=-1).max()), 1.0)
    p_hat = np.maximum(p_hat, floor)
    r = c / (p_hat * p_hat)
    total = float(r.sum())
    if total <= 0.0:  # no counts: the identity metric
        eye = np.eye(d1)
        return eye, eye, eye, eye
    u = r.sum(axis=1)
    v = r.sum(axis=0) / total
    out = []
    for f in ((b * u[:, None]).T @ b, (w * v[:, None]).T @ w):
        lam = ridge * float(np.trace(f)) / d1
        l_f = np.linalg.cholesky(f + lam * np.eye(d1))
        out.append((solve_triangular(l_f, np.eye(d1), lower=True).T, l_f))
    (a_b, l_b), (a_w, l_w) = out
    return a_b, a_w, l_b, l_w
