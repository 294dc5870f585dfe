"""ProcessTomograph (port of quantpy_tpu/tomography/process.py).

Construction from a channel and a set of input states that spans the
operator space, one StateTomograph per input state, `experiment` (with
`warm_start`), `results` get and set, `point_estimate('lifp' | 'pgdb' |
'dys' | 'states')` with optional CPTP projection, and the projections
`cptp_projection`, `tp_projection`, `cp_projection`.

The numerics live in `process_core` (Choi bloch representation); this class
is the host layer. The designs and counts are float64 numpy arrays;
computation runs on the tomograph's `device` in its `dtype`, with
randomness from its own `torch.Generator`, which its inner tomographs
share.
"""

from __future__ import annotations

import numpy as np
import torch

from ..basis import Basis
from ..channel import Channel
from ..config import get_device, rdtype
from ..measurements import _single_qubit_preset, generate_measurement_matrix
from ..ops.geometry import resolve_distance
from ..qobj import Qobj
from ..routines import generate_single_entries
from . import process_core, state_core
from .state import StateTomograph, make_generator

__all__ = ["ProcessTomograph"]


def _generate_input_states(input_states, n_qubits: int):
    """Input states from a preset name or an explicit list."""
    if isinstance(input_states, (list, tuple)):
        return [s if isinstance(s, Qobj) else Qobj(s) for s in input_states]
    blochs = np.squeeze(generate_measurement_matrix(input_states, n_qubits))
    states = []
    for b in np.atleast_2d(blochs):
        q = Qobj(b)
        states.append(q / complex(q.trace()).real)
    return states


class ProcessTomograph:
    """Simulate process-tomography experiments and reconstruct channels.

    Parameters
    ----------
    channel : Channel
    input_states : str or list, default='proj4'
        Must form a basis of the operator space (4^n elements).
    dst : str or callable, default='hs'
    key : int seed or torch.Generator, optional
        Randomness source for simulations (default: seed 0).
    device : torch device, optional
        Where the computation runs (default: `config.get_device()`).
    dtype : torch.float32 or torch.float64, optional
        Working precision (default: `config.rdtype()`).
    """

    #: from this qubit count on, the CPTP projection of 'lifp' and 'dys'
    #: runs the Newton-Schulz engine, with its criterion read every 100
    #: iterations (`process_core.cptp_project_bloch_host`)
    BIG_N_QUBITS = 5

    def __init__(
        self, channel, input_states="proj4", dst="hs", key=None, device=None, dtype=None
    ):
        self.channel = channel
        self.dst = resolve_distance(dst)
        self.device = torch.device(device) if device is not None else get_device()
        self.dtype = dtype or rdtype()
        self.input_states = input_states
        # single-qubit factor of a preset input-state basis (the full basis
        # is its tensor power), for the factored analytic intervals
        self._states1_t = (
            np.stack([s.T.bloch for s in _generate_input_states(input_states, 1)])
            if isinstance(input_states, str)
            else None
        )
        self.input_basis = Basis(_generate_input_states(input_states, channel.n_qubits))
        if self.input_basis.dim != 4**channel.n_qubits:
            raise ValueError("Input states do not constitute a basis")
        dim = 2**channel.n_qubits
        # decomposition of every single-entry matrix in the input basis, for
        # the 'states' method
        self._decomposed_single_entries = self.input_basis.decompose_batch(
            np.stack(generate_single_entries(dim))
        )
        self.generator = make_generator(0 if key is None else key, self.device)
        self.tomographs: list[StateTomograph] | None = None

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- experiment -----------------------------------------------------------

    def _new_tomographs(self):
        return [
            StateTomograph(
                self.channel.transform(s), key=self.generator, device=self.device,
                dtype=self.dtype,
            )
            for s in self.input_basis.elements
        ]

    def experiment(self, n_measurements, povm="proj-set", warm_start: bool = False):
        """State tomography of every transformed input state, all drawn in
        one call. warm_start=True merges the new POVM block with the
        previous one, reweighting rows by shot counts."""
        n = self.channel.n_qubits
        povm_matrix = generate_measurement_matrix(povm, n)
        # single-qubit POVM factor, for the factored analytic intervals
        if isinstance(povm, str):
            self._povm1 = _single_qubit_preset(povm)
        elif isinstance(povm, np.ndarray) and povm.shape[-1] == 4 and n > 1:
            self._povm1 = povm if povm.ndim == 3 else povm[None]
        else:
            self._povm1 = None
        n_povms = povm_matrix.shape[0]
        if np.issubdtype(type(n_measurements), np.integer):
            n_measurements = np.full(n_povms, n_measurements, dtype=np.float64)
        else:
            n_measurements = np.asarray(n_measurements, dtype=np.float64)

        if not warm_start or self.tomographs is None:
            self.tomographs = self._new_tomographs()
        out_blochs = np.stack([t.state.bloch for t in self.tomographs])
        counts = process_core.simulate_process_experiment(
            self.generator, self._tensor(povm_matrix), self._tensor(out_blochs),
            self._tensor(n_measurements),
        )
        counts = counts.cpu().numpy().astype(np.float64)
        for tmg, c in zip(self.tomographs, counts):
            if warm_start and tmg.results is not None:
                self._povm1 = None  # merged designs are no tensor power
                prev_total = float(np.sum(tmg.n_measurements))
                new_total = float(np.sum(n_measurements))
                tmg.povm_matrix = np.vstack(
                    [tmg.povm_matrix * prev_total, povm_matrix * new_total]
                ) / (prev_total + new_total)
                tmg.n_measurements = np.concatenate([tmg.n_measurements, n_measurements])
                tmg._results = np.vstack([tmg._results, c])
            else:
                tmg.povm_matrix = np.asarray(povm_matrix, dtype=np.float64)
                tmg.n_measurements = n_measurements
                tmg._results = c

    # -- results access ---------------------------------------------------------

    @property
    def results(self):
        if self.tomographs is None:
            raise RuntimeError("No results: run `experiment` first")
        return np.stack([t.results for t in self.tomographs])

    @results.setter
    def results(self, results):
        if self.tomographs is None:
            raise RuntimeError("Run `experiment` first to fix the design")
        for tmg, r in zip(self.tomographs, results):
            tmg.results = r

    # -- estimation ---------------------------------------------------------------

    def _input_blochs_t(self) -> np.ndarray:
        """(S, 4^n) bloch vectors of transposed input states."""
        return np.stack([s.T.bloch for s in self.input_basis.elements])

    def _design(self):
        """(counts, input_blochs_t, povm_matrix, n_measurements) as tensors
        on the tomograph's device."""
        t0 = self.tomographs[0]
        return tuple(
            self._tensor(x)
            for x in (self.results, self._input_blochs_t(), t0.povm_matrix, t0.n_measurements)
        )

    def _measurement_operator(self):
        return process_core.measurement_operator(*self._design()[1:])

    def _as_channel(self, choi_bloch) -> Channel:
        return Channel(Qobj(choi_bloch.cpu().numpy().astype(np.float64)))

    def point_estimate(
        self,
        method: str = "lifp",
        cptp: bool = True,
        n_iter: int | None = None,
        tol: float = 1e-10,
        states_est_method: str = "lin",
        states_physical: bool = True,
        states_init: str = "lin",
    ) -> Channel:
        """Reconstruct the Choi matrix.

        'lifp': bloch-space linear inversion (+ optional CPTP projection)
        'pgdb': projected gradient descent on the NLL, stopping when the
                NLL decrease of a step falls under `tol`; from 4 qubits up
                it starts at the lifp estimate
        'dys':  Davis-Yin three-operator splitting on the same CPTP MLE,
                one CP projection per iteration, started at the lifp
                estimate
        'states': per-output-state reconstruction recombined through the
                input basis

        `n_iter=None` is the per-method budget (pgdb and states: 1000; dys:
        10000 with an NLL-plateau stop); an explicit integer is taken as
        given. Returns a Channel and keeps it as `reconstructed_channel`.
        """
        if self.tomographs is None or self.tomographs[0].results is None:
            raise RuntimeError("Run `experiment` or set `results` first")
        if n_iter is not None:
            n_iter = max(int(n_iter), 1)
        n = self.channel.n_qubits
        big = n >= self.BIG_N_QUBITS
        cptp_tol = self._cptp_tol(tol)
        if method == "lifp":
            choi_bloch = process_core.estimate_lifp_factored(
                *self._design(), cptp=cptp and not big, cptp_tol=cptp_tol
            )
            if cptp and big:
                choi_bloch = process_core.cptp_project_bloch_host(
                    choi_bloch, tol=cptp_tol, cp="ns"
                )
        elif method == "dys":
            design = self._design()
            init = process_core.estimate_lifp_factored(
                *design, cptp=not big, cptp_tol=cptp_tol
            )
            if big:
                # a start only needs rough feasibility: 200 iterations
                init = process_core.cptp_project_bloch_host(
                    init, max_iter=200, tol=cptp_tol, cp="ns"
                )
            choi_bloch = process_core.estimate_dys_factored(
                *design, max_iter=10000 if n_iter is None else n_iter, init_bloch=init
            )
        elif method == "pgdb":
            design = self._design()
            init = None
            if n >= 4:
                init = process_core.estimate_lifp_factored(
                    *design, cptp=True, cptp_tol=cptp_tol
                )
            choi_bloch = process_core.estimate_pgdb_factored(
                *design, max_iter=1000 if n_iter is None else n_iter, tol=tol,
                init_bloch=init,
            )
        elif method == "states":
            self.reconstructed_channel = self._estimate_states(
                cptp, states_est_method, states_physical, states_init, n_iter, tol
            )
            return self.reconstructed_channel
        else:
            raise ValueError("Incorrect value for argument `method`")
        self.reconstructed_channel = self._as_channel(choi_bloch)
        return self.reconstructed_channel

    def _estimate_states(self, cptp, method, physical, init, n_iter, tol) -> Channel:
        """'states': reconstruct every output state in one batched call,
        then recombine the single-entry decompositions through the basis of
        the reconstructed output states."""
        counts, _, povm, n_meas = self._design()
        blochs = state_core.estimate(
            counts, povm, n_meas,
            method=method,
            physical=physical,
            init=init,
            max_iter=100 if method == "lin" else (1000 if n_iter is None else n_iter),
            tol=tol if method != "lin" else 1e-3,
        )
        output_states = [Qobj(b) for b in blochs.cpu().numpy().astype(np.float64)]
        for tmg, q in zip(self.tomographs, output_states):
            tmg.reconstructed_state = q
        output_basis = Basis(output_states)
        dim = 2**self.channel.n_qubits
        choi = np.zeros((dim * dim, dim * dim), dtype=np.complex128)
        for dec in self._decomposed_single_entries:
            e_in = self.input_basis.compose(dec)
            e_out = output_basis.compose(dec)
            choi += np.kron(e_in.matrix, e_out.matrix)
        channel = Channel(Qobj(choi))
        if cptp and not channel.is_cptp(verbose=False):
            channel = self.cptp_projection(channel, tol=self._cptp_tol(1e-12))
        return channel

    # -- projections ----------------------------------------------------------------

    def _cptp_tol(self, tol: float) -> float:
        """The Dykstra tolerance floored at the precision of the
        tomograph's dtype (`process_core.default_cptp_tol`)."""
        return process_core.default_cptp_tol(tol, self.dtype)

    def cptp_projection(self, channel: Channel, n_iter: int = 1000, tol=1e-12):
        """Project a channel onto CPTP space (Dykstra)."""
        return self._as_channel(
            self._cptp_projection_vec(self._tensor(channel.choi.bloch), n_iter, tol)
        )

    def _cptp_projection_vec(self, choi_bloch, n_iter: int = 1000, tol=1e-12, cp: str = "eigh"):
        """CPTP projection of Choi bloch vectors; `cp` selects the CP
        engine ('eigh' or 'ns', see `process_core.cptp_project_bloch`)."""
        return process_core.cptp_project_bloch(
            self._tensor(choi_bloch), n_iter, self._cptp_tol(tol), cp
        )

    def _projected(self, project, channel, vectorized):
        out = project(self._tensor(channel.choi.bloch)).cpu().numpy().astype(np.float64)
        return out if vectorized else Channel(Qobj(out))

    def tp_projection(self, channel: Channel, vectorized: bool = False):
        """Projection onto trace-preserving maps."""
        return self._projected(process_core.tp_project_bloch, channel, vectorized)

    def cp_projection(self, channel: Channel, vectorized: bool = False):
        """Projection onto completely positive maps."""
        return self._projected(process_core.cp_project_bloch, channel, vectorized)

    def _cptp_update_rule(self, x_t, delta, step):
        """The proposal of the likelihood-sampling intervals: the CPTP
        projection (100 Dykstra iterations) of x + step * delta, on Choi
        bloch vectors; from 4 qubits up on the Newton-Schulz engine."""
        cp = "ns" if self.channel.n_qubits >= 4 else "eigh"
        return self._cptp_projection_vec(
            self._tensor(x_t) + step * self._tensor(delta), n_iter=100, cp=cp
        )

    def _nll(self, choi_bloch):
        """Process NLL of Choi bloch vectors under the current data, through
        the factored product."""
        t0 = self.tomographs[0]
        w = state_core.weighted_povm_flat(
            self._tensor(t0.povm_matrix), self._tensor(t0.n_measurements)
        )
        flat = np.concatenate([t.flat_results for t in self.tomographs])
        return process_core.process_nll_factored(
            self._tensor(choi_bloch), self._tensor(self._input_blochs_t()), w, self._tensor(flat)
        )
