"""StateTomograph (port of quantpy_tpu/tomography/state.py, dense path).

`experiment` (with `warm_start`), the `results` setter for measured data,
`point_estimate('lin' | 'mle-rhor')`, and the batch API
(`simulate_batch`, `estimate_batch`). The design and the counts are kept as
float64 numpy arrays, as in the JAX package; computation runs on the
tomograph's `device` in its `dtype`, with randomness from its own
`torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import get_device, rdtype
from ..measurements import _single_qubit_preset, generate_measurement_matrix
from ..ops.geometry import resolve_distance
from ..qobj import Qobj
from . import state_core

__all__ = ["StateTomograph"]


def _uniform_shots(n_measurements):
    """A scalar shot count as float, or None if `n_measurements` is not a
    scalar integer (integral floats count as integers)."""
    if np.issubdtype(type(n_measurements), np.integer):
        return float(n_measurements)
    if isinstance(n_measurements, float) and n_measurements.is_integer():
        return n_measurements
    return None


def make_generator(key, device) -> torch.Generator:
    """`key` itself if it is a torch.Generator, else a generator on `device`
    seeded with the int `key`."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


class StateTomograph:
    """Simulate state-tomography experiments and reconstruct states.

    Parameters
    ----------
    state : Qobj
        True state used by `experiment` simulations.
    dst : str or callable, default='hs'
        'hs', 'trace', 'if', or a custom (A, B) -> float distance.
    key : int seed or torch.Generator, optional
        Randomness source for simulations (default: seed 0).
    device : torch device, optional
        Where the computation runs (default: `config.get_device()`).
    dtype : torch.float32 or torch.float64, optional
        Working precision (default: `config.rdtype()`).
    """

    #: dense-POVM element budget; larger designs need the kron-factored
    #: path of the JAX package, which is not ported yet (ROADMAP A9)
    DENSE_POVM_MAX_ELEMENTS = 2**25

    def __init__(self, state, dst="hs", key=None, device=None, dtype=None):
        self.state = state
        self.dst = resolve_distance(dst)
        self.device = torch.device(device) if device is not None else get_device()
        self.dtype = dtype or rdtype()
        self.generator = make_generator(0 if key is None else key, self.device)
        self._results = None
        self.povm_matrix = None
        self.n_measurements = None

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def experiment(self, n_measurements, povm="proj-set", warm_start: bool = False):
        """Simulate a tomography experiment.

        warm_start=True merges the new POVM block with the previous one,
        reweighting rows by shot counts.
        """
        n = self.state.n_qubits
        povm_block = None
        if isinstance(povm, str):
            povm_block = _single_qubit_preset(povm)
        elif isinstance(povm, np.ndarray) and povm.shape[-1] == 4 and n > 1:
            povm_block = povm if povm.ndim == 3 else povm[None]
        if povm_block is not None:
            m1, p1, _ = povm_block.shape
            if (m1 * p1 * 4) ** n > self.DENSE_POVM_MAX_ELEMENTS:
                raise NotImplementedError(
                    "this design exceeds DENSE_POVM_MAX_ELEMENTS and needs the "
                    "kron-factored path, not ported yet (ROADMAP A9)"
                )
        povm_matrix = generate_measurement_matrix(povm, n)
        n_povms = povm_matrix.shape[0]
        if _uniform_shots(n_measurements) is not None:
            n_measurements = np.full(n_povms, _uniform_shots(n_measurements))
        else:
            n_measurements = np.asarray(n_measurements, dtype=np.float64)
            if n_measurements.shape[0] != n_povms:
                raise ValueError("Wrong length for argument `n_measurements`")

        counts = state_core.simulate_experiment(
            self.generator,
            self._tensor(povm_matrix),
            self.state.bloch_tensor(self.device, self.dtype),
            self._tensor(n_measurements),
        )
        counts = counts.cpu().numpy().astype(np.float64)

        if warm_start:
            prev_total = float(np.sum(self.n_measurements))
            new_total = float(np.sum(n_measurements))
            self.povm_matrix = np.vstack(
                [self.povm_matrix * prev_total, povm_matrix * new_total]
            ) / (prev_total + new_total)
            self.n_measurements = np.concatenate([self.n_measurements, n_measurements])
            self._results = np.vstack([self._results, counts])
        else:
            self.povm_matrix = np.asarray(povm_matrix, dtype=np.float64)
            self.n_measurements = n_measurements
            self._results = counts

    @property
    def results(self):
        return self._results

    @results.setter
    def results(self, results):
        """Inject measured outcome counts; n_measurements becomes the row
        sums."""
        self._results = np.asarray(results, dtype=np.float64)
        self.n_measurements = self._results.sum(-1)

    def point_estimate(
        self,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        max_iter: int = 100,
        tol: float = 1e-3,
    ) -> Qobj:
        """Reconstruct the state by 'lin' or 'mle-rhor'. Returns a Qobj and
        keeps it as `reconstructed_state`."""
        if self._results is None:
            raise RuntimeError("Run `experiment` or set `results` first")
        bloch = state_core.estimate(
            self._tensor(self._results),
            self._tensor(self.povm_matrix),
            self._tensor(self.n_measurements),
            method=method,
            physical=physical,
            init=init,
            max_iter=max_iter,
            tol=tol,
        )
        self.reconstructed_state = Qobj(bloch.cpu().numpy().astype(np.float64))
        return self.reconstructed_state

    def simulate_batch(self, n_experiments: int, state=None, generator=None):
        """Simulate `n_experiments` repetitions of the current design at once.
        Returns (n_experiments, m, p) counts as a tensor on `device`."""
        if self.povm_matrix is None:
            raise RuntimeError("Run `experiment` first to fix the design")
        bloch = (state or self.state).bloch_tensor(self.device, self.dtype)
        return state_core.simulate_experiment(
            generator if generator is not None else self.generator,
            self._tensor(self.povm_matrix),
            bloch.expand((n_experiments,) + tuple(bloch.shape)),
            self._tensor(self.n_measurements),
        )

    def estimate_batch(self, counts, method: str = "lin", **kwargs):
        """Estimate a batch of experiments at once; returns bloch vectors
        (batch, 4^n) as a tensor on `device`."""
        return state_core.estimate(
            self._tensor(counts),
            self._tensor(self.povm_matrix),
            self._tensor(self.n_measurements),
            method=method,
            **kwargs,
        )
