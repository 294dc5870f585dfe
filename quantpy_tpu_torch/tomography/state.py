"""StateTomograph (port of quantpy_tpu/tomography/state.py).

`experiment` (with `warm_start`), the `results` setter for measured data,
`point_estimate('lin' | 'mle' | 'mle-constr' | 'mle-rhor')`, the batch API
(`simulate_batch`, `estimate_batch`) and `_nll`, the likelihood of a
Cholesky parameter vector. The design and the counts are kept as float64
numpy arrays, as in the JAX package; computation runs on the tomograph's
`device` in its `dtype`, with randomness from its own `torch.Generator`.

A design of single-qubit blocks whose tensor power exceeds
`DENSE_POVM_MAX_ELEMENTS` (every proj-set design from 6 qubits up) runs in
kron mode: `povm_matrix` stays None, `povm_kron` holds the (m1, p1, 4)
block, and simulation and estimation run the factored chains of
`kron_core` (uniform shots only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import get_device, rdtype
from ..measurements import _single_qubit_preset, generate_measurement_matrix
from ..ops.geometry import resolve_distance
from ..qobj import Qobj
from . import kron_core, state_core

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

    #: dense-POVM element budget; beyond it a design of single-qubit blocks
    #: with uniform shots runs in kron mode and never materializes the POVM
    DENSE_POVM_MAX_ELEMENTS = 2**25

    def __init__(self, state, dst="hs", key=None, device=None, dtype=None):
        self.state = state
        self.dst = resolve_distance(dst)
        self.device = torch.device(device) if device is not None else get_device()
        self.dtype = dtype or rdtype()
        self.generator = make_generator(0 if key is None else key, self.device)
        self._results = None
        self.povm_matrix = None
        self.povm_kron = None
        self.n_measurements = None

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @property
    def kron_mode(self) -> bool:
        """Whether the experiment runs on the kron-factored design."""
        return self.povm_matrix is None and self.povm_kron is not None

    def _kron_draw(self, shots):
        counts = kron_core.kron_simulate(
            self.generator,
            self._tensor(self.povm_kron),
            self.state.bloch_tensor(self.device, self.dtype),
            shots,
        )
        return counts.cpu().numpy().astype(np.float64)

    def experiment(self, n_measurements, povm="proj-set", warm_start: bool = False):
        """Simulate a tomography experiment.

        warm_start=True merges the new POVM block with the previous one,
        reweighting rows by shot counts. In kron mode it must repeat the
        same single-qubit block with uniform shots, and it adds the new
        counts to the old ones: every estimator reads only the weighted
        frequency table, so this is the same experiment as stacking the
        rows.
        """
        n = self.state.n_qubits
        povm_block = None
        if isinstance(povm, str):
            povm_block = _single_qubit_preset(povm)
        elif isinstance(povm, np.ndarray) and povm.shape[-1] == 4 and n > 1:
            povm_block = povm if povm.ndim == 3 else povm[None]
        shots = _uniform_shots(n_measurements)
        if warm_start and self.kron_mode:
            if (
                povm_block is None
                or povm_block.shape != self.povm_kron.shape
                or not np.allclose(povm_block, self.povm_kron)
            ):
                raise NotImplementedError(
                    "kron-mode warm_start supports only repeating the same "
                    "factored design; pass the identical single-qubit block"
                )
            if shots is None:
                raise NotImplementedError("kron-mode warm_start needs uniform integral shots")
            self._results = self._results + self._kron_draw(shots)
            self.n_measurements = self.n_measurements + shots
            return
        if povm_block is not None and shots is not None:
            m1, p1, _ = povm_block.shape
            if (m1 * p1 * 4) ** n > self.DENSE_POVM_MAX_ELEMENTS:
                if warm_start:
                    raise NotImplementedError(
                        "warm_start into kron-factored mode needs a prior "
                        "kron-mode experiment with the same design"
                    )
                self.povm_kron = np.asarray(povm_block, dtype=np.float64)
                self.povm_matrix = None
                self._results = self._kron_draw(shots)
                self.n_measurements = np.full(self._results.shape[0], shots)
                return
        self.povm_kron = None
        povm_matrix = generate_measurement_matrix(povm, n)
        n_povms = povm_matrix.shape[0]
        if shots is not None:
            n_measurements = np.full(n_povms, shots)
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

    @property
    def flat_results(self):
        return self._results.reshape(-1)

    def _kron_estimate(self, counts, method, physical, max_iter, tol):
        """Kron mode's estimators: 'lin', and RrhoR for every MLE method
        (the Cholesky estimate has no factored form; its fixed point is the
        same maximum of the likelihood)."""
        n = self.state.n_qubits
        povm1 = self._tensor(self.povm_kron)
        if method == "lin":
            return kron_core.kron_estimate_lin(counts, povm1, n, physical=physical)
        if method in ("mle", "mle-constr", "mle-rhor"):
            return kron_core.kron_estimate_mle_rhor(
                counts, povm1, n, max_iter=max_iter, tol=tol
            )
        raise NotImplementedError(
            f"method {method!r} is not available on the kron-factored path"
        )

    def point_estimate(
        self,
        method: str = "lin",
        physical: bool = True,
        init: str = "lin",
        max_iter: int = 100,
        tol: float = 1e-3,
    ) -> Qobj:
        """Reconstruct the state by 'lin', 'mle', 'mle-constr' or
        'mle-rhor'. Returns a Qobj and keeps it as `reconstructed_state`."""
        if self._results is None:
            raise RuntimeError("Run `experiment` or set `results` first")
        counts = self._tensor(self._results)
        if self.kron_mode:
            # the JAX package floors the stop at float32's precision whatever
            # the dtype; kept for parity
            rhor_tol = max(float(np.finfo(np.float32).eps) * 10, tol * 1e-3)
            bloch = self._kron_estimate(counts, method, physical, max_iter, rhor_tol)
        else:
            bloch = state_core.estimate(
                counts,
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
        if self.povm_matrix is None and self.povm_kron is None:
            raise RuntimeError("Run `experiment` first to fix the design")
        bloch = (state or self.state).bloch_tensor(self.device, self.dtype)
        blochs = bloch.expand((n_experiments,) + tuple(bloch.shape))
        generator = generator if generator is not None else self.generator
        if self.kron_mode:
            return kron_core.kron_simulate(
                generator, self._tensor(self.povm_kron), blochs,
                float(self.n_measurements[0]),
            )
        return state_core.simulate_experiment(
            generator,
            self._tensor(self.povm_matrix),
            blochs,
            self._tensor(self.n_measurements),
        )

    def estimate_batch(self, counts, method: str = "lin", **kwargs):
        """Estimate a batch of experiments at once; returns bloch vectors
        (batch, 4^n) as a tensor on `device`. In kron mode `physical`,
        `max_iter` and `tol` are read and `tol` is the RrhoR stop itself
        (default 1e-6), as in the JAX package."""
        counts = self._tensor(counts)
        if self.kron_mode:
            return self._kron_estimate(
                counts, method, kwargs.get("physical", True),
                kwargs.get("max_iter", 100), kwargs.get("tol", 1e-6),
            )
        return state_core.estimate(
            counts,
            self._tensor(self.povm_matrix),
            self._tensor(self.n_measurements),
            method=method,
            **kwargs,
        )

    def _nll(self, tril_vec):
        """NLL of Cholesky parameter vectors (..., 4^n) under the current
        data. In kron mode the probabilities run through the factored
        forward chain (uniform row weights 1/m)."""
        freq = self._tensor(self.flat_results / self.flat_results.sum())
        tril_vec = self._tensor(tril_vec)
        n = self.state.n_qubits
        if self.kron_mode:
            return kron_core.kron_nll_tril(
                tril_vec, self._tensor(self.povm_kron), n, freq, self._results.shape[0]
            )
        a = state_core.weighted_povm_flat(
            self._tensor(self.povm_matrix), self._tensor(self.n_measurements)
        )
        return state_core.nll_tril(tril_vec, a, freq, n)
