"""Bayesian mean estimation (BME) for state tomography (port of
quantpy_tpu/tomography/bayes.py).

The posterior over density matrices (Cholesky parametrization,
count-weighted likelihood, uniform prior over the parametrization) is
sampled by `n_chains` device chains side by side, each with its own
burn-in; the estimate is the posterior mean of the pooled samples, with a
credible radius (arXiv:1509.03770, arXiv:2106.00577).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mhmc import MHMC, normalized_update
from ..ops.cholesky import np_matrix_to_real_tril_vec, real_tril_vec_to_matrix
from ..ops.paulis import matrix_to_bloch
from ..qobj import Qobj
from . import bootstrap_core

__all__ = ["bayesian_mean_estimate"]


def bayesian_mean_estimate(
    tmg,
    n_samples: int = 500,
    n_chains: int = 8,
    step: float = 0.02,
    burn_steps: int = 500,
    thinning: int = 2,
    adapt_step: bool = True,
    credible_level: float = 0.9,
    key=None,
):
    """Posterior-mean state estimate with a credible radius.

    Parameters
    ----------
    tmg : StateTomograph with results
    n_samples : samples kept per chain
    n_chains : chains side by side (pooled)
    credible_level : level of the reported credible radius (hs distance of
        the samples to the posterior mean)
    key : int seed or torch.Generator on the tomograph's device (default 0)

    Returns
    -------
    (rho_bme : Qobj, credible_radius : float, diagnostics : dict)
    """
    if tmg.results is None:
        raise RuntimeError("Run `experiment` or set `results` first")
    n_qubits = tmg.state.n_qubits
    dim = 2**n_qubits
    # start at the (feasible) MLE and sample the count-weighted posterior
    start = tmg.point_estimate("mle-rhor")
    mat = start.matrix + 1e-7 * np.eye(dim)
    mat = mat / np.trace(mat).real
    n_total = float(np.sum(tmg.n_measurements))
    chain = MHMC(
        lambda x: -n_total * tmg._nll(x),
        step=step,
        burn_steps=burn_steps,
        dim=dim * dim,
        update_rule=normalized_update,
        symmetric=True,
        x_init=tmg._tensor(np_matrix_to_real_tril_vec(mat)),
        key=key,
    )
    if adapt_step:
        chain.adapt_step()
    samples, acceptance = chain.sample_chains(n_samples, n_chains, thinning)
    rho = real_tril_vec_to_matrix(tmg._tensor(samples.reshape(-1, dim * dim)), dim)
    tr = torch.diagonal(rho, dim1=-2, dim2=-1).sum(-1).real
    blochs = matrix_to_bloch(rho) / tr[..., None]
    mean_bloch = blochs.mean(0)
    dists = bootstrap_core._distance_batch("hs", blochs, mean_bloch, n_qubits)
    dists = np.sort(dists.cpu().numpy().astype(np.float64))
    if not (np.all(np.isfinite(dists)) and bool(torch.isfinite(mean_bloch).all())):
        raise FloatingPointError("bayesian_mean_estimate: a posterior sample is not finite")
    radius = float(np.quantile(dists, credible_level))
    mean_hs = bootstrap_core._distance_batch(
        "hs", mean_bloch[None], tmg._tensor(start.bloch), n_qubits
    )
    diagnostics = {
        "acceptance_rate": acceptance,
        "step": chain.step,
        "n_pooled_samples": blochs.shape[0],
        "mean_hs_to_mle": float(mean_hs[0]),
    }
    return Qobj(mean_bloch.cpu().numpy().astype(np.float64)), radius, diagnostics
