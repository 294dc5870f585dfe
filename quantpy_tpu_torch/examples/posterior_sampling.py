"""Process-posterior sampling with the anchored kraus chains.

Port of examples/posterior_sampling.py. The reference samples the float64
NLL with a NumPy loop (quantpy/tomography/interval.py:688-850); here the
chain is a device loop over a smooth, exactly-CPTP kraus-factor
parametrization, evaluated as an exact delta from a host-f64 anchor with a
float64 reduction. Demonstrates:

- MHMCProcessInterval(parametrization='kraus') with MALA, R-hat/ESS
  diagnostics, and bootstrap cross-validation;
- scipy frozen distributions as proposals (drawn on the device by inverse
  CDF, Hastings-corrected when asymmetric).

DECISION PATH for a process CI (measured with the JAX package):
- 1-3 qubit channels: this chain converges (R-hat < 1.1 here) and is the
  posterior-exact answer; cross-validate with the bootstrap as below.
- 4+ qubit channels: use BootstrapProcessInterval. The chain target is
  precision-clean, but the posterior geometry is a measured wall —
  a two-seed Lanczos spectrum of the whitened Hessian shows ~12,600
  stiff directions over four curvature decades, which no feasible
  metric flattens (docs/benchmarks.md, the 4-qubit posterior study). The chain's
  R-hat/ESS RuntimeWarning fires if you try anyway.

Run:  python -m quantpy_tpu_torch.examples.posterior_sampling [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import quantpy_tpu_torch as qt
from quantpy_tpu_torch.channel import depolarizing
from quantpy_tpu_torch.examples import parse_args


def process_posterior(
    n_qubits: int = 2,
    n_shots: int = 2000,
    key: int = 5,
    n_points: int = 600,
    burn_steps: int = 4000,
    n_boot: int = 400,
):
    """Anchored kraus-MALA chain vs the parametric bootstrap on one
    depolarizing-channel experiment. Returns (chain d50/d90, bootstrap
    d50/d90, r_hat, ess)."""
    tmg = qt.ProcessTomograph(depolarizing(0.15, n_qubits), key=key)
    tmg.experiment(n_shots, "proj-set")
    tmg.point_estimate("lifp")

    conf = np.array([0.5, 0.9])
    boot = qt.BootstrapProcessInterval(tmg, n_points=n_boot, key=key + 1)
    bd, _ = boot(conf)

    chain = qt.MHMCProcessInterval(
        tmg,
        n_points=n_points,
        burn_steps=burn_steps,
        step=0.01,
        parametrization="kraus",
        proposal="mala",
        adapt_step=True,
        n_chains=4,
        thinning=8,
        key=key + 2,
    )
    cd, _ = chain(conf)
    return np.asarray(cd), np.asarray(bd), chain.r_hat, chain.ess


def scipy_proposal_state_chain(key: int = 9):
    """State-space MHMC driven by a scipy frozen proposal (the reference's
    input style, adapted on the fly). Returns the d50/d90 radii."""
    import scipy.stats as st

    tmg = qt.StateTomograph(qt.GHZ(1), key=key)
    tmg.experiment(3000, "proj-set")
    tmg.point_estimate("lin")
    iv = qt.MHMCStateInterval(
        tmg,
        n_points=800,
        burn_steps=800,
        jump_distr=st.laplace(scale=1.0),
        use_new_estimate=True,
        key=key + 1,
    )
    d, _ = iv(np.array([0.5, 0.9]))
    return np.asarray(d)


def main(args=None) -> None:
    parse_args(argparse.ArgumentParser(description=__doc__.splitlines()[0]), args)
    cd, bd, r_hat, ess = process_posterior()
    print("2-qubit depolarizing process, 2000 shots/config:")
    print(f"  kraus-MALA chain d50/d90 = {cd.round(4)}  "
          f"(R-hat {r_hat:.3f}, ESS {ess:.0f})")
    print(f"  bootstrap        d50/d90 = {bd.round(4)}")
    print("  (the two quantify different spreads — posterior vs sampling "
          "distribution — but should sit on the same scale)")

    d = scipy_proposal_state_chain()
    print(f"\n1-qubit state chain with a scipy laplace proposal: "
          f"d50/d90 = {d.round(4)}")


if __name__ == "__main__":
    main()
