"""Multi-device scaling over a single-controller device mesh (port of
quantpy_tpu/parallel; see `mesh`)."""

from .mesh import (
    make_mesh,
    povm_sharded_probabilities,
    sharded_bootstrap_distances,
    sharded_coverage,
    sharded_kron_adjoint_flat,
    sharded_kron_bootstrap_distances,
    sharded_kron_estimate_lin,
    sharded_kron_estimate_mle_rhor,
    sharded_kron_forward_flat,
    sharded_kron_simulate,
    sharded_mhmc_kraus_chains,
    sharded_mhmc_process_chains,
    sharded_mhmc_state_chains,
    sharded_process_bootstrap_distances,
)

__all__ = [
    "make_mesh",
    "povm_sharded_probabilities",
    "sharded_bootstrap_distances",
    "sharded_coverage",
    "sharded_kron_adjoint_flat",
    "sharded_kron_bootstrap_distances",
    "sharded_kron_estimate_lin",
    "sharded_kron_estimate_mle_rhor",
    "sharded_kron_forward_flat",
    "sharded_kron_simulate",
    "sharded_mhmc_kraus_chains",
    "sharded_mhmc_process_chains",
    "sharded_mhmc_state_chains",
    "sharded_process_bootstrap_distances",
]
