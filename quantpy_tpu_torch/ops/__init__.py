"""Tensor operations: Pauli transforms, distances, sampling and the RrhoR
kernels."""

from .cplx import complex_to_pair, from_pair, pair_to_complex, to_pair
from .geometry import fidelity, hs_dst, if_dst, product, resolve_distance, trace_dst
from .kernels import rhor_mle, rhor_mle_flat, rhor_mle_flat_reference, rhor_mle_reference
from .lstsq import left_inverse, lstsq_solve
from .paulis import (
    PTM_MAX_QUBITS,
    bloch_to_matrix,
    generate_pauli,
    kron_all,
    matrix_to_bloch,
    n_qubits_from_dim,
    pauli_transfer_matrix,
    pauli_transpose_signs,
    ptrace,
    unvec,
    vec,
)
from .sampling import sample_multinomial

__all__ = [
    "PTM_MAX_QUBITS",
    "bloch_to_matrix",
    "matrix_to_bloch",
    "n_qubits_from_dim",
    "pauli_transfer_matrix",
    "vec",
    "unvec",
    "generate_pauli",
    "pauli_transpose_signs",
    "kron_all",
    "ptrace",
    "left_inverse",
    "lstsq_solve",
    "hs_dst",
    "trace_dst",
    "if_dst",
    "fidelity",
    "product",
    "resolve_distance",
    "sample_multinomial",
    "rhor_mle",
    "rhor_mle_reference",
    "rhor_mle_flat",
    "rhor_mle_flat_reference",
    "complex_to_pair",
    "from_pair",
    "pair_to_complex",
    "to_pair",
]
