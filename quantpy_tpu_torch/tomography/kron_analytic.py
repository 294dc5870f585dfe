"""Analytic confidence intervals on Kronecker-factored designs (port of
quantpy_tpu/tomography/kron_analytic.py).

A product design factorizes its pseudo-inverse: for A = kron_n(A1),
A^+ = kron_n(A1^+), so V = A^+ never has to exist, and the moment and
Sugiyama recipes reduce to per-qubit contractions over tensors no larger
than the frequency table times small factors:

- Moment interval (mean = tr(R - S)/N, var = 2||R - S||_F^2/N^2, see
  stats.py): with the single-qubit Gram kernel C1 = V1^T V1,
      tr R    = < f, kron(diag C1) >
      tr R^2  = < f, kron(C1 o C1) f >          (o = Hadamard)
      S       = T T^T with T = per-POVM contraction of V against f
      <R, S>  = sum_{ai} f[ai] || (V^T T)[ai, :] ||^2
  The largest object is T (4^n x m1^n) resp. V^T T ((m1 p1)^n x m1^n,
  computed in column chunks sized by bytes).
- Sugiyama interval: the extrema over outcomes of
  V[d, a, i] = prod_k V1[d_k, a_k, i_k] come from an interval-arithmetic
  fold over qubits carrying (min, max) of the partial products.
- Channel moments: the process design is kron(states, POVM), so the moment
  matrix splits into per-input-state blocks (exact), or, for a fully
  kron-factored design, into an exact mean and a Hutchinson estimate of
  the Frobenius term.

Every contraction runs in torch, in float64, on the device given (the
port's default device if none). The pseudo-inverses of the single-qubit
factors are host numpy.
"""

from __future__ import annotations

import string

import numpy as np
import torch

from ..config import get_device
from .state import make_generator

__all__ = [
    "kron_l2_moments",
    "kron_sugiyama_c_alpha",
    "channel_l2_moments",
    "channel_l2_moments_kron",
]

F64 = torch.float64
#: bytes of one work tensor of a column chunk of <R, S> and of a state
#: chunk of the per-state channel path
_CHUNK_BYTES = 1 << 30


def _device(device):
    return torch.device(device) if device is not None else get_device()


def _v1(povm1) -> np.ndarray:
    """Single-qubit pseudo-inverse factor V1 (4, m1, p1) of the (m1, p1, 4)
    POVM block: A^+ = kron(A1^+) for A = kron(A1)."""
    povm1 = np.asarray(povm1, dtype=np.float64)
    m1, p1, _ = povm1.shape
    a1 = povm1.reshape(m1 * p1, 4)
    return np.linalg.solve(a1.T @ a1, a1.T).reshape(4, m1, p1)


def _interleave(freq, m1: int, p1: int, n: int, device):
    """(m1^n, p1^n) frequency table -> qubit-major (m1, p1)*n layout."""
    x = torch.as_tensor(np.asarray(freq), dtype=F64, device=device)
    x = x.reshape((m1,) * n + (p1,) * n)
    return x.permute([j for k in range(n) for j in (k, n + k)])


def _compute_t(x, v1, n: int):
    """T[d, a] = sum_i prod_k V1[d_k, a_k, i_k] f[a, i] as (4^n, m1^n).

    x is the interleaved frequency table; each step consumes the leading
    (a, i) pair and appends (d, a)."""
    for _ in range(n):
        x = torch.einsum("ai...,dai->...da", x, v1)
    # axes now (d1, a1, ..., dn, an) -> (d.., a..)
    perm = [2 * k for k in range(n)] + [2 * k + 1 for k in range(n)]
    return x.permute(perm).reshape(4**n, -1)


def _kron_quadform(x, op, n: int):
    """< x, kron_n(op) x > for an (m1, p1, m1, p1) per-qubit operator and an
    interleaved table x; each step consumes the leading (a, i) pair and
    appends (b, j), so the result stays in interleaved layout."""
    y = x
    for _ in range(n):
        y = torch.tensordot(y, op, dims=([0, 1], [0, 1]))
    return torch.sum(x * y)


def _kron_diag_contract(x, diag, n: int):
    """< f, kron_n(diag) > for a per-qubit (m1, p1) diagonal table."""
    y = x
    for _ in range(n):
        y = torch.tensordot(y, diag, dims=([0, 1], [0, 1]))
    return y


def _rs_term(t, x, v1, n: int, chunk: int | None):
    """sum_{ai} f[ai] sum_b (V^T T)[ai, b]^2 over column chunks of T."""
    m1, p1 = v1.shape[1], v1.shape[2]
    if chunk is None:
        chunk = max(1, _CHUNK_BYTES // (8 * (m1 * p1) ** n))
    sub = string.ascii_lowercase[: 2 * n]  # (a1, i1, ..., an, in) letters
    rs = torch.zeros((), dtype=F64, device=t.device)
    for lo in range(0, t.shape[1], chunk):
        g = t[:, lo : lo + chunk].reshape((4,) * n + (-1,))
        for _ in range(n):
            g = torch.tensordot(g, v1, dims=([0], [0]))
        # g axes: (B, a1, i1, ..., an, in); contract everything to a scalar
        rs = rs + torch.einsum(f"z{sub},{sub}->", g * g, x)
    return rs


def kron_l2_moments(
    povm1, n_qubits: int, freq, n_trials, chunk: int | None = None, device=None
):
    """(mean, variance) of the weighted L2 statistic of MomentInterval for a
    kron-factored design, exact (the dense path's numbers), never
    materializing the POVM, its pseudo-inverse or the weights tensor.

    povm1: (m1, p1, 4) single-qubit block; freq: (m1^n, p1^n) observed
    frequencies; n_trials: shots per POVM (uniform, as the kron experiment
    path guarantees); chunk: columns of T per <R, S> step (default: sized
    by bytes); device: where the contractions run, in float64.
    """
    n = n_qubits
    device = _device(device)
    v1_np = _v1(povm1) * 0.5  # per-qubit share of the 1/2^n scale
    m1, p1 = v1_np.shape[1], v1_np.shape[2]
    v1 = torch.as_tensor(v1_np, dtype=F64, device=device)
    x = _interleave(freq, m1, p1, n, device)

    v1f = v1.reshape(4, m1 * p1)
    c1 = (v1f.T @ v1f).reshape(m1, p1, m1, p1)  # per-qubit Gram kernel
    diag_c1 = torch.einsum("aiai->ai", c1)

    tr_r = _kron_diag_contract(x, diag_c1, n)
    tr_r2 = _kron_quadform(x, c1 * c1, n)
    t = _compute_t(x, v1, n)  # (4^n, m1^n)
    tr_s = torch.sum(t * t)
    y = t.T @ t  # (m1^n, m1^n)
    tr_s2 = torch.sum(y * y)
    rs = _rs_term(t, x, v1, n, chunk)
    tr_r, tr_s, tr_r2, rs, tr_s2 = torch.stack([tr_r, tr_s, tr_r2, rs, tr_s2]).tolist()
    mean = (tr_r - tr_s) / n_trials
    variance = 2.0 * (tr_r2 - 2.0 * rs + tr_s2) / n_trials**2
    return mean, variance


def _channel_block_grams(vp, f):
    """(tr Mp[s], <Mp[s], Mp[s']>_F) of the per-state moment blocks
    Mp[s] = vp diag(f_s) vp^T - tp[s] tp[s]^T, in float64 on the device of
    `vp`; states are taken in chunks whose (dp, m p) work tensor stays
    under `_CHUNK_BYTES`."""
    n_states, m, p = f.shape
    dp = vp.shape[0]
    vp3 = vp.reshape(dp, m, p)
    chunk = max(1, _CHUNK_BYTES // (8 * dp * m * p))
    blocks = torch.empty((n_states, dp, dp), dtype=F64, device=vp.device)
    for lo in range(0, n_states, chunk):
        fc = f[lo : lo + chunk]
        tp = torch.einsum("dai,sai->sda", vp3, fc)
        vpf = vp[None] * fc.reshape(fc.shape[0], 1, m * p)
        blocks[lo : lo + chunk] = torch.matmul(vpf, vp.T) - torch.matmul(tp, tp.transpose(1, 2))
    tr_mp = torch.diagonal(blocks, dim1=-2, dim2=-1).sum(-1)
    x = blocks.reshape(n_states, dp * dp)
    return tr_mp, x @ x.T


def channel_l2_moments(states_matrix, povm_matrix, freq, n_trials, device=None):
    """(mean, variance) of the MomentInterval L2 statistic for a process
    design, never materializing the (S*K, 16^n) channel matrix.

    The process measurement map is a two-factor Kronecker product,
    A[(s,k), (d,e)] = states_matrix[s, d] * povm_flat[k, e], so
    A^+ = states_matrix^+ (x) povm_flat^+, and the moment matrix splits per
    input state:

        M = sum_s (v_s v_s^T) (x) Mp[s],
        Mp[s] = Vp diag(f_s) Vp^T - Tp[s] Tp[s]^T   (dp x dp per state)

    with v_s = column s of Vs = states_matrix^+. Hence

        tr M      = sum_s ||v_s||^2 tr Mp[s]
        ||M||_F^2 = sum_{s,s'} (v_s . v_s')^2  <Mp[s], Mp[s']>_F

    Everything is (S, dp, dp)-sized: 134 MB at 4 qubits, where the dense
    pseudo-inverse would be 21 GB. Exact, in float64 on `device`.

    Parameters
    ----------
    states_matrix : (S, ds) input-state bloch rows (tmg._input_blochs_t())
    povm_matrix : (m, p, dp) POVM bloch tensor of the child tomographs
    freq : (S, m, p) observed frequencies
    n_trials : shots per (state, POVM) multinomial (uniform)
    """
    device = _device(device)
    states_matrix = np.asarray(states_matrix, dtype=np.float64)
    povm = np.asarray(povm_matrix, dtype=np.float64)
    n_states, m, p = np.shape(freq)
    dp = povm.shape[-1]
    dim = float(dp)  # the dense path scales A^+ by 1/dim, dim = 4^n

    vs = np.linalg.pinv(states_matrix)  # (ds, S)
    cs = torch.as_tensor(vs.T @ vs, dtype=F64, device=device)  # state-factor Gram
    vp = np.linalg.pinv(povm.reshape(m * p, dp)) / dim  # (dp, m p)
    tr_mp, p_gram = _channel_block_grams(
        torch.as_tensor(vp, dtype=F64, device=device),
        torch.as_tensor(np.asarray(freq), dtype=F64, device=device),
    )
    trace, fro2 = torch.stack([torch.diagonal(cs) @ tr_mp, torch.sum(cs * cs * p_gram)]).tolist()
    return trace / n_trials, 2.0 * fro2 / n_trials**2


def kron_sugiyama_c_alpha(povm1, n_qubits: int, device=None) -> np.ndarray:
    """The Sugiyama c_alpha vector (4^n,) for a kron-factored design.

    Dense recipe: scale the POVM rows by dim/sqrt(2 dim), invert, and for
    every bloch axis d sum over POVMs the squared outcome spread
    (max_i - min_i of inv[d, a, i]) times the shot ratio. Here
    inv[d, a, i] = s * prod_k V1[d_k, a_k, i_k] with s = sqrt(2/dim), and
    the per-axis extrema over the product of independently chosen outcome
    factors come from carrying (lo, hi) of the partial product one qubit at
    a time over all p1 candidate factors (in float64 on `device`).

    Returns c_alpha WITHOUT the shot-ratio weighting (uniform shots give a
    constant ratio m1^n applied by the caller) and WITHOUT the +EPS floor.
    """
    n = n_qubits
    v1 = torch.as_tensor(_v1(povm1), dtype=F64, device=_device(device))
    s = np.sqrt(2.0 / 2**n)
    lo = torch.ones((), dtype=F64, device=v1.device)
    hi = lo
    for _ in range(n):
        # candidates over this qubit's outcomes: shape (..., d, a, p1)
        cand_lo = lo[..., None, None, None] * v1
        cand_hi = hi[..., None, None, None] * v1
        lo = torch.minimum(cand_lo, cand_hi).amin(-1)  # (..., d, a)
        hi = torch.maximum(cand_lo, cand_hi).amax(-1)
    perm = [2 * k for k in range(n)] + [2 * k + 1 for k in range(n)]
    spread = (hi - lo).permute(perm).reshape(4**n, -1) * s
    return torch.sum(spread**2, dim=-1).cpu().numpy()


# --------------------------------------------------------------------------
# 6+ qubit channel moments: exact mean + Hutchinson Frobenius term
# --------------------------------------------------------------------------


def _channel_kron_factors(states1_t, povm1):
    """Per-qubit factors of the fully kron-factored process design:
    V1 = pinv of the flattened single-qubit POVM block, its Gram G1, and
    the input-state Gram Cs1 = Vs1^T Vs1 (host numpy)."""
    states1_t = np.asarray(states1_t, dtype=np.float64)  # (S1, 4)
    povm1 = np.asarray(povm1, dtype=np.float64)  # (m1, p1, 4)
    m1, p1, _ = povm1.shape
    f1 = povm1.reshape(m1 * p1, 4)
    v1 = np.linalg.solve(f1.T @ f1, f1.T)  # (4, m1 p1)
    g1 = v1.T @ v1  # (m1 p1, m1 p1)
    vs1 = np.linalg.pinv(states1_t)  # (4, S1)
    cs1 = vs1.T @ vs1  # (S1, S1)
    return v1, g1, cs1, m1, p1


def _fold_axis(u, k: int, op):
    """Contract axis 1+k of u (one leading axis) with op (c, out), keeping
    the axis order."""
    return torch.movedim(torch.movedim(u, 1 + k, -1) @ op, -1, 1 + k)


def _fold_block_axis(u, k: int, b1, m1: int, p1: int):
    """Per-POVM quadratic-kernel fold on fused axis 1+k: with the axis
    viewed as (a, i), map to (a, j) via b1[a, i, j] (the G1 diagonal
    blocks)."""
    u = torch.movedim(u, 1 + k, -1)
    u = u.reshape(u.shape[:-1] + (m1, p1))
    u = torch.einsum("...ai,aij->...aj", u, b1)
    return torch.movedim(u.reshape(u.shape[:-2] + (m1 * p1,)), -1, 1 + k)


def _kron_power_vec(vec1, n: int) -> np.ndarray:
    """n-fold Kronecker power of a vector (host, float64)."""
    out = np.asarray(vec1, dtype=np.float64)
    for _ in range(n - 1):
        out = np.kron(out, vec1)
    return out


def channel_l2_moments_kron(
    states1_t,
    povm1,
    n_qubits: int,
    freq,
    n_trials,
    n_probes: int = 128,
    key=None,
    state_chunk: int = 256,
    probe_chunk: int = 16,
    probes=None,
    device=None,
):
    """(mean, variance) of the channel-mode MomentInterval L2 statistic for
    a FULLY kron-factored process design (input states AND POVM are tensor
    powers of single-qubit blocks): the 6-qubit regime, where the per-state
    blocks of :func:`channel_l2_moments` are (4^n)^2 each.

    The MEAN is exact: tr Mp[s] = sum_j ||vp_j||^2 f_sj - ||tp_s||_F^2,
    both per-qubit folds of the frequency tensor.

    The Frobenius term of the VARIANCE is an unbiased Rademacher
    Hutchinson estimate: with W = (Vs^T Vs)^{o 2} (a Kronecker power),

        fro2 = sum_{s,s'} W[s,s'] tr(Mp[s] Mp[s']) = E_z[u_z],
        u_z  = sum_{s,s'} W[s,s'] (Mp[s] z).(Mp[s'] z),

    and Mp[s] z = vp-apply(C_s), C_s[(a,i)] = f_s[(a,i)] (y[(a,i)] -
    t_s[a]), y = vp^T z, t_s[a] = sum_i f_s[(a,i)] y[(a,i)]: no tp or Mp is
    materialized. n_probes=128 reproduces the exact variance to ~2 percent
    at 2-3 qubits; the estimator error enters the radius through a square
    root.

    Parameters
    ----------
    states1_t : (S1, 4) transposed single-qubit input-state bloch rows
    povm1 : (m1, p1, 4) single-qubit POVM block
    freq : (S, m1^n, p1^n) observed frequencies, S = S1^n
    n_trials : uniform shots per (state, POVM)
    key : int seed or torch.Generator on `device` for the probes
        (default: seed 1234)
    state_chunk : states per fold: the exact mean and each probe batch's
        folds run over the states in chunks of this size, which bounds the
        memory of the per-state work tensors (state_chunk x probe_chunk x
        (m1 p1)^n entries); the result changes only by summation order
    probe_chunk : probes per batch
    probes : optional (n_probes,) + (4,)*n tensor of +-1 probes to use
        instead of drawing them
    device : where the folds run, in float64
    """
    n = n_qubits
    device = _device(device)
    v1, g1, cs1, m1, p1 = _channel_kron_factors(states1_t, povm1)
    f = torch.as_tensor(np.asarray(freq), dtype=F64, device=device)
    s_count = f.shape[0]
    dim = float(4**n)
    c_dim = m1 * p1
    # (S, m, p) -> (S, c1, ..., cn) with fused c_k = (a_k, i_k)
    x = f.reshape((s_count,) + (m1,) * n + (p1,) * n)
    x = x.permute([0] + [1 + j for k in range(n) for j in (k, n + k)]).contiguous()
    x = x.reshape((s_count,) + (c_dim,) * n)

    def tensor(a):  # a copy: some factors are read-only numpy views
        return torch.tensor(a, dtype=F64, device=device)

    v1t_d = tensor(v1.T)  # (c, 4): vp-apply op per qubit
    v1_d = tensor(v1)  # (4, c): vp^T-apply op per qubit
    g1_diag = tensor(np.diag(g1))
    b1_d = tensor(np.einsum("aiaj->aij", g1.reshape(m1, p1, m1, p1)))  # (m1, p1, p1)
    w1_d = tensor(cs1 * cs1)  # (S1, S1)
    s1 = cs1.shape[0]
    cs_diag = tensor(_kron_power_vec(np.diag(cs1), n))  # (S,)
    if probes is not None:
        probes = torch.as_tensor(probes, dtype=F64, device=device)
        n_probes = probes.shape[0]
    state_chunk = max(1, int(state_chunk))
    chunks = [x[lo : lo + state_chunk] for lo in range(0, s_count, state_chunk)]

    def tr_mp_chunk(xc):
        """Exact (chunk,) tr Mp[s]: diagonal fold minus block quadratic."""
        t1 = xc
        for _ in range(n):
            # consuming axis 1 repeatedly walks through every qubit
            t1 = torch.tensordot(t1, g1_diag, dims=([1], [0]))
        u = xc
        for k in range(n):
            u = _fold_block_axis(u, k, b1_d, m1, p1)
        t2 = torch.sum(u * xc, dim=tuple(range(1, n + 1)))
        return (t1 - t2) / (dim * dim)

    def u_probe_chunk(xc, z_batch):
        """(chunk, nz, 4^n) factored Mp[s] z for a probe batch
        z_batch (nz,) + (4,)*n, with the 1/dim^2 of Mp's two vp factors."""
        nz = z_batch.shape[0]
        y = z_batch
        for k in range(n):
            y = _fold_axis(y, k, v1_d)  # (nz, c1..cn), vp^T z * dim
        w = xc[:, None] * y[None]  # (chunk, nz, c1..cn)
        t = torch.sum(
            w.reshape(w.shape[:2] + (m1, p1) * n), dim=tuple(3 + 2 * k for k in range(n))
        )  # (chunk, nz, a1..an)
        # broadcast t back over the outcome axes, fused to (c,) per qubit
        t_b = t.reshape(t.shape[:2] + (m1, 1) * n).expand(t.shape[:2] + (m1, p1) * n)
        c = xc[:, None] * (y[None] - t_b.reshape(w.shape))
        u = c.reshape((c.shape[0] * nz,) + c.shape[2:])
        for k in range(n):
            u = _fold_axis(u, k, v1t_d)  # c_k -> d_k (vp-apply * dim)
        return u.reshape(c.shape[0], nz, -1) / (dim * dim)

    def w_quadratic(u_all):
        """(nz,) u_z = sum_{s,s'} W[s,s'] U[s].U[s'] via per-qubit w1
        folds over the state axis."""
        nz, dp = u_all.shape[1], u_all.shape[2]
        v = u_all.reshape((s1,) * n + (nz * dp,))
        for k in range(n):
            v = torch.movedim(torch.movedim(v, k, -1) @ w1_d, -1, k)
        v = v.reshape(s_count, nz, dp)
        return torch.sum(u_all * v, dim=(0, 2))

    tr_mp = torch.cat([tr_mp_chunk(c) for c in chunks])
    generator = None if probes is not None else make_generator(
        1234 if key is None else key, device)
    u_sum = torch.zeros((), dtype=F64, device=device)
    for lo in range(0, n_probes, probe_chunk):
        nz = min(probe_chunk, n_probes - lo)
        if probes is not None:
            z = probes[lo : lo + nz]
        else:
            z = torch.randint(0, 2, (nz,) + (4,) * n, generator=generator, device=device)
            z = z.to(F64) * 2 - 1
        u_all = torch.cat([u_probe_chunk(c, z) for c in chunks], dim=0)  # (S, nz, 4^n)
        u_sum = u_sum + torch.sum(w_quadratic(u_all))
    trace, u_sum = torch.stack([cs_diag @ tr_mp, u_sum]).tolist()
    return trace / n_trials, 2.0 * (u_sum / n_probes) / n_trials**2
