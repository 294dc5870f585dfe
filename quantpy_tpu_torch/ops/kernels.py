"""The fused RrhoR MLE kernels and their plain PyTorch versions.

`rhor_mle` and `rhor_mle_flat` each run `n_iter` fixed RrhoR iterations
for a batch of resamples and reach the same fixed point. On CUDA tensors
they launch the hand-written kernels of `csrc/rhor_mle.cu` (the port of
quantpy_tpu/ops/kernels.py::rhor_mle_pallas, whose loop state is the bloch
vector) and `csrc/rhor_mle_flat.cu` (the port of rhor_mle_pallas_flat,
whose loop state is the density matrix); on CPU tensors they run
`rhor_mle_reference` and `rhor_mle_flat_reference`, the same math in plain
PyTorch. A CUDA tensor reaches the kernel or the call raises.

All of them work in the transposed matrix space of the JAX package: the
row-major reshape of the column-stacked vec(A) is A^T, and the palindrome
R rho R is closed under transposition, so nothing is ever untransposed.

The lane kernel applies the Pauli transfer matrix as a signed gather: every
row and every column of PTM has exactly d non-zeros, each one of +-1 and
+-i. `_ptm_gather_tables` lists them; `_ptm_gather_apply` and
`_ptm_gather_back` state in plain PyTorch what the kernel computes from
them.

The flat kernel keeps the Hermitian density matrix folded to its D real
entries (`_fold`, `_unfold`), and the POVM operands with it
(`_flat_fold_operands`), so its two POVM products are K x D like the lane
kernel's; `_rhor_mle_flat_folded` states its iteration in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .paulis import PTM_MAX_QUBITS, _pauli_transfer_np

__all__ = ["rhor_mle", "rhor_mle_flat", "rhor_mle_flat_reference", "rhor_mle_reference"]

EPS = 1e-10


@functools.lru_cache(maxsize=8)
def _ptm_parts(n_qubits: int, dtype: torch.dtype, device: torch.device):
    """(PTM_re, PTM_im, PTM_re^T, PTM_im^T) as contiguous real tensors."""
    ptm = _pauli_transfer_np(n_qubits)
    re = torch.as_tensor(ptm.real, dtype=dtype, device=device).contiguous()
    im = torch.as_tensor(ptm.imag, dtype=dtype, device=device).contiguous()
    return re, im, re.T.contiguous(), im.T.contiguous()


@functools.lru_cache(maxsize=8)
def _ptm_gather_tables(n_qubits: int, device: torch.device):
    """(fwd, back), each an int32 (d, D) tensor on `device`: PTM's non-zeros
    as signed gathers, entry = (index << 2) | (imaginary << 1) | negative.

    fwd[k, i] is the k-th non-zero of row i of PTM (its bloch index j), so
    that PTM[i, :] x = sum_k +-x_j into the real or the imaginary part.
    back[k, j] is the k-th non-zero of column j (its vec index i), so that
    (t_re PTM_re + t_im PTM_im)_j = sum_k +-t_re_i or +-t_im_i. Built from
    the same PTM as `_ptm_parts`; the (d, D) layout lets neighbouring
    outputs read neighbouring entries.
    """
    ptm = _pauli_transfer_np(n_qubits)
    dim2, dim = 4**n_qubits, 2**n_qubits
    rows, cols = np.nonzero(ptm)  # row-major: row i's d columns together
    vals = ptm[rows, cols]
    per_row = np.bincount(rows, minlength=dim2)
    per_col = np.bincount(cols, minlength=dim2)
    if not (np.all(per_row == dim) and np.all(per_col == dim)
            and np.all(np.abs(vals.real) + np.abs(vals.imag) == 1)
            and np.all(vals.real * vals.imag == 0)):
        raise AssertionError("PTM is not d non-zeros of +-1, +-i per row and column")
    code = 2 * (vals.imag != 0) + (vals.real + vals.imag < 0)
    by_col = np.argsort(cols, kind="stable")  # column j's d rows together

    def table(index, codes):
        packed = ((index << 2) | codes).reshape(dim2, dim).T.astype(np.int32)
        return torch.as_tensor(np.ascontiguousarray(packed), device=device)

    return table(cols, code), table(rows[by_col], code[by_col])


def _unpack(table):
    """(index, sign, imaginary) of a gather table, as int64 tensors."""
    t = table.long()
    return t >> 2, 1 - 2 * (t & 1), (t >> 1) & 1


def _ptm_gather_apply(x, tables):
    """(x PTM_re^T, x PTM_im^T) for x (..., D), by the gather tables."""
    idx, sign, imag = _unpack(tables[0])
    vals = x[..., idx] * sign.to(x.dtype)
    imag = imag.to(torch.bool)
    return vals.masked_fill(imag, 0).sum(-2), vals.masked_fill(~imag, 0).sum(-2)


def _ptm_gather_back(t_re, t_im, tables):
    """t_re PTM_re + t_im PTM_im for t_re, t_im (..., D), by the gather
    tables."""
    idx, sign, imag = _unpack(tables[1])
    vals = torch.where(imag.to(torch.bool), t_im[..., idx], t_re[..., idx])
    return (vals * sign.to(t_re.dtype)).sum(-2)


def _dims(dim2: int) -> tuple[int, int]:
    """(n_qubits, d) for a bloch dimension D = 4^n, n = 1..PTM_MAX_QUBITS."""
    n = int(round(math.log(dim2, 4))) if dim2 > 0 else 0
    if dim2 != 4**n or not 1 <= n <= PTM_MAX_QUBITS:
        raise ValueError(
            f"bloch dimension must be 4^n with 1 <= n <= {PTM_MAX_QUBITS}, got {dim2}"
        )
    return n, 2**n


def rhor_mle_reference(freq, bloch0, w2, n_iter: int, tol: float | None = None):
    """Plain PyTorch RrhoR iteration, the same math as the kernel.

    freq (..., K) count fractions, bloch0 (..., D) full-rank starts, w2
    (K, D) weighted POVM rows * 2^n. Runs `n_iter` iterations; with `tol`,
    it stops early once max |bloch change| over the whole batch is not
    above `tol` (the stop of the JAX package's XLA loop).
    """
    n, dim = _dims(w2.shape[-1])
    ptm_re, ptm_im, _, _ = _ptm_parts(n, w2.dtype, w2.device)
    batch_shape = tuple(bloch0.shape[:-1])
    mats = batch_shape + (dim, dim)

    bloch = bloch0
    for _ in range(n_iter):
        probs = bloch @ w2.T
        c = freq / probs.clamp(min=EPS)
        r = c @ w2
        rre = (r @ ptm_re.T).reshape(mats)
        rim = (r @ ptm_im.T).reshape(mats)
        pre = (bloch @ ptm_re.T).reshape(mats)
        pim = (bloch @ ptm_im.T).reshape(mats)
        sre = rre @ pre - rim @ pim
        sim = rre @ pim + rim @ pre
        tre = sre @ rre - sim @ rim
        tim = sre @ rim + sim @ rre
        new = (
            tre.reshape(batch_shape + (-1,)) @ ptm_re
            + tim.reshape(batch_shape + (-1,)) @ ptm_im
        ) / dim
        new = new / (dim * new[..., 0:1])
        if tol is not None:
            delta = float((new - bloch).abs().max())
            bloch = new
            if not delta > tol:
                break
        else:
            bloch = new
    return bloch


def _flat_operands(w2, n_qubits: int):
    """(G_re, G_im), each (K, D): G_x = w2 PTM_x^T / d, in the dtype and on
    the device of `w2`. G [t_re; t_im] gives the POVM probabilities of the
    transposed density matrix t, and d G^T c the R operator."""
    ptm_re, ptm_im, _, _ = _ptm_parts(n_qubits, w2.dtype, w2.device)
    d = 2**n_qubits
    return w2 @ ptm_re.T / d, w2 @ ptm_im.T / d


@functools.lru_cache(maxsize=8)
def _fold_tables(n_qubits: int, device: torch.device):
    """(src, upper, low, sign), each a (D,) tensor on `device`: the fold of
    a Hermitian d x d matrix (re, im), row-major over i = a d + e, to its D
    real entries F[i] = re[a, e] for a <= e and im[e, a] for a > e.

    fold: F = where(upper, re[src], im[src]); unfold: re = F[src],
    im = sign F[low], with src the mirrored index e d + a where a > e, low
    the mirrored index where a < e, and sign +1 above the diagonal, -1
    below it, 0 on it."""
    d = 2**n_qubits
    i = np.arange(d * d)
    a, e = np.divmod(i, d)
    mirror = e * d + a
    upper = a <= e
    tables = (np.where(upper, i, mirror), upper, np.where(upper, mirror, i), np.sign(e - a))
    return tuple(torch.as_tensor(t, device=device) for t in tables)


def _fold(re, im):
    """F (..., D) of the Hermitian pair (re, im), each (..., D)."""
    src, upper, _, _ = _fold_tables(_dims(re.shape[-1])[0], re.device)
    return torch.where(upper, re[..., src], im[..., src])


def _unfold(f):
    """The Hermitian pair (re, im), each (..., D), of its fold F (..., D)."""
    src, _, low, sign = _fold_tables(_dims(f.shape[-1])[0], f.device)
    return f[..., src], f[..., low] * sign.to(f.dtype)


def _flat_fold_operands(w2, n_qubits: int):
    """The flat kernel's operands, in the dtype and on the device of `w2`.

    With H (K, D) the fold of each row of [G_re | G_im] (`_flat_operands`;
    for every k, G_re[k] is symmetric and G_im[k] antisymmetric as d x d
    matrices) and w 1 on the diagonal and 2 off it:

    - hw_t (D, K) = (H o w)^T, so that p = F @ hw_t;
    - h_d (K, D) = d H, so that c @ h_d is the fold of R; a new tensor, so
      its storage is 16-byte aligned for the kernel's vector loads;
    - entry (D, D) = P_in^T, so that F = bloch0 @ entry is the fold of
      (bloch0 PTM_re^T, bloch0 PTM_im^T);
    - exit (D, D) = P_out, so that bloch = F @ exit / d.
    """
    ptm_re, ptm_im, ptm_re_t, ptm_im_t = _ptm_parts(n_qubits, w2.dtype, w2.device)
    src, _, low, sign = _fold_tables(n_qubits, w2.device)
    d = 2**n_qubits
    h = _fold(*_flat_operands(w2, n_qubits))
    weight = torch.full((d * d,), 2.0, dtype=w2.dtype, device=w2.device)
    weight[torch.arange(d, device=w2.device) * (d + 1)] = 1.0
    exit_map = torch.zeros_like(ptm_re).index_add_(0, src, ptm_re)
    exit_map.index_add_(0, low, sign.to(w2.dtype)[:, None] * ptm_im)
    return (h * weight).T.contiguous(), d * h, _fold(ptm_re_t, ptm_im_t), exit_map


def _karatsuba(a_re, a_im, b_re, b_im):
    """Complex batched matmul from three real ones."""
    p1 = a_re @ b_re
    p2 = a_im @ b_im
    p3 = (a_re + a_im) @ (b_re + b_im)
    return p1 - p2, p3 - p1 - p2


def rhor_mle_flat_reference(freq, bloch0, w2, n_iter: int):
    """Plain PyTorch flat-matrix RrhoR iteration, the same math as the flat
    kernel: the loop state is the transposed density matrix (t_re, t_im),
    renormalised to unit trace every iteration. freq (..., K), bloch0
    (..., D), w2 (K, D) as for `rhor_mle_reference`; always `n_iter`
    iterations."""
    n, dim = _dims(w2.shape[-1])
    ptm_re, ptm_im, _, _ = _ptm_parts(n, w2.dtype, w2.device)
    g_re, g_im = _flat_operands(w2, n)
    batch_shape = tuple(bloch0.shape[:-1])
    mats = batch_shape + (dim, dim)
    diag = torch.arange(dim, device=w2.device) * (dim + 1)

    t_re, t_im = bloch0 @ ptm_re.T, bloch0 @ ptm_im.T
    for _ in range(n_iter):
        probs = t_re @ g_re.T + t_im @ g_im.T
        tr = t_re[..., diag].sum(-1, keepdim=True)
        c = freq * tr / probs.clamp(min=EPS)
        r_re = ((c @ g_re) * dim).reshape(mats)
        r_im = ((c @ g_im) * dim).reshape(mats)
        s_re, s_im = _karatsuba(r_re, r_im, t_re.reshape(mats), t_im.reshape(mats))
        u_re, u_im = _karatsuba(s_re, s_im, r_re, r_im)
        inv = 1.0 / u_re.diagonal(dim1=-2, dim2=-1).sum(-1).clamp(min=EPS)
        t_re = u_re.reshape(batch_shape + (-1,)) * inv[..., None]
        t_im = u_im.reshape(batch_shape + (-1,)) * inv[..., None]
    return (t_re @ ptm_re + t_im @ ptm_im) / dim


def _rhor_mle_flat_folded(freq, bloch0, w2, n_iter: int):
    """Plain PyTorch statement of what the flat kernel computes: the
    iteration of `rhor_mle_flat_reference` with the Hermitian state folded
    to its D real entries F (`_fold`), so both POVM products are K x D.
    Per iteration: p = F hw_t, c = f tr / max(p, eps), R = unfold(c h_d),
    S = R t with t = unfold(F), then only the fold of U = S R (Re U[a, e]
    for a <= e, -Im U[a, e] for a > e), renormalised to unit trace."""
    n, dim = _dims(w2.shape[-1])
    hw_t, h_d, entry, exit_map = _flat_fold_operands(w2, n)
    upper = _fold_tables(n, w2.device)[1]
    batch_shape = tuple(bloch0.shape[:-1])
    mats = batch_shape + (dim, dim)
    diag = torch.arange(dim, device=w2.device) * (dim + 1)

    f = bloch0 @ entry
    for _ in range(n_iter):
        tr = f[..., diag].sum(-1, keepdim=True)
        c = freq * tr / (f @ hw_t).clamp(min=EPS)
        r_re, r_im = (x.reshape(mats) for x in _unfold(c @ h_d))
        t_re, t_im = (x.reshape(mats) for x in _unfold(f))
        s_re, s_im = _karatsuba(r_re, r_im, t_re, t_im)
        u_re, u_im = _karatsuba(s_re, s_im, r_re, r_im)
        flat = batch_shape + (-1,)
        u = torch.where(upper, u_re.reshape(flat), -u_im.reshape(flat))
        f = u / u[..., diag].sum(-1, keepdim=True).clamp(min=EPS)
    return f @ exit_map / dim


def _check(freq, bloch0, w2, n_iter):
    for name, t in (("freq", freq), ("bloch0", bloch0), ("w2", w2)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name} must be float32 or float64, got {t.dtype}")
        if t.dtype != freq.dtype or t.device != freq.device:
            raise ValueError("freq, bloch0 and w2 must share one dtype and device")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (b, k), (k2, d2) = freq.shape, w2.shape
    if k2 != k or tuple(bloch0.shape) != (b, d2):
        raise ValueError(
            f"shapes must be (B, K), (B, D), (K, D); got {tuple(freq.shape)}, "
            f"{tuple(bloch0.shape)}, {tuple(w2.shape)}"
        )
    if b == 0 or k == 0:
        raise ValueError("empty batch or POVM")
    if not isinstance(n_iter, int) or n_iter < 0:
        raise ValueError(f"n_iter must be a non-negative int, got {n_iter!r}")
    if freq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the RrhoR kernels run on cpu or cuda tensors, got {freq.device}")
    return _dims(d2)


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """Build and load csrc/<name>.cu; declare its C signatures. Each kernel
    library exports <name>_f32 and <name>_f64 (freq, bloch0, the kernel's
    four operands, out, scratch, B, K, D, d, n_iter, grid, stream), and
    <name>_tile, <name>_smem_limit and <name>_error_string."""
    from . import _build

    lib = _build.load(name)
    p, i = ctypes.c_void_p, ctypes.c_int
    for dtype in ("f32", "f64"):
        fn = getattr(lib, f"{name}_{dtype}")
        fn.argtypes = [p] * 8 + [i] * 6 + [p]
        fn.restype = i
    for suffix in ("tile", "smem_limit"):
        fn = getattr(lib, f"{name}_{suffix}")
        fn.argtypes = [i]
        fn.restype = i
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return lib


def _launch(name, freq, bloch0, operands, d, n_iter, state_rows):
    """Launch csrc/<name>.cu on the current stream and return the output.

    `operands` are the kernel's tensors between bloch0 and out in its C
    interface; a block keeps `state_rows` rows of tile-width values, in
    shared memory when they fit and otherwise in a global scratch buffer."""
    lib = _library(name)
    error_string = getattr(lib, f"{name}_error_string")
    b, k = freq.shape
    d2 = bloch0.shape[-1]
    is_double = freq.dtype == torch.float64
    device = freq.device
    out = torch.empty_like(bloch0)
    tile = getattr(lib, f"{name}_tile")(int(is_double))
    n_tiles = -(-b // tile)
    tile_bytes = freq.element_size() * tile * state_rows
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        smem_limit = getattr(lib, f"{name}_smem_limit")(index)
        if smem_limit < 0:
            raise RuntimeError(
                f"{name} cannot read the shared-memory limit: "
                + error_string(-smem_limit).decode()
            )
        if tile_bytes <= smem_limit:
            grid, scratch = n_tiles, None
        else:
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            grid = min(n_tiles, 2 * sms)
            scratch = torch.empty(grid * tile * state_rows, dtype=freq.dtype, device=device)
        fn = getattr(lib, f"{name}_{'f64' if is_double else 'f32'}")
        err = fn(
            freq.data_ptr(), bloch0.data_ptr(), *(t.data_ptr() for t in operands),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, k, d2, d, n_iter, grid, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: {error_string(err).decode()}")
    return out


def _lane_operands(w2, n_qubits: int):
    """The lane kernel's operands: w2, which it reads in 16-byte vectors (so
    it is copied if its storage is not 16-byte aligned), w2^T, and the PTM
    gather tables."""
    if w2.data_ptr() % 16:
        w2 = w2.clone()
    return (w2, w2.T.contiguous(), *_ptm_gather_tables(n_qubits, w2.device))


def rhor_mle(freq, bloch0, w2, n_iter: int = 60):
    """Fused RrhoR MLE: `n_iter` fixed iterations per resample.

    freq (B, K) count fractions, bloch0 (B, D) full-rank starting blochs,
    w2 (K, D) weighted POVM rows * 2^n, one dtype (float32 or float64) and
    one device. Returns (B, D) estimate blochs. On CUDA it launches the
    kernel on the current stream without synchronizing and adds one to
    `rhor_mle.launches`; on the CPU it runs `rhor_mle_reference`.
    """
    n, d = _check(freq, bloch0, w2, n_iter)
    if freq.device.type == "cpu":
        return rhor_mle_reference(freq, bloch0, w2, n_iter)
    k, d2 = w2.shape
    out = _launch("rhor_mle", freq, bloch0, _lane_operands(w2, n), d, n_iter, k + 7 * d2)
    rhor_mle.launches += 1
    return out


def rhor_mle_flat(freq, bloch0, w2, n_iter: int = 60):
    """Flat-matrix fused RrhoR MLE, the same contract and fixed point as
    `rhor_mle`: the loop state is the density matrix, so the Pauli transfer
    matrix is applied only at entry and exit. The kernel keeps the state
    folded to its D real entries (`_rhor_mle_flat_folded`). On CUDA it
    launches the flat kernel on the current stream without synchronizing
    and adds one to `rhor_mle_flat.launches`; on the CPU it runs
    `rhor_mle_flat_reference`.
    """
    n, d = _check(freq, bloch0, w2, n_iter)
    if freq.device.type == "cpu":
        return rhor_mle_flat_reference(freq, bloch0, w2, n_iter)
    k, d2 = w2.shape
    operands = _flat_fold_operands(w2, n)
    out = _launch("rhor_mle_flat", freq, bloch0, operands, d, n_iter, k + 7 * d2)
    rhor_mle_flat.launches += 1
    return out


#: kernel launches since the count was last reset to 0
rhor_mle.launches = 0
rhor_mle_flat.launches = 0
