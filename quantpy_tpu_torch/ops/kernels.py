"""The fused RrhoR MLE kernel and its plain PyTorch version.

`rhor_mle` runs `n_iter` fixed RrhoR iterations for a batch of resamples.
On CUDA tensors it launches the hand-written kernel of
`csrc/rhor_mle.cu` (the port of quantpy_tpu/ops/kernels.py::rhor_mle_pallas);
on CPU tensors it runs `rhor_mle_reference`, the same math in plain
PyTorch. A CUDA tensor reaches the kernel or the call raises.

Both work in the transposed matrix space of the JAX package: the row-major
reshape of the column-stacked vec(A) is A^T, and the palindrome R rho R is
closed under transposition, so nothing is ever untransposed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .paulis import PTM_MAX_QUBITS, _pauli_transfer_np

__all__ = ["rhor_mle", "rhor_mle_reference"]

EPS = 1e-10


@functools.lru_cache(maxsize=8)
def _ptm_parts(n_qubits: int, dtype: torch.dtype, device: torch.device):
    """(PTM_re, PTM_im, PTM_re^T, PTM_im^T) as contiguous real tensors."""
    ptm = _pauli_transfer_np(n_qubits)
    re = torch.as_tensor(ptm.real, dtype=dtype, device=device).contiguous()
    im = torch.as_tensor(ptm.imag, dtype=dtype, device=device).contiguous()
    return re, im, re.T.contiguous(), im.T.contiguous()


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
    return _dims(d2)


@functools.lru_cache(maxsize=None)
def _library():
    """Build and load the kernel library; declare its C signatures."""
    from . import _build

    lib = _build.load("rhor_mle")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rhor_mle_f32, lib.rhor_mle_f64):
        fn.argtypes = [p] * 10 + [i] * 6 + [p]
        fn.restype = i
    lib.rhor_mle_tile.argtypes = [i]
    lib.rhor_mle_tile.restype = i
    lib.rhor_mle_smem_limit.argtypes = [i]
    lib.rhor_mle_smem_limit.restype = i
    lib.rhor_mle_error_string.argtypes = [i]
    lib.rhor_mle_error_string.restype = ctypes.c_char_p
    return lib


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
    if freq.device.type != "cuda":
        raise ValueError(f"rhor_mle runs on cpu or cuda tensors, got {freq.device}")

    lib = _library()
    b, k = freq.shape
    d2 = w2.shape[-1]
    is_double = freq.dtype == torch.float64
    device = freq.device
    ptm_re, ptm_im, ptm_re_t, ptm_im_t = _ptm_parts(n, freq.dtype, device)
    w2t = w2.T.contiguous()
    out = torch.empty_like(bloch0)
    tile = lib.rhor_mle_tile(int(is_double))
    n_tiles = -(-b // tile)
    tile_bytes = freq.element_size() * tile * (k + 7 * d2)
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        smem_limit = lib.rhor_mle_smem_limit(index)
        if smem_limit < 0:
            raise RuntimeError(
                "rhor_mle cannot read the shared-memory limit: "
                + lib.rhor_mle_error_string(-smem_limit).decode()
            )
        if tile_bytes <= smem_limit:
            grid, scratch = n_tiles, None
        else:
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            grid = min(n_tiles, 2 * sms)
            scratch = torch.empty(grid * tile * (k + 7 * d2), dtype=freq.dtype, device=device)
        fn = lib.rhor_mle_f64 if is_double else lib.rhor_mle_f32
        err = fn(
            freq.data_ptr(), bloch0.data_ptr(), w2.data_ptr(), w2t.data_ptr(),
            ptm_re.data_ptr(), ptm_im.data_ptr(), ptm_re_t.data_ptr(),
            ptm_im_t.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, k, d2, d, n_iter, grid, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"rhor_mle kernel launch failed: {lib.rhor_mle_error_string(err).decode()}"
        )
    rhor_mle.launches += 1
    return out


#: kernel launches since the count was last reset to 0
rhor_mle.launches = 0
