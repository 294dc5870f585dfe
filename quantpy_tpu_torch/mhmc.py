"""Metropolis-Hastings chains on the device (port of quantpy_tpu/mhmc.py).

A chain is a Python loop of steps on the device of its state. Chains run
side by side along a leading chain axis: a target takes states (..., dim)
and returns log-densities (...), and every step moves all chains at once.
Randomness comes from an explicit `torch.Generator` on the chain's device.

Each step is a pure function of its draws (`mh_step`: the displacement
`delta` and `log_u`; `mala_step`: the normal `xi` and `log_u`); `_run_chain`
draws them from the generator and calls the step. Accepted counts add up on
the device and kept samples go into a preallocated tensor, so a span of
steps reads nothing on the host until it ends.

The proposal is an isotropic normal by default; `update_rule(x, delta,
step)` maps a displacement to the proposed point (`basic_update`,
`normalized_update`, or `ProcessTomograph._cptp_update_rule`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import get_device, rdtype
from .tomography.state import make_generator

__all__ = [
    "MHMC",
    "basic_update",
    "normalized_update",
    "from_scipy_frozen",
    "resolve_jump_distr",
    "autograd_drift",
    "mh_step",
    "mala_step",
    "split_rhat",
    "effective_sample_size",
    "maximize_logpdf",
]


def _value_and_grad(logpdf, x):
    """logpdf(x) and its gradient in x, from one forward and one backward
    pass. The chains along the leading axes are independent, so the
    gradient of the sum is each chain's own gradient."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        value = logpdf(xg)
        (grad,) = torch.autograd.grad(value.sum(), xg)
    return value.detach(), grad


class _AutogradDrift:
    """The gradient of a log-density by autograd, as a drift function."""

    def __init__(self, logpdf):
        self.logpdf = logpdf

    def __call__(self, x):
        return _value_and_grad(self.logpdf, x)[1]


def autograd_drift(logpdf):
    """MALA's drift, the gradient of `logpdf`, by autograd. Given to `MHMC`
    with the same `logpdf`, the chain takes value and drift from one
    forward pass."""
    return _AutogradDrift(logpdf)


def _value_and_drift(logpdf, drift_fn, x):
    if isinstance(drift_fn, _AutogradDrift) and drift_fn.logpdf is logpdf:
        return _value_and_grad(logpdf, x)
    return logpdf(x), drift_fn(x)


def maximize_logpdf(logpdf, x0, n_steps: int = 500, lr: float = 3e-3):
    """Ascend a log-density with Adam, optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8, bias-corrected), on the autograd gradient of -logpdf.

    The mode-seeking warm start of the process chains: a chain started in
    the transient region adapts its step to the transient gradient, and the
    adapted step is then far too small to mix (the JAX package measured 8e-8
    against ~1e-2 at the mode on 4-qubit process chains). `x0` is a tensor
    (its dtype and device are kept) or an array (then the port's defaults).
    Returns the ascended point as a tensor."""
    x = _as_state(x0)
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    for t in range(1, int(n_steps) + 1):
        g = -_value_and_grad(logpdf, x)[1]
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g**2 + b2 * nu
        mu_hat = mu / (1 - b1**t)
        nu_hat = nu / (1 - b2**t)
        x = x - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return x


def _as_state(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(np.asarray(x), dtype=rdtype(), device=get_device())


def basic_update(x, delta, step):
    """x + step * delta."""
    return x + step * delta


def normalized_update(x, delta, step):
    """x + step * delta, renormalized to ||x|| = 1 along the last axis."""
    x_new = x + step * delta
    return x_new / torch.linalg.vector_norm(x_new, dim=-1, keepdim=True)


# -- proposal samplers: callable(generator, shape, dtype, device) -> delta ----
#
# torch.distributions samplers take no generator, so the heavy-tailed
# families are drawn by inverse CDF from the generator's uniforms.


def _uniform(gen, shape, dtype, device, lo: float = 0.0, hi: float = 1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _laplace(gen, shape, dtype, device):
    eps = torch.finfo(dtype).eps
    u = _uniform(gen, shape, dtype, device, -1.0, 1.0).clamp(min=-1.0 + eps)
    return -torch.sign(u) * torch.log1p(-u.abs())


def _cauchy(gen, shape, dtype, device):
    u = _uniform(gen, shape, dtype, device).clamp(min=torch.finfo(dtype).tiny)
    return torch.tan(math.pi * (u - 0.5))


def _logistic(gen, shape, dtype, device):
    u = _uniform(gen, shape, dtype, device).clamp(min=torch.finfo(dtype).tiny)
    return torch.log(u) - torch.log1p(-u)


def _gamma(gen, shape, dtype, device, a: float):
    """Gamma(a, 1) draws by Marsaglia and Tsang's squeeze (a < 1 through
    Gamma(a + 1) U^(1/a)). The rejection loop ends when every element has
    accepted: one host read per round (about 4% rejected per round)."""
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.zeros(shape, dtype=dtype, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        z = _normal(gen, shape, dtype, device)
        v = (1.0 + c * z) ** 3
        log_u = torch.log(_uniform(gen, shape, dtype, device).clamp(min=torch.finfo(dtype).tiny))
        ok = (v > 0) & (log_u < 0.5 * z * z + d - d * v + d * torch.log(v.clamp(min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if boost:
        u = _uniform(gen, shape, dtype, device).clamp(min=torch.finfo(dtype).tiny)
        out = out * u ** (1.0 / a)
    return out


def _student_t(gen, shape, dtype, device, df: float):
    """Student t: a normal over sqrt(Gamma(df/2) / (df/2))."""
    z = _normal(gen, shape, dtype, device)
    g = _gamma(gen, shape, dtype, device, df / 2.0)
    return z * torch.sqrt((df / 2.0) / g)


#: named symmetric proposals
_JUMP_DISTRS = {
    "normal": _normal,
    "uniform": lambda gen, shape, dtype, device: _uniform(gen, shape, dtype, device, -1.0, 1.0),
    "laplace": _laplace,
    "cauchy": _cauchy,
}

_LOG_2PI = math.log(2 * math.pi)

#: scipy frozen families: name -> (standard sampler, standardized log-density)
_SCIPY_FAMILIES = {
    "norm": (_normal, lambda z: -0.5 * z**2 - 0.5 * _LOG_2PI),
    "laplace": (_laplace, lambda z: -z.abs() - math.log(2.0)),
    "cauchy": (_cauchy, lambda z: -torch.log(math.pi * (1.0 + z**2))),
    "logistic": (_logistic, lambda z: -z - 2.0 * torch.log1p(torch.exp(-z))),
    "t": (
        _student_t,
        lambda z, df: (
            math.lgamma((df + 1) / 2)
            - math.lgamma(df / 2)
            - 0.5 * math.log(df * math.pi)
            - (df + 1) / 2 * torch.log1p(z**2 / df)
        ),
    ),
}


def from_scipy_frozen(frozen):
    """Adapt a scipy frozen distribution to a device chain: returns
    (sampler(generator, shape, dtype, device), jump_logpdf(delta (..., dim))
    -> (...), symmetric).

    norm, uniform, laplace, cauchy, logistic and t are translated, with any
    loc and scale: the sampler and the Hastings log-density of the whole
    displacement (summed over the last axis), and `symmetric` from the
    parameters, so that an asymmetric proposal is corrected as the
    reference corrects it with pdf(-delta) / pdf(delta). Other families
    raise."""
    name = getattr(getattr(frozen, "dist", None), "name", None)
    shapes, loc_, scale_ = frozen.dist._parse_args(*frozen.args, **frozen.kwds)
    shape_args = tuple(float(a) for a in shapes)
    loc, scale = float(loc_), float(scale_)
    if name == "uniform":
        lo, hi = loc, loc + scale

        def sampler(gen, shape, dtype, device):
            return _uniform(gen, shape, dtype, device, lo, hi)

        def jump_logpdf(delta):
            inside = ((delta >= lo) & (delta <= hi)).all(-1)
            inside_value = -delta.shape[-1] * math.log(scale)
            return torch.where(
                inside,
                torch.full_like(inside, inside_value, dtype=delta.dtype),
                torch.full_like(inside, -math.inf, dtype=delta.dtype),
            )

        return sampler, jump_logpdf, bool(abs(lo + hi) < 1e-12 * abs(scale))
    if name not in _SCIPY_FAMILIES:
        raise NotImplementedError(
            f"scipy frozen family {name!r} has no adapter; supported: "
            f"{sorted(_SCIPY_FAMILIES) + ['uniform']}. Pass a "
            "callable(generator, shape, dtype, device) (+ jump_logpdf if "
            "asymmetric) instead."
        )
    base_sample, base_logpdf = _SCIPY_FAMILIES[name]

    def sampler(gen, shape, dtype, device):
        return loc + scale * base_sample(gen, shape, dtype, device, *shape_args)

    def jump_logpdf(delta):
        z = (delta - loc) / scale
        return base_logpdf(z, *shape_args).sum(-1) - delta.shape[-1] * math.log(scale)

    return sampler, jump_logpdf, loc == 0.0


def _is_scipy_frozen(obj) -> bool:
    return hasattr(obj, "dist") and hasattr(obj, "rvs") and hasattr(obj, "kwds")


def resolve_jump_distr(jump_distr):
    """A proposal spec (None, a name, a scipy frozen distribution or a
    callable(generator, shape, dtype, device)) as a sampler callable."""
    if jump_distr is None:
        return _JUMP_DISTRS["normal"]
    if isinstance(jump_distr, str):
        if jump_distr not in _JUMP_DISTRS:
            raise ValueError(
                f"Unknown jump_distr {jump_distr!r}; available: "
                f"{sorted(_JUMP_DISTRS)} or a callable(generator, shape, dtype, device)"
            )
        return _JUMP_DISTRS[jump_distr]
    if _is_scipy_frozen(jump_distr):
        return from_scipy_frozen(jump_distr)[0]
    if callable(jump_distr):
        return jump_distr
    raise NotImplementedError(
        "jump_distr must be None, a name, a scipy frozen distribution "
        "(adapted by from_scipy_frozen), or a callable(generator, shape, dtype, device)"
    )


# -- one step -------------------------------------------------------------------


def _select(accept, new, old):
    return torch.where(accept[..., None], new, old)


def mh_step(x, logp_x, delta, log_u, logpdf, update_rule, step, jump_logpdf=None,
            refresh_logp: bool = False):
    """One Metropolis(-Hastings) step of the chains x (..., dim) with the
    displacement `delta` (..., dim) and the log-uniforms `log_u` (...).

    `jump_logpdf` (callable(delta (..., dim)) -> (...)) adds the Hastings
    term log q(-delta) - log q(delta) of an asymmetric proposal.
    `refresh_logp` evaluates the target at the current state instead of
    carrying `logp_x`: an f32 target with O(1) evaluation noise otherwise
    sticks on its positive noise. A proposal whose target is NaN is
    rejected. Returns (x, logp, accepted (...))."""
    if refresh_logp:
        logp_x = logpdf(x)
    x_prime = update_rule(x, delta, step)
    logp_prime = logpdf(x_prime)
    log_ratio = logp_prime - logp_x
    if jump_logpdf is not None:
        log_ratio = log_ratio + jump_logpdf(-delta) - jump_logpdf(delta)
    accept = log_u <= log_ratio
    return _select(accept, x_prime, x), torch.where(accept, logp_prime, logp_x), accept


def mala_step(x, logp_x, drift_x, xi, log_u, logpdf, drift_fn, step,
              refresh_logp: bool = False):
    """One MALA step with the standard normals `xi` (..., dim): the
    proposal x' = x + (step^2 / 2) drift(x) + step xi, accepted with the
    exact state-dependent Hastings ratio q(x | x') / q(x' | x).

    The reverse proposal's residual is written as
    xi + (step / 2) (drift(x) + drift(x')), never as a difference of x and
    x': that difference is pure float32 rounding once step < eps |x| (the
    JAX package measured a chain frozen at acceptance 0 by it at 4 qubits).
    Returns (x, logp, drift, accepted)."""
    if refresh_logp:
        logp_x = logpdf(x)
    x_prime = x + (0.5 * step * step) * drift_x + step * xi
    logp_prime, drift_prime = _value_and_drift(logpdf, drift_fn, x_prime)
    bwd_res = xi + (0.5 * step) * (drift_x + drift_prime)
    lq_fwd = -0.5 * (xi**2).sum(-1)
    lq_bwd = -0.5 * (bwd_res**2).sum(-1)
    log_ratio = logp_prime - logp_x + lq_bwd - lq_fwd
    accept = log_u <= log_ratio
    return (
        _select(accept, x_prime, x),
        torch.where(accept, logp_prime, logp_x),
        _select(accept, drift_prime, drift_x),
        accept,
    )


@torch.no_grad()
def _run_chain(gen, x0, logpdf, update_rule, jump_fn, step, n_steps: int, keep_every=None,
               jump_logpdf=None, drift_fn=None, refresh_logp: bool = False):
    """Run the chains x0 (..., dim) for `n_steps` steps. Keeps every
    `keep_every`-th state, the states at steps keep_every - 1,
    2 keep_every - 1, ... (0-based; the JAX package's
    xs[keep_every-1::keep_every]), in a tensor (n_keep, ..., dim);
    `keep_every` None keeps none. With `drift_fn` the chain is MALA and
    `jump_fn` must draw standard normals. Returns (kept, accepted count as
    a device tensor, final state)."""
    x = x0
    shape, dtype, device = x.shape, x.dtype, x.device
    n_keep = 0 if keep_every is None else int(n_steps) // int(keep_every)
    kept = x.new_empty((n_keep,) + tuple(shape))
    accepted = torch.zeros((), dtype=torch.int64, device=device)
    if drift_fn is not None:
        logp, drift = _value_and_drift(logpdf, drift_fn, x)
    else:
        logp = logpdf(x)
    for t in range(int(n_steps)):
        delta = jump_fn(gen, shape, dtype, device)
        u = torch.rand(shape[:-1], generator=gen, dtype=dtype, device=device)
        log_u = torch.log(u)
        if drift_fn is not None:
            x, logp, drift, accept = mala_step(
                x, logp, drift, delta, log_u, logpdf, drift_fn, step, refresh_logp
            )
        else:
            x, logp, accept = mh_step(
                x, logp, delta, log_u, logpdf, update_rule, step, jump_logpdf, refresh_logp
            )
        accepted += accept.sum()
        if n_keep and (t + 1) % keep_every == 0:
            kept[(t + 1) // keep_every - 1] = x
    return kept, accepted, x


# -- diagnostics --------------------------------------------------------------


def split_rhat(chains) -> float:
    """Split-R-hat (Gelman et al.) of a scalar series per chain, chains
    (n_chains, n_samples). Near 1 the chains have mixed; above ~1.05 they
    have not."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    x = np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)
    m, n = x.shape
    chain_means = x.mean(axis=1)
    b = n * chain_means.var(ddof=1)
    w = x.var(axis=1, ddof=1).mean()
    if w == 0:
        return 1.0
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def effective_sample_size(chains) -> float:
    """Multi-chain effective sample size of a scalar series, from FFT
    autocorrelations with Geyer's initial-positive-sequence truncation."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    if n < 4:
        return float(m * n)
    x = x - x.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real
    acov /= np.arange(n, 0, -1)[None, :]
    denom = acov[:, 0].mean()
    if denom == 0:
        return float(m * n)
    rho = acov.mean(axis=0) / denom
    tau = 1.0
    t = 1
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        tau += 2 * pair
        t += 2
    return float(m * n / max(tau, 1e-12))


class MHMC:
    """Metropolis-Hastings sampler over an unnormalized log-density.

    Parameters
    ----------
    target_logpdf : callable(x (..., dim)) -> (...)
    jump_distr : None, str, scipy frozen distribution, or callable
        The proposal. None is the isotropic normal; a name from
        {'normal', 'uniform', 'laplace', 'cauchy'}; a scipy frozen
        distribution (norm, uniform, laplace, cauchy, logistic or t with any
        loc and scale, adapted by `from_scipy_frozen`, with the Hastings
        correction on when it is asymmetric); or a
        callable(generator, shape, dtype, device) -> delta, where the JAX
        package takes a callable(key, shape, dtype). A callable is taken as
        symmetric unless symmetric=False and `jump_logpdf` are given.
    step : float, the proposal scale
    burn_steps : int
    dim : int, the state dimension
    update_rule : callable(x, delta, step) or None (basic_update)
    symmetric : bool; False needs `jump_logpdf`
    jump_logpdf : callable(delta (..., dim)) -> (...), the log-density of
        the displacement, for the Hastings correction
    x_init : tensor, array or None (uniform random)
    key : int seed or torch.Generator (default seed 0)
    drift_fn : callable(x) -> grad log pi(x), or None; switches to MALA
        (`autograd_drift(target_logpdf)` is the autograd gradient)
    refresh_logp : bool, see `mh_step`

    The chain lives on the device and in the dtype of a tensor `x_init`;
    an array or the random start takes the port's defaults.
    """

    def __init__(
        self,
        target_logpdf,
        jump_distr=None,
        step: float = 0.01,
        burn_steps: int = 100,
        dim: int = 1,
        update_rule=None,
        symmetric: bool = True,
        x_init=None,
        key=None,
        jump_logpdf=None,
        drift_fn=None,
        refresh_logp: bool = False,
    ):
        if _is_scipy_frozen(jump_distr):
            sampler, logq, sym = from_scipy_frozen(jump_distr)
            jump_distr = sampler
            if not sym:
                symmetric = False
                if jump_logpdf is None:
                    jump_logpdf = logq
        self.jump_fn = resolve_jump_distr(jump_distr)
        if not symmetric and jump_logpdf is None:
            raise ValueError(
                "symmetric=False needs `jump_logpdf`: a callable(delta) -> log q(delta) "
                "for the Hastings correction"
            )
        if drift_fn is not None and jump_distr is not None:
            raise ValueError(
                "MALA (drift_fn) requires the standard-normal proposal; leave jump_distr=None"
            )
        self.jump_logpdf = None if symmetric else jump_logpdf
        self.drift_fn = drift_fn
        self.refresh_logp = bool(refresh_logp)
        self.target_logpdf = target_logpdf
        self.step = step
        self.burn_steps = burn_steps
        self.dim = dim
        self.update_rule = update_rule if update_rule is not None else basic_update
        if isinstance(x_init, torch.Tensor):
            device = x_init.device
        elif isinstance(key, torch.Generator):
            device = key.device
        else:
            device = get_device()
        self.generator = make_generator(0 if key is None else key, device)
        if x_init is None:
            x_init = torch.rand(dim, generator=self.generator, dtype=rdtype(), device=device)
        self.x_t = _as_state(x_init)
        self.burned = False

    def _run_span(self, x0, n_steps: int, keep_every=None):
        """`_run_chain` from x0 with this sampler's settings; returns (kept,
        accepted count as a float, final state). The count is the span's
        one host read."""
        kept, accepted, x = _run_chain(
            self.generator, x0, self.target_logpdf, self.update_rule, self.jump_fn,
            self.step, int(n_steps), keep_every, jump_logpdf=self.jump_logpdf,
            drift_fn=self.drift_fn, refresh_logp=self.refresh_logp,
        )
        return kept, float(accepted), x

    def adapt_step(
        self,
        target_rate: float = 0.25,
        segment: int = 200,
        max_rounds: int = 12,
        bounds: tuple = (0.05, 0.5),
        confirm: int = 1,
    ) -> float:
        """Tune the proposal scale during burn-in toward an acceptance-rate
        window: run segments of `segment` steps, halving `step` under the
        window and doubling it (at most to 64 times the start) above, until
        `confirm` consecutive segments land in `bounds` or `max_rounds`
        have run. `confirm` > 1 guards against the acceptance of a chain
        still descending from a start away from the mode. Leaves the chain
        burned at the adapted scale and returns the step."""
        del target_rate  # the window `bounds` decides, as in the JAX package
        lo, hi = bounds
        streak = 0
        step0 = self.step
        for _ in range(max_rounds):
            _, accepted, self.x_t = self._run_span(self.x_t, segment)
            rate = accepted / segment
            if rate < lo:
                self.step /= 2.0
                streak = 0
            elif rate > hi:
                # capped growth: on a near-flat target acceptance stays ~1 at
                # any scale, and unbounded doubling throws the chain far out
                self.step = min(self.step * 2.0, 64.0 * step0)
                streak = 0
            else:
                streak += 1
                if streak >= confirm:
                    break
        self.burned = True
        return self.step

    def sample(self, n_samples: int, thinning: int = 1, verbose: bool = False):
        """Draw samples (burning in first if needed). Returns (samples
        (n_samples, dim) as numpy, acceptance rate); `verbose` is accepted
        for API parity."""
        del verbose
        if not self.burned and self.burn_steps > 0:
            _, _, self.x_t = self._run_span(self.x_t, int(self.burn_steps))
            self.burned = True
        total = int(n_samples) * int(thinning)
        kept, accepted, self.x_t = self._run_span(self.x_t, total, int(thinning))
        return kept.cpu().numpy(), accepted / total

    def sample_chains(self, n_samples: int, n_chains: int, thinning: int = 1):
        """`n_chains` independent chains side by side from the current
        point, each with its own burn-in. Returns (samples
        (n_chains, n_samples, dim) as numpy, acceptance rate)."""
        x0 = self.x_t.expand((n_chains,) + tuple(self.x_t.shape)).clone()
        burn = int(self.burn_steps)
        acc_total = 0.0
        if burn > 0:
            _, acc_b, x0 = self._run_span(x0, burn)
            acc_total += acc_b
        total = int(n_samples) * int(thinning)
        kept, acc_s, _ = self._run_span(x0, total, int(thinning))
        acc_total += acc_s
        return kept.transpose(0, 1).cpu().numpy(), acc_total / (n_chains * (total + burn))
