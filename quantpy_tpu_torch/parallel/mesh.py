"""Multi-device scaling: a device mesh and the sharded bootstraps, chains
and kron operators (port of quantpy_tpu/parallel/mesh.py).

One process drives every device, as the JAX package's single-controller
`jax.sharding.Mesh` does: a `Mesh` is a list of torch devices, and every
sharded function takes it and runs on all of them from the caller's
process (no process group, no `torchrun`). A device may appear more than
once: ``make_mesh(devices=["cpu"] * 8)`` is the CPU stand-in of the JAX
tests' 8 virtual devices, and ``["cuda:0"] * 4`` runs four logical shards
on one card.

The `shard_map` specs of the JAX package translate directly:

- a batch-sharded input (``P(batch)``) is split into equal shards, each
  moved to its shard's device; a replicated one (``P()``) is copied once
  to each distinct device;
- a batch-sharded output is the `torch.cat` of the shard results on
  ``mesh.devices[0]``, a ``psum`` their sum there (sent back to each
  device where the next step needs it), an ``all_gather`` a `torch.cat`.

Two sharding modes, as in the JAX package:

1. RESAMPLE sharding: each shard runs the port's single-device program on
   its share of the resamples, trials or chains (`bootstrap_core`,
   `kron_core`, `process_core`, `verification`, `mhmc._run_chain`), so an
   f32 'mle-rhor' shard on the card hands the RrhoR kernel its batch.
2. OPERATOR sharding: the first measurement group's outcome axis of the
   kron-factored design is split over the shards, so the 6^n counts tensor
   (8.7 GB in float32 at 12 qubits) is never whole on one device, and only
   (z, 4^n) vectors and (rows, 2^n) blocks move between devices.

Random streams. ``jax.random.split(key, n)`` becomes :func:`shard_seeds`:
the generator of shard i is a `torch.Generator` on its device seeded with
``SeedSequence([seed, i])``'s first 64-bit word, the rule of
`utils.checkpoint`'s chunk seeds; a `torch.Generator` key gives up one
draw of 63 bits as the seed first. `sharded_kron_simulate` draws each
first-group outcome slice j of shard i from its own generator, seeded the
same way from ``[seed_i, j]``.

Concurrency. Every resample-sharded program reads the host before it ends
(the eigh clip's error check, Dykstra's and the polytope harness's stop
reads, a chain's accepted count), so enqueueing every shard before the
first read is impossible there: :func:`_run_shards` gives each distinct
device one worker thread, which runs that device's shards one after
another. The operator-sharded iterations read nothing per shard, so they
enqueue every shard from the caller's thread before the one host read of
an iteration.
"""

from __future__ import annotations

import contextlib
import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..config import as_real, rdtype
from ..mhmc import _as_state
from ..tomography import bootstrap_core, kron_core
from ..tomography.state import make_generator
from ..utils import profiling

__all__ = [
    "make_mesh",
    "sharded_bootstrap_distances",
    "sharded_kron_bootstrap_distances",
    "sharded_kron_forward_flat",
    "sharded_kron_adjoint_flat",
    "sharded_kron_estimate_lin",
    "sharded_kron_estimate_mle_rhor",
    "sharded_kron_simulate",
    "sharded_process_bootstrap_distances",
    "sharded_coverage",
    "sharded_mhmc_kraus_chains",
    "sharded_mhmc_process_chains",
    "sharded_mhmc_state_chains",
    "povm_sharded_probabilities",
]

BATCH_AXIS = "batch"


@dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: `devices` in shard order (a device may repeat)."""

    devices: tuple
    axis_names: tuple = (BATCH_AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple:
        """The devices of the mesh, each once, in order of first use."""
        return tuple(dict.fromkeys(self.devices))


def _as_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_devices: int | None = None, axis_name: str = BATCH_AXIS, devices=None) -> Mesh:
    """1-D device mesh over the experiment/resample batch axis.

    The default is every CUDA device, cuda:0 .. cuda:n-1; without CUDA it
    raises and builds nothing on the CPU. `devices` lists the shards'
    devices instead (a device may repeat); `n_devices` keeps the first
    that many."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices= (for example ['cpu'] * 8) "
                "to build a mesh of CPU shards"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_as_device(d) for d in devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, (axis_name,))


def _derived_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([int(seed), i]).generate_state(1, np.uint64)[0])


def shard_seeds(key, n: int) -> list[int]:
    """The seeds of `n` shards' generators: a stable function of (key, i),
    the same on every run and device (see the module docstring)."""
    if isinstance(key, torch.Generator):
        profiling.count("host_sync")
        key = int(torch.randint(0, 2**63 - 1, (), generator=key, device=key.device))
    return [_derived_seed(key, i) for i in range(n)]


def shard_generators(mesh: Mesh, key) -> list[torch.Generator]:
    """One generator per shard, on its device, seeded by :func:`shard_seeds`."""
    return [make_generator(s, d) for s, d in zip(shard_seeds(key, mesh.size), mesh.devices)]


def _on(device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _run_shards(mesh: Mesh, fn) -> list:
    """[fn(0), .., fn(size - 1)]: one worker thread per distinct device
    runs that device's shards in order (see the module docstring); a mesh
    on one device runs them in the caller's thread. Each shard is a span
    `qt.mesh.shard`, a child of the caller's open span, with the device
    range of the kernels it launches outside other annotations."""
    groups: dict = {}
    for i, device in enumerate(mesh.devices):
        groups.setdefault(device, []).append(i)
    caller = profiling.current()

    def shard(device, i):
        with profiling.span("qt.mesh.shard", device, device_range=True):
            return fn(i)

    def run(device, shards):
        with profiling.resumed(caller), _on(device):
            return [(i, shard(device, i)) for i in shards]

    if len(groups) == 1:
        pairs = run(*next(iter(groups.items())))
    else:
        with ThreadPoolExecutor(len(groups)) as pool:
            futures = [pool.submit(run, d, s) for d, s in groups.items()]
            pairs = [p for f in futures for p in f.result()]
    out = [None] * mesh.size
    for i, value in pairs:
        out[i] = value
    return out


def _replicate(mesh: Mesh, x, like=None) -> dict:
    """`x` as a real tensor (the dtype of `like`, else `as_real`'s) copied
    once to each distinct device of the mesh: {device: tensor}."""
    if like is not None:
        x = torch.as_tensor(x, dtype=like.dtype)
    elif isinstance(x, torch.Tensor):
        x = as_real(x)
    else:
        x = torch.tensor(np.asarray(x), dtype=rdtype())
    return {d: x.to(d) for d in mesh.distinct_devices}


def _replicas(mesh: Mesh, main, *others) -> list:
    """[`main`, *`others`] each copied once to every distinct device, the
    others in `main`'s dtype (`_replicate`)."""
    first = _replicate(mesh, main)
    like = next(iter(first.values()))
    return [first] + [_replicate(mesh, a, like) for a in others]


def _per_shard(mesh: Mesh, n: int, what: str) -> int:
    if n % mesh.size:
        raise ValueError(f"{what}={n} must divide by {mesh.size} devices")
    return n // mesh.size


def _gather(mesh: Mesh, parts, dim: int = 0):
    """The shard results concatenated on devices[0] (out_specs=P(batch))."""
    with profiling.span("qt.mesh.gather", mesh.devices[0]):
        return torch.cat([p.to(mesh.devices[0]) for p in parts], dim=dim)


def _psum(mesh: Mesh, parts):
    """The sum of the shard results on devices[0], in shard order."""
    total = parts[0].to(mesh.devices[0])
    for p in parts[1:]:
        total = total + p.to(mesh.devices[0])
    return total


# -- resample sharding ----------------------------------------------------------


def sharded_bootstrap_distances(
    mesh: Mesh,
    key,
    bloch_est,
    povm_matrix,
    n_measurements,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
):
    """Bootstrap `n_points` resamples data-parallel over the mesh.

    Shard i draws and re-estimates its n_points/size resamples with
    `bootstrap_core.bootstrap_distances` on its own generator
    (:func:`shard_generators`); the distances are gathered on
    mesh.devices[0] in shard order. `key` is an int seed or a
    torch.Generator."""
    per_dev = _per_shard(mesh, n_points, "n_points")

    def shard(i):
        d = mesh.devices[i]
        return bootstrap_core.bootstrap_distances(
            gens[i], est[d], povm[d], n_meas[d], n_points=per_dev, method=method, dst=dst,
            max_iter=max_iter,
        )

    with profiling.span("qt.mesh.call", mesh.devices[0]):
        with profiling.span("qt.mesh.setup"):
            gens = shard_generators(mesh, key)
            est, povm, n_meas = _replicas(mesh, bloch_est, povm_matrix, n_measurements)
        return _gather(mesh, _run_shards(mesh, shard))


def sharded_kron_bootstrap_distances(
    mesh: Mesh,
    key,
    bloch_est,
    povm1,
    n_qubits: int,
    n_shots,
    n_points: int,
    method: str = "lin",
    dst: str = "hs",
    max_iter: int = 100,
    chunk: int | None = None,
):
    """Kron-factored bootstrap data-parallel over the mesh, the path of the
    6+ qubit designs whose measurement matrix is never materialized: shard i
    runs `kron_core.kron_bootstrap_distances` on its n_points/size
    resamples (in host chunks of `chunk`, see there) with its own
    generator; the distances are gathered on mesh.devices[0]."""
    per_dev = _per_shard(mesh, n_points, "n_points")

    def shard(i):
        d = mesh.devices[i]
        return kron_core.kron_bootstrap_distances(
            gens[i], est[d], factor[d], n_qubits, n_shots, n_points=per_dev, method=method,
            dst=dst, max_iter=max_iter, chunk=chunk,
        )

    with profiling.span("qt.mesh.call", mesh.devices[0]):
        with profiling.span("qt.mesh.setup"):
            gens = shard_generators(mesh, key)
            est, factor = _replicas(mesh, bloch_est, povm1)
        return _gather(mesh, _run_shards(mesh, shard))


def sharded_process_bootstrap_distances(
    mesh: Mesh,
    key,
    choi_bloch,
    out_blochs,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    n_points: int,
    cptp: bool = True,
    dst: str = "hs",
    cp: str = "eigh",
    cptp_iter: int = 2000,
):
    """Process bootstrap (simulate + factored lifp [+ CPTP projection] +
    Choi distance) data-parallel over the mesh: shard i re-estimates its
    n_points/size resamples from its own generator. choi_bloch (16^n,) is
    the reference point, out_blochs (S, 4^n) the channel's output states,
    input_blochs_t (S, 4^n) the transposed inputs; `cp`/`cptp_iter` select
    the Dykstra CP engine and iteration cap."""
    from ..tomography import process_core

    per_dev = _per_shard(mesh, n_points, "n_points")

    def shard(i):
        d = mesh.devices[i]
        counts = process_core.simulate_process_experiment(
            gens[i], povm[d], outs[d].expand((per_dev,) + tuple(outs[d].shape)), n_meas[d]
        )
        blochs = process_core.estimate_lifp_factored(
            counts, inputs_t[d], povm[d], n_meas[d], cptp=cptp, cptp_iter=cptp_iter, cp=cp
        )
        return bootstrap_core._distance_batch(dst, blochs, choi[d], n2)

    with profiling.span("qt.mesh.call", mesh.devices[0]):
        with profiling.span("qt.mesh.setup"):
            gens = shard_generators(mesh, key)
            choi, outs, inputs_t, povm, n_meas = _replicas(
                mesh, choi_bloch, out_blochs, input_blochs_t, povm_matrix, n_measurements
            )
            n2 = int(round(math.log(next(iter(choi.values())).shape[-1], 4)))
        return _gather(mesh, _run_shards(mesh, shard))


def sharded_coverage(mesh: Mesh, key, problem, conf_levels, n_trials: int):
    """Monte-Carlo coverage of the confidence polytopes sharded over the
    mesh: shard i simulates and tests n_trials/size experiments
    (`verification.coverage_hits`) from its own generator, and the
    per-level hit counts are summed over the shards.

    `problem` is the tuple of `verification.qst_problem` / `qpt_problem`;
    its simulated states compute in the port's default dtype (a tensor in
    its own). Returns per-level coverage (L,) as float64 numpy."""
    from ..tomography.polytopes import verification

    povm, n_meas, sim_blochs, prod, offset, clip_b = problem
    per_dev = _per_shard(mesh, n_trials, "n_trials")

    def shard(i):
        return verification.coverage_hits(
            gens[i], povm, n_meas, blochs[mesh.devices[i]], prod, offset, conf_levels,
            per_dev, clip_b,
        )

    with profiling.span("qt.mesh.call", mesh.devices[0]):
        with profiling.span("qt.mesh.setup"):
            gens = shard_generators(mesh, key)
            blochs = _replicate(mesh, sim_blochs)
        hits = _run_shards(mesh, shard)
    return np.sum(hits, axis=0).astype(np.float64) / n_trials


# -- mesh-sharded Metropolis chains ---------------------------------------------


def _sharded_chains(
    mesh: Mesh,
    key,
    x_init,
    make_fns,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int,
    thinning: int,
    jump_distr,
):
    """Shared scaffold of the mesh-sharded Metropolis chains.

    Shard i runs its n_chains/size chains side by side (`mhmc._run_chain`)
    on its own generator, each chain with its own burn-in, from the tensor
    `x_init`;
    `make_fns(device)` builds the (logpdf, update_rule) pair with its
    operands on the shard's device. Each chain keeps the states at steps
    burn_steps + thinning - 1 + j * thinning (0-based) of its
    total = n_samples * thinning + burn_steps steps. Returns (samples
    (n_chains, n_samples, dim) as numpy, acceptance rate accepted /
    (n_chains * total))."""
    from ..mhmc import _run_chain, resolve_jump_distr

    per_dev = _per_shard(mesh, n_chains, "n_chains")
    jump_fn = resolve_jump_distr(jump_distr)
    burn, kept_steps = int(burn_steps), int(n_samples) * int(thinning)

    def shard(i):
        d = mesh.devices[i]
        logpdf, update_rule = make_fns(d)
        x = x_init.to(d).expand((per_dev,) + tuple(x_init.shape[-1:])).clone()
        _, acc_burn, x = _run_chain(gens[i], x, logpdf, update_rule, jump_fn, step, burn)
        kept, acc_kept, _ = _run_chain(
            gens[i], x, logpdf, update_rule, jump_fn, step, kept_steps, int(thinning)
        )
        return kept.transpose(0, 1), acc_burn + acc_kept

    with profiling.span("qt.mesh.call", mesh.devices[0]):
        with profiling.span("qt.mesh.setup"):
            gens = shard_generators(mesh, key)
        results = _run_shards(mesh, shard)
        samples = _gather(mesh, [r[0] for r in results])
        accepted = sum(int(r[1]) for r in results)
        return samples.cpu().numpy(), accepted / (n_chains * (kept_steps + burn))


def sharded_mhmc_state_chains(
    mesh: Mesh,
    key,
    x_init,
    povm_flat_w,
    frequencies,
    n_qubits: int,
    scale,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int = 100,
    thinning: int = 1,
    jump_distr=None,
):
    """Independent state-NLL likelihood chains sharded over the mesh.

    The target is the count-scaled state NLL over Cholesky parameters
    (`state_core.nll_tril`) against the dense weighted design, the
    single-device chain of `MHMCStateInterval`; proposals are renormalized
    (`mhmc.normalized_update`). Returns (samples (n_chains, n_samples,
    dim), acceptance_rate)."""
    from ..mhmc import normalized_update
    from ..tomography import state_core

    scale = float(scale)
    x0 = _as_state(x_init)
    povm_w = _replicate(mesh, povm_flat_w, x0)
    freq = _replicate(mesh, frequencies, x0)

    def make_fns(d):
        def logpdf(x):
            return -scale * state_core.nll_tril(x, povm_w[d], freq[d], n_qubits)

        return logpdf, normalized_update

    return _sharded_chains(
        mesh, key, x0, make_fns, step, n_chains, n_samples, burn_steps, thinning, jump_distr
    )


def sharded_mhmc_process_chains(
    mesh: Mesh,
    key,
    x_init,
    input_blochs_t,
    povm_matrix,
    n_measurements,
    flat_counts,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int = 100,
    thinning: int = 1,
    jump_distr=None,
    cptp_iter: int = 100,
    cp: str | None = None,
    scale: float = 1.0,
):
    """Process-tomography twin of :func:`sharded_mhmc_state_chains`:
    CPTP-projected Metropolis chains over Choi bloch vectors. The target is
    -scale times the factored process NLL, and every proposal is
    Dykstra-projected into CPTP (`cptp_iter` iterations, the tolerance
    1e-12 floored at the dtype's precision, the stop read every
    `interval.PROJECTION_READ_EVERY` iterations), as in
    `MHMCProcessInterval`'s single-device chain. `cp` selects the CP engine
    ('ns' at 4+ qubits by default, else 'eigh'); `scale` is the interval's
    tempering factor. Returns (samples (n_chains, n_samples, 16^n),
    acceptance_rate)."""
    from ..tomography import process_core, state_core
    from ..tomography.interval import PROJECTION_READ_EVERY

    x0 = _as_state(x_init)
    tol = process_core.default_cptp_tol(1e-12, x0.dtype)
    if cp is None:
        cp = "ns" if int(round(math.log(x0.shape[-1], 16))) >= 4 else "eigh"
    b, povm, n_meas, flat = (
        _replicate(mesh, a, x0)
        for a in (input_blochs_t, povm_matrix, n_measurements, flat_counts)
    )
    scale = float(scale)

    def make_fns(d):
        w = state_core.weighted_povm_flat(povm[d], n_meas[d])

        def logpdf(x):
            return -scale * process_core.process_nll_factored(x, b[d], w, flat[d])

        def update_rule(x, delta, s):
            return process_core.cptp_project_bloch_host(
                x + s * delta, cptp_iter, tol, chunk=PROJECTION_READ_EVERY, cp=cp
            )

        return logpdf, update_rule

    return _sharded_chains(
        mesh, key, x0, make_fns, step, n_chains, n_samples, burn_steps, thinning, jump_distr
    )


def sharded_mhmc_kraus_chains(
    mesh: Mesh,
    key,
    dz_init,
    pack,
    input_blochs_t,
    w_flat,
    flat_counts,
    p_ref,
    scale: float,
    step: float,
    n_chains: int,
    n_samples: int,
    burn_steps: int = 100,
    thinning: int = 1,
    jump_distr=None,
    u_scale=None,
):
    """ANCHORED kraus-factor process chains sharded over the mesh: each
    shard runs its random-walk chains on the smooth exactly-CPTP
    anchored-delta target (`process_core.process_nll_anchored`, reduced in
    float64); the chain state is the offset dz from the float64 anchor in
    `pack` (`process_core.np_kraus_anchor_pack`), or dz / u_scale where
    `u_scale` rescales the coordinates. `flat_counts` and `p_ref` stay
    float64. Symmetric proposals only. Returns (samples (n_chains,
    n_samples, 2*D*D) of the chain states, acceptance_rate)."""
    from ..mhmc import basic_update
    from ..tomography import process_core

    x0 = _as_state(dz_init)
    scale = float(scale)
    b, w = (_replicate(mesh, a, x0) for a in (input_blochs_t, w_flat))
    f64 = torch.zeros((), dtype=torch.float64)
    counts, p = (_replicate(mesh, a, f64) for a in (flat_counts, p_ref))
    us = None if u_scale is None else _replicate(mesh, u_scale, x0)
    packs = {d: process_core.anchor_pack_to(pack, b[d]) for d in mesh.distinct_devices}

    def make_fns(d):
        def logpdf(x):
            xx = x if us is None else x * us[d]
            return -scale * process_core.process_nll_anchored(
                xx, b[d], w[d], counts[d], packs[d], p[d]
            )

        return logpdf, basic_update

    return _sharded_chains(
        mesh, key, x0, make_fns, step, n_chains, n_samples, burn_steps, thinning, jump_distr
    )


# -- operator sharding of the kron-factored design ------------------------------


class ShardedCounts:
    """Outcome counts (..., M, P) born split over a mesh on the outcome
    axis P (the first measurement group's outcomes): `shards[i]` is
    (..., M, P / size) on mesh.devices[i]. `gather()` assembles the whole
    tensor on mesh.devices[0]."""

    def __init__(self, mesh: Mesh, shards):
        self.mesh = mesh
        self.shards = list(shards)

    @property
    def shape(self) -> tuple:
        s = tuple(self.shards[0].shape)
        return s[:-1] + (s[-1] * len(self.shards),)

    def gather(self) -> torch.Tensor:
        return _gather(self.mesh, self.shards, dim=-1)


def _kron_factor_shards(povm1, n_qubits: int, n_dev: int):
    """Shared setup of the operator-sharded kron chain: grouped factors
    with the FIRST group's outcome axis destined for the mesh. `povm1` is a
    tensor; raises ValueError unless n_dev divides that axis."""
    groups, factors = kron_core._grouped_factors(povm1, n_qubits)
    p0 = factors[0].shape[1]
    if p0 % n_dev:
        raise ValueError(
            f"first-group outcome axis {p0} must divide by {n_dev} devices "
            f"(groups {groups}; pick a mesh size dividing p1^{groups[0]})"
        )
    return groups, factors


def _shard_factors(mesh: Mesh, factors):
    """Per shard, the factors with the first one's outcomes sliced to the
    shard's share, on the shard's device."""
    rest = {d: [f.to(d) for f in factors[1:]] for d in mesh.distinct_devices}
    p_loc = factors[0].shape[1] // mesh.size
    return [
        [factors[0][:, i * p_loc : (i + 1) * p_loc].contiguous().to(d)] + rest[d]
        for i, d in enumerate(mesh.devices)
    ]


def _count_shards(mesh: Mesh, counts, like=None):
    """(shards (Z, M, P / size) on their devices, batch shape) of counts
    that are a `ShardedCounts` of this mesh's size (used in place) or a
    whole (..., M, P) tensor or array (split on its last axis)."""
    if isinstance(counts, ShardedCounts):
        if len(counts.shards) != mesh.size:
            raise ValueError(
                f"counts are split in {len(counts.shards)} shards, the mesh has {mesh.size}"
            )
        shards = [s.to(d) for s, d in zip(counts.shards, mesh.devices)]
        batch = tuple(shards[0].shape[:-2])
        return [s.reshape((-1,) + tuple(s.shape[-2:])) for s in shards], batch
    counts = as_real(counts) if like is None else as_real(counts, like=like)
    batch = tuple(counts.shape[:-2])
    c3 = counts.reshape((-1,) + tuple(counts.shape[-2:]))
    parts = torch.chunk(c3, mesh.size, dim=-1)
    return [p.to(d) for p, d in zip(parts, mesh.devices)], batch


def sharded_kron_forward_flat(mesh: Mesh, bloch, povm1, n_qubits: int):
    """OPERATOR-sharded kron forward: the first measurement group's outcome
    axis rides the mesh, so shard i holds the factor slice f0[:, p0_i, :]
    and computes its (z, M, P/size) slab of the output from the replicated
    bloch input; no reduction runs. Returns the flat forward
    (..., (m1 p1)^n) gathered on mesh.devices[0], the twin of
    `kron_core.kron_forward_flat`."""
    bloch = as_real(bloch)
    povm1 = as_real(povm1, like=bloch)
    groups, factors = _kron_factor_shards(povm1, n_qubits, mesh.size)
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))
    xs = {d: x.to(d) for d in mesh.distinct_devices}
    shard_f = _shard_factors(mesh, factors)
    slabs = [kron_core._forward_chain(shard_f[i], xs[d]) for i, d in enumerate(mesh.devices)]
    out = _gather(mesh, slabs, dim=-1)
    return out.reshape(tuple(bloch.shape[:-1]) + (-1,))


def sharded_kron_adjoint_flat(mesh: Mesh, c, povm1, n_qubits: int):
    """Operator-sharded kron adjoint: shard i contracts its outcome slab
    c[..., M, p0_i, ...] against its factor slice; the (4^n,) results are
    summed on mesh.devices[0]. Twin of `kron_core.kron_adjoint_flat`."""
    c = as_real(c)
    povm1 = as_real(povm1, like=c)
    _, factors = _kron_factor_shards(povm1, n_qubits, mesh.size)
    m1, p1 = povm1.shape[0], povm1.shape[1]
    batch = tuple(c.shape[:-1])
    shards, _ = _count_shards(mesh, c.reshape(batch + (m1**n_qubits, p1**n_qubits)))
    shard_f = _shard_factors(mesh, factors)
    parts = [kron_core._adjoint_chain(f, s) for f, s in zip(shard_f, shards)]
    return _psum(mesh, parts).reshape(batch + (4**n_qubits,))


def _sharded_frequencies(mesh: Mesh, shards):
    """Each shard's counts over the total count of its batch row, summed
    over every shard."""
    total = _psum(mesh, [s.sum(dim=(-2, -1), keepdim=True) for s in shards])
    return [s / total.to(s.device) for s in shards]


def sharded_kron_estimate_lin(mesh: Mesh, counts, povm1, n_qubits: int, physical: bool = True):
    """Operator-sharded linear inversion: the counts stay split on the
    outcome axis, the adjoint's (4^n,) right-hand sides are summed on
    mesh.devices[0], and the factored Gram solve (+ feasibility projection)
    runs there. `counts` is a `ShardedCounts` (used in place) or a whole
    (..., M, P) tensor. Same math as `kron_core.kron_estimate_lin`."""
    shards, batch = _count_shards(mesh, counts)
    povm1 = as_real(povm1, like=shards[0])
    _, factors = _kron_factor_shards(povm1, n_qubits, mesh.size)
    shard_f = _shard_factors(mesh, factors)
    freqs = _sharded_frequencies(mesh, shards)
    rhs = _psum(mesh, [kron_core._adjoint_chain(f, q) for f, q in zip(shard_f, freqs)])
    m_total = shards[0].shape[-2]
    bloch = kron_core._lin_from_rhs(rhs, povm1.to(rhs.device), n_qubits, m_total, physical)
    return bloch.reshape(batch + (4**n_qubits,))


def sharded_kron_simulate(mesh: Mesh, key, povm1, bloch, n_shots) -> ShardedCounts:
    """Operator-sharded experiment simulation: shard i evaluates its
    (…, M, P/size) probability slab from the replicated bloch and draws its
    own outcomes, so the 6^n counts are born split and never whole on one
    device. Shot totals are allocated per shard in proportion to the
    shard's probability mass (rounded), one first-group outcome slice at a
    time, each (shard, slice) from its own generator (module docstring):
    the product-binomial design of the JAX package, whose per-POVM totals
    hold only in expectation and whose counts are underdispersed against a
    multinomial. One slice at a time keeps the sampler's transient at
    1/m0 of the probability volume. Returns `ShardedCounts` of shape
    (..., m1^n, p1^n)."""
    from ..ops.sampling import sample_multinomial

    bloch = as_real(bloch)
    n_qubits = int(round(math.log(bloch.shape[-1], 4)))
    povm1 = as_real(povm1, like=bloch)
    groups, factors = _kron_factor_shards(povm1, n_qubits, mesh.size)
    batch = tuple(bloch.shape[:-1])
    x = bloch.reshape((-1,) + tuple(4**g for g in groups))
    xs = {d: x.to(d) for d in mesh.distinct_devices}
    shard_f = _shard_factors(mesh, factors)
    m0 = factors[0].shape[0]
    m_total = m0 * math.prod(f.shape[0] for f in factors[1:])
    seeds = shard_seeds(key, mesh.size)
    outs = []
    for i, d in enumerate(mesh.devices):
        p_loc = shard_f[i][0].shape[1] * math.prod(f.shape[1] for f in factors[1:])
        outs.append(torch.empty((x.shape[0], m0, m_total // m0, p_loc), dtype=x.dtype, device=d))
    for j in range(m0):
        probs = []
        for i, d in enumerate(mesh.devices):
            f0 = shard_f[i][0][j : j + 1]
            slab = kron_core._forward_chain([f0] + shard_f[i][1:], xs[d])
            probs.append((slab * (2**n_qubits)).clamp(0.0, 1.0))
        mass = [p.sum(-1) for p in probs]
        total = _psum(mesh, mass)
        total = torch.where(total > 0, total, torch.ones_like(total))
        for i, d in enumerate(mesh.devices):
            gen = make_generator(_derived_seed(seeds[i], j), d)
            n_loc = torch.round(float(n_shots) * mass[i] / total.to(d))
            outs[i][:, j] = sample_multinomial(gen, n_loc, probs[i])
    shards = [o.reshape(batch + (m_total, -1)) for o in outs]
    return ShardedCounts(mesh, shards)


def sharded_kron_estimate_mle_rhor(
    mesh: Mesh,
    counts,
    povm1,
    n_qubits: int,
    init_bloch=None,
    max_iter: int = 100,
    tol: float = 1e-6,
):
    """Operator-sharded RrhoR fixed-point MLE, the 12-qubit enabler: the
    fixed point of `kron_core.kron_estimate_mle_rhor`, with every
    6^n-sized tensor split over the mesh on the first group's outcome axis.

    Per iteration each shard evaluates its (z, M, P/size) probability slab
    from the bloch, forms freq / probs and contracts it through the adjoint
    chain; the (z, 4^n) R-vectors are summed on mesh.devices[0] and sent
    back. The R rho R sandwich is row-sharded: shard i computes its
    (2^n/size, 2^n) row block of (R rho) R, and the blocks are concatenated
    on mesh.devices[0]; when size does not divide 2^n it runs there whole.
    The stop criterion (max |bloch change| over the batch not above `tol`)
    is read on the host after every iteration, the schedule of the
    single-device loop, so both stop at the same iteration.

    `counts` is a `ShardedCounts` (used in place) or a whole (..., M, P)
    tensor. Returns the (..., 4^n) estimate on mesh.devices[0]."""
    from ..ops.paulis import bloch_to_matrix
    from ..tomography.state_core import _NLL_EPS, _mixed_start, _unit_trace_bloch

    shards, batch = _count_shards(mesh, counts)
    home = mesh.devices[0]
    povm1 = as_real(povm1, like=shards[0])
    _, factors = _kron_factor_shards(povm1, n_qubits, mesh.size)
    shard_f = _shard_factors(mesh, factors)
    dim = 2**n_qubits
    m_total = shards[0].shape[-2]
    scale = dim / m_total
    rows = dim // mesh.size if dim % mesh.size == 0 else None
    freqs = _sharded_frequencies(mesh, shards)
    freqs = [
        q.reshape((q.shape[0],) + tuple(f.shape[0] for f in fs) + tuple(f.shape[1] for f in fs))
        for q, fs in zip(freqs, shard_f)
    ]
    if init_bloch is None:
        init_bloch = sharded_kron_estimate_lin(mesh, ShardedCounts(mesh, shards), povm1, n_qubits)
    bloch = _mixed_start(
        as_real(init_bloch, like=shards[0]).to(home).reshape(-1, dim * dim), dim, 0.05
    )
    groups = tuple(4**g for g in kron_core.group_sizes(n_qubits))

    def r_vector(b):
        parts = []
        for fs, q, d in zip(shard_f, freqs, mesh.devices):
            x = b.to(d).reshape((-1,) + groups)
            probs = (kron_core._forward_chain(fs, x) * dim).clamp(0.0, 1.0) / m_total
            c = q / probs.reshape(q.shape).clamp(min=_NLL_EPS)
            parts.append(kron_core._adjoint_chain(fs, c))
        return _psum(mesh, parts) * scale

    for _ in range(int(max_iter)):
        r_bloch = r_vector(bloch)
        if rows is None:
            r = bloch_to_matrix(r_bloch, n_qubits)
            new = r @ bloch_to_matrix(bloch, n_qubits) @ r
        else:
            mats = {
                d: (bloch_to_matrix(r_bloch.to(d), n_qubits), bloch_to_matrix(bloch.to(d), n_qubits))
                for d in mesh.distinct_devices
            }
            blocks = []
            for i, d in enumerate(mesh.devices):
                r, rho = mats[d]
                blocks.append((r[..., i * rows : (i + 1) * rows, :] @ rho) @ r)
            new = _gather(mesh, blocks, dim=-2)
        new_bloch = _unit_trace_bloch(new)
        delta = float((new_bloch - bloch).abs().max())
        bloch = new_bloch
        if not delta > tol:
            break
    return bloch.reshape(batch + (dim * dim,))


def povm_sharded_probabilities(mesh: Mesh, povm_flat, bloch):
    """Probability evaluation with the measurement axis sharded over the
    mesh: p_k = (W @ bloch)_k computed on the shard that holds row k, the
    rows split evenly (ValueError otherwise); gathered on
    mesh.devices[0]."""
    bloch = as_real(bloch)
    w = as_real(povm_flat, like=bloch)
    _per_shard(mesh, w.shape[0], "rows of povm_flat")
    parts = torch.chunk(w, mesh.size, dim=0)
    return _gather(mesh, [p.to(d) @ bloch.to(d) for p, d in zip(parts, mesh.devices)])
