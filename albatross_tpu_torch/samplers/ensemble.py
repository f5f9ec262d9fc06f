"""Ensemble MCMC: the affine-invariant (Goodman-Weare) stretch move.

Counterpart of ``albatross_tpu.samplers.ensemble``.  The walk runs in the
model's tunable space with the parallel two-half scheme: each half proposes
against the other at once, so an iteration is two batches of log-prob
evaluations.  ``ensemble_sampler_from_model`` evaluates each batch with one
walker-batched gram launch (or a stack of the walkers' DSL covariances)
and one batched factorization (``GaussianProcess.batched_log_likelihood``),
the counterpart of the JAX package's ``jax.vmap`` over walkers.

The reference semantics are kept: z = ((a - 1) p + 1)^2 / a with p ~ U(0,
1); zero components of a proposal's delta nudged to 1e-6; acceptance on
(d - 1) log z + delta log p > log u, u ~ U(0, 1), for a finite proposal
only; halves of n // 2 and the rest, the second proposing against the
updated first; non-finite initial walkers repaired by interpolating toward
finite donors, alpha ~ U(0.2, 0.8), for up to 50 tries.

State lives on the host: walker positions and log-probs are f64 CPU
tensors, as the port's tunable vector is, and a log-prob batch is read back
once a half-step.  Draws come from an explicit ``torch.Generator`` (an int
``key`` seeds one); torch's generator gives other numbers than JAX's keys,
so each half-step is a draw (``draw_half_step``) and a deterministic update
that takes the draws (``update_half``): fed the JAX package's draws, the
update reproduces its step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.random import as_generator


class SamplerState(NamedTuple):
    """One iteration's ensemble state."""

    params: torch.Tensor  # (n_walkers, n_dim) tunable-space positions, f64 on the CPU
    log_prob: torch.Tensor  # (n_walkers,) f64
    accepted: torch.Tensor  # (n_walkers,) bool


@dataclasses.dataclass
class EnsembleChain:
    """The whole chain: numpy arrays with a leading iteration axis (the
    initial state, then one entry an iteration)."""

    params: np.ndarray  # (n_iterations + 1, n_walkers, n_dim)
    log_prob: np.ndarray
    accepted: np.ndarray

    def __len__(self):
        return self.params.shape[0]

    def state(self, i: int) -> SamplerState:
        return SamplerState(*(torch.as_tensor(a[i]) for a in (self.params, self.log_prob, self.accepted)))

    def acceptance_rate(self) -> float:
        return float(np.mean(self.accepted[1:]))

    def flat_samples(self, burn_in: int = 0) -> np.ndarray:
        return self.params[burn_in:].reshape(-1, self.params.shape[-1])


class HalfStepDraws(NamedTuple):
    """The random numbers of one half-step, for its n_move movers."""

    partners: torch.Tensor  # (n_move,) int64: index into the other half
    p: torch.Tensor  # (n_move,) U(0, 1): the stretch z = ((a - 1) p + 1)^2 / a
    u: torch.Tensor  # (n_move,) U(0, 1): accept when log_diff > log u


class RepairDraws(NamedTuple):
    """The random numbers of one repair try of the initial walkers."""

    donors: torch.Tensor  # (n_walkers,) int64: a finite walker for each
    alpha: torch.Tensor  # (n_walkers, 1) U(0.2, 0.8)


def _pick_finite(generator: torch.Generator, log_prob: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` indices drawn uniformly over the finite entries of
    ``log_prob``, or over all of them when none is finite (the JAX package
    draws by ``categorical`` on logits 0 / -1e30; ``torch.multinomial``
    raises on all-zero weights)."""
    weights = torch.isfinite(log_prob).to(torch.float64)
    if not bool(weights.any()):
        weights = torch.ones_like(weights)
    return torch.multinomial(weights, count, replacement=True, generator=generator)


def draw_half_step(generator: torch.Generator, n_move: int, others_lp: torch.Tensor) -> HalfStepDraws:
    """Partners among the other half (finite ones preferred), then p, then u."""
    partners = _pick_finite(generator, others_lp, n_move)
    p = torch.rand(n_move, generator=generator, dtype=torch.float64)
    u = torch.rand(n_move, generator=generator, dtype=torch.float64)
    return HalfStepDraws(partners, p, u)


def update_half(movers, movers_lp, others, draws: HalfStepDraws, log_prob_fn: Callable, a: float = 2.0):
    """Propose for every mover against its partner at once, evaluate the
    proposals as one batch, and accept or keep each: (new positions, new
    log-probs, accepted)."""
    partners = others[draws.partners]
    z = ((a - 1.0) * draws.p + 1.0) ** 2 / a
    delta = movers - partners
    delta = torch.where(delta == 0.0, torch.full_like(delta, 1e-6), delta)
    proposal = partners + z[:, None] * delta
    prop_lp = _as_host_f64(log_prob_fn(proposal))
    log_diff = (movers.shape[1] - 1.0) * torch.log(z) + prop_lp - movers_lp
    accepted = (log_diff > torch.log(draws.u)) & torch.isfinite(prop_lp)
    new = torch.where(accepted[:, None], proposal, movers)
    new_lp = torch.where(accepted, prop_lp, movers_lp)
    return new, new_lp, accepted


def _as_host_f64(values) -> torch.Tensor:
    return torch.as_tensor(values).detach().to(device="cpu", dtype=torch.float64)


def stretch_move_step(key, state: SamplerState, log_prob_fn: Callable, a: float = 2.0,
                      draws: Optional[tuple] = None) -> SamplerState:
    """One stretch-move iteration over both halves.  ``draws`` (optional)
    gives both halves' ``HalfStepDraws`` instead of drawing them from
    ``key``."""
    params, log_prob = state.params, state.log_prob
    half = params.shape[0] // 2
    pa, lpa, pb, lpb = params[:half], log_prob[:half], params[half:], log_prob[half:]
    generator = None if draws is not None else as_generator(key)
    da = draws[0] if draws is not None else draw_half_step(generator, pa.shape[0], lpb)
    pa, lpa, acc_a = update_half(pa, lpa, pb, da, log_prob_fn, a)
    db = draws[1] if draws is not None else draw_half_step(generator, pb.shape[0], lpa)
    pb, lpb, acc_b = update_half(pb, lpb, pa, db, log_prob_fn, a)
    return SamplerState(torch.cat([pa, pb]), torch.cat([lpa, lpb]), torch.cat([acc_a, acc_b]))


def draw_repair(generator: torch.Generator, log_prob: torch.Tensor) -> RepairDraws:
    n = log_prob.shape[0]
    donors = _pick_finite(generator, log_prob, n)
    alpha = 0.2 + 0.6 * torch.rand((n, 1), generator=generator, dtype=torch.float64)
    return RepairDraws(donors, alpha)


def repair_walkers(params, log_prob, draws: RepairDraws, log_prob_fn: Callable):
    """One repair try: each non-finite walker moves to donor + alpha (walker
    - donor) and only those are evaluated again (the finite ones keep their
    positions, so their log-probs stand)."""
    finite = torch.isfinite(log_prob)
    donors = params[draws.donors]
    repaired = donors + draws.alpha * (params - donors)
    params = torch.where(finite[:, None], params, repaired)
    bad = torch.nonzero(~finite)[:, 0]
    log_prob = log_prob.clone()
    log_prob[bad] = _as_host_f64(log_prob_fn(params[bad]))
    return params, log_prob


def ensure_finite_initial_state(key, params, log_prob_fn: Callable, max_tries: int = 50,
                                draws: Optional[list] = None):
    """Repair non-finite walkers by interpolating toward finite ones;
    returns (params, log_prob).  ``draws`` (optional) gives each try's
    ``RepairDraws`` instead of drawing them from ``key``."""
    params = _as_host_f64(params)
    log_prob = _as_host_f64(log_prob_fn(params))
    generator = None if draws is not None else as_generator(key)
    for t in range(max_tries):
        if bool(torch.isfinite(log_prob).all()):
            break
        d = draws[t] if draws is not None else draw_repair(generator, log_prob)
        params, log_prob = repair_walkers(params, log_prob, d, log_prob_fn)
    return params, log_prob


def ensemble_sampler(log_prob_fn: Callable, initial_params, max_iterations: int, key, a: float = 2.0,
                     callback: Optional[Callable] = None, callback_interval: int = 64) -> EnsembleChain:
    """Run the sampler.  ``log_prob_fn`` maps an (n_walkers, n_dim) f64 CPU
    tensor to (n_walkers,) log-probabilities (a tensor on any device, or
    an array).

    ``callback(iteration, state)`` fires for the initial state (iteration
    0) and then after every iteration, in order, as the JAX package's
    chunked scan delivers them; each half-step's log-probs are read back
    anyway, so every iteration is its own chunk and ``callback_interval``,
    kept for the JAX package's signature, changes nothing."""
    del callback_interval
    generator = as_generator(key)
    params, log_prob = ensure_finite_initial_state(generator, initial_params, log_prob_fn)
    state = SamplerState(params, log_prob, torch.ones(params.shape[0], dtype=torch.bool))
    states = [state]
    if callback is not None:
        callback(0, state)
    for i in range(max_iterations):
        state = stretch_move_step(generator, state, log_prob_fn, a)
        states.append(state)
        if callback is not None:
            callback(i + 1, state)
    return EnsembleChain(*(np.stack([s[k].numpy() for s in states]) for k in range(3)))


def initial_params_from_jitter(key, tunable_values, n_walkers: int, jitter_sd: float = 0.1) -> torch.Tensor:
    """Walkers = values + N(0, jitter_sd^2) in tunable space, f64."""
    values = _as_host_f64(tunable_values)
    noise = torch.randn((n_walkers, values.shape[0]), generator=as_generator(key), dtype=torch.float64)
    return values[None, :] + jitter_sd * noise


def model_log_prob_fn(model, dataset) -> Callable:
    """log p(x) = model.set_tunable_params(x).log_likelihood(dataset) over a
    batch of walkers.  A ``GaussianProcess`` evaluates the batch at once
    (``batched_log_likelihood``); other models, and a GP with
    ``safe_factorization`` (its jitter search is per matrix), walker by
    walker."""
    from ..core.parameters import set_tunable_params
    from ..models.gp import GaussianProcess

    params0 = model.get_params()

    def walker_models(walkers):
        return [model.set_params(set_tunable_params(params0, x)) for x in walkers]

    if isinstance(model, GaussianProcess) and not model.safe_factorization:
        return lambda walkers: GaussianProcess.batched_log_likelihood(walker_models(walkers), dataset)
    return lambda walkers: torch.stack([_as_host_f64(m.log_likelihood(dataset))
                                        for m in walker_models(walkers)])


def _walker_sharded(log_prob_fn: Callable, mesh, mesh_axis: str) -> Callable:
    """``log_prob_fn`` over the ranks of a mesh axis: each rank evaluates
    its contiguous slice of the walkers (as even as the count allows), and
    one all-reduce of a zero-padded (n_walkers,) buffer on the mesh's
    device gives every rank every log-prob, bit for bit."""
    import torch.distributed as dist

    from ..parallel._comm import mesh_axis as _mesh_axis

    ax = _mesh_axis(mesh, mesh_axis)

    def fn(walkers):
        n = walkers.shape[0]
        counts = [n // ax.size + (1 if r < n % ax.size else 0) for r in range(ax.size)]
        start = sum(counts[:ax.rank])
        out = torch.zeros(n, dtype=torch.float64, device=mesh.device_type)
        if counts[ax.rank]:
            out[start:start + counts[ax.rank]] = _as_host_f64(log_prob_fn(walkers[start:start + counts[ax.rank]]))
        if ax.size > 1:
            dist.all_reduce(out, group=ax.group)
        return out.cpu()

    return fn


def ensemble_sampler_from_model(model, dataset, n_walkers: int, max_iterations: int, key,
                                jitter_sd: float = 0.1, callback: Optional[Callable] = None,
                                callback_interval: int = 64, mesh=None,
                                mesh_axis: str = "chain") -> EnsembleChain:
    """Sample the model's tunable parameters under its log-likelihood on
    ``dataset`` (prior included), from walkers jittered around the current
    values.

    With a ``DeviceMesh`` (``parallel.make_mesh``) every rank of it calls
    this with the same arguments: each evaluates its slice of every
    half-step's walker batch, the log-probs are gathered, and every rank
    holds the same chain as an unsharded run (the counterpart of the JAX
    package's sharding of the ``vmap``'s walker axis over ``mesh_axis``)."""
    generator = as_generator(key)
    initial = initial_params_from_jitter(generator, model.get_tunable_parameters().values, n_walkers,
                                         jitter_sd)
    log_prob_fn = model_log_prob_fn(model, dataset)
    if mesh is not None:
        log_prob_fn = _walker_sharded(log_prob_fn, mesh, mesh_axis)
    return ensemble_sampler(log_prob_fn, initial, max_iterations, generator,
                            callback=callback, callback_interval=callback_interval)
