"""Standalone Metropolis-Hastings sampler over a wavefront of independent
chains, validated against analytic 1-D targets via KL divergence.

JAX port of /root/reference/metropolis.py:28-147: the lazily-grown
proposal list becomes a fixed (N, D) dimension array (D static), the gaussian
+ large-step mixture kernel and the accept/reject select are identical; state
is an explicit pytree advanced by a pure function (jit/donate friendly).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from ..core import warp
from ..core.rng import Sampler
from ..core.struct import jstruct


@jstruct
class MetropolisState:
    samples: jnp.ndarray    # (N, D) current chain positions (primary space)
    proposed: jnp.ndarray   # (N, D) proposal awaiting accept/reject
    f: jnp.ndarray          # (N,) target value at `samples`
    sampler: Sampler


def seed_metropolis(seed, n: int, d: int) -> MetropolisState:
    sampler = Sampler.create(seed, n)
    sampler, u = _uniform_block(sampler, d)
    return MetropolisState(
        samples=u,
        proposed=u,
        f=jnp.zeros((n,), m.Float),
        sampler=sampler,
    )


def _uniform_block(sampler, d):
    us = []
    for _ in range(d):
        sampler, u = sampler.next_1d()
        us.append(u)
    return sampler, jnp.stack(us, axis=-1)


def sample_proposal(sampler, x, sigma=0.1, p_large=0.1):
    """Gaussian random walk (wrapped to [0,1)) + large-step mixture
    (metropolis.py:66-73)."""
    d = x.shape[-1]
    outs = []
    for k in range(d):
        sampler, u2 = sampler.next_2d()
        step = warp.square_to_std_normal(u2)[..., 0] * sigma
        y = x[..., k] + step
        y = y - jnp.floor(y)
        sampler, ul = sampler.next_1d()
        sampler, unew = sampler.next_1d()
        y = jnp.where(ul < p_large, unew, y)
        outs.append(y)
    return sampler, jnp.stack(outs, axis=-1)


def advance(state: MetropolisState, f_proposed, sigma=0.1, p_large=0.1):
    """Accept/reject on target ratio, then draw the next proposal
    (metropolis.py:78-93)."""
    a = jnp.minimum(1.0, m.safe_div(f_proposed, state.f, fill=1.0))
    sampler, u = state.sampler.next_1d()
    accept = u <= a
    samples = jnp.where(accept[:, None], state.proposed, state.samples)
    f = jnp.where(accept, f_proposed, state.f)
    sampler, proposed = sample_proposal(sampler, samples, sigma, p_large)
    return MetropolisState(
        samples=samples, proposed=proposed, f=f, sampler=sampler
    )


# ---------------------------------------------------------------------------
# Validation harness (metropolis.py:121-223): 1-D bimodal target, KL tracking
# ---------------------------------------------------------------------------

def gaussian(x, mu, sig):
    return (
        1.0 / (np.sqrt(2.0 * np.pi) * sig)
        * np.exp(-0.5 * ((x - mu) / sig) ** 2)
    )


def analytic_target(x):
    """metropolis.py:121-133: two gaussians with a hole in (0.5, 0.6)."""
    f = gaussian(x, 0.2, 0.01) + gaussian(x, 0.7, 0.1)
    inside = (x > 0.0) & (x < 1.0) & ((x < 0.5) | (x > 0.6))
    return np.where(inside, f, 0.0)


def kl_divergence(p, q, eps=1e-5):
    p = np.asarray(p) + eps
    q = np.asarray(q) + eps
    return float(np.mean(p * np.log(p / q)))


def run_chain_1d(n_chains=16384, n_iters=300, seed=0, sigma=0.1, p_large=0.1,
                 bins=64):
    """Run the Metropolis chains against the analytic target; returns
    (kl_history, final_histogram, target_histogram)."""
    state = seed_metropolis(seed, n_chains, 1)
    f0 = jnp.asarray(analytic_target(np.asarray(state.proposed[:, 0])))
    state = dataclasses.replace(state, f=f0)

    centers = (np.arange(bins) + 0.5) / bins
    target_hist = analytic_target(centers)
    target_hist = target_hist / target_hist.sum()

    adv = jax.jit(lambda st, f: advance(st, f, sigma, p_large))

    kls = []
    for i in range(n_iters):
        f_prop = jnp.asarray(
            analytic_target(np.asarray(state.proposed[:, 0]))
        )
        state = adv(state, f_prop)
        if (i + 1) % 50 == 0:
            hist, _ = np.histogram(
                np.asarray(state.samples[:, 0]), bins=bins, range=(0, 1)
            )
            hist = hist / max(hist.sum(), 1)
            kls.append(kl_divergence(target_hist, hist))
    hist, _ = np.histogram(
        np.asarray(state.samples[:, 0]), bins=bins, range=(0, 1)
    )
    hist = hist / max(hist.sum(), 1)
    return kls, hist, target_hist
