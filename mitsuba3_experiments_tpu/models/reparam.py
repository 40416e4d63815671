"""Reparameterized importance sampling: learn a sampling map T(z) whose
density is shaped by |det J_T|.

JAX re-design of /root/reference/reparam.ipynb: the reference had to
hand-roll an entire manual-backprop `JacobianNet` (per-layer stored inputs,
custom grad_ rules for Linear/ReLU/Exp/TaLU/Resize, unit-gradient backprops
to assemble J — cells 6-10) because Dr.Jit lacks second-order AD.  JAX has
real forward-mode: `jax.jacfwd` gives J in one line and composes with
reverse-mode for the NLL gradient, so the whole apparatus collapses to ~60
lines.  The custom-vs-AD gradient check (cell 10) becomes a jacfwd-vs-finite
-difference test.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import optax

from .mlp import apply_mlp, identity_init_mlp


def talu(x):
    """The reference's TaLU activation (cell 6): tanh for x<0, linear above —
    smooth, invertible-friendly."""
    return jnp.where(x < 0, jnp.tanh(x), x)


@dataclasses.dataclass(frozen=True)
class ReparamConfig:
    dim: int = 2
    hidden: int = 32
    depth: int = 3
    # squash: wrap the MLP as sigmoid(MLP(logit(z))) so T maps the unit
    # square to itself.  Without it, long NLL runs diverge: outside the
    # square the target floor is flat, so the optimizer inflates |det J|
    # without bound (measured: a 100k-iter run reached NLL -2.36 with a
    # structureless pushforward).  Identity init is preserved exactly
    # (sigmoid(logit(z)) = z), and det J picks up the chain factors
    # automatically through jacfwd.
    squash: bool = False
    # fold_penalty: see nll_loss — keeps T orientation-preserving
    # (bijective), which the reverse-KL objective requires
    fold_penalty: float = 0.0


def init_map(key, cfg: ReparamConfig):
    sizes = [cfg.dim] + [cfg.hidden] * (cfg.depth - 1) + [cfg.dim]
    return identity_init_mlp(key, sizes)


def apply_map(params, z, squash: bool = False):
    """T(z): the learned sampling map (fp32 — second-order work wants full
    precision).  squash: sigmoid(MLP(logit(z))) — see ReparamConfig."""
    eps = 1e-5
    h = jnp.log(jnp.clip(z, eps, 1 - eps) / (1 - jnp.clip(z, eps, 1 - eps))) \
        if squash else z
    for i, layer in enumerate(params):
        h = jnp.matmul(h, layer["w"],
                       precision=jax.lax.Precision.HIGHEST) + layer["b"]
        if i < len(params) - 1:
            h = talu(h)
    return jax.nn.sigmoid(h) if squash else h


def det_jacobian(params, z, squash: bool = False, signed: bool = False):
    """det J_T(z) per sample via forward-mode (vmapped jacfwd); abs
    unless signed=True."""
    J = jax.vmap(jax.jacfwd(lambda zz: apply_map(params, zz, squash)))(z)
    d = jnp.linalg.det(J)
    return d if signed else jnp.abs(d)


def nll_loss(params, z, log_p_ref, defensive=0.05, squash: bool = False,
             fold_penalty: float = 0.0):
    """-log( p_ref(T(z)) |det J| ) with a defensive mixture (cell 21).

    The objective is reverse KL and only valid while T stays BIJECTIVE
    (q(T(z)) = 1/|det J| needs single cover): long runs otherwise learn
    folded multi-cover maps whose |det J| > 1 everywhere and the NLL
    diverges to -inf with a structureless pushforward (measured).  A
    continuous fold reverses orientation across its crease, so
    `fold_penalty` * relu(-det) (signed det) keeps T orientation-
    preserving and the objective in the flow regime."""
    x = apply_map(params, z, squash)
    det = det_jacobian(params, z, squash, signed=True)
    p = jnp.exp(log_p_ref(x)) * jnp.abs(det)
    p = (1.0 - defensive) * p + defensive
    loss = -jnp.mean(jnp.log(jnp.maximum(p, 1e-12)))
    if fold_penalty:
        loss = loss + fold_penalty * jnp.mean(jax.nn.relu(-det))
    return loss


def train_reparam(log_p_ref, cfg: ReparamConfig = ReparamConfig(),
                  n_iters=1000, batch=1 << 12, lr=1e-3, seed=0):
    """Adam on the NLL; iterations run in jitted lax.scan chunks of 100
    (one device dispatch per chunk instead of one host round trip per
    step)."""
    key = jax.random.PRNGKey(seed)
    key, k = jax.random.split(key)
    params = init_map(k, cfg)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    chunk = min(100, n_iters)

    @jax.jit
    def run_chunk(params, opt_state, key):
        def one(carry, k):
            params, opt_state = carry
            z = jax.random.uniform(k, (batch, cfg.dim))
            loss, grads = jax.value_and_grad(nll_loss)(
                params, z, log_p_ref, squash=cfg.squash,
                fold_penalty=cfg.fold_penalty)
            updates, opt_state = opt.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            one, (params, opt_state), jax.random.split(key, chunk))
        return params, opt_state, losses[-1]

    losses = []
    for _ in range(max(n_iters // chunk, 1)):
        key, k = jax.random.split(key)
        params, opt_state, loss = run_chunk(params, opt_state, k)
        losses.append(float(loss))
    return params, losses
