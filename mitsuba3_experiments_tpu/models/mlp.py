"""Plain-pytree MLP in bf16 — the JAX analog of drjit.nn's cooperative-vector
networks (nn.Linear/Sequential/LeakyReLU..., /root/reference/nerad.py:66-89,
normflow.py:274-352).

Coopvec on CUDA keeps per-thread activations in registers and hits tensor
cores via warp cooperation; in JAX the same thing is a batched matmul that
XLA hands to the matrix units: activations (N, C) @ weights (C, C') in
bfloat16 with fp32 accumulation.  Master parameters stay fp32 (the fp16-weights/fp32-Adam AMP
split of nerad.py:336-347 is unnecessary in bf16 — no GradScaler needed).
"""
from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp

ACTS = {
    "relu": jax.nn.relu,
    "leaky_relu": lambda x: jax.nn.leaky_relu(x, 0.01),
    "gelu": jax.nn.gelu,
    "exp": jnp.exp,
    "tanh": jnp.tanh,
    "none": lambda x: x,
}


def init_mlp(key, sizes: Sequence[int], scale: float | None = None):
    """He-uniform init; returns list of {'w': (in, out), 'b': (out,)} fp32."""
    params = []
    for cin, cout in zip(sizes[:-1], sizes[1:]):
        key, k1, k2 = jax.random.split(key, 3)
        s = scale if scale is not None else math.sqrt(2.0 / cin)
        params.append(
            {
                "w": jax.random.normal(k1, (cin, cout), jnp.float32) * s,
                "b": jnp.zeros((cout,), jnp.float32),
            }
        )
    return params


def apply_mlp(params, x, hidden_act="leaky_relu", out_act="none",
              compute_dtype=jnp.bfloat16):
    """Forward pass: bf16 matmuls with fp32 accumulation."""
    act = ACTS[hidden_act]
    h = x.astype(compute_dtype)
    for i, layer in enumerate(params):
        w = layer["w"].astype(compute_dtype)
        h = (
            jnp.dot(h, w, preferred_element_type=jnp.float32)
            + layer["b"]
        )
        if i < len(params) - 1:
            h = act(h).astype(compute_dtype)
    return ACTS[out_act](h)


def identity_init_mlp(key, sizes: Sequence[int], eps: float = 1e-2):
    """Near-identity init (reparam.ipynb identity-pretrain trick): small
    random weights + identity passthrough where square."""
    params = init_mlp(key, sizes, scale=eps)
    for layer in params:
        w = layer["w"]
        if w.shape[0] == w.shape[1]:
            layer["w"] = w + jnp.eye(w.shape[0], dtype=w.dtype)
    return params
