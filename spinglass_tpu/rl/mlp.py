"""A plain-JAX multilayer perceptron: parameters are a dict of arrays.

``MLP(hidden_sizes, out_dim).init(key, x)`` returns the parameters for inputs
shaped like ``x``; ``apply(params, x)`` maps [..., in] to [..., out_dim].
Dense layers start from the LeCun-normal initialisation (truncated normal,
variance 1 / fan_in) with zero biases; the optional layer norm starts as the
identity.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
_LN_EPS = 1e-6


def _dense(key, fan_in: int, fan_out: int) -> dict:
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    w = std * jax.random.truncated_normal(key, -2.0, 2.0, (fan_in, fan_out),
                                          jnp.float32)
    return {"w": w, "b": jnp.zeros((fan_out,), jnp.float32)}


class MLP:
    """Dense -> [layer norm] -> activation per hidden size, then a linear
    output layer."""

    def __init__(self, hidden_sizes: Tuple[int, ...], out_dim: int,
                 activation: Callable = jnp.tanh, layer_norm: bool = False):
        self.hidden_sizes = tuple(hidden_sizes)
        self.out_dim = out_dim
        self.activation = activation
        self.layer_norm = layer_norm

    def init(self, key: jax.Array, x: jax.Array) -> dict:
        sizes = (x.shape[-1],) + self.hidden_sizes
        keys = jax.random.split(key, len(self.hidden_sizes) + 1)
        hidden = []
        for k, fan_in, fan_out in zip(keys, sizes[:-1], sizes[1:]):
            layer = _dense(k, fan_in, fan_out)
            if self.layer_norm:
                layer["scale"] = jnp.ones((fan_out,), jnp.float32)
                layer["offset"] = jnp.zeros((fan_out,), jnp.float32)
            hidden.append(layer)
        return {"hidden": hidden,
                "out": _dense(keys[-1], sizes[-1], self.out_dim)}

    def apply(self, params: dict, x: jax.Array) -> jax.Array:
        for layer in params["hidden"]:
            x = x @ layer["w"] + layer["b"]
            if self.layer_norm:
                mean = jnp.mean(x, axis=-1, keepdims=True)
                var = jnp.var(x, axis=-1, keepdims=True)
                x = ((x - mean) * jax.lax.rsqrt(var + _LN_EPS)
                     * layer["scale"] + layer["offset"])
            x = self.activation(x)
        return x @ params["out"]["w"] + params["out"]["b"]
