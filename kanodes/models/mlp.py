"""MLP baseline — the reference's MLP-NODE comparator.

`LV_driver_MLP.jl:61` uses `Chain(Dense(2 => 50, tanh), Dense(50 => 2))`;
this is the same family, expressed as one configurable module so the
param-efficiency sweep (trend_plotter.py) runs both families through one
training path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from kanodes.models.core import glorot_uniform
from kanodes.ops import basis as B
from kanodes.utils.precision import matmul_precision

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class MLP:
    widths: tuple[int, ...]
    activation: str = "tanh"
    final_activation: str = "identity"
    use_bias: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "widths", tuple(self.widths))

    @property
    def in_dims(self) -> int:
        return self.widths[0]

    @property
    def out_dims(self) -> int:
        return self.widths[-1]

    def num_params(self) -> int:
        n = 0
        for i, o in zip(self.widths[:-1], self.widths[1:]):
            n += i * o + (o if self.use_bias else 0)
        return n

    def init(self, key: Array) -> list[dict]:
        dt = jnp.dtype(self.dtype)
        keys = jax.random.split(key, len(self.widths) - 1)
        params = []
        for k, (i, o) in zip(keys, zip(self.widths[:-1], self.widths[1:])):
            p = {"W": glorot_uniform(k, (i, o), fan_in=i, fan_out=o, dtype=dt)}
            if self.use_bias:
                p["b"] = jnp.zeros((o,), dtype=dt)
            params.append(p)
        return params

    def apply(self, params: list[dict], x: Array) -> Array:
        act = B.get_base_act(self.activation) if self.activation in B.BASE_ACTS \
            else B.get_normalizer(self.activation)
        n = len(params)
        for idx, p in enumerate(params):
            x = jnp.matmul(x, p["W"], preferred_element_type=x.dtype,
                           precision=matmul_precision())
            if self.use_bias:
                x = x + p["b"]
            if idx < n - 1:
                x = act(x)
        fin = self.final_activation
        if fin != "identity":
            x = B.get_base_act(fin)(x)
        return x

    def __call__(self, params, x):
        return self.apply(params, x)
