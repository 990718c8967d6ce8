"""Gaussian-basis KAN layers for the strain-limiting PINN.

Two flavors, matching the two reference implementations:
  * `GaussianKANLayer` — trainable coeff/lin/bias + TRAINABLE centers and
    log-widths (the Python flavor, `StrainLimiting_KAN_PINN.py:188-213`);
  * the Julia flavor (`StrainLimiting_KAN_PINN.jl:12-48`) has fixed
    centers — config flag `trainable_centers=False`.

`KANPINN` stacks them with tanh between hidden layers
(`StrainLimiting_KAN_PINN.py:216-227`: [2, H, H, H, 1]; Julia
[2, 32, 32, 1] :50-58 — depth configurable).

Everything is plain jnp (no custom VJP): the PINN residual needs
grad-of-grad, and XLA fuses the basis math fine at these sizes.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from kanodes.utils.precision import matmul_precision

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class GaussianKANLayer:
    in_dims: int
    out_dims: int
    n_basis: int
    scale: float = 0.1                 # init scale (:190)
    trainable_centers: bool = True     # Python flavor; False = Julia flavor
    center_range: tuple[float, float] = (0.0, 1.0)   # linspace(0,1,B) (:199)
    init_logwidth: float = math.log(0.15)            # (:201)

    def init(self, key: Array) -> dict:
        kc, kl = jax.random.split(key)
        p = {
            # coeff [I, B, O] (reference [O, I, B]; ours is GEMM-major)
            "coeff": self.scale * jax.random.normal(
                kc, (self.in_dims, self.n_basis, self.out_dims)),
            "lin": self.scale * jax.random.normal(
                kl, (self.in_dims, self.out_dims)),
            "bias": jnp.zeros((self.out_dims,)),
            "centers": jnp.linspace(self.center_range[0],
                                    self.center_range[1], self.n_basis),
            "logwidth": jnp.full((self.n_basis,), self.init_logwidth),
        }
        return p

    def apply(self, params: dict, x: Array) -> Array:
        centers = params["centers"]
        logwidth = params["logwidth"]
        if not self.trainable_centers:
            centers = jax.lax.stop_gradient(centers)
            logwidth = jax.lax.stop_gradient(logwidth)
        widths = jnp.exp(logwidth) + 1e-5                    # (:205)
        z = (x[..., None] - centers) / widths                # [..., I, B]
        bi = jnp.exp(-(z * z))
        flat = bi.reshape(*bi.shape[:-2], self.in_dims * self.n_basis)
        cflat = params["coeff"].reshape(self.in_dims * self.n_basis,
                                        self.out_dims)
        basis_part = jnp.matmul(flat, cflat, precision=matmul_precision())
        lin_part = jnp.matmul(x, params["lin"],
                              precision=matmul_precision())
        return lin_part + basis_part + params["bias"]

    def num_params(self) -> int:
        n = self.in_dims * self.n_basis * self.out_dims \
            + self.in_dims * self.out_dims + self.out_dims
        n += 2 * self.n_basis
        return n


@dataclasses.dataclass(frozen=True)
class KANPINN:
    """tanh-coupled Gaussian-KAN stack; widths e.g. (2, 96, 96, 96, 1)."""
    widths: tuple[int, ...] = (2, 96, 96, 96, 1)
    n_basis: int = 48
    trainable_centers: bool = True

    def __post_init__(self):
        object.__setattr__(self, "widths", tuple(self.widths))

    @property
    def in_dims(self) -> int:
        return self.widths[0]

    @property
    def out_dims(self) -> int:
        return self.widths[-1]

    @property
    def layers(self) -> tuple[GaussianKANLayer, ...]:
        return tuple(
            GaussianKANLayer(i, o, self.n_basis,
                             trainable_centers=self.trainable_centers)
            for i, o in zip(self.widths[:-1], self.widths[1:]))

    def init(self, key: Array) -> list:
        keys = jax.random.split(key, len(self.widths) - 1)
        return [l.init(k) for l, k in zip(self.layers, keys)]

    def apply(self, params: list, x: Array) -> Array:
        layers = self.layers
        for i, (layer, p) in enumerate(zip(layers, params)):
            x = layer.apply(p, x)
            if i < len(layers) - 1:
                x = jnp.tanh(x)
        return x

    def phi(self, params: list, xy: Array) -> Array:
        """Scalar field: [..., 2] -> [...] (phi_scalar, :631-633)."""
        return self.apply(params, xy)[..., 0]

    def num_params(self) -> int:
        return sum(l.num_params() for l in self.layers)
