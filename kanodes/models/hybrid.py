"""Hybrid KAN+MLP model and data normalization.

Rebuild of the optimized-PyTorch pipeline's extras
(`Lotka-Volterra-Pytorch/optimized_kan.py`):
  * `HybridKANMLP` (:346-389) — a KAN branch and an MLP branch blended by
    a learned scalar gate alpha = sigmoid(a): y = alpha*kan + (1-alpha)*mlp;
  * `DataNormalizer` (:396-464) — min-max mapping of states to [-1, 1]
    with the chain-rule RHS rescaling used during ODE training
    (`optimized_training.py:382-394`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.models.bspline import BSplineKANChain
from kanodes.models.mlp import MLP

Array = jax.Array


class HybridKANMLP:
    """alpha-blended KAN + MLP (optimized_kan.py:346-389)."""

    def __init__(self, widths: list[int], grid_size: int = 5,
                 mlp_hidden: int = 32, **kan_kw):
        self.kan = BSplineKANChain(widths, grid_size=grid_size, **kan_kw)
        self.mlp = MLP((widths[0], mlp_hidden, widths[-1]))
        self.in_dims = widths[0]
        self.out_dims = widths[-1]

    def init(self, key: Array) -> dict:
        k1, k2 = jax.random.split(key)
        return {
            "kan": self.kan.init(k1),
            "mlp": self.mlp.init(k2),
            "gate": jnp.asarray(0.0),    # sigmoid(0) = 0.5 blend (:361)
        }

    def apply(self, params: dict, x: Array) -> Array:
        alpha = jax.nn.sigmoid(params["gate"])
        return alpha * self.kan.apply(params["kan"], x) \
            + (1.0 - alpha) * self.mlp.apply(params["mlp"], x)

    def blend(self, params: dict) -> float:
        return float(jax.nn.sigmoid(params["gate"]))

    def num_params(self) -> int:
        return self.kan.num_params() + self.mlp.num_params() + 1


@dataclasses.dataclass
class DataNormalizer:
    """Min-max to [-1, 1] (optimized_kan.py:396-464). Fit on host data;
    `scale` is the per-dim half-range used for RHS chain-rule rescaling:
    if z = norm(u), dz/dt = du/dt / scale."""

    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, X: np.ndarray, margin: float = 0.0) -> "DataNormalizer":
        lo = X.min(axis=0) - margin
        hi = X.max(axis=0) + margin
        span = np.maximum(hi - lo, 1e-12)
        return cls(lo.astype(np.float32), (lo + span).astype(np.float32))

    @property
    def scale(self) -> np.ndarray:
        return (self.hi - self.lo) / 2.0

    def normalize(self, u):
        lo = jnp.asarray(self.lo)
        hi = jnp.asarray(self.hi)
        return 2.0 * (u - lo) / (hi - lo) - 1.0

    def denormalize(self, z):
        lo = jnp.asarray(self.lo)
        hi = jnp.asarray(self.hi)
        return (z + 1.0) * (hi - lo) / 2.0 + lo

    def wrap_rhs(self, rhs):
        """Given rhs(t, u, p) in physical space, return the normalized-
        space RHS (optimized_training.py:382-394): the model sees
        z in [-1,1], dynamics are rescaled by 1/scale."""
        s = jnp.asarray(self.scale)

        def rhs_norm(t, z, p):
            u = self.denormalize(z)
            return rhs(t, u, p) / s

        return rhs_norm
