"""Gray-box RHS composition: known physics + learned pointwise KAN.

The reference's hidden-physics pattern (`Fisher-KPP_Source.jl:95-98`,
`Allen-Cahn_Source.jl:90-93`) is
    du/dt = D * Lap @ u  +  kan.(u)
— a known linear operator plus a scalar 1->1 KAN broadcast over every
grid node. On an accelerator the broadcast IS the natural form: the
pointwise KAN
evaluated on the whole grid batches the basis expansion into one
[N, G] x [G, 1] GEMM, so the "hot scalar broadcast" of the reference
becomes a single fused op over all nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class GrayBoxRHS:
    """rhs(t, u, params) = known(t, u) + pointwise_model(params, u).

    `model` maps [..., 1] -> [..., 1]; it is applied to the grid state
    u: [N] by treating nodes as the batch axis.
    """

    known: Callable[[Array, Array], Array]   # (t, u[N]) -> [N]
    model: "object"                          # layer with .apply

    def __call__(self, t, u: Array, params) -> Array:
        learned = self.model.apply(params, u[..., None])[..., 0]
        return self.known(t, u) + learned


@dataclasses.dataclass(frozen=True)
class FullSurrogateRHS:
    """rhs = model(u): the whole semi-discrete RHS is the network, the
    grid state is the network input vector (`Burgers_Surrogate.jl:82-88`,
    402-dim for Schrödinger `Schrodinger_Surrogate.jl:93-96`)."""

    model: "object"

    def __call__(self, t, u: Array, params) -> Array:
        return self.model.apply(params, u)
