"""1-D method-of-lines finite-difference operators.

The reference builds these either via ModelingToolkit/MethodOfLines
discretization (`Burgers_Surrogate.jl:34-64`) or by hand as a dense
periodic Laplacian matrix applied with a GEMV
(`Fisher-KPP_Source.jl:55-59`). Here both forms exist:

  * stencil ops (roll / slicing) — O(N) and fuse into the RHS;
  * dense operator matrices — for parity checks and because a dense
    [N, N] x [N, B] GEMM is actually the fastest form for batched
    states at moderate N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


# -- stencil forms -----------------------------------------------------------

def laplacian_periodic(u: Array, dx: float) -> Array:
    """Second-order centered Laplacian with periodic wrap (last axis)."""
    return (jnp.roll(u, -1, axis=-1) - 2.0 * u + jnp.roll(u, 1, axis=-1)) \
        / (dx * dx)


def laplacian_periodic_2d(u: Array, dx: float) -> Array:
    """5-point periodic Laplacian over the last TWO axes (square dx)."""
    return (jnp.roll(u, -1, axis=-1) + jnp.roll(u, 1, axis=-1)
            + jnp.roll(u, -1, axis=-2) + jnp.roll(u, 1, axis=-2)
            - 4.0 * u) / (dx * dx)


def laplacian_dirichlet(u: Array, dx: float, left: float = 0.0,
                        right: float = 0.0) -> Array:
    """Centered Laplacian with Dirichlet ghost values (last axis)."""
    up = jnp.concatenate(
        [jnp.full_like(u[..., :1], left), u,
         jnp.full_like(u[..., :1], right)], axis=-1)
    return (up[..., 2:] - 2.0 * up[..., 1:-1] + up[..., :-2]) / (dx * dx)


def ddx_central_periodic(u: Array, dx: float) -> Array:
    return (jnp.roll(u, -1, axis=-1) - jnp.roll(u, 1, axis=-1)) / (2.0 * dx)


def ddx_central_dirichlet(u: Array, dx: float, left: float = 0.0,
                          right: float = 0.0) -> Array:
    up = jnp.concatenate(
        [jnp.full_like(u[..., :1], left), u,
         jnp.full_like(u[..., :1], right)], axis=-1)
    return (up[..., 2:] - up[..., :-2]) / (2.0 * dx)


# -- dense operator matrices (Fisher-KPP_Source.jl:55-59 pattern) -----------

def laplacian_matrix_periodic(n: int, dx: float, dtype=np.float64) -> np.ndarray:
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
           + np.diag(np.ones(n - 1), -1))
    lap[0, -1] = 1.0
    lap[-1, 0] = 1.0
    return (lap / dx ** 2).astype(dtype)


def laplacian_matrix_dirichlet(n: int, dx: float, dtype=np.float64) -> np.ndarray:
    lap = (np.diag(-2.0 * np.ones(n)) + np.diag(np.ones(n - 1), 1)
           + np.diag(np.ones(n - 1), -1))
    return (lap / dx ** 2).astype(dtype)


# -- grids -------------------------------------------------------------------

def uniform_grid(lo: float, hi: float, n: int, *, endpoint: bool = True,
                 dtype=np.float64):
    """Return (x, dx). endpoint=False gives the periodic convention."""
    if endpoint:
        x = np.linspace(lo, hi, n, dtype=dtype)
        dx = (hi - lo) / (n - 1)
    else:
        x = np.linspace(lo, hi, n, endpoint=False, dtype=dtype)
        dx = (hi - lo) / n
    return x, float(dx)
