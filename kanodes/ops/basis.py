"""Grid-basis functions for KAN layers.

Functional parity with the reference basis library
(`Lotka-Volterra/src/utils.jl:8-62`): three radial/bump bases evaluated on a
fixed 1-D grid of centers with a shared bandwidth, plus the Cox-de Boor
B-spline basis used by the PyTorch flavor
(`Lotka-Volterra-Pytorch/efficient_kan/efficientkan.py:78-111`).

Design notes (deliberately NOT a port):

* The reference attaches hand-written `ChainRulesCore.rrule`s to each basis to
  bypass Zygote's broadcast-AD overhead. JAX has no such overhead — XLA fuses
  the elementwise chain and its transpose — so the bases here are plain `jnp`
  compositions. That also makes them differentiable to *arbitrary* order,
  which the KAN-PINN residual (nested grad-of-grad) requires; a `custom_vjp`
  would have capped us at first order on the backward path.
* All bases broadcast: `x[..., 1] against grid[G] -> [..., G]`. Callers vmap /
  reshape; nothing here assumes a batch layout.
* The fused Pallas fast path lives in `kanodes.ops.kdense_pallas`; this
  module is the always-correct XLA reference implementation that the kernel
  is tested against.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array


def make_grid(grid_len: int, grid_lims: tuple[float, float] = (-1.0, 1.0),
              dtype=jnp.float32) -> Array:
    """Uniform grid of basis centers, `LinRange(lims..., G)` in the reference
    (`kdense.jl:88-92`)."""
    return jnp.linspace(grid_lims[0], grid_lims[1], grid_len, dtype=dtype)


def default_denominator(grid_len: int,
                        grid_lims: tuple[float, float] = (-1.0, 1.0)) -> float:
    """Shared bandwidth h = span / (G - 1)  (`kdense.jl:27`)."""
    return (grid_lims[1] - grid_lims[0]) / (grid_len - 1)


# ---------------------------------------------------------------------------
# Radial bases  (utils.jl:8-62). Each maps  x[..., 1], grid[G], h  ->  [..., G]
# via the normalized distance y = (x - z) / h.
# ---------------------------------------------------------------------------

def rbf(x: Array, grid: Array, h) -> Array:
    """Gaussian RBF: exp(-((x - z)/h)^2)   (utils.jl:8-13)."""
    y = (x[..., None] - grid) / h
    return jnp.exp(-(y * y))


def rswaf(x: Array, grid: Array, h) -> Array:
    """Reflectional switch: sech((x-z)/h)^2 = 1 - tanh(y)^2  (utils.jl:27-34)."""
    y = (x[..., None] - grid) / h
    t = jnp.tanh(y)
    return 1.0 - t * t


def iqf(x: Array, grid: Array, h) -> Array:
    """Inverse quadratic: 1 / (1 + y^2)   (utils.jl:49-54)."""
    y = (x[..., None] - grid) / h
    return 1.0 / (1.0 + y * y)


def cheby(x: Array, grid: Array, h) -> Array:
    """Chebyshev polynomial basis T_0..T_{G-1} (beyond parity: the
    fKAN / AC-PKAN-style polynomial-basis KAN variant; see PAPERS.md).

    Global polynomials instead of local radial bumps: the layer's tanh
    normalizer already maps inputs into Chebyshev's natural [-1, 1]
    domain, so `grid` only sets G and `h` is unused. The recurrence
    unrolls at trace time (G is static and small), leaving a fused
    elementwise chain for XLA.
    """
    G = grid.shape[-1]
    z = jnp.clip(x, -1.0, 1.0)
    ts = [jnp.ones_like(z), z]
    for _ in range(2, G):
        ts.append(2.0 * z * ts[-1] - ts[-2])
    return jnp.stack(ts[:G], axis=-1)


def fourier(x: Array, grid: Array, h) -> Array:
    """Truncated Fourier basis 1, sin(pi x), cos(pi x), sin(2 pi x), ...
    (beyond parity: the FourierKAN-style variant; see PAPERS.md).

    Global periodic features instead of local radial bumps. The layer's
    tanh normalizer maps inputs into (-1, 1), one fundamental period of
    omega = pi, so like `cheby` the `grid` only sets G and `h` is
    unused. G features = DC + ceil((G-1)/2) sin/cos pairs; the loop
    unrolls at trace time (G static, small) into one fused elementwise
    chain. Periodic, bounded, and C^inf everywhere — no domain clip.
    """
    G = grid.shape[-1]
    feats = [jnp.ones_like(x)]
    k = 1
    while len(feats) < G:
        feats.append(jnp.sin(k * jnp.pi * x))
        if len(feats) < G:
            feats.append(jnp.cos(k * jnp.pi * x))
        k += 1
    return jnp.stack(feats[:G], axis=-1)


BASIS_FUNCS: dict[str, Callable[..., Array]] = {
    "rbf": rbf,
    "rswaf": rswaf,
    "iqf": iqf,
    "cheby": cheby,
    "fourier": fourier,
}


def get_basis(name_or_fn) -> Callable[..., Array]:
    if callable(name_or_fn):
        return name_or_fn
    try:
        return BASIS_FUNCS[name_or_fn]
    except KeyError:
        raise ValueError(
            f"unknown basis {name_or_fn!r}; have {sorted(BASIS_FUNCS)}"
        ) from None


# ---------------------------------------------------------------------------
# Closed-form first derivatives w.r.t. x (used by interpretability plots and
# by the Pallas backward kernel; autodiff of the fns above matches these).
# ---------------------------------------------------------------------------

def rbf_dx(x: Array, grid: Array, h) -> Array:
    y = (x[..., None] - grid) / h
    return -2.0 * y * jnp.exp(-(y * y)) / h


def rswaf_dx(x: Array, grid: Array, h) -> Array:
    y = (x[..., None] - grid) / h
    t = jnp.tanh(y)
    return -2.0 * t * (1.0 - t * t) / h


def iqf_dx(x: Array, grid: Array, h) -> Array:
    y = (x[..., None] - grid) / h
    d = 1.0 + y * y
    return -2.0 * y / (d * d) / h


def cheby_dx(x: Array, grid: Array, h) -> Array:
    """dT_k/dx = k * U_{k-1}(x); zero outside the clipped domain
    (matches autodiff through jnp.clip)."""
    G = grid.shape[-1]
    z = jnp.clip(x, -1.0, 1.0)
    inside = ((x >= -1.0) & (x <= 1.0)).astype(z.dtype)
    us = [jnp.ones_like(z), 2.0 * z]
    for _ in range(2, G - 1):
        us.append(2.0 * z * us[-1] - us[-2])
    ds = [jnp.zeros_like(z)]
    for k in range(1, G):
        ds.append(k * us[k - 1] * inside)
    return jnp.stack(ds[:G], axis=-1)


def fourier_dx(x: Array, grid: Array, h) -> Array:
    """d/dx of `fourier`: 0, pi cos(pi x), -pi sin(pi x), ..."""
    G = grid.shape[-1]
    ds = [jnp.zeros_like(x)]
    k = 1
    while len(ds) < G:
        ds.append(k * jnp.pi * jnp.cos(k * jnp.pi * x))
        if len(ds) < G:
            ds.append(-k * jnp.pi * jnp.sin(k * jnp.pi * x))
        k += 1
    return jnp.stack(ds[:G], axis=-1)


BASIS_DX = {"rbf": rbf_dx, "rswaf": rswaf_dx, "iqf": iqf_dx,
            "cheby": cheby_dx, "fourier": fourier_dx}


# ---------------------------------------------------------------------------
# Normalizers / base activations (kdense.jl:25,31; NNlib fast_act is a Julia
# micro-optimization with no JAX analogue needed).
# ---------------------------------------------------------------------------

def softsign(x: Array) -> Array:
    return x / (1.0 + jnp.abs(x))


def swish(x: Array) -> Array:
    return x * jax.nn.sigmoid(x)


NORMALIZERS: dict[str, Callable[[Array], Array]] = {
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "softsign": softsign,
    "identity": lambda x: x,
}

BASE_ACTS: dict[str, Callable[[Array], Array]] = {
    "swish": swish,
    "silu": swish,
    "tanh": jnp.tanh,
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "identity": lambda x: x,
}


def get_normalizer(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return NORMALIZERS[name_or_fn]


def get_base_act(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return BASE_ACTS[name_or_fn]


# ---------------------------------------------------------------------------
# Cox-de Boor B-spline basis (efficientkan.py:78-111). The PyTorch reference
# keeps a per-feature padded grid buffer [I, G + 2k + 1] and computes k-order
# splines by recursion; we keep the same contract so `update_grid`-style
# quantile refits (sparsify/grid_update.py) carry over.
# ---------------------------------------------------------------------------

def bspline_basis(x: Array, grid: Array, k: int) -> Array:
    """B-spline bases of order `k` (degree k) on a padded knot grid.

    Args:
      x:    [..., I] inputs.
      grid: [I, G + 2k + 1] padded knots, ascending along the last axis
            (G = number of intervals in the unpadded grid).
      k:    spline order (reference default 3, efficientkan.py:34).

    Returns:
      [..., I, G + k] basis values (each row sums to 1 inside the grid).
    """
    x = x[..., None]                         # [..., I, 1]
    # order-0: indicator of the knot interval
    b = ((x >= grid[..., :-1]) & (x < grid[..., 1:])).astype(x.dtype)
    for d in range(1, k + 1):
        left_num = x - grid[..., : -(d + 1)]
        left_den = grid[..., d:-1] - grid[..., : -(d + 1)]
        right_num = grid[..., d + 1:] - x
        right_den = grid[..., d + 1:] - grid[..., 1:-d]
        b = (left_num / left_den) * b[..., :-1] + (right_num / right_den) * b[..., 1:]
    return b


def make_bspline_grid(in_dims: int, grid_size: int, k: int,
                      grid_range: tuple[float, float] = (-1.0, 1.0),
                      dtype=jnp.float32) -> Array:
    """Padded uniform knot grid, one row per input feature
    (efficientkan.py:27-36)."""
    lo, hi = grid_range
    h = (hi - lo) / grid_size
    knots = (jnp.arange(-k, grid_size + k + 1, dtype=dtype) * h + lo)
    return jnp.tile(knots[None, :], (in_dims, 1))
