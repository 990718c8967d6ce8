"""B-spline KAN layer — parity with the PyTorch efficient-kan flavor.

Rebuild of `Lotka-Volterra-Pytorch/efficient_kan/efficientkan.py`
(vendored Blealtan/efficient-kan): Cox-de Boor B-spline bases of order k
on a per-feature padded knot grid (:27-36, :78-111), least-squares
coefficient (re)fit `curve2coeff` (:113-143), fused linear forward
(:153-166), **adaptive grid refit from sample quantiles** `update_grid`
(:168-215), and the L1+entropy regularization view (:217-237).

JAX-native design notes:
  * the knot grid is carried in the params dict (it is data-dependent
    state mutated by `update_grid`) but wrapped in stop_gradient — the
    optimizer sees zero gradient and leaves it untouched;
  * `update_grid` is a pure function (params, x) -> params with
    identical shapes, so training can continue under the same jit;
  * lstsq is `jnp.linalg.lstsq` vmapped over input features.
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
class BSplineKAN:
    """One KANLinear layer (efficientkan.py:9-76 constructor parity).

    grid_size: number of intervals G; spline_order: k (default 3);
    coefficients: [I, G+k, O]. scale_noise/base/spline and
    grid_eps follow the reference defaults (:10-20).
    """

    in_dims: int
    out_dims: int
    grid_size: int = 5
    spline_order: int = 3
    scale_noise: float = 0.1
    scale_base: float = 1.0
    scale_spline: float = 1.0
    base_act: str = "swish"       # reference uses SiLU (:18)
    grid_eps: float = 0.02
    grid_range: tuple[float, float] = (-1.0, 1.0)
    standalone_scaler: bool = True   # enable_standalone_scale_spline (:19)
    dtype: str = "float32"

    @property
    def n_coeff(self) -> int:
        return self.grid_size + self.spline_order

    def num_params(self) -> int:
        n = self.in_dims * self.out_dims          # base_weight
        n += self.in_dims * self.n_coeff * self.out_dims
        if self.standalone_scaler:
            n += self.in_dims * self.out_dims
        return n

    # -- init (efficientkan.py:38-62: noise-fit spline init) ----------------

    def init(self, key: Array) -> dict:
        kb, kn, ks = jax.random.split(key, 3)
        dt = jnp.dtype(self.dtype)
        grid = B.make_bspline_grid(self.in_dims, self.grid_size,
                                   self.spline_order, self.grid_range, dt)
        base_w = glorot_uniform(kb, (self.in_dims, self.out_dims),
                                fan_in=self.in_dims, fan_out=self.out_dims,
                                dtype=dt) * self.scale_base
        # init spline coeffs by fitting noise at the grid points (:52-58)
        pts = grid[:, self.spline_order:-self.spline_order].T  # [G+1, I]
        noise = (jax.random.uniform(kn, (self.grid_size + 1, self.in_dims,
                                         self.out_dims), dt) - 0.5) \
            * self.scale_noise / self.grid_size
        coeff = self.curve2coeff(pts, noise, grid)
        if not self.standalone_scaler:
            coeff = coeff * self.scale_spline
        p = {"grid": grid, "base_w": base_w, "coeff": coeff}
        if self.standalone_scaler:
            p["scaler"] = glorot_uniform(
                ks, (self.in_dims, self.out_dims), fan_in=self.in_dims,
                fan_out=self.out_dims, dtype=dt) * self.scale_spline
        return p

    # -- forward (efficientkan.py:153-166) ----------------------------------

    def scaled_coeff(self, params: dict) -> Array:
        c = params["coeff"]
        if self.standalone_scaler:
            c = c * params["scaler"][:, None, :]
        return c

    def apply(self, params: dict, x: Array) -> Array:
        grid = jax.lax.stop_gradient(params["grid"])
        bas = B.bspline_basis(x, grid, self.spline_order)  # [..., I, G+k]
        c = self.scaled_coeff(params)                      # [I, G+k, O]
        flat = bas.reshape(*bas.shape[:-2], self.in_dims * self.n_coeff)
        spline = jnp.matmul(
            flat, c.reshape(self.in_dims * self.n_coeff, self.out_dims),
            precision=matmul_precision())
        base = jnp.matmul(B.get_base_act(self.base_act)(x),
                          params["base_w"], precision=matmul_precision())
        return spline + base

    def __call__(self, params, x):
        return self.apply(params, x)

    # -- least-squares refit (efficientkan.py:113-143) ----------------------

    def curve2coeff(self, x: Array, y: Array, grid: Array) -> Array:
        """Fit coefficients so the splines interpolate (x, y).

        x: [N, I] sample points; y: [N, I, O] target values per edge.
        Returns [I, G+k, O].
        """
        bas = B.bspline_basis(x, grid, self.spline_order)  # [N, I, G+k]
        A = jnp.transpose(bas, (1, 0, 2))                  # [I, N, G+k]
        Y = jnp.transpose(y, (1, 0, 2))                    # [I, N, O]

        def solve(a, b):
            return jnp.linalg.lstsq(a, b)[0]               # [G+k, O]

        return jax.vmap(solve)(A, Y)

    # -- adaptive grid (efficientkan.py:168-215) -----------------------------

    def update_grid(self, params: dict, x: Array) -> dict:
        """Refit the knot grid to the sample distribution of x ([N, I]),
        mixing quantile knots with uniform knots by grid_eps, then refit
        the coefficients so the layer's function is preserved."""
        k, G = self.spline_order, self.grid_size
        grid = params["grid"]
        # current spline values at the samples (unscaled coeff refit target)
        bas = B.bspline_basis(x, jax.lax.stop_gradient(grid), k)
        y = jnp.einsum("nig,igo->nio", bas, self.scaled_coeff(params),
                       precision=matmul_precision())

        xs = jnp.sort(x, axis=0)                           # [N, I]
        N = x.shape[0]
        idx = jnp.linspace(0, N - 1, G + 1).astype(jnp.int32)
        grid_adaptive = xs[idx].T                          # [I, G+1]
        step = (xs[-1] - xs[0] + 2 * 0.01) / G             # margin (:189)
        grid_uniform = (xs[0] - 0.01)[:, None] \
            + step[:, None] * jnp.arange(G + 1)[None, :]
        new_core = self.grid_eps * grid_uniform \
            + (1 - self.grid_eps) * grid_adaptive          # [I, G+1]
        left = new_core[:, :1] - step[:, None] * jnp.arange(k, 0, -1)
        right = new_core[:, -1:] + step[:, None] * jnp.arange(1, k + 1)
        new_grid = jnp.concatenate([left, new_core, right], axis=1)

        new_coeff = self.curve2coeff(x, y, new_grid)
        out = dict(params)
        out["grid"] = new_grid
        if self.standalone_scaler:
            # fold the refit into coeff, keep scaler — divide out scaler
            out["coeff"] = new_coeff / params["scaler"][:, None, :]
        else:
            out["coeff"] = new_coeff
        return out

    # -- regularization view (efficientkan.py:217-237) -----------------------

    def regularization_loss(self, params: dict, act_reg: float = 1.0,
                            entropy_reg: float = 1.0) -> Array:
        a = jnp.abs(params["coeff"]).mean(axis=1)          # [I, O] (:229)
        total = jnp.sum(a)
        frac = a / (total + 1e-12)
        entropy = -jnp.sum(frac * jnp.log(frac + 1e-12))
        return act_reg * total + entropy_reg * entropy


class BSplineKANChain:
    """Stack of BSplineKAN layers — the reference `KAN` module
    (efficientkan.py:240-285) with `update_grid` threading."""

    def __init__(self, widths: list[int], **kw):
        self.layers = tuple(
            BSplineKAN(i, o, **kw) for i, o in zip(widths[:-1], widths[1:]))
        self.in_dims = widths[0]
        self.out_dims = widths[-1]

    def init(self, key: Array):
        keys = jax.random.split(key, len(self.layers))
        return [l.init(k) for l, k in zip(self.layers, keys)]

    def apply(self, params, x: Array):
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def update_grids(self, params, x: Array):
        """Thread x through the chain, refitting every layer's grid
        (efficientkan.py:263-266)."""
        new = []
        for layer, p in zip(self.layers, params):
            new.append(layer.update_grid(p, x))
            x = layer.apply(new[-1], x)
        return new

    def num_params(self) -> int:
        return sum(l.num_params() for l in self.layers)

    def regularization_loss(self, params, act_reg=1.0, entropy_reg=1.0):
        return sum(l.regularization_loss(p, act_reg, entropy_reg)
                   for l, p in zip(self.layers, params))
