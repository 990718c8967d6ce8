"""KDense — the grid-basis Kolmogorov-Arnold layer.

Functional parity with the reference layer (`Lotka-Volterra/src/kdense.jl:
5-130`): each scalar edge i->o is a learned function
    phi_{i,o}(x) = sum_g C[i,g,o] * basis((norm(x) - grid[g]) / h)
                   (+ W[i,o] * base_act(x)  when use_base_act)
and the layer output is o_j = sum_i phi_{i,j}(x_i). The fused compute is one
basis expansion followed by one GEMM.

Differences from the reference:
  * batch-leading layout `[..., I] -> [..., O]` (the reference is
    column-major `[I, K]`);
  * the grid is a static constant folded into the jitted graph, not a
    runtime "state";
  * `C` is stored `[I, G, O]` (edge-major) so activation extraction and
    pruning (`sparsify/`) index it directly; the forward reshapes it to
    `[I*G, O]` for the GEMM, which XLA treats as a free bitcast;
  * the whole-RK-step kernels (`ops/rk_fused.py`) fuse a 2-layer
    chain's every RK stage; `apply` is the plain XLA path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from kanodes.models.core import glorot_uniform
from kanodes.models.core import Chain as _Chain
from kanodes.ops import basis as B
from kanodes.utils.precision import matmul_precision

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class KDense:
    """Grid-basis KAN layer (kdense.jl:20-37 constructor parity).

    Attributes:
      in_dims/out_dims/grid_len: layer shape; params C [I, G, O], W [I, O].
      normalizer: squashes inputs into grid_lims before basis eval
        ("tanh" default, kdense.jl:25).
      grid_lims: basis-center span (default (-1, 1), kdense.jl:26).
      denominator: shared bandwidth h; None -> span/(G-1) (kdense.jl:27).
      basis: "rbf" | "rswaf" | "iqf" or a callable (x, grid, h) -> [..., G].
      base_act: residual branch activation ("swish" default, kdense.jl:31).
      use_base_act: include the W * base_act(x) residual (kdense.jl:32).
    """

    in_dims: int
    out_dims: int
    grid_len: int
    normalizer: str = "tanh"
    grid_lims: tuple[float, float] = (-1.0, 1.0)
    denominator: float | None = None
    basis: str = "rbf"
    base_act: str = "swish"
    use_base_act: bool = True
    # adaptive-basis extension (beyond reference parity; cf. the
    # adaptive-RBF-KAN literature): learn per-layer center offsets and a
    # log-bandwidth. XLA path only (the fused kernels assume a static
    # grid).
    trainable_grid: bool = False
    dtype: str = "float32"

    # -- static helpers ----------------------------------------------------

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return B.default_denominator(self.grid_len, self.grid_lims)

    def grid(self) -> Array:
        return B.make_grid(self.grid_len, self.grid_lims,
                           dtype=jnp.dtype(self.dtype))

    def num_params(self) -> int:
        n = self.in_dims * self.grid_len * self.out_dims
        if self.use_base_act:
            n += self.in_dims * self.out_dims
        return n

    # -- parameters ---------------------------------------------------------

    def init(self, key: Array) -> dict:
        kc, kw = jax.random.split(key)
        dt = jnp.dtype(self.dtype)
        # fan parity with the reference's glorot on C:[O, G*I] (kdense.jl:75)
        p = {
            "C": glorot_uniform(
                kc, (self.in_dims, self.grid_len, self.out_dims),
                fan_in=self.in_dims * self.grid_len, fan_out=self.out_dims,
                dtype=dt),
        }
        if self.use_base_act:
            p["W"] = glorot_uniform(
                kw, (self.in_dims, self.out_dims),
                fan_in=self.in_dims, fan_out=self.out_dims, dtype=dt)
        if self.trainable_grid:
            p["grid_offset"] = jnp.zeros((self.grid_len,), dtype=dt)
            p["log_h"] = jnp.asarray(jnp.log(self.h), dtype=dt)
        return p

    # -- forward -------------------------------------------------------------

    def basis_values(self, x: Array, params: dict | None = None) -> Array:
        """[..., I] -> [..., I, G] basis tensor on the normalized input."""
        xn = B.get_normalizer(self.normalizer)(x)
        grid, h = self.grid(), self.h
        if self.trainable_grid and params is not None:
            grid = grid + params["grid_offset"]
            h = jnp.exp(params["log_h"])
        return B.get_basis(self.basis)(xn, grid, h)

    def apply(self, params: dict, x: Array) -> Array:
        """Forward pass [..., I] -> [..., O]  (kdense.jl:109-130)."""
        bas = self.basis_values(x, params)               # [..., I, G]
        flat = bas.reshape(*bas.shape[:-2], self.in_dims * self.grid_len)
        C2 = params["C"].reshape(self.in_dims * self.grid_len, self.out_dims)
        y = jnp.matmul(flat, C2, preferred_element_type=flat.dtype,
                       precision=matmul_precision())
        if self.use_base_act:
            base = B.get_base_act(self.base_act)(x)
            y = y + jnp.matmul(base, params["W"],
                               preferred_element_type=flat.dtype,
                               precision=matmul_precision())
        return y

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)

    # -- introspection (used by sparsify/activations.py) ---------------------

    def edge_activations(self, params: dict, x: Array) -> Array:
        """Per-edge activations phi_{i->o}(x_i): [..., I, O].

        The un-fused view of the forward pass — `sum over i` of this tensor
        equals `apply` (the reference recomputes this in
        `Activation_getter.jl:3-63` for pruning and plotting).
        """
        bas = self.basis_values(x, params)               # [..., I, G]
        spline = jnp.einsum("...ig,igo->...io", bas, params["C"],
                            precision=matmul_precision())
        if self.use_base_act:
            base = B.get_base_act(self.base_act)(x)      # [..., I]
            spline = spline + base[..., None] * params["W"]
        return spline


@dataclasses.dataclass(frozen=True)
class KDense1:
    """Alternate shared-spline KAN layer (`src/alternate.jl:7-70`).

    Per-input spline (one coefficient vector per input, no per-edge
    functions) followed by a linear mix. Kept for parity: the reference
    retains it as a documented negative result ("doesn't train well",
    alternate.jl:4).
    """

    in_dims: int
    out_dims: int
    grid_len: int
    denominator: float | None = None
    base_act: str = "swish"
    use_base_act: bool = True
    basis: str = "rbf"
    dtype: str = "float32"

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return 2.0 / (self.grid_len - 1)

    def grid(self) -> Array:
        return B.make_grid(self.grid_len, (-1.0, 1.0),
                           dtype=jnp.dtype(self.dtype))

    def num_params(self) -> int:
        return self.in_dims * (self.grid_len + self.out_dims)

    def init(self, key: Array) -> dict:
        kc, kw = jax.random.split(key)
        dt = jnp.dtype(self.dtype)
        return {
            # reference C: [G, I] (alternate.jl:41) -> ours [I, G]
            "C": glorot_uniform(kc, (self.in_dims, self.grid_len),
                                fan_in=self.in_dims, fan_out=self.grid_len,
                                dtype=dt),
            "W": glorot_uniform(kw, (self.in_dims, self.out_dims),
                                fan_in=self.in_dims, fan_out=self.out_dims,
                                dtype=dt),
        }

    def apply(self, params: dict, x: Array) -> Array:
        xn = jnp.tanh(x)
        bas = B.get_basis(self.basis)(xn, self.grid(), self.h)  # [..., I, G]
        spline = jnp.sum(params["C"] * bas, axis=-1)            # [..., I]
        if self.use_base_act:
            spline = spline + B.get_base_act(self.base_act)(x)
        return jnp.matmul(spline, params["W"],
                          preferred_element_type=spline.dtype,
                          precision=matmul_precision())

    def __call__(self, params, x):
        return self.apply(params, x)


class KANChain(_Chain):
    """Chain of KDense layers — the reference's `Lux.Chain(KDense, KDense)`
    (`LV_driver_KANODE.jl:136-142`).

    `KANChain.mlp_like([2, 10, 2], grid_len=5)` builds the canonical stack.
    """

    @classmethod
    def mlp_like(cls, widths: list[int], grid_len: int, **kw) -> "KANChain":
        layers = [
            KDense(i, o, grid_len, **kw)
            for i, o in zip(widths[:-1], widths[1:])
        ]
        return cls(*layers)

    def apply(self, params, x: Array) -> Array:
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x
