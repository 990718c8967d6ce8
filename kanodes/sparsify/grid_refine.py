"""Grid refinement for KDense chains (efficient-kan `update_grid` for
the grid-basis layer family).

The reference refits B-spline knots to the quantiles of the inputs a
layer actually sees (`efficientkan.py:168-215`); round 2 exercised that
cadence on the LV B-spline chain only. This module is the KDense
counterpart used by the PDE-surrogate chains: the basis grid is a
STATIC uniform [lo, hi] span baked into the jitted graph (and into the
fused Pallas kernels' constants), so a refit

  1. measures the span the normalized layer inputs actually occupy
     (quantiles over states visited by the trained trajectory),
  2. rebuilds the layers with `grid_lims` shrunk onto that span (both
     layers share one span — the fused ChainSpec contract), and
  3. least-squares refits every edge's C coefficients so the learned
     functions are PRESERVED on the sampled range (the lstsq step of
     `efficientkan.py:113-143`); W (base branch) is grid-independent.

The returned chain has new static constants, so the next jit/kernel
compile picks up the refined grid (one extra compile per refit — cheap
next to a 1e5-iteration budget).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.ops import basis as B
from kanodes.sparsify.activations import chain_activations
from kanodes.utils.precision import matmul_precision

Array = jax.Array


def refine_kdense_chain_grid(chain, params, x_samples: Array, *,
                             q: tuple[float, float] = (0.0, 1.0),
                             pad: float = 0.05) -> tuple:
    """Refit a KDense chain's (shared) basis-grid span onto the inputs
    it actually sees.

    Args:
      chain: KANChain of KDense layers (2 layers for the fused path).
      params: trained parameters.
      x_samples: [N, in_dims] states the RHS visits (e.g. the predicted
        training trajectory).
      q: quantile band of normalized inputs the new span must cover
        (default min/max — rbf values decay outside the span, so
        clipping tails trades tail fidelity for center resolution).
      pad: relative padding added to each side of the measured span.

    Returns (new_chain, new_params, info) with info carrying the old/new
    spans and the per-layer function-preservation error.
    """
    for layer in chain.layers:
        if getattr(layer, "trainable_grid", False):
            # the learned grid_offset/log_h params would be
            # reinterpreted against the new static lims while C was
            # refit without them — silent corruption (measured ~195%
            # output change at ~2e-4 reported refit error)
            raise ValueError(
                "refine_kdense_chain_grid does not support "
                "trainable_grid layers: the adaptive-basis params "
                "already adapt the span during training")

    ca = chain_activations(chain, params, x_samples)

    # 1. measured span of NORMALIZED inputs, pooled over layers (the
    # fused ChainSpec requires one shared grid)
    lo, hi = np.inf, -np.inf
    for layer, x_l in zip(chain.layers, ca.inputs):
        xn = np.asarray(B.get_normalizer(layer.normalizer)(x_l)).ravel()
        ql, qh = np.quantile(xn, q[0]), np.quantile(xn, q[1])
        lo, hi = min(lo, float(ql)), max(hi, float(qh))
    span = max(hi - lo, 1e-6)
    lo, hi = lo - pad * span, hi + pad * span
    new_lims = (float(lo), float(hi))

    # 2. rebuild layers with the refined span (shared h from the span)
    new_layers = [dataclasses.replace(l, grid_lims=new_lims,
                                      denominator=None)
                  for l in chain.layers]
    new_chain = type(chain)(*new_layers)

    # 3. function-preserving lstsq refit of C. Every edge function is
    # 1-D, so the fit targets a DENSE per-dim input grid spanning the
    # observed range (the visited samples alone can be fewer than G —
    # e.g. 5 snapshot rows vs 10 coefficients — which would leave the
    # fit unconstrained between samples). Layers refit SEQUENTIALLY:
    # layer l+1's observed input range comes from the already-refit
    # layer l, so refit error does not compound through the chain.
    M = 96
    new_params = []
    errs = []
    x_cur = x_samples
    for layer, new_layer, p in zip(chain.layers, new_layers, params):
        xi_min = jnp.min(x_cur, axis=0)               # [I]
        xi_max = jnp.max(x_cur, axis=0)
        span_i = jnp.maximum(xi_max - xi_min, 1e-3)
        t = jnp.linspace(-pad, 1.0 + pad, M)[:, None]
        X_dense = xi_min[None, :] + t * span_i[None, :]   # [M, I]

        # f32 precision on every contraction: a reduced-precision
        # default (bf16 / TF32 inputs) loses the 1e-8 ridge and the
        # normal equations go singular (a NaN refit)
        prec = matmul_precision()
        bas_old = layer.basis_values(X_dense, p)      # [M, I, G]
        spline_old = jnp.einsum("nig,igo->nio", bas_old, p["C"],
                                precision=prec)
        bas_new = new_layer.basis_values(X_dense)     # [M, I, G]

        def _fit(bn_i, tgt_i):
            # lightly ridge-regularized normal equations: stable when
            # the new centers overlap (rbf collinearity at small spans)
            A = jnp.matmul(bn_i.T, bn_i, precision=prec) \
                + 1e-8 * jnp.eye(bn_i.shape[1])
            return jnp.linalg.solve(
                A, jnp.matmul(bn_i.T, tgt_i, precision=prec))

        C_new = jax.vmap(_fit, in_axes=(1, 1))(bas_new, spline_old)
        p_new = dict(p)
        p_new["C"] = C_new
        new_params.append(p_new)
        spline_new = jnp.einsum("nig,igo->nio", bas_new, C_new,
                                precision=prec)
        denom = float(jnp.mean(spline_old ** 2)) + 1e-30
        errs.append(float(jnp.mean((spline_new - spline_old) ** 2))
                    / denom)
        x_cur = new_layer.apply(p_new, x_cur)

    info = {"old_lims": tuple(chain.layers[0].grid_lims),
            "new_lims": new_lims,
            "relative_refit_error": errs}
    return new_chain, new_params, info
