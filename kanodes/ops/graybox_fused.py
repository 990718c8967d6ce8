"""Whole-RK-step kernels for gray-box (hidden-physics) RHSs (Pallas,
Triton route).

The source-recovery experiments integrate
    du/dt = D * (lap @ u) + phi(u),     phi = pointwise 1->1 KDense
(`Fisher-KPP_Source.jl:95-98`) over 11-101 save points per loss. At
26-41 grid nodes every stage is a tiny product plus a handful of
elementwise ops, so an XLA step pays about two launches per stage. This
kernel runs ALL RK stages of a step in one launch; since the KAN is
1->1 its grid dimension is a loop of G scalar-coefficient elementwise
ops — no basis reshape:

    phi(u) = sum_g C[g] * exp(-((norm(u) - z_g)/h)^2) + W * swish(u)

The backward kernel runs the step's discrete adjoint (dC, dW, du); the
known operator's D and lap are static physics, not trained. Spatial
dimensions are padded to powers of two >= 16 by masked loads, and the
padded lanes of every stage are zeroed so they never feed the real ones.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from kanodes.ode.tableaus import get_tableau
from kanodes.ops.kan_chain import (BWD_PRECISIONS, FWD_PRECISION,
                                   KERNEL_BACKEND, check_bwd_precision,
                                   dnorm, dot, dot_t1, dswish,
                                   kernel_interpret, masked_load,
                                   masked_store, norm, pow2, swish)
from kanodes.ops.rk_fused import (ROW_BLOCK, _needed_stages,
                                  compiler_params, rk_adjoint, rk_step)

Array = jax.Array


class GrayboxSpec:
    """Static config: 1->1 KDense (rbf) + symmetric dense operator."""

    def __init__(self, grid_len: int, normalizer: str = "softsign",
                 grid_lims=(-1.0, 1.0), denominator=None):
        self.G = grid_len
        self.normalizer = normalizer
        self.lims = grid_lims
        self.h = denominator if denominator is not None else \
            (grid_lims[1] - grid_lims[0]) / (grid_len - 1)

    @classmethod
    def of_layer(cls, layer) -> "GrayboxSpec":
        if (layer.in_dims, layer.out_dims) != (1, 1) or \
                layer.basis != "rbf" or not layer.use_base_act:
            raise ValueError("graybox kernel needs a 1->1 rbf KDense")
        return cls(layer.grid_len, layer.normalizer,
                   tuple(float(v) for v in layer.grid_lims),
                   layer.denominator)


def _sum_all(a):
    # the Triton lowering reduces one axis per op
    return jnp.sum(jnp.sum(a, axis=1), axis=0)


def _basis(spec, un, g):
    """(z_g, B_g) at grid node g (a traced loop index) of normalized u."""
    z = (un - spec.lims[0] - g * ((spec.lims[1] - spec.lims[0])
                                  / (spec.G - 1))) * (1.0 / spec.h)
    return z, jnp.exp(-(z * z))


def _phi(spec, u, c_ref, w):
    """Pointwise KAN on u [R, N]: C[g] from the [1, G] ref, w scalar."""
    un = norm(u, spec.normalizer)

    def body(g, y):
        return y + c_ref[0, g] * _basis(spec, un, g)[1]

    return jax.lax.fori_loop(0, spec.G, body, w * swish(u))


def _phi_vjp_x(spec, u, c_ref, w, gy):
    """State part of the phi VJP."""
    un = norm(u, spec.normalizer)

    def body(g, dun):
        z, b = _basis(spec, un, g)
        return dun + c_ref[0, g] * (-2.0 / spec.h) * z * b

    dun = jax.lax.fori_loop(0, spec.G, body, jnp.zeros_like(u))
    return gy * (dun * dnorm(u, spec.normalizer) + w * dswish(u))


def _known(D, u, lap, kron, prec):
    """The known linear operator. kron=False: u [R, N] row states, one
    [N, N] dense product. kron=True: u is the 2-D field U [n, n] and lap
    the 1-D [n, n] operator L; the Kronecker-sum Laplacian (I (+) L)
    factors as L@U + U@L^T — two [n, n] products instead of an
    n^2 x n^2 matrix (L symmetric here, so L^T = L). Self-adjoint in
    both modes, so the VJP reuses it."""
    if kron:
        return D * (dot(lap, u, prec) + dot_t1(u, lap, prec))
    return D * dot_t1(u, lap, prec)


def _rhs_fns(spec, D, lap, c_ref, w, kron, valid, prec_bwd):
    def f(u):
        k = _known(D, u, lap, kron, FWD_PRECISION) + _phi(spec, u, c_ref, w)
        return valid(k), None

    def f_vjp_x(u, _, g):
        du = _known(D, g, lap, kron, prec_bwd) + \
            _phi_vjp_x(spec, u, c_ref, w, g)
        return valid(du), None

    return f, f_vjp_x


class _Blocks:
    """kron=False: rows of [K, N] states over a grid of row blocks.
    kron=True: one program holds the whole [n, n] field."""

    def __init__(self, spec, shape, kron):
        self.R, self.N = shape
        self.G = spec.G
        self.Np = pow2(self.N)
        self.kron = kron
        self.bk = pow2(self.R) if kron else min(pow2(self.R),
                                                 pow2(ROW_BLOCK))
        self.nb = -(-self.R // self.bk)

    def rows_valid(self):
        return self.R - pl.program_id(0) * self.bk, self.N

    def masker(self, valid):
        """Zeroes the padded lanes of a state block."""
        r, c = valid
        m = (jnp.arange(self.bk) < r)[:, None] & \
            (jnp.arange(self.Np) < c)[None, :]
        return lambda val: jnp.where(m, val, 0.0)

    def load_state(self, ref, valid):
        return masked_load(ref, (self.bk, self.Np), valid)

    def state_spec(self):
        return pl.BlockSpec((self.bk, self.Np), lambda i: (i, 0))

    def lap_spec(self):
        n = self.bk if self.kron else self.Np
        return pl.BlockSpec((n, self.Np), lambda i: (0, 0))

    def load_lap(self, lap_ref):
        n = self.R if self.kron else self.N
        n_p = self.bk if self.kron else self.Np
        return masked_load(lap_ref, (n_p, self.Np), (n, self.N))

    def kan_specs(self):
        return [pl.BlockSpec((1, self.G), lambda i: (0, 0)),
                pl.BlockSpec((1, 1), lambda i: (0, 0))]


def _gb_fwd_kernel(spec, tab, dt, D, blk, u_ref, lap_ref, c_ref, w_ref,
                   y_ref):
    valid = blk.rows_valid()
    f, _ = _rhs_fns(spec, D, blk.load_lap(lap_ref), c_ref, w_ref[0, 0],
                    blk.kron, blk.masker(valid), None)
    masked_store(y_ref, rk_step(f, tab, dt, _needed_stages(tab),
                                blk.load_state(u_ref, valid)), valid)


def _gb_bwd_kernel(spec, tab, dt, D, blk, prec, u_ref, lap_ref, c_ref,
                   w_ref, gy_ref, du_ref, dc_ref, dw_ref):
    valid = blk.rows_valid()
    f, f_vjp_x = _rhs_fns(spec, D, blk.load_lap(lap_ref), c_ref,
                          w_ref[0, 0], blk.kron, blk.masker(valid), prec)
    du, stages = rk_adjoint(f, f_vjp_x, tab, dt, _needed_stages(tab),
                            blk.load_state(u_ref, valid),
                            blk.load_state(gy_ref, valid))
    masked_store(du_ref, du, valid)
    # deferred parameter cotangents: sum over the stages of
    # kbar_i * dphi/dtheta(u_i)
    uns = [norm(s[0], spec.normalizer) for s in stages]

    def body(g, carry):
        dc = None
        for un, (_, _, kbar, _) in zip(uns, stages):
            t = _sum_all(kbar * _basis(spec, un, g)[1])
            dc = t if dc is None else dc + t
        dc_ref[0, g] = dc
        return carry

    jax.lax.fori_loop(0, spec.G, body, 0)
    dw = None
    for u, _, kbar, _ in stages:
        t = _sum_all(kbar * swish(u))
        dw = t if dw is None else dw + t
    dw_ref[0, 0] = dw


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 8, 9))
def fused_graybox_rk_step(spec: GrayboxSpec, solver: str, dt: float,
                          D: float, u, lap, c, w,
                          bwd_precision: str = "highest",
                          kron: bool = False):
    """One whole RK step of du/dt = D*lap@u + phi(u) as ONE kernel.

    u: [K, N]; lap: [N, N] SYMMETRIC dense operator; c: [1, G] KAN
    spline coefficients; w: [1, 1] residual weight. kron=True instead
    takes the 2-D field u=[n, n] with lap=[n, n] the 1-D operator and
    applies the Kronecker-sum Laplacian as L@U + U@L (see `_known`).
    Differentiable w.r.t. u, c, w (D and lap are known physics).
    bwd_precision: "highest" | "tf32" (backward dots only).
    """
    check_bwd_precision(bwd_precision)
    tab = get_tableau(solver)
    blk = _Blocks(spec, u.shape, kron)
    return pl.pallas_call(
        partial(_gb_fwd_kernel, spec, tab, dt, D, blk),
        grid=(blk.nb,),
        in_specs=[blk.state_spec(), blk.lap_spec()] + blk.kan_specs(),
        out_specs=blk.state_spec(),
        out_shape=jax.ShapeDtypeStruct(u.shape, jnp.float32),
        backend=KERNEL_BACKEND, compiler_params=compiler_params(),
        interpret=kernel_interpret(), name="graybox_rk_step",
    )(u, lap, c, w)


def _fgb_fwd(spec, solver, dt, D, u, lap, c, w, bwd_precision, kron):
    y = fused_graybox_rk_step(spec, solver, dt, D, u, lap, c, w,
                              bwd_precision, kron)
    return y, (u, lap, c, w)


def _fgb_bwd(spec, solver, dt, D, bwd_precision, kron, res, gy):
    u, lap, c, w = res
    tab = get_tableau(solver)
    blk = _Blocks(spec, u.shape, kron)
    du, dc, dw = pl.pallas_call(
        partial(_gb_bwd_kernel, spec, tab, dt, D, blk,
                BWD_PRECISIONS[bwd_precision]),
        grid=(blk.nb,),
        in_specs=[blk.state_spec(), blk.lap_spec()] + blk.kan_specs()
        + [blk.state_spec()],
        out_specs=[blk.state_spec(),
                   pl.BlockSpec((1, blk.G), lambda i: (i, 0)),
                   pl.BlockSpec((1, 1), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct(u.shape, jnp.float32),
                   jax.ShapeDtypeStruct((blk.nb, blk.G), jnp.float32),
                   jax.ShapeDtypeStruct((blk.nb, 1), jnp.float32)],
        backend=KERNEL_BACKEND, compiler_params=compiler_params(),
        interpret=kernel_interpret(), name="graybox_rk_step_bwd",
    )(u, lap, c, w, gy)
    return (du, jnp.zeros_like(lap), jnp.sum(dc, axis=0, keepdims=True),
            jnp.sum(dw, axis=0, keepdims=True))


fused_graybox_rk_step.defvjp(_fgb_fwd, _fgb_bwd)


def graybox_kernel_adapter(layer, lap: Array, D: float,
                           bwd_precision: str = "highest"):
    """Build advance(params, u [N], dt, n_steps) -> [n_steps+1, N] for a
    1->1 KDense gray-box RHS; params is the layer's {C, W} dict."""
    spec = GrayboxSpec.of_layer(layer)
    lap = jnp.asarray(lap, jnp.float32)

    def advance(params, u, dt, n_steps):
        c = params["C"].reshape(1, spec.G)
        w = params["W"].reshape(1, 1)
        x = u[None, :]

        def body(carr, _):
            y = fused_graybox_rk_step(spec, "tsit5", dt, D, carr, lap,
                                      c, w, bwd_precision)
            return y, y

        _, ys = jax.lax.scan(body, x, None, length=n_steps)
        return jnp.concatenate([x[None], ys], axis=0)[:, 0, :]

    return spec, advance


def graybox_kron_kernel_adapter(layer, lap1: Array, D: float,
                                bwd_precision: str = "highest"):
    """Build advance(params, U [n, n], dt, n_steps) -> [n_steps+1, n, n]
    for the 2-D gray-box RHS D*lap2d(U) + phi.(U), with the Kronecker-sum
    Laplacian factored inside the kernel as L@U + U@L (`_known`): one
    [n, n] operator where the flattened dense form is [n^2, n^2]."""
    spec = GrayboxSpec.of_layer(layer)
    lap1 = jnp.asarray(lap1, jnp.float32)

    def advance(params, U, dt, n_steps):
        c = params["C"].reshape(1, spec.G)
        w = params["W"].reshape(1, 1)

        def body(carr, _):
            y = fused_graybox_rk_step(spec, "tsit5", dt, D, carr, lap1,
                                      c, w, bwd_precision, True)
            return y, y

        _, ys = jax.lax.scan(body, U, None, length=n_steps)
        return jnp.concatenate([U[None], ys], axis=0)

    return spec, advance
