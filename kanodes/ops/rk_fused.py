"""Whole-RK-step kernels for KAN-chain neural ODEs (Pallas, Triton route).

One kernel advances a batch of independent states (shooting segments,
ensemble rows, a single trajectory) through every stage of an explicit
RK step over the 2-layer KDense chain; a second kernel runs the step's
discrete adjoint. An RK step built from XLA ops pays several fusions and
small GEMMs per stage; here a step is one launch forward and one
backward, and `fused_rk_multistep` folds a whole fixed-grid solve into
one launch each way.

Layout. The grid runs over power-of-two blocks of `ROW_BLOCK` state rows,
one program per block, in parallel; rows past the batch are masked on
load and store. Every feature width is padded inside the kernel to a
power of two >= 16 (Triton's dot minimum) by masked loads, so the
parameters are read in their natural layout (C1 [I, G, H], W1 [I, H],
C2 [H, G, O], W2 [H, O]) and padded lanes stay exactly zero. A layer
contracts one grid node per turn of a loop (`y += B_g(x) @ C[:, g, :]`),
which keeps the kernel body — and Triton's compile time — independent
of the grid size.

The backward recomputes the stage states (cheaper than storing them at
these sizes) and runs the reverse-RK recursion:
    x_bar     = g ;  kbar_i = dt * b_i * g
    for i = s-1 .. 0:
        dx_i = vjp_chain_x(x_i, kbar_i)
        x_bar += dx_i ;  kbar_j += dt * a_ij * dx_i  (j < i)
The parameter cotangents are deferred to one pass after the sweep,
dC[:, g, :] = sum_i B_g(x_i)^T gy_i for each layer, summed over the rows
of a block; each program writes its partial sums and XLA adds the
blocks.

Replaces: backprop-through-Tsit5 via Zygote (`LV_driver_KANODE.jl:284`)
/ torchdiffeq autograd.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from kanodes.ode.tableaus import Tableau, get_tableau
from kanodes.ops.kan_chain import (BWD_PRECISIONS, FWD_PRECISION,
                                   KERNEL_BACKEND, ChainSpec, basis_du,
                                   basis_val, check_bwd_precision, dnorm,
                                   dot, dot_t0, dot_t1, dswish,
                                   kernel_interpret, masked_load,
                                   masked_store, norm, pow2, swish)

Array = jax.Array

# rows of the state batch per program
ROW_BLOCK = 32
NUM_WARPS = 4

# Chains on which the kernels beat XLA's fusions of the same step grid,
# timed end to end on an H100 (scripts/kernel_vs_xla.py): they won at
# [2,10,2] and [41,10,41] with grid 5 (LV, Burgers) and lost with a wider
# hidden layer ([2,40,2], packed [8,40,8] and [16,80,16]: its padded
# width 64-128 is held per program) and with grid 10 at [41,10,41]
# (Allen-Cahn: twice the grid-node turns). Anything wider is untimed.
MAX_STATE_WIDTH = 64        # padded in_dims / out_dims
MAX_HIDDEN_WIDTH = 16       # padded hidden
MAX_GRID = 5


def kernel_wins(spec: ChainSpec) -> bool:
    """Whether `impl="fused"` runs this chain through the kernels: the
    one width rule of every driver (LV, sweeps, packed ensembles, PDE
    surrogates); the drivers take XLA on the same step grid otherwise."""
    return (max(pow2(spec.in_dims), pow2(spec.out_dims)) <= MAX_STATE_WIDTH
            and pow2(spec.hidden) <= MAX_HIDDEN_WIDTH
            and spec.grid_len <= MAX_GRID)


def compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def _needed_stages(tab: Tableau) -> list[bool]:
    """Stages whose output is consumed (e.g. Tsit5's FSAL 7th stage has
    b = 0 and feeds nothing in fixed-step mode)."""
    s = tab.stages
    needed = [tab.b[i] != 0.0 for i in range(s)]
    changed = True
    while changed:
        changed = False
        for i in range(s):
            if not needed[i]:
                continue
            for j in range(i):
                if tab.a[i][j] != 0.0 and not needed[j]:
                    needed[j] = True
                    changed = True
    return needed


# ---------------------------------------------------------------------------
# generic RK step and its discrete adjoint (traced inside a kernel)
# ---------------------------------------------------------------------------

def rk_stages(f, tab, dt, needed, x):
    """Stage inputs and f-outputs of one step. f(x) -> (k, aux)."""
    ks = [None] * tab.stages
    xs = [None] * tab.stages
    auxs = [None] * tab.stages
    for i in range(tab.stages):
        if not needed[i]:
            continue
        xi = x
        for j in range(i):
            if tab.a[i][j] != 0.0 and ks[j] is not None:
                xi = xi + (dt * tab.a[i][j]) * ks[j]
        xs[i] = xi
        ks[i], auxs[i] = f(xi)
    return ks, xs, auxs


def rk_step(f, tab, dt, needed, x):
    ks, _, _ = rk_stages(f, tab, dt, needed, x)
    y = x
    for i in range(tab.stages):
        if tab.b[i] != 0.0:
            y = y + (dt * tab.b[i]) * ks[i]
    return y


def rk_adjoint(f, f_vjp_x, tab, dt, needed, x, gy):
    """Discrete adjoint of one step at input x with output cotangent gy.

    f_vjp_x(x_i, aux_i, kbar_i) -> (dx_i, saved_i) is the state part of
    the RHS VJP. Returns (dx, stages) with stages the list of
    (x_i, aux_i, kbar_i, saved_i) of every stage that contributes — the
    operands of the deferred parameter cotangents."""
    _, xs, auxs = rk_stages(f, tab, dt, needed, x)
    xbar = gy
    kbar = [None] * tab.stages
    for i in range(tab.stages):
        if needed[i] and tab.b[i] != 0.0:
            kbar[i] = (dt * tab.b[i]) * gy
    stages = []
    for i in range(tab.stages - 1, -1, -1):
        if not needed[i] or kbar[i] is None:
            continue
        dxi, saved = f_vjp_x(xs[i], auxs[i], kbar[i])
        stages.append((xs[i], auxs[i], kbar[i], saved))
        xbar = xbar + dxi
        for j in range(i):
            if tab.a[i][j] != 0.0 and needed[j]:
                contrib = (dt * tab.a[i][j]) * dxi
                kbar[j] = contrib if kbar[j] is None else kbar[j] + contrib
    return xbar, stages


def barrier():
    """Make this program's global-memory writes visible to all of its
    threads (needed between read-modify-writes of an output block); the
    sequential interpreter needs none."""
    if not kernel_interpret():
        plgpu.debug_barrier()


# ---------------------------------------------------------------------------
# the 2-layer chain on padded blocks
# ---------------------------------------------------------------------------

class _Layer(NamedTuple):
    c_ref: object          # [n_in, G, n_out] in device memory
    w: Array               # [n_in_p, n_out_p], loaded once
    n_in: int
    n_out: int
    n_in_p: int
    n_out_p: int

    def c(self, g):
        return masked_load(self.c_ref.at[:, g, :],
                           (self.n_in_p, self.n_out_p),
                           (self.n_in, self.n_out))

    def store_dc(self, ref, g, dc):
        masked_store(ref.at[:, g, :], dc, (self.n_in, self.n_out))

    def add_dc(self, ref, g, dc):
        view = ref.at[:, g, :]
        valid = (self.n_in, self.n_out)
        masked_store(view, masked_load(view, dc.shape, valid) + dc, valid)


def _layer_fwd(spec: ChainSpec, L: _Layer, z_ref, x):
    """x [R, I] -> [R, O]: W^T swish(x) + sum_g B_g(x) C[:, g, :]."""
    xn = norm(x, spec.normalizer)
    inv_h = 1.0 / spec.h

    def body(g, y):
        b = basis_val((xn - z_ref[0, g]) * inv_h, spec.basis)
        return y + dot(b, L.c(g), FWD_PRECISION)

    return jax.lax.fori_loop(0, spec.grid_len, body,
                             dot(swish(x), L.w, FWD_PRECISION))


def _layer_vjp_x(spec: ChainSpec, L: _Layer, z_ref, x, gy, prec):
    """State part of the layer VJP: d(layer)/dx^T gy."""
    xn = norm(x, spec.normalizer)
    inv_h = 1.0 / spec.h

    def body(g, dxn):
        u = (xn - z_ref[0, g]) * inv_h
        b = basis_val(u, spec.basis)
        return dxn + dot_t1(gy, L.c(g), prec) * basis_du(u, b, spec.basis)

    dxn = jax.lax.fori_loop(0, spec.grid_len, body, jnp.zeros_like(x))
    return dxn * (inv_h * dnorm(x, spec.normalizer)) \
        + dot_t1(gy, L.w, prec) * dswish(x)


def _layer_param_grads(spec: ChainSpec, z_ref, xs, gys, prec, emit_dc):
    """Parameter cotangents of one layer from its inputs xs and output
    cotangents gys over the stages: emit_dc(g, dC[:, g, :]) per grid
    node; returns dW."""
    xns = [norm(x, spec.normalizer) for x in xs]
    inv_h = 1.0 / spec.h

    def body(g, carry):
        dc = None
        for xn, gy in zip(xns, gys):
            b = basis_val((xn - z_ref[0, g]) * inv_h, spec.basis)
            t = dot_t0(b, gy, prec)
            dc = t if dc is None else dc + t
        emit_dc(g, dc)
        return carry

    jax.lax.fori_loop(0, spec.grid_len, body, 0)
    dw = None
    for x, gy in zip(xs, gys):
        t = dot_t0(swish(x), gy, prec)
        dw = t if dw is None else dw + t
    return dw


def _chain_fns(spec, layers, z_ref, prec_bwd):
    l1, l2 = layers

    def f(x):
        y1 = _layer_fwd(spec, l1, z_ref, x)
        return _layer_fwd(spec, l2, z_ref, y1), y1

    def f_vjp_x(x, y1, g):
        dy1 = _layer_vjp_x(spec, l2, z_ref, y1, g, prec_bwd)
        return _layer_vjp_x(spec, l1, z_ref, x, dy1, prec_bwd), dy1

    return f, f_vjp_x


def _param_pass(spec, z_ref, stages, prec, emit1, emit2):
    """(dW1, dW2) of one step's stages; dC via emit1/emit2(g, dC_g)."""
    xs, y1s, kbars, dy1s = (list(t) for t in zip(*stages))
    dw1 = _layer_param_grads(spec, z_ref, xs, dy1s, prec, emit1)
    dw2 = _layer_param_grads(spec, z_ref, y1s, kbars, prec, emit2)
    return dw1, dw2


class _Blocks:
    """Padded sizes of one call: rows per program and feature widths."""

    def __init__(self, spec: ChainSpec, n_rows: int):
        self.K = n_rows
        self.bk = min(pow2(n_rows), pow2(ROW_BLOCK))
        self.nb = -(-n_rows // self.bk)
        self.I, self.H, self.O = spec.in_dims, spec.hidden, spec.out_dims
        self.G = spec.grid_len
        self.Ip, self.Hp, self.Op = pow2(self.I), pow2(self.H), pow2(self.O)

    def rows_valid(self):
        """(valid rows, valid columns) of this program's state block.
        Read at the kernel's top level: the interpreter resolves
        program_id only there, not inside loop bodies."""
        return self.K - pl.program_id(0) * self.bk, self.I

    def load_rows(self, ref, valid):
        return masked_load(ref, (self.bk, self.Ip), valid)

    def layers(self, c1_ref, w1_ref, c2_ref, w2_ref):
        w1 = masked_load(w1_ref, (self.Ip, self.Hp), (self.I, self.H))
        w2 = masked_load(w2_ref, (self.Hp, self.Op), (self.H, self.O))
        return (_Layer(c1_ref, w1, self.I, self.H, self.Ip, self.Hp),
                _Layer(c2_ref, w2, self.H, self.O, self.Hp, self.Op))

    # BlockSpecs -------------------------------------------------------------
    def rows_spec(self):
        return pl.BlockSpec((self.bk, self.Ip), lambda i: (i, 0))

    def steps_spec(self, n_steps):
        return pl.BlockSpec((n_steps, self.bk, self.Ip), lambda i: (0, i, 0))

    def param_specs(self):
        return [pl.BlockSpec((self.Ip, self.G, self.Hp), lambda i: (0, 0, 0)),
                pl.BlockSpec((self.Ip, self.Hp), lambda i: (0, 0)),
                pl.BlockSpec((self.Hp, self.G, self.Op), lambda i: (0, 0, 0)),
                pl.BlockSpec((self.Hp, self.Op), lambda i: (0, 0)),
                pl.BlockSpec((1, self.G), lambda i: (0, 0))]

    def grad_specs(self):
        return [pl.BlockSpec((None, self.Ip, self.G, self.Hp),
                             lambda i: (i, 0, 0, 0)),
                pl.BlockSpec((None, self.Ip, self.Hp), lambda i: (i, 0, 0)),
                pl.BlockSpec((None, self.Hp, self.G, self.Op),
                             lambda i: (i, 0, 0, 0)),
                pl.BlockSpec((None, self.Hp, self.Op), lambda i: (i, 0, 0))]

    def grad_shapes(self, c1, w1, c2, w2):
        return [jax.ShapeDtypeStruct((self.nb,) + a.shape, jnp.float32)
                for a in (c1, w1, c2, w2)]


def _centers(spec: ChainSpec):
    return jnp.asarray(np.asarray(spec.centers, np.float32)[None, :])


def _sum_blocks(dparts):
    return tuple(jnp.sum(d, axis=0) for d in dparts)


# ---------------------------------------------------------------------------
# single-step kernels
# ---------------------------------------------------------------------------

def _step_fwd_kernel(spec, tab, dt, blk, x_ref, c1_ref, w1_ref, c2_ref,
                     w2_ref, z_ref, y_ref):
    valid = blk.rows_valid()
    layers = blk.layers(c1_ref, w1_ref, c2_ref, w2_ref)
    f, _ = _chain_fns(spec, layers, z_ref, None)
    masked_store(y_ref, rk_step(f, tab, dt, _needed_stages(tab),
                                blk.load_rows(x_ref, valid)), valid)


def _step_bwd_kernel(spec, tab, dt, blk, prec, x_ref, c1_ref, w1_ref,
                     c2_ref, w2_ref, z_ref, gy_ref, dx_ref, dc1_ref,
                     dw1_ref, dc2_ref, dw2_ref):
    valid = blk.rows_valid()
    l1, l2 = blk.layers(c1_ref, w1_ref, c2_ref, w2_ref)
    f, f_vjp_x = _chain_fns(spec, (l1, l2), z_ref, prec)
    dx, stages = rk_adjoint(f, f_vjp_x, tab, dt, _needed_stages(tab),
                            blk.load_rows(x_ref, valid),
                            blk.load_rows(gy_ref, valid))
    masked_store(dx_ref, dx, valid)
    dw1, dw2 = _param_pass(spec, z_ref, stages, prec,
                           partial(l1.store_dc, dc1_ref),
                           partial(l2.store_dc, dc2_ref))
    masked_store(dw1_ref, dw1, (l1.n_in, l1.n_out))
    masked_store(dw2_ref, dw2, (l2.n_in, l2.n_out))


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 8))
def fused_rk_step(spec: ChainSpec, solver: str, dt: float,
                  x, c1, w1, c2, w2, bwd_precision: str = "highest"):
    """One whole RK step y = x + dt*sum(b_i k_i) as ONE kernel launch.

    x: [K, I] batch of states; c1, w1, c2, w2: `fused_params` layout;
    solver: fixed-step tableau name; dt: static step size.
    Differentiable w.r.t. x and all params via the one-kernel discrete
    adjoint. bwd_precision: "highest" | "tf32" (backward dots only).
    """
    check_bwd_precision(bwd_precision)
    tab = get_tableau(solver)
    blk = _Blocks(spec, x.shape[0])
    return pl.pallas_call(
        partial(_step_fwd_kernel, spec, tab, dt, blk),
        grid=(blk.nb,),
        in_specs=[blk.rows_spec()] + blk.param_specs(),
        out_specs=blk.rows_spec(),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        backend=KERNEL_BACKEND, compiler_params=compiler_params(),
        interpret=kernel_interpret(), name="kan_rk_step",
    )(x, c1, w1, c2, w2, _centers(spec))


def _frs_fwd(spec, solver, dt, x, c1, w1, c2, w2, bwd_precision):
    y = fused_rk_step(spec, solver, dt, x, c1, w1, c2, w2, bwd_precision)
    return y, (x, c1, w1, c2, w2)


def _frs_bwd(spec, solver, dt, bwd_precision, res, gy):
    x, c1, w1, c2, w2 = res
    tab = get_tableau(solver)
    blk = _Blocks(spec, x.shape[0])
    dx, *dparts = pl.pallas_call(
        partial(_step_bwd_kernel, spec, tab, dt, blk,
                BWD_PRECISIONS[bwd_precision]),
        grid=(blk.nb,),
        in_specs=[blk.rows_spec()] + blk.param_specs() + [blk.rows_spec()],
        out_specs=[blk.rows_spec()] + blk.grad_specs(),
        out_shape=[jax.ShapeDtypeStruct(x.shape, jnp.float32)]
        + blk.grad_shapes(c1, w1, c2, w2),
        backend=KERNEL_BACKEND, compiler_params=compiler_params(),
        interpret=kernel_interpret(), name="kan_rk_step_bwd",
    )(x, c1, w1, c2, w2, _centers(spec), gy)
    return (dx,) + _sum_blocks(dparts)


fused_rk_step.defvjp(_frs_fwd, _frs_bwd)


def fused_odeint(spec: ChainSpec, solver: str, dt: float, n_steps: int,
                 x0, c1, w1, c2, w2, *, save_every: int = 1):
    """Fixed-grid solve as a scan of whole-step kernels.

    Returns [n_steps//save_every + 1, K, I] including x0.
    """
    def body(x, _):
        y = fused_rk_step(spec, solver, dt, x, c1, w1, c2, w2)
        return y, y

    _, ys = jax.lax.scan(body, x0, None, length=n_steps)
    ys = jnp.concatenate([x0[None], ys], axis=0)
    if save_every != 1:
        ys = ys[::save_every]
    return ys


# ---------------------------------------------------------------------------
# multi-step kernels: n whole RK steps per launch
# ---------------------------------------------------------------------------

def _multistep_fwd_kernel(spec, tab, dt, n_steps, blk, x_ref, c1_ref,
                          w1_ref, c2_ref, w2_ref, z_ref, ys_ref):
    """Advance n_steps whole RK steps in a loop inside the block, writing
    every post-step state to ys [n_steps, K, I]."""
    valid = blk.rows_valid()
    f, _ = _chain_fns(spec, blk.layers(c1_ref, w1_ref, c2_ref, w2_ref),
                      z_ref, None)
    needed = _needed_stages(tab)

    def body(s, x):
        y = rk_step(f, tab, dt, needed, x)
        masked_store(ys_ref.at[s], y, valid)
        return y

    jax.lax.fori_loop(0, n_steps, body, blk.load_rows(x_ref, valid))


def _multistep_bwd_kernel(spec, tab, dt, n_steps, blk, prec, x0_ref,
                          ys_ref, c1_ref, w1_ref, c2_ref, w2_ref, z_ref,
                          gys_ref, dx_ref, dc1_ref, dw1_ref, dc2_ref,
                          dw2_ref):
    """Reverse sweep over the stored states, one step per loop turn:
    rebuild the step's stages from its INPUT state (recompute; nothing
    but the post-step states is stored) and run its discrete adjoint,
    folding in the cotangent gys[s] of every saved state. dC accumulates
    in this program's output block, dW in registers."""
    valid = blk.rows_valid()
    l1, l2 = blk.layers(c1_ref, w1_ref, c2_ref, w2_ref)
    f, f_vjp_x = _chain_fns(spec, (l1, l2), z_ref, prec)
    needed = _needed_stages(tab)
    x0 = blk.load_rows(x0_ref, valid)

    def zero(g, carry):
        l1.store_dc(dc1_ref, g, jnp.zeros((l1.n_in_p, l1.n_out_p)))
        l2.store_dc(dc2_ref, g, jnp.zeros((l2.n_in_p, l2.n_out_p)))
        return carry

    jax.lax.fori_loop(0, spec.grid_len, zero, 0)
    barrier()

    def body(r, carry):
        xbar, dw1, dw2 = carry
        s = n_steps - 1 - r
        x_in = jnp.where(s == 0, x0, blk.load_rows(
            ys_ref.at[jnp.maximum(s - 1, 0)], valid))
        xbar = xbar + blk.load_rows(gys_ref.at[s], valid)
        xbar, stages = rk_adjoint(f, f_vjp_x, tab, dt, needed, x_in, xbar)
        d1, d2 = _param_pass(spec, z_ref, stages, prec,
                             partial(l1.add_dc, dc1_ref),
                             partial(l2.add_dc, dc2_ref))
        barrier()
        return xbar, dw1 + d1, dw2 + d2

    dx, dw1, dw2 = jax.lax.fori_loop(
        0, n_steps, body, (jnp.zeros_like(x0), jnp.zeros_like(l1.w),
                           jnp.zeros_like(l2.w)))
    masked_store(dx_ref, dx, valid)
    masked_store(dw1_ref, dw1, (l1.n_in, l1.n_out))
    masked_store(dw2_ref, dw2, (l2.n_in, l2.n_out))


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 9))
def fused_rk_multistep(spec: ChainSpec, solver: str, dt: float,
                       n_steps: int, x0, c1, w1, c2, w2,
                       bwd_precision: str = "highest"):
    """n_steps whole RK steps in ONE kernel launch; returns the full
    post-step state history ys [n_steps, K, I] (x0 NOT included).

    The backward pass is a second single kernel that sweeps the stored
    states in reverse, accepting cotangents for EVERY saved state — so a
    trajectory loss over all save points costs exactly two launches."""
    check_bwd_precision(bwd_precision)
    tab = get_tableau(solver)
    blk = _Blocks(spec, x0.shape[0])
    return pl.pallas_call(
        partial(_multistep_fwd_kernel, spec, tab, dt, n_steps, blk),
        grid=(blk.nb,),
        in_specs=[blk.rows_spec()] + blk.param_specs(),
        out_specs=blk.steps_spec(n_steps),
        out_shape=jax.ShapeDtypeStruct((n_steps,) + x0.shape, jnp.float32),
        backend=KERNEL_BACKEND, compiler_params=compiler_params(),
        interpret=kernel_interpret(), name="kan_rk_multistep",
    )(x0, c1, w1, c2, w2, _centers(spec))


def _frm_fwd(spec, solver, dt, n_steps, x0, c1, w1, c2, w2, bwd_precision):
    ys = fused_rk_multistep(spec, solver, dt, n_steps, x0, c1, w1, c2, w2,
                            bwd_precision)
    return ys, (x0, ys, c1, w1, c2, w2)


def _frm_bwd(spec, solver, dt, n_steps, bwd_precision, res, gys):
    x0, ys, c1, w1, c2, w2 = res
    tab = get_tableau(solver)
    blk = _Blocks(spec, x0.shape[0])
    dx, *dparts = pl.pallas_call(
        partial(_multistep_bwd_kernel, spec, tab, dt, n_steps, blk,
                BWD_PRECISIONS[bwd_precision]),
        grid=(blk.nb,),
        in_specs=[blk.rows_spec(), blk.steps_spec(n_steps)]
        + blk.param_specs() + [blk.steps_spec(n_steps)],
        out_specs=[blk.rows_spec()] + blk.grad_specs(),
        out_shape=[jax.ShapeDtypeStruct(x0.shape, jnp.float32)]
        + blk.grad_shapes(c1, w1, c2, w2),
        backend=KERNEL_BACKEND, compiler_params=compiler_params(),
        interpret=kernel_interpret(), name="kan_rk_multistep_bwd",
    )(x0, ys, c1, w1, c2, w2, _centers(spec), gys)
    return (dx,) + _sum_blocks(dparts)


fused_rk_multistep.defvjp(_frm_fwd, _frm_bwd)
