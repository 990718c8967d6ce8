"""Implicit (stiff-capable) integration: ESDIRK with controlled Newton.

The reference generates stiff truth data with Rosenbrock23 / Rodas5
(`Allen-Cahn_Surrogate.jl:63`, `Schrodinger_Surrogate.jl:69`). The
framework's primary data path is host-side fine-step RK4 in float64
(`pde/datagen.py`), but a real implicit solver is part of the solver
family: Kvaerno3 — a 4-stage, 3rd-order, stiffly-accurate L-stable
ESDIRK pair — with a dense-Jacobian modified-Newton inner loop
(`jax.jacfwd`; the systems here are <= O(400) wide, so each stage is a
single LU factor + a few triangular solves).

Robustness controls (round-2 hardening):
  * Newton iterations carry a residual-based convergence mask — once
    the relative update norm drops below `newton_tol` further sweeps
    are no-ops (differentiable early exit), and the convergence flag is
    surfaced so the adaptive controller can reject non-converged steps.
  * The step exposes Kvaerno's embedded 2nd-order error estimate
    (stage-3 weights; the pair is stiffly accurate so it costs nothing).
  * `odeint_implicit(..., adaptive=True)` runs a PI-controlled
    `lax.while_loop` with save-point clipping — steps are sized by the
    embedded error and halved on Newton failure. Non-differentiable
    (datagen role); the fixed-grid path stays a differentiable scan.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax

from kanodes.ode.integrate import StepController, error_norm


Array = jax.Array

# Kvaerno (2004) 3/2 ESDIRK tableau; gamma = 0.4358665215084590.
# Stiffly accurate: b == A[3]; the 3rd stage (c=1) is the embedded
# 2nd-order solution, so b_err = b - A[2] (padded with -gamma at i=3).
_G = 0.4358665215084590
KV3_A = (
    (0.0,),
    (_G, _G),
    (0.490563388419108, 0.073570090080892, _G),
    (0.308809969973036, 1.490563388254106, -1.235239879727145, _G),
)
KV3_B = (0.308809969973036, 1.490563388254106, -1.235239879727145, _G)
KV3_B_ERR = tuple(b - a for b, a in zip(KV3_B, KV3_A[2] + (0.0,)))
KV3_C = (0.0, 2 * _G, 1.0, 1.0)
KV3_ORDER = 3


def _newton_solve(f, t, y0, rhs_const, gamma_dt, newton_iters: int,
                  newton_tol: float):
    """Solve y = rhs_const + gamma_dt * f(t, y) by modified Newton (one
    Jacobian/LU per stage, evaluated at the predictor `y0`).

    Returns (y, converged). Iterations after the relative update norm
    drops below `newton_tol` are masked no-ops, so `newton_iters` is an
    upper bound, not a fixed cost — and the whole solve stays a
    differentiable `lax.scan`.
    """
    n = y0.shape[0]
    J = jax.jacfwd(lambda y: f(t, y))(y0)            # [N, N]
    A = jnp.eye(n, dtype=y0.dtype) - gamma_dt * J
    lu, piv = jax.scipy.linalg.lu_factor(A)
    # the requested tol can't undercut the dtype's resolution
    tol = max(newton_tol, 100.0 * float(jnp.finfo(y0.dtype).eps))

    def body(carry, _):
        y, done = carry
        g = y - rhs_const - gamma_dt * f(t, y)
        dy = jax.scipy.linalg.lu_solve((lu, piv), g)
        y_new = jnp.where(done, y, y - dy)
        rel = jnp.linalg.norm(dy) / (jnp.linalg.norm(y_new) + 1e-300)
        return (y_new, done | (rel < tol)), rel

    (y, settled), _ = lax.scan(body, (y0, jnp.asarray(False)), None,
                               length=newton_iters)
    # a small update under a frozen (possibly huge) Jacobian does not
    # imply a small residual — verify the stage equation itself
    g = y - rhs_const - gamma_dt * f(t, y)
    scale = (jnp.linalg.norm(y) + jnp.linalg.norm(rhs_const)
             + jnp.abs(gamma_dt) * jnp.linalg.norm(f(t, y)) + 1e-300)
    converged = settled & (jnp.linalg.norm(g) <= 10.0 * tol * scale)
    return y, converged


def kvaerno3_step(f, t, y, dt, args, newton_iters: int = 8,
                  newton_tol: float = 1e-9):
    """One Kvaerno3 ESDIRK step (flat-array state).

    Returns (y1, err, converged): the 3rd-order solution, the embedded
    2nd-order error estimate, and whether every stage's Newton solve
    converged.
    """
    def fa(ti, yi):
        return f(ti, yi, args)

    k = [None] * 4
    k[0] = fa(t, y)
    converged = jnp.asarray(True)
    for i in (1, 2, 3):
        # stage equation: yi = y + dt sum_{j<i} a_ij k_j + dt*gamma*f(ti, yi)
        acc = y
        for j in range(i):
            if KV3_A[i][j] != 0.0:
                acc = acc + dt * KV3_A[i][j] * k[j]
        ti = t + KV3_C[i] * dt
        yi, conv_i = _newton_solve(fa, ti, acc, acc, dt * _G,
                                   newton_iters, newton_tol)
        converged = converged & conv_i
        k[i] = fa(ti, yi)
    y1 = y
    err = jnp.zeros_like(y)
    for i in range(4):
        if KV3_B[i] != 0.0:
            y1 = y1 + dt * KV3_B[i] * k[i]
        if KV3_B_ERR[i] != 0.0:
            err = err + dt * KV3_B_ERR[i] * k[i]
    return y1, err, converged


def _implicit_adaptive(f, y0, ts, args, rtol, atol, newton_iters,
                       newton_tol, max_steps, ctrl: StepController):
    """PI-controlled adaptive Kvaerno3 over save grid `ts` (forward
    time), clipping accepted steps onto save points. while_loop — not
    differentiable; for truth-data generation and validation."""
    T = ts.shape[0]
    ys0 = jnp.zeros((T,) + y0.shape, y0.dtype).at[0].set(y0)
    state = {
        "t": ts[0], "y": y0, "dt": ts[1] - ts[0],
        "save_idx": jnp.asarray(1, jnp.int32), "ys": ys0,
        "done": jnp.asarray(T <= 1),
        "err_prev": jnp.asarray(1.0, y0.dtype),
        "n_iter": jnp.asarray(0, jnp.int32),
        "n_reject": jnp.asarray(0, jnp.int32),
    }

    def cond(s):
        return (~s["done"]) & (s["n_iter"] < max_steps)

    def body(s):
        t_save = ts[jnp.minimum(s["save_idx"], T - 1)]
        remaining = t_save - s["t"]
        hit = s["dt"] >= remaining
        dt_used = jnp.where(hit, remaining, s["dt"])
        y1, err, conv = kvaerno3_step(f, s["t"], s["y"], dt_used, args,
                                      newton_iters, newton_tol)
        enrm = error_norm(err, s["y"], y1, rtol, atol)
        accept = (enrm <= 1.0) & conv
        # Newton failure: halve; otherwise standard controller factor
        fac = jnp.where(conv, ctrl.factor(enrm, KV3_ORDER, s["err_prev"]),
                        0.5)
        dt_next = jnp.maximum(dt_used * fac, ctrl.dt_min)
        accept = accept | (dt_used <= ctrl.dt_min)

        t_new = jnp.where(accept, jnp.where(hit, t_save, s["t"] + dt_used),
                          s["t"])
        y_new = jnp.where(accept, y1, s["y"])
        saved = accept & hit
        old = lax.dynamic_index_in_dim(s["ys"], s["save_idx"], 0,
                                       keepdims=False)
        ys_new = lax.dynamic_update_index_in_dim(
            s["ys"], jnp.where(saved, y1, old), s["save_idx"], 0)
        save_idx = s["save_idx"] + saved.astype(jnp.int32)
        return {
            "t": t_new, "y": y_new, "dt": dt_next,
            "save_idx": save_idx, "ys": ys_new,
            "done": save_idx >= T,
            "err_prev": jnp.where(accept, jnp.maximum(enrm, 1e-12),
                                  s["err_prev"]),
            "n_iter": s["n_iter"] + 1,
            "n_reject": s["n_reject"] + (~accept).astype(jnp.int32),
        }

    st = lax.while_loop(cond, body, state)
    return st


def odeint_implicit(f, y0: Array, ts: Array, args=None, *,
                    substeps: int = 1, newton_iters: int = 8,
                    newton_tol: float = 1e-9,
                    adaptive: bool = False,
                    rtol: float = 1e-6, atol: float = 1e-9,
                    max_steps: int = 100_000,
                    controller: StepController = StepController(),
                    return_stats: bool = False) -> Array:
    """Stiff ESDIRK solve at save times `ts` (flat-array state).

    adaptive=False: fixed grid, `substeps` Kvaerno3 steps per save
    interval, differentiable scan (the training-capable path).
    adaptive=True: embedded-error step control with Newton-failure
    halving (truth generation / validation; not differentiable).

    Suitable for stiff semi-discrete PDEs where an explicit stepper's
    stability bound, not accuracy, dictates the step size.
    """
    ts = jnp.asarray(ts)
    y0 = jnp.asarray(y0)

    if adaptive:
        st = _implicit_adaptive(f, y0, ts, args, rtol, atol, newton_iters,
                                newton_tol, max_steps, controller)
        if return_stats:
            return st["ys"], {"n_iter": st["n_iter"],
                              "n_reject": st["n_reject"],
                              "success": st["done"]}
        return st["ys"]

    def interval(y, t_pair):
        t0, t1 = t_pair
        h = (t1 - t0) / substeps

        def sub(y, i):
            y1, _, _ = kvaerno3_step(f, t0 + i * h, y, h, args,
                                     newton_iters, newton_tol)
            return y1, None

        y, _ = lax.scan(sub, y, jnp.arange(substeps))
        return y, y

    _, ys = lax.scan(interval, y0, (ts[:-1], ts[1:]))
    out = jnp.concatenate([y0[None], ys], axis=0)
    if return_stats:
        return out, {"success": jnp.asarray(True)}
    return out
