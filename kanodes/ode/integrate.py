"""Jittable ODE integration with three differentiation strategies.

Replaces the reference's solver layer — OrdinaryDiffEq `solve(..., Tsit5())`
+ Zygote backprop-through-the-solver (`LV_driver_KANODE.jl:180-184,284`) and
torchdiffeq `odeint` / `odeint_adjoint` (`predator_prey.py:142`,
`predator_prey_adjoint.py:5,142`) — with on-device `lax` control flow:

  * `odeint_fixed`   — fixed-grid RK via `lax.scan`; exact reverse AD through
                       every stage (discretize-then-optimize). The default
                       training path: static shapes, zero host syncs, and the
                       whole solve fuses into one XLA loop.
  * `odeint`         — adaptive embedded RK (Tsit5 default) with a PI-style
                       step controller.
                       adjoint="direct":    bounded `lax.scan` over
                           `max_steps`, reverse-differentiable (the analogue
                           of Zygote through the adaptive loop);
                       adjoint="backsolve": `lax.while_loop` forward +
                           `custom_vjp` continuous adjoint integrating the
                           augmented system backwards (torchdiffeq
                           `odeint_adjoint` equivalent, O(1) memory);
                       adjoint="none":      `lax.while_loop`, no gradients —
                           fastest; for data generation and inference.

Conventions (torchdiffeq-style): `rhs(t, y, args)`, `ts` strictly monotone
with `ts[0]` the initial time, outputs stacked along a leading time axis,
`y` may be any pytree of arrays.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from kanodes.ode.tableaus import Tableau, get_tableau

Array = jax.Array


# ---------------------------------------------------------------------------
# pytree arithmetic helpers
# ---------------------------------------------------------------------------

def _tmap(f, *trees):
    return jax.tree_util.tree_map(f, *trees)


def _zeros_like(tree):
    return _tmap(jnp.zeros_like, tree)


def _weighted_sum(coeffs, trees):
    """sum_i coeffs[i] * trees[i] over pytrees (skipping zero coeffs)."""
    acc = None
    for c, tr in zip(coeffs, trees):
        if c == 0.0:
            continue
        term = _tmap(lambda x: c * x, tr)
        acc = term if acc is None else _tmap(jnp.add, acc, term)
    if acc is None:
        acc = _zeros_like(trees[0])
    return acc


def _axpy(a, x, y):
    """y + a * x elementwise over pytrees (a scalar, possibly traced)."""
    return _tmap(lambda xi, yi: yi + a * xi, x, y)


def _where_tree(pred, a, b):
    return _tmap(lambda ai, bi: jnp.where(pred, ai, bi), a, b)


def _vdot_tree(a, b):
    """sum_leaves <a, b> — scalar dot product over matching pytrees."""
    tot = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        tot = tot + jnp.sum(x * y)
    return tot


def error_norm(err, y0, y1, rtol, atol) -> Array:
    """Hairer mixed-tolerance RMS norm of the local error estimate."""
    sq = 0.0
    n = 0
    for e, a, b in zip(jax.tree_util.tree_leaves(err),
                       jax.tree_util.tree_leaves(y0),
                       jax.tree_util.tree_leaves(y1)):
        scale = atol + rtol * jnp.maximum(jnp.abs(a), jnp.abs(b))
        sq = sq + jnp.sum((e / scale) ** 2)
        n += e.size
    return jnp.sqrt(sq / n)


# ---------------------------------------------------------------------------
# single explicit RK step
# ---------------------------------------------------------------------------

def rk_step(tab: Tableau, f: Callable, t, y, dt, args, k1=None):
    """One explicit RK step.

    Returns (y1, err, k_last, k_first) where `err` is the embedded error
    estimate (None if the tableau has none) and `k_last` is f(t+dt, y1) for
    FSAL tableaus (reusable as the next step's k1).
    """
    ks = [k1 if k1 is not None else f(t, y, args)]
    for i in range(1, tab.stages):
        yi = _tmap(lambda base, inc: base + dt * inc, y,
                   _weighted_sum(tab.a[i], ks))
        ks.append(f(t + tab.c[i] * dt, yi, args))
    y1 = _tmap(lambda base, inc: base + dt * inc, y, _weighted_sum(tab.b, ks))
    err = None
    if tab.b_err is not None:
        err = _tmap(lambda e: dt * e, _weighted_sum(tab.b_err, ks))
    k_last = ks[-1] if tab.fsal else None
    return y1, err, k_last


# ---------------------------------------------------------------------------
# fixed-grid integration (lax.scan — exact reverse AD)
# ---------------------------------------------------------------------------

def odeint_fixed(f: Callable, y0, ts: Array, args=None, *,
                 solver: str | Tableau = "tsit5", substeps: int = 1):
    """Integrate on the save grid `ts` with `substeps` equal RK steps per
    interval. Fully reverse-differentiable; O(T * substeps) tape via scan.

    This is the fast training path: for smooth non-stiff problems a
    5th-order step per save interval already integrates below model error,
    and the whole solve is one fused on-device loop.
    """
    tab = get_tableau(solver)
    ts = jnp.asarray(ts)

    def interval(carry, t_pair):
        y = carry
        t0, t1 = t_pair
        h = (t1 - t0) / substeps

        def sub(y, i):
            t = t0 + i * h
            y1, _, _ = rk_step(tab, f, t, y, h, args)
            return y1, None

        y, _ = lax.scan(sub, y, jnp.arange(substeps))
        return y, y

    _, ys = lax.scan(interval, y0, (ts[:-1], ts[1:]))
    # prepend y0 at ts[0]
    return _tmap(lambda a, b: jnp.concatenate([a[None], b], axis=0), y0, ys)


# ---------------------------------------------------------------------------
# adaptive step controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepController:
    """Proportional-integral step-size controller (Hairer-Wanner IV.2).

    dt_next = dt * clip(safety * err^(-(icoeff+pcoeff)/order)
                               * err_prev^(pcoeff/order))

    The default (pcoeff=0) is the classic I-controller; `StepController.pi()`
    gives the recommended PI pair for explicit embedded RK, which damps the
    accept/reject oscillation on stiffer problems (err_prev is the error
    norm of the last ACCEPTED step).
    """
    safety: float = 0.9
    min_factor: float = 0.2
    max_factor: float = 10.0
    dt_min: float = 1e-10
    pcoeff: float = 0.0       # proportional gain (0 -> pure I control)
    icoeff: float = 1.0       # integral gain

    @classmethod
    def pi(cls, **kw) -> "StepController":
        """Recommended PI pair for explicit RK (beta1=0.7/k, beta2=0.4/k)."""
        kw.setdefault("pcoeff", 0.4)
        kw.setdefault("icoeff", 0.3)
        return cls(**kw)

    def factor(self, err_nrm: Array, order: int,
               err_prev: Array | None = None) -> Array:
        # guard err == 0 -> max growth
        e = jnp.maximum(err_nrm, 1e-12)
        fac = self.safety * e ** (-(self.icoeff + self.pcoeff) / order)
        if self.pcoeff != 0.0 and err_prev is not None:
            fac = fac * jnp.maximum(err_prev, 1e-12) ** (self.pcoeff / order)
        return jnp.clip(fac, self.min_factor, self.max_factor)


def initial_dt(f, t0, y0, args, order, rtol, atol, tdir) -> Array:
    """Hairer-Wanner starting step heuristic (simplified)."""
    f0 = f(t0, y0, args)

    def nrm(tree):
        sq, n = 0.0, 0
        for leaf, yref in zip(jax.tree_util.tree_leaves(tree),
                              jax.tree_util.tree_leaves(y0)):
            sc = atol + rtol * jnp.abs(yref)
            sq = sq + jnp.sum((leaf / sc) ** 2)
            n += leaf.size
        return jnp.sqrt(sq / n)

    d0, d1 = nrm(y0), nrm(f0)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = _axpy(tdir * h0, f0, y0)
    f1 = f(t0 + tdir * h0, y1, args)
    d2 = nrm(_tmap(jnp.subtract, f1, f0)) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(dmax <= 1e-15,
                   jnp.maximum(1e-6, h0 * 1e-3),
                   (0.01 / dmax) ** (1.0 / (order + 1)))
    return jnp.minimum(100.0 * h0, h1)


# ---------------------------------------------------------------------------
# adaptive integration — shared step logic
# ---------------------------------------------------------------------------

def _flat_len(tree) -> int:
    return sum(x.size for x in jax.tree_util.tree_leaves(tree))


def _hermite(t0, t1, y0, y1, f0, f1, t_eval):
    """Cubic Hermite interpolation on [t0, t1] (3rd-order dense output;
    f0/f1 are the RHS values at the endpoints — free via FSAL)."""
    h = t1 - t0
    s = (t_eval - t0) / h
    h00 = (1 + 2 * s) * (1 - s) ** 2
    h10 = s * (1 - s) ** 2
    h01 = s * s * (3 - 2 * s)
    h11 = s * s * (s - 1)
    return _tmap(
        lambda a, b, fa, fb: h00 * a + h10 * h * fa + h01 * b
        + h11 * h * fb, y0, y1, f0, f1)


def _adaptive_step(tab, f, args, rtol, atol, ctrl, ts, state,
                   dense: bool = False):
    """One controller iteration. `state` is a dict; everything is masked
    by `state["done"]` so this body is safe to run as a no-op after
    finishing.

    dense=False: clip steps so accepted steps land exactly on save times
    (exact save values; reverse-differentiable).
    dense=True: take natural controller steps and fill save points inside
    each accepted step by cubic Hermite interpolation (fewer steps; used
    by the non-differentiated forward passes).
    """
    t, y, dt, k1 = state["t"], state["y"], state["dt"], state["k1"]
    save_idx, ys = state["save_idx"], state["ys"]
    done = state["done"]
    tdir = state["tdir"]
    T = ts.shape[0]

    t_save = ts[jnp.minimum(save_idx, T - 1)]
    remaining = (t_save - t) * tdir                    # > 0 while not done
    if dense:
        # never step beyond the final save time
        t_end = ts[T - 1]
        dt_used = jnp.minimum(dt, (t_end - t) * tdir)
        hit = dt >= remaining      # unused for stepping; kept for parity
    else:
        hit = dt >= remaining
        dt_used = jnp.where(hit, remaining, dt)

    y1, err, k_last = rk_step(tab, f, t, y, tdir * dt_used, args, k1=k1)
    err_nrm = lax.stop_gradient(error_norm(err, y, y1, rtol, atol))
    accept = (err_nrm <= 1.0) | (dt_used <= ctrl.dt_min)
    fac = ctrl.factor(err_nrm, tab.order, state.get("err_prev"))
    dt_next = jnp.maximum(dt_used * fac, ctrl.dt_min)

    step_ok = accept & ~done
    t1_ = t + tdir * dt_used
    if dense:
        t_new = jnp.where(step_ok, t1_, t)
    else:
        t_new = jnp.where(step_ok, jnp.where(hit, t_save, t1_), t)
    y_new = _where_tree(step_ok, y1, y)
    k1_new = _where_tree(step_ok, k_last, k1)

    if dense:
        # fill every save time inside (t, t1] by Hermite interpolation
        def fill_cond(c):
            si, _ = c
            inside = (ts[jnp.minimum(si, T - 1)] - t1_) * tdir <= 1e-6
            return step_ok & (si < T) & inside

        def fill_body(c):
            si, buf = c
            te = ts[jnp.minimum(si, T - 1)]
            val = _hermite(t, t1_, y, y1, k1, k_last, te)

            def rec(b, v):
                return lax.dynamic_update_index_in_dim(b, v, si, 0)

            return si + 1, _tmap(rec, buf, val)

        save_idx_new, ys_new = lax.while_loop(fill_cond, fill_body,
                                              (save_idx, ys))
        saved = save_idx_new > save_idx
    else:
        saved = step_ok & hit

        def _record(buf, val):
            # out-of-range save_idx (after done) clamps + rewrites old
            old = lax.dynamic_index_in_dim(buf, save_idx, 0,
                                           keepdims=False)
            return lax.dynamic_update_index_in_dim(
                buf, jnp.where(saved, val, old), save_idx, 0)

        ys_new = _tmap(_record, ys, y1)
        save_idx_new = save_idx + saved.astype(save_idx.dtype)
    done_new = done | (save_idx_new >= ts.shape[0])

    return {
        "t": t_new, "y": y_new, "dt": jnp.where(done, dt, dt_next),
        "k1": k1_new, "save_idx": save_idx_new, "ys": ys_new,
        "done": done_new, "tdir": tdir,
        # PI memory: error norm of the last ACCEPTED step
        "err_prev": jnp.where(step_ok, jnp.maximum(err_nrm, 1e-12),
                              state["err_prev"]),
        "n_accept": state["n_accept"] + step_ok.astype(jnp.int32),
        "n_reject": state["n_reject"] + (~accept & ~done).astype(jnp.int32),
        "n_iter": state["n_iter"] + (~done).astype(jnp.int32),
    }


def _init_state(tab, f, y0, ts, args, rtol, atol, dt0):
    t0 = ts[0]
    tdir = jnp.sign(ts[-1] - ts[0])
    if dt0 is None:
        # step-size selection must NOT be differentiated: initial_dt is
        # a function of f(y0, args), and letting cotangents flow through
        # the controller's dt chain produces exploding garbage gradients
        # (d(solution)/d(step size) is an error-level quantity with
        # error-level conditioning). err_nrm is already stopped in
        # _adaptive_step; this stops the one remaining leak.
        dt = lax.stop_gradient(
            initial_dt(f, t0, y0, args, tab.order, rtol, atol, tdir))
    else:
        dt = jnp.asarray(dt0, dtype=jnp.result_type(ts))
    k1 = f(t0, y0, args)
    T = ts.shape[0]
    ys = _tmap(lambda x: jnp.zeros((T,) + x.shape, x.dtype)
               .at[0].set(x), y0)
    return {
        "t": t0, "y": y0, "dt": dt, "k1": k1,
        "save_idx": jnp.asarray(1, jnp.int32), "ys": ys,
        "done": jnp.asarray(T <= 1), "tdir": tdir,
        "err_prev": jnp.asarray(1.0, jnp.result_type(ts)),
        "n_accept": jnp.asarray(0, jnp.int32),
        "n_reject": jnp.asarray(0, jnp.int32),
        "n_iter": jnp.asarray(0, jnp.int32),
    }


def _adaptive_while(tab, f, y0, ts, args, rtol, atol, dt0, max_steps, ctrl,
                    dense: bool = False):
    state = _init_state(tab, f, y0, ts, args, rtol, atol, dt0)

    def cond(s):
        return (~s["done"]) & (s["n_iter"] < max_steps)

    def body(s):
        return _adaptive_step(tab, f, args, rtol, atol, ctrl, ts, s,
                              dense=dense)

    return lax.while_loop(cond, body, state)


def _adaptive_scan(tab, f, y0, ts, args, rtol, atol, dt0, max_steps, ctrl,
                   remat: bool = False):
    state = _init_state(tab, f, y0, ts, args, rtol, atol, dt0)

    def body(s, _):
        return _adaptive_step(tab, f, args, rtol, atol, ctrl, ts, s), None

    if remat:
        # checkpointed direct adjoint: recompute each controller step's
        # stages in the backward pass instead of storing them — the
        # activation-memory middle ground between "direct" (stores all
        # stages) and "backsolve" (re-simulates the trajectory)
        body = jax.checkpoint(body)
    state, _ = lax.scan(body, state, None, length=max_steps)
    return state


@dataclasses.dataclass
class SolveStats:
    n_accept: Any
    n_reject: Any
    n_iter: Any
    success: Any


def odeint(f: Callable, y0, ts: Array, args=None, *,
           solver: str | Tableau = "tsit5",
           rtol: float = 1e-3, atol: float = 1e-6,
           dt0: float | None = None, max_steps: int = 4096,
           adjoint: str = "backsolve",
           controller: StepController = StepController(),
           return_stats: bool = False,
           dense: bool = False):
    """Adaptive ODE solve at save times `ts` (torchdiffeq-compatible shape).

    adjoint:
      "direct"    exact reverse AD through the (bounded-scan) adaptive loop;
      "direct_remat"  same gradients, O(1) stage-activation memory
                  (each controller step recomputed in the backward pass);
      "interpolating"  diffrax-style checkpointed-interpolating adjoint:
                  while_loop forward (early exit) recording each accepted
                  step's Hermite data; backward integrates the adjoint ODE
                  against the interpolated forward solution — stable on
                  dissipative/stiff dynamics where backsolve diverges,
                  cheaper than "direct" when max_steps is a loose bound;
      "backsolve" continuous adjoint custom_vjp (O(1) memory);
      "none"      while_loop, fastest, not differentiable.

    Default tolerances mirror the reference's OrdinaryDiffEq defaults
    (reltol 1e-3 / abstol 1e-6).

    Gradient notes: all differentiable adjoints propagate cotangents to
    y0, args AND the save times `ts`. "direct"/"direct_remat" get ts
    gradients by exact reverse AD through the save-clipped stepper;
    "backsolve" and "interpolating" compute the continuous boundary
    terms dL/dt_i = g_i . f(t_i, y_i) (i >= 1) and
    dL/dt_0 = -a(t_0) . f(t_0, y_0) — torchdiffeq's time_vjps
    (predator_prey_adjoint.py:5,142). The only hard-zero ts rows are
    unreached-save fills (max_steps exhausted), which are error-handling
    constants.
    """
    tab = get_tableau(solver)
    if tab.b_err is None:
        raise ValueError(f"solver {tab.name!r} has no embedded error "
                         "estimate; use odeint_fixed")
    if not tab.fsal:
        raise ValueError("adaptive path requires an FSAL tableau "
                         "(tsit5/dopri5/bs3)")
    ts = jnp.asarray(ts)

    if dense and adjoint in ("direct", "interpolating"):
        raise ValueError("dense output is not reverse-differentiable; "
                         "use adjoint='none' or 'backsolve'")
    if adjoint == "interpolating":
        if return_stats:
            raise ValueError("return_stats unsupported with interpolating")
        dt0_static = None if dt0 is None else float(dt0)
        return _odeint_interp(f, tab, rtol, atol, max_steps, controller,
                              2, dt0_static, y0, ts, args)
    if adjoint == "none":
        st = _adaptive_while(tab, f, y0, ts, args, rtol, atol, dt0,
                             max_steps, controller, dense=dense)
    elif adjoint in ("direct", "direct_remat"):
        st = _adaptive_scan(tab, f, y0, ts, args, rtol, atol, dt0,
                            max_steps, controller,
                            remat=(adjoint == "direct_remat"))
    if adjoint in ("none", "direct", "direct_remat"):
        # if max_steps ran out before reaching every save time, fill the
        # remaining slots with the last integrated state instead of
        # leaving zeros; check `return_stats` -> stats.success to detect
        # truncation
        st["ys"] = _fill_unreached(st, ts)
    elif adjoint == "backsolve":
        if return_stats:
            raise ValueError("return_stats unsupported with backsolve")
        return _odeint_backsolve(f, tab, rtol, atol, max_steps,
                                 (controller, dense), y0, ts, args)
    else:
        raise ValueError(f"unknown adjoint {adjoint!r}")

    if return_stats:
        stats = SolveStats(st["n_accept"], st["n_reject"], st["n_iter"],
                           st["done"])
        return st["ys"], stats
    return st["ys"]


def odeint_adjoint(f, y0, ts, args=None, adjoint_params=None, **kw):
    """torchdiffeq `odeint_adjoint` equivalent (continuous backsolve).

    `adjoint_params` mirrors torchdiffeq's parameter-subset selection
    (`predator_prey_adjoint.py:132-142`): a pytree of bools matching
    `args` (prefix trees work — a single False kills everything). Leaves
    marked False are excluded from the backward solve via stop_gradient,
    so their cotangents come back zero and the augmented adjoint system
    stays correspondingly smaller after DCE.
    """
    if adjoint_params is not None:
        args = _tmap(
            lambda keep, a: a if keep else lax.stop_gradient(a),
            adjoint_params, args)
    kw["adjoint"] = "backsolve"
    return odeint(f, y0, ts, args, **kw)


# ---------------------------------------------------------------------------
# interpolating adjoint — custom_vjp over a recorded forward solve
# ---------------------------------------------------------------------------

def _adaptive_while_record(tab, f, y0, ts, args, rtol, atol, dt0,
                           max_steps, ctrl):
    """Adaptive while_loop forward (early exit) that additionally records
    every ACCEPTED step's cubic-Hermite data: (t0, t1, y0, y1, f0, f1)
    plus the save index hit at the step end (-1 if none). The record is
    what the interpolating adjoint integrates backwards over."""
    state = _init_state(tab, f, y0, ts, args, rtol, atol, dt0)
    zeros_t = jnp.zeros((max_steps,), jnp.result_type(ts))
    buf = lambda: _tmap(
        lambda x: jnp.zeros((max_steps,) + x.shape, x.dtype), y0)
    rec = {"t0": zeros_t, "t1": zeros_t,
           "y0": buf(), "y1": buf(), "f0": buf(), "f1": buf(),
           "sidx": jnp.full((max_steps,), -1, jnp.int32)}

    def cond(c):
        s, _ = c
        return (~s["done"]) & (s["n_iter"] < max_steps)

    def body(c):
        s, rec = c
        t_prev, y_prev, k1_prev = s["t"], s["y"], s["k1"]
        s2 = _adaptive_step(tab, f, args, rtol, atol, ctrl, ts, s)
        accepted = s2["n_accept"] > s["n_accept"]
        saved = s2["save_idx"] > s["save_idx"]
        slot = s["n_accept"]          # accepted-step counter = record slot

        def rec_scalar(b, v):
            old = lax.dynamic_index_in_dim(b, slot, 0, keepdims=False)
            return lax.dynamic_update_index_in_dim(
                b, jnp.where(accepted, v, old), slot, 0)

        def rec_tree(b, v):
            return _tmap(rec_scalar, b, v)

        rec = {"t0": rec_scalar(rec["t0"], t_prev),
               "t1": rec_scalar(rec["t1"], s2["t"]),
               "y0": rec_tree(rec["y0"], y_prev),
               "y1": rec_tree(rec["y1"], s2["y"]),
               "f0": rec_tree(rec["f0"], k1_prev),
               "f1": rec_tree(rec["f1"], s2["k1"]),
               "sidx": rec_scalar(
                   rec["sidx"],
                   jnp.where(saved, s["save_idx"], -1).astype(jnp.int32))}
        return s2, rec

    return lax.while_loop(cond, body, (state, rec))


def _fill_unreached(st, ts):
    """Replace save rows the bounded solve never reached (max_steps ran
    out) with the last integrated state — zeros there silently poison
    losses/gradients. Applied uniformly by the direct and interpolating
    paths."""
    T = ts.shape[0]
    unreached = jnp.arange(T) >= st["save_idx"]
    return _tmap(
        lambda buf, yf: jnp.where(
            unreached.reshape((T,) + (1,) * (buf.ndim - 1)), yf[None], buf),
        st["ys"], st["y"])


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5, 6, 7))
def _odeint_interp(f, tab, rtol, atol, max_steps, ctrl, bwd_substeps, dt0,
                   y0, ts, args):
    st, _ = _adaptive_while_record(tab, f, y0, ts, args, rtol, atol, dt0,
                                   max_steps, ctrl)
    st["ys"] = _fill_unreached(st, ts)
    return st["ys"]


def _interp_fwd(f, tab, rtol, atol, max_steps, ctrl, bwd_substeps, dt0,
                y0, ts, args):
    st, rec = _adaptive_while_record(tab, f, y0, ts, args, rtol, atol,
                                     dt0, max_steps, ctrl)
    st["ys"] = _fill_unreached(st, ts)
    return st["ys"], (rec, st["n_accept"], st["save_idx"], ts, args)


def _interp_bwd(f, tab, rtol, atol, max_steps, ctrl, bwd_substeps, dt0,
                res, ys_bar):
    """Integrate the adjoint ODE a' = -a df/dy backwards over each
    recorded forward step, with y(t) supplied by the forward solution's
    cubic Hermite interpolant (never re-simulated — stable for
    dissipative systems where backsolve diverges). One `bwd_substeps`-
    step RK solve of the same tableau per forward step; cotangents of
    saved outputs are injected at the step boundaries they landed on
    (the save-clipped forward guarantees saves ARE boundaries). Save
    rows beyond `save_idx` were filled with the final integrated state by
    `_fill_unreached`; their cotangents are therefore summed into the
    initial (final-time) adjoint below — the exact VJP of the fill."""
    rec, n_acc, save_idx, ts, args = res

    def seg(carry, i):
        a_y, a_args = carry
        valid = i >= 0
        j = jnp.maximum(i, 0)
        t0 = rec["t0"][j]
        t1 = rec["t1"][j]
        y0v = _tmap(lambda b: b[j], rec["y0"])
        y1v = _tmap(lambda b: b[j], rec["y1"])
        f0 = _tmap(lambda b: b[j], rec["f0"])
        f1 = _tmap(lambda b: b[j], rec["f1"])
        sidx = rec["sidx"][j]

        # inject the cotangent of the save point hit at this step's end
        g = _tmap(lambda b: b[jnp.maximum(sidx, 0)], ys_bar)
        has_save = valid & (sidx >= 0)
        a_y_in = _where_tree(has_save, _tmap(jnp.add, a_y, g), a_y)
        # save-time boundary term dL/dt_i = g_i . f(t_i, y_i): the
        # save-clipped forward ends accepted steps exactly on save times,
        # so the recorded f1 = f(t1, y1) IS f(t_i, y_i)
        t_bar = jnp.where(has_save, _vdot_tree(g, f1), 0.0)

        def aug_dyn(t, a, _):
            ay, _aargs = a
            y_t = _hermite(t0, t1, y0v, y1v, f0, f1, t)

            def fy(y_, args_):
                return f(t, y_, args_)

            _, vjp = jax.vjp(fy, y_t, args)
            y_bar, args_bar = vjp(ay)
            return (_tmap(jnp.negative, y_bar),
                    _tmap(jnp.negative, args_bar))

        h = (t0 - t1) / bwd_substeps
        a = (a_y_in, a_args)
        for k in range(bwd_substeps):
            a, _, _ = rk_step(tab, aug_dyn, t1 + k * h, a, h, None)
        return (_where_tree(valid, a[0], a_y_in),
                _where_tree(valid, a[1], a_args)), \
            (jnp.maximum(sidx, 0), t_bar)

    T = ts.shape[0]
    unreached = jnp.arange(T) >= save_idx
    a_y0 = _tmap(
        lambda b: jnp.sum(
            jnp.where(unreached.reshape((T,) + (1,) * (b.ndim - 1)),
                      b, jnp.zeros_like(b)), axis=0),
        ys_bar)
    a_args0 = _zeros_like(args)
    # reverse order over the n_acc recorded steps (masked tail)
    idxs = n_acc - 1 - jnp.arange(max_steps)
    (a_y, a_args), (sidxs, t_bars) = lax.scan(seg, (a_y0, a_args0), idxs)
    # masked slots wrote (0, 0.0) pairs — scatter-adds of zero are no-ops
    ts_bar = jnp.zeros_like(ts).at[sidxs].add(t_bars.astype(ts.dtype))
    # initial-time term dL/dt_0 = -a(t_0) . f(t_0, y_0) with the adjoint
    # BEFORE the g_0 injection; rec["f0"][0] is f(ts[0], y0) whenever at
    # least one step was accepted (guarded otherwise). Unreached-fill
    # rows keep a hard-zero ts cotangent (the fill value is the solve's
    # final state, an error-handling constant w.r.t. save times).
    f0_first = _tmap(lambda b: b[0], rec["f0"])
    t0_bar = jnp.where(n_acc > 0, -_vdot_tree(a_y, f0_first), 0.0)
    ts_bar = ts_bar.at[0].add(t0_bar.astype(ts.dtype))
    g0 = _tmap(lambda b: b[0], ys_bar)
    a_y = _tmap(jnp.add, a_y, g0)
    return a_y, ts_bar, a_args


_odeint_interp.defvjp(_interp_fwd, _interp_bwd)


# ---------------------------------------------------------------------------
# continuous (backsolve) adjoint — custom_vjp
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5))
def _odeint_backsolve(f, tab, rtol, atol, max_steps, ctrl_dense, y0, ts,
                      args):
    ctrl, dense = ctrl_dense if isinstance(ctrl_dense, tuple) \
        else (ctrl_dense, False)
    st = _adaptive_while(tab, f, y0, ts, args, rtol, atol, None,
                         max_steps, ctrl, dense=dense)
    return st["ys"]


def _backsolve_fwd(f, tab, rtol, atol, max_steps, ctrl_dense, y0, ts,
                   args):
    ys = _odeint_backsolve(f, tab, rtol, atol, max_steps, ctrl_dense, y0,
                           ts, args)
    return ys, (ys, ts, args)


def _backsolve_bwd(f, tab, rtol, atol, max_steps, ctrl_dense, res, ys_bar):
    ctrl = ctrl_dense[0] if isinstance(ctrl_dense, tuple) else ctrl_dense
    ys, ts, args = res
    T = ts.shape[0]

    def aug_dyn(t, aug, _):
        y, a_y, _a_args = aug

        def fy(y_, args_):
            return f(t, y_, args_)

        f_val, vjp = jax.vjp(fy, y, args)
        y_bar, args_bar = vjp(a_y)
        return (f_val,
                _tmap(jnp.negative, y_bar),
                _tmap(jnp.negative, args_bar))

    def segment(carry, idx):
        # idx runs T-1 .. 1 ; integrate from ts[idx] back to ts[idx-1]
        a_y, a_args = carry
        y_i = _tmap(lambda b: b[idx], ys)
        g_i = _tmap(lambda b: b[idx], ys_bar)
        # save-time boundary term dL/dt_i = g_i . f(t_i, y_i): moving the
        # measurement time slides the readout along the trajectory
        # (torchdiffeq's time_vjps, predator_prey_adjoint.py:5,142)
        t_bar = _vdot_tree(g_i, f(ts[idx], y_i, args))
        a_y = _tmap(jnp.add, a_y, g_i)
        aug0 = (y_i, a_y, a_args)
        seg_ts = jnp.stack([ts[idx], ts[idx - 1]])
        st = _adaptive_while(tab, aug_dyn, aug0, seg_ts, None,
                             rtol, atol, None, max_steps, ctrl)
        aug1 = _tmap(lambda b: b[1], st["ys"])
        _, a_y, a_args = aug1
        return (a_y, a_args), t_bar

    a_y0 = _zeros_like(_tmap(lambda b: b[0], ys))
    a_args0 = _zeros_like(args)
    (a_y, a_args), t_bars = lax.scan(segment, (a_y0, a_args0),
                                     jnp.arange(T - 1, 0, -1))
    ts_bar = jnp.zeros_like(ts).at[jnp.arange(T - 1, 0, -1)].set(
        t_bars.astype(ts.dtype))
    # initial-time term dL/dt_0 = -a(t_0) . f(t_0, y_0), with the adjoint
    # BEFORE the g_0 injection (y(t_0) = y_0 identically, so g_0 itself
    # carries no t_0 sensitivity)
    y_0 = _tmap(lambda b: b[0], ys)
    ts_bar = ts_bar.at[0].set(
        jnp.asarray(-_vdot_tree(a_y, f(ts[0], y_0, args)), ts.dtype))
    g_0 = _tmap(lambda b: b[0], ys_bar)
    a_y = _tmap(jnp.add, a_y, g_0)
    return a_y, ts_bar, a_args


_odeint_backsolve.defvjp(_backsolve_fwd, _backsolve_bwd)


# ---------------------------------------------------------------------------
# per-member adaptive integration for packed ensembles
# ---------------------------------------------------------------------------

def _member_norm(tree_like_err: Array, y0: Array, y1: Array,
                 rtol, atol, n_members: int) -> Array:
    """Member-blocked Hairer norm: the packed state's last axis is
    member-major [S*d]; returns one error norm per member [S], computed
    over that member's block (all batch axes included) — the exact
    per-member analogue of `error_norm`."""
    S = n_members
    d = y0.shape[-1] // S
    scale = atol + rtol * jnp.maximum(jnp.abs(y0), jnp.abs(y1))
    r = (tree_like_err / scale).reshape(y0.shape[:-1] + (S, d))
    axes = tuple(range(r.ndim - 2)) + (r.ndim - 1,)
    return jnp.sqrt(jnp.mean(r * r, axis=axes))


def _initial_dt_members(f, t0, y0, args, order, rtol, atol, tdir,
                        n_members: int) -> Array:
    """Per-member Hairer starting-step heuristic — `initial_dt` with
    every norm taken over the member's own block, so each member starts
    exactly where its sequential solve would."""
    S = n_members
    d = y0.shape[-1] // S
    expand = lambda v: jnp.repeat(v, d)
    f0 = f(t0, y0, args)

    def nrm(x):
        sc = atol + rtol * jnp.abs(y0)
        r = (x / sc).reshape(y0.shape[:-1] + (S, d))
        axes = tuple(range(r.ndim - 2)) + (r.ndim - 1,)
        return jnp.sqrt(jnp.mean(r * r, axis=axes))

    d0, d1 = nrm(y0), nrm(f0)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + expand(tdir * h0) * f0
    f1 = f(t0 + tdir * h0, y1, args)
    d2 = nrm(f1 - f0) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(dmax <= 1e-15,
                   jnp.maximum(1e-6, h0 * 1e-3),
                   (0.01 / dmax) ** (1.0 / (order + 1)))
    return jnp.minimum(100.0 * h0, h1)


def odeint_members(f: Callable, y0: Array, ts: Array, args=None, *,
                   n_members: int,
                   solver: str | Tableau = "tsit5",
                   rtol: float = 1e-3, atol: float = 1e-6,
                   dt0: float | None = None, max_steps: int = 4096,
                   controller: StepController = StepController(),
                   return_stats: bool = False):
    """Adaptive solve of a PACKED ensemble state with one independent
    step controller PER MEMBER.

    `y0`'s last axis is member-major packed [S*d] (`models/packed.py`);
    `f` must be block-diagonal across members (packed KAN chains are, by
    masking) and is called with a per-member time VECTOR t [S] —
    autonomous RHSs ignore it. Each member then carries its own
    (t, dt, save_idx, err_prev): error norms are member-blocked, steps
    are save-clipped per member, and accept/reject decisions never
    couple members — the reference-faithful adaptive training protocol
    (`LV_driver_KANODE.jl:180-184`) applied to every ensemble member at
    once, which a single shared controller (the `odeint` default over a
    packed state) cannot do.

    Reverse-differentiable: the bounded `lax.scan` analogue of
    `odeint(..., adjoint="direct")`. Returns ys [T, ..., S*d] (and
    per-member SolveStats when `return_stats`).
    """
    tab = get_tableau(solver)
    if tab.b_err is None or not tab.fsal:
        raise ValueError("per-member adaptive requires an FSAL embedded "
                         "tableau (tsit5/dopri5/bs3)")
    ts = jnp.asarray(ts)
    y0 = jnp.asarray(y0)
    S = int(n_members)
    if y0.shape[-1] % S:
        raise ValueError(f"state dim {y0.shape[-1]} not divisible by "
                         f"n_members={S}")
    d = y0.shape[-1] // S
    T = ts.shape[0]
    tdir = jnp.sign(ts[-1] - ts[0])
    expand = lambda v: jnp.repeat(v, d)                    # [S] -> [S*d]

    t0 = jnp.full((S,), ts[0], jnp.result_type(ts))
    if dt0 is None:
        dt = lax.stop_gradient(_initial_dt_members(
            f, t0, y0, args, tab.order, rtol, atol, tdir, S))
    else:
        dt = jnp.full((S,), dt0, jnp.result_type(ts))
    k1 = f(t0, y0, args)
    ys = jnp.zeros((T,) + y0.shape, y0.dtype).at[0].set(y0)
    state = {
        "t": t0, "y": y0, "dt": dt, "k1": k1,
        "save_idx": jnp.ones((S,), jnp.int32),
        "ys": ys,
        "done": jnp.full((S,), T <= 1),
        "err_prev": jnp.ones((S,), jnp.result_type(ts)),
        "n_accept": jnp.zeros((S,), jnp.int32),
        "n_reject": jnp.zeros((S,), jnp.int32),
        "n_iter": jnp.zeros((S,), jnp.int32),
    }

    def step(s, _):
        t, y, dt, k1 = s["t"], s["y"], s["dt"], s["k1"]
        save_idx, done = s["save_idx"], s["done"]
        t_save = ts[jnp.minimum(save_idx, T - 1)]          # [S]
        remaining = (t_save - t) * tdir
        hit = dt >= remaining
        dt_used = jnp.where(hit, remaining, dt)            # [S]
        h = expand(tdir * dt_used)                         # [S*d]

        ks = [k1]
        for i in range(1, tab.stages):
            yi = y + h * _weighted_sum(tab.a[i], ks)
            ks.append(f(t + tab.c[i] * dt_used, yi, args))
        y1 = y + h * _weighted_sum(tab.b, ks)
        err = h * _weighted_sum(tab.b_err, ks)
        err_nrm = lax.stop_gradient(
            _member_norm(err, y, y1, rtol, atol, S))       # [S]
        accept = (err_nrm <= 1.0) | (dt_used <= controller.dt_min)
        fac = controller.factor(err_nrm, tab.order, s["err_prev"])
        dt_next = jnp.maximum(dt_used * fac, controller.dt_min)

        step_ok = accept & ~done                           # [S]
        t1_ = t + tdir * dt_used
        t_new = jnp.where(step_ok, jnp.where(hit, t_save, t1_), t)
        ok = expand(step_ok)
        y_new = jnp.where(ok, y1, y)
        k1_new = jnp.where(ok, ks[-1], k1)                 # FSAL

        saved = step_ok & hit                              # [S]
        onehot = ((jnp.arange(T)[:, None] == save_idx[None, :])
                  & saved[None, :])                        # [T, S]
        m = jnp.repeat(onehot, d, axis=1)                  # [T, S*d]
        m = m.reshape((T,) + (1,) * (y.ndim - 1) + (S * d,))
        ys_new = jnp.where(m, y1[None], s["ys"])
        save_idx_new = save_idx + saved.astype(jnp.int32)
        done_new = done | (save_idx_new >= T)

        return {
            "t": t_new, "y": y_new,
            "dt": jnp.where(done, dt, dt_next),
            "k1": k1_new, "save_idx": save_idx_new, "ys": ys_new,
            "done": done_new,
            "err_prev": jnp.where(step_ok, jnp.maximum(err_nrm, 1e-12),
                                  s["err_prev"]),
            "n_accept": s["n_accept"] + step_ok.astype(jnp.int32),
            "n_reject": s["n_reject"]
            + (~accept & ~done).astype(jnp.int32),
            "n_iter": s["n_iter"] + (~done).astype(jnp.int32),
        }, None

    state, _ = lax.scan(step, state, None, length=max_steps)

    # unreached save rows (max_steps exhausted): fill that MEMBER's block
    # with its last integrated state, mirroring `_fill_unreached`
    unreached = (jnp.arange(T)[:, None]
                 >= state["save_idx"][None, :])            # [T, S]
    um = jnp.repeat(unreached, d, axis=1)
    um = um.reshape((T,) + (1,) * (y0.ndim - 1) + (S * d,))
    ys = jnp.where(um, state["y"][None], state["ys"])

    if return_stats:
        stats = SolveStats(state["n_accept"], state["n_reject"],
                           state["n_iter"], state["done"])
        return ys, stats
    return ys
