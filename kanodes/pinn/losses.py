"""Strain-limiting PINN physics: residual, stress, and loss terms.

PDE (Eq. 40 of the strain-limiting model): with the nonlinear flux
    q = grad(phi) / (2 mu (1 + beta |grad phi|^alpha)^(1/alpha)),
find phi with div q = 0 on the notched plate.

Rebuild of `StrainLimiting_KAN_PINN.py:560-860` (autograd residual,
tip-weighted PDE loss, Dirichlet boundary loss, gauge pin, mirror
symmetry, tip-stress amplitude + near/far ratio hinge) and the Julia
FD-residual flavor (`StrainLimiting_KAN_PINN.jl:109-149`).

On device: residuals are forward-over-reverse AD — per point,
    g(x) = grad(phi)(x)           (reverse)
    div q = sum_i  e_i . d/dx_i [flux(g(x))]   (two JVPs)
vmapped over the batch, jitted once; no chunked python loops, no OOM
retry ladders (XLA's memory plan is static). The FD flavor is kept as
`pde_residual_fd` for Julia-parity testing.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class Material:
    """MaterialParams (StrainLimiting_KAN_PINN.py:62-66)."""
    mu: float = 1.0
    beta: float = 1.0
    alpha: float = 0.2


def flux_from_grad(g: Array, mat: Material, eps: float = 1e-10) -> Array:
    """q = g / (2 mu (1 + beta |g|^alpha)^(1/alpha))  (:560-565)."""
    gnorm = jnp.sqrt(jnp.sum(g * g, axis=-1) + eps)
    denom = 2.0 * mat.mu * (1.0 + mat.beta * gnorm ** mat.alpha) \
        ** (1.0 / mat.alpha)
    return g / denom[..., None]


def pde_residual(phi_fn, xy: Array, mat: Material,
                 eps: float = 1e-10) -> Array:
    """div q at each point of xy [N, 2] -> [N] (:612-654)."""

    def q_at(p):                                   # [2] -> [2]
        g = jax.grad(phi_fn)(p)
        return flux_from_grad(g, mat, eps)

    def div_q(p):
        _, dqx = jax.jvp(q_at, (p,), (jnp.asarray([1.0, 0.0]),))
        _, dqy = jax.jvp(q_at, (p,), (jnp.asarray([0.0, 1.0]),))
        return dqx[0] + dqy[1]

    return jax.vmap(div_q)(xy)


def pde_residual_fd(phi_fn, xy: Array, mat: Material,
                    fd_eps: float = 2e-3, eps: float = 1e-10) -> Array:
    """Julia-flavor nested central finite differences
    (`StrainLimiting_KAN_PINN.jl:109-149`): ~12 field evals per point."""
    ex = jnp.asarray([fd_eps, 0.0])
    ey = jnp.asarray([0.0, fd_eps])

    def grad_fd(p):
        return jnp.stack([
            (phi_fn(p + ex) - phi_fn(p - ex)) / (2 * fd_eps),
            (phi_fn(p + ey) - phi_fn(p - ey)) / (2 * fd_eps)])

    def q_at(p):
        return flux_from_grad(grad_fd(p), mat, eps)

    def div_q(p):
        dqx = (q_at(p + ex)[0] - q_at(p - ex)[0]) / (2 * fd_eps)
        dqy = (q_at(p + ey)[1] - q_at(p - ey)[1]) / (2 * fd_eps)
        return dqx + dqy

    return jax.vmap(div_q)(xy)


def stress(phi_fn, xy: Array, eps: float = 1e-10
           ) -> tuple[Array, Array, Array]:
    """(tau_xz, tau_yz, tau_eq): tau_xz = d(phi)/dy, tau_yz = -d(phi)/dx
    (:637-655)."""
    g = jax.vmap(jax.grad(phi_fn))(xy)
    tau_xz = g[:, 1]
    tau_yz = -g[:, 0]
    tau_eq = jnp.sqrt(tau_xz ** 2 + tau_yz ** 2 + eps)
    return tau_xz, tau_yz, tau_eq


# ---------------------------------------------------------------------------
# loss terms
# ---------------------------------------------------------------------------

def tip_residual_weights(xy: Array, tip: tuple[float, float],
                         power: float = 0.5, w_eps: float = 1e-3,
                         clip: float = 50.0) -> Array:
    """1/(dist^power + eps) residual weights, mean-normalized + clipped
    (:672-686)."""
    if power <= 0:
        return jnp.ones(xy.shape[0])
    d = jnp.sqrt((xy[:, 0] - tip[0]) ** 2 + (xy[:, 1] - tip[1]) ** 2
                 + 1e-10)
    raw = 1.0 / (d ** power + w_eps)
    raw = raw / jax.lax.stop_gradient(jnp.maximum(raw.mean(), 1e-12))
    return jnp.minimum(raw, clip) if clip > 0 else raw


def weighted_pde_loss(phi_fn, xy: Array, mat: Material,
                      tip: tuple[float, float], *, weight_power: float,
                      residual: str = "autograd",
                      fd_eps: float = 2e-3) -> Array:
    """mean((w * r)^2) (:688-712)."""
    if residual == "fd":
        r = pde_residual_fd(phi_fn, xy, mat, fd_eps=fd_eps)
    else:
        r = pde_residual(phi_fn, xy, mat)
    w = tip_residual_weights(xy, tip, power=weight_power)
    return jnp.mean((w * r) ** 2)


def boundary_loss(phi_fn, bdata: dict[str, Array],
                  btargets: dict[str, Array]) -> tuple[Array, dict]:
    """Mean over labels of per-label Dirichlet MSE (:764-791)."""
    terms = {}
    for label, xy in bdata.items():
        pred = jax.vmap(phi_fn)(xy)
        terms[label] = jnp.mean((pred - btargets[label]) ** 2)
    total = jnp.mean(jnp.stack(list(terms.values()))) if terms \
        else jnp.asarray(0.0)
    return total, terms


def gauge_loss(phi_fn) -> Array:
    """phi(0,0)^2 — pins the potential's additive constant (:826-828)."""
    return phi_fn(jnp.zeros(2)) ** 2


def symmetry_loss(phi_fn, pairs_a: Array, pairs_b: Array) -> Array:
    """Mirror symmetry about the tip line (:831-852); point pairs
    precomputed host-side."""
    if pairs_a.shape[0] == 0:
        return jnp.asarray(0.0)
    pa = jax.vmap(phi_fn)(pairs_a)
    pb = jax.vmap(phi_fn)(pairs_b)
    return jnp.mean((pa - pb) ** 2)


def tip_stress_loss(phi_fn, tip_xy: Array, tip: tuple[float, float], *,
                    c: float = 0.25, s_eps: float = 1e-5,
                    r_weight_power: float = 0.5) -> Array:
    """Enforce the crack-tip amplitude tau_eq * sqrt(r) ~ c with
    1/r^pw weights (:715-736)."""
    if tip_xy.shape[0] == 0:
        return jnp.asarray(0.0)
    _, _, tau = stress(phi_fn, tip_xy)
    r = jnp.sqrt((tip_xy[:, 0] - tip[0]) ** 2
                 + (tip_xy[:, 1] - tip[1]) ** 2 + 1e-10)
    mism2 = (tau * jnp.sqrt(r + s_eps) - c) ** 2
    if r_weight_power <= 0:
        return jnp.mean(mism2)
    w = 1.0 / (r + s_eps) ** r_weight_power
    return jnp.sum(w * mism2) / (jnp.sum(w) + 1e-12)


def tip_ratio_loss(phi_fn, near_xy: Array, far_xy: Array, *,
                   target: float = 1.2) -> tuple[Array, Array]:
    """Hinge on the near/far equivalent-stress ratio (:739-761)."""
    _, _, tn = stress(phi_fn, near_xy)
    _, _, tf = stress(phi_fn, far_xy)
    ratio = jnp.mean(tn) / (jnp.mean(tf) + 1e-8)
    return jax.nn.relu(target - ratio) ** 2, ratio
