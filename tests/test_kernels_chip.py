"""Compiled-kernel parity on the GPU, at the reference widths.

Each Triton kernel is compared with the plain reference: the same chain
or gray-box RHS in `jax.numpy`, integrated by `odeint_fixed` at
`Precision.HIGHEST` (no TF32). Tolerances:
  * forward: rtol 1e-5 / atol 1e-6 — both sides are IEEE float32, only
    the summation order differs;
  * gradients (x and every parameter tensor): elementwise rtol 1e-4
    with an absolute floor of 1e-6 of the tensor's largest entry (a
    reverse sweep accumulates more rounding than the forward, and
    entries that cancel to near zero keep the absolute rounding of the
    terms they sum);
  * bwd_precision="tf32": rtol 2e-2 relative to the largest entry —
    TF32 keeps about three decimal digits per product.

Run on the card with `python -m pytest tests/test_kernels_chip.py -m chip`
(`chip_smoke.py` runs them as its last phase); on the CPU they skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models import KANChain, KDense
from kanodes.ode import odeint_fixed
from kanodes.ops.graybox_fused import (graybox_kernel_adapter,
                                       graybox_kron_kernel_adapter)
from kanodes.ops.kan_chain import chain_spec_of, fused_params
from kanodes.ops.rk_fused import fused_rk_multistep, fused_rk_step
from kanodes.pde import datagen

pytestmark = pytest.mark.chip

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-6
TF32_RTOL = 2e-2


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the Triton kernels are compiled only "
                    "there (the CPU tests run them in interpret mode)")


def _close_rel(got, want, rtol):
    """Every leaf within rtol of its largest entry."""
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        scale = max(float(np.max(np.abs(b))), 1e-30)
        err = float(np.max(np.abs(a - b))) / scale
        assert err <= rtol, f"relative error {err:.3e} > {rtol:.0e}"


def _close_grads(got, want):
    """Elementwise: |a - b| <= GRAD_RTOL |b| + GRAD_ATOL_FRAC max|b|."""
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        scale = float(np.max(np.abs(b)))
        excess = np.abs(a - b) / (GRAD_RTOL * np.abs(b)
                                  + GRAD_ATOL_FRAC * scale + 1e-30)
        print(f"grad {b.shape}: max |a-b|/max|b| "
              f"{float(np.max(np.abs(a - b))) / max(scale, 1e-30):.2e}, "
              f"tolerance used {float(np.max(excess)):.2f}x")
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * scale)


def _chain(widths, grid, seed=0):
    chain = KANChain.mlp_like(widths, grid_len=grid, normalizer="tanh")
    params = jax.tree_util.tree_map(
        lambda a: a * 0.5, chain.init(jax.random.PRNGKey(seed)))
    return chain, params


def _ref_solve(chain, x, params, dt, n):
    ts = jnp.arange(n + 1, dtype=jnp.float32) * dt
    rhs = lambda t, u, p: chain.apply(p, u)
    ys = jax.vmap(lambda xi: odeint_fixed(rhs, xi, ts, params,
                                          solver="tsit5")[1:])(x)
    return jnp.swapaxes(ys, 0, 1)                    # [n, K, I]


# the chains rk_fused.kernel_wins admits: an LV shooting batch (34
# segments) and a Burgers shooting batch
@pytest.mark.parametrize("widths,grid,K", [([2, 10, 2], 5, 34),
                                           ([41, 10, 41], 5, 5)])
@pytest.mark.parametrize("bwd_precision", ["highest", "tf32"])
def test_step_matches_reference(gpu, widths, grid, K, bwd_precision):
    chain, params = _chain(widths, grid)
    spec = chain_spec_of(chain)
    x = jax.random.uniform(jax.random.PRNGKey(1), (K, widths[0]),
                           minval=0.2, maxval=1.5)
    dt = 0.1
    y = jax.jit(lambda x, p: fused_rk_step(spec, "tsit5", dt, x,
                                           *fused_params(p)))(x, params)
    np.testing.assert_allclose(y, _ref_solve(chain, x, params, dt, 1)[0],
                               **FWD_TOL)
    tgt = x * 1.05

    def lf(p, x):
        return jnp.mean((fused_rk_step(spec, "tsit5", dt, x,
                                       *fused_params(p),
                                       bwd_precision) - tgt) ** 2)

    def lr(p, x):
        return jnp.mean((_ref_solve(chain, x, p, dt, 1)[0] - tgt) ** 2)

    gf = jax.jit(jax.grad(lf, argnums=(0, 1)))(params, x)
    gr = jax.jit(jax.grad(lr, argnums=(0, 1)))(params, x)
    if bwd_precision == "highest":
        _close_grads(gf, gr)
    else:
        _close_rel(gf, gr, TF32_RTOL)


# LV trajectory (35 Tsit5 steps, K=1) and a Burgers trajectory window
@pytest.mark.parametrize("widths,grid,n", [([2, 10, 2], 5, 35),
                                           ([41, 10, 41], 5, 20)])
def test_multistep_matches_reference(gpu, widths, grid, n):
    chain, params = _chain(widths, grid, seed=2)
    spec = chain_spec_of(chain)
    x0 = jnp.full((1, widths[0]), 0.7, jnp.float32)
    dt = 0.1 if widths[0] == 2 else 0.005
    ys = jax.jit(lambda x, p: fused_rk_multistep(
        spec, "tsit5", dt, n, x, *fused_params(p)))(x0, params)
    np.testing.assert_allclose(ys, _ref_solve(chain, x0, params, dt, n),
                               **FWD_TOL)
    tgt = jnp.ones((n, 1, widths[0]))

    def lf(p, x):
        return jnp.mean((fused_rk_multistep(spec, "tsit5", dt, n, x,
                                            *fused_params(p)) - tgt) ** 2)

    def lr(p, x):
        return jnp.mean((_ref_solve(chain, x, p, dt, n) - tgt) ** 2)

    _close_grads(jax.jit(jax.grad(lf, argnums=(0, 1)))(params, x0),
                 jax.jit(jax.grad(lr, argnums=(0, 1)))(params, x0))


@pytest.mark.parametrize("ndim", [1, 2])
def test_graybox_step_matches_reference(gpu, ndim):
    """Fisher-KPP source recovery: 26 nodes (1-D) and a 32x32 field with
    the Kronecker Laplacian (2-D)."""
    layer = KDense(1, 1, 10, normalizer="softsign")
    params = layer.init(jax.random.PRNGKey(0))
    # dt inside Tsit5's real-axis stability bound (~3.3) for the stiffest
    # diffusion mode: lambda*dt = 4*D/dx^2*dt = 1.25 (1-D) and
    # 8*D/dx^2*dt = 1.64 (2-D). Beyond it, rounding noise in the
    # checkerboard mode grows every step and no two float32 orders agree.
    D, n_steps = 0.01, 3
    dt = 0.05 if ndim == 1 else 0.02
    if ndim == 1:
        n, dx = 26, 0.04
        lap = jnp.asarray(datagen._cyclic_lap(n, dx), jnp.float32)
        _, advance = graybox_kernel_adapter(layer, lap, D)
        u0 = jnp.asarray(0.4 + 0.3 * np.sin(np.arange(n)), jnp.float32)

        def rhs(t, u, p):
            return D * jnp.matmul(lap, u, precision="highest") + \
                layer.apply(p, u[:, None])[:, 0]
    else:
        n, dx = 32, 1.0 / 32
        lap1 = jnp.asarray(datagen._cyclic_lap(n, dx), jnp.float32)
        _, advance = graybox_kron_kernel_adapter(layer, lap1, D)
        ij = np.add.outer(np.arange(n), np.arange(n))
        u0 = jnp.asarray(0.4 + 0.3 * np.sin(ij / 3.0), jnp.float32)

        def rhs(t, u, p):
            # the Kronecker-sum Laplacian in the kernel's own form (the
            # roll stencil sums the same terms in another order, which
            # at 1/dx^2 = 1024 differs by ~1e-5)
            lap_u = jnp.matmul(lap1, u, precision="highest") + \
                jnp.matmul(u, lap1, precision="highest")
            return D * lap_u + layer.apply(
                p, u.reshape(-1, 1)).reshape(u.shape)

    ts = jnp.arange(n_steps + 1, dtype=jnp.float32) * dt
    ys = jax.jit(lambda p: advance(p, u0, dt, n_steps))(params)
    want = odeint_fixed(rhs, u0, ts, params, solver="tsit5")
    np.testing.assert_allclose(ys, want, **FWD_TOL)
    tgt = u0 * 1.02

    def lf(p, u):
        return jnp.mean((advance(p, u, dt, n_steps)[-1] - tgt) ** 2)

    def lr(p, u):
        return jnp.mean((odeint_fixed(rhs, u, ts, p,
                                      solver="tsit5")[-1] - tgt) ** 2)

    _close_grads(jax.jit(jax.grad(lf, argnums=(0, 1)))(params, u0),
                 jax.jit(jax.grad(lr, argnums=(0, 1)))(params, u0))
