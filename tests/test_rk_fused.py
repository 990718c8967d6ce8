"""Whole-RK-step kernels vs the composed XLA reference (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models import KANChain
from kanodes.ode import odeint_fixed
from kanodes.ops.kan_chain import chain_spec_of, fused_params
from kanodes.ops.rk_fused import fused_rk_step, fused_odeint


@pytest.fixture
def setup():
    chain = KANChain.mlp_like([2, 10, 2], grid_len=5)
    params = chain.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda a: a * 0.5, params)
    spec = chain_spec_of(chain)
    return chain, params, spec


@pytest.mark.parametrize("solver", ["tsit5", "rk4"])
def test_fused_step_matches_rk_step(setup, solver):
    chain, params, spec = setup
    x = jnp.asarray([[1.0, 1.0], [0.5, 2.0]])
    dt = 0.1
    y = fused_rk_step(spec, solver, dt, x, *fused_params(params))

    def rhs(t, u, p):
        return chain.apply(p, u)

    ts = jnp.asarray([0.0, dt])
    want = jax.vmap(lambda xi: odeint_fixed(rhs, xi, ts, params,
                                            solver=solver)[-1])(x)
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-6)


def test_fused_step_gradients_match(setup):
    chain, params, spec = setup
    x = jnp.asarray([[1.0, 1.0], [2.0, 0.3], [0.4, 0.9]])
    dt = 0.1
    tgt = x * 1.05

    def loss_fused(params, x):
        y = fused_rk_step(spec, "tsit5", dt, x, *fused_params(params))
        return jnp.mean((y - tgt) ** 2)

    def rhs(t, u, p):
        return chain.apply(p, u)

    def loss_ref(params, x):
        ts = jnp.asarray([0.0, dt])
        y = jax.vmap(lambda xi: odeint_fixed(rhs, xi, ts, params,
                                             solver="tsit5")[-1])(x)
        return jnp.mean((y - tgt) ** 2)

    gf = jax.grad(loss_fused, argnums=(0, 1))(params, x)
    gr = jax.grad(loss_ref, argnums=(0, 1))(params, x)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gr)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


def test_fused_odeint_trajectory(setup):
    chain, params, spec = setup
    x0 = jnp.asarray([[1.0, 1.0]])
    ys = fused_odeint(spec, "tsit5", 0.1, 10, x0, *fused_params(params))
    assert ys.shape == (11, 1, 2)

    def rhs(t, u, p):
        return chain.apply(p, u)

    ts = jnp.linspace(0.0, 1.0, 11)
    want = odeint_fixed(rhs, x0[0], ts, params, solver="tsit5")
    np.testing.assert_allclose(ys[:, 0, :], want, rtol=1e-4, atol=1e-5)


def test_fsal_stage_pruned():
    from kanodes.ode.tableaus import TSIT5
    from kanodes.ops.rk_fused import _needed_stages
    needed = _needed_stages(TSIT5)
    assert needed == [True] * 6 + [False]   # 7th (FSAL) stage unused


def test_multistep_matches_scanned_steps(setup):
    from kanodes.ops.rk_fused import fused_rk_multistep
    chain, params, spec = setup
    fp = fused_params(params)
    x0 = jnp.asarray([[1.0, 1.0], [0.4, 2.0]])
    dt, n = 0.1, 7
    ys = fused_rk_multistep(spec, "tsit5", dt, n, x0, *fp)
    assert ys.shape == (n, 2, 2)
    # reference: scan of single fused steps
    x = x0
    for s in range(n):
        x = fused_rk_step(spec, "tsit5", dt, x, *fp)
        np.testing.assert_allclose(ys[s], x, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_multistep_gradients_match_scan(setup):
    from kanodes.ops.rk_fused import fused_rk_multistep
    chain, params, spec = setup
    x0 = jnp.asarray([[1.0, 1.0]])
    dt, n = 0.1, 6
    tgt = jnp.linspace(0.8, 1.3, n)[:, None, None] * x0

    def loss_multi(params, x0):
        fp = fused_params(params)
        ys = fused_rk_multistep(spec, "tsit5", dt, n, x0, *fp)
        return jnp.mean((ys - tgt) ** 2)

    def loss_scan(params, x0):
        fp = fused_params(params)
        x, acc = x0, 0.0
        for s in range(n):
            x = fused_rk_step(spec, "tsit5", dt, x, *fp)
            acc = acc + jnp.mean((x - tgt[s]) ** 2)
        return acc / n

    gm = jax.grad(loss_multi, argnums=(0, 1))(params, x0)
    gs = jax.grad(loss_scan, argnums=(0, 1))(params, x0)
    for a, b in zip(jax.tree_util.tree_leaves(gm),
                    jax.tree_util.tree_leaves(gs)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6)


def test_bwd_precision_validated_at_call():
    """Invalid bwd_precision fails fast with a clear error, not a
    KeyError at backward-trace time."""
    import pytest

    from kanodes.models import KDense
    from kanodes.models.core import Chain
    from kanodes.ops.kan_chain import chain_spec_of, fused_params
    from kanodes.ops.rk_fused import fused_rk_multistep, fused_rk_step

    chain = Chain(KDense(2, 4, 5), KDense(4, 2, 5))
    spec = chain_spec_of(chain)
    params = chain.init(jax.random.PRNGKey(0))
    c1, w1, c2, w2 = fused_params(params)
    x = jnp.ones((1, 2), jnp.float32)
    with pytest.raises(ValueError, match="bwd_precision"):
        fused_rk_step(spec, "rk4", 0.1, x, c1, w1, c2, w2,
                      bwd_precision="bf16")
    with pytest.raises(ValueError, match="bwd_precision"):
        fused_rk_multistep(spec, "rk4", 0.1, 3, x, c1, w1, c2, w2,
                           bwd_precision="f32")


@pytest.mark.parametrize("basis", ["iqf", "rswaf"])
def test_fused_multistep_alt_basis_matches_xla(basis):
    """Whole-trajectory multistep kernel with the alternate LOCAL bases:
    rollout and loss-gradient parity vs the XLA integrator."""
    from kanodes.ops.rk_fused import fused_rk_multistep

    chain = KANChain.mlp_like([2, 10, 2], grid_len=5, basis=basis)
    params = jax.tree_util.tree_map(
        lambda a: a * 0.5, chain.init(jax.random.PRNGKey(3)))
    spec = chain_spec_of(chain)
    fp = fused_params(params)
    x0 = jnp.asarray([[1.0, 1.0]])
    dt, n = 0.1, 5
    ys = fused_rk_multistep(spec, "tsit5", dt, n, x0, *fp)

    def rhs(t, u, p):
        return chain.apply(p, u)

    ts = jnp.asarray(np.arange(n + 1) * dt, jnp.float32)
    want = odeint_fixed(rhs, x0[0], ts, params, solver="tsit5")
    np.testing.assert_allclose(ys[:, 0, :], want[1:], rtol=1e-5, atol=1e-6)

    tgt = jnp.ones((n, 1, 2))

    def loss_fused(p):
        fp = fused_params(p)
        return jnp.mean((fused_rk_multistep(spec, "tsit5", dt, n, x0,
                                            *fp) - tgt) ** 2)

    def loss_ref(p):
        ys = odeint_fixed(rhs, x0[0], ts, p, solver="tsit5")[1:]
        return jnp.mean((ys[:, None, :] - tgt) ** 2)

    gf = jax.grad(loss_fused)(params)
    gr = jax.grad(loss_ref)(params)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gr)):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-5)
