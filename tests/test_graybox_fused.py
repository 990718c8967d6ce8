"""Gray-box fused RK kernel vs the XLA gray-box RHS."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models import KDense
from kanodes.ode import odeint_fixed
from kanodes.ops.graybox_fused import (GrayboxSpec,
                                       fused_graybox_rk_step,
                                       graybox_kernel_adapter)
from kanodes.pde import datagen
from kanodes.utils.precision import matmul_precision


@pytest.fixture
def setup():
    layer = KDense(1, 1, 10, normalizer="softsign")
    params = layer.init(jax.random.PRNGKey(0))
    n, dx, D = 26, 0.04, 0.01
    lap = jnp.asarray(datagen._cyclic_lap(n, dx), jnp.float32)
    return layer, params, lap, D, n


def _xla_rhs(layer, lap, D):
    def rhs(t, u, p):
        known = D * jnp.matmul(lap, u, precision=matmul_precision())
        return known + layer.apply(p, u[:, None])[:, 0]
    return rhs


def test_forward_matches_xla(setup):
    layer, params, lap, D, n = setup
    spec, advance = graybox_kernel_adapter(layer, lap, D)
    u0 = jnp.asarray(0.4 + 0.3 * np.sin(np.arange(n)), jnp.float32)
    ys = advance(params, u0, 0.05, 3)
    assert ys.shape == (4, n)
    rhs = _xla_rhs(layer, lap, D)
    ts = jnp.asarray([0.0, 0.05, 0.1, 0.15])
    want = odeint_fixed(rhs, u0, ts, params, solver="tsit5")
    np.testing.assert_allclose(ys, want, rtol=2e-4, atol=1e-5)


def test_gradients_match_xla(setup):
    layer, params, lap, D, n = setup
    spec, advance = graybox_kernel_adapter(layer, lap, D)
    u0 = jnp.asarray(0.5 + 0.2 * np.cos(np.arange(n)), jnp.float32)
    tgt = u0 * 1.02

    def loss_fused(p):
        return jnp.mean((advance(p, u0, 0.05, 2)[-1] - tgt) ** 2)

    rhs = _xla_rhs(layer, lap, D)

    def loss_xla(p):
        ts = jnp.asarray([0.0, 0.1])
        return jnp.mean((odeint_fixed(rhs, u0, ts, p, solver="tsit5",
                                      substeps=2)[-1] - tgt) ** 2)

    gf = jax.grad(loss_fused)(params)
    gx = jax.grad(loss_xla)(params)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gx)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6)


def test_bwd_precision_option_threads(setup):
    """bwd_precision="tf32" must thread through the adapter and produce
    gradients agreeing with "highest" (identical math in CPU interpret
    mode, where there is no TF32; the compiled kernels are compared on
    the GPU by the chip-marked tests)."""
    layer, params, lap, D, n = setup
    u0 = jnp.asarray(0.5 + 0.2 * np.cos(np.arange(n)), jnp.float32)
    tgt = u0 * 1.02

    grads = {}
    for bp in ("highest", "tf32"):
        _, advance = graybox_kernel_adapter(layer, lap, D, bp)

        def loss(p):
            return jnp.mean((advance(p, u0, 0.05, 2)[-1] - tgt) ** 2)

        grads[bp] = jax.grad(loss)(params)
    for a, b in zip(jax.tree_util.tree_leaves(grads["highest"]),
                    jax.tree_util.tree_leaves(grads["tf32"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-9)


def test_rejects_non_pointwise_layer():
    with pytest.raises(ValueError):
        GrayboxSpec.of_layer(KDense(2, 1, 5))


def test_fused_2d_driver_matches_xla_driver():
    """SourceConfig(ndim=2, impl='fused'): the Kronecker-lap flattened
    path reproduces the 2-D roll-stencil XLA losses and gradients."""
    from kanodes.experiments.pde_source import (SourceConfig,
                                                make_data, make_fns,
                                                make_model)

    kw = dict(problem="fisher_kpp", ndim=2, grid_n=8, data_substeps=40,
              substeps=4)
    cfg_x = SourceConfig(**kw)
    cfg_f = SourceConfig(**kw, impl="fused")
    data = make_data(cfg_x)
    model = make_model(cfg_x)
    params = model.init(jax.random.PRNGKey(1))
    loss_x, _, pred_x = make_fns(cfg_x, model, data)
    loss_f, _, pred_f = make_fns(cfg_f, model, data)
    np.testing.assert_allclose(np.asarray(pred_f(params)),
                               np.asarray(pred_x(params)),
                               rtol=2e-4, atol=2e-5)
    lx, gx = jax.value_and_grad(loss_x)(params)
    lf, gf = jax.value_and_grad(loss_f)(params)
    np.testing.assert_allclose(float(lf), float(lx), rtol=1e-4, atol=1e-9)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gx)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-6)
