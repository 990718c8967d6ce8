"""BSplineKAN (efficient-kan parity): shapes, lstsq refit, grid update."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models.bspline import BSplineKAN, BSplineKANChain


@pytest.fixture
def layer():
    return BSplineKAN(2, 10, grid_size=5, spline_order=3)


@pytest.fixture
def lparams(layer):
    return layer.init(jax.random.PRNGKey(0))


def test_shapes_and_counts(layer, lparams):
    assert lparams["grid"].shape == (2, 5 + 2 * 3 + 1)
    assert lparams["coeff"].shape == (2, 8, 10)
    assert lparams["base_w"].shape == (2, 10)
    y = layer.apply(lparams, jnp.ones((7, 2)) * 0.3)
    assert y.shape == (7, 10)


def test_curve2coeff_roundtrip(layer, lparams):
    """Fitting values produced by known coefficients recovers them (the
    lstsq system is exactly determined on enough samples)."""
    from kanodes.ops import basis as B
    grid = lparams["grid"]
    key = jax.random.PRNGKey(1)
    coeff_true = jax.random.normal(key, (2, 8, 10))
    x = jnp.stack([jnp.linspace(-0.9, 0.9, 50),
                   jnp.linspace(-0.8, 0.8, 50)], axis=-1)
    bas = B.bspline_basis(x, grid, 3)
    y = jnp.einsum("nig,igo->nio", bas, coeff_true)
    coeff_fit = layer.curve2coeff(x, y, grid)
    np.testing.assert_allclose(coeff_fit, coeff_true, rtol=1e-2, atol=1e-3)


def test_update_grid_preserves_function(layer, lparams):
    """After a quantile grid refit the layer computes (nearly) the same
    function on the sample range (efficientkan.py:168-215 contract)."""
    key = jax.random.PRNGKey(2)
    x = jax.random.normal(key, (256, 2)) * 0.4
    y_before = layer.apply(lparams, x)
    new_params = layer.update_grid(lparams, x)
    assert new_params["grid"].shape == lparams["grid"].shape
    assert not np.allclose(new_params["grid"], lparams["grid"])
    y_after = layer.apply(new_params, x)
    err = float(jnp.abs(y_after - y_before).max())
    scale = float(jnp.abs(y_before).max()) + 1e-8
    assert err / scale < 0.05, (err, scale)


def test_gradients_flow_but_not_into_grid(layer, lparams):
    x = jnp.ones((4, 2)) * 0.2

    def loss(p):
        return jnp.sum(layer.apply(p, x) ** 2)

    g = jax.grad(loss)(lparams)
    assert float(jnp.abs(g["grid"]).max()) == 0.0
    assert float(jnp.abs(g["coeff"]).max()) > 0.0
    assert float(jnp.abs(g["base_w"]).max()) > 0.0


def test_chain_and_reg(layer):
    chain = BSplineKANChain([2, 10, 2], grid_size=5)
    params = chain.init(jax.random.PRNGKey(3))
    x = jnp.ones((6, 2)) * 0.1
    y = chain.apply(params, x)
    assert y.shape == (6, 2)
    reg = chain.regularization_loss(params)
    assert float(reg) > 0
    new_params = chain.update_grids(params, jax.random.normal(
        jax.random.PRNGKey(4), (128, 2)) * 0.5)
    y2 = chain.apply(new_params, x)
    assert y2.shape == (6, 2) and bool(jnp.all(jnp.isfinite(y2)))


def test_ode_integration_with_bspline_kan():
    """The torchdiffeq-flavor LV setup (predator_prey.py:101,142):
    B-spline KAN chain as neural-ODE RHS."""
    from kanodes.ode import odeint_fixed
    chain = BSplineKANChain([2, 10, 2], grid_size=5)
    params = chain.init(jax.random.PRNGKey(5))

    def rhs(t, u, p):
        return chain.apply(p, u)

    ts = jnp.linspace(0.0, 1.0, 5)
    ys = odeint_fixed(rhs, jnp.asarray([1.0, 1.0]), ts, params,
                      solver="rk4", substeps=2)
    assert ys.shape == (5, 2) and bool(jnp.all(jnp.isfinite(ys)))

    def loss(p):
        return jnp.sum(odeint_fixed(rhs, jnp.asarray([1.0, 1.0]), ts, p,
                                    solver="rk4", substeps=2) ** 2)

    g = jax.grad(loss)(params)
    assert all(bool(jnp.all(jnp.isfinite(l)))
               for l in jax.tree_util.tree_leaves(g))
