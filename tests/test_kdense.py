"""KDense layer: shapes, parameter counts, math parity with the reference
formulation (kdense.jl:109-130), edge-activation consistency."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models import KDense, KDense1, KANChain, MLP
from kanodes.models.core import count_params
from kanodes.ops import basis as B


def test_param_count_matches_reference():
    # kdense.jl:98-107: I*G*O + I*O (with base act)
    l = KDense(2, 10, 5)
    p = l.init(jax.random.PRNGKey(0))
    assert count_params(p) == 2 * 5 * 10 + 2 * 10 == l.num_params()
    l2 = KDense(2, 10, 5, use_base_act=False)
    assert count_params(l2.init(jax.random.PRNGKey(0))) == 100


def test_forward_shape_and_batching():
    l = KDense(3, 7, 5)
    p = l.init(jax.random.PRNGKey(1))
    x = jnp.ones((4, 6, 3))
    y = l.apply(p, x)
    assert y.shape == (4, 6, 7)
    # vmap consistency
    y2 = jax.vmap(lambda xi: l.apply(p, xi))(x.reshape(24, 3).reshape(24, 3))
    np.testing.assert_allclose(y.reshape(24, 7), y2, rtol=1e-5, atol=1e-6)


def test_forward_matches_manual_math():
    """y = C[i,g,o] * rbf(tanh(x)) summed over (i,g)  +  W.T swish(x)."""
    l = KDense(2, 3, 5)
    p = l.init(jax.random.PRNGKey(2))
    x = jnp.asarray([[0.3, -1.2], [2.0, 0.05]])
    xn = jnp.tanh(x)
    bas = B.rbf(xn, l.grid(), l.h)                       # [2, 2, 5]
    want = jnp.einsum("kig,igo->ko", bas, p["C"])
    want = want + B.swish(x) @ p["W"]
    np.testing.assert_allclose(l.apply(p, x), want, rtol=1e-5, atol=1e-6)


def test_edge_activations_sum_to_forward():
    # the Activation_getter.jl:33-36 self-consistency check, as a real test
    l = KDense(4, 6, 7, basis="rswaf")
    p = l.init(jax.random.PRNGKey(3))
    x = jax.random.normal(jax.random.PRNGKey(4), (9, 4))
    acts = l.edge_activations(p, x)                      # [9, 4, 6]
    np.testing.assert_allclose(acts.sum(axis=-2), l.apply(p, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("basis", ["rbf", "rswaf", "iqf"])
def test_gradients_finite(basis):
    l = KDense(2, 5, 5, basis=basis)
    p = l.init(jax.random.PRNGKey(5))
    x = jax.random.normal(jax.random.PRNGKey(6), (3, 2))

    def loss(p):
        return jnp.sum(l.apply(p, x) ** 2)

    g = jax.grad(loss)(p)
    for leaf in jax.tree_util.tree_leaves(g):
        assert jnp.all(jnp.isfinite(leaf))
        assert float(jnp.abs(leaf).max()) > 0


def test_chain_canonical_lv_shape():
    # LV_driver_KANODE.jl:136-142 — [2, 10, 2], grid 5
    net = KANChain.mlp_like([2, 10, 2], grid_len=5)
    p = net.init(jax.random.PRNGKey(7))
    assert net.num_params() == (2 * 5 * 10 + 2 * 10) + (10 * 5 * 2 + 10 * 2)
    y = net.apply(p, jnp.ones((2,)))
    assert y.shape == (2,)


def test_kdense1_shapes():
    l = KDense1(3, 4, 6)
    p = l.init(jax.random.PRNGKey(8))
    assert count_params(p) == 3 * (6 + 4) == l.num_params()
    y = l.apply(p, jnp.ones((5, 3)))
    assert y.shape == (5, 4)


def test_mlp_baseline():
    # LV_driver_MLP.jl:61 — Dense(2=>50, tanh), Dense(50=>2)
    m = MLP((2, 50, 2))
    p = m.init(jax.random.PRNGKey(9))
    assert m.num_params() == 2 * 50 + 50 + 50 * 2 + 2
    y = m.apply(p, jnp.ones((7, 2)))
    assert y.shape == (7, 2)


def test_jit_and_no_recompile_across_params():
    l = KDense(2, 10, 5)
    p = l.init(jax.random.PRNGKey(10))
    f = jax.jit(l.apply)
    x = jnp.ones((3, 2))
    y1 = f(p, x)
    p2 = jax.tree_util.tree_map(lambda a: a * 2, p)
    y2 = f(p2, x)
    assert y1.shape == y2.shape == (3, 10)


def test_trainable_grid_variant():
    """Adaptive-basis extension: center offsets + log-bandwidth train."""
    l = KDense(2, 4, 5, trainable_grid=True)
    p = l.init(jax.random.PRNGKey(11))
    assert "grid_offset" in p and "log_h" in p
    x = jax.random.normal(jax.random.PRNGKey(12), (6, 2))

    def loss(p):
        return jnp.sum(l.apply(p, x) ** 2)

    g = jax.grad(loss)(p)
    assert float(jnp.abs(g["grid_offset"]).max()) > 0
    assert float(jnp.abs(g["log_h"])) > 0
    # offsets zero at init -> identical to the static-grid layer
    l0 = KDense(2, 4, 5)
    p0 = {k: v for k, v in p.items() if k in ("C", "W")}
    np.testing.assert_allclose(l.apply(p, x), l0.apply(p0, x),
                               rtol=1e-6, atol=1e-7)
