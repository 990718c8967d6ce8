"""Activation extraction, pruning, grid refit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models import KANChain
from kanodes.sparsify.activations import (chain_activations,
                                          activation_magnitudes)
from kanodes.sparsify.prune import node_scores, prune


@pytest.fixture
def chain():
    return KANChain.mlp_like([2, 10, 2], grid_len=5)


@pytest.fixture
def cparams(chain):
    return chain.init(jax.random.PRNGKey(0))


@pytest.fixture
def xs():
    return jax.random.uniform(jax.random.PRNGKey(1), (64, 2),
                              minval=0.1, maxval=4.0)


def test_activations_sum_to_chain_forward(chain, cparams, xs):
    ca = chain_activations(chain, cparams, xs)
    assert len(ca.acts) == 2
    assert ca.acts[0].shape == (64, 2, 10)
    assert ca.acts[1].shape == (64, 10, 2)
    # layer-2 acts evaluated at layer-1 outputs; total sum == forward
    y = ca.acts[1].sum(axis=-2)
    np.testing.assert_allclose(y, chain.apply(cparams, xs),
                               rtol=1e-4, atol=1e-5)


def test_edge_curves(chain, cparams, xs):
    ca = chain_activations(chain, cparams, xs)
    x_vals, phi_vals = ca.edge_curves(0, 1, 3)
    assert x_vals.shape == (64,) and phi_vals.shape == (64,)
    np.testing.assert_allclose(x_vals, xs[:, 1])


def test_prune_drops_weak_nodes(chain, cparams, xs):
    # zero out everything flowing through nodes 3..9 -> only 0,1,2 survive
    p1, p2 = cparams
    mask = jnp.zeros((10,)).at[:3].set(1.0)
    cparams = [
        {"C": p1["C"] * mask[None, None, :], "W": p1["W"] * mask[None, :]},
        {"C": p2["C"] * mask[:, None, None], "W": p2["W"] * mask[:, None]},
    ]
    res = prune(chain, cparams, xs, threshold=1e-4)
    assert list(res.kept) == [0, 1, 2]
    assert res.chain.layers[0].out_dims == 3
    assert res.chain.layers[1].in_dims == 3
    # pruned forward == original forward (dropped nodes carried nothing)
    y_old = chain.apply(cparams, xs)
    y_new = res.chain.apply(res.params, xs)
    np.testing.assert_allclose(y_new, y_old, rtol=1e-4, atol=1e-5)


def test_prune_keeps_at_least_one(chain, cparams, xs):
    res = prune(chain, cparams, xs, threshold=1e9)
    assert res.kept.size == 1


def test_pruned_chain_trains(chain, cparams, xs):
    import optax
    res = prune(chain, cparams, xs, threshold=0.0)  # keep all -> same shape
    assert res.chain.layers[0].out_dims == 10
    res2 = prune(chain, cparams, xs,
                 threshold=float(np.median(res.scores)))
    tgt = jnp.ones((64, 2))

    def loss(p):
        return jnp.mean((res2.chain.apply(p, xs) - tgt) ** 2)

    opt = optax.adam(1e-2)
    p, s = res2.params, opt.init(res2.params)
    l0 = float(loss(p))
    for _ in range(60):
        g = jax.grad(loss)(p)
        u, s = opt.update(g, s, p)
        p = optax.apply_updates(p, u)
    assert float(loss(p)) < l0


def test_grid_refine_rejects_trainable_grid():
    import pytest

    from kanodes.models import KANChain
    from kanodes.sparsify.grid_refine import refine_kdense_chain_grid

    chain = KANChain.mlp_like([2, 4, 2], grid_len=5, trainable_grid=True)
    params = chain.init(jax.random.PRNGKey(0))
    x = jnp.ones((8, 2), jnp.float32)
    with pytest.raises(ValueError, match="trainable_grid"):
        refine_kdense_chain_grid(chain, params, x)
