"""Hybrid model, normalizer, edge pruning, evaluation harness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.experiments.lv import LVConfig, make_data
from kanodes.models.bspline import BSplineKAN, BSplineKANChain
from kanodes.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes.sparsify.edge_prune import (edge_magnitudes, prune_edges,
                                         prune_chain_edges)
from kanodes.train.harness import (HarnessConfig, time_ordered_split,
                                   curriculum_train, evaluate_model,
                                   robustness_test, compare_models)


def test_hybrid_blend():
    m = HybridKANMLP([2, 8, 2], grid_size=5, mlp_hidden=16)
    p = m.init(jax.random.PRNGKey(0))
    y = m.apply(p, jnp.ones((4, 2)) * 0.2)
    assert y.shape == (4, 2)
    assert m.blend(p) == pytest.approx(0.5)
    # gate at +inf -> pure KAN
    p2 = dict(p, gate=jnp.asarray(50.0))
    np.testing.assert_allclose(m.apply(p2, jnp.ones((4, 2)) * 0.2),
                               m.kan.apply(p["kan"], jnp.ones((4, 2)) * 0.2),
                               rtol=1e-5)
    # gate trains
    g = jax.grad(lambda p: jnp.sum(m.apply(p, jnp.ones((2, 2))) ** 2))(p)
    assert float(jnp.abs(g["gate"])) > 0


def test_normalizer_roundtrip_and_rhs():
    X = np.asarray([[0.0, 1.0], [2.0, 5.0], [1.0, 3.0]])
    nm = DataNormalizer.fit(X)
    z = nm.normalize(jnp.asarray(X))
    assert float(z.min()) == -1.0 and float(z.max()) == 1.0
    np.testing.assert_allclose(nm.denormalize(z), X, rtol=1e-6)

    # chain rule: for du/dt = c, dz/dt = c / scale
    c = jnp.asarray([2.0, 4.0])
    rhs = nm.wrap_rhs(lambda t, u, p: c)
    out = rhs(0.0, jnp.zeros(2), None)
    np.testing.assert_allclose(out, np.asarray(c) / nm.scale, rtol=1e-6)


def test_edge_pruning():
    l = BSplineKAN(3, 4, grid_size=5)
    p = l.init(jax.random.PRNGKey(1))
    # force one strong edge, weak others
    p["coeff"] = p["coeff"].at[:].set(1e-6).at[0, :, 0].set(1.0)
    mag = edge_magnitudes(p)
    assert float(mag[0, 0]) > 0.5
    q, mask = prune_edges(p, threshold=0.1)
    assert float(mask.sum()) == 1.0
    assert float(jnp.abs(q["coeff"][1:, :, :]).max()) == 0.0
    newp, masks, n_pruned = prune_chain_edges([p], 0.1)
    assert n_pruned == 11


@pytest.fixture(scope="module")
def lv_setup():
    from kanodes.models import KANChain
    cfg = LVConfig()
    data = make_data(cfg)
    model = KANChain.mlp_like([2, 10, 2], grid_len=5)
    params = model.init(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(lambda a: a * 1e-3, params)
    return data, model, params


def test_split_and_curriculum(lv_setup):
    data, model, params = lv_setup
    cfg = HarnessConfig(curriculum_horizons=(0.5, 1.0),
                        curriculum_iters=(50, 50))
    ts, X = np.asarray(data["ts"]), np.asarray(data["X"])
    (tr, _), (va, _), (te, _) = time_ordered_split(ts, X, cfg)
    assert len(tr) == 98 and len(va) == 21 and len(te) == 22
    out = curriculum_train(model, params, ts[:36], X[:36], cfg)
    assert len(out["stages"]) == 2
    assert np.isfinite([s["final_loss"] for s in out["stages"]]).all()


def test_evaluate_and_robustness(lv_setup):
    data, model, params = lv_setup
    cfg = HarnessConfig()
    ts, X = np.asarray(data["ts"])[:36], np.asarray(data["X"])[:36]
    m = evaluate_model(model, params, ts, X, cfg)
    assert set(m) >= {"mse", "mae", "rmse", "max_error", "horizon_mse",
                      "stability"}
    rob = robustness_test(model, params, ts, X, cfg)
    assert set(rob["noise"]) == {0.0, 0.01, 0.05}
    assert len(rob["perturbed_ics"]) == 3


def test_compare_models(lv_setup):
    data, model, params = lv_setup
    ts, X = np.asarray(data["ts"])[:36], np.asarray(data["X"])[:36]
    rep = compare_models({"kan": (model, params)}, ts, X)
    assert "kan" in rep and "robustness" in rep["kan"]


def test_test_horizon_excludes_seeded_ic(lv_setup):
    """The test-horizon rollout is seeded from the last TRAIN state; the
    seeded row must not count toward the metrics (it would trivially
    match itself and deflate the error)."""
    data, model, params = lv_setup
    ts, X = np.asarray(data["ts"])[:40], np.asarray(data["X"])[:40]
    cfg = HarnessConfig()
    (ts_tr, X_tr), _, (ts_te, X_te) = time_ordered_split(ts, X, cfg)

    rep = compare_models({"kan": (model, params)}, ts, X, cfg)
    got = rep["kan"]["test_horizon"]["mse"]

    # reproduce by hand: integrate from X_tr[-1] over [ts_tr[-1], *ts_te],
    # score only the test rows
    from kanodes.ode import odeint_fixed
    ts_roll = jnp.asarray(np.concatenate([ts_tr[-1:], ts_te]))
    pred = odeint_fixed(lambda t, u, p: model.apply(p, u),
                        jnp.asarray(X_tr[-1]), ts_roll, params,
                        solver="tsit5")
    want = float(jnp.mean((pred[1:] - jnp.asarray(X_te)) ** 2))
    assert got == pytest.approx(want, rel=1e-5)
    # and the seeded-row-included value differs (first row is exact)
    with_ic = float(jnp.mean(
        (pred - jnp.concatenate([jnp.asarray(X_tr[-1:]),
                                 jnp.asarray(X_te)])) ** 2))
    assert with_ic < want  # including the free-match row deflates MSE


def test_ensemble_seeds_cpu():
    from kanodes.experiments.sweep import ensemble_seeds
    res = ensemble_seeds(n=4, iters=80)
    assert res["final_losses"].shape == (4,)
    assert np.isfinite(res["final_losses"]).all()
    assert np.isfinite(res["test_losses"]).all()
