"""Training loop + LV experiment end-to-end slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.experiments.lv import (LVConfig, make_data, make_model,
                                    make_ode_fns, init_params, run,
                                    lv_rhs_truth)
from kanodes.sparsify.regularization import (l1_entropy_reg, l2_reg,
                                             spline_smoothness_reg)
from kanodes.train.loop import TrainConfig, train


def test_train_loop_quadratic_converges():
    target = jnp.asarray([1.0, -2.0, 0.5])

    def loss(p):
        return jnp.sum((p - target) ** 2)

    out = train(loss, jnp.zeros(3), TrainConfig(lr=0.05, iters=500,
                                                eval_every=100))
    np.testing.assert_allclose(out["params"], target, atol=1e-2)
    assert out["loss_history"].shape == (500,)
    assert out["eval_history"].shape == (5,)
    assert float(out["best_loss"]) <= float(out["loss_history"][0])


def test_train_best_params_match_best_loss():
    """best_params must be the exact point best_loss was measured at —
    not one optimizer step past it (regression: at the f32 floor one
    Adam step moves the loss 3x, measured on the 2-D AC surrogate)."""
    target = jnp.asarray([1.0, -2.0, 0.5])

    def loss(p):
        return jnp.sum((p - target) ** 2)

    # large lr so the iterates oscillate around the minimum: the argmin
    # is then interior and the off-by-one would be visible
    out = train(loss, jnp.zeros(3), TrainConfig(lr=0.4, iters=200,
                                                eval_every=50))
    assert float(loss(out["best_params"])) == float(out["best_loss"])
    assert float(out["best_loss"]) == float(jnp.min(out["loss_history"]))


def test_train_loop_host_chunking_equivalence():
    """Chunked device calls must match a single-call run exactly."""
    def loss(p):
        return jnp.sum((p - 3.0) ** 2)

    a = train(loss, jnp.zeros(2), TrainConfig(lr=0.1, iters=200,
                                              eval_every=50,
                                              max_iters_per_call=200))
    b = train(loss, jnp.zeros(2), TrainConfig(lr=0.1, iters=200,
                                              eval_every=50,
                                              max_iters_per_call=50))
    np.testing.assert_allclose(a["params"], b["params"], rtol=1e-6)
    np.testing.assert_allclose(a["loss_history"], b["loss_history"],
                               rtol=1e-6)


def test_lv_data_matches_truth_dynamics():
    cfg = LVConfig()
    data = make_data(cfg)
    X, ts = data["X"], data["ts"]
    assert X.shape == (141, 2) and data["n_train"] == 35
    # cross-check host f64 data gen against the on-device adaptive solver
    from kanodes.ode import odeint
    ys = odeint(lambda t, u, a: lv_rhs_truth(t, u), X[0], ts, None,
                rtol=1e-8, atol=1e-10, max_steps=8192, adjoint="none")
    np.testing.assert_allclose(ys, X, rtol=2e-3, atol=2e-3)


def test_lv_short_training_reduces_loss():
    cfg = LVConfig(iters=800, eval_every=400)
    out = run(cfg)
    h = np.asarray(out["loss_history"])
    assert np.isfinite(h).all()
    assert h[-1] < h[0] * 0.5, (h[0], h[-1])


def test_lv_mlp_baseline_trains():
    cfg = LVConfig(model="mlp", iters=300, eval_every=300, lr=1e-2,
                   init_scale=1.0)
    out = run(cfg)
    h = np.asarray(out["loss_history"])
    assert np.isfinite(h).all() and h[-1] < h[0]


def test_lv_deep_kan_chain_trains():
    """kan_widths builds a depth-3 [2,w,w,2] KDense chain (the
    beyond-parity Fig-3C KAN3 trend points) and trains on the XLA path."""
    cfg = LVConfig(kan_widths=(2, 4, 4, 2), iters=300, eval_every=300)
    model = make_model(cfg)
    assert len(model.layers) == 3
    assert model.num_params() == 6 * (2 * 4 + 4 * 4 + 4 * 2)
    out = run(cfg)
    h = np.asarray(out["loss_history"])
    assert np.isfinite(h).all() and h[-1] < h[0]


def test_lv_adaptive_mode_runs():
    cfg = LVConfig(iters=30, eval_every=30, solve_mode="adaptive",
                   max_steps=128)
    out = run(cfg)
    assert np.isfinite(np.asarray(out["loss_history"])).all()


def test_reg_loss_values():
    # uniform magnitudes -> entropy = log(n)
    p = {"a": jnp.ones(4), "b": jnp.ones(4)}
    val = l1_entropy_reg(p, act_reg=0.0, entropy_reg=1.0)
    np.testing.assert_allclose(float(val), np.log(8), rtol=1e-5)
    val2 = l1_entropy_reg(p, act_reg=2.0, entropy_reg=0.0)
    np.testing.assert_allclose(float(val2), 16.0, rtol=1e-6)
    assert float(l2_reg(p)) == 8.0


def test_spline_smoothness_reg():
    C = jnp.arange(12.0).reshape(1, 12, 1)  # linear ramp -> zero 2nd diff
    assert float(spline_smoothness_reg([{"C": C}])) == 0.0
    C2 = jnp.asarray([0.0, 1.0, 0.0]).reshape(1, 3, 1)
    np.testing.assert_allclose(
        float(spline_smoothness_reg([{"C": C2}])), 4.0)


def test_lv_sparse_mode_penalizes():
    cfg_d = LVConfig(iters=50, eval_every=50)
    cfg_s = LVConfig(iters=50, eval_every=50, sparse_on=True)
    data = make_data(cfg_d)
    model = make_model(cfg_d)
    params = init_params(cfg_d, model)
    loss_d, _, _ = make_ode_fns(cfg_d, model, data)
    loss_s, _, _ = make_ode_fns(cfg_s, model, data)
    assert float(loss_s(params)) > float(loss_d(params))


def test_lv_bspline_model_trains():
    # PyTorch-flavor parity: efficient-kan B-spline chain as the RHS
    # (predator_prey.py:101,142)
    cfg = LVConfig(model="bspline_kan", iters=200, eval_every=200,
                   lr=2e-3, init_scale=1.0)
    out = run(cfg)
    h = np.asarray(out["loss_history"])
    assert np.isfinite(h).all() and h[-1] < h[0]


def test_lv_adaptive_interpolating_adjoint_trains():
    """cfg.adjoint selects the adaptive-mode differentiation strategy;
    the interpolating adjoint must train (finite, descending)."""
    cfg = LVConfig(iters=150, eval_every=150, solve_mode="adaptive",
                   adjoint="interpolating", lr=2e-3, init_scale=1e-2)
    out = run(cfg)
    h = np.asarray(out["loss_history"])
    assert np.isfinite(h).all() and h[-1] < h[0]


def test_lv_bspline_default_init_keeps_grid():
    """init_scale must not collapse the knot grid: with the default
    near-zero init the spline branch must still have live gradients."""
    from kanodes.experiments.lv import make_model, init_params, \
        make_ode_fns
    cfg = LVConfig(model="bspline_kan")          # default init_scale 1e-5
    model = make_model(cfg)
    params = init_params(cfg, model)
    # knot span is the constructor's grid_range, not 1e-5 of it
    assert float(params[0]["grid"].max()) > 0.5
    data = make_data(cfg)
    loss_fn, _, _ = make_ode_fns(cfg, model, data)
    g = jax.grad(loss_fn)(params)
    gnorm = sum(float(jnp.abs(x).sum()) for p in g
                for k, x in p.items() if k == "coeff")
    assert gnorm > 0.0                           # spline branch trainable


@pytest.mark.slow
def test_lv_grid_refinement_flow():
    """Train -> update_grid -> keep training: knots move onto the data
    distribution while the refit preserves the learned function."""
    from kanodes.experiments.lv import run_grid_refinement
    cfg = LVConfig(model="bspline_kan", iters=300, eval_every=100,
                   lr=2e-3, init_scale=1.0)
    out = run_grid_refinement(cfg, update_every=100)
    h = np.asarray(out["loss_history"])
    assert np.isfinite(h).all() and h[-1] < h[0]
    assert len(out["refits"]) == 2
    for pre, post in out["refits"]:
        # lstsq refit is function-preserving up to projection error
        assert post < max(2.0 * pre, pre + 1e-6)
    # knots actually moved off the uniform init
    g0 = make_model(cfg).init(jax.random.PRNGKey(cfg.seed))[0]["grid"]
    g1 = out["params"][0]["grid"]
    assert float(jnp.abs(g1 - g0).max()) > 1e-3


def test_adaptive_vs_fixed_gradient_equivalence():
    """The adaptive (reference-faithful) training mode computes the same
    gradients as the fixed-grid fast path at matched integration
    accuracy (VERDICT round-1 #2 equivalence note): both discretize the
    same continuous-time objective, so as tolerances tighten their
    param-gradients converge to each other."""
    cfg_a = LVConfig(solve_mode="adaptive", rtol=1e-8, atol=1e-10,
                     max_steps=512)
    cfg_f = LVConfig(solve_mode="fixed", substeps=4)
    data = make_data(cfg_a)
    model = make_model(cfg_a)
    # unscaled init: nontrivial dynamics (near-zero init has ~zero grads)
    params = model.init(jax.random.PRNGKey(3))

    loss_a, _, _ = make_ode_fns(cfg_a, model, data)
    loss_f, _, _ = make_ode_fns(cfg_f, model, data)
    la, lf = float(loss_a(params)), float(loss_f(params))
    np.testing.assert_allclose(la, lf, rtol=1e-5)

    ga = jax.grad(loss_a)(params)
    gf = jax.grad(loss_f)(params)
    fa = jnp.concatenate([g.ravel() for g in jax.tree_util.tree_leaves(ga)])
    ff = jnp.concatenate([g.ravel() for g in jax.tree_util.tree_leaves(gf)])
    cos = float(jnp.vdot(fa, ff) / (jnp.linalg.norm(fa)
                                    * jnp.linalg.norm(ff)))
    assert cos > 0.9999, cos
    np.testing.assert_allclose(np.asarray(fa), np.asarray(ff),
                               rtol=2e-2, atol=1e-6)


def test_lv_fused_bwd_precision_threads():
    """LVConfig.bwd_precision must reach the fused kernels: in CPU
    interpret mode both settings execute identical math (there is no
    TF32), so shooting- and trajectory-mode losses/gradients must agree
    exactly (on the GPU the tf32 backward is compared with the
    reference by the chip-marked tests)."""
    import jax

    data = make_data(LVConfig())
    model = make_model(LVConfig())
    params = init_params(LVConfig(), model)
    params = jax.tree_util.tree_map(lambda a: a + 0.05, params)
    for mode, seg in (("shooting", 2), ("fixed", 1)):
        fns = {}
        for bp in ("highest", "tf32"):
            cfg = LVConfig(solve_mode=mode, segment_len=seg,
                           impl="fused", bwd_precision=bp)
            loss_fn, _, _ = make_ode_fns(cfg, model, data)
            fns[bp] = jax.value_and_grad(loss_fn)(params)
        np.testing.assert_allclose(fns["highest"][0], fns["tf32"][0],
                                   rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(fns["highest"][1]),
                        jax.tree_util.tree_leaves(fns["tf32"][1])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9)
