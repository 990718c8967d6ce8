"""Multi-seed (vector-loss) training mode of train().

The reference runs seed studies as hand-edited sequential scripts (one
rng per driver run, e.g. `Lotka-Volterra/LV_driver_KANODE.jl:114`).
`train()` instead supports stacking S independent replicas on a
leading param axis and training them as ONE device program: the loss_fn
returns the [S] per-member loss vector, gradients are taken of the
member sum (exact per-member grads — members are independent), and
best-tracking / eval history / snapshot history become per-member.
(Measured wall-clock story: EXPERIMENTS.md multi-seed section — exact
parity, modest dispatch-amortization win, grid-lifted latency at S.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.experiments.lv import (LVConfig, make_data, make_model,
                                    make_ode_fns)
from kanodes.train.checkpoint import (select_from_history,
                                      select_members_from_history)
from kanodes.train.loop import (TrainConfig, init_stacked,
                                member_params, train)

TARGETS = jnp.asarray([[1.0, -2.0, 0.5],
                       [0.0, 3.0, -1.0],
                       [2.0, 2.0, 2.0]])


def _member_loss(p, target):
    return jnp.sum((p - target) ** 2)


def test_vector_mode_matches_independent_scalar_runs():
    """Each member of a 3-member vector run must match its own scalar
    train() run: same optimizer trajectory, same best tracking."""
    cfg = TrainConfig(lr=0.3, iters=120, eval_every=30)  # oscillating lr
    p0 = jnp.stack([jnp.zeros(3), jnp.ones(3), -jnp.ones(3)])

    vec_loss = jax.vmap(_member_loss)

    def loss_vec(p):
        return vec_loss(p, TARGETS)

    out = train(loss_vec, p0, cfg, eval_fn=loss_vec)
    assert out["loss_history"].shape == (120, 3)
    assert out["eval_history"].shape == (4, 3)
    assert out["best_loss"].shape == (3,)

    for s in range(3):
        scalar = train(lambda p, t=TARGETS[s]: _member_loss(p, t),
                       p0[s], cfg,
                       eval_fn=lambda p, t=TARGETS[s]: _member_loss(p, t))
        np.testing.assert_allclose(member_params(out["params"], s),
                                   scalar["params"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["loss_history"][:, s],
                                   scalar["loss_history"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(out["best_loss"][s],
                                   scalar["best_loss"],
                                   rtol=1e-5, atol=1e-7)
        # per-member best_params are the exact argmin points
        np.testing.assert_allclose(
            _member_loss(member_params(out["best_params"], s), TARGETS[s]),
            out["best_loss"][s], rtol=1e-6)


def test_vector_mode_history_and_member_selection():
    cfg = TrainConfig(lr=0.4, iters=80, eval_every=20)
    p0 = jnp.stack([jnp.zeros(3), 5.0 * jnp.ones(3)])
    tgt = TARGETS[:2]

    def loss_vec(p):
        return jax.vmap(_member_loss)(p, tgt)

    out = train(loss_vec, p0, cfg, eval_fn=loss_vec, record_history=True)
    assert out["param_history"].shape == (4, 2, 3)
    picks = select_members_from_history(out["param_history"],
                                        out["eval_history"])
    assert len(picks) == 2
    for s, (p, idx, metric) in enumerate(picks):
        # the member pick equals running select_from_history on that
        # member's own slice
        ref_p, ref_idx, ref_m = select_from_history(
            out["param_history"][:, s], out["eval_history"][:, s])
        assert idx == ref_idx and metric == ref_m
        np.testing.assert_array_equal(p, ref_p)
        np.testing.assert_allclose(_member_loss(p, tgt[s]), metric,
                                   rtol=1e-6)


def test_select_members_rejects_scalar_history():
    with pytest.raises(ValueError):
        select_members_from_history(jnp.zeros((4, 2, 3)), jnp.zeros(4))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_lv_multiseed_matches_sequential(impl):
    """3 LV seeds trained as one vector program == 3 sequential runs
    (same shooting objective), through both the XLA and the fused Triton
    path (interpret mode on CPU; the vmap lifts into the kernel grid)."""
    cfg = LVConfig(solve_mode="shooting", impl=impl, lr=3e-3)
    data = make_data(cfg)
    model = make_model(cfg)
    loss_fn, eval_fn, _ = make_ode_fns(cfg, model, data)
    seeds = [0, 1, 2]
    stacked = init_stacked(model.init, seeds)
    stacked = jax.tree_util.tree_map(lambda x: x * cfg.init_scale, stacked)

    tcfg = TrainConfig(lr=cfg.lr, iters=40, eval_every=20)
    out = train(jax.vmap(loss_fn), stacked, tcfg, eval_fn=jax.vmap(eval_fn))
    assert out["loss_history"].shape == (40, 3)
    assert np.all(np.isfinite(out["loss_history"]))

    for s in seeds:
        p0 = jax.tree_util.tree_map(
            lambda x: x * cfg.init_scale, model.init(jax.random.PRNGKey(s)))
        ref = train(loss_fn, p0, tcfg, eval_fn=eval_fn)
        np.testing.assert_allclose(out["loss_history"][:, s],
                                   ref["loss_history"], rtol=2e-4)
        np.testing.assert_allclose(out["eval_history"][:, s],
                                   ref["eval_history"], rtol=2e-4)
    # training actually progresses per member
    assert np.all(out["loss_history"][-1] < out["loss_history"][0])


def test_vector_mode_grad_clip_is_per_member():
    """With grad_clip set, stacked vector mode must clip each member by
    ITS OWN gradient norm (one global norm over the summed-loss
    gradients would couple the members — ADVICE r4): every member still
    matches its own scalar clipped run."""
    cfg = TrainConfig(lr=0.2, iters=60, eval_every=30, grad_clip=0.5)
    p0 = jnp.stack([jnp.zeros(3), 8.0 * jnp.ones(3), -3.0 * jnp.ones(3)])

    def loss_vec(p):
        return jax.vmap(_member_loss)(p, TARGETS)

    out = train(loss_vec, p0, cfg, eval_fn=loss_vec)
    for s in range(3):
        scalar = train(lambda p, t=TARGETS[s]: _member_loss(p, t),
                       p0[s], cfg,
                       eval_fn=lambda p, t=TARGETS[s]: _member_loss(p, t))
        np.testing.assert_allclose(out["loss_history"][:, s],
                                   scalar["loss_history"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(member_params(out["params"], s),
                                   scalar["params"], rtol=1e-5, atol=1e-6)


def test_vector_mode_grad_clip_rejects_non_stacked():
    """Packed (non-stacked) vector layouts cannot be member-clipped, so
    grad_clip must raise instead of silently coupling members."""
    def loss_vec(p):
        return jnp.sum((p - TARGETS) ** 2, axis=1)

    cfg = TrainConfig(lr=0.1, iters=10, grad_clip=1.0)
    with pytest.raises(ValueError, match="stacked"):
        train(loss_vec, jnp.zeros((3, 3)), cfg, stacked=False)


def test_explicit_stacked_kwarg():
    """stacked=False forces joint best-tracking even when every leaf
    coincidentally leads with S (the inference heuristic's failure
    mode); stacked=True on a scalar loss raises."""
    cfg = TrainConfig(lr=0.2, iters=30, eval_every=30)

    def loss_vec(p):
        return jax.vmap(_member_loss)(p, TARGETS)

    p0 = jnp.stack([jnp.zeros(3), jnp.ones(3), -jnp.ones(3)])
    joint = train(loss_vec, p0, cfg, stacked=False)
    # joint best: ONE snapshot (argmin of the member sum) — all members'
    # best_params come from the same iteration, so re-evaluating the
    # vector loss there reproduces best_loss exactly
    np.testing.assert_allclose(loss_vec(joint["best_params"]),
                               joint["best_loss"], rtol=1e-6)
    with pytest.raises(ValueError, match="vector"):
        train(lambda p: jnp.sum(p ** 2), jnp.zeros(3), cfg, stacked=True)


def test_stacked_lr_scales_parity():
    """Per-member learning rates in stacked vector mode: member s
    follows the exact Adam trajectory of a scalar run at lr*factor_s."""
    from kanodes.train.loop import stacked_lr_scales
    cfg = TrainConfig(lr=0.2, iters=50, eval_every=50)
    p0 = jnp.stack([jnp.zeros(3), jnp.ones(3), -jnp.ones(3)])
    factors = jnp.asarray([1.0, 0.1, 2.5])

    def loss_vec(p):
        return jax.vmap(_member_loss)(p, TARGETS)

    out = train(loss_vec, p0, cfg, lr_scales=stacked_lr_scales(p0, factors))
    for s in range(3):
        ref = train(lambda p, t=TARGETS[s]: _member_loss(p, t), p0[s],
                    TrainConfig(lr=0.2 * float(factors[s]), iters=50,
                                eval_every=50))
        np.testing.assert_allclose(out["loss_history"][:, s],
                                   ref["loss_history"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(member_params(out["params"], s),
                                   ref["params"], rtol=1e-5, atol=1e-6)


def test_init_stacked_shapes():
    cfg = LVConfig()
    model = make_model(cfg)
    stacked = init_stacked(model.init, [0, 1, 2, 3])
    single = model.init(jax.random.PRNGKey(2))
    for leaf, ref in zip(jax.tree_util.tree_leaves(stacked),
                         jax.tree_util.tree_leaves(single)):
        assert leaf.shape == (4,) + ref.shape
    np.testing.assert_array_equal(
        jax.tree_util.tree_leaves(member_params(stacked, 2))[0],
        jax.tree_util.tree_leaves(single)[0])
