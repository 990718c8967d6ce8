"""Mask-aware packed L-BFGS (`train/packed_polish.py`).

S members polished on ONE packed tree must behave as S independent
L-BFGS runs: per-member inner products, per-member line searches,
per-member curvature-pair validity. Isolation is exact by construction
(off-block entries are 0.0 and finite*0 == 0), so member trajectories
must be BITWISE invariant to other members' contents.
"""

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.experiments.lv import LVConfig, make_model
from kanodes.models.packed import (HeteroPacked, block_mask,
                                   member_ids, pack_chain,
                                   pack_params, tile_state)
from kanodes.train.packed_polish import (PackedPolishConfig,
                                         polish_packed)

CFG = PackedPolishConfig(iters=12, memory_size=5, linesearch_steps=15)


def _hetero(widths=(3, 5), grids=(4, 5), seeds=None):
    cfgs = [LVConfig(layer_width=w, grid_size=g, impl="xla")
            for w, g in zip(widths, grids)]
    members = [make_model(c) for c in cfgs]
    hp = HeteroPacked(members)
    seeds = seeds or list(range(len(members)))
    inits = [jax.tree_util.tree_map(
        lambda x: x * 0.3, m.init(jax.random.PRNGKey(s)))
        for m, s in zip(members, seeds)]
    return hp, inits


def _loss_vec_fn(hp):
    x = jax.random.uniform(jax.random.PRNGKey(7), (16, 2),
                           minval=0.2, maxval=2.0)
    tgt = jax.random.normal(jax.random.PRNGKey(8), (16, 2)) * 0.5
    xt, tt = hp.tile_state(x), hp.tile_state(tgt)
    mask, reduce = hp.mask(), hp.member_mean()

    def loss_vec(p):
        masked = jax.tree_util.tree_map(jnp.multiply, mask, p)
        return reduce((hp.apply(masked, xt) - tt) ** 2)
    return loss_vec


def test_polish_packed_improves_every_member():
    hp, inits = _hetero()
    loss_vec = _loss_vec_fn(hp)
    p0 = hp.pack(inits)
    f0 = loss_vec(p0)
    out = polish_packed(loss_vec, p0, ids=hp.member_ids(),
                        mask=hp.mask(), n_members=hp.n_members, cfg=CFG)
    best = np.asarray(out["best_loss"])
    assert np.all(np.isfinite(np.asarray(out["loss_history"])))
    assert out["loss_history"].shape == (CFG.iters, hp.n_members)
    # best-so-far never exceeds the start, and L-BFGS makes real progress
    np.testing.assert_array_less(best, np.asarray(f0) + 1e-12)
    assert np.all(best < 0.7 * np.asarray(f0))
    # off-block entries of the returned params are exact zeros
    for m, p in zip(jax.tree_util.tree_leaves(hp.mask()),
                    jax.tree_util.tree_leaves(out["params"])):
        np.testing.assert_array_equal(np.asarray(p)[np.asarray(m) == 0],
                                      0.0)


def test_polish_packed_member_bitwise_isolation():
    """Member 0's polished block is BITWISE invariant to member 1's
    init: its loss, line search, and curvature history see the other
    member only through exact-zero products."""
    hp, inits = _hetero()
    loss_vec = _loss_vec_fn(hp)
    out_a = polish_packed(loss_vec, hp.pack(inits), ids=hp.member_ids(),
                          mask=hp.mask(), n_members=2, cfg=CFG)
    inits_b = [inits[0],
               jax.tree_util.tree_map(lambda x: x * -1.7, inits[1])]
    out_b = polish_packed(loss_vec, hp.pack(inits_b), ids=hp.member_ids(),
                          mask=hp.mask(), n_members=2, cfg=CFG)
    np.testing.assert_array_equal(out_a["best_loss"][0],
                                  out_b["best_loss"][0])
    np.testing.assert_array_equal(out_a["loss_history"][:, 0],
                                  out_b["loss_history"][:, 0])
    for a, b in zip(jax.tree_util.tree_leaves(
            hp.extract_member(out_a["params"], 0)),
            jax.tree_util.tree_leaves(
            hp.extract_member(out_b["params"], 0))):
        np.testing.assert_array_equal(a, b)
    # and member 1 genuinely changed (the test has teeth)
    assert not np.array_equal(out_a["best_loss"][1], out_b["best_loss"][1])


def test_polish_packed_matches_single_member_pack():
    """An S=2 hetero pack reproduces each member's own S=1 run (same
    algorithm, different GEMM shapes — f32 summation-order tolerance)."""
    hp, inits = _hetero()
    loss_vec = _loss_vec_fn(hp)
    out = polish_packed(loss_vec, hp.pack(inits), ids=hp.member_ids(),
                        mask=hp.mask(), n_members=2, cfg=CFG)
    for s in range(2):
        hp1 = HeteroPacked([hp.members[s]])
        lv1 = _loss_vec_fn(hp1)
        out1 = polish_packed(lv1, hp1.pack([inits[s]]),
                             ids=hp1.member_ids(), mask=hp1.mask(),
                             n_members=1, cfg=CFG)
        np.testing.assert_allclose(out["best_loss"][s],
                                   out1["best_loss"][0], rtol=2e-3)


def test_polish_packed_homogeneous_layout():
    """The homogeneous pack_chain/pack_params layout works through the
    same entry point via module-level member_ids/block_mask."""
    model = make_model(LVConfig(impl="xla"))
    S = 3
    inits = [jax.tree_util.tree_map(
        lambda x: x * 0.3, model.init(jax.random.PRNGKey(s)))
        for s in range(S)]
    packed_model = pack_chain(model, S)
    mask = block_mask(model, S)
    ids = member_ids(model, S)
    x = jax.random.uniform(jax.random.PRNGKey(7), (16, 2),
                           minval=0.2, maxval=2.0)
    tgt = jax.random.normal(jax.random.PRNGKey(8), (16, 2)) * 0.5
    xt, tt = tile_state(x, S), tile_state(tgt, S)

    def loss_vec(p):
        masked = jax.tree_util.tree_map(jnp.multiply, mask, p)
        err = (packed_model.apply(masked, xt) - tt) ** 2
        e = err.reshape(err.shape[0], S, 2)
        return e.mean(axis=(0, 2))

    p0 = pack_params(model, inits)
    f0 = loss_vec(p0)
    out = polish_packed(loss_vec, p0, ids=ids, mask=mask, n_members=S,
                        cfg=CFG)
    assert np.all(np.asarray(out["best_loss"]) < 0.7 * np.asarray(f0))


def test_member_ids_block_values():
    model = make_model(LVConfig(impl="xla"))
    ids = member_ids(model, 3)
    mask = block_mask(model, 3)
    for i, m in zip(jax.tree_util.tree_leaves(ids),
                    jax.tree_util.tree_leaves(mask)):
        assert i.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(i)[np.asarray(m) == 0], 0)
    # member 2's C block carries the value 2
    np.testing.assert_array_equal(
        np.asarray(ids[0]["C"][4:6, :, 20:30]), 2)

    hp, _ = _hetero()
    hids = hp.member_ids()
    for i, m in zip(jax.tree_util.tree_leaves(hids),
                    jax.tree_util.tree_leaves(hp.mask())):
        assert i.dtype == jnp.int32
        assert np.asarray(i).max() == hp.n_members - 1


def test_packed_trend_sweep_polish_stage():
    """polish_iters wires the packed L-BFGS into the trend sweep: every
    member's polished train loss is no worse than its Adam endpoint."""
    from kanodes.experiments.sweep import SweepPoint, packed_trend_sweep
    pts = (SweepPoint("kan", layer_width=4, grid_size=3),
           SweepPoint("kan", layer_width=5, grid_size=5))
    out = packed_trend_sweep(pts, shooting_iters=30, seg4_iters=20,
                             traj_iters=20, polish_iters=6)
    assert out["polish_iters"] == 6 and "polish_seconds" in out
    for r in out["results"]:
        assert r["polished_train_loss"] <= r["train_loss"] * (1 + 1e-6)
        assert np.isfinite(r["polished_test_loss"])
