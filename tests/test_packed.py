"""Packed (block-diagonal) KAN ensembles (`models/packed.py`).

S member chains embedded as block-diagonal weights of one wider chain
must compute S exactly-independent forwards, losses, gradients, and
training runs — the member axis rides the GEMM width instead of the
Pallas kernel grid (the measured-latency rationale is in
EXPERIMENTS.md's multi-seed section).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.experiments.lv import (LVConfig, make_data, make_model,
                                    make_ode_fns)
from kanodes.models.packed import (apply_mask, block_mask,
                                   extract_member, member_mean,
                                   pack_chain, pack_params,
                                   tile_state)
from kanodes.train.loop import TrainConfig, train

S = 3


def _members(model, seeds=range(S), scale=1e-2):
    return [jax.tree_util.tree_map(lambda x: x * scale,
                                   model.init(jax.random.PRNGKey(s)))
            for s in seeds]


def _lv_setup(**cfg_kw):
    cfg = LVConfig(**cfg_kw)
    data = make_data(cfg)
    model = make_model(cfg)
    members = _members(model)
    packed_model = pack_chain(model, S)
    packed = pack_params(model, members)
    pdata = {"ts": data["ts"], "X": tile_state(data["X"], S),
             "n_train": data["n_train"]}
    return cfg, data, model, members, packed_model, packed, pdata


def test_pack_extract_roundtrip():
    model = make_model(LVConfig())
    members = _members(model)
    packed = pack_params(model, members)
    assert packed[0]["C"].shape == (3 * 2, 5, 3 * 10)
    assert packed[1]["W"].shape == (3 * 10, 3 * 2)
    for s in range(S):
        got = extract_member(model, packed, S, s)
        for g, ref in zip(jax.tree_util.tree_leaves(got),
                          jax.tree_util.tree_leaves(members[s])):
            np.testing.assert_array_equal(g, ref)
    # off-block entries are exact zeros
    mask = block_mask(model, S)
    for m, p in zip(jax.tree_util.tree_leaves(mask),
                    jax.tree_util.tree_leaves(packed)):
        np.testing.assert_array_equal(np.asarray(p)[np.asarray(m) == 0],
                                      0.0)


@pytest.mark.parametrize("batch", [(7,), ()])
def test_packed_forward_is_member_independent(batch):
    """packed_chain(tile(x)) == concat of member forwards, and member s
    output is unaffected by other members' inputs (batched rows and a
    single state)."""
    model = make_model(LVConfig())
    members = _members(model, scale=1.0)
    packed_model = pack_chain(model, S)
    packed = pack_params(model, members)
    x = jax.random.uniform(jax.random.PRNGKey(9), batch + (2,),
                           minval=0.1, maxval=2.0)
    y_packed = packed_model.apply(packed, tile_state(x, S))
    for s in range(S):
        y_ref = model.apply(members[s], x)
        np.testing.assert_allclose(y_packed[..., 2 * s:2 * s + 2], y_ref,
                                   rtol=2e-5, atol=1e-6)
    # independence: perturb member 0's input slice only
    xt = tile_state(x, S).at[..., 0:2].set(-1.0)
    y2 = packed_model.apply(packed, xt)
    np.testing.assert_array_equal(y2[..., 2:], y_packed[..., 2:])


@pytest.mark.parametrize("impl,mode,substeps", [("xla", "shooting", 1),
                                                ("fused", "shooting", 1),
                                                ("fused", "shooting", 2),
                                                ("xla", "fixed", 1),
                                                ("fused", "fixed", 1),
                                                ("fused", "fixed", 2)])
def test_packed_lv_loss_and_grads_match_members(monkeypatch, impl, mode,
                                                substeps):
    if impl == "fused":
        # the width rule sends packed chains to XLA and single members to
        # the kernels; force the kernels for both so that the kernels'
        # handling of block-diagonal packed chains is what is compared
        from kanodes.ops import rk_fused
        monkeypatch.setattr(rk_fused, "kernel_wins", lambda spec: True)
    (cfg, data, model, members, packed_model, packed,
     pdata) = _lv_setup(solve_mode=mode, impl=impl, segment_len=2,
                        substeps=substeps)
    loss_s, eval_s, _ = make_ode_fns(cfg, packed_model, pdata,
                                     reduce_fn=member_mean(S))
    mask = block_mask(model, S)
    vec = loss_s(apply_mask(mask, packed))
    evec = eval_s(apply_mask(mask, packed))
    assert vec.shape == (S,) and evec.shape == (S,)

    ref_loss, ref_eval, _ = make_ode_fns(cfg, model, data)
    for s in range(S):
        np.testing.assert_allclose(vec[s], ref_loss(members[s]),
                                   rtol=3e-5)
        np.testing.assert_allclose(evec[s], ref_eval(members[s]),
                                   rtol=3e-5)

    # gradient isolation + parity: d(sum of member losses)/d packed ==
    # block-diag of the member gradients
    g = jax.grad(lambda p: jnp.sum(loss_s(apply_mask(mask, p))))(packed)
    for m, gl in zip(jax.tree_util.tree_leaves(mask),
                     jax.tree_util.tree_leaves(g)):
        np.testing.assert_array_equal(np.asarray(gl)[np.asarray(m) == 0],
                                      0.0)
    for s in range(S):
        gs = extract_member(model, g, S, s)
        ref_g = jax.grad(ref_loss)(members[s])
        for a, b in zip(jax.tree_util.tree_leaves(gs),
                        jax.tree_util.tree_leaves(ref_g)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)


def test_packed_train_matches_sequential():
    """A short packed vector-mode train run reproduces each member's own
    scalar run (same Adam trajectory on the block entries)."""
    (cfg, data, model, members, packed_model, packed,
     pdata) = _lv_setup(solve_mode="shooting", impl="xla")
    loss_s, eval_s, _ = make_ode_fns(cfg, packed_model, pdata,
                                     reduce_fn=member_mean(S))
    mask = block_mask(model, S)

    def loss_vec(p):
        return loss_s(apply_mask(mask, p))

    tcfg = TrainConfig(lr=3e-3, iters=40, eval_every=20)
    out = train(loss_vec, packed, tcfg,
                eval_fn=lambda p: eval_s(apply_mask(mask, p)))
    assert out["loss_history"].shape == (40, S)

    ref_loss, ref_eval, _ = make_ode_fns(cfg, model, data)
    for s in range(S):
        ref = train(ref_loss, members[s], tcfg, eval_fn=ref_eval)
        np.testing.assert_allclose(out["loss_history"][:, s],
                                   ref["loss_history"], rtol=2e-4)
        got = extract_member(model, out["params"], S, s)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref["params"])):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-7)


@pytest.mark.parametrize("impl,mode", [("xla", "shooting"),
                                       ("fused", "fixed"),
                                       ("fused", "shooting")])
def test_packed_surrogate_loss_matches_members(impl, mode):
    """The reduce_fn hook generalizes packing to the PDE surrogates:
    a 2-member packed Burgers chain reproduces each member's own loss
    and gradients (small 11-point grid)."""
    from kanodes.experiments.pde_surrogate import (SurrogateConfig,
                                                   make_data,
                                                   make_fns,
                                                   make_model)
    Sp = 2
    cfg = SurrogateConfig(problem="burgers", impl=impl, solve_mode=mode,
                          substeps=4, data_dx=0.2)
    data = make_data(cfg)
    model = make_model(cfg, data)
    members = [jax.tree_util.tree_map(lambda x: 1e-2 * x,
                                      model.init(jax.random.PRNGKey(s)))
               for s in range(Sp)]
    packed_model = pack_chain(model, Sp)
    packed = pack_params(model, members)
    pdata = dataclasses.replace(data, X=np.tile(data.X, (1, Sp)))
    mask = block_mask(model, Sp)

    loss_p, snap_p, _ = make_fns(cfg, packed_model, pdata,
                                 reduce_fn=member_mean(Sp))
    vec = loss_p(apply_mask(mask, packed))
    svec = snap_p(apply_mask(mask, packed))
    assert vec.shape == (Sp,) and svec.shape == (Sp,)

    ref_loss, ref_snap, _ = make_fns(cfg, model, data)
    g = jax.grad(lambda p: jnp.sum(loss_p(apply_mask(mask, p))))(packed)
    for s in range(Sp):
        np.testing.assert_allclose(vec[s], ref_loss(members[s]),
                                   rtol=3e-5)
        np.testing.assert_allclose(svec[s], ref_snap(members[s]),
                                   rtol=3e-5)
        gs = extract_member(model, g, Sp, s)
        ref_g = jax.grad(ref_loss)(members[s])
        for a, b in zip(jax.tree_util.tree_leaves(gs),
                        jax.tree_util.tree_leaves(ref_g)):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-8)


def test_odeint_members_independent_controllers():
    """Block-diagonal linear system with a 100x time-scale split: each
    member's controller must walk its own dt sequence (different step
    counts) and still match that member's sequential adaptive solve and
    the closed form."""
    from kanodes.ode import odeint, odeint_members

    lam = jnp.asarray([0.5, 50.0])

    def f_packed(t, y, args):
        return -jnp.repeat(args, 1) * y          # d=1 per member

    def f_single(t, y, args):
        return -args * y

    ts = jnp.linspace(0.0, 1.0, 6)
    y0 = jnp.asarray([1.0, 1.0])
    ys, stats = odeint_members(f_packed, y0, ts, lam, n_members=2,
                               rtol=1e-6, atol=1e-9, max_steps=512,
                               return_stats=True)
    assert ys.shape == (6, 2)
    # the stiff member needs far more accepted steps — controllers are
    # genuinely independent
    assert int(stats.n_accept[1]) > 2 * int(stats.n_accept[0])
    for s in range(2):
        ref = odeint(f_single, y0[s:s + 1], ts, lam[s], rtol=1e-6,
                     atol=1e-9, max_steps=512, adjoint="direct")
        np.testing.assert_allclose(ys[:, s:s + 1], ref, rtol=1e-6,
                                   atol=1e-9)
        # closed form holds down to the controller's atol floor (the
        # stiff member's tail decays to 1e-22 — below f32/atol reach)
        np.testing.assert_allclose(ys[:, s], jnp.exp(-lam[s] * ts),
                                   rtol=1e-3, atol=5e-9)


def test_packed_adaptive_members_matches_sequential():
    """Packed LV ensemble under the reference-faithful ADAPTIVE protocol:
    per-member losses, evals and gradients match each member's own
    sequential adaptive run (odeint_members gives every member its own
    save-clipped controller)."""
    (cfg, data, model, members, packed_model, packed,
     pdata) = _lv_setup(solve_mode="adaptive", impl="xla", max_steps=96)
    loss_s, eval_s, _ = make_ode_fns(cfg, packed_model, pdata,
                                     reduce_fn=member_mean(S),
                                     n_members=S)
    mask = block_mask(model, S)
    vec = loss_s(apply_mask(mask, packed))
    evec = eval_s(apply_mask(mask, packed))
    assert vec.shape == (S,) and evec.shape == (S,)

    ref_cfg = dataclasses.replace(cfg, adjoint="direct")
    ref_loss, ref_eval, _ = make_ode_fns(ref_cfg, model, data)
    for s in range(S):
        np.testing.assert_allclose(vec[s], ref_loss(members[s]),
                                   rtol=3e-5)
        np.testing.assert_allclose(evec[s], ref_eval(members[s]),
                                   rtol=3e-5)

    g = jax.grad(lambda p: jnp.sum(loss_s(apply_mask(mask, p))))(packed)
    for m, gl in zip(jax.tree_util.tree_leaves(mask),
                     jax.tree_util.tree_leaves(g)):
        np.testing.assert_array_equal(np.asarray(gl)[np.asarray(m) == 0],
                                      0.0)
    for s in range(S):
        gs = extract_member(model, g, S, s)
        ref_g = jax.grad(ref_loss)(members[s])
        for a, b in zip(jax.tree_util.tree_leaves(gs),
                        jax.tree_util.tree_leaves(ref_g)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)


def test_adaptive_reduce_fn_requires_n_members():
    """ADVICE r4: a packed ensemble trained with solve_mode='adaptive'
    must not silently couple members through one shared controller."""
    cfg = LVConfig(solve_mode="adaptive")
    data = make_data(cfg)
    model = make_model(cfg)
    with pytest.raises(ValueError, match="n_members"):
        make_ode_fns(cfg, model, data, reduce_fn=member_mean(2))


def test_member_lr_scales_packed_parity():
    """Per-member learning rates on the homogeneous packed layout:
    member s's Adam trajectory equals a scalar run at lr * factor_s."""
    from kanodes.models.packed import member_lr_scales
    (cfg, data, model, members, packed_model, packed,
     pdata) = _lv_setup(solve_mode="shooting", impl="xla")
    loss_s, eval_s, _ = make_ode_fns(cfg, packed_model, pdata,
                                     reduce_fn=member_mean(S))
    mask = block_mask(model, S)
    factors = [1.0, 0.25, 3.0]
    base_lr = 2e-3
    out = train(lambda p: loss_s(apply_mask(mask, p)), packed,
                TrainConfig(lr=base_lr, iters=30, eval_every=30),
                stacked=False,
                lr_scales=member_lr_scales(model, factors))
    for s in range(S):
        ref_loss, _, _ = make_ode_fns(cfg, model, data)
        ref = train(ref_loss, members[s],
                    TrainConfig(lr=base_lr * factors[s], iters=30,
                                eval_every=30))
        np.testing.assert_allclose(out["loss_history"][:, s],
                                   ref["loss_history"], rtol=2e-4)
        got = extract_member(model, out["params"], S, s)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(ref["params"])):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-7)


def _hetero_setup(widths=(4, 6), grids=(3, 5)):
    from kanodes.models.packed import HeteroPacked
    cfgs = [LVConfig(layer_width=w, grid_size=g)
            for w, g in zip(widths, grids)]
    members = [make_model(c) for c in cfgs]
    hp = HeteroPacked(members)
    inits = [jax.tree_util.tree_map(lambda x: x * 1e-2,
                                    m.init(jax.random.PRNGKey(s)))
             for s, m in enumerate(members)]
    return cfgs, members, hp, inits


def test_hetero_pack_forward_and_grads():
    """Members of DIFFERENT hidden widths and grid sizes packed into one
    chain: exact per-member forwards, loss vector, gradient isolation."""
    cfgs, members, hp, inits = _hetero_setup()
    packed = hp.pack(inits)
    # layer shapes: variable-size blocks, grid padded to max
    assert packed[0]["C"].shape == (4, 5, 10)      # 2+2 in, 4+6 out
    assert packed[1]["C"].shape == (10, 5, 4)
    # roundtrip
    for s in range(2):
        got = hp.extract_member(packed, s)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(inits[s])):
            np.testing.assert_array_equal(a, b)
    # forward parity (note mask not even needed on freshly packed params)
    x = jax.random.uniform(jax.random.PRNGKey(3), (7, 2), minval=0.1,
                           maxval=2.0)
    y = hp.apply(packed, hp.tile_state(x))
    for s in range(2):
        np.testing.assert_allclose(y[:, 2 * s:2 * s + 2],
                                   members[s].apply(inits[s], x),
                                   rtol=2e-5, atol=1e-7)
    # loss + grads through the LV objective
    cfg = LVConfig(solve_mode="shooting", impl="xla", segment_len=2)
    data = make_data(cfg)
    pdata = {"ts": data["ts"], "X": hp.tile_state(data["X"]),
             "n_train": data["n_train"]}
    loss_s, eval_s, _ = make_ode_fns(cfg, hp, pdata,
                                     reduce_fn=hp.member_mean())
    mask = hp.mask()
    vec = loss_s(apply_mask(mask, packed))
    g = jax.grad(lambda p: jnp.sum(loss_s(apply_mask(mask, p))))(packed)
    for s in range(2):
        ref_l, _, _ = make_ode_fns(cfg, members[s], data)
        np.testing.assert_allclose(vec[s], ref_l(inits[s]), rtol=3e-5)
        gs = hp.extract_member(g, s)
        ref_g = jax.grad(ref_l)(inits[s])
        for a, b in zip(jax.tree_util.tree_leaves(gs),
                        jax.tree_util.tree_leaves(ref_g)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)
    # off-block (and padded-grid-column) gradients are exact zeros
    for m, gl in zip(jax.tree_util.tree_leaves(mask),
                     jax.tree_util.tree_leaves(g)):
        np.testing.assert_array_equal(np.asarray(gl)[np.asarray(m) == 0],
                                      0.0)


def test_hetero_rejects_mixed_basis():
    from kanodes.models.packed import HeteroPacked
    with pytest.raises(ValueError, match="basis"):
        HeteroPacked([make_model(LVConfig(basis="rbf")),
                      make_model(LVConfig(basis="iqf"))])


def test_packed_trend_sweep_matches_sequential_curriculum():
    """A 2-size mini trend sweep trained as one packed program matches
    the same curriculum run per member."""
    import dataclasses as dc

    from kanodes.experiments.sweep import SweepPoint, packed_trend_sweep
    pts = (SweepPoint("kan", layer_width=4, grid_size=3),
           SweepPoint("kan", layer_width=5, grid_size=5))
    out = packed_trend_sweep(pts, shooting_iters=30, seg4_iters=20,
                             traj_iters=20)
    assert out["n_members"] == 2 and len(out["results"]) == 2
    assert out["results"][0]["n_params"] == 64
    assert out["results"][1]["n_params"] == 120

    for s, p in enumerate(pts):
        cfg = LVConfig(model="kan", layer_width=p.layer_width,
                       grid_size=p.grid_size, impl="xla")
        data = make_data(cfg)
        model = make_model(cfg)
        from kanodes.experiments.lv import init_params
        params = init_params(cfg, model)
        for mode, seg, lr, iters in [("shooting", 1, 3e-3, 30),
                                     ("shooting", 4, 1e-3, 20),
                                     ("fixed", 1, 3e-4, 20)]:
            c = dc.replace(cfg, solve_mode=mode, segment_len=seg, lr=lr)
            loss_fn, _, _ = make_ode_fns(c, model, data)
            r = train(loss_fn, params,
                      TrainConfig(lr=lr, iters=iters, eval_every=iters))
            params = r["params"]
        eval_cfg = dc.replace(cfg, solve_mode="fixed")
        loss_fn, eval_fn, _ = make_ode_fns(eval_cfg, model, data)
        np.testing.assert_allclose(out["results"][s]["train_loss"],
                                   float(loss_fn(params)), rtol=2e-3)
        np.testing.assert_allclose(out["results"][s]["test_loss"],
                                   float(eval_fn(params)), rtol=2e-3)


def test_packed_rejects_trainable_grid_and_vector_sparse():
    model = make_model(LVConfig())
    bad = dataclasses.replace(model.layers[0], trainable_grid=True)
    from kanodes.models.kdense import KANChain
    with pytest.raises(ValueError):
        pack_chain(KANChain(bad, model.layers[1]), 2)
    cfg = LVConfig(sparse_on=True)
    data = make_data(cfg)
    with pytest.raises(ValueError):
        make_ode_fns(cfg, model, data, reduce_fn=member_mean(2))


def test_packed_adaptive_fused_impl_matches_xla():
    """impl='fused' in adaptive mode takes the XLA per-member controllers
    (odeint_members) — the path that serves packed adaptive ensembles;
    losses, evals and gradients match impl='xla', and off-block
    gradients stay exactly zero."""
    (cfg, data, model, members, packed_model, packed,
     pdata) = _lv_setup(solve_mode="adaptive", impl="fused", max_steps=96)
    loss_f, eval_f, _ = make_ode_fns(cfg, packed_model, pdata,
                                     reduce_fn=member_mean(S),
                                     n_members=S)
    import dataclasses as dc
    cfg_x = dc.replace(cfg, impl="xla")
    loss_x, eval_x, _ = make_ode_fns(cfg_x, packed_model, pdata,
                                     reduce_fn=member_mean(S),
                                     n_members=S)
    mask = block_mask(model, S)
    mp = apply_mask(mask, packed)
    np.testing.assert_allclose(loss_f(mp), loss_x(mp), rtol=3e-5)
    np.testing.assert_allclose(eval_f(mp), eval_x(mp), rtol=3e-5)
    gf = jax.grad(lambda p: jnp.sum(loss_f(apply_mask(mask, p))))(packed)
    gx = jax.grad(lambda p: jnp.sum(loss_x(apply_mask(mask, p))))(packed)
    # off-block gradients stay exactly zero
    for m, gl in zip(jax.tree_util.tree_leaves(mask),
                     jax.tree_util.tree_leaves(gf)):
        np.testing.assert_array_equal(np.asarray(gl)[np.asarray(m) == 0],
                                      0.0)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gx)):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=5e-5)
