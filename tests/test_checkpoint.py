"""Checkpoint store, parameter-history recording, post-hoc selection.

Parity targets: the reference's full-p_list .mat checkpoints and
post-hoc argmin model selection (`LV_driver_KANODE.jl:252-272`,
`Plotting_standard.jl:105-110`) and its restart history continuation
(`:146-160`).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import kanodes.train.checkpoint as ckpt_mod
from kanodes.train.checkpoint import (Checkpointer, TrainState,
                                      select_from_history)
from kanodes.train.loop import TrainConfig, train


def _state(step, seed=0):
    rng = np.random.default_rng(seed)
    return TrainState(
        params={"w": rng.normal(size=(3, 2)).astype(np.float32),
                "b": rng.normal(size=(2,)).astype(np.float32)},
        step=step,
        loss_history=np.linspace(1.0, 0.1, 10).astype(np.float32),
        eval_history=np.asarray([0.5, 0.2], np.float32),
        best_loss=0.1)


@pytest.mark.parametrize("orbax", [True, False])
def test_save_restore_roundtrip(tmp_path, monkeypatch, orbax):
    if not orbax:
        monkeypatch.setattr(ckpt_mod, "_HAVE_ORBAX", False)
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    st = _state(7)
    ck.save(st)
    got = ck.restore()
    np.testing.assert_allclose(got["params"]["w"], st.params["w"])
    np.testing.assert_allclose(got["loss_history"], st.loss_history)
    assert got["step"] == 7
    # retention: keep=2
    ck.save(_state(8, seed=1))
    ck.save(_state(9, seed=2))
    assert ck.steps() == [8, 9]
    # re-save an existing step (numpy fallback must replace atomically)
    ck.save(_state(9, seed=3))
    got9 = ck.restore(9)
    assert ck.latest_step() == 9
    rng3 = np.random.default_rng(3)
    np.testing.assert_allclose(got9["params"]["w"],
                               rng3.normal(size=(3, 2)).astype(np.float32))


def _quad_problem():
    target = jnp.asarray([1.0, -2.0, 0.5])

    def loss_fn(p):
        return jnp.sum((p["x"] - target) ** 2)

    def eval_fn(p):
        return jnp.sum(jnp.abs(p["x"] - target))

    params = {"x": jnp.zeros(3)}
    return loss_fn, eval_fn, params


def test_record_history_and_posthoc_selection():
    loss_fn, eval_fn, params = _quad_problem()
    cfg = TrainConfig(lr=0.05, iters=200, eval_every=20)
    out = train(loss_fn, params, cfg, eval_fn=eval_fn,
                record_history=True)
    hist = out["param_history"]
    assert hist["x"].shape == (10, 3)
    # snapshots are the live params at each eval point: monotone approach
    best, idx, metric = select_from_history(hist, out["eval_history"])
    assert idx == 9                       # converging problem: last is best
    assert metric == float(out["eval_history"][-1])
    np.testing.assert_allclose(np.asarray(best["x"]),
                               np.asarray(hist["x"][9]))
    top3 = select_from_history(hist, out["eval_history"], k=3)
    assert [t[1] for t in top3] == [9, 8, 7]


def test_select_from_history_validates_lengths():
    hist = {"x": jnp.zeros((5, 2))}
    with pytest.raises(ValueError):
        select_from_history(hist, np.zeros(4))


def test_on_chunk_called_per_device_call():
    loss_fn, eval_fn, params = _quad_problem()
    cfg = TrainConfig(lr=0.05, iters=120, eval_every=10,
                      max_iters_per_call=40)
    calls = []

    def on_chunk(i, st):
        calls.append((i, len(np.asarray(st["loss_history"]))))
        assert np.isfinite(float(st["best_loss"]))

    train(loss_fn, params, cfg, eval_fn=eval_fn, on_chunk=on_chunk)
    assert [c[0] for c in calls] == [0, 1, 2]
    assert calls[-1][1] == 120


def test_chunk_cache_respects_new_lr():
    """train() memoizes its jitted chunk across calls keyed WITHOUT the
    learning rate (lr is injected via opt_state); a second call with the
    same loss closure but a different lr must actually train at the new
    lr — lr=0 must be an exact no-op even on the cache-hit path."""
    loss_fn, eval_fn, params = _quad_problem()
    cfg1 = TrainConfig(lr=0.05, iters=40, eval_every=40)
    out1 = train(loss_fn, params, cfg1)
    assert float(out1["loss_history"][-1]) < float(out1["loss_history"][0])

    # same closure, lr=0 -> cache hit, but parameters must NOT move
    cfg0 = TrainConfig(lr=0.0, iters=40, eval_every=40)
    out0 = train(loss_fn, params, cfg0)
    np.testing.assert_array_equal(np.asarray(out0["params"]["x"]),
                                  np.asarray(params["x"]))

    # and a third call at a large lr trains faster than the small one
    cfgL = TrainConfig(lr=0.5, iters=40, eval_every=40)
    outL = train(loss_fn, params, cfgL)
    assert float(outL["loss_history"][-1]) < float(out1["loss_history"][-1])


def test_chunk_cache_key_includes_structure():
    """Different chunk shapes (eval_every) and optimizers must NOT share
    a cached chunk."""
    from kanodes.train.loop import _RUN_CHUNK_CACHE
    loss_fn, eval_fn, params = _quad_problem()
    _RUN_CHUNK_CACHE.clear()  # the cache is capped at 16; a full cache
    n0 = len(_RUN_CHUNK_CACHE)  # (earlier tests) would mask key growth
    train(loss_fn, params, TrainConfig(lr=0.05, iters=40, eval_every=40))
    train(loss_fn, params, TrainConfig(lr=0.05, iters=40, eval_every=20))
    train(loss_fn, params, TrainConfig(lr=0.05, iters=40, eval_every=40,
                                       optimizer="sgd"))
    assert len(_RUN_CHUNK_CACHE) >= n0 + 3


def test_opt_state_resume_matches_uninterrupted():
    """Splitting a run via (params, opt_state) hand-off is exactly
    equivalent to one uninterrupted run."""
    loss_fn, eval_fn, params = _quad_problem()
    full = train(loss_fn, params, TrainConfig(lr=0.05, iters=100,
                                              eval_every=50))
    a = train(loss_fn, params, TrainConfig(lr=0.05, iters=50,
                                           eval_every=50))
    b = train(loss_fn, a["params"], TrainConfig(lr=0.05, iters=50,
                                                eval_every=50),
              opt_state=a["opt_state"])
    np.testing.assert_allclose(np.asarray(b["params"]["x"]),
                               np.asarray(full["params"]["x"]),
                               rtol=1e-6)
