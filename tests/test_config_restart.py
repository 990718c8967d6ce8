"""Config overrides + LV checkpoint/restart/prune workflow."""

import os

import jax
import numpy as np
import pytest

from kanodes.experiments.lv import LVConfig, run
from kanodes.train.config import (override_from_args, override_from_env,
                                  describe)


def test_override_from_args():
    cfg = override_from_args(LVConfig(), ["--iters=500", "--lr=1e-3",
                                          "--solve-mode=shooting",
                                          "--sparse-on=true"])
    assert cfg.iters == 500 and cfg.lr == 1e-3
    assert cfg.solve_mode == "shooting" and cfg.sparse_on is True


def test_override_from_env(monkeypatch):
    monkeypatch.setenv("KANODE_LV_ITERS", "123")
    monkeypatch.setenv("KANODE_LV_GRID_SIZE", "7")
    cfg = override_from_env(LVConfig(), "KANODE_LV_")
    assert cfg.iters == 123 and cfg.grid_size == 7
    assert "iters = 123" in describe(cfg)


def test_tuple_override():
    cfg = override_from_args(LVConfig(), ["--mlp-widths=2,20,2"])
    assert cfg.mlp_widths == (2, 20, 2)


@pytest.mark.slow
def test_checkpoint_restart_prune(tmp_path):
    """The reference's is_restart / is_prune flow
    (LV_driver_KANODE.jl:18-25,146-170) end to end."""
    ckdir = str(tmp_path / "ck")
    cfg = LVConfig(iters=200, eval_every=200)
    out1 = run(cfg, checkpoint_dir=ckdir)
    l1 = float(out1["loss_history"][-1])

    # restart continues from saved params: first losses much lower than a
    # fresh run's first losses
    out2 = run(cfg, checkpoint_dir=ckdir, restart=True)
    n1 = len(np.asarray(out1["loss_history"]))
    assert float(out2["loss_history"][n1]) < float(out1["loss_history"][0])

    # ...and EXTENDS the stored loss/test histories, like the reference
    # restart flow (LV_driver_KANODE.jl:146-160)
    assert len(np.asarray(out2["loss_history"])) == 2 * n1
    np.testing.assert_allclose(np.asarray(out2["loss_history"][:n1]),
                               np.asarray(out1["loss_history"]))
    assert (len(np.asarray(out2["eval_history"]))
            == 2 * len(np.asarray(out1["eval_history"])))

    # prune-on-restart rebuilds a narrower net and keeps training
    out3 = run(LVConfig(iters=100, eval_every=100),
               checkpoint_dir=ckdir, restart=True, prune_threshold=1e9)
    assert out3["model"].layers[0].out_dims == 1   # max-threshold: 1 node
    assert np.isfinite(np.asarray(out3["loss_history"])).all()
