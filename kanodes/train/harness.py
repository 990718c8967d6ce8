"""Evaluation / robustness harness for neural-ODE models.

Rebuild of `Lotka-Volterra-Pytorch/optimized_training.py`: time-ordered
train/val/test splits (:157-177), curriculum over the training time
horizon (:92-96, :454-473), normalizer-aware training, metric suite,
robustness testing over observation-noise levels and perturbed initial
conditions (:646-718), and a model-comparison runner in the spirit of
its 10-step `main` (:719-982).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.diag.metrics import (trajectory_metrics, horizon_error,
                                  stability_check)
from kanodes.ode import odeint_fixed
from kanodes.train.loop import TrainConfig, train

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class HarnessConfig:
    """Config parity (optimized_training.py:45-125, trimmed to the knobs
    that affect results)."""
    train_frac: float = 0.70           # 70/15/15 time-ordered (:157-177)
    val_frac: float = 0.15
    curriculum_horizons: tuple[float, ...] = (1.0, 2.0, 3.5)   # (:92-96)
    curriculum_iters: tuple[int, ...] = (1000, 1000, 2000)
    lr: float = 2e-3
    substeps: int = 1
    noise_levels: tuple[float, ...] = (0.0, 0.01, 0.05)        # (:646-668)
    n_perturbed_ics: int = 3
    ic_perturbation: float = 0.1
    seed: int = 0


def time_ordered_split(ts: np.ndarray, X: np.ndarray, cfg: HarnessConfig):
    n = len(ts)
    n_tr = int(n * cfg.train_frac)
    n_va = int(n * cfg.val_frac)
    return ((ts[:n_tr], X[:n_tr]),
            (ts[n_tr:n_tr + n_va], X[n_tr:n_tr + n_va]),
            (ts[n_tr + n_va:], X[n_tr + n_va:]))


def curriculum_train(model, params, ts: Array, X: Array,
                     cfg: HarnessConfig) -> dict:
    """Stage-wise training with growing time horizon (:454-473)."""
    ts = jnp.asarray(ts)
    X = jnp.asarray(X)
    u0 = X[0]

    def rhs(t, u, p):
        return model.apply(p, u)

    history = []
    for horizon, iters in zip(cfg.curriculum_horizons,
                              cfg.curriculum_iters):
        n = int(jnp.sum(ts <= horizon + 1e-9))
        n = max(n, 2)
        ts_h, X_h = ts[:n], X[:n]

        def loss_fn(p, ts_h=ts_h, X_h=X_h):
            ys = odeint_fixed(rhs, u0, ts_h, p, solver="tsit5",
                              substeps=cfg.substeps)
            return jnp.mean((ys - X_h) ** 2)

        out = train(loss_fn, params, TrainConfig(lr=cfg.lr, iters=iters,
                                                 eval_every=iters))
        params = out["params"]
        history.append({"horizon": horizon,
                        "final_loss": float(out["loss_history"][-1])})
    return {"params": params, "stages": history}


def evaluate_model(model, params, ts, X, cfg: HarnessConfig, *,
                   skip_first: bool = False) -> dict:
    """Full metric suite on a trajectory rollout (:184-247).

    `skip_first=True` drops the first row from the metrics: used when the
    rollout is seeded from a known state (e.g. the last train point) that
    is not itself part of the evaluation set.
    """
    ts = jnp.asarray(ts)
    X = jnp.asarray(X)

    def rhs(t, u, p):
        return model.apply(p, u)

    pred = odeint_fixed(rhs, X[0], ts, params, solver="tsit5",
                        substeps=cfg.substeps)
    if skip_first:
        pred, X = pred[1:], X[1:]
    m = trajectory_metrics(pred, X)
    m["horizon_mse"] = horizon_error(pred, X)
    m["stability"] = dataclasses.asdict(stability_check(np.asarray(pred)))
    return m


def robustness_test(model, params, ts, X, cfg: HarnessConfig) -> dict:
    """Noise + perturbed-IC sweeps (:646-718): rollout error when the
    initial condition is corrupted."""
    rng = np.random.default_rng(cfg.seed)
    ts = jnp.asarray(ts)
    X = jnp.asarray(X)

    def rhs(t, u, p):
        return model.apply(p, u)

    def rollout_mse(u0):
        pred = odeint_fixed(rhs, u0, ts, params, solver="tsit5",
                            substeps=cfg.substeps)
        return float(jnp.mean((pred - X) ** 2)), np.asarray(pred)

    noise_results = {}
    for lvl in cfg.noise_levels:
        u0 = X[0] + lvl * jnp.asarray(
            rng.normal(size=X.shape[1]), jnp.float32)
        mse, pred = rollout_mse(u0)
        noise_results[lvl] = {
            "mse": mse,
            "stable": stability_check(pred).stable,
        }

    ic_results = []
    for _ in range(cfg.n_perturbed_ics):
        u0 = X[0] * (1.0 + cfg.ic_perturbation * jnp.asarray(
            rng.uniform(-1, 1, X.shape[1]), jnp.float32))
        mse, pred = rollout_mse(u0)
        ic_results.append({"mse": mse,
                           "stable": stability_check(pred).stable})

    return {"noise": noise_results, "perturbed_ics": ic_results}


def compare_models(models: dict[str, tuple[Any, Any]], ts, X,
                   cfg: HarnessConfig | None = None) -> dict:
    """Run the evaluation + robustness suite over several (model, params)
    pairs and return a comparison report — the reference's baseline /
    optimized / hybrid comparison main (:719-982)."""
    cfg = cfg or HarnessConfig()
    (ts_tr, X_tr), (ts_va, X_va), (ts_te, X_te) = time_ordered_split(
        np.asarray(ts), np.asarray(X), cfg)
    report = {}
    for name, (model, params) in models.items():
        full = evaluate_model(model, params, ts, X, cfg)
        # Test-horizon rollout: integrate forward from the LAST TRAIN
        # STATE at the last train time, then score against the test
        # points only (the seeded IC row is excluded from the metrics —
        # it would trivially match itself).
        test = evaluate_model(
            model, params,
            np.concatenate([ts_tr[-1:], ts_te]),
            np.concatenate([X_tr[-1:].astype(X_te.dtype), X_te]),
            cfg, skip_first=True)
        rob = robustness_test(model, params, ts_tr, X_tr, cfg)
        report[name] = {"full": full, "test_horizon": test,
                        "robustness": rob}
    return report
