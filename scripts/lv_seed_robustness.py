"""Seed robustness of the LV record recipe (README record row).

The 1.2e-8 converged-train-MSE record (`scripts/lv_record.py`) is a
single seed-0 run; the reference likewise publishes single-seed numbers
(`trend_plotter.py:7-8`, seeded `Random.seed!(rng, 0)` at
`LV_driver_KANODE.jl:114`). This script answers "is the record an init
lottery?": the identical 30k-iteration iqf recipe over 8 init seeds,
reporting per-seed best reference-protocol train MSE + full-horizon
test MSE and the spread. Loss-closure objects are built once per
solve_mode and shared across seeds so every run after the first is a
pure compile-cache hit (CLAUDE.md in-process memo rules).

Writes artifacts/lv_seed_robustness.json.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from kanodes.experiments import lv  # noqa: E402
from kanodes.train.loop import TrainConfig, train  # noqa: E402

OUT = "artifacts/lv_seed_robustness.json"
SEEDS = list(range(8))
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
          ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000)]
BASIS = "iqf"   # the record basis (artifacts/basis_compare.json)


def main():
    base = lv.LVConfig(impl="fused", basis=BASIS)
    data = lv.make_data(base)
    model = lv.make_model(base)
    # one closure set per solve_mode, shared across ALL seeds
    fns = {}
    for mode, L, _, _ in PHASES:
        key = (mode, L)
        if key not in fns:
            fns[key] = lv.make_ode_fns(
                dataclasses.replace(base, solve_mode=mode,
                                    segment_len=max(L, 1)), model, data)

    runs = []
    for seed in SEEDS:
        params = lv.init_params(base, model,
                                key=jax.random.PRNGKey(seed))
        opt_state, prev = None, None
        best_traj = float("inf")
        t0 = time.time()
        for mode, L, lr, iters in PHASES:
            key = (mode, L)
            loss_fn, _, _ = fns[key]
            if opt_state is not None and key == prev:
                opt_state = opt_state._replace(hyperparams={
                    **opt_state.hyperparams,
                    "learning_rate": jnp.asarray(lr, jnp.float32)})
            else:
                opt_state = None
            out = train(loss_fn, params, TrainConfig(lr=lr, iters=iters,
                                                     eval_every=iters),
                        opt_state=opt_state)
            params, opt_state, prev = out["params"], out["opt_state"], key
            if mode == "fixed":
                best_traj = min(best_traj, float(out["best_loss"]))
        jax.block_until_ready(params)
        tl, te, _ = fns[("fixed", 0)]
        rec = {"seed": seed, "best_traj_train_mse": best_traj,
               "final_traj_train_mse": float(tl(params)),
               "test_full_horizon_mse": float(te(params)),
               "seconds": round(time.time() - t0, 1)}
        print(json.dumps(rec), flush=True)
        runs.append(rec)

    best = np.asarray([r["best_traj_train_mse"] for r in runs])
    test = np.asarray([r["test_full_horizon_mse"] for r in runs])
    summary = {
        "basis": BASIS, "iters_per_seed": sum(p[3] for p in PHASES),
        "n_seeds": len(SEEDS),
        "best_traj_train_mse": {
            "min": float(best.min()), "median": float(np.median(best)),
            "max": float(best.max())},
        "test_full_horizon_mse": {
            "min": float(test.min()), "median": float(np.median(test)),
            "max": float(test.max())},
        "reference_loss": 8.3e-7,
        "seeds_beating_reference": int((best < 8.3e-7).sum()),
        "runs": runs,
    }
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", OUT)
    print(json.dumps({k: summary[k] for k in
                      ("best_traj_train_mse", "test_full_horizon_mse",
                       "seeds_beating_reference")}))


if __name__ == "__main__":
    main()
