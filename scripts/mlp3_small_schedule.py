"""29/57-param depth-3 MLP-NODE baselines: equal-budget staged schedule.

The constant-Adam(1e-2) reference regime leaves the TINY two-hidden-
layer MLPs in bad basins on this stack (29p best 1.0, 57p best 3.2e-2;
`artifacts/mlp3_full_budget.json`) — deep narrow tanh stacks are
init/lr sensitive. Same total 1e5-iteration budget, staged: a
multiple-shooting warmup (the easy segment objective finds the
oscillation) then trajectory-mode lr decay — the `mlp502_schedule.py`
precedent applied to the small d=3 rows. Targets (trend_plotter.py:13):
29p -> 2.0e-4, 57p -> 2.6e-4.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from kanodes.experiments.lv import LVConfig, run

TARGETS = {3: 2.0e-4, 5: 2.6e-4}
order = [int(a) for a in sys.argv[1:]] or [5, 3]

with open("artifacts/mlp3_full_budget.json") as f:
    results = json.load(f)

for hidden in order:
    n_params = hidden * hidden + 6 * hidden + 2
    base = LVConfig(model="mlp", mlp_widths=(2, hidden, hidden, 2),
                    init_scale=1.0, impl="xla", rtol=1e-3, atol=1e-6,
                    max_steps=64, eval_every=500,
                    max_iters_per_call=10_000)
    phases = [
        dataclasses.replace(base, solve_mode="shooting", segment_len=1,
                            lr=1e-2, iters=15_000),
        dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                            lr=3e-3, iters=15_000),
        dataclasses.replace(base, solve_mode="adaptive", lr=1e-3,
                            iters=40_000, max_iters_per_call=5_000),
        dataclasses.replace(base, solve_mode="adaptive", lr=3e-4,
                            iters=30_000, max_iters_per_call=5_000),
    ]
    params = None
    traj_hists = []
    t0 = time.time()
    for cfg in phases:
        print(f"[{n_params}p] {cfg.solve_mode} lr={cfg.lr} "
              f"iters={cfg.iters}", flush=True)
        out = run(cfg, params=params)
        jax.block_until_ready(out["loss_history"])
        params = out["params"]
        h = np.asarray(out["loss_history"])
        if cfg.solve_mode == "adaptive":      # trajectory-MSE phases
            traj_hists.append(h)
        print(f"  -> final {h[-1]:.3e} best {h.min():.3e}", flush=True)
    dt = time.time() - t0
    hist = np.concatenate(traj_hists)
    rec = {"hidden": hidden, "widths": [2, hidden, hidden, 2],
           "iters": 100_000,
           "final_train_mse": float(hist[-1]),
           "best_train_mse": float(hist.min()),
           "final_test_mse": float(out["eval_history"][-1]),
           "reference_train_mse": TARGETS[hidden],
           "beats_reference": bool(hist.min() <= TARGETS[hidden]),
           "wall_s": round(dt, 1),
           "regime": ("equal 1e5-iter budget: shooting warmup (30k) + "
                      "adaptive-trajectory lr 1e-3 -> 3e-4 (70k); "
                      "best/final over the trajectory-MSE phases")}
    print(json.dumps(rec), flush=True)
    results[str(n_params)] = rec
    with open("artifacts/mlp3_full_budget.json", "w") as f:
        json.dump(results, f, indent=1)
