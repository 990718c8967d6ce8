"""Full-budget MLP-NODE baselines (VERDICT round-1 #4 / missing #2).

Reference regime, exactly: `LV_driver_MLP.jl:92-97` — Dense(2,H,tanh)
-> Dense(H,2), Adam(1e-2), 1e5 iterations, trajectory MSE over the
35-point train horizon, adaptive Tsit5. Sizes 52/252/502 params;
targets 4.7e-4 / 4.14e-5 / 1.6e-5 (`trend_plotter.py:10-11`).

Resumable per size via checkpoints. One process per card.
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
from kanodes.train.checkpoint import Checkpointer

TOTAL_ITERS = 100_000
TARGETS = {10: 4.7e-4, 50: 4.14e-5, 100: 1.6e-5}   # hidden -> ref loss

results = {}
out_path = "artifacts/mlp_full_budget.json"
if os.path.exists(out_path):
    with open(out_path) as f:
        results = json.load(f)

for hidden in (100, 50, 10):
    n_params = 2 * hidden + hidden + hidden * 2 + 2
    key = str(n_params)
    if key in results and results[key].get("iters", 0) >= TOTAL_ITERS:
        print(f"[{n_params}p] already done")
        continue
    ckdir = f"checkpoints/mlp_full_{hidden}"
    cfg = LVConfig(model="mlp", mlp_widths=(2, hidden, 2),
                   init_scale=1.0, solve_mode="adaptive", impl="xla",
                   rtol=1e-3, atol=1e-6, max_steps=64,
                   lr=1e-2, iters=TOTAL_ITERS, eval_every=500,
                   max_iters_per_call=5_000)
    prev = Checkpointer(ckdir).latest_step() or 0
    if prev >= TOTAL_ITERS:
        continue
    cfg = dataclasses.replace(cfg, iters=TOTAL_ITERS - prev)
    print(f"[{n_params}p] running {cfg.iters} iters (resume from {prev})",
          flush=True)
    t0 = time.time()
    out = run(cfg, checkpoint_dir=ckdir, restart=prev > 0, verbose=True)
    jax.block_until_ready(out["loss_history"])
    dt = time.time() - t0
    hist = np.asarray(out["loss_history"])
    results[key] = {
        "hidden": hidden,
        "iters": int(len(hist)),
        "final_train_mse": float(hist[-1]),
        "best_train_mse": float(hist.min()),
        "final_test_mse": float(out["eval_history"][-1]),
        "reference_train_mse": TARGETS[hidden],
        "beats_reference": bool(hist.min() <= TARGETS[hidden]),
        "wall_s": round(dt, 1),
        "it_per_s": round(cfg.iters / dt, 1),
        "regime": "adaptive tsit5 rtol=1e-3, Adam 1e-2, trajectory MSE",
    }
    os.makedirs("artifacts", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results[key]), flush=True)

print(json.dumps(results, indent=1))
