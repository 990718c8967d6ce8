"""Full-budget depth-3 MLP-NODE baselines (VERDICT r2 #5, C12).

The reference's "MLP-NODE, d=3" trend rows (`trend_plotter.py:13-14`)
are two-hidden-layer [2,h,h,2] tanh MLPs — h^2+6h+2 params gives
exactly 29/57/114/162/522 at h=3/5/8/10/20 ("d" counts depth, not
species; the d=2 rows 52/252/502 are [2,h,2] at h=10/50/100 by the same
arithmetic). Reference regime, exactly as the d=2 sweep
(`LV_driver_MLP.jl:92-97`): Adam(1e-2), 1e5 iterations, trajectory MSE
over the 35-point train horizon, adaptive Tsit5.

Targets: 29->2.0e-4, 57->2.6e-4, 114->3.6e-5, 162->3.7e-5, 522->2.96e-5.
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
TARGETS = {3: 2.0e-4, 5: 2.6e-4, 8: 3.6e-5, 10: 3.7e-5, 20: 2.96e-5}

results = {}
out_path = "artifacts/mlp3_full_budget.json"
if os.path.exists(out_path):
    with open(out_path) as f:
        results = json.load(f)

order = [int(a) for a in sys.argv[1:]] or [20, 10, 8, 5, 3]
for hidden in order:
    n_params = hidden * hidden + 6 * hidden + 2
    key = str(n_params)
    if key in results and results[key].get("iters", 0) >= TOTAL_ITERS:
        print(f"[{n_params}p] already done")
        continue
    ckdir = f"checkpoints/mlp3_full_{hidden}"
    cfg = LVConfig(model="mlp", mlp_widths=(2, hidden, hidden, 2),
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
        "widths": [2, hidden, hidden, 2],
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
