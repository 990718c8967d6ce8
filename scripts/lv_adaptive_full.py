"""Full-budget reference-faithful adaptive LV run (VERDICT round-1 #2).

Trains the LV KAN-ODE exactly in the reference regime — adaptive Tsit5
(rtol 1e-3 / atol 1e-6, OrdinaryDiffEq defaults), Adam 5e-4, 1e5
iterations, trajectory MSE objective over the 35-point train horizon
(`LV_driver_KANODE.jl:180-184,219-221`) — with reverse AD through the
bounded adaptive loop (the Zygote-through-Tsit5 analogue).

Resumable: relaunching continues from the latest checkpoint (params +
loss/test histories) until the total budget is reached. Run one process per
card.
"""

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
CKDIR = "checkpoints/lv_adaptive_full"

cfg = LVConfig(model="kan", solve_mode="adaptive", impl="xla",
               iters=TOTAL_ITERS, lr=5e-4, rtol=1e-3, atol=1e-6,
               max_steps=64, eval_every=100, max_iters_per_call=5_000)

prev = Checkpointer(CKDIR).latest_step() or 0
if prev >= TOTAL_ITERS:
    print(f"already done ({prev} iters)")
    sys.exit(0)
import dataclasses
cfg = dataclasses.replace(cfg, iters=TOTAL_ITERS - prev)
print(f"[lv_adaptive_full] running {cfg.iters} iters "
      f"(resuming from {prev})", flush=True)

t0 = time.time()
out = run(cfg, checkpoint_dir=CKDIR, restart=prev > 0, verbose=True)
jax.block_until_ready(out["loss_history"])
dt = time.time() - t0

result = {
    "iters_total": int(len(np.asarray(out["loss_history"]))),
    "final_train_mse": float(out["loss_history"][-1]),
    "best_train_mse": float(min(np.asarray(out["loss_history"]))),
    "final_test_mse": float(out["eval_history"][-1]),
    "wall_s_this_launch": round(dt, 1),
    "it_per_s": round(cfg.iters / dt, 1),
    "regime": "adaptive tsit5 rtol=1e-3 atol=1e-6, Adam 5e-4, "
              "trajectory MSE, max_steps=64 train / 282 eval",
}
print(json.dumps(result))
os.makedirs("artifacts", exist_ok=True)
with open("artifacts/lv_adaptive_full.json", "w") as f:
    json.dump(result, f, indent=1)
