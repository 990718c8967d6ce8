"""Allen-Cahn surrogate at the FULL reference budget, grid refinement
vs fixed grid at a COARSE basis (VERDICT r2 #8: measured
accuracy-vs-budget delta).

Where refinement matters: when the basis RESOLUTION binds. At the
reference's G=10 the fixed grid already reaches the f32 loss floor
(1.9e-14 best, `artifacts/allen_cahn_full_rk4.json`) and a refit is
pure risk — measured: refitting after the warmup had converged to
1e-7 exploded the eval by the projection-error floor and the run never
recovered (first version of this script; preserved in git history).
So the demonstration runs BOTH arms at G=5, where resolution binds:

  refined:  a short shooting warmup (REFIT_AT=200 iters) -> span refit
            onto visited normalized
            inputs (`sparsify/grid_refine`) -> rest of the 1e5 budget;
  fixed:    the identical 1e5 schedule on the default [-1, 1] grid.

The refit changes the fused kernels' static grid constants (one fresh
kernel compile set) and restarts the optimizer (Adam moments for the
old basis are meaningless in the new one).

Artifact: artifacts/allen_cahn_grid_refine.json.
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

import jax.numpy as jnp
import numpy as np

from kanodes.experiments.pde_surrogate import (SurrogateConfig,
                                               make_data, make_model,
                                               make_fns)
from kanodes.sparsify.grid_refine import refine_kdense_chain_grid
from kanodes.train.loop import TrainConfig, train

KAN_GRID = 5
REFIT_AT = 200
PHASES = [("shooting", 1e-2, 49_800),     # post-refit remainder of 50k
          ("shooting", 1e-3, 30_000),
          ("fixed", 3e-4, 20_000)]

base = SurrogateConfig(problem="allen_cahn", impl="fused", kan_grid=KAN_GRID,
                       rk_solver="rk4", substeps=24,
                       max_iters_per_call=5_000, eval_every=500)
data = make_data(base)
model = make_model(base, data)
params = model.init(jax.random.PRNGKey(base.seed))

t_all = time.time()
history = []

# ---- phase 0: REFIT_AT-iter shooting warmup on the default grid ------------
cfg0 = dataclasses.replace(base, solve_mode="shooting")
train_loss, eval_loss, predict = make_fns(cfg0, model, data)
t0 = time.time()
out = train(train_loss, params,
            TrainConfig(lr=1e-2, iters=REFIT_AT, eval_every=500,
                        max_iters_per_call=base.max_iters_per_call),
            eval_fn=eval_loss)
params = out["params"]
history.append({"phase": "warmup", "iters": REFIT_AT,
                "snapshot_mse": float(out["eval_history"][-1]),
                "wall_s": round(time.time() - t0, 1)})
print(json.dumps(history[-1]), flush=True)

# ---- grid refit -------------------------------------------------------------
t0 = time.time()
samples = jnp.asarray(predict(params))
before = float(eval_loss(params))
model, params, info = refine_kdense_chain_grid(model, params, samples)
_, eval_new, _ = make_fns(dataclasses.replace(base, solve_mode="fixed"),
                          model, data)
after = float(eval_new(params))
info.update(eval_before=before, eval_after=after,
            wall_s=round(time.time() - t0, 1))
print(json.dumps(info), flush=True)

# ---- phases on the refined grid ---------------------------------------------
fns = {}
for mode in {m for m, _, _ in PHASES}:
    fns[mode] = make_fns(dataclasses.replace(base, solve_mode=mode),
                         model, data)
opt_state = None
prev_mode = None
best = float("inf")
for mode, lr, iters in PHASES:
    train_loss, eval_loss, _ = fns[mode]
    if opt_state is not None and mode == prev_mode:
        opt_state = opt_state._replace(hyperparams={
            **opt_state.hyperparams,
            "learning_rate": jnp.asarray(lr, jnp.float32)})
    else:
        opt_state = None
    t0 = time.time()
    out = train(train_loss, params,
                TrainConfig(lr=lr, iters=iters, eval_every=500,
                            max_iters_per_call=base.max_iters_per_call),
                eval_fn=eval_loss, opt_state=opt_state)
    params = out["params"]
    opt_state = out["opt_state"]
    prev_mode = mode
    snap_best = float(jnp.min(out["eval_history"]))
    best = min(best, snap_best)
    history.append({"phase": mode, "lr": lr, "iters": iters,
                    "snapshot_mse": float(out["eval_history"][-1]),
                    "snapshot_mse_best": snap_best,
                    "it_per_s": round(iters / (time.time() - t0), 1),
                    "wall_s": round(time.time() - t0, 1)})
    print(json.dumps(history[-1]), flush=True)

# ---- fixed-grid arm: identical budget/schedule, default grid ---------------
print("[fixed-grid arm]", flush=True)
model_f = make_model(base, data)
params_f = model_f.init(jax.random.PRNGKey(base.seed))
fns_f = {}
for mode in {m for m, _, _ in [("shooting", 1e-2, REFIT_AT)] + PHASES}:
    fns_f[mode] = make_fns(dataclasses.replace(base, solve_mode=mode),
                           model_f, data)
opt_state = None
prev_mode = None
best_f = float("inf")
hist_f = []
for mode, lr, iters in [("shooting", 1e-2, REFIT_AT)] + PHASES:
    train_loss, eval_loss, _ = fns_f[mode]
    if opt_state is not None and mode == prev_mode:
        opt_state = opt_state._replace(hyperparams={
            **opt_state.hyperparams,
            "learning_rate": jnp.asarray(lr, jnp.float32)})
    else:
        opt_state = None
    t0 = time.time()
    out = train(train_loss, params_f,
                TrainConfig(lr=lr, iters=iters, eval_every=500,
                            max_iters_per_call=base.max_iters_per_call),
                eval_fn=eval_loss, opt_state=opt_state)
    params_f = out["params"]
    opt_state = out["opt_state"]
    prev_mode = mode
    snap_best = float(jnp.min(out["eval_history"]))
    best_f = min(best_f, snap_best)
    hist_f.append({"phase": mode, "lr": lr, "iters": iters,
                   "snapshot_mse": float(out["eval_history"][-1]),
                   "snapshot_mse_best": snap_best,
                   "wall_s": round(time.time() - t0, 1)})
    print(json.dumps(hist_f[-1]), flush=True)

g10_ref = None
if os.path.exists("artifacts/allen_cahn_full_rk4.json"):
    with open("artifacts/allen_cahn_full_rk4.json") as f:
        fr = json.load(f)
    g10_ref = {"end": fr["history"][-1]["snapshot_mse"],
               "best": fr.get("best_snapshot_mse")}

result = {
    "kan_grid": KAN_GRID,
    "refit": info, "history_refined": history,
    "history_fixed": hist_f,
    "refined": {"end": history[-1]["snapshot_mse"], "best": best},
    "fixed": {"end": hist_f[-1]["snapshot_mse"], "best": best_f},
    "total_iters": REFIT_AT + sum(p[2] for p in PHASES),
    "total_wall_s": round(time.time() - t_all, 1),
    "g10_fixed_reference": g10_ref,
}
with open("artifacts/allen_cahn_grid_refine.json", "w") as f:
    json.dump(result, f, indent=1)
print(json.dumps({k: result[k] for k in
                  ("refined", "fixed", "total_wall_s",
                   "g10_fixed_reference")}))
