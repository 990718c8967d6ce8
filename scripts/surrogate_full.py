"""Full-reference-budget PDE surrogate runs (usage:
`python scripts/surrogate_full.py [schrodinger|allen_cahn|burgers]`).

Matches each problem's reference budget (1e5 iters for Schrödinger /
Allen-Cahn, 2e4 for Burgers — `Schrodinger_Surrogate.jl:170-173`,
`Allen-Cahn_Surrogate.jl:82-87`, `Burgers_Surrogate.jl:82-88`) on the
fused path: snapshot-shooting warmup then trajectory polish, on
the fused MULTISTEP kernels (recompute-based backward; trajectory
mode is one whole-horizon kernel launch per iteration).

Phases that share a solve_mode share ONE set of loss closures, so the
train() chunk memo + injected learning rate make every phase after the
first a compile-cache hit; optimizer state is carried across same-mode
phases (a fresh Adam restart shocks a converged minimum).

Resumable at phase granularity via artifacts/<problem>_full.json.

Best-capture is the DEFAULT artifact path (round-3 finding): each
phase trains with record_history=True and the saved *_best_params.npy
is the argmin-eval SNAPSHOT across phases (select_from_history), not
an end-of-phase wander point; end params are still saved separately
for phase-resume continuity. For the polished stationary records use
scripts/surrogate_best.py (adds the L-BFGS polish).
"""

import json
import os
import sys
import time

PROBLEM = sys.argv[1] if len(sys.argv) > 1 else "schrodinger"
RK_SOLVER = sys.argv[2] if len(sys.argv) > 2 else "tsit5"
SUBSTEPS = int(sys.argv[3]) if len(sys.argv) > 3 else 20
BWD_PREC = sys.argv[4] if len(sys.argv) > 4 else "highest"
_TAG = "" if RK_SOLVER == "tsit5" else f"_{RK_SOLVER}"
if BWD_PREC != "highest":
    _TAG += f"_{BWD_PREC}"

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
from kanodes.train.checkpoint import select_from_history
from kanodes.train.loop import TrainConfig, train

OUT = f"artifacts/{PROBLEM}_full{_TAG}.json"
PARAMS_NPY = f"artifacts/{PROBLEM}_full{_TAG}_params.npy"
BEST_NPY = f"artifacts/{PROBLEM}_full{_TAG}_best_params.npy"
# (solve_mode, lr, iters) — 1e5 total, the reference Adam regime
# (Schrodinger_Surrogate.jl:170 lr 1e-3; Allen-Cahn/Burgers 1e-2).
# Continuation lrs are small: phase 0 already converges near the f32
# loss floor, and Adam's normalized steps wander a converged minimum
# by ~lr even with optimizer-state continuity.
PHASES_BY_PROBLEM = {
    "schrodinger": [("shooting", 1e-3, 50_000),
                    ("shooting", 1e-4, 30_000),
                    ("fixed", 3e-5, 20_000)],
    "allen_cahn": [("shooting", 1e-2, 50_000),
                   ("shooting", 1e-3, 30_000),
                   ("fixed", 3e-4, 20_000)],
    "burgers": [("shooting", 1e-2, 10_000),    # reference budget 2e4
                ("fixed", 1e-3, 10_000)],
    # beyond parity: 2-D full-state AC ([1024,10,1024] chain) at the
    # 1-D reference budget. lr is 3x cooler than 1-D AC: at 1024-wide
    # the 1e-2 schedule reaches 1.3e-6 then destabilizes (measured)
    "allen_cahn_2d": [("shooting", 3e-3, 50_000),
                      ("shooting", 3e-4, 30_000),
                      ("fixed", 1e-4, 20_000)],
}
PHASES = PHASES_BY_PROBLEM[PROBLEM]

base = SurrogateConfig(problem=PROBLEM, impl="fused",
                       rk_solver=RK_SOLVER, substeps=SUBSTEPS,
                       bwd_precision=BWD_PREC,
                       max_iters_per_call=2_000, eval_every=500)
data = make_data(base)
model = make_model(base, data)

# one fns set per solve_mode, shared across phases (jit-chunk reuse)
_fns = {}
for mode in {m for m, _, _ in PHASES}:
    import dataclasses
    cfg_m = dataclasses.replace(base, solve_mode=mode)
    _fns[mode] = make_fns(cfg_m, model, data)

state = {"phases_done": 0, "history": []}
if os.path.exists(OUT):
    with open(OUT) as f:
        state = json.load(f)

params = model.init(jax.random.PRNGKey(base.seed))
if state["phases_done"] > 0:
    params = jax.tree_util.tree_map(
        jnp.asarray, np.load(PARAMS_NPY,
                             allow_pickle=True).item())

t_all = time.time()
opt_state = None
prev_mode = None
best = {"snapshot_mse": float("inf"), "params": None}
for pi, (mode, lr, iters) in enumerate(PHASES):
    if pi < state["phases_done"]:
        prev_mode = mode
        continue
    train_loss, eval_loss, _ = _fns[mode]
    tc = TrainConfig(lr=lr, iters=iters, eval_every=base.eval_every,
                     max_iters_per_call=base.max_iters_per_call)
    # optimizer-state CONTINUITY across same-objective phases: a fresh
    # Adam restart at a lower lr shocks the model out of a converged
    # minimum (measured: 2.1e-10 -> 4.6e-6 on the phase-0/1 boundary).
    # The injected lr lives in opt_state.hyperparams, so the schedule
    # change is a state update, not a recompile.
    if opt_state is not None and mode == prev_mode:
        opt_state = opt_state._replace(hyperparams={
            **opt_state.hyperparams,
            "learning_rate": jnp.asarray(lr, jnp.float32)})
    else:
        opt_state = None
    print(f"[{PROBLEM}] phase {pi}: {mode} lr={lr} iters={iters}", flush=True)
    t0 = time.time()
    out = train(train_loss, params, tc, eval_fn=eval_loss,
                opt_state=opt_state, record_history=True)
    jax.block_until_ready(out["loss_history"])
    dt = time.time() - t0
    params = out["params"]
    opt_state = out["opt_state"]
    prev_mode = mode
    snap_mse = float(out["eval_history"][-1])
    snap_best = float(jnp.min(out["eval_history"]))
    # global best across phases: CAPTURE the argmin-eval snapshot, not
    # an end-of-phase wander point (at the f32 floor Adam wanders a
    # converged minimum by ~lr; the end params of a full run measured
    # 1000x worse than the best eval — EXPERIMENTS.md best-capture
    # section, LV_driver_KANODE.jl:252-272 p_list parity)
    cand, cap_idx, cap_metric = select_from_history(out["param_history"],
                                                    out["eval_history"])
    if float(cap_metric) < best["snapshot_mse"]:
        best = {"snapshot_mse": float(cap_metric), "params": cand,
                "where": f"phase{pi}:eval{int(cap_idx)}"}
    rec = {"phase": pi, "mode": mode, "lr": lr, "iters": iters,
           "wall_s": round(dt, 1), "it_per_s": round(iters / dt, 1),
           "train_loss": float(out["loss_history"][-1]),
           "snapshot_mse": snap_mse, "snapshot_mse_best": snap_best,
           "captured": {"metric": float(cap_metric),
                        "eval_idx": int(cap_idx)}}
    print(json.dumps(rec), flush=True)
    state["history"].append(rec)
    state["phases_done"] = pi + 1
    arr = np.empty((), dtype=object)
    arr[()] = jax.tree_util.tree_map(np.asarray, params)
    np.save(PARAMS_NPY, arr, allow_pickle=True)
    with open(OUT, "w") as f:
        json.dump(state, f, indent=1)

state["total_wall_s_last_launch"] = round(time.time() - t_all, 1)
state["total_iters"] = sum(p[2] for p in PHASES)
state["best_snapshot_mse"] = min(
    [h.get("snapshot_mse_best", h["snapshot_mse"])
     for h in state["history"]] + [float("inf")])
if best["params"] is not None:
    state["captured_best"] = {"metric": best["snapshot_mse"],
                              "where": best.get("where", "?"),
                              "path": BEST_NPY}
    arr = np.empty((), dtype=object)
    arr[()] = jax.tree_util.tree_map(np.asarray, best["params"])
    np.save(BEST_NPY, arr, allow_pickle=True)
with open(OUT, "w") as f:
    json.dump(state, f, indent=1)
print(json.dumps({"final_snapshot_mse": state["history"][-1]["snapshot_mse"],
                  "best_snapshot_mse": state["best_snapshot_mse"],
                  "total_iters": state["total_iters"]}))
