"""Capture the TRUE best-snapshot-MSE params of the surrogate records.

The committed full-budget runs (`scripts/surrogate_full.py`) report
`snapshot_mse_best` values (Schrödinger 3.2e-14, Allen-Cahn 1.1e-14)
that are TRANSIENTS of the eval cadence: at the f32 floor Adam wanders
a converged minimum by ~lr, so the end-of-phase params the script
saves sit orders of magnitude above the best point the run passed
through (measured: the saved Schrödinger end params evaluate to
1.9e-7). The reference has the same structure — it stores EVERY
iteration's params (`LV_driver_KANODE.jl:252-272`) precisely so the
paper model can be selected post hoc (`Plotting_standard.jl:105-110`).

This script re-runs the record recipe with
`train(..., record_history=True)` (a param snapshot at every eval
point, the bounded on-device version of the reference's p_list),
selects the argmin-eval snapshot across all phases
(`select_from_history`), additionally folds in the fixed-phase
per-ITERATION argmin (`track_best` on the trajectory objective), and
finally L-BFGS-polishes the winner (`train/polish.py`, exact-f32
backward). Artifacts:

  artifacts/{problem}_best_eval_params.npy    true argmin-eval params
  artifacts/{problem}_best_polished_params.npy  after curvature polish
  artifacts/{problem}_best_run.json           the numbers

Usage: python scripts/surrogate_best.py [schrodinger|allen_cahn] ...
One process per card.
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
import numpy as np

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from kanodes.experiments.pde_surrogate import (SurrogateConfig,
                                               make_data, make_model,
                                               make_fns)
from kanodes.train.checkpoint import select_from_history
from kanodes.train.loop import TrainConfig, train
from kanodes.train.polish import PolishConfig, polish

# the record configs and lr ladders of scripts/surrogate_full.py
# (rk4@24 for the stability-bound problems, tsit5@20 for
# advection-dominated Burgers)
PHASES_BY_PROBLEM = {
    "schrodinger": [("shooting", 1e-3, 50_000),
                    ("shooting", 1e-4, 30_000),
                    ("fixed", 3e-5, 20_000)],
    "allen_cahn": [("shooting", 1e-2, 50_000),
                   ("shooting", 1e-3, 30_000),
                   ("fixed", 3e-4, 20_000)],
    "burgers": [("shooting", 1e-2, 10_000),
                ("fixed", 1e-3, 10_000)],
    "allen_cahn_2d": [("shooting", 3e-3, 50_000),
                      ("shooting", 3e-4, 30_000),
                      ("fixed", 1e-4, 20_000)],
}
SOLVER_BY_PROBLEM = {"schrodinger": ("rk4", 24),
                     "allen_cahn": ("rk4", 24),
                     "burgers": ("tsit5", 20),
                     "allen_cahn_2d": ("rk4", 24)}


def run(problem: str, polish_iters: int = 150,
        fast: bool = False, seed: int | None = None) -> dict:
    """fast=True drops the 20k-iteration Adam trajectory phase — the
    capture runs measured it never produces the best iterate, so the
    fast recipe is shooting phases + capture + polish only (the
    headline time-to-stationary-record number). seed overrides the
    config's init seed (seed-robustness follow-ups,
    `scripts/surrogate_seed_robustness.py`); artifacts then carry a
    _seed{N} stem so the seed-0 record files are never clobbered."""
    solver, substeps = SOLVER_BY_PROBLEM[problem]
    base = SurrogateConfig(problem=problem, impl="fused",
                           rk_solver=solver, substeps=substeps,
                           bwd_precision="tf32",
                           max_iters_per_call=2_000, eval_every=500)
    if seed is not None:
        base = dataclasses.replace(base, seed=seed)
    data = make_data(base)
    model = make_model(base, data)
    fns = {m: make_fns(dataclasses.replace(base, solve_mode=m),
                       model, data)
           for m in {m for m, _, _ in PHASES_BY_PROBLEM[problem]}}

    params = model.init(jax.random.PRNGKey(base.seed))
    opt_state, prev_mode = None, None
    best = {"metric": float("inf"), "params": params, "where": "init"}
    t0 = time.time()
    phases = PHASES_BY_PROBLEM[problem]
    if fast:
        phases = [p for p in phases if p[0] == "shooting"]
    for pi, (mode, lr, iters) in enumerate(phases):
        train_loss, eval_loss, _ = fns[mode]
        if opt_state is not None and mode == prev_mode:
            opt_state = opt_state._replace(hyperparams={
                **opt_state.hyperparams,
                "learning_rate": jnp.asarray(lr, jnp.float32)})
        else:
            opt_state = None
        out = train(train_loss, params, TrainConfig(
            lr=lr, iters=iters, eval_every=base.eval_every,
            max_iters_per_call=base.max_iters_per_call),
            eval_fn=eval_loss, record_history=True, opt_state=opt_state)
        jax.block_until_ready(out["loss_history"])
        params, opt_state, prev_mode = out["params"], out["opt_state"], mode

        cand, idx, metric = select_from_history(out["param_history"],
                                                out["eval_history"])
        if float(metric) < best["metric"]:
            best = {"metric": float(metric), "params": cand,
                    "where": f"phase{pi}:eval{idx}"}
        # the fixed phase's train loss IS the snapshot metric, tracked
        # at cadence 1 by track_best — finer than the eval snapshots
        if mode == "fixed" and float(out["best_loss"]) < best["metric"]:
            best = {"metric": float(out["best_loss"]),
                    "params": out["best_params"],
                    "where": f"phase{pi}:iter_argmin"}
        print(f"[{problem}] phase {pi} {mode}: eval-best {metric:.3e} "
              f"end {float(out['eval_history'][-1]):.3e} "
              f"global best {best['metric']:.3e} ({best['where']})",
              flush=True)
    train_secs = time.time() - t0

    # exact-forward re-measure + curvature polish of the winner
    cfg_hi = dataclasses.replace(base, solve_mode="fixed",
                                 bwd_precision="highest")
    loss_hi, _, _ = make_fns(cfg_hi, model, data)
    best_re = float(loss_hi(best["params"]))
    t1 = time.time()
    pol = polish(loss_hi, best["params"], PolishConfig(iters=polish_iters))
    jax.block_until_ready(pol["params"])
    polish_secs = time.time() - t1

    def _save(tag, p):
        stem = f"{problem}_fast" if fast else f"{problem}_best"
        if seed is not None:
            stem = f"{stem}_seed{seed}"
        path = f"artifacts/{stem}_{tag}_params.npy"
        arr = np.empty((), dtype=object)
        arr[()] = jax.tree_util.tree_map(np.asarray, p)
        np.save(path, arr, allow_pickle=True)
        return path

    rec = {"problem": problem, "seed": seed,
           "recipe": "fast(shooting+polish)" if fast else "full",
           "best_snapshot_mse": best["metric"],
           "best_where": best["where"],
           "best_remeasured": best_re,
           "polished_snapshot_mse": float(pol["best_loss"]),
           "train_seconds": round(train_secs, 1),
           "polish_seconds": round(polish_secs, 1),
           "end_to_end_seconds": round(train_secs + polish_secs, 1),
           "best_params": _save("eval", best["params"]),
           "polished_params": _save("polished", pol["params"])}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    args = sys.argv[1:]
    fast = "--fast" in args
    seed = None
    if "--seed" in args:
        i = args.index("--seed")
        if i + 1 >= len(args) or not args[i + 1].lstrip("-").isdigit():
            sys.exit("usage: surrogate_best.py [--fast] [--seed N] "
                     "[problem ...]")
        seed = int(args[i + 1])
        del args[i:i + 2]
    problems = [a for a in args if not a.startswith("--")] \
        or ["schrodinger", "allen_cahn", "burgers"]
    out_path = ("artifacts/surrogate_fast.json" if fast
                else "artifacts/surrogate_best.json")
    if seed is not None:
        out_path = out_path.replace(".json", f"_seed{seed}.json")
    results = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    for p in problems:
        rec = run(p, fast=fast, seed=seed)
        results = [r for r in results if r["problem"] != p] + [rec]
        os.makedirs("artifacts", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    print("wrote", out_path)


if __name__ == "__main__":
    main()
