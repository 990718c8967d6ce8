"""Seed robustness of the surrogate records (README record rows).

The committed surrogate records (Burgers 3.8e-14, Allen-Cahn 3.5e-15,
Schrödinger 6.7e-14 — `scripts/surrogate_best.py`) are single seed-0
runs, like the reference's own published numbers
(`PDE examples/.../driver` scripts fix one rng). This script answers
"are the records an init lottery?": the fast record recipe (shooting
phases + best-eval capture + L-BFGS polish — measured in round 3 to
reproduce the stationary records without the never-winning Adam
trajectory phase) over 5 init seeds per problem, reporting the spread
of polished snapshot MSEs. Loss-closure objects are shared across
seeds so every run after the first is a pure compile-cache hit
(CLAUDE.md in-process memo rules).

Writes artifacts/surrogate_seed_robustness.json.
Usage: python scripts/surrogate_seed_robustness.py [problem ...]
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

from surrogate_best import PHASES_BY_PROBLEM, SOLVER_BY_PROBLEM  # noqa: E402

OUT = "artifacts/surrogate_seed_robustness.json"
SEEDS = list(range(5))          # seed 0 = the committed record's init
POLISH_ITERS = 60
# committed polished records (artifacts/surrogate_best.json) for context
RECORD = {"burgers": 3.81e-14, "allen_cahn": 3.49e-15,
          "schrodinger": 6.70e-14, "allen_cahn_2d": 3.09e-13}


def run_problem(problem: str) -> dict:
    solver, substeps = SOLVER_BY_PROBLEM[problem]
    base = SurrogateConfig(problem=problem, impl="fused",
                           rk_solver=solver, substeps=substeps,
                           bwd_precision="tf32",
                           max_iters_per_call=2_000, eval_every=500)
    data = make_data(base)
    model = make_model(base, data)
    phases = [p for p in PHASES_BY_PROBLEM[problem] if p[0] == "shooting"]
    fns = {"shooting": make_fns(
        dataclasses.replace(base, solve_mode="shooting"), model, data)}
    cfg_hi = dataclasses.replace(base, solve_mode="fixed",
                                 bwd_precision="highest")
    loss_hi, _, _ = make_fns(cfg_hi, model, data)

    runs = []
    for seed in SEEDS:
        params = model.init(jax.random.PRNGKey(seed))
        opt_state, first = None, True
        best = {"metric": float("inf"), "params": params}
        t0 = time.time()
        for mode, lr, iters in phases:
            train_loss, eval_loss, _ = fns[mode]
            if opt_state is not None and not first:
                opt_state = opt_state._replace(hyperparams={
                    **opt_state.hyperparams,
                    "learning_rate": jnp.asarray(lr, jnp.float32)})
            out = train(train_loss, params, TrainConfig(
                lr=lr, iters=iters, eval_every=base.eval_every,
                max_iters_per_call=base.max_iters_per_call),
                eval_fn=eval_loss, record_history=True,
                opt_state=opt_state)
            jax.block_until_ready(out["loss_history"])
            params, opt_state, first = out["params"], out["opt_state"], False
            cand, _, metric = select_from_history(out["param_history"],
                                                  out["eval_history"])
            if float(metric) < best["metric"]:
                best = {"metric": float(metric), "params": cand}
        pol = polish(loss_hi, best["params"],
                     PolishConfig(iters=POLISH_ITERS))
        jax.block_until_ready(pol["params"])
        rec = {"seed": seed,
               "best_snapshot_mse": best["metric"],
               "polished_snapshot_mse": float(pol["best_loss"]),
               "seconds": round(time.time() - t0, 1)}
        print(f"[{problem}] {json.dumps(rec)}", flush=True)
        runs.append(rec)

    pol = np.asarray([r["polished_snapshot_mse"] for r in runs])
    return {"problem": problem, "n_seeds": len(SEEDS),
            "recipe": "fast(shooting+capture+polish)",
            "phases": phases, "polish_iters": POLISH_ITERS,
            "committed_record": RECORD.get(problem),
            "polished_snapshot_mse": {
                "min": float(pol.min()), "median": float(np.median(pol)),
                "max": float(pol.max())},
            "runs": runs}


def main():
    problems = sys.argv[1:] or ["burgers", "allen_cahn", "schrodinger"]
    results = []
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    for p in problems:
        summary = run_problem(p)
        results = [r for r in results if r["problem"] != p] + [summary]
        os.makedirs("artifacts", exist_ok=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
        print(json.dumps({k: summary[k] for k in
                          ("problem", "polished_snapshot_mse")}),
              flush=True)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
