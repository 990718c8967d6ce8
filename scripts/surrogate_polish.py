"""Second-order polish of the PDE-surrogate full-budget records.

The full-budget Adam runs (`scripts/surrogate_full.py`) end with a huge
gap between their BEST transient snapshot MSE (seen mid-phase at some
eval) and their END value — e.g. Schrödinger 3.2e-14 best vs 1.2e-10
end — because at the f32 floor Adam wanders a converged minimum by ~lr
(CLAUDE.md numerics notes). The L-BFGS polish (`train/polish.py`)
turns the transient into a deliverable: starting from the SAVED
end-of-run params it descends with curvature to a stationary point and
returns the best-so-far params, which `*_polished_params.npy` then
holds as a reproducible artifact (the Adam "best" params were never
saved — only end-of-phase ones are).

Runs with an exact-f32 backward (`bwd_precision="highest"`): at
1e-13-class losses bf16 gradient noise exceeds the signal.

Usage: python scripts/surrogate_polish.py [iters]
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
from kanodes.train.polish import PolishConfig, polish

OUT = "artifacts/surrogate_polish.json"

# (problem, rk_solver, substeps) matching each committed record run;
# params tag = the file surrogate_full.py wrote for that config
RUNS = [
    ("schrodinger", "rk4", 24, "schrodinger_full_rk4_bf16"),
    ("allen_cahn", "rk4", 24, "allen_cahn_full_rk4_bf16"),
    ("burgers", "tsit5", 20, "burgers_full_bf16"),
]


def one(problem: str, rk_solver: str, substeps: int, tag: str,
        iters: int) -> dict | None:
    src = f"artifacts/{tag}_params.npy"
    if not os.path.exists(src):
        print(f"skip {tag}: {src} missing", flush=True)
        return None
    params = jax.tree_util.tree_map(
        jnp.asarray, np.load(src, allow_pickle=True).item())
    cfg = SurrogateConfig(problem=problem, impl="fused",
                          rk_solver=rk_solver, substeps=substeps,
                          solve_mode="fixed", bwd_precision="highest")
    data = make_data(cfg)
    model = make_model(cfg, data)
    loss_fn, _, _ = make_fns(cfg, model, data)

    before = float(loss_fn(params))
    t0 = time.time()
    pol = polish(loss_fn, params, PolishConfig(iters=iters))
    jax.block_until_ready(pol["params"])
    secs = time.time() - t0

    out_npy = f"artifacts/{tag}_polished_params.npy"
    arr = np.empty((), dtype=object)
    arr[()] = jax.tree_util.tree_map(np.asarray, pol["params"])
    np.save(out_npy, arr, allow_pickle=True)

    rec = {"problem": problem, "params_src": src,
           "adam_end_snapshot_mse": before,
           "polished_snapshot_mse": float(pol["best_loss"]),
           "improvement_x": before / max(float(pol["best_loss"]), 1e-30),
           "polish_iters": iters, "polish_seconds": round(secs, 1),
           "polished_params": out_npy,
           "history_every25": [float(v)
                               for v in pol["loss_history"][::25]]}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    results = []
    for problem, rk, sub, tag in RUNS:
        r = one(problem, rk, sub, tag, iters)
        if r is not None:
            results.append(r)
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
