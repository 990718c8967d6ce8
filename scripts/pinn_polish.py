"""L-BFGS polish of the gate-passing adaptive PINN (NEXT_STEPS #4).

The strain-limiting PINN selects `best_params` by a physics-aware
validation metric, but its Adam phases wander at the floor exactly like
the surrogate runs did (EXPERIMENTS.md best-capture section). The loss
resamples collocation points per epoch, so the polish needs a FIXED
objective: `pinn.train.polish_pinn` freezes one val-sized stratified
batch from an untouched rng stream and minimizes the full composite
loss at final curriculum weight (pde_w = 1).

This script loads the committed `artifacts/pinn_adaptive_best_params.npy`
(produced by scripts/pinn_full.py: PINNConfig(adam_epochs=6000,
finetune_epochs=4000, n_adaptive=256, adaptive_candidates=1024)),
polishes it, and reports cross_verification + all 5 acceptance gates
(eval_pass_fail.py:33-38) before and after, plus the recomputed
selection metric on the training-time validation batch.
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

from kanodes.diag.gates import evaluate, report
from kanodes.pinn import geometry as G
from kanodes.pinn import losses as L
from kanodes.pinn.model import KANPINN
from kanodes.pinn.train import (PINNConfig, cross_verification,
                                polish_pinn, validation_selection)

CFG = PINNConfig(adam_epochs=6000, finetune_epochs=4000,
                 n_adaptive=256, adaptive_candidates=1024)
PARAMS_PATH = "artifacts/pinn_adaptive_best_params.npy"


def load_out() -> dict:
    params = np.load(PARAMS_PATH, allow_pickle=True)[()]
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    model = KANPINN(CFG.widths, CFG.n_basis, CFG.trainable_centers)
    geo, mat = G.Geometry(), L.Material()
    best_val = validation_selection(CFG, geo, mat, model, params)
    return {"model": model, "params": params, "best_params": params,
            "best_val": best_val, "cfg": CFG, "geo": geo, "mat": mat}


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    n_batches = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    out = load_out()
    diag_before = cross_verification(out)
    res_before = evaluate(diag_before)
    print("BEFORE polish:", flush=True)
    print(report(res_before), flush=True)

    t0 = time.time()
    pol = polish_pinn(out, iters=iters, n_batches=n_batches)
    jax.block_until_ready(pol["params"])
    polish_secs = time.time() - t0
    hist = np.asarray(pol["loss_history"])
    print(f"polish: frozen-objective {hist[0]:.6g} -> "
          f"{float(pol['best_loss']):.6g} in {polish_secs:.1f}s "
          f"({iters} L-BFGS iters)", flush=True)

    out_pol = {**out, "best_params": pol["params"],
               "best_val": validation_selection(CFG, out["geo"],
                                                out["mat"], out["model"],
                                                pol["params"])}
    diag_after = cross_verification(out_pol)
    res_after = evaluate(diag_after)
    print("AFTER polish:", flush=True)
    print(report(res_after), flush=True)

    arr = np.empty((), dtype=object)
    arr[()] = jax.tree_util.tree_map(np.asarray, pol["params"])
    np.save("artifacts/pinn_polished_params.npy", arr, allow_pickle=True)

    payload = {
        "polish_iters": iters,
        "n_batches": n_batches,
        "polish_seconds": round(polish_secs, 1),
        "frozen_objective_start": float(hist[0]),
        "frozen_objective_best": float(pol["best_loss"]),
        "selection_before": float(out["best_val"]),
        "selection_after": float(out_pol["best_val"]),
        "before": {**diag_before, "all_gates_pass": res_before["passed"]},
        "after": {**diag_after, "all_gates_pass": res_after["passed"]},
        "polished_params": "artifacts/pinn_polished_params.npy",
    }
    with open("artifacts/pinn_polish.json", "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({k: v for k, v in payload.items()
                      if k not in ("before", "after")}), flush=True)


if __name__ == "__main__":
    main()
