"""Deliverable LV record params: capture + L-BFGS polish (README row).

The committed LV record numbers (`artifacts/lv_record.json`) were
training transients: at the f32 loss floor Adam wanders a converged
minimum by ~lr, so end-of-run params sit far above the best point the
run passed through (CLAUDE.md best-capture doctrine; the reference
stores EVERY iteration's params for exactly this post-hoc selection,
`LV_driver_KANODE.jl:252-272`, `Plotting_standard.jl:105-110`).

This script makes the record DELIVERABLE for both headline bases: run
the 30k-iteration record recipe (shooting L=1 -> L=4 -> two trajectory
phases with optimizer-state continuity), capture the per-ITERATION
argmin-train-loss params of the trajectory phases (`track_best` — the
tracked loss IS the reference-protocol train MSE), then L-BFGS-polish
the winner on the exact-f32 trajectory objective. Artifacts:

  artifacts/lv_{basis}_best_eval_params.npy     captured argmin params
  artifacts/lv_{basis}_best_polished_params.npy after curvature polish
  artifacts/lv_best.json                        train AND test MSE

Usage: python scripts/lv_best.py [rbf iqf ...]
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

from kanodes.experiments import lv  # noqa: E402
from kanodes.train.loop import TrainConfig, train  # noqa: E402
from kanodes.train.polish import PolishConfig, polish  # noqa: E402

OUT = "artifacts/lv_best.json"
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
          ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000)]


def save_params(path: str, p) -> str:
    arr = np.empty((), dtype=object)
    arr[()] = jax.tree_util.tree_map(np.asarray, p)
    np.save(path, arr, allow_pickle=True)
    return path


def one(basis: str, polish_iters: int = 200) -> dict:
    base = lv.LVConfig(impl="fused", basis=basis)
    data = lv.make_data(base)
    model = lv.make_model(base)
    params = lv.init_params(base, model)
    fns = {}
    opt_state, prev = None, None
    best = {"train_mse": float("inf"), "params": params, "where": "init"}
    t0 = time.time()
    for pi, (mode, L, lr, iters) in enumerate(PHASES):
        key = (mode, L)
        if key not in fns:
            fns[key] = lv.make_ode_fns(
                dataclasses.replace(base, solve_mode=mode,
                                    segment_len=max(L, 1)), model, data)
        loss_fn, _, _ = fns[key]
        if opt_state is not None and key == prev:
            opt_state = opt_state._replace(hyperparams={
                **opt_state.hyperparams,
                "learning_rate": jnp.asarray(lr, jnp.float32)})
        else:
            opt_state = None
        out = train(loss_fn, params, TrainConfig(lr=lr, iters=iters,
                                                 eval_every=iters),
                    opt_state=opt_state)
        params, opt_state, prev = out["params"], out["opt_state"], key
        # the fixed-mode objective IS the reference-protocol train MSE;
        # track_best records its per-iteration argmin (cadence 1)
        if mode == "fixed" and float(out["best_loss"]) < best["train_mse"]:
            best = {"train_mse": float(out["best_loss"]),
                    "params": out["best_params"],
                    "where": f"phase{pi}:iter_argmin"}
        print(f"[lv/{basis}] phase {pi} {mode}: end "
              f"{float(out['loss_history'][-1]):.3e} best-capture "
              f"{best['train_mse']:.3e} ({best['where']})", flush=True)
    train_secs = time.time() - t0

    train_loss, test_loss, _ = fns[("fixed", 0)]
    cap_train = float(train_loss(best["params"]))
    cap_test = float(test_loss(best["params"]))

    t1 = time.time()
    pol = polish(train_loss, best["params"],
                 PolishConfig(iters=polish_iters))
    jax.block_until_ready(pol["params"])
    polish_secs = time.time() - t1
    pol_train = float(train_loss(pol["params"]))
    pol_test = float(test_loss(pol["params"]))

    rec = {"basis": basis, "iters": sum(p[3] for p in PHASES),
           "captured_train_mse": cap_train,
           "captured_test_mse": cap_test,
           "polished_train_mse": pol_train,
           "polished_test_mse": pol_test,
           "best_where": best["where"],
           "train_seconds": round(train_secs, 1),
           "polish_seconds": round(polish_secs, 1),
           "captured_params": save_params(
               f"artifacts/lv_{basis}_best_eval_params.npy",
               best["params"]),
           "polished_params": save_params(
               f"artifacts/lv_{basis}_best_polished_params.npy",
               pol["params"])}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    bases = [a for a in sys.argv[1:] if not a.startswith("--")] \
        or ["rbf", "iqf"]
    os.makedirs("artifacts", exist_ok=True)
    results = []
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    for b in bases:
        rec = one(b)
        results = [r for r in results if r["basis"] != b] + [rec]
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
