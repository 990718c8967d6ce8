"""Second-order polish of the LV converged-train-MSE record.

Runs the 30k-iteration fused record recipe (`scripts/lv_record.py`)
then hands the converged params to the L-BFGS polish
(`train/polish.py`) on the reference-protocol trajectory train MSE.
Separates the two possible explanations of the ~1e-8 Adam floor:
optimizer wander (polish goes lower) vs model capacity at 240 params
(polish plateaus). Writes artifacts/lv_polish.json.

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

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from kanodes.experiments import lv  # noqa: E402
from kanodes.train.loop import TrainConfig, train  # noqa: E402
from kanodes.train.polish import PolishConfig, polish  # noqa: E402

OUT = "artifacts/lv_polish.json"
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
          ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000)]


def one(basis: str, polish_iters: int) -> dict:
    base = lv.LVConfig(impl="fused", basis=basis)
    data = lv.make_data(base)
    model = lv.make_model(base)
    params = lv.init_params(base, model)
    fns = {}
    opt_state, prev = None, None
    best_traj, best_params = float("inf"), params
    t0 = time.time()
    for mode, L, lr, iters in PHASES:
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
        if mode == "fixed" and float(out["best_loss"]) < best_traj:
            best_traj = float(out["best_loss"])
            best_params = out["best_params"]
    adam_secs = time.time() - t0

    traj_loss, test_loss, _ = fns[("fixed", 0)]
    t1 = time.time()
    pol = polish(traj_loss, best_params,
                 PolishConfig(iters=polish_iters))
    jax.block_until_ready(pol["params"])
    polish_secs = time.time() - t1

    hist = [float(v) for v in pol["loss_history"][::25]]
    rec = {"basis": basis,
           "adam_best_traj_train_mse": best_traj,
           "adam_seconds": round(adam_secs, 1),
           "polish_iters": polish_iters,
           "polish_best_traj_train_mse": float(pol["best_loss"]),
           "polish_seconds": round(polish_secs, 1),
           "polish_test_full_horizon_mse": float(test_loss(pol["params"])),
           "improvement_x": best_traj / max(float(pol["best_loss"]), 1e-30),
           "polish_history_every25": hist}
    print(rec, flush=True)
    return rec


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    results = [one("rbf", iters), one("iqf", iters)]
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
