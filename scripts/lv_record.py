"""Best-converged LV KAN-ODE training MSE (the README record row).

The 30k-iteration fused recipe (shooting L=1 -> L=4 -> two
trajectory-polish phases) with optimizer-state CONTINUITY across
same-objective phases (lr lives in opt_state via inject_hyperparams;
a fresh Adam restart shocks a converged minimum — CLAUDE.md). Runs the
recipe for the rbf (reference default) and iqf (best-converging local
basis, `artifacts/basis_compare.json`) fused chains and records the
reference-protocol trajectory train MSE + full-horizon test MSE.
Writes artifacts/lv_record.json.
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

from kanodes.experiments import lv  # noqa: E402
from kanodes.train.loop import TrainConfig, train  # noqa: E402

OUT = "artifacts/lv_record.json"
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
          ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000)]


def one(basis: str) -> dict:
    base = lv.LVConfig(impl="fused", basis=basis)
    data = lv.make_data(base)
    model = lv.make_model(base)
    params = lv.init_params(base, model)
    fns = {}
    opt_state, prev = None, None
    best_traj = float("inf")
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
        if mode == "fixed":   # this loss IS the reference-protocol MSE
            best_traj = min(best_traj, float(out["best_loss"]))
    jax.block_until_ready(params)
    tl, te, _ = fns[("fixed", 0)]
    rec = {"basis": basis, "iters": sum(p[3] for p in PHASES),
           "best_traj_train_mse": best_traj,
           "final_traj_train_mse": float(tl(params)),
           "test_full_horizon_mse": float(te(params)),
           "seconds": round(time.time() - t0, 1)}
    print(rec, flush=True)
    return rec


def main():
    results = [one("rbf"), one("iqf")]
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
