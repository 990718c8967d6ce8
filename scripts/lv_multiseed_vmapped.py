"""The LV seed-robustness sweep as ONE vmapped device program.

`scripts/lv_seed_robustness.py` runs the 30k-iteration record recipe
sequentially over 8 init seeds (~5.8 s/seed steady-state, 62.6 s
total). This script trains the SAME 8 replicas simultaneously via
`train()`'s multi-seed vector-loss mode (params stacked on a leading
member axis, loss = jax.vmap(member_loss)).

Measured outcome (artifacts/lv_multiseed_vmapped.json): per-member
results BITWISE equal to the sequential sweep; total 40.9 s vs 62.6 s
(warm caches both). The win is dispatch/compile amortization, not free
redundancy — vmap lifts the member axis into the kernel, so the
latency-bound in-kernel step chain scales with S (latency, not FLOPs,
is the cost at these shapes).

Reference anchor: the reference's published numbers are single-seed
(`Lotka-Volterra/LV_driver_KANODE.jl:114`, `trend_plotter.py:7-8`);
seed studies there mean hand-edited sequential reruns.

Writes artifacts/lv_multiseed_vmapped.json.
Usage: python scripts/lv_multiseed_vmapped.py
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

import numpy as np

from kanodes.experiments import lv  # noqa: E402
from kanodes.train.loop import (TrainConfig, init_stacked,  # noqa: E402
                                member_params, train)

OUT = "artifacts/lv_multiseed_vmapped.json"
SEEDS = list(range(8))
# identical recipe to scripts/lv_seed_robustness.py
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
          ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000)]
BASIS = "iqf"


def main():
    base = lv.LVConfig(impl="fused", basis=BASIS)
    data = lv.make_data(base)
    model = lv.make_model(base)
    fns = {}
    for mode, L, _, _ in PHASES:
        key = (mode, L)
        if key not in fns:
            loss_fn, eval_fn, _ = lv.make_ode_fns(
                dataclasses.replace(base, solve_mode=mode,
                                    segment_len=max(L, 1)), model, data)
            fns[key] = (jax.vmap(loss_fn), jax.vmap(eval_fn), loss_fn,
                        eval_fn)

    stacked = init_stacked(
        lambda k: lv.init_params(base, model, key=k), SEEDS)

    opt_state, prev = None, None
    best_traj = np.full(len(SEEDS), np.inf)
    t_total0 = time.time()
    phase_secs = []
    for mode, L, lr, iters in PHASES:
        key = (mode, L)
        vloss = fns[key][0]
        if opt_state is not None and key == prev:
            opt_state = opt_state._replace(hyperparams={
                **opt_state.hyperparams,
                "learning_rate": jnp.asarray(lr, jnp.float32)})
        else:
            opt_state = None
        t0 = time.time()
        out = train(vloss, stacked, TrainConfig(lr=lr, iters=iters,
                                                eval_every=iters),
                    opt_state=opt_state)
        jax.block_until_ready(out["params"])
        phase_secs.append(round(time.time() - t0, 2))
        stacked, opt_state, prev = out["params"], out["opt_state"], key
        if mode == "fixed":
            best_traj = np.minimum(best_traj,
                                   np.asarray(out["best_loss"]))
    total = round(time.time() - t_total0, 1)

    _, _, tl, te = fns[("fixed", 0)]
    runs = []
    for i, seed in enumerate(SEEDS):
        p = member_params(stacked, i)
        runs.append({"seed": seed,
                     "best_traj_train_mse": float(best_traj[i]),
                     "final_traj_train_mse": float(tl(p)),
                     "test_full_horizon_mse": float(te(p))})
        print(json.dumps(runs[-1]), flush=True)

    best = np.asarray([r["best_traj_train_mse"] for r in runs])
    seq = None
    try:
        with open("artifacts/lv_seed_robustness.json") as f:
            seq = sum(r["seconds"]
                      for r in json.load(f)["runs"])
    except OSError:
        pass
    summary = {
        "basis": BASIS, "n_seeds": len(SEEDS),
        "iters_per_seed": sum(p[3] for p in PHASES),
        "mode": "vmapped (train() vector-loss, one device program)",
        "best_traj_train_mse": {
            "min": float(best.min()), "median": float(np.median(best)),
            "max": float(best.max())},
        "reference_loss": 8.3e-7,
        "seeds_beating_reference": int((best < 8.3e-7).sum()),
        "phase_seconds": phase_secs,
        "total_seconds": total,
        "sequential_sweep_seconds": seq,
        "runs": runs,
    }
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", OUT)
    print(json.dumps({k: summary[k] for k in
                      ("best_traj_train_mse", "seeds_beating_reference",
                       "phase_seconds", "total_seconds",
                       "sequential_sweep_seconds")}))


if __name__ == "__main__":
    main()
