"""The LV seed-robustness sweep as ONE PACKED (block-diagonal) program.

Third rung of the seed-sweep ladder (artifacts: lv_seed_robustness /
lv_multiseed_vmapped / this):
  * sequential: 8 runs, 62.6 s total;
  * vmapped (train() vector mode over stacked params): exact parity,
    40.9 s — the member axis lifts into the Pallas kernel GRID, which
    serializes the latency-bound in-kernel step chain 8x;
  * packed (`models/packed.py`): the 8 member chains ride as
    block-diagonal weights of ONE [16, 80, 16] chain — the member axis
    becomes GEMM width, which is free at these sizes, so
    the whole ensemble steps at ~single-member latency.

Per-member best train MSE comes from the per-iteration [iters, S] loss
history (same definition as the sequential sweep's per-iter best
tracking); final/test metrics are measured on the extracted members
through the single-member closures.

Writes artifacts/lv_multiseed_packed.json.
Usage: python scripts/lv_multiseed_packed.py
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
from kanodes.models.packed import (apply_mask, block_mask,  # noqa: E402
                                   extract_member, member_mean,
                                   pack_chain, pack_params, tile_state)
from kanodes.train.loop import TrainConfig, train  # noqa: E402

OUT = "artifacts/lv_multiseed_packed.json"
SEEDS = list(range(8))
# identical recipe to scripts/lv_seed_robustness.py
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000),
          ("fixed", 0, 3e-4, 7_000), ("fixed", 0, 1e-4, 7_000)]
BASIS = "iqf"


def main():
    S = len(SEEDS)
    base = lv.LVConfig(impl="fused", basis=BASIS)
    data = lv.make_data(base)
    model = lv.make_model(base)
    packed_model = pack_chain(model, S)
    pdata = {"ts": data["ts"], "X": tile_state(data["X"], S),
             "n_train": data["n_train"]}
    mask = block_mask(model, S)

    fns = {}
    for mode, L, _, _ in PHASES:
        key = (mode, L)
        if key not in fns:
            loss_s, eval_s, _ = lv.make_ode_fns(
                dataclasses.replace(base, solve_mode=mode,
                                    segment_len=max(L, 1)),
                packed_model, pdata, reduce_fn=member_mean(S))
            fns[key] = (
                lambda p, f=loss_s: f(apply_mask(mask, p)),
                lambda p, f=eval_s: f(apply_mask(mask, p)))

    packed = pack_params(
        model, [lv.init_params(base, model, key=jax.random.PRNGKey(s))
                for s in SEEDS])

    opt_state, prev = None, None
    best_traj = np.full(S, np.inf)
    t_total0 = time.time()
    phase_secs = []
    for mode, L, lr, iters in PHASES:
        key = (mode, L)
        vloss, veval = fns[key]
        if opt_state is not None and key == prev:
            opt_state = opt_state._replace(hyperparams={
                **opt_state.hyperparams,
                "learning_rate": jnp.asarray(lr, jnp.float32)})
        else:
            opt_state = None
        t0 = time.time()
        out = train(vloss, packed, TrainConfig(lr=lr, iters=iters,
                                               eval_every=iters),
                    opt_state=opt_state)
        jax.block_until_ready(out["params"])
        phase_secs.append(round(time.time() - t0, 2))
        packed, opt_state, prev = out["params"], out["opt_state"], key
        if mode == "fixed":
            # per-member best over the per-iteration [iters, S] history —
            # the same per-iter best definition as the sequential sweep
            best_traj = np.minimum(
                best_traj, np.asarray(out["loss_history"]).min(axis=0))
    total = round(time.time() - t_total0, 1)

    ref_loss, ref_eval, _ = lv.make_ode_fns(
        dataclasses.replace(base, solve_mode="fixed"), model, data)
    runs = []
    for i, seed in enumerate(SEEDS):
        p = extract_member(model, packed, S, i)
        runs.append({"seed": seed,
                     "best_traj_train_mse": float(best_traj[i]),
                     "final_traj_train_mse": float(ref_loss(p)),
                     "test_full_horizon_mse": float(ref_eval(p))})
        print(json.dumps(runs[-1]), flush=True)

    best = np.asarray([r["best_traj_train_mse"] for r in runs])
    others = {}
    for name, path in (("sequential", "artifacts/lv_seed_robustness.json"),
                       ("vmapped", "artifacts/lv_multiseed_vmapped.json")):
        try:
            with open(path) as f:
                a = json.load(f)
            others[name] = (a["total_seconds"] if "total_seconds" in a
                            else sum(r["seconds"] for r in a["runs"]))
        except OSError:
            pass
    summary = {
        "basis": BASIS, "n_seeds": S,
        "iters_per_seed": sum(p[3] for p in PHASES),
        "mode": "packed block-diagonal (models/packed.py, one chain)",
        "best_traj_train_mse": {
            "min": float(best.min()), "median": float(np.median(best)),
            "max": float(best.max())},
        "reference_loss": 8.3e-7,
        "seeds_beating_reference": int((best < 8.3e-7).sum()),
        "phase_seconds": phase_secs,
        "total_seconds": total,
        "other_sweeps_seconds": others,
        "runs": runs,
    }
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", OUT)
    print(json.dumps({k: summary[k] for k in
                      ("best_traj_train_mse", "seeds_beating_reference",
                       "phase_seconds", "total_seconds",
                       "other_sweeps_seconds")}))


if __name__ == "__main__":
    main()
