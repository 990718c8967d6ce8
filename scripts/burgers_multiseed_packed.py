"""The Burgers surrogate seed sweep as ONE PACKED block-diagonal program.

The LV packed sweep (`scripts/lv_multiseed_packed.py`) measured ~10x
per-member throughput at LV sizes ([2,10,2] members). This script
answers VERDICT r4 #4: does the win carry to the WIDE surrogate chains?
Five [41,10,41] Burgers members ride as block-diagonal weights of one
[205,50,205] chain through the whole-RK-step kernels (205*5 = 1025 is
under the kernel's width threshold).

Recipe = the sequential sweep's fast record recipe
(`scripts/surrogate_seed_robustness.py`: shooting 1e-2 x 10k +
best-eval capture + 60-iter L-BFGS polish), so per-member results are
directly comparable to artifacts/surrogate_seed_robustness.json.
Per-member best capture: train() vector mode records the packed param
history once per eval; each member's argmin over its own eval column
is extracted (`models/packed.extract_member`) and polished through the
SINGLE-member high-precision closure.

Writes artifacts/burgers_multiseed_packed.json.
Usage: python scripts/burgers_multiseed_packed.py
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

from kanodes.experiments.pde_surrogate import (SurrogateConfig,  # noqa: E402
                                               make_data, make_fns,
                                               make_model)
from kanodes.models.packed import (apply_mask, block_mask,  # noqa: E402
                                   extract_member, member_mean,
                                   pack_chain, pack_params)
from kanodes.train.loop import TrainConfig, train  # noqa: E402
from kanodes.train.polish import (PolishConfig,  # noqa: E402
                                  polish_members)

OUT = "artifacts/burgers_multiseed_packed.json"
SEEDS = list(range(5))
PHASES = [("shooting", 1e-2, 10_000)]   # the Burgers fast record recipe
POLISH_ITERS = 60


def main():
    S = len(SEEDS)
    base = SurrogateConfig(problem="burgers", impl="fused",
                           rk_solver="tsit5", substeps=20,
                           bwd_precision="tf32",
                           max_iters_per_call=2_000, eval_every=500)
    data = make_data(base)
    model = make_model(base, data)
    packed_model = pack_chain(model, S)
    pdata = dataclasses.replace(data, X=np.tile(data.X, (1, S)))
    mask = block_mask(model, S)

    cfg_sh = dataclasses.replace(base, solve_mode="shooting")
    loss_s, eval_s, _ = make_fns(cfg_sh, packed_model, pdata,
                                 reduce_fn=member_mean(S))
    vloss = lambda p: loss_s(apply_mask(mask, p))      # noqa: E731
    veval = lambda p: eval_s(apply_mask(mask, p))      # noqa: E731

    packed = pack_params(
        model, [model.init(jax.random.PRNGKey(s)) for s in SEEDS])

    # single-member closures for polish + final per-member metrics.
    # The polish objective rides the XLA path (plain jnp, f32-precision
    # dots): it vmaps over the member axis without a kernel compile
    # for 60 iterations of work. Final MSEs are then
    # re-evaluated through the SAME fused flow the sequential sweep
    # reported, so the recorded numbers stay directly comparable.
    cfg_hi = dataclasses.replace(base, solve_mode="fixed",
                                 bwd_precision="highest")
    loss_hi, _, _ = make_fns(cfg_hi, model, data)
    cfg_pol = dataclasses.replace(cfg_hi, impl="xla")
    loss_pol, _, _ = make_fns(cfg_pol, model, data)

    t_train0 = time.time()
    opt_state = None
    eval_hist, param_hist = [], []
    for mode, lr, iters in PHASES:
        if opt_state is not None:
            opt_state = opt_state._replace(hyperparams={
                **opt_state.hyperparams,
                "learning_rate": jnp.asarray(lr, jnp.float32)})
        out = train(vloss, packed, TrainConfig(
            lr=lr, iters=iters, eval_every=base.eval_every,
            max_iters_per_call=base.max_iters_per_call),
            eval_fn=veval, record_history=True, opt_state=opt_state)
        jax.block_until_ready(out["loss_history"])
        packed, opt_state = out["params"], out["opt_state"]
        eval_hist.append(np.asarray(out["eval_history"]))
        param_hist.append(out["param_history"])
    eval_hist = np.concatenate(eval_hist, axis=0)       # [n_evals, S]
    param_hist = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *param_hist)
    train_secs = round(time.time() - t_train0, 1)

    # per-member capture, then ONE vmapped polish over all members
    # (train/polish.polish_members): S sequential polish() calls each
    # paid a fresh jit compile + a separate dispatch chain — the
    # round-5 measurement showed that leg dominating the sweep.
    t_pol0 = time.time()
    ks = [int(np.argmin(eval_hist[:, s])) for s in range(S)]
    members = []
    for s in range(S):
        snap = jax.tree_util.tree_map(lambda x, k=ks[s]: x[k], param_hist)
        members.append(extract_member(model, snap, S, s))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *members)
    pol = polish_members(loss_pol, stacked,
                         PolishConfig(iters=POLISH_ITERS))
    jax.block_until_ready(pol["best_loss"])
    # report through the fused flow (the sequential sweep's convention)
    loss_hi_j = jax.jit(loss_hi)
    runs = []
    for s, seed in enumerate(SEEDS):
        member_pol = jax.tree_util.tree_map(lambda x: x[s], pol["params"])
        mse = float(loss_hi_j(member_pol))
        runs.append({"seed": seed,
                     "best_snapshot_mse": float(eval_hist[ks[s], s]),
                     "capture_eval_index": ks[s],
                     "polished_snapshot_mse": mse,
                     "polish_xla_mse": float(pol["best_loss"][s])})
        print(json.dumps(runs[-1]), flush=True)
    polish_secs = round(time.time() - t_pol0, 1)

    pol = np.asarray([r["polished_snapshot_mse"] for r in runs])
    seq = None
    try:
        with open("artifacts/surrogate_seed_robustness.json") as f:
            for rec in json.load(f):
                if rec["problem"] == "burgers":
                    seq = {"total_seconds":
                           round(sum(r["seconds"] for r in rec["runs"]), 1),
                           "polished_snapshot_mse":
                           rec["polished_snapshot_mse"]}
    except OSError:
        pass
    summary = {
        "problem": "burgers", "n_seeds": S,
        "mode": ("packed block-diagonal [205,50,205] via the "
                 "whole-RK-step kernels (models/packed.py + ops/rk_fused)"),
        "recipe": "fast(shooting+capture+vmapped polish_members)",
        "phases": PHASES, "polish_iters": POLISH_ITERS,
        "train_seconds": train_secs,
        "polish_seconds": polish_secs,
        "total_seconds": round(train_secs + polish_secs, 1),
        "sequential_sweep": seq,
        "polished_snapshot_mse": {
            "min": float(pol.min()), "median": float(np.median(pol)),
            "max": float(pol.max())},
        "runs": runs,
    }
    os.makedirs("artifacts", exist_ok=True)
    # keep the throughput A/B section measured by
    # scripts/burgers_packed_throughput.py, if present
    try:
        with open(OUT) as f:
            prev = json.load(f)
        if "throughput" in prev:
            summary["throughput"] = prev["throughput"]
    except OSError:
        pass
    with open(OUT, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", OUT)
    print(json.dumps({k: summary[k] for k in
                      ("train_seconds", "polish_seconds", "total_seconds",
                       "sequential_sweep", "polished_snapshot_mse")}))


if __name__ == "__main__":
    main()
