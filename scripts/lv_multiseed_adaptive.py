"""Reference-faithful ADAPTIVE protocol riding the packed ensemble.

Round-4 verdict gap: the reference's canonical LV training loop is
adaptive Tsit5 (`LV_driver_KANODE.jl:180-184`), but packed ensembles
shared ONE step controller, so a reference-faithful adaptive seed study
could not ride the packed path. Round 5 added per-member step control
(`ode.odeint_members`: per-member error norms, a per-member dt vector,
and per-member save-point clipping inside one bounded scan); this
script measures it at S=8:

  1. DEVICE PARITY at init: the packed per-member loss/eval vectors
     against each member's own sequential adaptive solve.
  2. THROUGHPUT: packed S=8 vs single-member sequential (same xla
     adaptive settings as the ab_throughput lv-adaptive case:
     max_steps=64, rtol=1e-3, atol=1e-6), warm call discarded, 3 timed
     repeats of the memoized chunk.
  3. TRAINING: a 10k-iteration packed adaptive train; records the
     per-member final losses.

Writes artifacts/lv_multiseed_adaptive.json.
Usage: python scripts/lv_multiseed_adaptive.py
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

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from kanodes.experiments import lv
from kanodes.models.packed import (apply_mask, block_mask, member_mean,
                                   pack_chain, pack_params, tile_state)
from kanodes.train.loop import TrainConfig, train

S = 8
ITERS = 5000


def timed_train(loss, params, iters, lr=5e-4):
    tcfg = TrainConfig(lr=lr, iters=iters, eval_every=iters)
    out = train(loss, params, tcfg, stacked=False)       # warm/compile
    jax.block_until_ready(out["loss_history"])
    reps = []
    for _ in range(3):
        t0 = time.time()
        out = train(loss, params, tcfg, stacked=False)
        jax.block_until_ready(out["loss_history"])
        reps.append(iters / (time.time() - t0))
    return out, sorted(reps)[1], reps


def main():
    cfg = lv.LVConfig(solve_mode="adaptive", impl="xla", max_steps=64,
                      rtol=1e-3, atol=1e-6, adjoint="direct")
    data = lv.make_data(cfg)
    model = lv.make_model(cfg)
    members = [jax.tree_util.tree_map(
        lambda x: x * cfg.init_scale, model.init(jax.random.PRNGKey(s)))
        for s in range(S)]
    packed_model = pack_chain(model, S)
    packed = pack_params(model, members)
    pdata = {"ts": data["ts"], "X": tile_state(data["X"], S),
             "n_train": data["n_train"]}
    loss_s, eval_s, _ = lv.make_ode_fns(cfg, packed_model, pdata,
                                        reduce_fn=member_mean(S),
                                        n_members=S)
    mask = block_mask(model, S)
    ploss = lambda p: loss_s(apply_mask(mask, p))

    # ---- 1. device parity at init -------------------------------------
    vec = np.asarray(jax.jit(ploss)(packed))
    evec = np.asarray(jax.jit(
        lambda p: eval_s(apply_mask(mask, p)))(packed))
    sloss, seval, _ = lv.make_ode_fns(cfg, model, data)
    seq_l = np.asarray([jax.jit(sloss)(m) for m in members])
    seq_e = np.asarray([jax.jit(seval)(m) for m in members])
    parity = {
        "max_rel_loss": float(np.max(np.abs(vec - seq_l) / seq_l)),
        "max_rel_eval": float(np.max(np.abs(evec - seq_e) / seq_e)),
    }
    assert parity["max_rel_loss"] < 3e-5, parity
    assert parity["max_rel_eval"] < 3e-5, parity
    print("parity:", parity)

    # ---- 2. throughput: packed S=8 vs sequential single-member --------
    _, packed_its, packed_reps = timed_train(ploss, packed, ITERS)
    p0 = members[0]
    _, seq_its, seq_reps = timed_train(sloss, p0, ITERS)
    print(f"packed S=8 adaptive: {packed_its:.0f} it/s "
          f"({8 * packed_its:.0f} member-it/s); sequential: "
          f"{seq_its:.0f} it/s -> per-member speedup "
          f"{8 * packed_its / seq_its:.2f}x")

    # ---- 3. a real 10k-iteration packed adaptive training run ---------
    t0 = time.time()
    out = train(ploss, packed, TrainConfig(lr=5e-4, iters=10_000,
                                           eval_every=10_000),
                stacked=False)
    jax.block_until_ready(out["loss_history"])
    train_secs = round(time.time() - t0, 2)
    finals = np.asarray(jax.jit(ploss)(out["params"]))
    print(f"10k-iter packed adaptive train: {train_secs} s; "
          f"final losses {finals}")

    rec = {
        "date": "2026-08-19", "device": jax.devices()[0].device_kind,
        "S": S, "iters_timed": ITERS,
        "settings": {"max_steps": 64, "rtol": 1e-3, "atol": 1e-6,
                     "solver": "tsit5", "impl": "xla"},
        "parity_at_init": parity,
        "packed_it_per_s": round(packed_its, 1),
        "packed_reps": [round(r, 1) for r in packed_reps],
        "member_it_per_s": round(8 * packed_its, 1),
        "sequential_it_per_s": round(seq_its, 1),
        "sequential_reps": [round(r, 1) for r in seq_reps],
        "per_member_speedup": round(8 * packed_its / seq_its, 2),
        "train_10k_seconds": train_secs,
        "train_10k_final_losses": [float(x) for x in finals],
    }
    path = os.path.join("artifacts", "lv_multiseed_adaptive.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
