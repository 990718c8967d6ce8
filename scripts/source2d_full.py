"""2-D gray-box source recovery at the 1-D reference budgets
(beyond parity — the reference's source experiments are 1-D only,
`Fisher-KPP_Source.jl:33-70,170`, `Allen-Cahn_Source.jl:38-66,164`).

Usage: python scripts/source2d_full.py [fisher_kpp|allen_cahn]

Trains du/dt = D*lap2d(u) + kan.(u) on snapshots of the 32x32 periodic
truth on the Kronecker-factored fused kernel (L@U + U@L per stage) for
the problem's 1-D reference budget plus a small-lr continuation (Adam
wanders a converged minimum by ~lr; optimizer-state continuity per the
project's phase recipe), then recovers the hidden reaction law with
BOTH symbolic engines. Writes artifacts/{fisher2d,ac2d}_full.json.
"""

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

from kanodes.experiments.pde_source import (SourceConfig,  # noqa: E402
                                            make_data, make_fns,
                                            make_model, recover_source)
from kanodes.train.loop import TrainConfig, train  # noqa: E402

PROBLEM = sys.argv[1] if len(sys.argv) > 1 else "fisher_kpp"
# (lr, iters): phase 0 = the 1-D reference budget
# (Fisher-KPP_Source.jl:170 2e4; Allen-Cahn_Source.jl:164 5e4), then a
# small-lr continuation to settle the minimum before symbolic recovery
RUNS = {
    "fisher_kpp": dict(out="artifacts/fisher2d_full.json",
                       phases=[(1e-2, 20_000), (1e-3, 6_000),
                               (1e-4, 4_000)],
                       truth="1.0*x0 - 1.0*x0**2  (r u (1-u), r=1)"),
    "allen_cahn": dict(out="artifacts/ac2d_full.json",
                       phases=[(1e-2, 50_000), (1e-3, 6_000),
                               (1e-4, 4_000)],
                       truth="5.0*x0 - 5.0*x0**3"),
}


def main():
    spec = RUNS[PROBLEM]
    cfg = SourceConfig(problem=PROBLEM, ndim=2, eval_every=500,
                       impl="fused")
    data = make_data(cfg)
    model = make_model(cfg)
    params = model.init(jax.random.PRNGKey(cfg.seed))
    loss_fn, _, _ = make_fns(cfg, model, data)

    t0 = time.time()
    opt_state = None
    best = (float("inf"), params)
    history = []
    for lr, iters in spec["phases"]:
        if opt_state is not None:
            opt_state = opt_state._replace(hyperparams={
                **opt_state.hyperparams,
                "learning_rate": jnp.asarray(lr, jnp.float32)})
        tc = TrainConfig(lr=lr, iters=iters, eval_every=cfg.eval_every,
                         max_iters_per_call=cfg.resolved_chunk())
        out = train(loss_fn, params, tc, opt_state=opt_state)
        params, opt_state = out["params"], out["opt_state"]
        if float(out["best_loss"]) < best[0]:
            best = (float(out["best_loss"]), out["best_params"])
        history.append({"lr": lr, "iters": iters,
                        "final": float(out["loss_history"][-1]),
                        "best": float(out["best_loss"])})
        print(history[-1], flush=True)
    jax.block_until_ready(params)
    train_s = time.time() - t0

    rec_in = {"model": model, "best_params": best[1], "data": data}
    t1 = time.time()
    rec_sindy = recover_source(rec_in, method="sindy")
    sindy_s = time.time() - t1
    t1 = time.time()
    rec_gp = recover_source(rec_in, generations=250, seed=0)
    gp_s = time.time() - t1

    rec = {
        "grid": "32x32 periodic (1024 cells)",
        "phases": history,
        "best_train": best[0],
        "train_seconds": round(train_s, 1),
        "it_per_s": round(sum(i for _, i in spec["phases"]) / train_s, 1),
        "recovered_gp": rec_gp["pretty"],
        "gp_seconds": round(gp_s, 2),
        "recovered_sindy": rec_sindy["pretty"],
        "sindy_seconds": round(sindy_s, 3),
        "truth": spec["truth"],
        "state_range": [float(v) for v in rec_sindy["range"]],
    }
    print(json.dumps(rec, indent=1))
    os.makedirs("artifacts", exist_ok=True)
    with open(spec["out"], "w") as f:
        json.dump(rec, f, indent=1)
    print("wrote", spec["out"])


if __name__ == "__main__":
    main()
