"""Basis-function comparison on the flagship LV task (beyond parity:
the reference's KAN is rbf-only with rswaf/iqf variants defined but
unused, `utils.jl:8-62`; this framework adds global Chebyshev and
Fourier bases — here they get measured evidence at matched budget).

Protocol: identical [2,10,2] grid-5 architecture / params / data /
budget for each basis — shooting warmup (L=1, lr 3e-3, 10k) then L=4
refinement (lr 1e-3, 6k) on the XLA path (the fused kernels are
rbf-specialized; XLA is basis-agnostic), reporting the
reference-protocol trajectory train MSE and the full-horizon test MSE.
Writes artifacts/basis_compare.json.
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

OUT = "artifacts/basis_compare.json"
BASES = ("rbf", "rswaf", "iqf", "cheby", "fourier")
PHASES = [("shooting", 1, 3e-3, 10_000), ("shooting", 4, 1e-3, 6_000)]


def main():
    results = []
    for basis in BASES:
        base = lv.LVConfig(basis=basis, impl="xla")
        data = lv.make_data(base)
        model = lv.make_model(base)
        params = lv.init_params(base, model)
        # metric fns: the reference protocol (trajectory train MSE +
        # full-horizon test MSE), shared across phases
        tl, te, _ = lv.make_ode_fns(
            dataclasses.replace(base, solve_mode="fixed"), model, data)
        traj_train = jax.jit(tl)
        traj_test = jax.jit(te)

        t0 = time.time()
        opt_state = None
        prev_key = None
        fns = {}
        for mode, L, lr, iters in PHASES:
            key = (mode, L)
            if key not in fns:
                cfg_p = dataclasses.replace(base, solve_mode=mode,
                                            segment_len=L)
                fns[key] = lv.make_ode_fns(cfg_p, model, data)
            loss_fn, eval_fn, _ = fns[key]
            if opt_state is not None and key == prev_key:
                opt_state = opt_state._replace(hyperparams={
                    **opt_state.hyperparams,
                    "learning_rate": jnp.asarray(lr, jnp.float32)})
            else:
                opt_state = None
            out = train(loss_fn, params,
                        TrainConfig(lr=lr, iters=iters, eval_every=iters),
                        opt_state=opt_state)
            params, opt_state = out["params"], out["opt_state"]
            prev_key = key
        jax.block_until_ready(params)
        dt = time.time() - t0
        rec = {
            "basis": basis,
            "train_traj_mse": float(traj_train(params)),
            "test_full_horizon_mse": float(traj_test(params)),
            "seconds": round(dt, 1),
        }
        print(rec, flush=True)
        results.append(rec)
    os.makedirs("artifacts", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
