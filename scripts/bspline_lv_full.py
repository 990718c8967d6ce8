"""C22 at the FULL reference budget: the PyTorch-flavor LV drivers.

`Lotka-Volterra-Pytorch/predator_prey.py:24-25,101,142` trains a
[2,10,2] grid-5 efficient-kan B-spline KAN-ODE for 1e4 epochs with
Adam(2e-3) through torchdiffeq `odeint` (discretize-then-optimize);
`predator_prey_adjoint.py:5,132-142` repeats it through
`odeint_adjoint` (continuous backsolve adjoint) and the repo README
notes the adjoint is "slightly slower" at these sizes
(`Lotka-Volterra-Pytorch/README.md:5`).

This runs both flavors (plus the checkpointed-interpolating adjoint,
this framework's stable alternative) at the exact budget and commits
the artifact.
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

from kanodes.experiments import lv  # noqa: E402

OUT = "artifacts/bspline_lv_full.json"


def one(tag: str, cfg: lv.LVConfig) -> dict:
    t0 = time.time()
    out = lv.run(cfg)
    jax.block_until_ready(out["loss_history"])
    dt = time.time() - t0
    rec = {
        "tag": tag,
        "iters": cfg.iters,
        "lr": cfg.lr,
        "solve_mode": cfg.solve_mode,
        "adjoint": cfg.adjoint,
        "final_train": float(out["loss_history"][-1]),
        "best_train": float(out["best_loss"]),
        "full_horizon_mse": float(out["eval_history"][-1]),
        "seconds": round(dt, 1),
        "it_per_s": round(cfg.iters / dt, 1),
    }
    print(rec, flush=True)
    return rec


def main():
    base = dict(model="bspline_kan", iters=10_000, lr=2e-3,
                eval_every=500)
    runs = [
        # discretize-then-optimize: fixed-grid Tsit5, direct backprop
        # (predator_prey.py's odeint path at matched save grid)
        one("direct", lv.LVConfig(**base, solve_mode="fixed", substeps=2)),
        # continuous backsolve adjoint (predator_prey_adjoint.py)
        one("backsolve_adjoint", lv.LVConfig(
            **base, solve_mode="adaptive", adjoint="backsolve",
            rtol=1e-6, atol=1e-8, max_steps=96,
            max_iters_per_call=2_000)),
        # this framework's stable adjoint alternative
        one("interpolating_adjoint", lv.LVConfig(
            **base, solve_mode="adaptive", adjoint="interpolating",
            rtol=1e-6, atol=1e-8, max_steps=96,
            max_iters_per_call=2_000)),
    ]
    with open(OUT, "w") as f:
        json.dump(runs, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
