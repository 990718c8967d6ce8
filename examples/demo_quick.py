"""Quick three-model LV comparison demo.

Rebuild of `Lotka-Volterra-Pytorch/demo_quick.py` (baseline-vs-optimized
comparison with plots): trains the grid-basis KDense KAN, the B-spline
efficient-kan flavor, and the hybrid KAN+MLP on the Lotka-Volterra task
with a small budget, then writes loss curves + trajectory
reconstructions to ./demo_out/.

Run:  python examples/demo_quick.py  [--iters=1000]
"""

from __future__ import annotations

import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from kanodes.experiments.lv import LVConfig, make_data, run  # noqa: E402
from kanodes.diag.plots import loss_curves, lv_reconstruction  # noqa: E402
from kanodes.train.config import override_from_args  # noqa: E402


def main() -> None:
    base = LVConfig(iters=1000, eval_every=250)
    base = override_from_args(base, sys.argv[1:])
    os.makedirs("demo_out", exist_ok=True)

    configs = {
        "kdense_kan": dict(model="kan", lr=5e-4),
        "kdense_kan_shooting": dict(model="kan", lr=3e-3,
                                    solve_mode="shooting"),
        "bspline_kan": dict(model="bspline_kan", lr=2e-3, init_scale=1.0),
        "mlp": dict(model="mlp", lr=1e-2, init_scale=1.0),
    }

    histories, outs = {}, {}
    for name, kw in configs.items():
        import dataclasses
        cfg = dataclasses.replace(base, **kw)
        t0 = time.time()
        out = run(cfg)
        jax.block_until_ready(out["loss_history"])
        dt = time.time() - t0
        histories[name] = np.asarray(out["loss_history"])
        outs[name] = out
        print(f"{name:>22}: final {histories[name][-1]:.3e} "
              f"best {float(out['best_loss']):.3e} "
              f"test {float(out['eval_history'][-1]):.3e}  ({dt:.1f}s)")

    loss_curves(histories, "demo_out/loss_comparison.png",
                title=f"LV neural-ODE training ({base.iters} iters)")
    data = make_data(base)
    for name, out in outs.items():
        pred = out["predict"](out["best_params"], data["ts"])
        lv_reconstruction(np.asarray(data["ts"]), np.asarray(data["X"]),
                          np.asarray(pred), base.train_tmax,
                          f"demo_out/reconstruction_{name}.png")
    print("plots written to demo_out/")


if __name__ == "__main__":
    main()
