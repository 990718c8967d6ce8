"""End-to-end optimized-harness comparison (VERDICT r2 #3, C23/C24).

Mirrors the reference's 10-step `optimized_training.py:719-982` main on
this stack: LV data with a 70/15/15 time-ordered split, then three
models trained with the horizon curriculum (1.0 -> 2.0 -> 3.5 s,
Config:92-96):

  baseline   B-spline KAN [2,10,2] grid 5, plain MSE, lr 2e-3;
  optimized  B-spline KAN [2,8,2] grid 5 + L2 1e-4 + spline-smoothness
             1e-3 regularization + min-max data normalization with
             chain-rule RHS rescale (optimized_kan.py:396-464), lr 1e-3;
  hybrid     alpha-gated KAN+MLP blend (optimized_kan.py:346-389).

Then: full metric suite + seeded test-horizon rollout + noise/IC
robustness sweeps for every model (`train/harness.compare_models`),
magnitude-threshold edge pruning of the optimized model at 0.01 with
post-prune re-evaluation (optimized_kan.py:256-273), and a JSON report.

Artifacts: artifacts/harness_compare.json, artifacts/figures/harness_*.png.
Run on the GPU (one process per card).
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

from kanodes.experiments import lv as lv_mod
from kanodes.models.bspline import BSplineKANChain
from kanodes.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes.ode import odeint_fixed
from kanodes.sparsify.edge_prune import prune_chain_edges
from kanodes.sparsify.regularization import (l2_reg,
                                             spline_smoothness_reg)
from kanodes.train.harness import (HarnessConfig, compare_models,
                                   curriculum_train, evaluate_model,
                                   time_ordered_split)
from kanodes.train.loop import TrainConfig, train

t0 = time.time()
hc = HarnessConfig(curriculum_iters=(500, 1000, 3500))  # 5000 epochs total

# ---- step 1: data + split --------------------------------------------------
data = lv_mod.make_data(lv_mod.LVConfig())
ts, X = np.asarray(data["ts"]), np.asarray(data["X"])
(ts_tr, X_tr), (ts_va, X_va), (ts_te, X_te) = time_ordered_split(ts, X, hc)
print(f"[1] data: {len(ts)} points, split {len(ts_tr)}/{len(ts_va)}/"
      f"{len(ts_te)}")

# ---- step 2: baseline ------------------------------------------------------
baseline = BSplineKANChain([2, 10, 2], grid_size=5)
pb = baseline.init(jax.random.PRNGKey(0))
outb = curriculum_train(baseline, pb, ts_tr, X_tr,
                        dataclasses.replace(hc, lr=2e-3))
pb = outb["params"]
print(f"[2] baseline KAN [2,10,2]: {baseline.num_params()} params, "
      f"stages {outb['stages']}  ({time.time() - t0:.0f}s)")

# ---- step 3: optimized (regs + normalizer) ---------------------------------
optimized = BSplineKANChain([2, 8, 2], grid_size=5)
po = optimized.init(jax.random.PRNGKey(1))
norm = DataNormalizer.fit(X_tr)
scale = jnp.asarray(norm.scale)
L2_W, SMOOTH_W = 1e-4, 1e-3                  # Config:81-83


class NormalizedPhysicalModel:
    """Physical-space view of a model trained on normalized states:
    du/dt = scale * f(z(u)) (optimized_training.py:382-394)."""

    def __init__(self, inner, norm):
        self.inner, self.norm = inner, norm
        self.in_dims, self.out_dims = inner.in_dims, inner.out_dims

    def apply(self, p, u):
        return jnp.asarray(self.norm.scale) * self.inner.apply(
            p, self.norm.normalize(u))

    def num_params(self):
        return self.inner.num_params()


stages_o = []
for horizon, iters in zip(hc.curriculum_horizons,
                          dataclasses.replace(hc, lr=1e-3).curriculum_iters):
    n = max(int(np.sum(ts_tr <= horizon + 1e-9)), 2)
    ts_h = jnp.asarray(ts_tr[:n])
    Z_h = jnp.asarray(np.asarray(norm.normalize(jnp.asarray(X_tr[:n]))))

    def rhs_z(t, z, p):
        return optimized.apply(p, z)

    def _weights_only(p):
        # the B-spline knot "grid" is coordinate state (stop-gradient in
        # apply); regularizing it would push nonzero grads into the knots
        return [{k: v for k, v in layer.items() if k != "grid"}
                for layer in p]

    def loss_fn(p, ts_h=ts_h, Z_h=Z_h):
        zs = odeint_fixed(rhs_z, Z_h[0], ts_h, p, solver="tsit5",
                          substeps=hc.substeps)
        mse = jnp.mean((zs - Z_h) ** 2)
        return (mse + L2_W * l2_reg(_weights_only(p))
                + SMOOTH_W * spline_smoothness_reg(p))

    out = train(loss_fn, po, TrainConfig(lr=1e-3, iters=iters,
                                         eval_every=iters))
    po = out["params"]
    stages_o.append({"horizon": horizon,
                     "final_loss": float(out["loss_history"][-1])})
opt_phys = NormalizedPhysicalModel(optimized, norm)
print(f"[3] optimized KAN [2,8,2]+regs+normalizer: "
      f"{optimized.num_params()} params, stages {stages_o}  "
      f"({time.time() - t0:.0f}s)")

# ---- step 4: hybrid --------------------------------------------------------
hybrid = HybridKANMLP([2, 8, 2], grid_size=5, mlp_hidden=8)
ph = hybrid.init(jax.random.PRNGKey(2))
outh = curriculum_train(hybrid, ph, ts_tr, X_tr,
                        dataclasses.replace(hc, lr=1e-3))
ph = outh["params"]
blend = hybrid.blend(ph)
print(f"[4] hybrid KAN+MLP: {hybrid.num_params()} params, "
      f"blend alpha {blend:.3f}, stages {outh['stages']}  "
      f"({time.time() - t0:.0f}s)")

# ---- steps 5+7: evaluation + robustness for all models ---------------------
report = compare_models({
    "baseline": (baseline, pb),
    "optimized": (opt_phys, po),
    "hybrid": (hybrid, ph),
}, ts, X, hc)
print(f"[5/7] metric+robustness suite done  ({time.time() - t0:.0f}s)")

# ---- step 6: edge pruning of the optimized model ---------------------------
po_pruned, masks, n_pruned = prune_chain_edges(po, threshold=0.01)
pruned_eval = evaluate_model(opt_phys, po_pruned, ts, X, hc)
report["optimized_pruned"] = {
    "full": pruned_eval,
    "edges_pruned": n_pruned,
    "edges_total": int(sum(np.prod(m.shape) for m in masks)),
}
print(f"[6] pruning: {n_pruned} edges zeroed, full-horizon MSE "
      f"{pruned_eval['mse']:.3e}")

# ---- steps 8-10: plots, report, summary ------------------------------------
os.makedirs("artifacts/figures", exist_ok=True)
from kanodes.diag.plots import lv_reconstruction


def rollout(model, params):
    def rhs(t, u, p):
        return model.apply(p, u)
    return odeint_fixed(rhs, jnp.asarray(X[0]), jnp.asarray(ts), params,
                        solver="tsit5", substeps=hc.substeps)


for name, (model, params) in (("baseline", (baseline, pb)),
                              ("optimized", (opt_phys, po)),
                              ("hybrid", (hybrid, ph))):
    lv_reconstruction(ts, X, np.asarray(rollout(model, params)),
                      train_tmax=float(ts_tr[-1]),
                      path=f"artifacts/figures/harness_{name}.png")

summary = {
    "config": {"curriculum_horizons": hc.curriculum_horizons,
               "curriculum_iters": (500, 1000, 3500),
               "l2": L2_W, "smoothness": SMOOTH_W,
               "split": [len(ts_tr), len(ts_va), len(ts_te)]},
    "models": {
        "baseline": {"n_params": baseline.num_params(),
                     "stages": outb["stages"]},
        "optimized": {"n_params": optimized.num_params(),
                      "stages": stages_o, "normalized": True},
        "hybrid": {"n_params": hybrid.num_params(),
                   "stages": outh["stages"], "blend_alpha": blend},
    },
    "report": report,
    "seconds": round(time.time() - t0, 1),
}
with open("artifacts/harness_compare.json", "w") as f:
    json.dump(summary, f, indent=1, default=float)

print("\n=== summary (full-horizon rollout MSE / test-horizon MSE / "
      "robust @noise 0.05) ===")
for name in ("baseline", "optimized", "hybrid"):
    r = report[name]
    print(f"  {name:>10}: {r['full']['mse']:.3e} / "
          f"{r['test_horizon']['mse']:.3e} / "
          f"{r['robustness']['noise'][0.05]['mse']:.3e}")
print(f"  optimized_pruned: {report['optimized_pruned']['full']['mse']:.3e} "
      f"({n_pruned} edges pruned)")
print(f"done in {time.time() - t0:.0f}s -> artifacts/harness_compare.json")
