"""Fig-4 plotting parity (VERDICT r2 #4): per-activation symbolic
overlays + the 4-way RHS error-contour comparison.

Reproduces the reference's headline interpretability figure pipeline
(`Plotting_symbolic.jl:196-305` contour_compare/ panels incl. the MLP
RHS, and :345-411 activation_plots/ incl. the *_symb_* files):

  1. sparse-train -> prune -> retrain the LV KAN-ODE and fit per-edge +
     global symbolic expressions (`experiments/lv_symbolic.run_pipeline`);
  2. train the reference MLP-NODE comparator ([2,50,2] tanh,
     `LV_driver_MLP.jl:61`);
  3. emit, per output dim: truth field + signed error contours for
     KAN / MLP / global-symbolic / per-edge-symbolic-composition over
     the 100x100 (x,y) mesh with the training trajectory scattered on
     top (reference file names);
  4. emit per-activation plots: learned curves, symbolic-fit curves
     (X{j}/Y{j}/second_* + *_symb_* names) and combined overlay panels.

Artifacts: artifacts/figures/contour_compare/*.png,
artifacts/figures/activation_plots/*.png, artifacts/fig4_summary.json.
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

from kanodes.diag.plots import (activation_symbolic_overlays,
                                contour_compare)
from kanodes.experiments import lv as lv_mod
from kanodes.experiments.lv_symbolic import (SymbolicPipelineConfig,
                                                run_pipeline)
from kanodes.symbolic.fit import compose_edge_equations

OUT = "artifacts"
t0 = time.time()

# ---- 1. pruned KAN + symbolic fits ----------------------------------------
# polynomial edge ops: the per-edge expressions get COMPOSED over the
# full 100x100 mesh; rational fits extrapolate with poles there
print("[fig4] symbolic pipeline (sparse train -> prune -> retrain -> SR)")
pipe = run_pipeline(SymbolicPipelineConfig(edge_ops=("+", "-", "*")),
                    verbose=True)
model_p, params_p = pipe["model"], pipe["params"]
width = model_p.layers[0].out_dims
print(f"[fig4] pruned width {width}, train {pipe['pruned_train_loss']:.3e}, "
      f"recovered: {pipe['global_equations']}  ({time.time() - t0:.0f}s)")

# ---- 2. MLP comparator -----------------------------------------------------
# the reference regime (LV_driver_MLP.jl:92-97: adaptive Tsit5, Adam
# 1e-2, trajectory MSE), shortened to 30k iters; params cached so
# re-runs of the plotting phases are cheap
MLP_NPY = os.path.join(OUT, "fig4_mlp_params.npy")
mlp_base = lv_mod.LVConfig(model="mlp", mlp_widths=(2, 50, 2), impl="xla",
                           init_scale=1.0, solve_mode="adaptive",
                           rtol=1e-3, atol=1e-6, max_steps=64,
                           lr=1e-2, iters=30_000, eval_every=1000,
                           max_iters_per_call=5_000)
mlp_model = lv_mod.make_model(mlp_base)
if os.path.exists(MLP_NPY):
    params_m = jax.tree_util.tree_map(
        jnp.asarray, np.load(MLP_NPY, allow_pickle=True).item())
    mlp_train = float("nan")
    print("[fig4] MLP params loaded from cache")
else:
    print("[fig4] training MLP-NODE comparator [2,50,2], reference regime")
    out_m = lv_mod.run(mlp_base)
    params_m = out_m["best_params"]
    mlp_train = float(np.min(np.asarray(out_m["loss_history"])))
    arr = np.empty((), dtype=object)
    arr[()] = jax.tree_util.tree_map(np.asarray, params_m)
    os.makedirs(OUT, exist_ok=True)
    np.save(MLP_NPY, arr, allow_pickle=True)
print(f"[fig4] MLP best train loss {mlp_train:.3e}  ({time.time() - t0:.0f}s)")

# ---- 3. contour compare ----------------------------------------------------
data = pipe["data"]
X_train = np.asarray(data["X"][:data["n_train"]])


def truth_rhs(pts):
    return np.asarray(lv_mod.lv_rhs_truth(0.0, jnp.asarray(pts)))


def kan_rhs(pts):
    return model_p.apply(params_p, pts)


def mlp_rhs(pts):
    return mlp_model.apply(params_m, pts)


sym_comp = compose_edge_equations(pipe["edge_equations"], (2, width, 2))
stats = contour_compare(
    truth_rhs, kan_rhs, mlp_rhs,
    [f.expression for f in pipe["global_fits"]],
    os.path.join(OUT, "figures", "contour_compare"),
    trajectory=np.asarray(data["X"]), sym_comp_rhs=sym_comp)
print(f"[fig4] contour panels: { {k: round(v, 4) for k, v in stats.items()} }")

# ---- 4. activation overlays ------------------------------------------------
rng = np.random.default_rng(0)
span = X_train.max(axis=0) - X_train.min(axis=0)
samples = np.repeat(X_train, 8, axis=0)
samples = (samples + rng.normal(0, 0.03, samples.shape) * span
           ).astype(np.float32)
files = activation_symbolic_overlays(
    model_p, params_p, jnp.asarray(samples), pipe["edge_equations"],
    os.path.join(OUT, "figures", "activation_plots"))
print(f"[fig4] wrote {len(files)} activation plots")

# ---- summary ---------------------------------------------------------------
summary = {
    "pruned_width": int(width),
    "pruned_train_loss": pipe["pruned_train_loss"],
    "pruned_test_loss": pipe["pruned_test_loss"],
    "global_equations": pipe["global_equations"],
    "edge_equations": [
        {"layer": e.layer, "i": e.i, "o": e.o, "pretty": e.pretty,
         "mse": float(e.fit.mse)} for e in pipe["edge_equations"]],
    "symbolic_resim_mse": pipe["symbolic_resim_mse"],
    "mlp_train_loss": mlp_train,
    "contour_max_abs_err": stats,
    "activation_files": files,
    "seconds": time.time() - t0,
}
with open(os.path.join(OUT, "fig4_summary.json"), "w") as f:
    json.dump(summary, f, indent=2)
print(f"[fig4] done in {time.time() - t0:.0f}s -> artifacts/fig4_summary.json")
