"""LV interpretability pipeline: sparsify -> prune -> symbolic recovery.

Rebuild of the reference's post-hoc chain (SURVEY.md §3.5):
  1. train the LV KAN-ODE with L1/entropy sparsity
     (`LV_driver_KANODE.jl:199-201`);
  2. prune weak hidden nodes (threshold 1e-1 at the call site :169) and
     retrain the smaller network (:168-170);
  3. symbolic regression:
     a. per-edge activation fits (`Symbolic_reg.jl:138-156`);
     b. GLOBAL 2-variable fits of the full learned RHS — the closed-form
        ODE the paper reports (ẋ=1.495x−0.986xy, ẏ=0.970xy−2.929y,
        `Plotting_symbolic.jl:221-222`);
  4. re-simulate the recovered symbolic ODE and compare against data
     (`Plotting_symbolic.jl:196-236`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.experiments import lv as lv_mod
from kanodes.sparsify.prune import prune


@dataclasses.dataclass(frozen=True)
class SymbolicPipelineConfig:
    sparse_iters: int = 15_000
    retrain_iters: int = 10_000
    prune_threshold: float = 1e-1          # LV_driver_KANODE.jl:169
    act_reg: float = 5e-4                  # :199-201
    sr_generations: int = 300
    sr_restarts: int = 3
    # operator set for the PER-EDGE fits. The default mirrors
    # Symbolic_reg.jl:147; pass ("+", "-", "*") for pole-free
    # polynomial edge fits when the expressions will be COMPOSED over a
    # wide mesh (rational fits extrapolate with poles — same rationale
    # as pde_source.recover_source's polynomial default)
    edge_ops: tuple = ("+", "-", "*", "/")
    seed: int = 0


def run_pipeline(cfg: SymbolicPipelineConfig | None = None,
                 verbose: bool = False) -> dict[str, Any]:
    cfg = cfg or SymbolicPipelineConfig()

    # -- 1. sparse training (fast shooting curriculum + L1 reg) ----------
    base = lv_mod.LVConfig(impl="fused", sparse_on=True,
                           act_reg=cfg.act_reg, seed=cfg.seed)
    phases = [
        dataclasses.replace(base, solve_mode="shooting", segment_len=1,
                            lr=3e-3, iters=cfg.sparse_iters // 3 * 2),
        dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                            lr=1e-3, iters=cfg.sparse_iters // 3),
    ]
    data = lv_mod.make_data(base)
    model = lv_mod.make_model(base)
    params = lv_mod.init_params(base, model)
    for ph in phases:
        out = lv_mod.run(dataclasses.replace(ph, eval_every=ph.iters),
                         params=params)
        params = out["params"]

    # -- 2. prune + retrain dense ----------------------------------------
    X_train = data["X"][:data["n_train"]]
    res = prune(model, params, X_train, threshold=cfg.prune_threshold)
    if verbose:
        print(f"pruned hidden width 10 -> {res.kept.size} "
              f"(scores {np.sort(res.scores)[::-1][:5]})")
    model_p = res.chain
    params_p = res.params
    width = model_p.layers[0].out_dims
    retrain_base = dataclasses.replace(base, layer_width=width,
                                       sparse_on=False)
    for ph in (dataclasses.replace(retrain_base, solve_mode="shooting",
                                   segment_len=4, lr=1e-3,
                                   iters=cfg.retrain_iters // 2),
               dataclasses.replace(retrain_base, solve_mode="fixed",
                                   lr=3e-4, iters=cfg.retrain_iters // 2)):
        out = lv_mod.run(dataclasses.replace(ph, eval_every=ph.iters),
                         params=params_p)
        params_p = out["params"]

    loss_fn, eval_fn, _ = lv_mod.make_ode_fns(
        dataclasses.replace(retrain_base, solve_mode="fixed"),
        model_p, data)
    pruned_train = float(loss_fn(params_p))
    pruned_test = float(eval_fn(params_p))

    # -- 3a. per-edge symbolic fits ---------------------------------------
    from kanodes.symbolic.fit import fit_edge_activations, \
        simplify_expression

    edge_eqs = fit_edge_activations(
        model_p, params_p, X_train, ops=cfg.edge_ops,
        generations=cfg.sr_generations // 2, seed=cfg.seed)

    # -- 3b. global 2-var fits of the learned RHS ------------------------
    # sample ON the training trajectory (+ small jitter): the KAN is only
    # constrained where data visited; uniform box samples would pollute
    # the fit with unconstrained extrapolation regions
    from kanodes.symbolic.fit import compact_fit

    rng = np.random.default_rng(cfg.seed)
    Xs = np.asarray(X_train)
    span = Xs.max(axis=0) - Xs.min(axis=0)
    reps = 12
    base = np.tile(Xs, (reps, 1))
    jitter = rng.normal(0, 0.03, base.shape) * span
    samples = (base + jitter).astype(np.float32)
    rhs_vals = np.asarray(model_p.apply(params_p, jnp.asarray(samples)))
    global_eqs, global_pretty = [], []
    for d in range(2):
        fit = compact_fit(samples, rhs_vals[:, d], ops=("+", "-", "*"),
                          generations=cfg.sr_generations,
                          restarts=cfg.sr_restarts, seed=cfg.seed + d)
        global_eqs.append(fit)
        global_pretty.append(simplify_expression(fit.expression))

    # -- 3c. SINDy fast pass on the same samples --------------------------
    # closed-form STLSQ counterpart of the GP fits above (milliseconds;
    # exact least-squares coefficients for the polynomial-law class)
    from kanodes.symbolic.sindy import fit_sindy

    sindy_fits = fit_sindy(samples, rhs_vals, degree=3, threshold="auto")

    # -- 4. re-simulate the symbolic ODE ----------------------------------
    from kanodes.symbolic.fit import resimulate_symbolic_rhs

    ts = data["ts"]
    sym_traj = resimulate_symbolic_rhs([f.expression for f in global_eqs],
                                       np.asarray(data["X"][0]), ts, 2)
    sym_mse = float(jnp.mean((sym_traj - data["X"]) ** 2))
    sindy_traj = resimulate_symbolic_rhs(
        [f.expression for f in sindy_fits], np.asarray(data["X"][0]), ts, 2)
    sindy_mse = float(jnp.mean((sindy_traj - data["X"]) ** 2))

    return {
        "model": model_p, "params": params_p,
        "kept_nodes": res.kept, "node_scores": res.scores,
        "pruned_train_loss": pruned_train, "pruned_test_loss": pruned_test,
        "edge_equations": edge_eqs,
        "global_equations": global_pretty,
        "global_fits": global_eqs,
        "symbolic_resim_mse": sym_mse,
        "sindy_equations": [f.expression for f in sindy_fits],
        "sindy_fits": sindy_fits,
        "sindy_resim_mse": sindy_mse,
        "data": data,
    }


if __name__ == "__main__":
    import time

    t0 = time.time()
    out = run_pipeline(verbose=True)
    print(f"pruned width: {out['kept_nodes'].size}, "
          f"train {out['pruned_train_loss']:.3e} "
          f"test {out['pruned_test_loss']:.3e}")
    print("recovered ODE (GP):")
    print("  dx/dt =", out["global_equations"][0])
    print("  dy/dt =", out["global_equations"][1])
    print("recovered ODE (SINDy):")
    print("  dx/dt =", out["sindy_equations"][0])
    print("  dy/dt =", out["sindy_equations"][1])
    print(f"re-simulation MSE vs data: GP {out['symbolic_resim_mse']:.3e} "
          f"SINDy {out['sindy_resim_mse']:.3e}  ({time.time() - t0:.0f}s)")
