"""Paper-figure plotting.

Rebuild of the reference's plotting layer: training curves + trajectory
reconstruction (`Plotting_standard.jl:135-192`), per-edge activation
spline plots (`Plotting_symbolic.jl:345-411`), PDE contour panels
(`Burgers_Surrogate.jl:110-153`), and the param-efficiency trend figure
(`trend_plotter.py:7-35`). All functions save PNGs and return the
figure; headless (Agg) by default.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def loss_curves(histories: dict[str, np.ndarray], path: str,
                title: str = "training loss"):
    """Log-scale loss curves (Plotting_standard.jl:177-192)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4), dpi=150)
    for label, h in histories.items():
        ax.semilogy(np.asarray(h), label=label, lw=1)
    ax.set_xlabel("iteration")
    ax.set_ylabel("MSE loss")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    return fig


def lv_reconstruction(ts, truth, pred, train_tmax: float, path: str):
    """Fig 3A-style trajectory reconstruction with the train/test split
    line (Plotting_standard.jl:135-155)."""
    plt = _plt()
    ts, truth, pred = map(np.asarray, (ts, truth, pred))
    fig, ax = plt.subplots(figsize=(7, 4), dpi=150)
    for d, (name, color) in enumerate((("x (prey)", "tab:blue"),
                                       ("y (predator)", "tab:red"))):
        ax.plot(ts, truth[:, d], ".", color=color, ms=3,
                label=f"{name} data")
        ax.plot(ts, pred[:, d], "-", color=color, lw=1.2,
                label=f"{name} KAN-ODE")
    ax.axvline(train_tmax, color="k", ls="--", lw=1, label="train cut")
    ax.set_xlabel("t")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    return fig


def activation_grid(chain, params, x_samples, path: str,
                    alpha_scale: bool = True):
    """Per-edge activation curves phi_{i->o}, alpha scaled by magnitude
    (Plotting_symbolic.jl:345-411)."""
    plt = _plt()
    from kanodes.sparsify.activations import chain_activations

    ca = chain_activations(chain, params, x_samples)
    n_layers = len(ca.acts)
    fig, axes = plt.subplots(1, n_layers, figsize=(5 * n_layers, 4),
                             dpi=150, squeeze=False)
    for l, act in enumerate(ca.acts):
        ax = axes[0][l]
        a = np.asarray(act)
        xin = np.asarray(ca.inputs[l])
        mag = np.abs(a).max(axis=0)
        mmax = mag.max() + 1e-12
        I, O = a.shape[1:]
        for i in range(I):
            order = np.argsort(xin[:, i])
            for o in range(O):
                alpha = float(mag[i, o] / mmax) if alpha_scale else 1.0
                ax.plot(xin[order, i], a[order, i, o], lw=1,
                        alpha=max(alpha, 0.05))
        ax.set_title(f"layer {l + 1} activations")
        ax.set_xlabel("input")
    fig.tight_layout()
    fig.savefig(path)
    return fig


def pde_contour(ts, x, field, path: str, title: str = ""):
    """Space-time contour panel (Burgers_Surrogate.jl:110-153)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 2.6), dpi=150)
    c = ax.contourf(np.asarray(ts), np.asarray(x), np.asarray(field).T,
                    levels=101, cmap="turbo")
    fig.colorbar(c, ax=ax)
    ax.set_xlabel("t")
    ax.set_ylabel("x")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    return fig


def trend_plot(results: list[dict], path: str,
               reference: dict[str, dict] | None = None):
    """Loss-vs-#params trend with N^-4 / N^-2 guide lines
    (trend_plotter.py:7-35). `results` rows: {model, n_params,
    train_loss}."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.5, 4.5), dpi=150)

    def _series(model, depth):
        return [(r["n_params"], r["train_loss"]) for r in results
                if r["model"] == model and r.get("depth", 2) == depth]

    styles = (("kan", 2, "tab:blue", "o", "KAN-ODE d=2"),
              ("kan", 3, "tab:cyan", "^", "KAN-ODE d=3"),
              ("mlp", 2, "tab:red", "s", "MLP-NODE d=2"),
              ("mlp", 3, "tab:purple", "D", "MLP-NODE d=3"))
    for model, depth, color, marker, label in styles:
        pts = _series(model, depth)
        if pts:
            n, l = zip(*sorted(pts))
            ax.loglog(n, l, marker + "-", color=color,
                      label=f"{label} (this work)")
    if reference:
        ref_styles = (("kan", "tab:blue", "KAN-ODE d=2"),
                      ("mlp", "tab:red", "MLP-NODE d=2"),
                      ("mlp_d3", "tab:purple", "MLP-NODE d=3"))
        for key, color, label in ref_styles:
            if key in reference:
                n, l = zip(*sorted(reference[key].items()))
                ax.loglog(n, l, "x--", color=color, alpha=0.5,
                          label=f"{label} (reference)")
    n = np.asarray([60.0, 1000.0])
    ax.loglog(n, 2e2 * n ** -4.0, ":", color="gray", label=r"$N^{-4}$")
    ax.loglog(n, 1e-1 * n ** -2.0, ":", color="black", label=r"$N^{-2}$")
    ax.set_xlabel("# parameters")
    ax.set_ylabel("converged train MSE")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    return fig


def symbolic_error_contours(kan_rhs, sym_exprs: list[str], truth_rhs,
                            ranges, path: str, n: int = 100):
    """Dense/sparse RHS error contours over an (x, y) mesh — the
    Plotting_symbolic.jl:196-305 comparison: |KAN - truth| and
    |symbolic - truth| per output dimension."""
    plt = _plt()
    import jax.numpy as jnp

    (xlo, xhi), (ylo, yhi) = ranges
    xs = np.linspace(xlo, xhi, n)
    ys = np.linspace(ylo, yhi, n)
    XX, YY = np.meshgrid(xs, ys)
    pts = np.stack([XX.ravel(), YY.ravel()], 1).astype(np.float32)

    kan = np.asarray(kan_rhs(jnp.asarray(pts)))            # [N, 2]
    tru = np.asarray(truth_rhs(pts))                       # [N, 2]
    from kanodes.symbolic.fit import eval_symreg_expr
    sym = np.stack([eval_symreg_expr(e, x0=pts[:, 0], x1=pts[:, 1])
                    for e in sym_exprs], axis=1)

    fig, axes = plt.subplots(2, 2, figsize=(10, 8), dpi=150)
    for d in range(2):
        for col, (approx, title) in enumerate(
                ((kan, "|KAN − truth|"), (sym, "|symbolic − truth|"))):
            err = np.abs(approx[:, d] - tru[:, d]).reshape(n, n)
            ax = axes[d][col]
            c = ax.contourf(XX, YY, err, levels=31, cmap="turbo")
            fig.colorbar(c, ax=ax)
            ax.set_title(f"dim {d}: {title}")
    fig.tight_layout()
    fig.savefig(path)
    return fig


def contour_compare(truth_rhs, kan_rhs, mlp_rhs, sym_exprs: list[str],
                    out_dir: str, trajectory=None, sym_comp_rhs=None,
                    n: int = 100,
                    ranges=((0.25, 7.5), (0.1, 5.0))) -> dict:
    """Fig 4(C) parity: the reference's 4-way RHS error-contour panels
    (`Plotting_symbolic.jl:196-305`) — per output dim, the truth field
    plus signed errors (truth − approx) of the KAN, the MLP, the GLOBAL
    symbolic ODE, and (optionally) the per-activation symbolic
    composition ("Symbolic KAN-ODE"), each its own PNG with the
    reference's file names (xdot_actual / xdot_kan / xdot_mlp /
    xdot_symb / xdot_symb_comp and the ydot set), diverging colormap,
    KAN errors clamped to the MLP error range (:239-240), and the
    training trajectory scattered on top.

    Returns {panel_name: max_abs_error} for gating/regression tests.
    """
    import os

    import jax.numpy as jnp

    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    (xlo, xhi), (ylo, yhi) = ranges
    xs = np.linspace(xlo, xhi, n)
    ys = np.linspace(ylo, yhi, n)
    XX, YY = np.meshgrid(xs, ys)
    pts = np.stack([XX.ravel(), YY.ravel()], 1).astype(np.float32)

    tru = np.asarray(truth_rhs(pts)).reshape(n, n, 2)
    fields = {"actual": tru}
    errs = {}
    approx = {"kan": np.asarray(kan_rhs(jnp.asarray(pts)))}
    if mlp_rhs is not None:
        approx["mlp"] = np.asarray(mlp_rhs(jnp.asarray(pts)))
    from kanodes.symbolic.fit import eval_symreg_expr
    approx["symb"] = np.stack(
        [eval_symreg_expr(e, x0=pts[:, 0], x1=pts[:, 1])
         for e in sym_exprs], axis=1)
    if sym_comp_rhs is not None:
        approx["symb_comp"] = np.asarray(sym_comp_rhs(pts))
    for name, a in approx.items():
        errs[name] = tru - a.reshape(n, n, 2)
    if "mlp" in errs:
        # clamp the KAN error to the MLP error range so shared color
        # scales stay readable (Plotting_symbolic.jl:239-240)
        for d in range(2):
            errs["kan"][..., d] = np.clip(errs["kan"][..., d],
                                          errs["mlp"][..., d].min(),
                                          errs["mlp"][..., d].max())

    stats = {}
    for d, prefix in enumerate(("xdot", "ydot")):
        panels = [("actual", fields["actual"][..., d], "amp")]
        panels += [(k, errs[k][..., d], "balance") for k in errs]
        for name, field, style in panels:
            fig, ax = plt.subplots(figsize=(3.2, 2.5), dpi=200)
            if style == "amp":
                c = ax.contourf(XX, YY, field, levels=60, cmap="YlOrRd")
            else:
                lim = float(np.abs(field).max()) + 1e-12
                c = ax.contourf(XX, YY, field, levels=60, cmap="RdBu_r",
                                vmin=-lim, vmax=lim)
            fig.colorbar(c, ax=ax)
            if trajectory is not None:
                tr = np.asarray(trajectory)
                ax.scatter(tr[:, 0], tr[:, 1], s=2, c="goldenrod",
                           edgecolors="none")
            ax.set_xlabel("x")
            ax.set_ylabel("y")
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, f"{prefix}_{name}.png"))
            plt.close(fig)
            stats[f"{prefix}_{name}"] = float(np.abs(field).max())
    return stats


def _eval_edge_expr(expr: str, x: np.ndarray) -> np.ndarray:
    from kanodes.symbolic.fit import eval_symreg_expr
    return eval_symreg_expr(expr, x0=x)


def activation_symbolic_overlays(chain, params, x_samples, edge_eqs,
                                 out_dir: str, beta: float = 1.0) -> list:
    """Fig 4(A-B) parity: per-activation plots of the LEARNED edge
    functions and their recovered SYMBOLIC fits
    (`Plotting_symbolic.jl:345-411`), with the reference's
    magnitude-scaled line transparency (alpha = tanh(beta *
    output_range/input_range)) and file names — layer 1 edges from x/y
    (`X{j}.png`, `Y{j}.png`, `X_symb_{j}.png`, `Y_symb_{j}.png`), layer
    2 edges (`second_{i}_to_X.png`, `second_symb_{i}_to_X.png`, ...Y) —
    plus one combined overlay panel per layer (learned solid / symbolic
    dashed), which the reference lacked.

    edge_eqs: list of EdgeEquation (symbolic.fit.fit_edge_activations).
    Returns the written file names.
    """
    import os

    plt = _plt()
    from kanodes.sparsify.activations import chain_activations

    os.makedirs(out_dir, exist_ok=True)
    ca = chain_activations(chain, params, x_samples)
    eq_by_key = {(e.layer, e.i, e.o): e for e in edge_eqs}
    in_names = {0: ("X", "Y")}
    written = []

    def _single(path, xv, yv, alpha):
        fig, ax = plt.subplots(figsize=(1.6, 1.2), dpi=200)
        ax.plot(xv, yv, color="black", lw=1.2, alpha=max(alpha, 0.06))
        ax.set_xticks([float(xv.min()), float(xv.max())])
        ax.set_yticks([])
        fig.tight_layout(pad=0.2)
        fig.savefig(path)
        plt.close(fig)
        written.append(os.path.basename(path))

    overlay_axes = []
    for l, act in enumerate(ca.acts):
        a = np.asarray(act)                        # [N, I, O]
        xin = np.asarray(ca.inputs[l])             # [N, I]
        N, I, O = a.shape
        fig_o, axes_o = plt.subplots(I, O, figsize=(2.2 * O, 1.8 * I),
                                     dpi=150, squeeze=False)
        overlay_axes.append((fig_o, axes_o))
        for i in range(I):
            order = np.argsort(xin[:, i])
            xv = xin[order, i]
            in_rng = float(xv[-1] - xv[0]) + 1e-12
            for o in range(O):
                yv = a[order, i, o]
                alpha = float(np.tanh(
                    beta * (yv.max() - yv.min()) / in_rng))
                if l == 0 and I == 2:
                    base = f"{in_names[0][i]}{o + 1}"
                    sbase = f"{in_names[0][i]}_symb_{o + 1}"
                elif l == 1:
                    tgt = ("X", "Y")[o] if O == 2 else str(o + 1)
                    base = f"second_{i + 1}_to_{tgt}"
                    sbase = f"second_symb_{i + 1}_to_{tgt}"
                else:
                    # layer-indexed fallback (e.g. a 3-species layer 0):
                    # the reference's X*/second_* names only cover its
                    # 2-layer [2,h,2] chain, and reusing "second_*"
                    # here would collide with layer 1's files
                    tgt = ("X", "Y")[o] if O == 2 else str(o + 1)
                    base = f"layer{l + 1}_{i + 1}_to_{tgt}"
                    sbase = f"layer{l + 1}_symb_{i + 1}_to_{tgt}"
                _single(os.path.join(out_dir, base + ".png"),
                        xv, yv, alpha)
                ax = axes_o[i][o]
                ax.plot(xv, yv, "k-", lw=1.2,
                        alpha=max(alpha, 0.06), label="learned")
                eq = eq_by_key.get((l, i, o))
                if eq is not None:
                    sv = _eval_edge_expr(eq.fit.expression, xv)
                    s_alpha = float(np.tanh(
                        beta * (sv.max() - sv.min()) / in_rng))
                    _single(os.path.join(out_dir, sbase + ".png"),
                            xv, sv, s_alpha)
                    ax.plot(xv, sv, "r--", lw=1.0,
                            alpha=max(s_alpha, 0.06), label="symbolic")
                ax.set_xticks([])
                ax.set_yticks([])
        fig_o.suptitle(f"layer {l + 1}: learned (black) vs symbolic "
                       "(red dashed)", fontsize=9)
        fig_o.tight_layout()
        p = os.path.join(out_dir, f"overlay_layer{l + 1}.png")
        fig_o.savefig(p)
        plt.close(fig_o)
        written.append(os.path.basename(p))
    return written


def pinn_field_plot(model, params, geo, path: str, n: int = 151):
    """phi and tau_eq contours over the notched plate (the PINN's
    diagnostics panels, StrainLimiting_KAN_PINN.py:1092-1178)."""
    plt = _plt()
    import jax
    import jax.numpy as jnp
    from kanodes.pinn.losses import stress

    xs = np.linspace(geo.xmin, geo.xmax, n)
    ys = np.linspace(geo.ymin, geo.ymax, n)
    XX, YY = np.meshgrid(xs, ys)
    pts = jnp.asarray(np.stack([XX.ravel(), YY.ravel()], 1), jnp.float32)

    def phi(p):
        return model.phi(params, p)

    vals = np.asarray(jax.vmap(phi)(pts)).reshape(n, n)
    _, _, tau = stress(phi, pts)
    tau = np.asarray(tau).reshape(n, n)
    void = geo.in_void(XX, YY)
    vals = np.where(void, np.nan, vals)
    tau = np.where(void, np.nan, tau)

    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5), dpi=150)
    for ax, field, title in ((axes[0], vals, r"$\phi$"),
                             (axes[1], tau, r"$\tau_{eq}$")):
        c = ax.contourf(XX, YY, field, levels=51, cmap="turbo")
        fig.colorbar(c, ax=ax)
        ax.set_title(title)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path)
    return fig
