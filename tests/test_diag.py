"""Diagnostics: metrics, stability heuristics, gates, plots, checkpoints."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.diag.metrics import (trajectory_metrics, horizon_error,
                                  stability_check, finite_grid_check,
                                  MetricsLogger)
from kanodes.diag.gates import GateThresholds, evaluate, report


def test_trajectory_metrics():
    pred = np.asarray([[1.0, 2.0], [3.0, 4.0]])
    truth = np.asarray([[1.0, 2.0], [3.0, 5.0]])
    m = trajectory_metrics(pred, truth)
    assert m["mse"] == pytest.approx(0.25)
    assert m["max_error"] == pytest.approx(1.0)
    assert m["rmse"] == pytest.approx(0.5)


def test_stability_check():
    good = np.sin(np.linspace(0, 10, 100))[:, None] + 1.0
    rep = stability_check(good)
    assert rep.stable and not rep.exploded
    bad = np.exp(np.linspace(0, 10, 100))[:, None]
    assert stability_check(bad).exploded
    nanny = good.copy()
    nanny[5, 0] = np.nan
    assert stability_check(nanny).nan_count == 1


def test_finite_grid_check():
    assert finite_grid_check(lambda x: x * 2, np.ones((5, 2))) == 0
    with np.errstate(divide="ignore"):   # deliberate non-finite field
        assert finite_grid_check(lambda x: x / 0.0, np.ones((3,))) == 3


def test_metrics_logger(tmp_path):
    ml = MetricsLogger()
    ml.log(0, loss=1.0, lr=0.1)
    ml.log(10, loss=0.5)
    p = tmp_path / "m.csv"
    ml.to_csv(str(p))
    content = p.read_text()
    assert "loss" in content and "0.5" in content
    ml.to_json(str(tmp_path / "m.json"))


def test_gates_report_fail_case():
    diag = {"tip_near_far_ratio": 1.0, "best_val": 100.0,
            "symmetry_mean_abs": 0.5, "pde_residual_mean_abs": 1e3,
            "nonfinite_grid_points": 2}
    res = evaluate(diag)
    assert not res["passed"]
    assert all(not c["ok"] for c in res["checks"].values())
    assert "FAIL" in report(res)


def test_gates_pass_case():
    diag = {"tip_near_far_ratio": 1.5, "best_val": 1.0,
            "symmetry_mean_abs": 0.01, "pde_residual_mean_abs": 1.0,
            "nonfinite_grid_points": 0}
    assert evaluate(diag)["passed"]


class TestPlots:
    def test_loss_curves_and_trend(self, tmp_path):
        from kanodes.diag.plots import loss_curves, trend_plot
        loss_curves({"kan": np.geomspace(1, 1e-5, 100)},
                    str(tmp_path / "l.png"))
        assert (tmp_path / "l.png").exists()
        trend_plot([{"model": "kan", "n_params": 240,
                     "train_loss": 2e-7}], str(tmp_path / "t.png"),
                   reference={"kan": {240: 8.3e-7}})
        assert (tmp_path / "t.png").exists()

    def test_lv_reconstruction_and_activations(self, tmp_path):
        from kanodes.diag.plots import lv_reconstruction, activation_grid
        from kanodes.models import KANChain
        ts = np.linspace(0, 14, 50)
        truth = np.stack([np.sin(ts) + 2, np.cos(ts) + 2], 1)
        lv_reconstruction(ts, truth, truth * 1.01, 3.5,
                          str(tmp_path / "r.png"))
        chain = KANChain.mlp_like([2, 5, 2], grid_len=5)
        p = chain.init(jax.random.PRNGKey(0))
        activation_grid(chain, p, jnp.asarray(truth, jnp.float32),
                        str(tmp_path / "a.png"))
        assert (tmp_path / "a.png").exists()

    def test_pde_contour(self, tmp_path):
        from kanodes.diag.plots import pde_contour
        pde_contour(np.linspace(0, 1, 11), np.linspace(-1, 1, 41),
                    np.random.default_rng(0).normal(size=(11, 41)),
                    str(tmp_path / "c.png"))
        assert (tmp_path / "c.png").exists()


def test_checkpointer_roundtrip(tmp_path):
    from kanodes.train.checkpoint import Checkpointer, TrainState
    ck = Checkpointer(str(tmp_path / "ckpt"), keep=2)
    params = {"w": jnp.arange(4.0)}
    for step in (10, 20, 30):
        ck.save(TrainState(params=params, step=step,
                           best_loss=1.0 / step))
    assert ck.steps() == [20, 30]          # keep=2 retention
    st = ck.restore()
    np.testing.assert_allclose(st["params"]["w"], np.arange(4.0))
    assert st["step"] == 30
    assert ck.restore(20)["step"] == 20


def test_gates_cli(tmp_path):
    import json
    import subprocess
    import sys
    diag = {"tip_near_far_ratio": 1.5, "best_val": 1.0,
            "symmetry_mean_abs": 0.01, "pde_residual_mean_abs": 1.0,
            "nonfinite_grid_points": 0}
    p = tmp_path / "diag.json"
    p.write_text(json.dumps(diag))
    from kanodes.diag.gates import main
    assert main([str(p)]) == 0
    diag["best_val"] = 1e9
    p.write_text(json.dumps(diag))
    assert main([str(p)]) == 1


def test_symbolic_error_contours(tmp_path):
    import jax.numpy as jnp
    from kanodes.diag.plots import symbolic_error_contours

    def kan_rhs(pts):
        return jnp.stack([1.49 * pts[:, 0] - pts[:, 0] * pts[:, 1],
                          pts[:, 0] * pts[:, 1] - 2.95 * pts[:, 1]], axis=1)

    def truth(pts):
        return np.stack([1.5 * pts[:, 0] - pts[:, 0] * pts[:, 1],
                         pts[:, 0] * pts[:, 1] - 3.0 * pts[:, 1]], axis=1)

    exprs = ["1.5017*x0 - x0*x1", "x0*x1 - 3.0072*x1"]
    symbolic_error_contours(kan_rhs, exprs, truth, ((0.1, 4), (0.1, 4)),
                            str(tmp_path / "e.png"), n=30)
    assert (tmp_path / "e.png").exists()


def test_contour_compare_reference_panels(tmp_path):
    """Fig 4(C) parity: all ten reference-named PNG panels (truth + kan/
    mlp/symb/symb_comp errors per dim) are produced, stats returned."""
    import jax
    import jax.numpy as jnp
    from kanodes.diag.plots import contour_compare
    from kanodes.models import KANChain
    from kanodes.models.mlp import MLP

    kan = KANChain.mlp_like([2, 3, 2], grid_len=4)
    pk = kan.init(jax.random.PRNGKey(0))
    mlp = MLP((2, 8, 2))
    pm = mlp.init(jax.random.PRNGKey(1))

    def truth(pts):
        x, y = pts[:, 0], pts[:, 1]
        return np.stack([1.5 * x - x * y, x * y - 3.0 * y], 1)

    stats = contour_compare(
        truth, lambda p: kan.apply(pk, p), lambda p: mlp.apply(pm, p),
        ["1.5*x0 - x0*x1", "x0*x1 - 3.0*x1"], str(tmp_path), n=24,
        trajectory=np.asarray([[1.0, 1.0], [2.0, 0.5]]),
        sym_comp_rhs=lambda p: truth(np.asarray(p)))
    import os
    names = {f"{d}_{k}" for d in ("xdot", "ydot")
             for k in ("actual", "kan", "mlp", "symb", "symb_comp")}
    assert set(stats) == names
    for nm in names:
        assert os.path.exists(tmp_path / f"{nm}.png")
    # the global symbolic expressions here ARE the truth -> zero error
    assert stats["xdot_symb"] < 1e-5 and stats["ydot_symb"] < 1e-5


def test_activation_symbolic_overlays_reference_names(tmp_path):
    """Fig 4(A-B) parity: learned + *_symb_* per-activation files with
    the reference names, plus combined overlay panels."""
    import jax
    import jax.numpy as jnp
    from kanodes.diag.plots import activation_symbolic_overlays
    from kanodes.models import KANChain
    from kanodes.symbolic.engine import SymbolicFit
    from kanodes.symbolic.fit import EdgeEquation

    chain = KANChain.mlp_like([2, 3, 2], grid_len=4)
    params = chain.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(0).uniform(0.3, 4.0, (40, 2)),
                    jnp.float32)
    eqs = []
    for l, (I, O) in enumerate(((2, 3), (3, 2))):
        for i in range(I):
            for o in range(O):
                eqs.append(EdgeEquation(
                    l, i, o, SymbolicFit("0.5*x0", 0.0, 3), "0.5*x0"))
    files = activation_symbolic_overlays(chain, params, x, eqs,
                                         str(tmp_path))
    expected = {"X1.png", "Y1.png", "X_symb_1.png", "Y_symb_1.png",
                "second_1_to_X.png", "second_symb_1_to_X.png",
                "second_3_to_Y.png", "second_symb_3_to_Y.png",
                "overlay_layer1.png", "overlay_layer2.png"}
    assert expected.issubset(set(files))


def test_compose_edge_equations():
    """Per-edge symbolic composition reproduces the layer-sum semantics
    (symb_comp_getter, Plotting_symbolic.jl:96-140)."""
    from kanodes.symbolic.engine import SymbolicFit
    from kanodes.symbolic.fit import (EdgeEquation,
                                      compose_edge_equations)

    # layer 1: h_j = sum_i f_ij(x_i) with f_ij(x) = (j+1)*x for i=0,
    # 0 for i=1; layer 2: y_o = sum_j g_jo(h_j), g_jo(h) = h
    eqs = []
    for j in range(2):
        eqs.append(EdgeEquation(0, 0, j,
                                SymbolicFit(f"{j + 1}*x0", 0.0, 3), ""))
        eqs.append(EdgeEquation(0, 1, j, SymbolicFit("0*x0", 0.0, 3), ""))
        for o in range(2):
            eqs.append(EdgeEquation(1, j, o,
                                    SymbolicFit("x0", 0.0, 1), ""))
    fn = compose_edge_equations(eqs, (2, 2, 2))
    pts = np.asarray([[1.0, 5.0], [2.0, -1.0]])
    out = fn(pts)
    # h = [x, 2x]; y_o = h_0 + h_1 = 3x for both outputs
    np.testing.assert_allclose(out, np.stack([3 * pts[:, 0]] * 2, 1))
