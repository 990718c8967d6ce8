"""Symbolic regression engine + post-pass (native C++ GP via ctypes)."""

import numpy as np
import pytest

from kanodes.symbolic.engine import fit_expression
from kanodes.symbolic.fit import (simplify_expression,
                                  fit_scalar_function,
                                  resimulate_symbolic_rhs)


def test_recovers_fisher_kpp_source():
    # truth r*u*(1-u) (Fisher-KPP_Source.jl:234 recovers 0.9953x(1.0024-x))
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, 300)
    y = x * (1 - x)
    fit = fit_expression(x, y, ops=("+", "-", "*", "/"),
                         generations=150, restarts=2, seed=1)
    assert fit.mse < 1e-6, (fit.expression, fit.mse)
    # evaluates correctly
    np.testing.assert_allclose(fit(x), y, atol=1e-3)


def test_recovers_allen_cahn_source():
    # truth 5u - 5u^3 (Allen-Cahn_Source.jl:227)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 300)
    y = 5 * x - 5 * x ** 3
    fit = fit_expression(x, y, ops=("+", "-", "*", "/"),
                         generations=150, restarts=2, seed=2)
    assert fit.mse < 1e-5, (fit.expression, fit.mse)


def test_two_variable_recovery():
    # LV-style term: 1.5x - xy
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 3, (300, 2))
    y = 1.5 * X[:, 0] - X[:, 0] * X[:, 1]
    fit = fit_expression(X, y, ops=("+", "-", "*", "/"),
                         generations=250, restarts=3, seed=3)
    assert fit.mse < 1e-4, (fit.expression, fit.mse)


def test_fit_pareto_front():
    """The engine's Pareto archive: strictly improving MSE with size,
    and the true 2-term law appears as a compact front member."""
    from kanodes.symbolic.engine import fit_pareto
    rng = np.random.default_rng(0)
    x = rng.uniform(0.1, 2.0, (250, 1))
    y = 1.5 * x[:, 0] - x[:, 0] ** 2
    front = fit_pareto(x, y, ops=("+", "-", "*"), population=256,
                       generations=150, restarts=2, seed=5)
    assert len(front) >= 2
    sizes = [f.size for f in front]
    mses = [f.mse for f in front]
    assert sizes == sorted(sizes)
    assert all(b < a for a, b in zip(mses, mses[1:]))   # strict dominance
    # a compact member nails the law (LM-refined constants)
    good = [f for f in front if f.mse < 1e-10 and f.size <= 9]
    assert good, front


def test_simplify_expression():
    s = simplify_expression("((x0 - x0) - ((x0 + ((x0 - (x0 + x0)) / x0)) * x0))")
    # should reduce to x0 - x0**2 (i.e. x0*(1-x0))
    import sympy
    diff = sympy.simplify(sympy.sympify(s) - sympy.sympify("x0 - x0**2"))
    assert diff == 0, s


def test_fit_scalar_function():
    fit = fit_scalar_function(lambda u: 2.0 * u * (1 - u), 0.0, 1.0,
                              generations=120, restarts=2, seed=4)
    assert fit.mse < 1e-5


def test_resimulate_symbolic_rhs():
    # the paper's recovered LV ODE (Plotting_symbolic.jl:221-222)
    exprs = ["1.495*x0 - 0.986*x0*x1", "0.970*x0*x1 - 2.929*x1"]
    ts = np.linspace(0.0, 3.5, 36)
    ys = resimulate_symbolic_rhs(exprs, [1.0, 1.0], ts, 2)
    assert ys.shape == (36, 2)
    assert np.isfinite(np.asarray(ys)).all()
    # close to the true LV trajectory
    from kanodes.experiments.lv import LVConfig, make_data
    data = make_data(LVConfig())
    X = np.asarray(data["X"])[:36]
    assert float(np.mean((np.asarray(ys) - X) ** 2)) < 0.05


# ---------------------------------------------------------------------------
# SINDy engine (symbolic/sindy.py) — beyond-parity sparse regression
# ---------------------------------------------------------------------------

def test_polynomial_library_names_and_values():
    from kanodes.symbolic.sindy import polynomial_library

    X = np.asarray([[2.0, 3.0]])
    theta, names = polynomial_library(X, degree=2)
    want = {"1": 1.0, "x0": 2.0, "x1": 3.0,
            "x0**2": 4.0, "x0*x1": 6.0, "x1**2": 9.0}
    assert set(names) == set(want)
    for name, v in want.items():
        assert theta[0, names.index(name)] == v


def test_stlsq_recovers_sparse_coefficients_under_noise():
    from kanodes.symbolic.sindy import polynomial_library, stlsq

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (400, 2))
    theta, names = polynomial_library(X, degree=3)
    true = np.zeros(len(names))
    true[names.index("x0")] = 1.5
    true[names.index("x0*x1")] = -1.0
    y = theta @ true + rng.normal(0, 1e-4, 400)
    c = stlsq(theta, y, threshold=0.05)
    np.testing.assert_allclose(c, true, atol=1e-3)


def test_sindy_recovers_lv_rhs_exactly():
    """The LV vector field (1.5x-xy, xy-3y) comes back with exact
    least-squares coefficients — the closed-form counterpart of the GP
    fits in Symbolic_reg.jl:122-156."""
    from kanodes.symbolic.fit import eval_symreg_expr
    from kanodes.symbolic.sindy import fit_sindy

    rng = np.random.default_rng(2)
    X = rng.uniform(0.2, 4.0, (500, 2))
    Y = np.stack([1.5 * X[:, 0] - X[:, 0] * X[:, 1],
                  X[:, 0] * X[:, 1] - 3.0 * X[:, 1]], axis=1)
    fits = fit_sindy(X, Y, degree=3, threshold=0.05)
    assert fits[0].n_terms == 2 and fits[1].n_terms == 2
    assert fits[0].mse < 1e-20 and fits[1].mse < 1e-20
    # expressions evaluate through the shared env
    for k, fit in enumerate(fits):
        got = eval_symreg_expr(fit.expression, x0=X[:, 0], x1=X[:, 1])
        np.testing.assert_allclose(got, Y[:, k], atol=1e-4)


def test_sindy_expressions_resimulate():
    from kanodes.symbolic.fit import resimulate_symbolic_rhs
    from kanodes.symbolic.sindy import fit_sindy
    from kanodes.utils.host_rk import rk4_dense

    rng = np.random.default_rng(3)
    X = rng.uniform(0.2, 4.0, (500, 2))
    Y = np.stack([1.5 * X[:, 0] - X[:, 0] * X[:, 1],
                  X[:, 0] * X[:, 1] - 3.0 * X[:, 1]], axis=1)
    exprs = [f.expression for f in fit_sindy(X, Y, threshold=0.05)]
    ts = np.linspace(0.0, 3.5, 36)
    traj = np.asarray(resimulate_symbolic_rhs(exprs, [1.0, 1.0], ts, 2))

    def rhs(t, u):
        return np.asarray([1.5 * u[0] - u[0] * u[1],
                           u[0] * u[1] - 3.0 * u[1]])

    truth = rk4_dense(rhs, np.asarray([1.0, 1.0]), ts)
    np.testing.assert_allclose(traj, truth, atol=2e-4)


def test_sindy_auto_threshold_rejects_systematic_model_error():
    """threshold='auto' must recover the 2-term LV law even when the
    targets carry smooth SYSTEMATIC error (a trained network's
    approximation error generalizes to held-out samples, so plain
    validation or BIC keeps the dense fit — the penalized sweep in
    `_auto_support` is what prunes it)."""
    from kanodes.symbolic.sindy import fit_sindy

    rng = np.random.default_rng(0)
    t = rng.uniform(0, 1, 4000)
    X = np.stack([1 + 3 * np.abs(np.sin(3 * t)),
                  1 + 2.5 * np.abs(np.sin(3 * t + 1.2))], 1)
    X += rng.normal(0, 0.05, X.shape)
    err = (0.02 * np.sin(2.1 * X[:, 0] + 0.3) * np.cos(1.3 * X[:, 1] - 0.3)
           + 0.01 * np.tanh(X[:, 0] - 2))
    Y = 1.5 * X[:, 0] - X[:, 0] * X[:, 1] + err
    fit = fit_sindy(X, Y, degree=3, threshold="auto")[0]
    assert fit.n_terms == 2, fit.expression
    np.testing.assert_allclose(
        fit.coeffs[fit.names.index("x0")], 1.5, atol=0.02)
    np.testing.assert_allclose(
        fit.coeffs[fit.names.index("x0*x1")], -1.0, atol=0.02)


def test_sindy_recovers_source_laws():
    """Fisher-KPP (x - x^2) and Allen-Cahn (5x - 5x^3) — the laws the
    reference recovers by GP (Fisher-KPP_Source.jl:234,
    Allen-Cahn_Source.jl:227) — in one lstsq pass each."""
    from kanodes.symbolic.sindy import fit_sindy

    x = np.linspace(0, 1, 200)[:, None]
    fits = fit_sindy(x, x[:, 0] * (1 - x[:, 0]), degree=3)
    assert fits[0].n_terms == 2
    np.testing.assert_allclose(
        fits[0].coeffs[fits[0].names.index("x0")], 1.0, atol=1e-8)
    np.testing.assert_allclose(
        fits[0].coeffs[fits[0].names.index("x0**2")], -1.0, atol=1e-8)

    x = np.linspace(-1, 1, 200)[:, None]
    fits = fit_sindy(x, 5 * x[:, 0] - 5 * x[:, 0] ** 3, degree=4)
    assert fits[0].n_terms == 2
    np.testing.assert_allclose(
        fits[0].coeffs[fits[0].names.index("x0")], 5.0, atol=1e-8)
    np.testing.assert_allclose(
        fits[0].coeffs[fits[0].names.index("x0**3")], -5.0, atol=1e-8)


def test_recover_source_sindy_method():
    """recover_source(method='sindy') runs end to end on a (untrained)
    source model and returns an evaluable expression."""
    import jax

    from kanodes.experiments.pde_source import (SourceConfig,
                                                make_data, make_model,
                                                recover_source)
    from kanodes.symbolic.fit import eval_symreg_expr

    cfg = SourceConfig(problem="fisher_kpp")
    data = make_data(cfg)
    model = make_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rec = recover_source({"model": model, "best_params": params,
                          "data": data}, method="sindy")
    assert isinstance(rec["pretty"], str)
    lo, hi = rec["range"]
    vals = eval_symreg_expr(rec["fit"].expression,
                            x0=np.linspace(lo, hi, 7))
    assert np.all(np.isfinite(vals))


def test_sindy_from_trajectory_recovers_lv():
    """Classical SINDy: the LV field straight from the reference's
    training-horizon SAMPLES (dt=0.1, 35 points) — no model training,
    derivatives by 4th-order central differences."""
    from kanodes.experiments.lv import LVConfig, make_data
    from kanodes.symbolic.sindy import fit_sindy_trajectory

    data = make_data(LVConfig())
    n = data["n_train"]
    ts = np.asarray(data["ts"][:n])
    X = np.asarray(data["X"][:n])
    fits = fit_sindy_trajectory(ts, X, degree=3, threshold="auto")
    assert fits[0].n_terms == 2 and fits[1].n_terms == 2, \
        [f.expression for f in fits]
    np.testing.assert_allclose(
        fits[0].coeffs[fits[0].names.index("x0")], 1.5, atol=0.05)
    np.testing.assert_allclose(
        fits[0].coeffs[fits[0].names.index("x0*x1")], -1.0, atol=0.05)
    np.testing.assert_allclose(
        fits[1].coeffs[fits[1].names.index("x1")], -3.0, atol=0.08)
    np.testing.assert_allclose(
        fits[1].coeffs[fits[1].names.index("x0*x1")], 1.0, atol=0.05)


def test_sindy_trajectory_rejects_bad_inputs():
    from kanodes.symbolic.sindy import fit_sindy_trajectory

    with np.testing.assert_raises(ValueError):
        fit_sindy_trajectory(np.asarray([0.0, 0.1, 0.3, 0.4, 0.5]),
                             np.zeros((5, 2)))          # non-uniform
    with np.testing.assert_raises(ValueError):
        fit_sindy_trajectory(np.linspace(0, 1, 4), np.zeros((4, 2)))


def test_recover_source_from_data_no_training():
    """No-training source recovery: FD time-derivative minus known
    diffusion, SINDy on the pointwise residual — exact laws from the
    snapshots alone, 1-D and 2-D."""
    from kanodes.experiments.pde_source import recover_source_from_data
    from kanodes.pde import datagen

    r = recover_source_from_data(datagen.allen_cahn_source())
    assert r["fit"].n_terms == 2
    np.testing.assert_allclose(
        r["fit"].coeffs[r["fit"].names.index("x0")], 5.0, atol=1e-3)
    np.testing.assert_allclose(
        r["fit"].coeffs[r["fit"].names.index("x0**3")], -5.0, atol=1e-3)

    r = recover_source_from_data(datagen.fisher_kpp_2d(n=16, substeps=60),
                                 ndim=2)
    assert r["fit"].n_terms == 2
    np.testing.assert_allclose(
        r["fit"].coeffs[r["fit"].names.index("x0")], 1.0, atol=5e-3)
    np.testing.assert_allclose(
        r["fit"].coeffs[r["fit"].names.index("x0**2")], -1.0, atol=5e-3)
