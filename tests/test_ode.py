"""ODE solver stack: convergence order, adaptive accuracy vs analytic
solutions, gradient fidelity (direct vs backsolve vs finite differences)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.ode import odeint, odeint_fixed
from kanodes.ode.integrate import StepController


# -- analytic problems -------------------------------------------------------

def linear_rhs(t, y, args):
    return args * y          # y(t) = y0 exp(a t)


def cosine_rhs(t, y, args):
    return jnp.cos(t)        # y(t) = y0 + sin(t)


def lv_rhs(t, y, args):
    # Lotka-Volterra, truth params of the reference (LV_driver_KANODE.jl:116)
    alpha, beta, gamma, delta = args
    x, z = y[0], y[1]
    return jnp.stack([alpha * x - beta * x * z,
                      gamma * x * z - delta * z])


LV_ARGS = jnp.asarray([1.5, 1.0, 1.0, 3.0])
LV_Y0 = jnp.asarray([1.0, 1.0])


# -- fixed-step --------------------------------------------------------------

@pytest.mark.parametrize("solver,order", [("rk4", 4), ("tsit5", 5),
                                          ("heun", 2)])
def test_fixed_step_convergence_order(solver, order):
    ts = jnp.asarray([0.0, 1.0])
    a = jnp.asarray(-1.0)
    exact = jnp.exp(-1.0)
    errs = []
    # coarse steps: fine grids underflow the f32 error floor
    for substeps in (1, 2):
        ys = odeint_fixed(linear_rhs, jnp.asarray(1.0), ts, a,
                          solver=solver, substeps=substeps)
        errs.append(abs(float(ys[-1]) - float(exact)))
    rate = np.log2(errs[0] / max(errs[1], 1e-12))
    assert rate > order - 0.7, (solver, errs, rate)


def test_fixed_step_multi_save_points():
    ts = jnp.linspace(0.0, 2.0, 21)
    ys = odeint_fixed(cosine_rhs, jnp.asarray(0.5), ts, None, substeps=2)
    np.testing.assert_allclose(ys, 0.5 + np.sin(ts), rtol=1e-5, atol=1e-6)


def test_fixed_step_pytree_state():
    ts = jnp.linspace(0.0, 1.0, 5)

    def rhs(t, y, args):
        return {"a": -y["a"], "b": 2 * y["b"]}

    ys = odeint_fixed(rhs, {"a": jnp.asarray(1.0), "b": jnp.asarray(1.0)},
                      ts, None, substeps=4)
    np.testing.assert_allclose(ys["a"], np.exp(-ts), rtol=1e-5)
    np.testing.assert_allclose(ys["b"], np.exp(2 * ts), rtol=1e-4)


# -- adaptive ----------------------------------------------------------------

@pytest.mark.parametrize("adjoint", ["none", "direct", "backsolve"])
def test_adaptive_lv_accuracy(adjoint):
    ts = jnp.linspace(0.0, 3.5, 36)
    ys = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-8, atol=1e-10,
                max_steps=2000, adjoint=adjoint)
    # reference = very fine fixed-step RK4
    ys_ref = odeint_fixed(lv_rhs, LV_Y0, ts, LV_ARGS, solver="rk4",
                          substeps=200)
    np.testing.assert_allclose(ys, ys_ref, rtol=1e-5, atol=1e-6)


def test_adaptive_stats_and_rejections():
    ts = jnp.linspace(0.0, 3.5, 8)
    ys, stats = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-6, atol=1e-8,
                       adjoint="none", return_stats=True)
    assert bool(stats.success)
    assert int(stats.n_accept) >= 7
    assert int(stats.n_iter) < 4096


def test_adaptive_tolerance_scaling():
    ts = jnp.asarray([0.0, 3.5])
    ref = odeint_fixed(lv_rhs, LV_Y0, ts, LV_ARGS, solver="rk4", substeps=500)
    errs = []
    for rtol in (1e-4, 1e-7):
        ys = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=rtol, atol=rtol * 1e-2,
                    adjoint="none")
        errs.append(float(jnp.abs(ys[-1] - ref[-1]).max()))
    assert errs[1] < errs[0]
    assert errs[1] < 1e-5


def test_pi_controller_accuracy_and_defaults():
    """PI beta-pair: pcoeff=0 reproduces the legacy I-controller exactly;
    StepController.pi() solves to the same accuracy and does not inflate
    the iteration count on a stiff-ish oscillatory problem."""
    # Van der Pol (mu=5): stiff enough that an I-controller oscillates
    def vdp(t, y, mu):
        return jnp.stack([y[1], mu * ((1 - y[0] ** 2) * y[1]) - y[0]])

    y0 = jnp.asarray([2.0, 0.0])
    ts = jnp.asarray([0.0, 10.0])
    mu = jnp.asarray(5.0)
    ref = odeint_fixed(vdp, y0, ts, mu, solver="rk4", substeps=20_000)

    # pcoeff=0 path is bit-identical to the pre-PI controller by
    # construction: factor = safety * err^(-1/order)
    i_ctrl = StepController()
    assert i_ctrl.pcoeff == 0.0 and i_ctrl.icoeff == 1.0

    results = {}
    for name, ctrl in [("i", i_ctrl), ("pi", StepController.pi())]:
        ys, stats = odeint(vdp, y0, ts, mu, rtol=1e-6, atol=1e-8,
                           adjoint="none", max_steps=4096,
                           controller=ctrl, return_stats=True)
        assert bool(stats.success)
        err = float(jnp.abs(ys[-1] - ref[-1]).max())
        results[name] = (err, int(stats.n_iter), int(stats.n_reject))

    assert results["pi"][0] < 1e-3 and results["i"][0] < 1e-3
    # the PI pair must not be more rejection-prone than pure I control
    assert results["pi"][2] <= results["i"][2]


def test_pi_controller_differentiable_path():
    """PI controller composes with the direct adjoint (gradient flows)."""
    ts = jnp.linspace(0.0, 3.5, 8)

    def loss(args):
        ys = odeint(lv_rhs, LV_Y0, ts, args, rtol=1e-5, atol=1e-7,
                    adjoint="direct", max_steps=256,
                    controller=StepController.pi())
        return jnp.sum(ys[-1] ** 2)

    g = jax.grad(loss)(LV_ARGS)
    assert bool(jnp.all(jnp.isfinite(g))) and float(jnp.abs(g).max()) > 0


def test_backward_time_integration():
    ts = jnp.asarray([1.0, 0.0])
    ys = odeint(linear_rhs, jnp.asarray(jnp.e), ts, jnp.asarray(1.0),
                rtol=1e-8, atol=1e-10, adjoint="none")
    np.testing.assert_allclose(float(ys[-1]), 1.0, rtol=1e-5)


# -- gradients ---------------------------------------------------------------

def _loss_fn(adjoint):
    ts = jnp.linspace(0.0, 1.5, 6)
    target = odeint_fixed(lv_rhs, LV_Y0, ts, LV_ARGS, solver="rk4",
                          substeps=100)

    def loss(args):
        ys = odeint(lv_rhs, LV_Y0, ts, args, rtol=1e-7, atol=1e-9,
                    max_steps=512, adjoint=adjoint)
        return jnp.mean((ys - target) ** 2)

    return loss


def test_gradient_direct_vs_backsolve_vs_fd():
    args = jnp.asarray([1.4, 1.1, 0.9, 2.8])
    g_direct = jax.grad(_loss_fn("direct"))(args)
    g_back = jax.grad(_loss_fn("backsolve"))(args)
    np.testing.assert_allclose(g_direct, g_back, rtol=1e-3, atol=1e-6)

    # central finite differences
    loss = _loss_fn("direct")
    eps = 1e-4
    fd = []
    for i in range(4):
        e = jnp.zeros(4).at[i].set(eps)
        fd.append((loss(args + e) - loss(args - e)) / (2 * eps))
    # loose: adaptive accept/reject decisions flip under +-eps, so the
    # discretized map is only piecewise smooth in f32
    np.testing.assert_allclose(g_direct, jnp.asarray(fd), rtol=2e-2,
                               atol=1e-6)


def test_gradient_fixed_step_through_params_pytree():
    ts = jnp.linspace(0.0, 1.0, 4)

    def rhs(t, y, p):
        return p["a"] * y + p["b"]

    def loss(p):
        ys = odeint_fixed(rhs, jnp.asarray(1.0), ts, p, substeps=4)
        return jnp.sum(ys ** 2)

    g = jax.grad(loss)({"a": jnp.asarray(-0.5), "b": jnp.asarray(0.2)})
    assert jnp.isfinite(g["a"]) and jnp.isfinite(g["b"])
    # FD check on one coordinate
    eps = 1e-4
    lp = loss({"a": jnp.asarray(-0.5 + eps), "b": jnp.asarray(0.2)})
    lm = loss({"a": jnp.asarray(-0.5 - eps), "b": jnp.asarray(0.2)})
    np.testing.assert_allclose(float(g["a"]), float((lp - lm) / (2 * eps)),
                               rtol=2e-3)


def test_gradient_wrt_y0():
    ts = jnp.linspace(0.0, 1.0, 3)

    def loss(y0):
        ys = odeint(lv_rhs, y0, ts, LV_ARGS, rtol=1e-7, atol=1e-9,
                    adjoint="backsolve")
        return jnp.sum(ys[-1] ** 2)

    g = jax.grad(loss)(LV_Y0)
    eps = 1e-4

    def loss_fixed(y0):
        ys = odeint_fixed(lv_rhs, y0, ts, LV_ARGS, solver="rk4", substeps=64)
        return jnp.sum(ys[-1] ** 2)

    for i in range(2):
        e = jnp.zeros(2).at[i].set(eps)
        fd = (loss_fixed(LV_Y0 + e) - loss_fixed(LV_Y0 - e)) / (2 * eps)
        # f32 FD + backward-time re-simulation error: loose tolerance
        np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-2)


def test_odeint_jits():
    ts = jnp.linspace(0.0, 1.0, 5)
    f = jax.jit(lambda y0: odeint(lv_rhs, y0, ts, LV_ARGS, adjoint="none"))
    ys = f(LV_Y0)
    assert ys.shape == (5, 2)


def test_dense_output_accuracy():
    """Hermite dense output matches clipped-step saves within its
    3rd-order interpolation error."""
    ts = jnp.linspace(0.0, 3.5, 36)
    ys_clip = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-7, atol=1e-9,
                     adjoint="none")
    ys_dense, stats = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-7,
                             atol=1e-9, adjoint="none", dense=True,
                             return_stats=True)
    np.testing.assert_allclose(ys_dense, ys_clip, rtol=5e-4, atol=5e-4)
    # dense output must not take MORE steps than the clipped variant
    _, stats_clip = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-7,
                           atol=1e-9, adjoint="none", return_stats=True)
    assert int(stats.n_iter) <= int(stats_clip.n_iter)


def test_dense_output_backsolve_gradients():
    ts = jnp.linspace(0.0, 1.5, 6)
    target = odeint_fixed(lv_rhs, LV_Y0, ts, LV_ARGS, solver="rk4",
                          substeps=100)

    def loss(args, dense):
        ys = odeint(lv_rhs, LV_Y0, ts, args, rtol=1e-7, atol=1e-9,
                    adjoint="backsolve", dense=dense)
        return jnp.mean((ys - target) ** 2)

    g_d = jax.grad(lambda a: loss(a, True))(jnp.asarray([1.4, 1.1, 0.9, 2.8]))
    g_c = jax.grad(lambda a: loss(a, False))(jnp.asarray([1.4, 1.1, 0.9, 2.8]))
    np.testing.assert_allclose(g_d, g_c, rtol=5e-3, atol=1e-5)


def test_dense_direct_rejected():
    ts = jnp.linspace(0.0, 1.0, 4)
    with pytest.raises(ValueError, match="dense"):
        odeint(lv_rhs, LV_Y0, ts, LV_ARGS, adjoint="direct", dense=True)


def test_direct_remat_gradients_match_direct():
    args = jnp.asarray([1.4, 1.1, 0.9, 2.8])
    ts = jnp.linspace(0.0, 1.5, 6)
    target = odeint_fixed(lv_rhs, LV_Y0, ts, LV_ARGS, solver="rk4",
                          substeps=100)

    def loss(adjoint):
        def f(a):
            ys = odeint(lv_rhs, LV_Y0, ts, a, rtol=1e-7, atol=1e-9,
                        max_steps=512, adjoint=adjoint)
            return jnp.mean((ys - target) ** 2)
        return f

    g_d = jax.grad(loss("direct"))(args)
    g_r = jax.grad(loss("direct_remat"))(args)
    np.testing.assert_allclose(g_r, g_d, rtol=1e-5, atol=1e-8)


def test_interpolating_adjoint_values_and_gradients():
    """Interpolating adjoint: forward values equal the adjoint='none'
    solve bit-for-bit (same while_loop); gradients match the exact
    discrete adjoint within the continuous-adjoint discretization error."""
    args = jnp.asarray([1.4, 1.1, 0.9, 2.8])
    ts = jnp.linspace(0.0, 1.5, 6)
    target = odeint_fixed(lv_rhs, LV_Y0, ts, LV_ARGS, solver="rk4",
                          substeps=100)

    ys_i = odeint(lv_rhs, LV_Y0, ts, args, rtol=1e-7, atol=1e-9,
                  max_steps=512, adjoint="interpolating")
    ys_n = odeint(lv_rhs, LV_Y0, ts, args, rtol=1e-7, atol=1e-9,
                  max_steps=512, adjoint="none")
    np.testing.assert_array_equal(np.asarray(ys_i), np.asarray(ys_n))

    def loss(adjoint):
        def f(a):
            ys = odeint(lv_rhs, LV_Y0, ts, a, rtol=1e-7, atol=1e-9,
                        max_steps=512, adjoint=adjoint)
            return jnp.mean((ys - target) ** 2)
        return f

    g_i = jax.grad(loss("interpolating"))(args)
    g_d = jax.grad(loss("direct"))(args)
    np.testing.assert_allclose(g_i, g_d, rtol=1e-3, atol=1e-7)


def test_interpolating_adjoint_y0_and_pytree_args():
    ts = jnp.linspace(0.0, 1.0, 4)

    def rhs(t, y, p):
        return p["a"] * y + p["b"]

    p = {"a": jnp.asarray(-0.5), "b": jnp.asarray(0.2)}

    def loss(y0, p):
        ys = odeint(rhs, y0, ts, p, rtol=1e-7, atol=1e-9,
                    adjoint="interpolating")
        return jnp.sum(ys ** 2)

    (gy, gp) = jax.grad(loss, argnums=(0, 1))(jnp.asarray(1.0), p)
    def loss_fix(y0, p):
        ys = odeint_fixed(rhs, y0, ts, p, substeps=32)
        return jnp.sum(ys ** 2)
    (gy_f, gp_f) = jax.grad(loss_fix, argnums=(0, 1))(jnp.asarray(1.0), p)
    np.testing.assert_allclose(float(gy), float(gy_f), rtol=1e-3)
    np.testing.assert_allclose(float(gp["a"]), float(gp_f["a"]), rtol=1e-3)
    np.testing.assert_allclose(float(gp["b"]), float(gp_f["b"]), rtol=1e-3)


def test_interpolating_adjoint_stable_where_backsolve_diverges():
    """Strongly dissipative linear system: re-simulating backwards (the
    backsolve adjoint) amplifies error as exp(+lambda T); the
    interpolating adjoint reads the stored forward solution instead and
    stays accurate."""
    lam = -40.0
    ts = jnp.linspace(0.0, 2.0, 5)

    def rhs(t, y, a):
        return a * y

    def mk_loss(adjoint):
        def f(a):
            ys = odeint(rhs, jnp.asarray(1.0), ts, a, rtol=1e-6,
                        atol=1e-9, max_steps=2048, adjoint=adjoint)
            return ys[-1]
        return f

    # d y(T) / d lambda = T exp(lambda T) ~ 2 e^-80 ~ 0: tiny but the
    # interpolating estimate must be FINITE and near the direct value
    g_i = jax.grad(mk_loss("interpolating"))(jnp.asarray(lam))
    g_d = jax.grad(mk_loss("direct"))(jnp.asarray(lam))
    assert bool(jnp.isfinite(g_i))
    np.testing.assert_allclose(float(g_i), float(g_d), atol=1e-8)


def test_truncated_adaptive_fills_with_last_state():
    """Exhausting max_steps must not leave zero rows in ys."""
    ts = jnp.linspace(0.0, 3.5, 36)
    ys, stats = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-8, atol=1e-10,
                       max_steps=10, adjoint="none", return_stats=True)
    assert not bool(stats.success)
    # no all-zero rows; trailing rows equal the last integrated state
    assert float(jnp.abs(ys).min(axis=1).max()) > 0
    np.testing.assert_allclose(ys[-1], ys[-2], rtol=1e-6)


def test_truncated_interpolating_fills_and_grads_finite():
    """The interpolating adjoint applies the same unreached-slot fill as
    direct/none (no silent zero rows on max_steps exhaustion), and the
    fill rows' cotangents are routed into the final-state adjoint, so
    gradients stay finite and nonzero."""
    ts = jnp.linspace(0.0, 3.5, 36)
    ys_i = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-8, atol=1e-10,
                  max_steps=10, adjoint="interpolating")
    ys_n = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-8, atol=1e-10,
                  max_steps=10, adjoint="none")
    np.testing.assert_array_equal(np.asarray(ys_i), np.asarray(ys_n))
    assert float(jnp.abs(ys_i).min(axis=1).max()) > 0

    def loss(a):
        ys = odeint(lv_rhs, LV_Y0, ts, a, rtol=1e-8, atol=1e-10,
                    max_steps=10, adjoint="interpolating")
        return jnp.mean(ys ** 2)

    g = jax.grad(loss)(LV_ARGS)
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.abs(g).max()) > 0


def test_interpolating_adjoint_honors_dt0():
    """dt0 is threaded through the interpolating path (it was silently
    ignored): a tiny forced initial step must still produce the same
    solution values as the heuristic start, and the option must not
    error."""
    ts = jnp.linspace(0.0, 1.0, 4)
    ys_a = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-7, atol=1e-9,
                  adjoint="interpolating")
    ys_b = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-7, atol=1e-9,
                  dt0=1e-3, adjoint="interpolating")
    np.testing.assert_allclose(np.asarray(ys_a), np.asarray(ys_b),
                               rtol=1e-5, atol=1e-8)
    # and dt0 actually reaches the stepper: mirror the "none" path with
    # the same dt0, which must agree bit-for-bit (same while_loop)
    ys_n = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-7, atol=1e-9,
                  dt0=1e-3, adjoint="none")
    np.testing.assert_array_equal(np.asarray(ys_b), np.asarray(ys_n))


# -- save-time (ts) gradients -------------------------------------------------

def _ts_loss(adjoint):
    def loss(ts):
        ys = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-8, atol=1e-10,
                    max_steps=1024, adjoint=adjoint)
        return jnp.sum(ys ** 2)

    return loss


@pytest.mark.parametrize("adjoint", ["backsolve", "interpolating"])
def test_gradient_wrt_save_times(adjoint):
    """ts-cotangents of the custom-VJP adjoints: the continuous boundary
    terms dL/dt_i = g_i . f(t_i, y_i) (i >= 1) and
    dL/dt_0 = -a(t_0) . f(t_0, y_0) must match exact reverse AD through
    the save-clipped direct adjoint (closes the documented hard-zero
    gap; torchdiffeq time_vjps, predator_prey_adjoint.py:5,142)."""
    ts = jnp.linspace(0.0, 1.5, 6)
    g = jax.grad(_ts_loss(adjoint))(ts)
    g_direct = jax.grad(_ts_loss("direct"))(ts)
    assert float(jnp.abs(g_direct).max()) > 1e-2  # non-trivial signal
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_direct),
                               rtol=2e-3, atol=1e-5)
    # interior entries also match the analytic boundary term computed
    # from the (tight-tolerance) solution itself: 2 y_i . f(t_i, y_i)
    ys = odeint(lv_rhs, LV_Y0, ts, LV_ARGS, rtol=1e-8, atol=1e-10,
                max_steps=1024, adjoint="none")
    for i in range(1, 6):
        bt = 2.0 * float(ys[i] @ lv_rhs(ts[i], ys[i], LV_ARGS))
        np.testing.assert_allclose(float(g[i]), bt, rtol=1e-3)


def test_gradient_wrt_t0_finite_difference():
    """The initial-time term is the delicate one (adjoint BEFORE the g_0
    injection, negative sign): check it against central differences of
    the non-differentiated solve."""
    ts = jnp.linspace(0.2, 1.2, 4)
    g = jax.grad(_ts_loss("backsolve"))(ts)

    def loss_at_t0(t0):
        ts_p = ts.at[0].set(t0)
        ys = odeint(lv_rhs, LV_Y0, ts_p, LV_ARGS, rtol=1e-9, atol=1e-11,
                    max_steps=2048, adjoint="none")
        return float(jnp.sum(ys ** 2))

    eps = 1e-3
    fd = (loss_at_t0(0.2 + eps) - loss_at_t0(0.2 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), fd, rtol=5e-3)


def test_odeint_adjoint_params_subset():
    """torchdiffeq adjoint_params parity (predator_prey_adjoint.py:132-142):
    leaves masked False get exactly-zero cotangents; kept leaves match
    the unmasked gradient."""
    from kanodes.ode import odeint_adjoint
    ts = jnp.linspace(0.0, 1.0, 4)

    def rhs(t, y, p):
        return p["a"] * y + p["b"]

    p0 = {"a": jnp.asarray(-0.5), "b": jnp.asarray(0.3)}

    def make_loss(mask):
        def loss(p):
            ys = odeint_adjoint(rhs, jnp.asarray(1.0), ts, p,
                                rtol=1e-7, atol=1e-9,
                                adjoint_params=mask)
            return jnp.sum(ys ** 2)

        return loss

    g_all = jax.grad(make_loss(None))(p0)
    g_sub = jax.grad(make_loss({"a": True, "b": False}))(p0)
    assert float(g_sub["b"]) == 0.0
    assert float(jnp.abs(g_all["b"])) > 1e-3
    np.testing.assert_allclose(float(g_sub["a"]), float(g_all["a"]),
                               rtol=1e-5)
    # a single-leaf False prefix kills the whole args tree
    g_none = jax.grad(make_loss(False))(p0)
    assert float(g_none["a"]) == 0.0 and float(g_none["b"]) == 0.0
