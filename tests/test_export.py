"""jax.export model serialization round-trips."""

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.models import KANChain
from kanodes.utils.export import (export_forward, load_forward,
                                  export_rollout)


def test_forward_roundtrip():
    chain = KANChain.mlp_like([2, 6, 2], grid_len=5)
    params = chain.init(jax.random.PRNGKey(0))
    x = jnp.asarray([[0.5, 1.5], [2.0, 0.1]])
    blob = export_forward(chain.apply, params, x)
    assert isinstance(blob, bytes) and len(blob) > 100
    f = load_forward(blob)
    np.testing.assert_allclose(f(params, x), chain.apply(params, x),
                               rtol=1e-6)


def test_rollout_roundtrip():
    chain = KANChain.mlp_like([2, 6, 2], grid_len=5)
    params = jax.tree_util.tree_map(
        lambda a: a * 0.3, chain.init(jax.random.PRNGKey(1)))
    ts = jnp.linspace(0.0, 1.0, 6)
    u0 = jnp.asarray([1.0, 1.0])
    blob = export_rollout(chain, ts, u0, params)
    f = load_forward(blob)
    out = f(params, u0)
    assert out.shape == (6, 2)
    from kanodes.ode import odeint_fixed

    def rhs(t, u, p):
        return chain.apply(p, u)

    want = odeint_fixed(rhs, u0, ts, params, solver="tsit5")
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


# -- MAT-file interop (reference toolchain schema) ---------------------------

def test_mat_results_roundtrip(tmp_path):
    """save_mat_results/load_mat_results round-trip the reference's
    result schema (LV_driver_KANODE.jl:252-272): p_list rows reload and
    reshape back to the exact params pytrees."""
    from kanodes.utils.matio import (save_mat_results,
                                     load_mat_results,
                                     params_to_row, row_to_params)

    chain = KANChain.mlp_like([2, 5, 2], grid_len=5)
    ps = [chain.init(jax.random.PRNGKey(i)) for i in range(3)]
    ts = np.linspace(0.0, 14.0, 141)
    pred = np.stack([np.sin(ts), np.cos(ts)], axis=1)
    path = str(tmp_path / "run_results.mat")
    save_mat_results(path, p_list=ps, loss=[3.0, 2.0, 1.0],
                     loss_test=[4.0, 3.0], kan_pred_t=ts,
                     kan_pred_u=pred, size_kan=(2, 5, 5))
    back = load_mat_results(path)
    assert back["p_list"].shape == (3, params_to_row(ps[0]).size)
    np.testing.assert_array_equal(back["size_KAN"], [2.0, 5.0, 5.0])
    np.testing.assert_allclose(back["loss"], [3.0, 2.0, 1.0])
    # shorter loss_test was right-padded with its last value
    np.testing.assert_allclose(back["loss_test"], [4.0, 3.0, 3.0])
    np.testing.assert_allclose(back["kan_pred_u"], pred)
    # argmin-row selection, the reference's Plotting_standard.jl:105-110
    idx = int(np.argmin(back["loss"]))
    p_sel = row_to_params(back["p_list"][idx], ps[0])
    for a, b in zip(jax.tree_util.tree_leaves(p_sel),
                    jax.tree_util.tree_leaves(ps[idx])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-9)
    # reloaded params evaluate identically through the chain
    x = jnp.asarray([[0.7, 1.1]])
    np.testing.assert_allclose(chain.apply(p_sel, x),
                               chain.apply(ps[idx], x),
                               rtol=1e-6, atol=1e-7)


def test_lv_run_to_mat(tmp_path):
    """The lv.run() packager writes a file the loader (and therefore the
    reference plotting flow) can consume."""
    from kanodes.experiments import lv
    from kanodes.utils.matio import lv_run_to_mat, load_mat_results

    cfg = lv.LVConfig(iters=20, eval_every=10, layer_width=4,
                      record_history=True)
    out = lv.run(cfg)
    path = str(tmp_path / "lv_results.mat")
    lv_run_to_mat(out, path)
    back = load_mat_results(path)
    assert back["p_list"].shape[0] == 2          # one row per eval point
    assert back["kan_pred_t"].size == out["data"]["ts"].shape[0]
    np.testing.assert_array_equal(back["size_KAN"], [2.0, 4.0, 5.0])
    assert np.isfinite(back["p_list"]).all()
