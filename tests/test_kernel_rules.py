"""The Triton kernels' plumbing on the CPU: device rule, padding, row
blocks and masked tails, the gradient rule, and the XLA paths that serve
the configurations the kernels do not.

Kernels run in Pallas interpret mode here; the compiled kernels are
compared on the GPU by tests/test_kernels_chip.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.models import KANChain, KDense
from kanodes.models.core import Chain
from kanodes.ode import odeint_fixed
from kanodes.ops import kan_chain
from kanodes.ops.graybox_fused import (fused_graybox_rk_step,
                                       graybox_kernel_adapter,
                                       graybox_kron_kernel_adapter,
                                       GrayboxSpec)
from kanodes.ops.kan_chain import chain_spec_of, fused_params
from kanodes.ops.rk_fused import (_Blocks, fused_rk_multistep,
                                  fused_rk_step)
from kanodes.pde import datagen


# ---------------------------------------------------------------------------
# device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,interpret", [("cpu", True),
                                               ("gpu", False)])
def test_kernel_route_by_backend(monkeypatch, backend, interpret):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert kan_chain.kernel_interpret() is interpret


@pytest.mark.parametrize("backend", ["neuron", "rocm", "METAL"])
def test_kernel_route_other_backends_raise(monkeypatch, backend):
    """No backend but the GPU compiles the kernels, and nothing quietly
    falls back to the interpreter there."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no kernel route"):
        kan_chain.kernel_interpret()


def test_kernels_name_the_triton_route():
    assert kan_chain.KERNEL_BACKEND == "triton"


# ---------------------------------------------------------------------------
# padding and row blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,padded", [(1, 16), (2, 16), (10, 16), (16, 16),
                                      (17, 32), (41, 64), (402, 512)])
def test_feature_padding_to_dot_minimum(n, padded):
    assert kan_chain.pow2(n) == padded


@pytest.mark.parametrize("K,bk,nb", [(1, 16, 1), (5, 16, 1), (32, 32, 1),
                                     (33, 32, 2), (34, 32, 2),
                                     (100, 32, 4)])
def test_row_blocks(K, bk, nb):
    spec = kan_chain.ChainSpec(2, 10, 2, 5)
    blk = _Blocks(spec, K)
    assert (blk.bk, blk.nb) == (bk, nb)
    assert (blk.Ip, blk.Hp, blk.Op) == (16, 16, 16)


def test_dot_helpers_refuse_sub_minimum_shapes():
    a = jnp.ones((8, 16))
    with pytest.raises(AssertionError):
        kan_chain.dot(a, jnp.ones((16, 16)), None)


@pytest.mark.parametrize("prec", ["highest", "tf32"])
def test_bwd_precision_names(prec):
    assert kan_chain.check_bwd_precision(prec) == prec


@pytest.mark.parametrize("bad", ["bf16", "default", "f32"])
def test_bwd_precision_rejects_unknown(bad):
    with pytest.raises(ValueError, match="bwd_precision"):
        kan_chain.check_bwd_precision(bad)


# ---------------------------------------------------------------------------
# chain validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", [
    KANChain.mlp_like([2, 4, 4, 2], grid_len=5),           # 3 layers
    KANChain(KDense(2, 4, 5, trainable_grid=True), KDense(4, 2, 5)),
    KANChain(KDense(2, 4, 5, basis="cheby"), KDense(4, 2, 5, basis="cheby")),
    KANChain(KDense(2, 4, 5), KDense(4, 2, 7)),             # grid mismatch
])
def test_fused_path_rejects_unsupported_chain(chain):
    with pytest.raises(ValueError):
        chain_spec_of(chain)


def test_fused_params_read_natural_layout():
    chain = KANChain.mlp_like([2, 10, 2], grid_len=5)
    params = chain.init(jax.random.PRNGKey(0))
    c1, w1, c2, w2 = fused_params(params)
    assert c1.shape == (2, 5, 10) and w1.shape == (2, 10)
    assert c2.shape == (10, 5, 2) and w2.shape == (10, 2)


# ---------------------------------------------------------------------------
# kernels vs the XLA reference: masked tails, multi-block grids, solvers
# ---------------------------------------------------------------------------

def _chain(widths=(2, 10, 2), grid=5, **kw):
    chain = KANChain.mlp_like(list(widths), grid_len=grid, **kw)
    params = jax.tree_util.tree_map(
        lambda a: a * 0.5, chain.init(jax.random.PRNGKey(0)))
    return chain, params


def _xla_step(chain, solver, dt):
    ts = jnp.asarray([0.0, dt])

    def step(params, x):
        rhs = lambda t, u, p: chain.apply(p, u)
        return jax.vmap(lambda xi: odeint_fixed(rhs, xi, ts, params,
                                                solver=solver)[-1])(x)
    return step


def _check_step(chain, params, x, solver="tsit5", dt=0.1, rtol=1e-4):
    spec = chain_spec_of(chain)
    ref = _xla_step(chain, solver, dt)
    y = fused_rk_step(spec, solver, dt, x, *fused_params(params))
    np.testing.assert_allclose(y, ref(params, x), rtol=1e-5, atol=1e-6)
    tgt = x * 1.05

    def lf(p, x):
        return jnp.mean((fused_rk_step(spec, solver, dt, x,
                                       *fused_params(p)) - tgt) ** 2)

    def lr(p, x):
        return jnp.mean((ref(p, x) - tgt) ** 2)

    gf = jax.grad(lf, argnums=(0, 1))(params, x)
    gr = jax.grad(lr, argnums=(0, 1))(params, x)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gr)):
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-6 * float(np.max(np.abs(b))))


@pytest.mark.parametrize("K", [1, 31, 33, 70])
def test_step_masked_row_tails(K):
    """K below, just under, just over and several blocks past the row
    block: every row of the batch is stepped and differentiated."""
    chain, params = _chain()
    x = jax.random.uniform(jax.random.PRNGKey(K), (K, 2), minval=0.2,
                           maxval=1.5)
    _check_step(chain, params, x)


@pytest.mark.parametrize("solver", ["rk4", "heun", "bs3", "dopri5"])
def test_step_other_tableaus(solver):
    chain, params = _chain()
    x = jnp.asarray([[1.0, 1.0], [0.5, 2.0], [1.4, 0.3]])
    _check_step(chain, params, x, solver=solver)


def test_step_softsign_burgers_width():
    """A [41,10,41] softsign chain: features padded 41 -> 64."""
    chain, params = _chain((41, 10, 41), normalizer="softsign")
    x = jax.random.uniform(jax.random.PRNGKey(3), (3, 41), minval=-1.0,
                           maxval=1.0)
    _check_step(chain, params, x, dt=0.01)


@pytest.mark.parametrize("K", [1, 34])
def test_multistep_matches_reference(K):
    chain, params = _chain()
    spec = chain_spec_of(chain)
    n, dt = 6, 0.1
    x0 = jax.random.uniform(jax.random.PRNGKey(1), (K, 2), minval=0.3,
                            maxval=1.5)
    ts = jnp.arange(n + 1, dtype=jnp.float32) * dt

    def ref(p, x):
        rhs = lambda t, u, q: chain.apply(q, u)
        ys = jax.vmap(lambda xi: odeint_fixed(rhs, xi, ts, p,
                                              solver="tsit5")[1:])(x)
        return jnp.swapaxes(ys, 0, 1)

    ys = fused_rk_multistep(spec, "tsit5", dt, n, x0, *fused_params(params))
    np.testing.assert_allclose(ys, ref(params, x0), rtol=1e-5, atol=1e-6)
    tgt = jnp.ones_like(ys)
    gf = jax.grad(lambda p, x: jnp.mean((fused_rk_multistep(
        spec, "tsit5", dt, n, x, *fused_params(p)) - tgt) ** 2),
        argnums=(0, 1))(params, x0)
    gr = jax.grad(lambda p, x: jnp.mean((ref(p, x) - tgt) ** 2),
                  argnums=(0, 1))(params, x0)
    for a, b in zip(jax.tree_util.tree_leaves(gf),
                    jax.tree_util.tree_leaves(gr)):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * float(np.max(np.abs(b))))


def test_step_vmap_over_parameters():
    """vmap lifts into the kernel grid (stacked ensembles)."""
    chain, _ = _chain()
    spec = chain_spec_of(chain)
    stacked = jax.vmap(chain.init)(jax.random.split(jax.random.PRNGKey(0),
                                                    3))
    x = jnp.asarray([[1.0, 1.0], [0.5, 2.0]])
    ys = jax.vmap(lambda p: fused_rk_step(spec, "tsit5", 0.1, x,
                                          *fused_params(p)))(stacked)
    for s in range(3):
        p = jax.tree_util.tree_map(lambda a: a[s], stacked)
        np.testing.assert_allclose(
            ys[s], _xla_step(chain, "tsit5", 0.1)(p, x), rtol=1e-5,
            atol=1e-6)


# ---------------------------------------------------------------------------
# gray-box kernel: several rows, padded widths, non-power-of-two fields
# ---------------------------------------------------------------------------

def _gb_setup(n=26, dx=0.04):
    layer = KDense(1, 1, 10, normalizer="softsign")
    params = layer.init(jax.random.PRNGKey(0))
    lap = jnp.asarray(datagen._cyclic_lap(n, dx), jnp.float32)
    return layer, params, lap


def test_graybox_batched_rows_match_single_rows():
    layer, params, lap = _gb_setup()
    spec = GrayboxSpec.of_layer(layer)
    c, w = params["C"].reshape(1, -1), params["W"].reshape(1, 1)
    u = 0.5 + 0.3 * jnp.sin(jnp.arange(3 * 26, dtype=jnp.float32)
                            .reshape(3, 26))
    y = fused_graybox_rk_step(spec, "tsit5", 0.05, 0.01, u, lap, c, w)
    for r in range(3):
        yr = fused_graybox_rk_step(spec, "tsit5", 0.05, 0.01, u[r:r + 1],
                                   lap, c, w)
        np.testing.assert_allclose(y[r:r + 1], yr, rtol=1e-6, atol=1e-7)
    g = jax.grad(lambda c: jnp.sum(fused_graybox_rk_step(
        spec, "tsit5", 0.05, 0.01, u, lap, c, w) ** 2))(c)
    g_rows = sum(jax.grad(lambda c: jnp.sum(fused_graybox_rk_step(
        spec, "tsit5", 0.05, 0.01, u[r:r + 1], lap, c, w) ** 2))(c)
        for r in range(3))
    np.testing.assert_allclose(g, g_rows, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("n", [5, 12])
def test_graybox_kron_padded_field(n):
    """2-D fields whose side is not a power of two pad to 16 lanes; the
    padded lanes never feed the real ones."""
    layer, params, _ = _gb_setup()
    dx = 1.0 / n
    lap1 = jnp.asarray(datagen._cyclic_lap(n, dx), jnp.float32)
    D, dt = 0.01, 0.01
    _, advance = graybox_kron_kernel_adapter(layer, lap1, D)
    ij = np.add.outer(np.arange(n), np.arange(n))
    u0 = jnp.asarray(0.4 + 0.3 * np.sin(ij / 2.0), jnp.float32)

    def rhs(t, u, p):
        lap_u = jnp.matmul(lap1, u, precision="highest") + \
            jnp.matmul(u, lap1, precision="highest")
        return D * lap_u + layer.apply(p, u.reshape(-1, 1)).reshape(u.shape)

    ts = jnp.arange(3, dtype=jnp.float32) * dt
    np.testing.assert_allclose(advance(params, u0, dt, 2),
                               odeint_fixed(rhs, u0, ts, params,
                                            solver="tsit5"),
                               rtol=1e-5, atol=1e-6)


def test_graybox_adapter_gradient_wrt_initial_state():
    layer, params, lap = _gb_setup()
    _, advance = graybox_kernel_adapter(layer, lap, 0.01)
    u0 = jnp.asarray(0.5 + 0.2 * np.cos(np.arange(26)), jnp.float32)

    def rhs(t, u, p):
        return 0.01 * jnp.matmul(lap, u, precision="highest") + \
            layer.apply(p, u[:, None])[:, 0]

    ts = jnp.asarray([0.0, 0.05, 0.1])
    gf = jax.grad(lambda u: jnp.sum(advance(params, u, 0.05, 2)[-1] ** 3))(u0)
    gx = jax.grad(lambda u: jnp.sum(odeint_fixed(
        rhs, u, ts, params, solver="tsit5")[-1] ** 3))(u0)
    np.testing.assert_allclose(gf, gx, rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# driver routing and the XLA paths that replaced removed kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "fused_wide"])
def test_lv_rejects_removed_impls(impl):
    from kanodes.experiments import lv
    cfg = lv.LVConfig(impl=impl)
    with pytest.raises(ValueError, match="impl"):
        lv.make_ode_fns(cfg, lv.make_model(cfg), lv.make_data(cfg))


def test_source_rejects_unknown_impl():
    from kanodes.experiments import pde_source as src
    cfg = src.SourceConfig(impl="pallas", data_dx=0.2, data_substeps=4)
    with pytest.raises(ValueError, match="impl"):
        src.make_fns(cfg, src.make_model(cfg), src.make_data(cfg))


@pytest.mark.parametrize("widths,grid,wins", [
    ([2, 10, 2], 5, True),        # LV: timed, kernel faster
    ([41, 10, 41], 5, True),      # Burgers: timed, kernel faster
    ([2, 4, 2], 3, True),         # smallest reference sweep point
    ([2, 40, 2], 5, False),       # widest sweep point: timed, XLA faster
    ([16, 80, 16], 5, False),     # packed 8-member LV: timed, XLA faster
    ([41, 10, 41], 10, False),    # Allen-Cahn: timed, XLA faster
    ([402, 10, 402], 10, False),  # Schrödinger: untimed
])
def test_kernel_width_rule(widths, grid, wins):
    from kanodes.ops import rk_fused

    spec = chain_spec_of(KANChain.mlp_like(widths, grid_len=grid))
    assert rk_fused.kernel_wins(spec) is wins


def _count_kernel_calls(monkeypatch, wins):
    """Force the width rule to `wins` and count the kernel calls."""
    from kanodes.ops import rk_fused

    monkeypatch.setattr(rk_fused, "kernel_wins", lambda spec: wins)
    calls = []
    for name in ("fused_rk_step", "fused_rk_multistep"):
        real = getattr(rk_fused, name)
        monkeypatch.setattr(rk_fused, name,
                            lambda *a, _f=real, **k: calls.append(1)
                            or _f(*a, **k))
    return calls


@pytest.mark.parametrize("uses_kernel", [False, True])
def test_surrogate_width_rule(monkeypatch, uses_kernel):
    """impl='fused' runs the kernels where rk_fused.kernel_wins admits the
    chain and XLA on the same uniform step grid elsewhere: same loss and
    gradient either way."""
    from kanodes.experiments import pde_surrogate as ps

    calls = _count_kernel_calls(monkeypatch, uses_kernel)
    for mode in ("fixed", "shooting"):
        cfg = ps.SurrogateConfig(impl="fused", problem="burgers",
                                 substeps=2, data_dx=0.2, solve_mode=mode)
        data = ps.make_data(cfg)
        model = ps.make_model(cfg, data)
        params = model.init(jax.random.PRNGKey(0))
        loss_f, _, _ = ps.make_fns(cfg, model, data)
        # the uniform grid written out: every interval in base_h steps
        ts = np.asarray(data.ts[np.asarray(ps._SNAPSHOTS["burgers"]["idx"])])
        base_h = float(np.min(np.diff(ts))) / cfg.substeps
        n = [int(round(d / base_h)) for d in np.diff(ts)]

        def ref(p):
            rhs = lambda t, u, pp: model.apply(pp, u)
            x0 = jnp.asarray(data.X[0], jnp.float32)
            dense = jnp.arange(sum(n) + 1, dtype=jnp.float32) * base_h
            if mode == "fixed":
                ys = odeint_fixed(rhs, x0, dense, p, solver="tsit5")
                pred = ys[np.concatenate([[0], np.cumsum(n)])]
                return jnp.mean((pred - data.X[np.asarray(
                    ps._SNAPSHOTS["burgers"]["idx"])]) ** 2)
            snaps = jnp.asarray(data.X[np.asarray(
                ps._SNAPSHOTS["burgers"]["idx"])], jnp.float32)
            ends = [odeint_fixed(rhs, snaps[i], dense[:k + 1], p,
                                 solver="tsit5")[-1]
                    for i, k in enumerate(n)]
            return jnp.mean((jnp.stack(ends) - snaps[1:]) ** 2)

        np.testing.assert_allclose(loss_f(params), ref(params), rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(jax.grad(loss_f)(params)),
                        jax.tree_util.tree_leaves(jax.grad(ref)(params))):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-7)
    assert bool(calls) is uses_kernel


@pytest.mark.parametrize("mode", ["shooting", "fixed"])
@pytest.mark.parametrize("uses_kernel", [False, True])
def test_lv_width_rule(monkeypatch, mode, uses_kernel):
    """LV impl='fused' follows the same rule; a chain the rule refuses
    takes the plain XLA path, so the loss equals impl='xla' exactly."""
    from kanodes.experiments import lv

    calls = _count_kernel_calls(monkeypatch, uses_kernel)
    cfg = lv.LVConfig(impl="fused", solve_mode=mode, init_scale=0.3)
    data, model = lv.make_data(cfg), lv.make_model(cfg)
    params = lv.init_params(cfg, model)
    loss_f, _, _ = lv.make_ode_fns(cfg, model, data)
    loss_x, _, _ = lv.make_ode_fns(dataclasses.replace(cfg, impl="xla"),
                                   model, data)
    np.testing.assert_allclose(loss_f(params), loss_x(params),
                               rtol=1e-5 if uses_kernel else 0)
    assert bool(calls) is uses_kernel


def test_lv_adaptive_fused_impl_takes_xla_controller():
    """impl='fused' with solve_mode='adaptive' runs ode.odeint: the same
    loss and gradients as impl='xla'."""
    from kanodes.experiments import lv
    data = lv.make_data(lv.LVConfig())
    model = lv.make_model(lv.LVConfig())
    params = jax.tree_util.tree_map(
        lambda a: a * 1e4, lv.init_params(lv.LVConfig(), model))
    out = {}
    for impl in ("fused", "xla"):
        cfg = lv.LVConfig(solve_mode="adaptive", impl=impl, max_steps=64)
        loss, _, _ = lv.make_ode_fns(cfg, model, data)
        out[impl] = jax.value_and_grad(loss)(params)
    np.testing.assert_allclose(out["fused"][0], out["xla"][0], rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(out["fused"][1]),
                    jax.tree_util.tree_leaves(out["xla"][1])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


def test_wide_chain_gradient_matches_finite_difference():
    """The 402-wide Schrödinger-width chain ([402,10,402], grid 10) on the
    XLA path: the reverse-mode gradient agrees with a central finite
    difference along a random direction."""
    chain = KANChain.mlp_like([402, 10, 402], grid_len=10,
                              normalizer="softsign")
    params = jax.tree_util.tree_map(
        lambda a: a * 0.1, chain.init(jax.random.PRNGKey(0)))
    u0 = 0.3 * jnp.sin(jnp.arange(402, dtype=jnp.float32) / 20.0)
    ts = jnp.asarray([0.0, 0.01, 0.02])

    def loss(p):
        ys = odeint_fixed(lambda t, u, q: chain.apply(q, u), u0, ts, p,
                          solver="rk4", substeps=2)
        return jnp.sum((ys[-1] - u0) ** 2)     # the displacement: the
                                               # loss is all signal
    g = jax.grad(loss)(params)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    leaves, tree = jax.tree_util.tree_flatten(params)
    d = [jax.random.normal(k, l.shape) for k, l in zip(keys, leaves)]
    norm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in d)))
    direction = jax.tree_util.tree_unflatten(tree, [x / norm for x in d])
    eps = 3e-2
    plus = jax.tree_util.tree_map(lambda p, d: p + eps * d, params,
                                  direction)
    minus = jax.tree_util.tree_map(lambda p, d: p - eps * d, params,
                                   direction)
    fd = (float(loss(plus)) - float(loss(minus))) / (2 * eps)
    ad = sum(float(jnp.vdot(a, b)) for a, b in zip(
        jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(direction)))
    np.testing.assert_allclose(ad, fd, rtol=2e-2)


def test_compile_cache_helper_respects_environment(monkeypatch):
    from kanodes.utils import compile_cache

    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    compile_cache.enable_compile_cache()
    assert seen == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    compile_cache.enable_compile_cache()
    assert seen == [("jax_compilation_cache_dir",
                     str(compile_cache.CACHE_DIR))]
    assert compile_cache.CACHE_DIR.name == ".jax_cache"


def test_deploy_default_platforms_are_cpu_and_cuda():
    from kanodes.deploy import export
    assert export._DEFAULT_PLATFORMS == ("cpu", "cuda")


def test_claims_backend_key_rejects_unknown(monkeypatch):
    from kanodes.diag import claims
    monkeypatch.setattr(jax, "default_backend", lambda: "neuron")
    with pytest.raises(RuntimeError, match="no stored expectations"):
        claims._backend()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert claims._backend() == "gpu"


def test_packed_chain_through_kernels_matches_members():
    """A packed 2-member LV chain ([4,20,4]) through the step kernel
    equals each member's own kernel step."""
    from kanodes.experiments.lv import LVConfig, make_model
    from kanodes.models.packed import pack_chain, pack_params, tile_state

    model = make_model(LVConfig())
    members = [jax.tree_util.tree_map(lambda a: a * 0.5,
                                      model.init(jax.random.PRNGKey(s)))
               for s in range(2)]
    packed_model = pack_chain(model, 2)
    packed = pack_params(model, members)
    x = jnp.asarray([[1.0, 1.0], [0.6, 1.8]])
    yp = fused_rk_step(chain_spec_of(packed_model), "tsit5", 0.1,
                       tile_state(x, 2), *fused_params(packed))
    spec = chain_spec_of(model)
    for s in range(2):
        ys = fused_rk_step(spec, "tsit5", 0.1, x, *fused_params(members[s]))
        np.testing.assert_allclose(yp[:, 2 * s:2 * s + 2], ys, rtol=1e-5,
                                   atol=1e-6)


def test_kernel_step_inside_jit_and_scan():
    chain, params = _chain()
    spec = chain_spec_of(chain)
    fp = fused_params(params)

    @jax.jit
    def roll(x):
        def body(c, _):
            return fused_rk_step(spec, "tsit5", 0.1, c, *fp), None
        return jax.lax.scan(body, x, None, length=3)[0]

    x = jnp.asarray([[1.0, 1.0]])
    want = x
    for _ in range(3):
        want = _xla_step(chain, "tsit5", 0.1)(params, want)
    np.testing.assert_allclose(roll(x), want, rtol=1e-5, atol=1e-6)


def test_chain_spec_centers_match_layer_grid():
    layer = KDense(2, 3, 7, grid_lims=(-2.0, 1.5))
    chain = Chain(layer, KDense(3, 2, 7, grid_lims=(-2.0, 1.5)))
    spec = chain_spec_of(chain)
    np.testing.assert_allclose(np.asarray(spec.centers),
                               np.asarray(layer.grid()), rtol=0, atol=1e-6)
    assert dataclasses.replace(spec, denominator=0.3).h == 0.3
