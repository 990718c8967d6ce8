"""Serving export: StableHLO artifact roundtrips match live inference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.deploy import (ServingArtifact, export_graybox_trajectory,
                            export_rhs, export_trajectory)
from kanodes.models import KDense
from kanodes.models.core import Chain
from kanodes.ode import odeint_fixed
from kanodes.pde import datagen
from kanodes.utils.precision import matmul_precision


@pytest.fixture
def lv_chain():
    model = Chain(KDense(2, 6, 5), KDense(6, 2, 5))
    params = model.init(jax.random.PRNGKey(0))
    return model, params


def test_rhs_roundtrip_symbolic_batch(lv_chain, tmp_path):
    model, params = lv_chain
    art = export_rhs(model, params)          # symbolic batch
    p = str(tmp_path / "rhs.kexp")
    art.save(p)
    loaded = ServingArtifact.load(p)
    assert loaded.meta["kind"] == "rhs"
    assert loaded.meta["batch"] == "symbolic"
    # one artifact serves multiple batch sizes
    for b in (1, 3, 7):
        x = jnp.asarray(np.random.default_rng(b).normal(0, 0.5, (b, 2)),
                        jnp.float32)
        np.testing.assert_allclose(np.asarray(loaded(x)),
                                   np.asarray(model.apply(params, x)),
                                   rtol=1e-6, atol=1e-7)


def test_rhs_static_batch(lv_chain, tmp_path):
    model, params = lv_chain
    art = export_rhs(model, params, batch=4)
    assert art.meta["batch"] == 4
    x = jnp.ones((4, 2), jnp.float32)
    np.testing.assert_allclose(np.asarray(art(x)),
                               np.asarray(model.apply(params, x)),
                               rtol=1e-6, atol=1e-7)


def test_trajectory_roundtrip(lv_chain, tmp_path):
    model, params = lv_chain
    ts = jnp.linspace(0.0, 1.0, 11)
    art = export_trajectory(model, params, ts, solver="tsit5", substeps=2)
    p = str(tmp_path / "traj.kexp")
    art.save(p)
    loaded = ServingArtifact.load(p)
    assert loaded.meta["n_save"] == 11
    assert loaded.meta["solver"] == "tsit5"

    def rhs(t, u, _):
        return model.apply(params, u[None, :])[0]

    u0 = jnp.asarray([1.0, 1.0], jnp.float32)
    want = odeint_fixed(rhs, u0, ts, None, solver="tsit5", substeps=2)
    np.testing.assert_allclose(np.asarray(loaded(u0)), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_graybox_trajectory_roundtrip(tmp_path):
    layer = KDense(1, 1, 8, normalizer="softsign")
    params = layer.init(jax.random.PRNGKey(1))
    n, dx, D = 24, 0.05, 0.01
    lap = jnp.asarray(datagen._cyclic_lap(n, dx), jnp.float32)
    ts = jnp.linspace(0.0, 0.2, 5)
    art = export_graybox_trajectory(layer, params, lap, D, ts, substeps=2)
    p = str(tmp_path / "gb.kexp")
    art.save(p)
    loaded = ServingArtifact.load(p)
    assert loaded.meta["grid_points"] == n

    def rhs(t, u, _):
        known = D * jnp.matmul(lap, u, precision=matmul_precision())
        return known + layer.apply(params, u[:, None])[:, 0]

    u0 = jnp.asarray(0.4 + 0.3 * np.sin(np.arange(n)), jnp.float32)
    want = odeint_fixed(rhs, u0, ts, None, solver="tsit5", substeps=2)
    np.testing.assert_allclose(np.asarray(loaded(u0)), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_trajectory_batched_symbolic(lv_chain, tmp_path):
    """batch="any" exports a fleet-of-ICs rollout with a symbolic batch
    dimension: one artifact integrates any number of trajectories."""
    model, params = lv_chain
    ts = jnp.linspace(0.0, 0.5, 6)
    art = export_trajectory(model, params, ts, substeps=1, batch="any")
    assert art.meta["batch"] == "symbolic"
    p = str(tmp_path / "fleet.kexp")
    art.save(p)
    loaded = ServingArtifact.load(p)

    def rhs(t, u, _):
        return model.apply(params, u[None, :])[0]

    for b in (2, 5):
        u0s = jnp.asarray(np.random.default_rng(b).uniform(0.5, 1.5, (b, 2)),
                          jnp.float32)
        got = loaded(u0s)
        assert got.shape == (6, b, 2)
        for k in range(b):
            want = odeint_fixed(rhs, u0s[k], ts, None, solver="tsit5")
            np.testing.assert_allclose(np.asarray(got[:, k]),
                                       np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_pinn_field_export(tmp_path):
    """The generic field exporter serves the KAN-PINN displacement
    potential (same Layer protocol as the ODE models)."""
    from kanodes.pinn.model import KANPINN

    model = KANPINN(widths=(2, 8, 1), n_basis=6)
    params = model.init(jax.random.PRNGKey(3))
    from kanodes.deploy import export_field
    art = export_field(model, params)
    assert art.meta["kind"] == "field"
    p = str(tmp_path / "pinn.kexp")
    art.save(p)
    loaded = ServingArtifact.load(p)
    xy = jnp.asarray(np.random.default_rng(5).uniform(0, 1, (13, 2)),
                     jnp.float32)
    np.testing.assert_allclose(np.asarray(loaded(xy)),
                               np.asarray(model.apply(params, xy)),
                               rtol=1e-6, atol=1e-7)


def test_multiplatform_payload(lv_chain):
    """Default export lowers for BOTH cpu and cuda into one artifact, so
    a dev-box export runs on the serving GPUs unchanged."""
    model, params = lv_chain
    art = export_rhs(model, params, batch=2)
    assert set(art.platforms) == {"cpu", "cuda"}


def test_load_rejects_non_artifact(tmp_path):
    p = str(tmp_path / "junk.kexp")
    with open(p, "wb") as f:
        f.write(b"definitely not an artifact")
    with pytest.raises(ValueError, match="not a kanodes serving artifact"):
        ServingArtifact.load(p)


def test_spec_roundtrip_all_kinds():
    """spec_of -> model_from_spec rebuilds an equivalent model."""
    from kanodes.deploy.spec import model_from_spec, spec_of
    from kanodes.models import MLP, BSplineKANChain, KANChain

    for model in (
            KANChain.mlp_like([2, 7, 2], grid_len=5, basis="rswaf",
                              normalizer="softsign"),
            MLP((2, 9, 2), activation="tanh"),
            BSplineKANChain([2, 5, 2], grid_size=4)):
        spec = spec_of(model)
        rebuilt = model_from_spec(spec)
        params = model.init(jax.random.PRNGKey(1))
        x = jnp.asarray(np.random.default_rng(0).normal(0, 0.5, (4, 2)),
                        jnp.float32)
        np.testing.assert_allclose(np.asarray(rebuilt.apply(params, x)),
                                   np.asarray(model.apply(params, x)),
                                   rtol=1e-6, atol=1e-7)


def test_checkpoint_to_artifact_cli(tmp_path):
    """Train tiny LV w/ checkpoints -> `python -m kanodes.deploy`
    export -> artifact matches live inference on the checkpointed best
    params (the full train -> checkpoint -> deploy path)."""
    from kanodes.deploy.__main__ import main as deploy_main
    from kanodes.experiments import lv
    from kanodes.train.checkpoint import Checkpointer

    ckdir = str(tmp_path / "ck")
    cfg = lv.LVConfig(iters=30, eval_every=10, solve_mode="fixed")
    lv.run(cfg, checkpoint_dir=ckdir, verbose=False)

    out = str(tmp_path / "lv.kexp")
    rc = deploy_main(["--checkpoint", ckdir, "--kind", "trajectory",
                      "--t1", "3.4", "--nt", "35", "--batch", "any",
                      "--platforms", "cpu", "--out", out])
    assert rc == 0

    st = Checkpointer(ckdir).restore()
    model = lv.make_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, st["best_params"])
    ts = jnp.linspace(0.0, 3.4, 35)
    u0s = jnp.asarray([[1.0, 1.0], [0.8, 1.2]], jnp.float32)

    def rhs(t, u, _):
        return model.apply(params, u)

    want = odeint_fixed(rhs, u0s, ts, substeps=1, solver="tsit5")
    loaded = ServingArtifact.load(out)
    np.testing.assert_allclose(np.asarray(loaded(u0s)), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_cli_requires_spec_when_missing(tmp_path):
    """Old checkpoints without extra['model_spec'] get a clear error."""
    from kanodes.deploy.__main__ import main as deploy_main
    from kanodes.models import KANChain
    from kanodes.train.checkpoint import Checkpointer, TrainState

    model = KANChain.mlp_like([2, 4, 2], grid_len=5)
    params = model.init(jax.random.PRNGKey(0))
    ckdir = str(tmp_path / "old")
    Checkpointer(ckdir).save(TrainState(params=params, step=1))
    rc = deploy_main(["--checkpoint", ckdir, "--kind", "rhs",
                      "--platforms", "cpu",
                      "--out", str(tmp_path / "x.kexp")])
    assert rc == 2


def test_pinn_checkpoint_field_export(tmp_path):
    """A PINN checkpoint (extra['pinn_cfg']) exports as a field artifact
    without an explicit --spec."""
    import dataclasses

    from kanodes.deploy.__main__ import main as deploy_main
    from kanodes.pinn.model import KANPINN
    from kanodes.pinn.train import PINNConfig
    from kanodes.train.checkpoint import Checkpointer, TrainState

    cfg = PINNConfig(widths=(2, 8, 1), n_basis=4, trainable_centers=True)
    model = KANPINN(cfg.widths, cfg.n_basis, cfg.trainable_centers)
    params = model.init(jax.random.PRNGKey(3))
    ckdir = str(tmp_path / "pinnck")
    Checkpointer(ckdir).save(TrainState(
        params=params, step=5,
        extra={"pinn_cfg": dataclasses.asdict(cfg)}))

    out = str(tmp_path / "field.kexp")
    rc = deploy_main(["--checkpoint", ckdir, "--kind", "field",
                      "--params", "last", "--batch", "any",
                      "--platforms", "cpu", "--out", out])
    assert rc == 0
    loaded = ServingArtifact.load(out)
    assert loaded.meta["kind"] == "field"
    xy = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (9, 2)),
                     jnp.float32)
    np.testing.assert_allclose(np.asarray(loaded(xy)),
                               np.asarray(model.apply(params, xy)),
                               rtol=1e-6, atol=1e-7)


def test_trajectory_rejects_non_square_model():
    """A field network (in_dims != out_dims) must not silently
    broadcast inside the integrator."""
    from kanodes.pinn.model import KANPINN

    model = KANPINN(widths=(2, 6, 1), n_basis=4)
    params = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="in_dims == out_dims"):
        export_trajectory(model, params, jnp.linspace(0, 1, 5))


def test_spec_rejects_heterogeneous_and_callable():
    from kanodes.deploy.spec import spec_of
    from kanodes.models import KANChain
    from kanodes.models.core import Chain

    het = Chain(KDense(2, 4, 5), KDense(4, 2, 7))
    het2 = KANChain(*het.layers)
    with pytest.raises(ValueError, match="grid_len"):
        spec_of(het2)

    cal = KANChain(KDense(2, 2, 5, basis=lambda x, g, h: x[..., None] - g))
    with pytest.raises(TypeError, match="callable basis"):
        spec_of(cal)


def test_cli_npy_params_path(tmp_path):
    """--npy + --spec serves the experiment scripts' raw params
    artifacts (no Checkpointer directory needed)."""
    import json as _json

    from kanodes.deploy.__main__ import main as deploy_main
    from kanodes.models import KANChain

    model = KANChain.mlp_like([3, 4, 3], grid_len=5,
                              normalizer="softsign")
    params = model.init(jax.random.PRNGKey(7))
    npy = str(tmp_path / "p.npy")
    arr = np.empty((), dtype=object)
    arr[()] = jax.device_get(params)
    np.save(npy, arr, allow_pickle=True)

    spec = _json.dumps({"kind": "kan", "widths": [3, 4, 3],
                        "grid_len": 5, "normalizer": "softsign"})
    out = str(tmp_path / "m.kexp")
    rc = deploy_main(["--npy", npy, "--spec", spec, "--kind", "rhs",
                      "--batch", "any", "--platforms", "cpu",
                      "--out", out])
    assert rc == 0
    loaded = ServingArtifact.load(out)
    x = jnp.asarray(np.random.default_rng(2).normal(0, 1, (5, 3)),
                    jnp.float32)
    np.testing.assert_allclose(np.asarray(loaded(x)),
                               np.asarray(model.apply(params, x)),
                               rtol=1e-6, atol=1e-7)
    # exactly one of --checkpoint / --npy
    assert deploy_main(["--npy", npy, "--checkpoint", "x",
                        "--out", out]) == 2
    assert deploy_main(["--npy", npy, "--out", out]) == 2
