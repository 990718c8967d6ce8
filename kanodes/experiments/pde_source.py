"""Hidden-physics source-term recovery: Fisher-KPP and Allen-Cahn.

Rebuild of `PDE examples/Fisher-KPP_Source.jl` and `Allen-Cahn_Source.jl`:
a known diffusion operator plus a pointwise 1->1 KAN as the unknown
reaction term,
    du/dt = D * lap_cyclic @ u + kan.(u)        (rc_kanode, :95-98)
trained on snapshots of the true dynamics, then symbolic regression on
the learned scalar function recovers the reaction law (:216-234).

Here the pointwise broadcast becomes one batched basis-expansion GEMM
over all grid nodes; the Laplacian stays a dense [N,N] matmul as in the
reference; the whole training loop is the shared on-device scan.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.models import KDense
from kanodes.ode import odeint_fixed
from kanodes.pde import datagen
from kanodes.train.loop import TrainConfig, train
from kanodes.utils.precision import matmul_precision

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    problem: str = "fisher_kpp"        # fisher_kpp | allen_cahn
    # beyond parity: 2-D problems on periodic square grids (the
    # reference is 1-D only; the gray-box structure is dimension-
    # agnostic). ndim=2 supports both problems: XLA path = roll-based
    # 2-D Laplacian; impl="fused" = Kronecker-FACTORED kernel
    # (L@U + U@L per stage); `sp>1` shards the field's row axis with
    # ghost-ROW halo exchange (XLA path).
    ndim: int = 1
    grid_n: int | None = None          # 2-D grid points per side
    kan_grid: int = 10                 # KANgrid=10 (:82-86)
    normalizer: str = "softsign"       # (:81)
    lr: float = 1e-2                   # Adam 1e-2 (:167-170)
    iters: int = 2000                  # reference: 2e4 (fkpp) / 5e4 (AC)
    eval_every: int = 500
    substeps: int | None = None        # None -> per-problem default
    max_iters_per_call: int | None = None
    impl: str = "xla"                  # xla | fused (whole-RK-step kernel)
    # fused-kernel backward dot precision: "highest" | "tf32" (TF32
    # dots in the backward only)
    bwd_precision: str = "highest"
    seed: int = 0
    # multi-device: shard the spatial grid over `sp` devices. The known
    # diffusion operator becomes the shard_map halo-exchange stencil of
    # `pde/sharded.sharded_graybox_rhs` (periodic ring via ppermute) and
    # the pointwise 1->1 KAN stays fully local; only the 2-cell halo
    # crosses between devices per RK stage. XLA impl only; grid size
    # must divide.
    sp: int = 1
    # dataset overrides (tiny multi-chip dryruns; None -> reference values)
    data_dx: float | None = None
    data_substeps: int | None = None

    def resolved_substeps(self) -> int:
        if self.substeps is not None:
            return self.substeps
        if self.ndim == 2:
            # fisher: lambda = 8*D/dx^2 (5-point stencil) = 81.9 at
            # n=32; tsit5 real-axis bound ~3.3 -> dt <= 0.04 -> 16/0.5.
            # AC: tiny diffusion + dt=0.01 saves -> 1-D default carries
            return 16 if self.problem == "fisher_kpp" else 2
        # fkpp saves every dt=0.5 with diffusion lambda ~25 -> h=0.0625;
        # AC saves every dt=0.01 with lambda ~15 -> one step is plenty
        return 8 if self.problem == "fisher_kpp" else 2

    def resolved_chunk(self) -> int:
        if self.max_iters_per_call is not None:
            return self.max_iters_per_call
        if self.ndim == 2:
            return 2_000 if self.problem == "fisher_kpp" else 1_000
        # bound the length of one device execution: AC integrates 101
        # save points/loss vs fkpp's 11
        return 10_000 if self.problem == "fisher_kpp" else 1_000


def make_data(cfg: SourceConfig) -> datagen.PDEData:
    kw = {}
    if cfg.data_substeps is not None:
        kw["substeps"] = cfg.data_substeps
    if cfg.ndim == 2:
        if cfg.data_dx is not None:
            raise ValueError("data_dx is 1-D only; use grid_n for ndim=2")
        if cfg.grid_n is not None:
            kw["n"] = cfg.grid_n
        if cfg.problem == "fisher_kpp":
            return datagen.fisher_kpp_2d(**kw)
        if cfg.problem == "allen_cahn":
            return datagen.allen_cahn_source_2d(**kw)
        raise ValueError(cfg.problem)
    if cfg.data_dx is not None:
        kw["dx"] = cfg.data_dx
    if cfg.problem == "fisher_kpp":
        return datagen.fisher_kpp(**kw)
    if cfg.problem == "allen_cahn":
        return datagen.allen_cahn_source(**kw)
    raise ValueError(cfg.problem)


def truth_reaction(cfg: SourceConfig):
    if cfg.problem == "fisher_kpp":
        return lambda u: u * (1 - u)
    return lambda u: 5.0 * u - 5.0 * u ** 3


def make_model(cfg: SourceConfig) -> KDense:
    return KDense(1, 1, cfg.kan_grid, normalizer=cfg.normalizer)


def make_fns(cfg: SourceConfig, model: KDense, data: datagen.PDEData):
    if cfg.impl not in ("xla", "fused"):
        raise ValueError(f"impl must be 'xla' or 'fused', got {cfg.impl!r}")
    if cfg.ndim == 2:
        return _make_fns_2d(cfg, model, data)
    lap = jnp.asarray(datagen._cyclic_lap(len(data.x), data.dx), jnp.float32)
    D = data.meta["D"] if cfg.problem == "fisher_kpp" else data.meta["D"]
    X = jnp.asarray(data.X, jnp.float32)
    ts = jnp.asarray(data.ts, jnp.float32)
    u0 = X[0]

    def rhs(t, u, params):
        known = D * jnp.matmul(lap, u, precision=matmul_precision())
        learned = model.apply(params, u[:, None])[:, 0]
        return known + learned

    if cfg.sp > 1:
        if cfg.impl == "fused":
            raise ValueError("sharded mode uses the XLA path "
                             "(impl='xla'); fused kernels are per-device")
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from kanodes.pde.sharded import sharded_graybox_rhs
        n = len(data.x)
        if n % cfg.sp:
            raise ValueError(f"grid size {n} not divisible by sp={cfg.sp}"
                             " (override data_dx to adjust)")
        devs = jax.devices()
        if len(devs) < cfg.sp:
            raise ValueError(f"sp={cfg.sp} needs {cfg.sp} devices, "
                             f"{len(devs)} visible")
        mesh = Mesh(np.asarray(devs[:cfg.sp]), ("sp",))
        rhs_sh = sharded_graybox_rhs(mesh, float(data.dx), float(D),
                                     model, axis="sp")
        u0_sh = jax.device_put(u0, NamedSharding(mesh, P("sp")))

        def predict(params):
            return odeint_fixed(rhs_sh, u0_sh, ts, params, solver="tsit5",
                                substeps=cfg.resolved_substeps())
    elif cfg.impl == "fused":
        from kanodes.ops.graybox_fused import graybox_kernel_adapter
        _, _advance = graybox_kernel_adapter(model, lap, float(D),
                                             cfg.bwd_precision)
        sub = cfg.resolved_substeps()
        dt_save = float(data.ts[1] - data.ts[0])

        def predict(params):
            n_steps = (ts.shape[0] - 1) * sub
            return _advance(params, u0, dt_save / sub, n_steps)[::sub]
    else:
        def predict(params):
            return odeint_fixed(rhs, u0, ts, params, solver="tsit5",
                                substeps=cfg.resolved_substeps())

    def loss_fn(params):
        return jnp.mean((predict(params) - X) ** 2)

    return loss_fn, loss_fn, predict


def _make_fns_2d(cfg: SourceConfig, model: KDense, data: datagen.PDEData):
    """2-D gray-box objective: du/dt = D*lap2d(u) + kan.(u), u [n, n].

    Beyond parity (the reference source experiments are 1-D). XLA path:
    the pointwise KAN is ONE [n*n, 1] basis-expansion GEMM per stage and
    the 5-point stencil fuses into it; with `sp>1` the row axis shards
    over the mesh via ghost-row halo exchange
    (`pde/sharded.sharded_graybox_rhs_2d`)."""
    from kanodes.pde.operators import laplacian_periodic_2d

    D = float(data.meta["D"])
    dx = float(data.dx)
    X = jnp.asarray(data.X, jnp.float32)
    ts = jnp.asarray(data.ts, jnp.float32)
    u0 = X[0]
    n = u0.shape[0]

    if cfg.impl == "fused":
        if cfg.sp > 1:
            raise ValueError("sharded 2-D mode uses the XLA path "
                             "(impl='xla'); fused kernels are per-device")
        # the 2-D periodic Laplacian is the Kronecker sum L(+)L; the
        # fused kernel applies it FACTORED as L@U + U@L (two [n, n]
        # dots per stage) instead of the flattened [n^2, n^2] form
        from kanodes.ops.graybox_fused import \
            graybox_kron_kernel_adapter
        lap1 = datagen._cyclic_lap(n, dx)
        _, _advance = graybox_kron_kernel_adapter(model, lap1, D,
                                                  cfg.bwd_precision)
        sub = cfg.resolved_substeps()
        dt_save = float(data.ts[1] - data.ts[0])

        def predict(params):
            n_steps = (ts.shape[0] - 1) * sub
            return _advance(params, u0, dt_save / sub, n_steps)[::sub]

        def loss_fn(params):
            return jnp.mean((predict(params) - X) ** 2)

        return loss_fn, loss_fn, predict

    if cfg.sp > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from kanodes.pde.sharded import sharded_graybox_rhs_2d
        if n % cfg.sp:
            raise ValueError(f"rows {n} not divisible by sp={cfg.sp}")
        devs = jax.devices()
        if len(devs) < cfg.sp:
            raise ValueError(f"sp={cfg.sp} needs {cfg.sp} devices, "
                             f"{len(devs)} visible")
        mesh = Mesh(np.asarray(devs[:cfg.sp]), ("sp",))
        rhs = sharded_graybox_rhs_2d(mesh, dx, D, model, axis="sp")
        u0_run = jax.device_put(u0, NamedSharding(mesh, P("sp", None)))
    else:
        u0_run = u0

        def rhs(t, u, params):
            known = D * laplacian_periodic_2d(u, dx)
            learned = model.apply(params, u.reshape(-1, 1)).reshape(u.shape)
            return known + learned

    def predict(params):
        return odeint_fixed(rhs, u0_run, ts, params, solver="tsit5",
                            substeps=cfg.resolved_substeps())

    def loss_fn(params):
        return jnp.mean((predict(params) - X) ** 2)

    return loss_fn, loss_fn, predict


def run(cfg: SourceConfig | None = None, params=None) -> dict[str, Any]:
    cfg = cfg or SourceConfig()
    data = make_data(cfg)
    model = make_model(cfg)
    if params is None:
        params = model.init(jax.random.PRNGKey(cfg.seed))
    loss_fn, eval_fn, predict = make_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.lr, iters=cfg.iters, eval_every=cfg.eval_every,
                     max_iters_per_call=cfg.resolved_chunk())
    out = train(loss_fn, params, tc)
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def recover_source(out: dict, generations: int = 250,
                   seed: int = 0,
                   ops: tuple = ("+", "-", "*"),
                   method: str = "gp") -> dict:
    """SR post-pass on the trained 1->1 KAN over the state range — the
    reference's SRRegressor step (`Fisher-KPP_Source.jl:216-234`,
    recovered 0.9953*x*(1.0024-x)). method="sindy" swaps the GP search
    for the closed-form STLSQ engine (`symbolic/sindy.py`) — exact
    least-squares coefficients in milliseconds for polynomial laws."""
    from kanodes.symbolic.fit import fit_scalar_function, \
        simplify_expression

    model, params = out["model"], out["best_params"]
    X = np.asarray(out["data"].X)
    lo, hi = float(X.min()), float(X.max())

    def learned(u):
        u = jnp.asarray(u, jnp.float32)
        return np.asarray(model.apply(params, u[:, None])[:, 0])

    if method == "sindy":
        from kanodes.symbolic.sindy import fit_sindy
        u = np.linspace(lo, hi, 400)[:, None]
        fit = fit_sindy(u, learned(u[:, 0]), degree=4, threshold="auto")[0]
        return {"fit": fit, "pretty": simplify_expression(fit.expression),
                "range": (lo, hi)}

    # polynomial-only ops by default: the reference's source laws are
    # polynomial and '/' invites rational overfits of KAN approx error
    fit = fit_scalar_function(learned, lo, hi, generations=generations,
                              seed=seed, ops=ops)
    return {"fit": fit, "pretty": simplify_expression(fit.expression),
            "range": (lo, hi)}


def recover_source_from_data(data: datagen.PDEData, *, ndim: int = 1,
                             degree: int = 4, **kw) -> dict:
    """NO-TRAINING source recovery straight from the snapshots:
    estimate du/dt by 4th-order central differences on the save grid,
    subtract the KNOWN diffusion term, and SINDy-fit the pointwise
    residual against the state (beyond parity — the reference's only
    route is minutes of KAN training + GP; for polynomial laws the
    data identifies the law directly in milliseconds).

    Works when snapshots are saved densely enough for the FD stencil
    (Allen-Cahn's dt=0.01 grid easily; Fisher-KPP's 11 coarse saves
    only approximately). Returns the same dict shape as
    `recover_source`."""
    from kanodes.symbolic.fit import simplify_expression
    from kanodes.symbolic.sindy import fit_sindy

    ts = np.asarray(data.ts, np.float64)
    X = np.asarray(data.X, np.float64)
    h = float(np.diff(ts).mean())
    dXdt = (-X[4:] + 8.0 * X[3:-1] - 8.0 * X[1:-3] + X[:-4]) / (12.0 * h)
    Xi = X[2:-2]
    D = float(data.meta["D"])
    if ndim == 2:
        known = D * np.stack([datagen._lap2d_periodic_np(u, data.dx)
                              for u in Xi])
    else:
        lap = datagen._cyclic_lap(X.shape[1], data.dx)
        known = D * (Xi @ lap.T)
    resid = (dXdt - known).reshape(-1)
    u = Xi.reshape(-1, 1)
    kw.setdefault("gamma", 1.0)      # FD truncation error, as in
    fit = fit_sindy(u, resid, degree=degree, **kw)[0]  # fit_sindy_trajectory
    return {"fit": fit, "pretty": simplify_expression(fit.expression),
            "range": (float(u.min()), float(u.max()))}


if __name__ == "__main__":
    import time

    # CLI defaults = the reference's full training budgets
    # (Fisher-KPP_Source.jl:170 2e4 iters; Allen-Cahn_Source.jl:164 5e4)
    # on the fused gray-box kernel
    budgets = {"fisher_kpp": 20_000, "allen_cahn": 50_000}
    for problem, iters in budgets.items():
        cfg = SourceConfig(problem=problem, iters=iters,
                           eval_every=5000, impl="fused")
        t0 = time.time()
        out = run(cfg)
        jax.block_until_ready(out["loss_history"])
        rec = recover_source(out)
        print(f"{problem}: loss {float(out['best_loss']):.3e} "
              f"({time.time() - t0:.1f}s) recovered: {rec['pretty']}")
