"""Full PDE surrogates: Burgers, Allen-Cahn, Schrödinger.

Rebuild of `PDE examples/Burgers_Surrogate.jl`, `Allen-Cahn_Surrogate.jl`,
`Schrodinger_Surrogate.jl`: the entire semi-discrete RHS is a 2-layer
KDense chain whose input is the whole grid state ([41,10,41] grid 5 for
Burgers :82-88; [41,10,41] grid 10 for AC :82-87; [402,10,402] grid 10
for Schrödinger :93-96), trained on a handful of trajectory snapshots.

The loss integrates from u0 over the snapshot time grid with fixed-step
Tsit5 (substeps per interval chosen inside each problem's stability
budget) and compares at the snapshot rows only — the reference's
`NeuralODE(..., saveat=dt_train)` protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.models import KANChain
from kanodes.ode import odeint_fixed
from kanodes.pde import datagen
from kanodes.train.loop import TrainConfig, train

Array = jax.Array

# reference snapshot selections (indices into the dt=0.01 save grid)
_SNAPSHOTS = {
    # Burgers_Surrogate.jl:67-73 — t=0 row is u0 itself (included in loss)
    "burgers": dict(idx=[0, 10, 30, 50, 70, 90], include_t0=True,
                    kan_grid=5, hidden=10, iters_ref=20_000),
    # Allen-Cahn_Surrogate.jl:66-71 — t0 excluded
    "allen_cahn": dict(idx=[10, 30, 50, 70, 90], include_t0=False,
                       kan_grid=10, hidden=10, iters_ref=100_000),
    # beyond parity: 2-D Allen-Cahn full-state surrogate ([n^2,H,n^2]
    # chain on flattened 32x32 fields) — 1-D AC snapshot protocol
    "allen_cahn_2d": dict(idx=[10, 30, 50, 70, 90], include_t0=False,
                          kan_grid=10),
    # Schrodinger_Surrogate.jl:72-78 — 8 snapshots, t0 excluded
    "schrodinger": dict(idx=[10, 30, 50, 70, 90, 110, 130, 150],
                        include_t0=False, kan_grid=10, hidden=10,
                        iters_ref=100_000),
}


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    problem: str = "burgers"
    hidden: int = 10
    kan_grid: int | None = None        # None -> reference value
    normalizer: str = "softsign"
    basis: str = "rbf"                 # rbf | iqf | rswaf (all fused)
    lr: float = 1e-2                   # Burgers/AC 1e-2, Schr 1e-3
    iters: int = 2000
    eval_every: int = 500
    substeps: int = 20                 # per snapshot interval
    solve_mode: str = "fixed"          # fixed | shooting
    # xla: `substeps` RK steps per snapshot interval | fused: every
    # interval cut into steps of the shortest one's (the whole-step
    # kernels' uniform grid), through the Triton kernels within
    # `rk_fused.kernel_wins`' widths and XLA beyond them
    impl: str = "xla"
    # fixed-grid stepper. These solves are STABILITY-bound (substeps set
    # by the semi-discrete operator's spectrum, not accuracy), so a
    # tableau with more stability per stage can beat Tsit5: rk4 has
    # ~2.83/4 = 0.71 imaginary-axis units per stage vs Tsit5's ~0.5.
    rk_solver: str = "tsit5"
    # fused-kernel backward dot precision: "highest" (IEEE f32) |
    # "tf32" (TF32 dots in the backward only; the forward, and so the
    # reported loss, stays IEEE f32)
    bwd_precision: str = "highest"
    max_iters_per_call: int | None = None
    seed: int = 0
    # multi-device training: (dp, sp) mesh sizes. sp shards the GRID
    # axis of the state and the KAN chain's grid-facing parameter dims
    # (tensor-parallel contraction, one psum of the hidden vector per
    # RHS eval — see pde/sharded.chain_local_apply); dp shards the
    # shooting-segment batch. None -> single-device path.
    mesh: tuple[int, int] | None = None
    # dataset overrides (used by tiny multi-chip dryruns; None -> the
    # reference protocol values)
    data_dx: float | None = None
    data_substeps: int | None = None
    data_n: int | None = None          # 2-D problems: grid points per side

    def resolved_chunk(self) -> int:
        if self.max_iters_per_call is not None:
            return self.max_iters_per_call
        # bound the length of one device execution; schrodinger
        # iterations are ~100x heavier (402-dim, 100 substeps)
        return 200 if self.problem == "schrodinger" else 5000

    def resolved_lr(self) -> float:
        if self.problem == "schrodinger" and self.lr == 1e-2:
            return 1e-3                # Schrodinger_Surrogate.jl:170
        return self.lr


def make_data(cfg: SurrogateConfig) -> datagen.PDEData:
    gen = {"burgers": datagen.burgers,
           "allen_cahn": datagen.allen_cahn_surrogate,
           "allen_cahn_2d": datagen.allen_cahn_surrogate_2d,
           "schrodinger": datagen.schrodinger}[cfg.problem]
    kw = {}
    if cfg.problem.endswith("_2d"):
        if cfg.data_dx is not None:
            raise ValueError("data_dx is 1-D only; use data_n for 2-D")
        if cfg.data_n is not None:
            kw["n"] = cfg.data_n
    elif cfg.data_dx is not None:
        kw["dx"] = cfg.data_dx
    if cfg.data_substeps is not None:
        kw["substeps"] = cfg.data_substeps
    return gen(**kw)


def make_model(cfg: SurrogateConfig, data: datagen.PDEData) -> KANChain:
    spec = _SNAPSHOTS[cfg.problem]
    n_state = data.X.shape[1]
    grid = cfg.kan_grid or spec["kan_grid"]
    return KANChain.mlp_like([n_state, cfg.hidden, n_state],
                             grid_len=grid, normalizer=cfg.normalizer,
                             basis=cfg.basis)


def make_fns(cfg: SurrogateConfig, model: KANChain,
             data: datagen.PDEData, *, reduce_fn=None):
    """(train_loss, snapshot_loss, predict) closing over the dataset.

    `reduce_fn` maps the squared-error tensor (last axis = state dim) to
    the loss; default scalar mean. Packed ensembles (`models/packed.py`)
    pass `member_mean(S)` to get the [S] per-member loss vector (pair
    with a member-tiled `data.X` and the packed model).
    """
    _reduce = reduce_fn if reduce_fn is not None else jnp.mean
    spec = _SNAPSHOTS[cfg.problem]
    idx = np.asarray(spec["idx"])
    ts_snap = jnp.asarray(data.ts[idx], jnp.float32)
    X_snap = jnp.asarray(data.X[idx], jnp.float32)
    u0 = jnp.asarray(data.X[0], jnp.float32)
    # integration grid: u0 at t=0 plus the snapshot times
    if idx[0] == 0:
        t_grid = ts_snap
    else:
        t_grid = jnp.concatenate([jnp.zeros((1,), jnp.float32), ts_snap])

    def rhs(t, u, params):
        return model.apply(params, u)

    # snapshot intervals are non-uniform (0.1 then 0.2); impl="fused"
    # cuts each into a static number of base_h steps
    t_np = np.asarray(t_grid)
    base_h = float(min(np.diff(t_np))) / cfg.substeps
    interval_steps = [max(int(round((t_np[i + 1] - t_np[i]) / base_h)), 1)
                      for i in range(len(t_np) - 1)]

    # is the whole snapshot trajectory a single uniform-dt step grid?
    # (true for all three reference problems: snapshot spacings are exact
    # multiples of base_h). If so, trajectory mode runs as ONE multistep
    # solve (one kernel launch each way) instead of one per interval.
    uniform = all(abs(n * base_h - float(t_np[i + 1] - t_np[i])) < 1e-9
                  for i, n in enumerate(interval_steps))
    total_steps = int(sum(interval_steps))
    snap_rows = np.cumsum(interval_steps) - 1   # post-step rows of ys

    if cfg.impl not in ("xla", "fused"):
        raise ValueError(f"impl must be 'xla' or 'fused', got {cfg.impl!r}")
    fused = cfg.impl == "fused"
    if fused:
        from kanodes.ops import rk_fused
        from kanodes.ops.kan_chain import chain_spec_of, fused_params
        spec = chain_spec_of(model)
        use_kernel = rk_fused.kernel_wins(spec)

        def advance(params, x, n_steps, dt_total):
            """x [K, N] after n_steps equal steps spanning dt_total."""
            h = dt_total / n_steps
            if not use_kernel:
                ts = jnp.arange(n_steps + 1, dtype=jnp.float32) * h
                return jax.vmap(lambda xi: odeint_fixed(
                    rhs, xi, ts, params, solver=cfg.rk_solver)[-1])(x)
            fp = fused_params(params)

            def body(c, _):
                return rk_fused.fused_rk_step(spec, cfg.rk_solver, h, c,
                                              *fp, cfg.bwd_precision), None

            x, _ = jax.lax.scan(body, x, None, length=n_steps)
            return x

        def uniform_trajectory(params):
            """[total_steps, N] states after each base_h step."""
            if not use_kernel:
                ts = jnp.arange(total_steps + 1, dtype=jnp.float32) * base_h
                return odeint_fixed(rhs, u0, ts, params,
                                    solver=cfg.rk_solver)[1:]
            return rk_fused.fused_rk_multistep(
                spec, cfg.rk_solver, base_h, total_steps, u0[None],
                *fused_params(params), cfg.bwd_precision)[:, 0, :]

    def rhs(t, u, params):
        return model.apply(params, u)

    def predict(params):
        if fused and uniform:
            ys = jnp.concatenate(
                [u0[None], uniform_trajectory(params)[snap_rows]], axis=0)
        elif fused:
            x = u0[None]
            rows = [x]
            for i, n in enumerate(interval_steps):
                x = advance(params, x, n, float(t_np[i + 1] - t_np[i]))
                rows.append(x)
            ys = jnp.concatenate(rows, axis=0)
        else:
            ys = odeint_fixed(rhs, u0, t_grid, params,
                              solver=cfg.rk_solver,
                              substeps=cfg.substeps)
        return ys if idx[0] == 0 else ys[1:]

    def loss_fn(params):
        return _reduce((predict(params) - X_snap) ** 2)

    # segment structure is static: compute on host at closure scope
    ts_snap_np = np.asarray(data.ts[idx], np.float64)
    if idx[0] == 0:
        seg_t0_np = ts_snap_np[:-1]
        seg_t1_np = ts_snap_np[1:]
    else:
        seg_t0_np = np.concatenate([[0.0], ts_snap_np[:-1]])
        seg_t1_np = ts_snap_np
    seg_lens_np = np.round(seg_t1_np - seg_t0_np, 9)

    def shooting_loss(params):
        """Snapshot-to-snapshot shooting: integrate each inter-snapshot
        interval from the data, batched."""
        if idx[0] == 0:
            starts, targets = X_snap[:-1], X_snap[1:]
            seg_ts0, seg_ts1 = ts_snap[:-1], ts_snap[1:]
        else:
            # include the u0 -> first-snapshot segment
            starts = jnp.concatenate([u0[None], X_snap[:-1]], axis=0)
            targets = X_snap
            seg_ts0 = jnp.concatenate([jnp.zeros(1), ts_snap[:-1]])
            seg_ts1 = ts_snap
        if fused:
            # group segments by (static) interval length; each group is
            # one batched solve with its own dt
            preds = jnp.zeros_like(targets)
            for length in sorted(set(seg_lens_np.tolist())):
                sel = np.where(seg_lens_np == length)[0]
                n = max(int(round(length / base_h)), 1)
                x = advance(params, starts[sel], n, float(length))
                preds = preds.at[sel].set(x)
            return _reduce((preds - targets) ** 2)

        def seg(u_s, t0, t1):
            seg_ts = jnp.stack([t0, t1])
            return odeint_fixed(rhs, u_s, seg_ts, params,
                                solver=cfg.rk_solver,
                                substeps=cfg.substeps)[-1]

        preds = jax.vmap(seg)(starts, seg_ts0, seg_ts1)
        return _reduce((preds - targets) ** 2)

    train_loss = shooting_loss if cfg.solve_mode == "shooting" else loss_fn
    return train_loss, loss_fn, predict


def build_mesh(cfg: SurrogateConfig):
    """Build the (dp, sp) device mesh requested by cfg.mesh."""
    from jax.sharding import Mesh
    dp, sp = cfg.mesh
    devs = jax.devices()
    if len(devs) < dp * sp:
        raise ValueError(f"mesh {cfg.mesh} needs {dp * sp} devices, "
                         f"{len(devs)} visible")
    return Mesh(np.asarray(devs[:dp * sp]).reshape(dp, sp), ("dp", "sp"))


def make_sharded_fns(cfg: SurrogateConfig, model: KANChain,
                     data: datagen.PDEData, mesh):
    """Multi-device variants of `make_fns`'s objectives (XLA impl).

    Sharding layout (`pde/sharded.chain_local_apply`):
      sp — the grid axis: state vectors [., N] are sharded into [., N/sp]
           per device; layer-1 params along their input dim, layer-2
           along their output dim. Each RHS eval is a local partial
           contraction + ONE psum of the hidden vector over "sp".
      dp — the shooting-segment batch (padded with masked duplicate rows
           to a multiple of dp when needed).
    Losses equal the single-device objectives up to f32 reduction order
    (asserted by tests/test_pde.py parity tests).
    """
    from jax.sharding import PartitionSpec as P

    from kanodes.pde.sharded import (chain_local_apply,
                                     chain_param_specs)

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    spec = _SNAPSHOTS[cfg.problem]
    idx = np.asarray(spec["idx"])
    ts_snap = jnp.asarray(data.ts[idx], jnp.float32)
    X_snap = jnp.asarray(data.X[idx], jnp.float32)
    u0 = jnp.asarray(data.X[0], jnp.float32)
    N = int(data.X.shape[1])
    if idx[0] == 0:
        t_grid = ts_snap
    else:
        t_grid = jnp.concatenate([jnp.zeros((1,), jnp.float32), ts_snap])
    T = int(X_snap.shape[0])

    local_apply = chain_local_apply(model, sp, "sp")
    p_specs = chain_param_specs(model, "sp")

    def rhs_local(t, u_loc, params):
        return local_apply(params, u_loc)

    shard_map = jax.shard_map

    # ---- trajectory objective (the reference saveat protocol) ----------
    def _local_traj(params, u0_loc, X_loc):
        ys = odeint_fixed(rhs_local, u0_loc, t_grid, params,
                          solver=cfg.rk_solver, substeps=cfg.substeps)
        pred = ys if idx[0] == 0 else ys[1:]
        sq = jnp.sum((pred - X_loc) ** 2)
        # dp rows compute identical (dp-invarying) values; reduce over
        # the grid axis only
        return jax.lax.psum(sq, "sp") / (T * N)

    traj = shard_map(
        _local_traj, mesh=mesh,
        in_specs=(p_specs, P("sp"), P(None, "sp")), out_specs=P())

    def loss_fn(params):
        return traj(params, u0, X_snap)

    # ---- shooting objective (segment batch sharded over dp) ------------
    if idx[0] == 0:
        starts_np = np.asarray(X_snap[:-1])
        targets_np = np.asarray(X_snap[1:])
        ts0_np = np.asarray(ts_snap[:-1])
        ts1_np = np.asarray(ts_snap[1:])
    else:
        starts_np = np.concatenate([np.asarray(u0)[None],
                                    np.asarray(X_snap[:-1])], axis=0)
        targets_np = np.asarray(X_snap)
        ts0_np = np.concatenate([[0.0], np.asarray(ts_snap[:-1])])
        ts1_np = np.asarray(ts_snap)
    S = starts_np.shape[0]
    S_pad = -(-S // dp) * dp
    pad = S_pad - S
    if pad:
        # duplicate row 0, masked out of the mean
        rep = lambda a: np.concatenate([a, np.repeat(a[:1], pad, 0)], 0)
        starts_np, targets_np = rep(starts_np), rep(targets_np)
        ts0_np, ts1_np = rep(ts0_np), rep(ts1_np)
    mask_np = (np.arange(S_pad) < S).astype(np.float32)

    def _local_shoot(params, starts_loc, targets_loc, mask_loc,
                     ts0_loc, ts1_loc):
        def seg(u_s, t0, t1):
            seg_ts = jnp.stack([t0, t1])
            return odeint_fixed(rhs_local, u_s, seg_ts, params,
                                solver=cfg.rk_solver,
                                substeps=cfg.substeps)[-1]

        preds = jax.vmap(seg)(starts_loc, ts0_loc, ts1_loc)
        sq = jnp.sum((preds - targets_loc) ** 2 * mask_loc[:, None])
        return jax.lax.psum(sq, ("dp", "sp")) / (S * N)

    shoot = shard_map(
        _local_shoot, mesh=mesh,
        in_specs=(p_specs, P("dp", "sp"), P("dp", "sp"), P("dp"),
                  P("dp"), P("dp")),
        out_specs=P())

    def shooting_loss(params):
        return shoot(params, jnp.asarray(starts_np), jnp.asarray(targets_np),
                     jnp.asarray(mask_np), jnp.asarray(ts0_np, jnp.float32),
                     jnp.asarray(ts1_np, jnp.float32))

    # ---- full-trajectory prediction (global output) --------------------
    def _local_pred(params, u0_loc):
        ys = odeint_fixed(rhs_local, u0_loc, t_grid, params,
                          solver=cfg.rk_solver, substeps=cfg.substeps)
        return ys if idx[0] == 0 else ys[1:]

    pred_sm = shard_map(_local_pred, mesh=mesh,
                        in_specs=(p_specs, P("sp")),
                        out_specs=P(None, "sp"))

    def predict(params):
        return pred_sm(params, u0)

    train_loss = shooting_loss if cfg.solve_mode == "shooting" else loss_fn
    return train_loss, loss_fn, predict


def run(cfg: SurrogateConfig | None = None, params=None) -> dict[str, Any]:
    cfg = cfg or SurrogateConfig()
    data = make_data(cfg)
    model = make_model(cfg, data)
    if params is None:
        params = model.init(jax.random.PRNGKey(cfg.seed))
    if cfg.mesh is not None:
        from kanodes.pde.sharded import shard_chain_params
        mesh = build_mesh(cfg)
        train_loss, eval_loss, predict = make_sharded_fns(
            cfg, model, data, mesh)
        params = shard_chain_params(mesh, model, params)
    else:
        train_loss, eval_loss, predict = make_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.resolved_lr(), iters=cfg.iters,
                     eval_every=cfg.eval_every,
                     max_iters_per_call=cfg.resolved_chunk())
    out = train(train_loss, params, tc, eval_fn=eval_loss)
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def run_grid_refinement(cfg: SurrogateConfig | None = None, *,
                        refit_points: tuple[int, ...] | None = None,
                        verbose: bool = False) -> dict[str, Any]:
    """Train with the efficient-kan `update_grid` cadence on a KDense
    surrogate chain (VERDICT r2 #8): at each iteration in
    `refit_points` (default: one refit at 10% of the budget), refit the
    shared basis-grid span onto the normalized inputs the current
    trajectory actually visits
    (`sparsify/grid_refine.refine_kdense_chain_grid`, function-
    preserving lstsq over dense per-dim grids) and rebuild the
    jitted/fused objective with the new static grid constants.

    Cadence note (mirrors `efficientkan.py:263-266` usage): refits are
    EARLY-training events. The lstsq refit is a projection between rbf
    spaces on different centers, so it perturbs the learned functions by
    an O(1e-3)-relative floor — applied after convergence that floor
    dominates; applied early it is negligible and the remaining budget
    trains on the better-resolved grid.

    Returns the final run() dict plus `refits` (per-refit span + refit
    error + eval losses before/after).
    """
    cfg = cfg or SurrogateConfig(problem="allen_cahn")
    from kanodes.sparsify.grid_refine import refine_kdense_chain_grid

    if refit_points is None:
        refit_points = (max(cfg.iters // 10, 1),)
    data = make_data(cfg)
    model = make_model(cfg, data)
    params = model.init(jax.random.PRNGKey(cfg.seed))

    bounds = [p for p in sorted(refit_points) if p < cfg.iters]
    blocks = np.diff([0] + bounds + [cfg.iters]).tolist()

    losses, evals, refits = [], [], []
    for bi, iters_b in enumerate(blocks):
        cfg_block = dataclasses.replace(cfg, iters=int(iters_b))
        train_loss, eval_loss, predict = make_fns(cfg_block, model, data)
        tc = TrainConfig(lr=cfg.resolved_lr(), iters=int(iters_b),
                         eval_every=min(cfg.eval_every, int(iters_b)),
                         max_iters_per_call=cfg.resolved_chunk())
        out = train(train_loss, params, tc, eval_fn=eval_loss)
        params = out["params"]
        losses.append(np.asarray(out["loss_history"]))
        evals.append(np.asarray(out["eval_history"]))
        if bi < len(blocks) - 1:
            samples = jnp.asarray(predict(params))
            before = float(eval_loss(params))
            model, params, info = refine_kdense_chain_grid(
                model, params, samples)
            _, eval_new, _ = make_fns(cfg_block, model, data)
            after = float(eval_new(params))
            info.update(eval_before=before, eval_after=after)
            refits.append(info)
            if verbose:
                print(f"[refit @{sum(blocks[:bi + 1])}] lims "
                      f"{info['old_lims']} -> {info['new_lims']}, eval "
                      f"{before:.3e} -> {after:.3e} (refit err "
                      f"{info['relative_refit_error']})", flush=True)

    out.update(cfg=cfg, model=model, data=data,
               refits=refits,
               loss_history=np.concatenate(losses),
               eval_history=np.concatenate(evals))
    return out


if __name__ == "__main__":
    import sys
    import time

    problem = sys.argv[1] if len(sys.argv) > 1 else "burgers"
    cfg = SurrogateConfig(problem=problem)
    t0 = time.time()
    out = run(cfg)
    jax.block_until_ready(out["loss_history"])
    print(f"{problem}: loss {float(out['loss_history'][-1]):.3e} "
          f"best {float(out['best_loss']):.3e} "
          f"({cfg.iters} iters in {time.time() - t0:.1f}s)")
