"""Lotka-Volterra KAN-ODE — the canonical experiment.

Rebuild of `Lotka-Volterra/LV_driver_KANODE.jl` (KAN) and
`LV_driver_MLP.jl` (MLP baseline): a small network is the entire RHS of a
neural ODE fit to predator-prey data.

Reference experimental protocol (kept exactly):
  truth:    dx = alpha x - beta x y ; dy = gamma x y - delta y,
            (alpha,beta,gamma,delta) = (1.5, 1, 1, 3), u0 = (1, 1)
            (LV_driver_KANODE.jl:110-127)
  data:     saveat dt=0.1 over t in (0, 14); train on the first
            floor(141 * 3.5/14) = 35 points, test on the full horizon
  model:    KDense chain [2, 10, 2], grid 5, rbf basis, tanh normalizer
            (:136-142); init = glorot / 1e5 (:179)
  loss:     MSE over the train horizon + optional L1/entropy reg
            (:187-203), Adam(5e-4) (:219), 1e5 iterations
Differences from the reference: the whole training run is one on-device
`lax.scan`; the ODE solve inside the loss is either one fused fixed-grid
Tsit5 step per data interval (default — integration error is far below
model error here and every shape is static) or the adaptive
bounded-scan solver ("adaptive" mode, reference-faithful).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.models import KANChain, MLP
from kanodes.ode import odeint, odeint_fixed
from kanodes.sparsify.regularization import l1_entropy_reg
from kanodes.train.loop import TrainConfig, train
from kanodes.utils.host_rk import rk4_dense

Array = jax.Array

LV_PARAMS = (1.5, 1.0, 1.0, 3.0)


def lv_rhs_truth(t, u, p=LV_PARAMS):
    alpha, beta, gamma, delta = p
    x, y = u[..., 0], u[..., 1]
    return jnp.stack([alpha * x - beta * x * y,
                      gamma * x * y - delta * y], axis=-1)


@dataclasses.dataclass(frozen=True)
class LVConfig:
    # data (reference values, LV_driver_KANODE.jl:110-127)
    tspan: tuple[float, float] = (0.0, 14.0)
    train_tmax: float = 3.5
    dt: float = 0.1
    u0: tuple[float, float] = (1.0, 1.0)
    # model
    model: str = "kan"                 # kan | mlp | bspline_kan
    layer_width: int = 10
    # full width list for deep KAN chains (overrides layer_width when
    # set; e.g. (2, 5, 5, 2) is the depth-3 analogue of the reference's
    # two-hidden-layer "d=3" MLP trend rows, trend_plotter.py:13-14)
    kan_widths: tuple[int, ...] | None = None
    grid_size: int = 5
    basis: str = "rbf"
    normalizer: str = "tanh"
    mlp_widths: tuple[int, ...] = (2, 50, 2)
    init_scale: float = 1e-5           # glorot/1e5, :179
    # training
    lr: float = 5e-4
    iters: int = 10_000
    eval_every: int = 100
    sparse_on: bool = False
    act_reg: float = 5e-4              # reg_loss(p, 5e-4, 0), :199-201
    entropy_reg: float = 0.0
    # solver
    solve_mode: str = "fixed"          # fixed | adaptive | shooting
    substeps: int = 1                  # fixed-mode Tsit5 steps per interval
    segment_len: int = 1               # shooting-mode intervals per segment
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 256
    # adaptive-mode differentiation strategy: direct | direct_remat |
    # interpolating | backsolve (ode/integrate.odeint adjoints)
    adjoint: str = "direct"
    # xla: plain jnp RHS | fused: whole-RK-step Triton kernels
    # (ops/rk_fused) for the fixed and shooting modes of a 2-layer KAN
    # within `rk_fused.kernel_wins`' widths, XLA beyond them; the
    # adaptive mode always runs the XLA controller (ode.odeint)
    impl: str = "xla"
    # fused-kernel backward dot precision: "highest" (IEEE f32) |
    # "tf32" (TF32 dots in the backward only; forward stays IEEE f32)
    bwd_precision: str = "highest"
    seed: int = 0
    # upper bound on iterations per device execution (the host re-
    # dispatches the compiled chunk; lower it for slow modes like
    # adaptive)
    max_iters_per_call: int = 10_000
    # record a bounded parameter-history ring (one snapshot per eval
    # point) for post-hoc model selection, reference p_list parity
    record_history: bool = False


def make_data(cfg: LVConfig):
    """Host float64 truth trajectory, split into train/test cuts."""
    ts = np.arange(0.0, cfg.tspan[1] + cfg.dt / 2, cfg.dt)

    def f(t, u):
        a, b, g, d = LV_PARAMS
        x, y = u
        return np.array([a * x - b * x * y, g * x * y - d * y])

    X = rk4_dense(f, np.asarray(cfg.u0), ts, substeps=50)
    n_train = int(np.floor(len(ts) * cfg.train_tmax / cfg.tspan[1]))
    return {
        "ts": jnp.asarray(ts, jnp.float32),
        "X": jnp.asarray(X, jnp.float32),          # [T, 2]
        "n_train": n_train,
    }


def make_model(cfg: LVConfig):
    if cfg.model == "kan":
        widths = (list(cfg.kan_widths) if cfg.kan_widths is not None
                  else [2, cfg.layer_width, 2])
        return KANChain.mlp_like(widths,
                                 grid_len=cfg.grid_size, basis=cfg.basis,
                                 normalizer=cfg.normalizer)
    if cfg.model == "mlp":
        return MLP(cfg.mlp_widths)
    if cfg.model == "bspline_kan":
        # the PyTorch-flavor LV model: efficient-kan B-spline chain
        # ([2,10,2] grid 5, predator_prey.py:101)
        from kanodes.models.bspline import BSplineKANChain
        return BSplineKANChain([2, cfg.layer_width, 2],
                               grid_size=cfg.grid_size)
    raise ValueError(cfg.model)


def init_params(cfg: LVConfig, model, key=None):
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    params = model.init(key)
    # near-zero start (reference: p = glorot/1e5, LV_driver_KANODE.jl:179).
    # The B-spline chain's knot "grid" entries are coordinate state, not
    # weights — scaling them collapses the knot span and kills every
    # basis gradient, so they are exempt.
    if cfg.model == "bspline_kan":
        return [{k: (v if k == "grid" else v * cfg.init_scale)
                 for k, v in p.items()} for p in params]
    return jax.tree_util.tree_map(lambda x: x * cfg.init_scale, params)


def make_ode_fns(cfg: LVConfig, model, data, *, reduce_fn=None,
                 n_members: int | None = None):
    """(loss_fn, eval_fn, predict_fn) closing over the dataset.

    `reduce_fn` maps the squared-error tensor (last axis = state dim) to
    the loss value; default is the scalar mean. Packed ensembles
    (`models/packed.py`) pass a per-member mean so the loss is the [S]
    vector `train()`'s multi-seed mode expects.

    `n_members` declares the packed-ensemble member count; adaptive
    solve modes REQUIRE it with a `reduce_fn` — the solve then routes
    through one independent step controller per member
    (`ode.odeint_members`, the reference-faithful protocol applied
    member-wise). With `n_members=None`, adaptive + reduce_fn raises:
    the single shared controller would silently couple the members
    through dt.
    """
    _reduce = reduce_fn if reduce_fn is not None else jnp.mean
    if reduce_fn is not None and cfg.sparse_on:
        raise ValueError("sparse_on adds a scalar regularizer; it does "
                         "not compose with a vector reduce_fn")
    if (reduce_fn is not None and cfg.solve_mode == "adaptive"
            and n_members is None):
        raise ValueError(
            "adaptive solve with a vector reduce_fn needs n_members= "
            "(per-member step control via odeint_members); a shared "
            "controller would couple the ensemble members through dt")
    ts, X, n_train = data["ts"], data["X"], data["n_train"]
    ts_train = ts[:n_train]
    u0 = X[0]

    if cfg.impl not in ("xla", "fused"):
        raise ValueError(f"impl must be 'xla' or 'fused', got {cfg.impl!r}")
    use_fused = False
    if cfg.impl == "fused" and cfg.model == "kan":
        from kanodes.ops import rk_fused
        from kanodes.ops.kan_chain import chain_spec_of, fused_params
        spec = chain_spec_of(model)
        use_fused = rk_fused.kernel_wins(spec)
        h = cfg.dt / cfg.substeps

        def fused_interval(params, x):
            """Advance a batch of states one save interval (one kernel
            per substep)."""
            fp = fused_params(params)
            for _ in range(cfg.substeps):
                x = rk_fused.fused_rk_step(spec, "tsit5", h, x, *fp,
                                           cfg.bwd_precision)
            return x

    def rhs(t, u, params):
        return model.apply(params, u)

    def predict(params, t_grid):
        if cfg.solve_mode == "adaptive":
            # save-point clipping floors the iteration count at one
            # accepted step per save time, so the bounded scan must grow
            # with the grid (the train grid uses cfg.max_steps as-is)
            ms = max(cfg.max_steps, 2 * int(t_grid.shape[0]))
            if n_members is not None:
                # packed ensemble, one controller per member; packed
                # callers pass pre-tiled data, so u0 is [S*d]
                from kanodes.ode import odeint_members
                return odeint_members(rhs, u0, t_grid, params,
                                      n_members=n_members, solver="tsit5",
                                      rtol=cfg.rtol, atol=cfg.atol,
                                      max_steps=ms)
            return odeint(rhs, u0, t_grid, params, solver="tsit5",
                          rtol=cfg.rtol, atol=cfg.atol,
                          max_steps=ms, adjoint=cfg.adjoint)
        if use_fused:
            n_steps = (t_grid.shape[0] - 1) * cfg.substeps
            # whole solve in ONE kernel launch (+1 for its backward)
            ys = rk_fused.fused_rk_multistep(spec, "tsit5", h, n_steps,
                                             u0[None], *fused_params(params),
                                             cfg.bwd_precision)
            ys = jnp.concatenate([u0[None, None], ys], axis=0)
            if cfg.substeps != 1:
                ys = ys[::cfg.substeps]
            return ys[:, 0, :]
        return odeint_fixed(rhs, u0, t_grid, params,
                            solver="tsit5", substeps=cfg.substeps)

    def trajectory_loss(params):
        pred = predict(params, ts_train)
        return _reduce((pred - X[:n_train]) ** 2)

    def shooting_loss(params):
        """Multiple-shooting objective.

        The reference backprops through one long sequential solve
        (35 chained RK steps, LV_driver_KANODE.jl:180-184); on an
        accelerator that chain is launch-latency-bound. Multiple
        shooting integrates short segments from *every* data point in
        parallel (vmap over segments -> one batched RK step chain of
        length `segment_len`),
        matching each segment end against the data. Same fixed point
        (the true RHS zeroes both losses), ~n_train x less sequential
        depth per iteration.
        """
        L = cfg.segment_len
        Xtr = X[:n_train]
        starts = Xtr[:-L]                            # [S, 2]
        seg_ts = jnp.arange(L + 1, dtype=jnp.float32) * cfg.dt
        # targets[s] = X[s+1 : s+L+1]
        idx = jnp.arange(starts.shape[0])[:, None] + jnp.arange(1, L + 1)
        targets = Xtr[idx]                           # [S, L, 2]

        if use_fused:
            # the segment batch IS the kernel batch dim — no vmap needed
            x = starts
            preds = []
            for _ in range(L):
                x = fused_interval(params, x)
                preds.append(x)
            preds = jnp.stack(preds, axis=1)         # [S, L, 2]
        else:
            def seg(u0_s):
                ys = odeint_fixed(rhs, u0_s, seg_ts, params,
                                  solver="tsit5", substeps=cfg.substeps)
                return ys[1:]                        # [L, 2]

            preds = jax.vmap(seg)(starts)
        return _reduce((preds - targets) ** 2)

    def loss_fn(params):
        if cfg.solve_mode == "shooting":
            loss = shooting_loss(params)
        else:
            loss = trajectory_loss(params)
        if cfg.sparse_on:
            loss = loss + l1_entropy_reg(params, cfg.act_reg,
                                         cfg.entropy_reg)
        return loss

    def eval_fn(params):
        pred = predict(params, ts)
        return _reduce((pred - X) ** 2)

    return loss_fn, eval_fn, predict


def run(cfg: LVConfig | None = None, params=None, *,
        checkpoint_dir: str | None = None, restart: bool = False,
        prune_threshold: float | None = None,
        verbose: bool = False) -> dict[str, Any]:
    """Train an LV neural ODE end to end; returns params + histories.

    Restart/prune parity with the reference driver's `is_restart` /
    `is_prune` flow (`LV_driver_KANODE.jl:18-25,146-170`): `restart`
    loads the latest checkpoint from `checkpoint_dir`; `prune_threshold`
    prunes weak hidden nodes before (re)training, rebuilding a narrower
    chain (the new width is reflected in the returned model).
    """
    cfg = cfg or LVConfig()
    data = make_data(cfg)
    model = make_model(cfg)

    # restart parity with LV_driver_KANODE.jl:146-160: reload params AND
    # the loss/test histories so the continued run extends them
    ckptr = None
    prev_loss = np.zeros((0,), np.float32)
    prev_eval = np.zeros((0,), np.float32)
    prev_step = 0
    if checkpoint_dir is not None:
        from kanodes.train.checkpoint import Checkpointer, TrainState
        ckptr = Checkpointer(checkpoint_dir)
        if restart and ckptr.latest_step() is not None:
            st = ckptr.restore()
            params = jax.tree_util.tree_map(jnp.asarray, st["params"])
            prev_step = int(st.get("step", 0))
            if st.get("loss_history") is not None:
                prev_loss = np.asarray(st["loss_history"], np.float32)
            if st.get("eval_history") is not None:
                prev_eval = np.asarray(st["eval_history"], np.float32)

    if params is None:
        params = init_params(cfg, model)

    if prune_threshold is not None:
        from kanodes.sparsify.prune import prune as _prune
        res = _prune(model, params, data["X"][:data["n_train"]],
                     threshold=prune_threshold)
        model = res.chain
        params = res.params
        cfg = dataclasses.replace(cfg,
                                  layer_width=model.layers[0].out_dims)

    loss_fn, eval_fn, predict = make_ode_fns(cfg, model, data)
    tc = TrainConfig(lr=cfg.lr, iters=cfg.iters, eval_every=cfg.eval_every,
                     max_iters_per_call=cfg.max_iters_per_call)

    on_chunk = None
    if ckptr is not None:
        from kanodes.train.checkpoint import TrainState

        from kanodes.deploy.spec import spec_of
        model_spec = spec_of(model)

        def on_chunk(i, st):
            step = prev_step + len(st["loss_history"])
            ckptr.save(TrainState(
                params=st["params"],
                step=step,
                best_params=st["best_params"],
                best_loss=float(st["best_loss"]),
                loss_history=np.concatenate(
                    [prev_loss, np.asarray(st["loss_history"])]),
                eval_history=np.concatenate(
                    [prev_eval, np.asarray(st["eval_history"])]),
                # model spec rides along so post-hoc tools (deploy CLI,
                # gates) can rebuild the network without the driver's
                # constants — the reference's `size_KAN`-in-.mat pattern
                # (LV_driver_KANODE.jl:252-272).
                extra={"model_spec": model_spec}))
            if verbose:
                print(f"[lv] step {step}  train "
                      f"{float(st['loss_history'][-1]):.3e}  best "
                      f"{float(st['best_loss']):.3e}  test "
                      f"{float(st['eval_history'][-1]):.3e}", flush=True)

    out = train(loss_fn, params, tc, eval_fn=eval_fn,
                record_history=cfg.record_history, on_chunk=on_chunk)
    out["loss_history"] = jnp.concatenate(
        [jnp.asarray(prev_loss), out["loss_history"]])
    out["eval_history"] = jnp.concatenate(
        [jnp.asarray(prev_eval), out["eval_history"]])
    out.update(cfg=cfg, model=model, data=data, predict=predict)
    return out


def run_grid_refinement(cfg: LVConfig | None = None, *,
                        update_every: int = 500,
                        verbose: bool = False) -> dict[str, Any]:
    """efficient-kan `update_grid` cadence for the B-spline LV model:
    train a block of iterations, refit every layer's knot grid to the
    quantiles of its CURRENT inputs along the predicted train trajectory
    (function-preserving lstsq refit), continue training — the reference
    train loop's `model(x, update_grid=True)` rhythm
    (`Lotka-Volterra-Pytorch/efficient_kan/efficientkan.py:263-266`).

    Returns the usual run() dict plus `refits`: per-refit
    (loss_before, loss_after) pairs — `loss_after ~ loss_before`
    verifies the refit preserved the learned function while moving the
    knots onto the data distribution.
    """
    cfg = cfg or LVConfig(model="bspline_kan", iters=3000, lr=2e-3,
                          init_scale=1.0)
    if cfg.model != "bspline_kan":
        raise ValueError("grid refinement applies to the B-spline chain")
    data = make_data(cfg)
    model = make_model(cfg)
    params = init_params(cfg, model)
    loss_fn, eval_fn, predict = make_ode_fns(cfg, model, data)

    n_blocks = max(cfg.iters // update_every, 1)
    losses, evals, refits = [], [], []
    best_loss, best_params = np.inf, params
    for b in range(n_blocks):
        out = train(loss_fn, params,
                    TrainConfig(lr=cfg.lr, iters=update_every,
                                eval_every=min(cfg.eval_every,
                                               update_every),
                                max_iters_per_call=cfg.max_iters_per_call),
                    eval_fn=eval_fn)
        params = out["params"]
        losses.append(np.asarray(out["loss_history"]))
        evals.append(np.asarray(out["eval_history"]))
        if float(out["best_loss"]) < best_loss:
            best_loss = float(out["best_loss"])
            best_params = out["best_params"]
        if b < n_blocks - 1:
            # knots -> quantiles of the states the RHS actually sees
            xs = predict(params, data["ts"][:data["n_train"]])
            pre = float(loss_fn(params))
            params = model.update_grids(params, xs)
            post = float(loss_fn(params))
            refits.append((pre, post))
            if verbose:
                print(f"[lv-grid] block {b}: refit loss {pre:.3e} -> "
                      f"{post:.3e}", flush=True)
    return {"params": params, "best_params": best_params,
            "best_loss": best_loss,
            "loss_history": jnp.asarray(np.concatenate(losses)),
            "eval_history": jnp.asarray(np.concatenate(evals)),
            "refits": refits, "cfg": cfg, "model": model, "data": data,
            "predict": predict}


if __name__ == "__main__":
    import sys
    import time

    from kanodes.train.config import override_from_args, \
        override_from_env

    cfg = LVConfig(iters=10_000)
    cfg = override_from_env(cfg, "KANODE_LV_")
    cfg = override_from_args(cfg, sys.argv[1:])
    t0 = time.time()
    out = run(cfg,
              checkpoint_dir=("checkpoints/lv"
                              if "--checkpoint" in sys.argv else None),
              restart="--restart" in sys.argv)
    jax.block_until_ready(out["loss_history"])
    dt = time.time() - t0
    print(f"train loss {float(out['loss_history'][-1]):.3e}  "
          f"best {float(out['best_loss']):.3e}  "
          f"test {float(out['eval_history'][-1]):.3e}  "
          f"({cfg.iters} iters in {dt:.1f}s, "
          f"{cfg.iters / dt:.0f} it/s)")
