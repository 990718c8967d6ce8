"""Parameter-efficiency sweep (the paper's Fig. 3C / section A2 study).

The reference produced its KAN-vs-MLP loss-vs-size trend by hand-editing
`layer_width`/`grid_size` and re-running the LV driver for 1e5 CPU
iterations per point, then hardcoding the converged losses into
`trend_plotter.py:7-14`. Here the whole sweep is one function:

  * different network SIZES train sequentially (shapes differ, so no
    vmap), each with the fast fused-kernel shooting curriculum — a few
    seconds per point instead of CPU-hours;
  * same-shape ENSEMBLES (seed / learning-rate grids) train as one
    vmapped, mesh-sharded program (`parallel/sharding.py`) — the
    capability SURVEY.md §2.9 calls out as the DP upgrade.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import jax
import numpy as np
import optax
from jax import lax

from kanodes.experiments import lv as lv_mod

# the reference's published sweep points (trend_plotter.py:7-14).
# "d" in trend_plotter's labels is network DEPTH, not species count:
# the d=2 sizes are one-hidden-layer [2,h,2] MLPs (52/252/502 params at
# h=10/50/100) and the d=3 sizes are two-hidden-layer [2,h,h,2] MLPs —
# h^2+6h+2 gives exactly 29/57/114/162/522 at h=3/5/8/10/20.
REFERENCE_KAN_TREND = {64: 1.4e-4, 80: 5.2e-5, 96: 1.2e-4, 120: 1.9e-5,
                       144: 1.6e-5, 240: 8.3e-7, 480: 6.6e-7, 960: 6.1e-7}
REFERENCE_MLP_TREND = {52: 4.7e-4, 252: 4.14e-5, 502: 1.6e-5}
REFERENCE_MLP3_TREND = {29: 2.0e-4, 57: 2.6e-4, 114: 3.6e-5,
                        162: 3.7e-5, 522: 2.96e-5}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    model: str                  # kan | mlp
    layer_width: int = 10
    grid_size: int = 5
    mlp_hidden: int = 50
    mlp_depth: int = 2          # trend_plotter's "d": hidden layers + 1
    kan_depth: int = 2          # 3 = two-hidden-layer [2,w,w,2] KDense chain

    def mlp_widths(self) -> tuple[int, ...]:
        return (2,) + (self.mlp_hidden,) * (self.mlp_depth - 1) + (2,)

    def kan_widths(self) -> tuple[int, ...]:
        return (2,) + (self.layer_width,) * (self.kan_depth - 1) + (2,)


# KAN sweep matching the reference's param counts:
# params = 12*W*G/5... for [2,W,2] grid G: 4*W*G + 4*W
KAN_SWEEP = (
    SweepPoint("kan", layer_width=4, grid_size=3),    # 64
    SweepPoint("kan", layer_width=5, grid_size=3),    # 80
    SweepPoint("kan", layer_width=4, grid_size=5),    # 96
    SweepPoint("kan", layer_width=5, grid_size=5),    # 120
    SweepPoint("kan", layer_width=6, grid_size=5),    # 144
    SweepPoint("kan", layer_width=10, grid_size=5),   # 240
    SweepPoint("kan", layer_width=20, grid_size=5),   # 480
    SweepPoint("kan", layer_width=40, grid_size=5),   # 960
)
MLP_SWEEP = (
    SweepPoint("mlp", mlp_hidden=10),                 # 52
    SweepPoint("mlp", mlp_hidden=50),                 # 252
    SweepPoint("mlp", mlp_hidden=100),                # 502
)
# beyond-parity depth-3 KAN points ([2,w,w,2], no reference counterpart;
# params = 6*(2w + w^2) at grid 5 — w=4/5/8 -> 192/270/576)
KAN3_SWEEP = (
    SweepPoint("kan", layer_width=4, grid_size=5, kan_depth=3),   # 192
    SweepPoint("kan", layer_width=5, grid_size=5, kan_depth=3),   # 270
    SweepPoint("kan", layer_width=8, grid_size=5, kan_depth=3),   # 576
)
MLP3_SWEEP = (
    SweepPoint("mlp", mlp_hidden=3, mlp_depth=3),     # 29
    SweepPoint("mlp", mlp_hidden=5, mlp_depth=3),     # 57
    SweepPoint("mlp", mlp_hidden=8, mlp_depth=3),     # 114
    SweepPoint("mlp", mlp_hidden=10, mlp_depth=3),    # 162
    SweepPoint("mlp", mlp_hidden=20, mlp_depth=3),    # 522
)


def train_point(point: SweepPoint, *, shooting_iters: int = 10_000,
                seg4_iters: int = 6_000, traj_iters: int = 6_000,
                seed: int = 0) -> dict[str, Any]:
    """Train one sweep point with the fast curriculum; returns the
    trajectory-protocol train/test losses (the quantities trend_plotter
    records)."""
    # fused whole-RK-step kernels cover the canonical 2-layer chain;
    # deeper KAN chains (kan_depth=3 beyond-parity points) run the XLA
    # path like the MLPs
    impl = ("fused" if point.model == "kan" and point.kan_depth == 2
            else "xla")
    base = lv_mod.LVConfig(model=point.model,
                           seed=seed,
                           layer_width=point.layer_width,
                           kan_widths=(point.kan_widths()
                                       if point.kan_depth != 2 else None),
                           grid_size=point.grid_size,
                           mlp_widths=point.mlp_widths(),
                           impl=impl,
                           # depth-3 chains: the reference's glorot/1e5
                           # init vanishes through the third layer (the
                           # whole chain output is ~1e-5 so layer-2/3
                           # inputs collapse to basis(0)); measured
                           # probe: 1e-2 trains to 9.5e-7 in 3k iters
                           # where 1e-5 is stuck at 5.1
                           init_scale=(1.0 if point.model != "kan"
                                       else 1e-5 if point.kan_depth == 2
                                       else 1e-2))
    data = lv_mod.make_data(base)
    model = lv_mod.make_model(base)
    params = lv_mod.init_params(base, model)
    n_params = model.num_params()

    if point.model == "kan":
        phases = [
            dataclasses.replace(base, solve_mode="shooting", segment_len=1,
                                lr=3e-3, iters=shooting_iters),
            dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                                lr=1e-3, iters=seg4_iters),
            dataclasses.replace(base, solve_mode="fixed", lr=3e-4,
                                iters=traj_iters),
        ]
    else:
        # tanh MLPs land in rollout-unstable basins under aggressive
        # shooting; use a gentler schedule with a long trajectory phase
        # (the reference trains them Adam(1e-2) full-trajectory,
        # LV_driver_MLP.jl:92-97)
        phases = [
            dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                                lr=1e-3, iters=shooting_iters),
            dataclasses.replace(base, solve_mode="fixed", lr=1e-3,
                                iters=seg4_iters + traj_iters),
            dataclasses.replace(base, solve_mode="fixed", lr=2e-4,
                                iters=traj_iters),
        ]
    t0 = time.time()
    for cfg in phases:
        out = lv_mod.run(dataclasses.replace(cfg, eval_every=cfg.iters),
                         params=params)
        params = out["params"]
    secs = time.time() - t0

    eval_cfg = dataclasses.replace(base, solve_mode="fixed")
    loss_fn, eval_fn, _ = lv_mod.make_ode_fns(eval_cfg, model, data)
    return {
        "model": point.model,
        "depth": (point.mlp_depth if point.model == "mlp"
                  else point.kan_depth),
        "n_params": n_params,
        "train_loss": float(loss_fn(params)),
        "test_loss": float(eval_fn(params)),
        "seconds": secs,
        "params": params,
    }


def run_sweep(points=KAN_SWEEP + MLP_SWEEP, **kw) -> list[dict]:
    results = []
    for p in points:
        r = train_point(p, **kw)
        r.pop("params")
        results.append(r)
    return results


def packed_trend_sweep(points=KAN_SWEEP, *, shooting_iters: int = 10_000,
                       seg4_iters: int = 6_000, traj_iters: int = 6_000,
                       seed: int = 0, lr_factors=None,
                       polish_iters: int = 0,
                       on_phase=None) -> dict[str, Any]:
    """The Fig-3C KAN d=2 trend sweep as ONE device program.

    The reference produced this study by hand-editing sizes and
    re-running 1e5 CPU iterations per point (`trend_plotter.py:7-8`);
    `run_sweep` already collapses that to seconds per point but still
    trains the sizes sequentially (shapes differ). Here all sizes train
    SIMULTANEOUSLY: the member chains — different hidden widths AND
    different grid sizes — pack block-diagonally into one heterogeneous
    chain (`models.packed.HeteroPacked`, variable-size blocks, per-row
    grids), the member axis rides the GEMM width, and the whole
    curriculum is a handful of `train()` calls on one packed param tree.
    This cashes SURVEY §2.9's DP promise ("train the A2 sweep of KAN
    sizes as one sharded vmap") in its stronger packed form.

    `lr_factors` optionally trains members under per-member learning
    rates (`train(..., lr_scales=...)`); the default recipe is the
    `train_point` KAN curriculum shared by all members.

    `polish_iters > 0` appends a mask-aware packed L-BFGS stage
    (`train.packed_polish.polish_packed`): all members polish
    SIMULTANEOUSLY with per-member curvature histories and line
    searches — the heterogeneous analogue of `polish_members`, which
    needs a stacked (same-shape) layout the trend sweep doesn't have.
    Per-point results then also carry polished_{train,test}_loss.

    Returns {"results": [per-point dicts matching run_sweep's schema],
    "total_seconds", "phase_seconds"}.
    """
    cfgs = [lv_mod.LVConfig(model="kan", seed=seed,
                            layer_width=p.layer_width,
                            grid_size=p.grid_size, impl="xla")
            for p in points]
    if any(p.model != "kan" or p.kan_depth != 2 for p in points):
        raise ValueError("packed trend sweep covers the 2-layer KAN "
                         "points (MLPs have no packing analogue here)")
    base = cfgs[0]
    data = lv_mod.make_data(base)
    members = [lv_mod.make_model(c) for c in cfgs]
    from kanodes.models.packed import HeteroPacked
    hp = HeteroPacked(members)
    inits = [lv_mod.init_params(c, m) for c, m in zip(cfgs, members)]
    params = hp.pack(inits)
    mask = hp.mask()
    pdata = {"ts": data["ts"], "X": hp.tile_state(data["X"]),
             "n_train": data["n_train"]}
    reduce_fn = hp.member_mean()
    lr_scales = None if lr_factors is None else hp.lr_scales(lr_factors)

    from kanodes.models.packed import apply_mask
    from kanodes.train.loop import TrainConfig, train

    phases = [
        dataclasses.replace(base, solve_mode="shooting", segment_len=1,
                            lr=3e-3, iters=shooting_iters),
        dataclasses.replace(base, solve_mode="shooting", segment_len=4,
                            lr=1e-3, iters=seg4_iters),
        dataclasses.replace(base, solve_mode="fixed", lr=3e-4,
                            iters=traj_iters),
    ]
    t0 = time.time()
    phase_secs = []
    for pi, cfg in enumerate(phases):
        loss_s, eval_s, _ = lv_mod.make_ode_fns(cfg, hp, pdata,
                                                reduce_fn=reduce_fn)
        tp = time.time()
        out = train(lambda p: loss_s(apply_mask(mask, p)), params,
                    TrainConfig(lr=cfg.lr, iters=cfg.iters,
                                eval_every=cfg.iters),
                    stacked=False, lr_scales=lr_scales)
        jax.block_until_ready(out["loss_history"])
        params = out["params"]
        phase_secs.append(round(time.time() - tp, 2))
        if on_phase is not None:
            on_phase(pi, out)
    total = time.time() - t0     # train-only (claims pin this); the
                                 # polish stage reports its own time

    polished = None
    polish_secs = None
    if polish_iters:
        from kanodes.train.packed_polish import (PackedPolishConfig,
                                                 polish_packed)
        loss_v, _, _ = lv_mod.make_ode_fns(phases[-1], hp, pdata,
                                           reduce_fn=reduce_fn)
        tp = time.time()
        pol = polish_packed(
            lambda p: loss_v(apply_mask(mask, p)), params,
            ids=hp.member_ids(), mask=mask, n_members=len(points),
            cfg=PackedPolishConfig(iters=polish_iters))
        jax.block_until_ready(pol["best_loss"])
        polish_secs = round(time.time() - tp, 2)
        polished = pol["params"]

    results = []
    for s, (p, c, m) in enumerate(zip(points, cfgs, members)):
        mp = hp.extract_member(params, s)
        eval_cfg = dataclasses.replace(c, solve_mode="fixed")
        loss_fn, eval_fn, _ = lv_mod.make_ode_fns(eval_cfg, m, data)
        row = {
            "model": "kan", "depth": 2,
            "layer_width": p.layer_width, "grid_size": p.grid_size,
            "n_params": m.num_params(),
            "train_loss": float(loss_fn(mp)),
            "test_loss": float(eval_fn(mp)),
        }
        if polished is not None:
            pp = hp.extract_member(polished, s)
            row["polished_train_loss"] = float(loss_fn(pp))
            row["polished_test_loss"] = float(eval_fn(pp))
        results.append(row)
    out = {"results": results, "total_seconds": round(total, 2),
           "phase_seconds": phase_secs, "n_members": len(points)}
    if polish_secs is not None:
        out["polish_seconds"] = polish_secs
        out["polish_iters"] = polish_iters
    return out


def ensemble_seeds(n: int = 8, *, iters: int = 5000, lr: float = 3e-3,
                   mesh=None) -> dict:
    """Train n same-shape LV KAN replicas (different inits) as ONE
    vmapped program, optionally sharded over a device mesh axis "dp"."""
    from kanodes.parallel.sharding import make_mesh, shard_leading

    base = lv_mod.LVConfig(solve_mode="shooting", lr=lr, impl="xla")
    data = lv_mod.make_data(base)
    model = lv_mod.make_model(base)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    params = jax.vmap(model.init)(keys)
    params = jax.tree_util.tree_map(lambda x: x * base.init_scale, params)
    loss_fn, eval_fn, _ = lv_mod.make_ode_fns(base, model, data)
    opt = optax.adam(lr)
    opt_state = jax.vmap(opt.init)(params)

    if mesh is None and len(jax.devices()) > 1:
        mesh = make_mesh(min(len(jax.devices()), n), ("dp",))
    if mesh is not None:
        params = shard_leading(params, mesh)

    def member(p, s):
        def step(c, _):
            p, s = c
            l, g = jax.value_and_grad(loss_fn)(p)
            u, s = opt.update(g, s, p)
            return (optax.apply_updates(p, u), s), l
        (p, s), ls = lax.scan(step, (p, s), None, length=iters)
        return p, s, ls[-1]

    params, opt_state, losses = jax.jit(jax.vmap(member))(params, opt_state)
    evals = jax.jit(jax.vmap(eval_fn))(params)
    return {"params": params, "final_losses": np.asarray(losses),
            "test_losses": np.asarray(evals)}


if __name__ == "__main__":
    import json

    res = run_sweep()
    for r in res:
        ref = (REFERENCE_KAN_TREND if r["model"] == "kan"
               else REFERENCE_MLP_TREND).get(r["n_params"])
        print(f"{r['model']:>4} {r['n_params']:>4} params: "
              f"train {r['train_loss']:.2e} test {r['test_loss']:.2e} "
              f"({r['seconds']:.1f}s)"
              + (f"  [reference: {ref:.2e}]" if ref else ""))
    with open("sweep_results.json", "w") as f:
        json.dump(res, f, indent=1)
