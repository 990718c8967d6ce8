"""Whole-RK-step Triton kernels vs the plain XLA path, end to end.

Each case builds the driver's own objective (`make_ode_fns` / `make_fns`)
once per route and times N training iterations — value_and_grad + Adam,
the loop `train()` runs — inside one jitted `lax.scan`, so host dispatch
is paid once per N iterations. Both routes solve the same step grid:
the chain cases build `impl="fused"` with `rk_fused.kernel_wins` forced
on ("fused") or off ("xla"), whatever the width rule would choose; the
gray-box cases compare `impl="fused"` with `impl="xla"`. Turns
alternate xla, fused, fused, xla (repeated `--rounds` times) in one
process on one card; the reported time is the median over the turns of
each route, in ms per iteration.

The XLA-only cases time the paths that replaced the removed adaptive
and wide-state kernels (LV adaptive at the reference rtol, Schrödinger
[402,10,402]).

    python scripts/kernel_vs_xla.py [--rounds=2] [--cases=a,b]

Needs the GPU. Writes chiprun_out/kernel_vs_xla.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import optax  # noqa: E402
from jax import lax  # noqa: E402

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def _forced(route):
    """Force the width rule: the kernels ("fused") or XLA ("xla")."""
    from kanodes.ops import rk_fused
    return mock.patch.object(rk_fused, "kernel_wins",
                             lambda spec: route == "fused")


def _lv(mode, members=1, **kw):
    from kanodes.experiments import lv
    from kanodes.models import packed

    def build(route):
        cfg = lv.LVConfig(solve_mode=mode, impl="fused", **kw)
        data = lv.make_data(cfg)
        model = lv.make_model(cfg)
        params = lv.init_params(cfg, model)
        fn_kw = {}
        if members > 1:
            params = packed.pack_params(
                model, [lv.init_params(cfg, model, jax.random.PRNGKey(s))
                        for s in range(members)])
            model = packed.pack_chain(model, members)
            data = dict(data, X=packed.tile_state(data["X"], members))
            fn_kw["reduce_fn"] = packed.member_mean(members)
        with _forced(route):
            loss, _, _ = lv.make_ode_fns(cfg, model, data, **fn_kw)
        if members > 1:
            return (lambda p: loss(p).sum()), params, cfg.lr
        return loss, params, cfg.lr
    return build


def _surrogate(problem, **kw):
    from kanodes.experiments import pde_surrogate as ps

    def build(route):
        cfg = ps.SurrogateConfig(problem=problem, impl="fused", **kw)
        data = ps.make_data(cfg)
        model = ps.make_model(cfg, data)
        with _forced(route):
            loss, _, _ = ps.make_fns(cfg, model, data)
        return loss, model.init(jax.random.PRNGKey(0)), cfg.resolved_lr()
    return build


def _source(**kw):
    from kanodes.experiments import pde_source as src

    def build(route):
        cfg = src.SourceConfig(impl=route, **kw)
        data = src.make_data(cfg)
        model = src.make_model(cfg)
        loss, _, _ = src.make_fns(cfg, model, data)
        return loss, model.init(jax.random.PRNGKey(0)), cfg.lr
    return build


BOTH = ("xla", "fused")
# name -> (builder, iterations per timed call, routes)
CASES = {
    "lv_shooting": (_lv("shooting", segment_len=1), 2000, BOTH),
    "lv_trajectory": (_lv("fixed"), 500, BOTH),
    # the widest reference sweep point, [2,40,2] (sweep.KAN_SWEEP)
    "lv_sweep_h40_shooting": (_lv("shooting", segment_len=1,
                                  layer_width=40), 1000, BOTH),
    # packed seed ensembles ([2S,10S,2S], models/packed.py)
    "lv_packed4_shooting": (_lv("shooting", members=4, segment_len=1),
                            1000, BOTH),
    "lv_packed8_shooting": (_lv("shooting", members=8, segment_len=1),
                            1000, BOTH),
    "lv_packed8_trajectory": (_lv("fixed", members=8), 200, BOTH),
    "burgers_trajectory": (_surrogate("burgers"), 50, BOTH),
    "burgers_shooting": (_surrogate("burgers", solve_mode="shooting"),
                         50, BOTH),
    "allen_cahn_trajectory": (_surrogate("allen_cahn", rk_solver="rk4",
                                         substeps=24), 20, BOTH),
    "fisher_1d": (_source(), 500, BOTH),
    "fisher_2d": (_source(ndim=2), 100, BOTH),
    "lv_adaptive": (_lv("adaptive"), 100, ("xla",)),
    "schrodinger": (_surrogate("schrodinger"), 5, ("xla",)),
}


def _runner(loss_fn, params, lr, n):
    opt = optax.adam(lr)
    vg = jax.value_and_grad(loss_fn)

    def it(carry, _):
        p, s = carry
        loss, g = vg(p)
        u, s = opt.update(g, s, p)
        return (optax.apply_updates(p, u), s), loss

    @jax.jit
    def run(p, s):
        (p, s), losses = lax.scan(it, (p, s), None, length=n)
        return p, s, losses

    return run, (params, opt.init(params))


def measure(name, rounds):
    build, n, routes = CASES[name]
    runners = {}
    for route in routes:
        loss_fn, params, lr = build(route)
        run, carry = _runner(loss_fn, params, lr, n)
        t0 = time.perf_counter()
        out = run(*carry)
        jax.block_until_ready(out)
        compile_s = time.perf_counter() - t0
        runners[route] = (run, carry, compile_s, float(out[2][-1]),
                          float(out[2][0]))
    order = list(routes) + list(reversed(routes))
    times = {route: [] for route in routes}
    for _ in range(rounds):
        for route in order:
            run, carry, *_ = runners[route]
            t0 = time.perf_counter()
            jax.block_until_ready(run(*carry))
            times[route].append((time.perf_counter() - t0) / n * 1e3)
    row = {"iters_per_call": n}
    for route in routes:
        _, _, compile_s, last, first = runners[route]
        row[route] = {"ms_per_iter": statistics.median(times[route]),
                      "turns_ms": times[route],
                      "first_call_s": compile_s,
                      "loss_first": first, "loss_last": last}
    if "fused" in row:
        row["xla_over_fused"] = (row["xla"]["ms_per_iter"]
                                 / row["fused"]["ms_per_iter"])
    return row


def main(argv):
    opts = dict(a.lstrip("-").split("=", 1) for a in argv if "=" in a)
    rounds = int(opts.get("rounds", 2))
    names = opts["cases"].split(",") if "cases" in opts else list(CASES)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs the GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"device_kind": dev.device_kind, "card": card, "cases": {}}
    print(f"[kernel_vs_xla] {card}", flush=True)
    for name in names:
        row = measure(name, rounds)
        result["cases"][name] = row
        line = " ".join(f"{k} {v['ms_per_iter']:.4f} ms/it (first call "
                        f"{v['first_call_s']:.1f} s)"
                        for k, v in row.items() if isinstance(v, dict))
        ratio = row.get("xla_over_fused")
        print(f"[kernel_vs_xla] {name}: {line}"
              + (f" xla/fused {ratio:.2f}" if ratio else ""), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/kernel_vs_xla.json", "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
