"""Smoke test of the main paths on the GPU, through the normal entry points.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --multichip   # four cards: the sharded paths only

Phases (one card):
  device     platform, device kind and count; the card's name and power
             limit from nvidia-smi (a child process that stays off JAX)
  lv         the reference LV KAN-ODE ([2,10,2] RBF-KAN, grid 5, 240
             params) through make_ode_fns + train: shooting mode (34
             segments) and trajectory mode (35 Tsit5 steps) on the Triton
             kernels, and 500 shooting iterations with impl="fused" and
             impl="xla" — both losses must fall and agree
  surrogate  Burgers [41,10,41] and Schrödinger [402,10,402] (grid 10)
             with impl="fused": the kernels where rk_fused.kernel_wins
             admits the chain, compared with XLA on the same step grid,
             and XLA beyond it
  source     Fisher-KPP gray-box source recovery, 1-D (26 nodes) and 2-D
             (32x32, Kronecker Laplacian), on the kernels
  kernels    the compiled-kernel parity tests marked `chip`

--multichip runs only what exists across cards, each against the same
work on one device: the seed ensemble sharded over a 4-way "dp" mesh,
a surrogate with its grid axis sharded over a (1, 4) mesh, and the
gray-box source trainer with its grid sharded over 4 devices (ppermute
halo exchange).

Each phase prints its compile time, run time and errors on a line of
its own; any failure exits nonzero. The last line is the JSON result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cuda")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

# Gradient-level agreement of two training runs: after hundreds of Adam
# steps, float32 rounding differences between the kernel and XLA grow
# through the optimizer's trajectory; the losses must still agree to
# this relative tolerance.
TRAIN_RTOL = 5e-2
# Loss at the same parameters, kernel vs XLA: IEEE float32 on both sides,
# only the summation order differs.
LOSS_RTOL = 1e-5


def _fmt(x):
    return f"{x:.4g}" if isinstance(x, float) else str(x)


def phase(name):
    """Decorator: run, time, print one line; re-raise failures."""
    def wrap(fn):
        def run(*a):
            t0 = time.perf_counter()
            try:
                info = fn(*a)
            except Exception as e:
                print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}"
                      f" s: {type(e).__name__}: {e}", flush=True)
                raise
            fields = " ".join(f"{k}={_fmt(v)}" for k, v in info.items())
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: "
                  f"{fields}", flush=True)
            return info
        return run
    return wrap


def _timed_train(loss_fn, params, tc, eval_fn=None):
    """First train() call (compile + run) and a second one on the
    memoized executable (run only)."""
    from kanodes.train.loop import train
    t0 = time.perf_counter()
    out = train(loss_fn, params, tc, eval_fn=eval_fn)
    jax.block_until_ready(out["loss_history"])
    t1 = time.perf_counter()
    out = train(loss_fn, params, tc, eval_fn=eval_fn)
    jax.block_until_ready(out["loss_history"])
    t2 = time.perf_counter()
    hist = np.asarray(out["loss_history"])
    if not np.all(np.isfinite(hist)):
        raise AssertionError("non-finite loss")
    return out, hist, {"compile_s": (t1 - t0) - (t2 - t1),
                       "run_s": t2 - t1}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@phase("device")
def device_phase():
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in card:
        print(f"[device] card: {line}", flush=True)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


@phase("lv")
def lv_phase():
    from kanodes.experiments import lv
    from kanodes.train.loop import TrainConfig

    info = {}
    for mode, iters in (("shooting", 200), ("fixed", 50)):
        cfg = lv.LVConfig(solve_mode=mode, impl="fused", lr=5e-3)
        data = lv.make_data(cfg)
        model = lv.make_model(cfg)
        params = lv.init_params(cfg, model)
        loss_f, eval_f, _ = lv.make_ode_fns(cfg, model, data)
        loss_x, _, _ = lv.make_ode_fns(
            lv.LVConfig(solve_mode=mode, impl="xla"), model, data)
        err = _rel(loss_f(params), loss_x(params))
        if err > LOSS_RTOL:
            raise AssertionError(f"{mode}: kernel vs XLA loss {err:.2e}")
        _, hist, t = _timed_train(
            loss_f, params, TrainConfig(lr=cfg.lr, iters=iters,
                                        eval_every=iters), eval_f)
        if not hist[-1] < hist[0]:
            raise AssertionError(f"{mode}: loss did not fall")
        info.update({f"{mode}_compile_s": t["compile_s"],
                     f"{mode}_run_s": t["run_s"],
                     f"{mode}_loss_err_vs_xla": err})

    # 500 shooting iterations on the kernels and on XLA
    finals = {}
    for impl in ("fused", "xla"):
        cfg = lv.LVConfig(solve_mode="shooting", impl=impl, lr=5e-3)
        data = lv.make_data(cfg)
        model = lv.make_model(cfg)
        loss, _, _ = lv.make_ode_fns(cfg, model, data)
        _, hist, _ = _timed_train(loss, lv.init_params(cfg, model),
                                  TrainConfig(lr=cfg.lr, iters=500,
                                              eval_every=500))
        if not hist[-1] < 1e-2 * hist[0]:
            raise AssertionError(f"500 its {impl}: loss fell only "
                                 f"{hist[0]:.3e} -> {hist[-1]:.3e}")
        finals[impl] = hist[-1]
    err = _rel(finals["fused"], finals["xla"])
    if err > TRAIN_RTOL:
        raise AssertionError(f"500-iteration losses differ by {err:.2e}")
    info.update({"final_loss_fused": float(finals["fused"]),
                 "final_loss_xla": float(finals["xla"]),
                 "final_loss_rel_err": err})
    return info


@phase("surrogate")
def surrogate_phase():
    from kanodes.experiments import pde_surrogate as ps
    from kanodes.ops import rk_fused
    from kanodes.ops.kan_chain import chain_spec_of
    from kanodes.train.loop import TrainConfig

    info = {}
    for problem, iters in (("burgers", 20), ("schrodinger", 2)):
        cfg = ps.SurrogateConfig(problem=problem, impl="fused")
        data = ps.make_data(cfg)
        model = ps.make_model(cfg, data)
        params = model.init(jax.random.PRNGKey(0))
        loss_f, snap_f, _ = ps.make_fns(cfg, model, data)
        on_kernel = rk_fused.kernel_wins(chain_spec_of(model))
        info[f"{problem}_route"] = "kernel" if on_kernel else "xla"
        if on_kernel:
            with mock.patch.object(rk_fused, "kernel_wins",
                                   lambda spec: False):
                loss_x, _, _ = ps.make_fns(cfg, model, data)
            err = _rel(loss_f(params), loss_x(params))
            if err > LOSS_RTOL:
                raise AssertionError(f"{problem}: kernel vs XLA loss "
                                     f"{err:.2e}")
            info[f"{problem}_loss_err_vs_xla"] = err
        _, hist, t = _timed_train(
            loss_f, params, TrainConfig(lr=cfg.resolved_lr(), iters=iters,
                                        eval_every=iters), snap_f)
        if not hist[-1] < hist[0]:
            raise AssertionError(f"{problem}: loss did not fall")
        info.update({f"{problem}_compile_s": t["compile_s"],
                     f"{problem}_run_s": t["run_s"]})
    return info


@phase("source")
def source_phase():
    from kanodes.experiments import pde_source as src
    from kanodes.train.loop import TrainConfig

    info = {}
    for ndim, iters in ((1, 100), (2, 20)):
        cfg = src.SourceConfig(ndim=ndim, impl="fused")
        data = src.make_data(cfg)
        model = src.make_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        loss_f, _, _ = src.make_fns(cfg, model, data)
        loss_x, _, _ = src.make_fns(src.SourceConfig(ndim=ndim), model,
                                    data)
        err = _rel(loss_f(params), loss_x(params))
        if err > LOSS_RTOL:
            raise AssertionError(f"{ndim}-D: kernel vs XLA loss {err:.2e}")
        _, hist, t = _timed_train(
            loss_f, params, TrainConfig(lr=cfg.lr, iters=iters,
                                        eval_every=iters))
        if not hist[-1] < hist[0]:
            raise AssertionError(f"{ndim}-D: loss did not fall")
        info.update({f"fisher{ndim}d_compile_s": t["compile_s"],
                     f"fisher{ndim}d_run_s": t["run_s"],
                     f"fisher{ndim}d_loss_err_vs_xla": err})
    return info


@phase("kernels")
def kernels_phase():
    import pytest

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "test_kernels_chip.py")
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      "-p", "no:randomly", tests])
    if rc != 0:
        raise AssertionError(f"chip parity tests failed (pytest rc {rc})")
    return {"pytest_rc": int(rc)}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

@phase("multichip-dp")
def dp_phase():
    from kanodes.experiments.sweep import ensemble_seeds
    from kanodes.parallel.sharding import make_mesh

    kw = dict(n=8, iters=200)
    one = ensemble_seeds(**kw, mesh=make_mesh(1, ("dp",)))
    four = ensemble_seeds(**kw, mesh=make_mesh(4, ("dp",)))
    err = max(_rel(a, b) for a, b in zip(four["final_losses"],
                                         one["final_losses"]))
    if err > LOSS_RTOL:
        raise AssertionError(f"dp ensemble vs one device: {err:.2e}")
    return {"members": 8, "devices": 4, "max_rel_loss_err": err}


def _sharded_vs_single(run, cfg_sharded, cfg_single):
    a = np.asarray(run(cfg_sharded)["loss_history"])
    b = np.asarray(run(cfg_single)["loss_history"])
    if not (np.all(np.isfinite(a)) and a[-1] < a[0]):
        raise AssertionError("sharded loss not finite or not falling")
    return float(np.max(np.abs(a - b) / np.abs(b)))


@phase("multichip-sp")
def sp_phase():
    import dataclasses

    from kanodes.experiments import pde_source as src
    from kanodes.experiments import pde_surrogate as ps

    # Schrödinger surrogate on 200 grid points (state 400, divisible by
    # 4): grid axis tensor-parallel over sp=4, one psum per RHS eval
    cfg = ps.SurrogateConfig(problem="schrodinger", data_dx=10.0 / 199,
                             iters=20, eval_every=20, mesh=(1, 4))
    err_tp = _sharded_vs_single(ps.run, cfg,
                                dataclasses.replace(cfg, mesh=None))
    # Fisher-KPP source on 28 nodes: ppermute halo exchange over sp=4
    cfg = src.SourceConfig(problem="fisher_kpp", data_dx=1.0 / 27,
                           iters=50, eval_every=50, sp=4)
    err_halo = _sharded_vs_single(src.run, cfg,
                                  dataclasses.replace(cfg, sp=1))
    for name, err in (("surrogate", err_tp), ("source", err_halo)):
        if err > 1e-4:
            raise AssertionError(f"{name}: sharded vs one device {err:.2e}")
    return {"surrogate_mesh": "(1,4)", "surrogate_max_rel_err": err_tp,
            "source_sp": 4, "source_max_rel_err": err_halo}


def main(argv):
    info = device_phase()
    if "--multichip" in argv:
        if info["count"] < 4:
            raise SystemExit(f"--multichip needs 4 GPUs, found "
                             f"{info['count']}")
        dp_phase()
        sp_phase()
    else:
        lv_phase()
        surrogate_phase()
        source_phase()
        kernels_phase()
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main(sys.argv[1:])
