"""Jitted training loops.

The reference's training loop is host-side Python calling
`Zygote.gradient` + `Flux.update!` once per iteration with two extra
metric solves (`LV_driver_KANODE.jl:279-305`). On an accelerator that
pattern is dominated by dispatch latency, so here the *entire* loop is one
`lax.scan` on device: the carry is (params, opt_state), per-iteration
losses stream out as scan outputs, and expensive eval metrics run on a
subsampled schedule in an outer scan. Zero host syncs until the final
history fetch.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from jax import lax

Array = jax.Array

# jitted-chunk memo across train() calls (see train() body)
_RUN_CHUNK_CACHE: dict = {}

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-4
    iters: int = 10_000
    eval_every: int = 100          # test-metric cadence (reference: 1)
    grad_clip: float | None = None
    optimizer: str = "adam"        # adam | adamw | sgd
    weight_decay: float = 0.0
    # upper bound on iterations inside ONE device execution: very long
    # single XLA programs can outlive device/runtime watchdogs, so the
    # host re-dispatches the same compiled chunk and carries state across
    max_iters_per_call: int = 10_000


def clip_by_member_norm(max_norm: float) -> optax.GradientTransformation:
    """Per-member global-norm clipping for STACKED ensembles (leading
    member axis on every leaf): member s is clipped by the norm of ITS
    OWN gradient slice, so members stay exactly independent — a single
    `optax.clip_by_global_norm` over the summed-loss gradients would
    couple every member through one shared norm."""
    def init(params):
        del params
        return optax.EmptyState()

    def update(updates, state, params=None):
        del params
        leaves = jax.tree_util.tree_leaves(updates)
        # per-member squared norm: sum over every axis but the member axis
        sq = sum(jnp.sum(jnp.square(x), axis=tuple(range(1, x.ndim)))
                 for x in leaves)
        scale = jnp.minimum(1.0, max_norm / jnp.maximum(
            jnp.sqrt(sq), 1e-16))
        updates = jax.tree_util.tree_map(
            lambda x: x * scale.reshape((-1,) + (1,) * (x.ndim - 1)),
            updates)
        return updates, state

    return optax.GradientTransformation(init, update)


def scale_by_tree(scale_tree) -> optax.GradientTransformation:
    """Elementwise-multiply updates by a fixed pytree of scale factors
    (leaves broadcastable against the update leaves).

    The per-member-learning-rate mechanism for ensembles: the GLOBAL lr
    stays the injected runtime hyperparameter (`make_optimizer`), and
    this transform carries only the per-member RELATIVE factors — Adam's
    direction is lr-independent, so `adam(lr) . scale_by(r_s)` steps
    member s exactly like `adam(lr * r_s)` would. The factors are
    compile-time constants: changing them recompiles (changing the
    global lr does not), which fits the sweep usage where relative
    factors are fixed per program."""
    def init(params):
        del params
        return optax.EmptyState()

    def update(updates, state, params=None):
        del params
        return jax.tree_util.tree_map(
            lambda u, s: u * s, updates, scale_tree), state

    return optax.GradientTransformation(init, update)


def stacked_lr_scales(params, factors):
    """Per-member lr-factor tree for the STACKED layout: leaf s of every
    param gets `factors[s]` (broadcast over trailing axes). Feed to
    `train(..., lr_scales=...)`; packed layouts use
    `models.packed.member_lr_scales` instead."""
    f = jnp.asarray(factors)
    return jax.tree_util.tree_map(
        lambda x: f.reshape(f.shape + (1,) * (x.ndim - 1)), params)


def make_optimizer(cfg: TrainConfig,
                   member_clip: bool = False,
                   lr_scales=None) -> optax.GradientTransformation:
    """The learning rate is INJECTED as a runtime hyperparameter (it
    lives in opt_state, not in the compiled program): training phases
    that differ only in lr then lower to byte-identical HLO, so the
    in-process chunk memo and the persistent compilation cache serve
    every phase after the first.

    `member_clip=True` replaces global-norm clipping by the per-member
    variant (stacked ensembles; see `clip_by_member_norm`). `lr_scales`
    appends a `scale_by_tree` stage (per-member learning rates)."""
    if cfg.optimizer == "adam":
        opt = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.lr)
    elif cfg.optimizer == "adamw":
        opt = optax.inject_hyperparams(optax.adamw)(
            learning_rate=cfg.lr, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = optax.inject_hyperparams(optax.sgd)(learning_rate=cfg.lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if lr_scales is not None:
        opt = optax.chain(opt, scale_by_tree(lr_scales))
    if cfg.grad_clip is not None:
        clip = (clip_by_member_norm(cfg.grad_clip) if member_clip
                else optax.clip_by_global_norm(cfg.grad_clip))
        opt = optax.chain(clip, opt)
    return opt


def train(loss_fn: Callable[[Any], Array],
          params,
          cfg: TrainConfig,
          eval_fn: Callable[[Any], Array] | None = None,
          track_best: bool = True,
          record_history: bool = False,
          on_chunk: Callable[[int, dict], None] | None = None,
          opt_state=None,
          stacked: bool | None = None,
          lr_scales=None):
    """Run `cfg.iters` optimization steps fully on device.

    Args:
      loss_fn: params -> scalar training loss (the objective).
      eval_fn: params -> scalar eval metric, run every `cfg.eval_every`
        iterations (e.g. the test-horizon loss of `LV_driver_KANODE.jl:214`).
      track_best: keep the argmin-loss parameters in the carry — the
        online equivalent of the reference's post-hoc argmin over a
        stored full parameter history (`Plotting_standard.jl:105-110`)
        without O(iters x params) checkpoint storage.
      record_history: also return "param_history" — a parameter snapshot
        at every eval point ([n_evals, ...] leaves). This restores the
        reference's post-hoc model-selection capability (pick the params
        minimizing ANY recorded metric after the fact,
        `LV_driver_KANODE.jl:252-272`) at eval cadence, bounding storage
        to iters/eval_every snapshots instead of its full p_list.
      on_chunk: called as on_chunk(call_index, state) after every device
        execution with the live params/opt_state/histories — the hook
        for mid-run checkpointing of long runs.
      opt_state: resume an existing optimizer state (restart flows).

    Multi-seed (vector-loss) mode: if `loss_fn` returns a VECTOR of
    per-member losses (independent replicas stacked on a leading axis of
    every param leaf, e.g. `jax.vmap(member_loss)`), the loop trains all
    members as ONE device program: gradients are taken of the member
    SUM — exact per-member gradients, since members are independent —
    and best-tracking/eval/history become per-member. Measured on the
    8-seed LV record sweep (EXPERIMENTS.md): bitwise per-member parity
    with sequential runs. The value is orchestration: one program,
    one compile, per-member capture. `eval_fn` must return the
    matching [S] vector.

    `stacked`: declare the vector-mode param layout explicitly — True
    for the stacked layout (leading member axis on every leaf; enables
    per-member best-tracking), False for any other layout (packed
    block-diagonal ensembles etc.; joint best-tracking). The default
    (None) infers it by checking every leaf's leading dim against the
    loss-vector length — which can misfire on a NON-stacked tree whose
    leaves all coincidentally lead with S, silently frankensteinining
    best_params from per-member argmin slices along a non-member axis.
    Pass it explicitly when the layout is known.

    `lr_scales`: per-member learning-rate factors as a pytree matching
    `params` with broadcastable leaves (build with `stacked_lr_scales`
    or `models.packed.member_lr_scales`). Member s trains exactly as it
    would under `adam(cfg.lr * factor_s)` — heterogeneous-recipe
    ensembles in one device program (SURVEY §2.9's DP promise).

    Returns dict with final/best params, per-iter train-loss history and
    per-eval metric history.
    """
    # () for the classic scalar objective; [S] for multi-seed vector mode
    lshape = tuple(jax.eval_shape(loss_fn, params).shape)
    # per-member best selection needs the stacked layout (leading member
    # axis on every leaf); other vector-loss layouts (e.g. packed
    # block-diagonal ensembles, models/packed.py) get JOINT best
    # tracking: best_params/best_loss are taken at the argmin of the
    # member SUM (per-member capture there goes through record_history +
    # per-member argmin over snapshots instead)
    if stacked is None:
        stacked = lshape != () and all(
            leaf.shape[:1] == lshape
            for leaf in jax.tree_util.tree_leaves(params))
    elif stacked and lshape == ():
        raise ValueError("stacked=True requires a vector loss_fn")
    stacked_layout = stacked
    if lshape != () and cfg.grad_clip is not None and not stacked_layout:
        # one global norm over the member-summed gradients would couple
        # every member's update (ADVICE r4); the per-member clip needs
        # the stacked layout to find the member axis
        raise ValueError(
            "grad_clip with a vector (multi-member) loss requires the "
            "stacked layout (per-member clipping); a global norm would "
            "silently couple the members")
    opt = make_optimizer(cfg, member_clip=(lshape != () and stacked_layout),
                         lr_scales=lr_scales)
    if opt_state is None:
        opt_state = opt.init(params)

    # chunking: the run executes n_calls * per_call iterations, which
    # ROUNDS cfg.iters UP to a whole number of chunks (loss_history is
    # still truncated to cfg.iters; the extra updates only help)
    per_call = min(cfg.iters, cfg.max_iters_per_call)
    evals_per_call = max(per_call // cfg.eval_every, 1)
    inner = max(per_call // evals_per_call, 1)
    per_call = evals_per_call * inner
    n_calls = max(-(-cfg.iters // per_call), 1)

    # the compiled chunk is MEMOIZED across train() calls: the learning
    # rate lives in opt_state (inject_hyperparams), so phases differing
    # only in lr/iters reuse one executable instead of re-tracing and
    # re-compiling a fresh jit callable.
    lr_key = None
    if lr_scales is not None:
        # the scale factors are closure CONSTANTS of the compiled chunk
        # (see scale_by_tree) — key the memo by their bytes
        import numpy as _np
        h = hashlib.sha256()
        for leaf in jax.tree_util.tree_leaves(lr_scales):
            arr = _np.asarray(leaf)
            h.update(str(arr.shape).encode() + arr.tobytes())
        lr_key = h.hexdigest()
    cache_key = (loss_fn, eval_fn, inner, evals_per_call, track_best,
                 record_history, cfg.optimizer, cfg.grad_clip,
                 cfg.weight_decay, lshape, stacked_layout, lr_key)
    run_chunk = _RUN_CHUNK_CACHE.get(cache_key)
    if run_chunk is None:
        if lshape == ():
            vg = jax.value_and_grad(loss_fn)
        else:
            # vector mode: grad of the member sum == exact per-member
            # grads (members are independent); keep the vector as aux
            # for per-member best-tracking
            def _summed(p):
                vec = loss_fn(p)
                return jnp.sum(vec), vec
            _vg_aux = jax.value_and_grad(_summed, has_aux=True)

            def vg(p):
                (_, vec), grads = _vg_aux(p)
                return vec, grads

        def step(carry, _):
            params, opt_state, best_loss, best_params = carry
            loss, grads = vg(params)
            if track_best:
                # record the PRE-update params the loss was measured at;
                # storing the post-update params pairs best_loss with a
                # point one Adam step past it (measured 3x off at the
                # f32 floor: 4.15e-13 recorded vs 1.2e-12 re-measured on
                # the 2-D AC surrogate before this fix)
                if lshape == () or stacked_layout:
                    better = loss < best_loss
                else:                     # joint (sum) best for packed
                    better = jnp.sum(loss) < jnp.sum(best_loss)
                best_loss = jnp.where(better, loss, best_loss)
                if lshape == () or not stacked_layout:
                    sel = lambda new, old: jnp.where(better, new, old)
                else:
                    # per-member select: broadcast [S] over [S, ...] leaves
                    def sel(new, old):
                        b = better.reshape(
                            lshape + (1,) * (new.ndim - len(lshape)))
                        return jnp.where(b, new, old)
                best_params = jax.tree_util.tree_map(
                    sel, params, best_params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state, best_loss, best_params), loss

        def outer(carry, _):
            carry, losses = lax.scan(step, carry, None, length=inner)
            metric = eval_fn(carry[0]) if eval_fn is not None else jnp.nan
            snap = carry[0] if record_history else jnp.nan
            return carry, (losses, metric, snap)

        def _chunk_fn(carry):
            carry, (losses, metrics, snaps) = lax.scan(
                outer, carry, None, length=evals_per_call)
            return carry, losses.reshape((-1,) + lshape), metrics, snaps

        run_chunk = jax.jit(_chunk_fn)

        if len(_RUN_CHUNK_CACHE) >= 16:      # bound closure retention
            _RUN_CHUNK_CACHE.pop(next(iter(_RUN_CHUNK_CACHE)))
        _RUN_CHUNK_CACHE[cache_key] = run_chunk

    carry = (params, opt_state, jnp.full(lshape, jnp.inf, jnp.float32),
             params)
    loss_chunks, metric_chunks, snap_chunks = [], [], []
    for i in range(n_calls):
        carry, losses, metrics, snaps = run_chunk(carry)
        loss_chunks.append(losses)
        metric_chunks.append(metrics)
        if record_history:
            snap_chunks.append(snaps)
        if on_chunk is not None:
            on_chunk(i, {
                "params": carry[0], "opt_state": carry[1],
                "best_loss": carry[2], "best_params": carry[3],
                "loss_history": jnp.concatenate(loss_chunks),
                "eval_history": jnp.concatenate(metric_chunks),
            })
    params, opt_state, best_loss, best_params = carry
    out = {
        "params": params,
        "opt_state": opt_state,
        "best_params": best_params,
        "best_loss": best_loss,
        "loss_history": jnp.concatenate(loss_chunks)[:cfg.iters],
        "eval_history": jnp.concatenate(metric_chunks),
    }
    if record_history:
        out["param_history"] = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs), *snap_chunks)
    return out


def init_stacked(init_fn: Callable, seeds) -> Any:
    """Stack independent inits on a leading member axis — the param
    layout for `train()`'s multi-seed vector-loss mode (pair with
    `jax.vmap(loss_fn)`). `init_fn` takes a PRNGKey; `seeds` are ints."""
    trees = [init_fn(jax.random.PRNGKey(int(s))) for s in seeds]
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def member_params(tree, i: int):
    """Extract member i from a stacked multi-seed param tree."""
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def train_step_fn(loss_fn: Callable, cfg: TrainConfig):
    """A single jittable (params, opt_state) -> (params, opt_state, loss)
    step — building block for custom loops / sharded ensembles."""
    opt = make_optimizer(cfg)
    vg = jax.value_and_grad(loss_fn)

    def step(params, opt_state):
        loss, grads = vg(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, opt
