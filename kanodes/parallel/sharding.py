"""Mesh / sharding utilities — the multi-device scale-out layer.

The reference has NO parallelism of any kind (SURVEY.md §2.9): single
process, single CPU. The multi-device equivalents built here:

  * ensemble data-parallelism: the paper's A2 param-efficiency sweep
    trains many network sizes sequentially (`trend_plotter.py`); here a
    whole ensemble of models (different inits / hyperparams) trains as ONE
    jitted program, vmapped over the member axis and sharded over the
    device mesh ("dp").
  * grid-sharded PDE RHS ("sp"): for method-of-lines problems the spatial
    grid axis is sharded over the devices via `shard_map`, with halo
    exchange for
    the FD stencil — the project's analogue of sequence/context
    parallelism (SURVEY.md §5.7). See `kanodes/pde/sharded.py`.
"""

from __future__ import annotations

from typing import Callable

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, ...] = ("dp",),
              shape: tuple[int, ...] | None = None) -> Mesh:
    """1-D (or reshaped) device mesh over the first n_devices devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = np.asarray(devs[:n])
    if shape is None:
        shape = (n,)
    return Mesh(devs.reshape(shape), axis_names)


def shard_leading(tree, mesh: Mesh, axis: str = "dp"):
    """Place a pytree with its leading axis sharded over `axis`."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), tree)


def dp_value_and_grad(per_shard_loss: Callable, mesh: Mesh,
                      axis: str | tuple[str, ...] = "dp"):
    """Classic synchronized data parallelism: the BATCH (shooting
    segments, collocation points, PDE snapshots) is sharded over `axis`;
    every device computes its shard's loss/gradient and the results are
    psum-reduced, so the returned (loss, grads) equal the full-batch
    values exactly — one model, N-way batch scale-out.

    `axis` may be a tuple for hierarchical meshes, e.g. ("host", "chip")
    with the host axis across the network and the chip axis within a
    host (NVLink between cards): XLA lowers the
    psum to an intra-host reduce + cross-host all-reduce of the small
    parameter pytree (the only cross-host traffic per step).

    per_shard_loss: (params, batch_shard) -> (loss_SUM, n_examples);
    returning the shard SUM and count (not the mean) keeps the global
    mean exact for uneven shards.
    Returns f(params, batch) -> (loss, grads) with params replicated and
    batch leading-axis sharded.
    """
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    spec = P(names if len(names) > 1 else names[0])

    def local(params, batch):
        # differentiate THROUGH the psum'd global mean: shard_map's
        # vma-aware reverse AD then auto-inserts the one gradient psum
        # (params are replicated inputs, so their cotangent must be) —
        # adding a manual psum on top would multiply by the axis size
        def global_mean(p):
            lsum, n = per_shard_loss(p, batch)
            return jax.lax.psum(lsum, names) / jax.lax.psum(n, names)

        return jax.value_and_grad(global_mean)(params)

    return jax.shard_map(local, mesh=mesh, in_specs=(P(), spec),
                         out_specs=(P(), P()))


def dp_train_step(per_shard_loss: Callable, optimizer, mesh: Mesh,
                  axis: str | tuple[str, ...] = "dp"):
    """Jitted synchronized-DP Adam/optax step over a sharded batch:
    (params, opt_state, batch) -> (params, opt_state, loss). Gradients
    are exact full-batch gradients (see dp_value_and_grad)."""
    import optax

    vg = dp_value_and_grad(per_shard_loss, mesh, axis)

    def step(params, opt_state, batch):
        loss, grads = vg(params, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    return jax.jit(step)


def ensemble_train_step(loss_fn: Callable, optimizer, mesh: Mesh,
                        axis: str = "dp"):
    """Build a sharded ensemble step: params/opt_state lead with a member
    axis sharded over `axis`; each device trains its members independently
    (no collectives in the hot path — pure DP).

    loss_fn: (member_params) -> scalar. Returns jitted
    (params, opt_state) -> (params, opt_state, losses[B]).
    """
    import optax

    def member_step(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    step = jax.vmap(member_step)
    shard = NamedSharding(mesh, P(axis))
    return jax.jit(step, out_shardings=(None, None, shard))
