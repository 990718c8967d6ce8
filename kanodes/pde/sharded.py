"""Grid-sharded PDE right-hand sides over a device mesh.

The reference never scales beyond one CPU; its largest grid is the
402-dim Schrödinger state (SURVEY.md §5.7). This module is the answer
for when grids DO grow: shard the spatial axis over the devices with
`shard_map`, exchange one-cell halos with `lax.ppermute`, and keep the
pointwise KAN evaluation fully local. This is the project's analogue of
sequence/context parallelism — the only cross-device traffic is the
2-element halo per step, which rides the device interconnect.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

Array = jax.Array


def halo_exchange(u_local: Array, axis_name: str) -> tuple[Array, Array]:
    """Return (left_ghost, right_ghost) cells from ring neighbors.

    Periodic by construction of the ring permutation.
    """
    n = lax.psum(1, axis_name)
    right_src = [(i, (i + 1) % n) for i in range(n)]   # send right edge ->
    left_src = [(i, (i - 1) % n) for i in range(n)]
    left_ghost = lax.ppermute(u_local[-1:], axis_name, right_src)
    right_ghost = lax.ppermute(u_local[:1], axis_name, left_src)
    return left_ghost, right_ghost


def sharded_laplacian_periodic(mesh: Mesh, dx: float,
                               axis: str = "sp") -> Callable[[Array], Array]:
    """Periodic centered Laplacian on a grid sharded along `axis`."""

    def local(u_local: Array) -> Array:
        lg, rg = halo_exchange(u_local, axis)
        up = jnp.concatenate([lg, u_local, rg])
        return (up[2:] - 2.0 * up[1:-1] + up[:-2]) / (dx * dx)

    return shard_map(local, mesh=mesh, in_specs=P(axis), out_specs=P(axis))


def sharded_graybox_rhs(mesh: Mesh, dx: float, diffusivity: float,
                        model, axis: str = "sp"):
    """Sharded version of the Fisher-KPP / Allen-Cahn gray-box RHS:
    D * lap(u) + kan.(u), u sharded along `axis`; KAN params replicated.

    Returns rhs(t, u, params) usable directly by the ode solvers under
    jit — the solver's scan runs SPMD with only halo traffic per stage.
    """

    def local(u_local: Array, params) -> Array:
        lg, rg = halo_exchange(u_local, axis)
        up = jnp.concatenate([lg, u_local, rg])
        lap = (up[2:] - 2.0 * up[1:-1] + up[:-2]) / (dx * dx)
        learned = model.apply(params, u_local[:, None])[:, 0]
        return diffusivity * lap + learned

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis), P()), out_specs=P(axis))

    def rhs(t, u, params):
        return fn(u, params)

    return rhs


def sharded_graybox_rhs_2d(mesh: Mesh, dx: float, diffusivity: float,
                           model, axis: str = "sp"):
    """2-D gray-box RHS D*lap2d(u) + kan.(u) with the field's ROW axis
    sharded along `axis` (u: [Ny, Nx], periodic both directions).

    The x-direction stencil is fully local (rolls along the unsharded
    axis); the y-direction stencil needs one ghost ROW from each ring
    neighbor — `halo_exchange` already moves whole rows because it
    slices the leading axis. Per RK stage the wire cost is 2 rows of
    Nx floats, independent of Ny. The pointwise KAN stays local.
    """

    def local(u_local: Array, params) -> Array:
        lg, rg = halo_exchange(u_local, axis)            # [1, Nx] rows
        up = jnp.concatenate([lg, u_local, rg], axis=0)
        lap_y = (up[2:] - 2.0 * up[1:-1] + up[:-2]) / (dx * dx)
        lap_x = (jnp.roll(u_local, -1, axis=1) - 2.0 * u_local
                 + jnp.roll(u_local, 1, axis=1)) / (dx * dx)
        learned = model.apply(params, u_local.reshape(-1, 1)
                              ).reshape(u_local.shape)
        return diffusivity * (lap_x + lap_y) + learned

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axis, None), P()), out_specs=P(axis, None))

    def rhs(t, u, params):
        return fn(u, params)

    return rhs


# ---------------------------------------------------------------------------
# tensor-parallel KAN chain over the grid axis (PDE-surrogate sharding)
# ---------------------------------------------------------------------------
#
# The PDE *surrogate* RHS is not a stencil: the whole grid state is one
# KAN input vector ([402,10,402] for Schrödinger,
# `Schrodinger_Surrogate.jl:93-96`), so halo exchange does not apply.
# The sharding is a tensor-parallel contraction instead:
#
#   layer 1 (N -> H): shard the INPUT dim. Each device holds C1/W1 rows
#     for its grid shard, computes its partial contribution to the
#     H-vector, and one psum over the grid axis produces the (small,
#     replicated) hidden activation — the only collective per RHS eval.
#   layer 2 (H -> N): shard the OUTPUT dim. Each device computes its own
#     output rows from the replicated hidden vector; the result is the
#     next sharded grid state. Zero communication.
#
# Per RK stage the wire cost is one psum of an H-vector (H=10), which
# rides the interconnect; compute and memory traffic scale as
# N/n_devices per device.


def chain_param_specs(model, axis: str = "sp") -> list[dict]:
    """PartitionSpecs for a 2-layer KDense chain under grid-TP sharding:
    layer-1 params sharded along the input (grid) dim, layer-2 along the
    output (grid) dim."""
    if len(model.layers) != 2:
        raise ValueError("grid-TP sharding expects a 2-layer chain "
                         f"(got {len(model.layers)} layers)")
    l1, l2 = model.layers
    for l in (l1, l2):
        if getattr(l, "trainable_grid", False):
            raise ValueError("trainable_grid is not supported sharded")
    s1 = {"C": P(axis, None, None)}
    if l1.use_base_act:
        s1["W"] = P(axis, None)
    s2 = {"C": P(None, None, axis)}
    if l2.use_base_act:
        s2["W"] = P(None, axis)
    return [s1, s2]


def shard_chain_params(mesh: Mesh, model, params, axis: str = "sp"):
    """device_put a 2-layer chain's params with the grid-TP shardings."""
    specs = chain_param_specs(model, axis)
    # specs subtrees (PartitionSpec) are matched up-to params' leaves
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        params, specs)


def chain_local_apply(model, n_shards: int, axis: str = "sp") -> Callable:
    """Per-device body of the grid-TP chain forward, for use INSIDE a
    shard_map whose mesh has `axis` of size `n_shards`.

    Returns local(params_local, x_local) -> y_local where x/y are the
    device-local grid shards [..., N/n] and params_local are the shards
    described by `chain_param_specs`. Exact math parity with
    `model.apply` up to f32 reduction order (layer 1 sums partials via
    psum instead of one long contraction).
    """
    l1, l2 = model.layers
    if l1.in_dims % n_shards or l2.out_dims % n_shards:
        raise ValueError(
            f"grid dims ({l1.in_dims}, {l2.out_dims}) must be divisible "
            f"by the '{axis}' mesh axis size {n_shards}")
    l1_loc = dataclasses.replace(l1, in_dims=l1.in_dims // n_shards)
    l2_loc = dataclasses.replace(l2, out_dims=l2.out_dims // n_shards)

    def local(params, x_loc: Array) -> Array:
        p1, p2 = params
        h = lax.psum(l1_loc.apply(p1, x_loc), axis)
        return l2_loc.apply(p2, h)

    return local


def sharded_laplacian_dirichlet(mesh: Mesh, dx: float, axis: str = "sp",
                                left: float = 0.0, right: float = 0.0):
    """Dirichlet-ghost centered Laplacian on a grid sharded along `axis`:
    interior shards exchange halos; the first/last shard substitute the
    boundary values."""

    def local(u_local: Array) -> Array:
        n = lax.psum(1, axis)
        idx = lax.axis_index(axis)
        lg, rg = halo_exchange(u_local, axis)
        lg = jnp.where(idx == 0, jnp.full_like(lg, left), lg)
        rg = jnp.where(idx == n - 1, jnp.full_like(rg, right), rg)
        up = jnp.concatenate([lg, u_local, rg])
        return (up[2:] - 2.0 * up[1:-1] + up[:-2]) / (dx * dx)

    return shard_map(local, mesh=mesh, in_specs=P(axis), out_specs=P(axis))
