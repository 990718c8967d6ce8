"""Serving export: trained models as portable StableHLO artifacts.

The reference ships research scripts whose only "deployment" story is
re-running Julia/PyTorch with a .mat/.jls checkpoint next to the source
tree (`LV_driver_KANODE.jl:146-160`, `StrainLimiting_KAN_PINN.py:1616`).
For production serving a trained KAN-ODE should be a *self-contained
compiled artifact*: no Python model class, no parameter files, no
version-matched training code at load time.

This module exports jitted inference functions through `jax.export`
(StableHLO + VHLO serialization, which carries JAX's cross-version
compatibility guarantees) with the trained parameters BAKED IN as
constants — the artifact is one file that any JAX process (CPU or GPU)
can load and call:

    art = export_trajectory(model, params, ts)        # train side
    art.save("lv_model.kexp")
    ...
    art = ServingArtifact.load("lv_model.kexp")       # serve side
    ys = art(u0)                                      # [T, D] rollout

Design notes:
- Exports use the pure-XLA compute path (`model.apply` +
  `ode.odeint_fixed`), not the Triton kernels: kernel custom-calls are
  device-specific, while StableHLO-only artifacts stay portable across
  CPU/GPU and compiler versions.
- The batch dimension of the RHS evaluator may be SYMBOLIC
  (`batch=None`), so one artifact serves any batch size; everything
  else is static shapes, as XLA wants.
- `platforms=("cpu", "cuda")` (the default) lowers once per platform
  into the same artifact, so the file exported on a CPU dev box runs
  unchanged on the serving GPUs.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
from jax import export as jax_export

_MAGIC = b"KANODESRV1"
_DEFAULT_PLATFORMS = ("cpu", "cuda")


@dataclasses.dataclass
class ServingArtifact:
    """A serialized, self-contained inference function.

    `blob` is the `jax.export` VHLO payload (parameters baked in);
    `meta` is a small JSON-able dict describing what the function is
    (kind, shapes, solver, time grid) for serving-side introspection.
    """

    blob: bytes
    meta: dict[str, Any]
    _fn: Callable | None = dataclasses.field(default=None, repr=False)

    def __call__(self, *args):
        if self._fn is None:
            exported = jax_export.deserialize(self.blob)
            self._fn = exported.call
        return self._fn(*args)

    # -- file format: MAGIC | u32 header length | JSON header | blob --
    def save(self, path: str) -> None:
        header = json.dumps(self.meta, sort_keys=True).encode()
        with open(path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack(">I", len(header)))
            f.write(header)
            f.write(self.blob)

    @classmethod
    def load(cls, path: str) -> "ServingArtifact":
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a kanodes serving artifact")
            (hlen,) = struct.unpack(">I", f.read(4))
            meta = json.loads(f.read(hlen).decode())
            blob = f.read()
        return cls(blob=blob, meta=meta)

    @property
    def platforms(self) -> tuple[str, ...]:
        return tuple(self.meta.get("platforms", ()))


def _resolve_platforms(platforms: Sequence[str] | None) -> tuple[str, ...]:
    if platforms is None:
        return _DEFAULT_PLATFORMS
    return tuple(platforms)


def export_fn(fn: Callable, example_args: tuple, meta: dict[str, Any],
              platforms: Sequence[str] | None = None) -> ServingArtifact:
    """Export an arbitrary jittable function (already closed over its
    parameters) for the given abstract/sample args."""
    plats = _resolve_platforms(platforms)
    exported = jax_export.export(jax.jit(fn), platforms=plats)(*example_args)
    meta = dict(meta)
    meta["platforms"] = list(plats)
    meta["format"] = "jax_export/vhlo"
    return ServingArtifact(blob=exported.serialize(), meta=meta)


def export_rhs(model, params, batch: int | None = None,
               platforms: Sequence[str] | None = None) -> ServingArtifact:
    """Export the learned RHS evaluator x [B, in_dims] -> dx [B, out_dims].

    batch=None exports a SYMBOLIC batch dimension — one artifact serves
    any batch size; an int pins it statically.
    """
    params = jax.device_get(params)

    def f(x):
        return model.apply(params, x)

    if batch is None:
        (b,) = jax_export.symbolic_shape("b")
        spec_shape: tuple = (b, model.in_dims)
    else:
        spec_shape = (int(batch), model.in_dims)
    spec = jax.ShapeDtypeStruct(spec_shape, jnp.float32)
    return export_fn(f, (spec,), {
        "kind": "rhs",
        "in_dims": model.in_dims,
        "out_dims": model.out_dims,
        "batch": "symbolic" if batch is None else int(batch),
    }, platforms)


def export_field(model, params, batch: int | None = None,
                 platforms: Sequence[str] | None = None) -> ServingArtifact:
    """Export a pointwise field network x [B, in_dims] -> y [B, out_dims]
    (e.g. the trained KAN-PINN displacement potential,
    `StrainLimiting_KAN_PINN.py:188-227`) — same payload as
    `export_rhs`, tagged kind="field" for serving-side dispatch."""
    art = export_rhs(model, params, batch, platforms)
    art.meta["kind"] = "field"
    return art


def export_trajectory(model, params, ts, solver: str = "tsit5",
                      substeps: int = 1,
                      batch: int | str | None = None,
                      platforms: Sequence[str] | None = None
                      ) -> ServingArtifact:
    """Export the full rollout u0 -> ys over the STATIC save grid `ts`
    (fixed-step `solver` with `substeps` substeps per save interval —
    the deterministic serving analogue of the training-side integrator).

    batch=None: u0 [in_dims] -> ys [T, in_dims] (single rollout).
    batch=int or "any" (symbolic): u0 [B, in_dims] -> ys [T, B, in_dims]
    — a fleet of initial conditions integrated in one call, the shape
    serving actually wants."""
    from kanodes.ode import odeint_fixed

    if model.in_dims != model.out_dims:
        # an ODE RHS maps state -> state; a mismatched model would
        # silently broadcast inside the integrator (use export_field
        # for field networks like the PINN potential)
        raise ValueError(
            f"export_trajectory needs in_dims == out_dims, got "
            f"{model.in_dims} -> {model.out_dims}; use export_field "
            f"for non-square networks")

    params = jax.device_get(params)
    ts = jnp.asarray(ts, jnp.float32)

    if batch is None:
        def rhs(t, u, _):
            return model.apply(params, u[None, :])[0]
        spec_shape: tuple = (model.in_dims,)
    else:
        def rhs(t, u, _):
            return model.apply(params, u)
        if batch == "any":
            (b,) = jax_export.symbolic_shape("b")
            spec_shape = (b, model.in_dims)
        else:
            spec_shape = (int(batch), model.in_dims)

    def f(u0):
        return odeint_fixed(rhs, u0, ts, None, solver=solver,
                            substeps=substeps)

    spec = jax.ShapeDtypeStruct(spec_shape, jnp.float32)
    return export_fn(f, (spec,), {
        "kind": "trajectory",
        "in_dims": model.in_dims,
        "batch": ("none" if batch is None
                  else "symbolic" if batch == "any" else int(batch)),
        "n_save": int(ts.shape[0]),
        "t0": float(ts[0]),
        "t1": float(ts[-1]),
        "solver": solver,
        "substeps": int(substeps),
    }, platforms)


def export_graybox_trajectory(model, params, lap, D: float, ts,
                              solver: str = "tsit5", substeps: int = 1,
                              platforms: Sequence[str] | None = None
                              ) -> ServingArtifact:
    """Export a gray-box PDE rollout u0 [N] -> ys [len(ts), N] for
    du/dt = D*lap@u + kan.(u) (the source-recovery model family,
    `Fisher-KPP_Source.jl:95-98`); lap/D are baked static physics."""
    from kanodes.ode import odeint_fixed
    from kanodes.utils.precision import matmul_precision

    params = jax.device_get(params)
    lap = jnp.asarray(jax.device_get(lap), jnp.float32)
    ts = jnp.asarray(ts, jnp.float32)
    n = int(lap.shape[0])

    def rhs(t, u, _):
        known = D * jnp.matmul(lap, u, precision=matmul_precision())
        return known + model.apply(params, u[:, None])[:, 0]

    def f(u0):
        return odeint_fixed(rhs, u0, ts, None, solver=solver,
                            substeps=substeps)

    spec = jax.ShapeDtypeStruct((n,), jnp.float32)
    return export_fn(f, (spec,), {
        "kind": "graybox_trajectory",
        "grid_points": n,
        "D": float(D),
        "n_save": int(ts.shape[0]),
        "solver": solver,
        "substeps": int(substeps),
    }, platforms)
