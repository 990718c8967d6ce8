"""Model export for serving.

The reference has no serving story (research scripts); this framework is
meant to be deployable, so trained models can be serialized as
platform-retargetable StableHLO artifacts via `jax.export`:

    blob = export_forward(model, params, example_input)
    f = load_forward(blob)            # any process, any backend
    y = f(params, x)

Covers the two serving shapes this workload has: pointwise model
evaluation (the KAN itself) and full trajectory rollout (model + fixed
solver), both closed over static configuration.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def export_forward(apply_fn, params, example_x: Array) -> bytes:
    """Serialize `apply_fn(params, x)` to a StableHLO artifact."""
    from jax import export as jexport

    fn = jax.jit(apply_fn)
    exp = jexport.export(fn)(
        jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params),
        jax.ShapeDtypeStruct(example_x.shape, example_x.dtype))
    return bytes(exp.serialize())


def load_forward(blob: bytes):
    """Deserialize an exported forward; returns f(params, x)."""
    from jax import export as jexport

    exp = jexport.deserialize(blob)
    return lambda params, x: exp.call(params, x)


def export_rollout(model, ts: Array, example_u0: Array, params,
                   solver: str = "tsit5", substeps: int = 1) -> bytes:
    """Serialize a full trajectory rollout u0 -> [T, dim]."""
    from kanodes.ode import odeint_fixed

    ts = jnp.asarray(ts)

    def rollout(params, u0):
        def rhs(t, u, p):
            return model.apply(p, u)

        return odeint_fixed(rhs, u0, ts, params, solver=solver,
                            substeps=substeps)

    return export_forward(rollout, params, example_u0)
