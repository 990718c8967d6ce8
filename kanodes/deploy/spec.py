"""Serializable model specs: rebuild an inference model from a checkpoint.

The reference's checkpoints carry the network shape next to the weights
(`size_KAN` in the .mat files, `LV_driver_KANODE.jl:252-272`) so that
post-hoc tools (`Plotting_standard.jl:76-110`, `Symbolic_reg.jl:85-118`)
can rebuild the model without the training script's constants. This is
the same capability for this framework's checkpoints: a small JSON-able
dict that names the model family and its static constructor arguments,
saved in `TrainState.extra["model_spec"]` and consumed by the
checkpoint -> serving-artifact CLI (`python -m kanodes.deploy`).

Only static Python scalars go in a spec — parameters stay in the
checkpoint pytree; anything else would break `jax.export` baking.
"""

from __future__ import annotations

from typing import Any


def spec_of(model) -> dict[str, Any]:
    """Derive the spec dict from a live model object."""
    from kanodes.models import (MLP, BSplineKANChain, KANChain)
    from kanodes.models.bspline import BSplineKAN
    from kanodes.models.kdense import KDense

    if isinstance(model, KANChain) and all(
            isinstance(l, KDense) for l in model.layers):
        l0 = model.layers[0]
        if not isinstance(l0.basis, str):
            raise TypeError(
                "spec_of cannot serialize a callable basis; use a "
                "named basis ('rbf'/'rswaf'/'iqf') for checkpoint->"
                "deploy rebuilds")
        # the spec records layer-0 attrs chain-wide; a heterogeneous
        # chain would rebuild silently wrong
        for k in ("grid_len", "basis", "normalizer", "grid_lims",
                  "denominator", "base_act", "use_base_act",
                  "trainable_grid"):
            vals = {getattr(l, k) for l in model.layers}
            if len(vals) != 1:
                raise ValueError(
                    f"spec_of needs homogeneous KDense layers; "
                    f"attribute {k!r} differs across layers: {vals}")
        widths = [model.layers[0].in_dims] + [
            l.out_dims for l in model.layers]
        return {
            "kind": "kan",
            "widths": widths,
            "grid_len": l0.grid_len,
            "basis": l0.basis,
            "normalizer": l0.normalizer,
            "grid_lims": list(l0.grid_lims),
            "denominator": l0.denominator,
            "base_act": l0.base_act,
            "use_base_act": l0.use_base_act,
            "trainable_grid": l0.trainable_grid,
        }
    if isinstance(model, MLP):
        return {
            "kind": "mlp",
            "widths": list(model.widths),
            "activation": model.activation,
            "final_activation": model.final_activation,
            "use_bias": model.use_bias,
        }
    if isinstance(model, BSplineKANChain) and all(
            isinstance(l, BSplineKAN) for l in model.layers):
        l0 = model.layers[0]
        for k in ("grid_size", "spline_order"):
            vals = {getattr(l, k) for l in model.layers}
            if len(vals) != 1:
                raise ValueError(
                    f"spec_of needs homogeneous BSplineKAN layers; "
                    f"attribute {k!r} differs across layers: {vals}")
        widths = [model.layers[0].in_dims] + [
            l.out_dims for l in model.layers]
        return {
            "kind": "bspline_kan",
            "widths": widths,
            "grid_size": l0.grid_size,
            "spline_order": l0.spline_order,
        }
    from kanodes.pinn.model import KANPINN
    if isinstance(model, KANPINN):
        return {
            "kind": "kanpinn",
            "widths": list(model.widths),
            "n_basis": model.n_basis,
            "trainable_centers": model.trainable_centers,
        }
    raise TypeError(f"no spec rule for model type {type(model).__name__}")


def model_from_spec(spec: dict[str, Any]):
    """Rebuild a model object from `spec_of` output (or hand-written)."""
    from kanodes.models import (MLP, BSplineKANChain, KANChain)

    kind = spec["kind"]
    if kind == "kan":
        kw = {}
        for k in ("basis", "normalizer", "denominator", "base_act",
                  "use_base_act", "trainable_grid"):
            if k in spec:
                kw[k] = spec[k]
        if "grid_lims" in spec:
            kw["grid_lims"] = tuple(spec["grid_lims"])
        return KANChain.mlp_like(list(spec["widths"]),
                                 grid_len=spec["grid_len"], **kw)
    if kind == "mlp":
        kw = {}
        for k in ("activation", "final_activation", "use_bias"):
            if k in spec:
                kw[k] = spec[k]
        return MLP(tuple(spec["widths"]), **kw)
    if kind == "bspline_kan":
        kw = {}
        for k in ("grid_size", "spline_order"):
            if k in spec:
                kw[k] = spec[k]
        return BSplineKANChain(list(spec["widths"]), **kw)
    if kind == "kanpinn":
        from kanodes.pinn.model import KANPINN
        kw = {}
        for k in ("n_basis", "trainable_centers"):
            if k in spec:
                kw[k] = spec[k]
        return KANPINN(tuple(spec["widths"]), **kw)
    raise ValueError(f"unknown model spec kind: {kind!r}")
