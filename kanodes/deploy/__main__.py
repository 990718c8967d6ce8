"""Checkpoint -> serving artifact CLI.

    python -m kanodes.deploy --checkpoint ckpt_dir --kind trajectory \
        --t1 3.4 --nt 35 --batch any --out lv.kexp

Restores a `train.checkpoint.Checkpointer` directory, rebuilds the model
from the `model_spec` stored in `TrainState.extra` (see `deploy/spec.py`;
override with --spec for older checkpoints), and writes a self-contained
StableHLO artifact with the chosen parameters baked in. Completes the
train -> checkpoint -> deploy path the reference approximates by
re-running training scripts against .mat checkpoints
(`LV_driver_KANODE.jl:146-160`).
"""

from __future__ import annotations

import argparse
import json
import sys


def _params_from_state(state: dict, which: str):
    import jax.numpy as jnp
    import jax

    if which == "best" and state.get("best_params") is not None:
        tree = state["best_params"]
    else:
        tree = state["params"]
    return jax.tree_util.tree_map(jnp.asarray, tree)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kanodes.deploy",
        description="Export a training checkpoint as a serving artifact.")
    ap.add_argument("--checkpoint", default=None,
                    help="Checkpointer directory")
    ap.add_argument("--npy", default=None,
                    help="alternative to --checkpoint: a pickled-pytree "
                         "params .npy (the experiment scripts' "
                         "*_params.npy artifacts); requires --spec")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--params", choices=("best", "last"), default="best",
                    help="use best_params (if stored) or last params")
    ap.add_argument("--kind", choices=("rhs", "field", "trajectory"),
                    default="trajectory")
    ap.add_argument("--spec", default=None,
                    help="JSON model spec override (else read from "
                         "checkpoint extra['model_spec'])")
    ap.add_argument("--out", required=True, help="output artifact path")
    ap.add_argument("--batch", default=None,
                    help="batch dim: int, 'any' (symbolic), or omit")
    ap.add_argument("--t0", type=float, default=0.0)
    ap.add_argument("--t1", type=float, default=3.4)
    ap.add_argument("--nt", type=int, default=35,
                    help="number of save points incl. t0")
    ap.add_argument("--solver", default="tsit5")
    ap.add_argument("--substeps", type=int, default=1)
    ap.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated lowering targets")
    ap.add_argument("--on", default=None, metavar="PLATFORM",
                    help="jax platform to RUN the export on (e.g. 'cpu'; "
                         "lowering needs no accelerator, so exporting on "
                         "cpu is always safe)")
    args = ap.parse_args(argv)

    import jax

    if args.on:
        jax.config.update("jax_platforms", args.on)

    import jax.numpy as jnp

    from kanodes.deploy import (export_field, export_rhs,
                                export_trajectory)
    from kanodes.deploy.spec import model_from_spec
    from kanodes.train.checkpoint import Checkpointer

    if (args.checkpoint is None) == (args.npy is None):
        print("error: pass exactly one of --checkpoint / --npy",
              file=sys.stderr)
        return 2
    if args.npy is not None:
        if args.spec is None:
            print("error: --npy needs --spec (a bare params file has "
                  "no stored model spec)", file=sys.stderr)
            return 2
        import numpy as np
        tree = np.load(args.npy, allow_pickle=True)
        if getattr(tree, "shape", None) == ():
            tree = tree.item()
        state = {"params": tree, "step": 0}
    else:
        state = Checkpointer(args.checkpoint).restore(args.step)
    if args.spec is not None:
        spec = json.loads(args.spec)
    else:
        extra = state.get("extra") or {}
        spec = extra.get("model_spec")
        if spec is None and "pinn_cfg" in extra:
            # PINN checkpoints carry the full PINNConfig; the model
            # spec is its (widths, n_basis, trainable_centers) slice.
            pc = extra["pinn_cfg"]
            spec = {"kind": "kanpinn", "widths": list(pc["widths"]),
                    "n_basis": int(pc["n_basis"]),
                    "trainable_centers": bool(pc["trainable_centers"])}
        if spec is None:
            print("error: checkpoint has no extra['model_spec']; "
                  "pass --spec", file=sys.stderr)
            return 2
    model = model_from_spec(spec)
    params = _params_from_state(state, args.params)

    batch = args.batch
    if batch is not None and batch != "any":
        batch = int(batch)
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p)

    if args.kind == "rhs":
        # export_rhs: batch=None already means a symbolic batch dim
        art = export_rhs(model, params,
                         batch=None if batch == "any" else batch,
                         platforms=platforms)
    elif args.kind == "field":
        art = export_field(model, params,
                           batch=None if batch == "any" else batch,
                           platforms=platforms)
    else:
        ts = jnp.linspace(args.t0, args.t1, args.nt)
        art = export_trajectory(model, params, ts, solver=args.solver,
                                substeps=args.substeps, batch=batch,
                                platforms=platforms)
    art.save(args.out)
    print(json.dumps({"out": args.out, "kind": args.kind,
                      "spec": spec, "step": int(state.get("step", 0)),
                      "params": args.params,
                      "platforms": list(platforms)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
