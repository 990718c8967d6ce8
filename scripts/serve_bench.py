"""Serving-throughput benchmark for the deploy artifacts (beyond parity).

The reference has no serving story (its deployment unit is "re-run the
training script with a checkpoint", `LV_driver_KANODE.jl:146-160`).
This measures what the exported StableHLO artifacts
(`kanodes/deploy/export.py`) sustain on one accelerator:

- RHS evaluator with a SYMBOLIC batch dim: KAN RHS evals/s at serving
  batch sizes (the "KAN RHS evals/sec/chip" north-star metric from
  BASELINE.json, on the serving path instead of the training path).
- Fleet trajectory artifact: full 34-step Tsit5 rollouts/s for a batch
  of initial conditions (the batched-IC export from
  `deploy/export.export_trajectory(batch="any")`).

Writes artifacts/serve_bench.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from kanodes.deploy import export_rhs, export_trajectory  # noqa: E402
from kanodes.models import KDense  # noqa: E402
from kanodes.models.core import Chain  # noqa: E402

OUT = "artifacts/serve_bench.json"


def main():
    model = Chain(KDense(2, 10, 5), KDense(10, 2, 5))
    params = model.init(jax.random.PRNGKey(0))
    recs = []

    # 1) RHS evaluator, symbolic batch — evals/s at serving batch sizes.
    art = export_rhs(model, params)
    for B in (8192, 65536, 262144):
        x = jnp.asarray(np.random.default_rng(0).normal(0, 0.5, (B, 2)),
                        jnp.float32)
        art(x).block_until_ready()  # compile
        n = 200
        t0 = time.time()
        for _ in range(n):
            y = art(x)
        y.block_until_ready()
        dt = time.time() - t0
        rec = {"kind": "rhs", "batch": B,
               "evals_per_s": round(n * B / dt),
               "us_per_call": round(dt / n * 1e6)}
        print(rec, flush=True)
        recs.append(rec)

    # 2) Fleet trajectory: B ICs x 34-step Tsit5 rollout per call.
    ts = jnp.linspace(0.0, 3.4, 35)
    traj = export_trajectory(model, params, ts, substeps=1, batch="any")
    for B in (1024, 8192):
        u0s = jnp.asarray(
            np.random.default_rng(1).uniform(0.5, 1.5, (B, 2)), jnp.float32)
        traj(u0s).block_until_ready()
        n = 50
        t0 = time.time()
        for _ in range(n):
            y = traj(u0s)
        y.block_until_ready()
        dt = time.time() - t0
        rec = {"kind": "trajectory_fleet", "batch": B, "steps": 34,
               "rollouts_per_s": round(n * B / dt),
               "ms_per_call": round(dt / n * 1e3, 2)}
        print(rec, flush=True)
        recs.append(rec)

    with open(OUT, "w") as f:
        json.dump(recs, f, indent=1)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
