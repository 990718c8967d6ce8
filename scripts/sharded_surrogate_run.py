"""Committed multi-device training run of the Schrödinger surrogate
(VERDICT r2 #1 "Done" criterion): `SurrogateConfig(mesh=(dp, sp))` at
FULL problem size ([402,10,402] grid 10) on the virtual 8-device CPU
mesh — the grid axis tensor-parallel over sp=2 (one psum of the hidden
vector per RHS eval) and the 8 shooting segments data-parallel over
dp=4 — with the single-device path run at identical iterations for a
loss-parity record.

The virtual CPU mesh exercises the identical GSPMD/shard_map program
a multi-GPU mesh runs (`chip_smoke.py --multichip` runs it on cards). Artifact: artifacts/sharded_surrogate_run.json.
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np

from kanodes.experiments.pde_surrogate import SurrogateConfig, run

# usage: python scripts/sharded_surrogate_run.py [schrodinger|allen_cahn_2d]
PROBLEM = sys.argv[1] if len(sys.argv) > 1 else "schrodinger"
RUNS = {
    # full-size Schrödinger: [402,10,402]
    "schrodinger": dict(iters=200, substeps=8, state=402, suffix=""),
    # beyond parity: 2-D full-state chain [1024,10,1024] (heavier per
    # iter on the single-core virtual mesh -> fewer iters)
    "allen_cahn_2d": dict(iters=60, substeps=2, state=1024, suffix="_2d"),
}
spec = RUNS[PROBLEM]
ITERS = spec["iters"]
base = SurrogateConfig(problem=PROBLEM, solve_mode="shooting",
                       substeps=spec["substeps"], iters=ITERS,
                       eval_every=ITERS // 4, impl="xla")

t0 = time.time()
out_single = run(base)
t_single = time.time() - t0
print(f"single-device: loss {float(out_single['loss_history'][-1]):.6e} "
      f"({t_single:.0f}s)", flush=True)

t0 = time.time()
out_mesh = run(dataclasses.replace(base, mesh=(4, 2)))
t_mesh = time.time() - t0
h_s = np.asarray(out_single["loss_history"])
h_m = np.asarray(out_mesh["loss_history"])
rel = np.abs(h_m - h_s) / (np.abs(h_s) + 1e-30)
# per-step sharded/unsharded parity is exact to f32 rounding (test-
# asserted); over hundreds of Adam steps those last-ulp differences
# compound chaotically, so the parity METRIC here is the early prefix
# and the end-of-run losses are reported as training equivalence
rel10 = float(np.max(rel[:10]))
c1 = out_mesh["params"][0]["C"]
result = {
    "problem": PROBLEM, "state_dim": spec["state"], "mesh": [4, 2],
    "iters": ITERS,
    "single_final_loss": float(h_s[-1]),
    "mesh_final_loss": float(h_m[-1]),
    "rel_loss_divergence_first10": rel10,
    "rel_loss_divergence_full": float(np.max(rel)),
    "layer1_C_devices": len(c1.sharding.device_set),
    "single_wall_s": round(t_single, 1),
    "mesh_wall_s_virtual_cpu": round(t_mesh, 1),
    "note": ("virtual 8-device CPU mesh (single physical core): wall "
             "times measure correctness, not speedup; the sharded "
             "program is the one a real dp x sp device mesh would run. "
             "Full-history divergence is f32 reduction-order chaos "
             "compounded over Adam steps; step-level parity is "
             "asserted by tests/test_pde.py"),
}
os.makedirs("artifacts", exist_ok=True)
with open(f"artifacts/sharded_surrogate_run{spec['suffix']}.json",
          "w") as f:
    json.dump(result, f, indent=1)
print(json.dumps(result, indent=1))
assert rel10 < 1e-3, rel10
