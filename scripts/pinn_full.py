"""Full strain-limiting KAN-PINN run with per-epoch device-side
adaptive residual resampling (VERDICT round-1 #10 gate check).

Round-1's gate-passing run (artifacts/pinn_diagnostics.json, 547 s,
18.8 ep/s) trained without adaptive resampling. This run turns on the
in-scan jax.lax.top_k adaptive picks (n_adaptive=256 from a fresh
1024-candidate pool per epoch — the reference's topk semantics,
StrainLimiting_KAN_PINN.py:400-431) and re-checks all 5 acceptance
gates plus epochs/s.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from kanodes.pinn.train import PINNConfig, train, cross_verification
from kanodes.diag.gates import evaluate, report

cfg = PINNConfig(adam_epochs=6000, finetune_epochs=4000,
                 n_adaptive=256, adaptive_candidates=1024)
t0 = time.time()
out = train(cfg, verbose=True)
dt = time.time() - t0
diag = cross_verification(out)
res = evaluate(diag)
print(report(res))
payload = {**diag, "epochs": 10000, "wall_s": round(dt, 1),
           "epochs_per_s": round(10000 / dt, 2),
           "n_adaptive": cfg.n_adaptive,
           "adaptive_candidates": cfg.adaptive_candidates,
           "all_gates_pass": bool(res["passed"])}
with open("artifacts/pinn_adaptive_diagnostics.json", "w") as f:
    json.dump(payload, f, indent=1)
arr = np.empty((), dtype=object)
arr[()] = jax.tree_util.tree_map(np.asarray, out["best_params"])
np.save("artifacts/pinn_adaptive_best_params.npy", arr, allow_pickle=True)
print(json.dumps({k: v for k, v in payload.items()
                  if k != "boundary_mse"}))
