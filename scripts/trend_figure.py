"""Regenerate the Fig-3C param-efficiency trend figure from committed
artifacts (reference: `trend_plotter.py:7-35`).

Series:
  * KAN-ODE d=2   — `sweep_results.json` (full-fidelity sweep points)
  * KAN-ODE d=3   — `sweep_results.json` (beyond-parity [2,w,w,2] rows,
                    `scripts/kan3_trend.py`; no reference counterpart)
  * MLP-NODE d=2  — `artifacts/mlp_full_budget.json` (full 1e5-iter runs)
  * MLP-NODE d=3  — `artifacts/mlp3_full_budget.json` (full 1e5-iter runs)
plus the reference's published points for the three reference series.

Pure-host work (matplotlib + json); no accelerator needed.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from kanodes.diag.plots import trend_plot
from kanodes.experiments.sweep import (
    REFERENCE_KAN_TREND, REFERENCE_MLP_TREND, REFERENCE_MLP3_TREND)

results = []

with open("sweep_results.json") as f:
    for r in json.load(f):
        if r["model"] == "kan":
            results.append({"model": "kan", "depth": r.get("depth", 2),
                            "n_params": r["n_params"],
                            "train_loss": r["train_loss"]})

for path, depth in (("artifacts/mlp_full_budget.json", 2),
                    ("artifacts/mlp3_full_budget.json", 3)):
    with open(path) as f:
        for n, row in json.load(f).items():
            results.append({"model": "mlp", "depth": depth,
                            "n_params": int(n),
                            "train_loss": row["best_train_mse"]})

out = "artifacts/figures/param_efficiency_trend.png"
trend_plot(results, out, reference={
    "kan": REFERENCE_KAN_TREND,
    "mlp": REFERENCE_MLP_TREND,
    "mlp_d3": REFERENCE_MLP3_TREND,
})
print(f"wrote {out} with {len(results)} measured points")
