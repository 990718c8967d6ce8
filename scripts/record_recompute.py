"""Record backend-keyed recompute expectations for the deep claims.

The deep tier of the claims ledger (`diag/claims.py --deep`) reloads
every deliverable param file and recomputes the headline MSEs. Those
recomputes are backend-sensitive at the f32 floor (CPU vs GPU forward
rounding: 25-30% at the 1e-8 LV floor, up to ~4x at the 1e-14 surrogate
floor), so the expectations are stored PER BACKEND in each artifact —
this script measures them on whatever backend it runs on and writes
them under row["recompute"][<cpu|gpu>]. Run it once per backend after
any change to the deliverable params or the forward-path code:

    python scripts/record_recompute.py            # current backend
    (run on both CPU and GPU so both keys exist)

It also records, for the floor-level records, the recompute on the
step grid they were trained on (row["recompute"][backend]
["record_flow_mse"]); the deep check compares that value with the
claimed record itself, not with the stored one.

CPU runs force the platform the CLAUDE.md way (config update after
import; env overrides are ignored): pass --cpu.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
from kanodes.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from kanodes.diag.claims import (REPO, _backend, _by, _lv_recompute,
                                 _surrogate_recompute,
                                 _surrogate_recompute_record_flow)


def _update(rel: str, match_key: str, match_val: str, values: dict):
    path = os.path.join(REPO, rel)
    with open(path) as f:
        rows = json.load(f)
    row = _by(match_key, match_val, rows)
    rec = row.setdefault("recompute", {})
    rec.setdefault(_backend(), {}).update(values)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")
    print(f"{rel} [{match_val}] recompute[{_backend()}] <- {values}")


def main():
    b = _backend()
    print(f"backend: {b} ({jax.devices()[0].device_kind})")

    for basis in ("rbf", "iqf"):
        train, test = _lv_recompute(basis)
        _update("artifacts/lv_best.json", "basis", basis,
                {"train_mse": train, "test_mse": test})

    _update("artifacts/surrogate_best.json", "problem", "burgers",
            {"snapshot_mse": _surrogate_recompute("burgers")})

    records = [
        ("artifacts/surrogate_fast_seed1.json", "schrodinger",
         "artifacts/schrodinger_fast_seed1_polished_params.npy"),
        ("artifacts/surrogate_fast_seed4.json", "allen_cahn_2d",
         "artifacts/allen_cahn_2d_fast_seed4_polished_params.npy"),
    ]
    for rel, problem, params_rel in records:
        vals = {"snapshot_mse": _surrogate_recompute(problem, params_rel),
                "record_flow_mse": _surrogate_recompute_record_flow(
                    problem, params_rel)}
        _update(rel, "problem", problem, vals)


if __name__ == "__main__":
    main()
