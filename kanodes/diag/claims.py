"""Claims ledger: every headline number re-derived from its artifact.

The README/EXPERIMENTS tables carry dozens of measured numbers (the
registry below is the authoritative count — `python -m kanodes
claims` prints it). Nothing in the reference guards such claims (its
numbers live in the paper); here
every headline claim is registered with (a) the committed artifact that
evidences it and (b) a derivation from that artifact, and
``python -m kanodes claims`` fails when a doc number and its
artifact disagree — the guard against doc rot.

Two tiers:
  * shallow (default): reload the artifact JSON and compare the derived
    value against the registered claim. Pure host work, milliseconds.
  * --deep: additionally reload the DELIVERABLE param .npy files,
    rebuild the models and recompute the headline MSEs from scratch
    (forward solves on whatever backend is present — CPU in tests).
    This is the "records = params you can reload" doctrine made
    executable.

Tolerances: claims are stored at the precision the docs print (2-3
significant digits), so the default rtol is 1 % of the claimed value;
floor-level recomputations (1e-14 MSEs at f32 eps^2) compare within a
factor instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load_json(rel: str):
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


def _load_params(rel: str):
    return np.load(os.path.join(REPO, rel), allow_pickle=True)[()]


def _by(key: str, val: str, rows: list) -> dict:
    for r in rows:
        if r.get(key) == val:
            return r
    raise KeyError(f"no row with {key}={val!r}")


@dataclasses.dataclass(frozen=True)
class Claim:
    name: str
    doc: str                       # where the number is stated
    artifact: str
    claimed: Any
    derive: Callable[[Any], Any]   # loaded artifact -> derived value
    rtol: float = 1e-2
    deep: bool = False             # needs param reload + recompute


def _cmp(claimed, derived, rtol) -> bool:
    if isinstance(claimed, str):
        return claimed == derived
    if isinstance(claimed, bool):
        return bool(derived) is claimed
    return bool(np.isclose(float(derived), float(claimed),
                           rtol=rtol, atol=0.0))


# --------------------------------------------------------------------------
# deep derivations: reload deliverable params, rebuild, recompute
# --------------------------------------------------------------------------

BACKENDS = ("cpu", "gpu")


def _backend() -> str:
    """Expectation key for backend-keyed deep checks: every deliverable
    artifact stores the recompute value measured on each backend
    (`scripts/record_recompute.py`), and the deep check asserts <=5%
    against the MATCHING backend — cross-backend f32 forward rounding
    (measured 25-30% at the 1e-8 LV floor, up to ~4x at the 1e-14
    surrogate floor) never enters the tolerance."""
    import jax
    backend = jax.default_backend()
    if backend not in BACKENDS:
        raise RuntimeError(f"no stored expectations for backend "
                           f"{backend!r} (known: {BACKENDS})")
    return backend


def _expected(row: dict, field: str):
    """The stored recompute expectation for this backend, or None (not
    recorded yet — the deep check then FAILS with a pointer to the
    recording script rather than passing vacuously)."""
    return row.get("recompute", {}).get(_backend(), {}).get(field)


def _within(got: float, expected, rtol: float = 0.05) -> bool:
    if expected is None:
        return False
    return bool(np.isclose(got, float(expected), rtol=rtol, atol=0.0))


def _lv_recompute(basis: str) -> tuple[float, float]:
    """(train_mse, test_mse) of the committed polished LV params through
    the plain-XLA forward (kernel-parity-tested against the fused path
    the record was measured with)."""
    import dataclasses as dc

    from kanodes.experiments import lv

    cfg = lv.LVConfig(impl="xla", basis=basis)
    data = lv.make_data(cfg)
    model = lv.make_model(cfg)
    params = _load_params(f"artifacts/lv_{basis}_best_polished_params.npy")
    train_loss, test_loss, _ = lv.make_ode_fns(
        dc.replace(cfg, solve_mode="fixed"), model, data)
    return float(train_loss(params)), float(test_loss(params))


def _surrogate_recompute(problem: str, params_rel: str | None = None) -> float:
    """Snapshot MSE of the committed polished surrogate params through
    the plain-XLA forward at the record's solver config."""
    import dataclasses as dc

    from kanodes.experiments.pde_surrogate import (SurrogateConfig,
                                                   make_data,
                                                   make_fns, make_model)

    solver, substeps = {"burgers": ("tsit5", 20)}.get(problem, ("rk4", 24))
    cfg = SurrogateConfig(problem=problem, impl="xla", rk_solver=solver,
                          substeps=substeps, solve_mode="fixed")
    data = make_data(cfg)
    model = make_model(cfg, data)
    params = _load_params(
        params_rel or f"artifacts/{problem}_best_polished_params.npy")
    loss, _, _ = make_fns(cfg, model, data)
    return float(loss(params))


# --------------------------------------------------------------------------
# the ledger
# --------------------------------------------------------------------------

def _claims() -> list[Claim]:
    lv_best = lambda basis, field: (
        lambda a: _by("basis", basis, a)[field])
    sur = lambda prob, field: (lambda a: _by("problem", prob, a)[field])
    return [
        # ---- LV record (README headline row) --------------------------
        Claim("lv_rbf_train_mse", "README: LV best train MSE 1.18e-8",
              "artifacts/lv_best.json", 1.18e-8,
              lv_best("rbf", "polished_train_mse")),
        Claim("lv_rbf_test_mse", "README: LV rbf full-horizon test 6.6e-7",
              "artifacts/lv_best.json", 6.6e-7,
              lv_best("rbf", "polished_test_mse")),
        Claim("lv_iqf_train_mse", "README: LV iqf train 3.9e-8",
              "artifacts/lv_best.json", 3.9e-8,
              lv_best("iqf", "polished_train_mse"), rtol=2e-2),
        Claim("lv_iqf_test_mse", "README: LV iqf test 4.6e-7",
              "artifacts/lv_best.json", 4.6e-7,
              lv_best("iqf", "polished_test_mse")),
        Claim("lv_seeds_beat_reference",
              "README: 8/8 seeds beat the reference loss",
              "artifacts/lv_seed_robustness.json", 8,
              lambda a: a["seeds_beating_reference"], rtol=0.0),
        Claim("lv_seed_median", "README: seed-sweep median best 3.1e-8",
              "artifacts/lv_seed_robustness.json", 3.1e-8,
              lambda a: a["best_traj_train_mse"]["median"]),
        Claim("lv_vmapped_sweep_parity",
              "EXPERIMENTS: vmapped 8-seed sweep median best bitwise "
              "equal to the sequential sweep (3.130522863159513e-08)",
              "artifacts/lv_multiseed_vmapped.json",
              3.130522863159513e-08,
              lambda a: a["best_traj_train_mse"]["median"], rtol=0.0),
        Claim("lv_vmapped_sweep_beats_ref",
              "EXPERIMENTS: vmapped sweep 8/8 seeds beat the reference",
              "artifacts/lv_multiseed_vmapped.json", 8,
              lambda a: a["seeds_beating_reference"], rtol=0.0),
        Claim("lv_packed_sweep_parity",
              "EXPERIMENTS: packed 8-seed sweep median best 3.1249e-8 "
              "(sequential: 3.1305e-8 — equal to f32 rounding)",
              "artifacts/lv_multiseed_packed.json", 3.1249e-8,
              lambda a: a["best_traj_train_mse"]["median"]),
        Claim("lv_packed_sweep_beats_ref",
              "EXPERIMENTS: packed sweep 8/8 seeds beat the reference",
              "artifacts/lv_multiseed_packed.json", 8,
              lambda a: a["seeds_beating_reference"], rtol=0.0),
        Claim("adaptive_members_parity",
              "EXPERIMENTS: packed per-member adaptive loss vector "
              "bitwise-equal to sequential solves at init (device)",
              "artifacts/lv_multiseed_adaptive.json", 0.0,
              lambda a: a["parity_at_init"]["max_rel_loss"], rtol=0.0),
        Claim("trend_packed_beats_ref",
              "EXPERIMENTS: heterogeneous packed trend sweep — 8/8 "
              "Fig-3C KAN sizes beat the reference in ONE device program",
              "artifacts/lv_trend_packed.json", 8,
              lambda a: a["points_beating_reference"], rtol=0.0),
        Claim("trend_packed_polish_no_worse",
              "EXPERIMENTS: packed polish never worsens a member "
              "(per-member best-so-far) — 8/8 polished <= Adam endpoint",
              "artifacts/lv_trend_packed.json", 8,
              lambda a: sum(r["polished_train_loss"]
                            <= r["train_loss"] * (1 + 1e-9)
                            for r in a["results"]), rtol=0.0),
        Claim("trend_packed_polish_best",
              "EXPERIMENTS: packed-polished 240-param member reaches "
              "1.20e-8 train (reference 8.3e-7: 69x)",
              "artifacts/lv_trend_packed.json", 1.20e-8,
              lambda a: min(r["polished_train_loss"]
                            for r in a["results"])),
        Claim("burgers_packed_median",
              "EXPERIMENTS: packed Burgers 5-seed sweep median polished "
              "snapshot MSE 6.2e-13 (all members record-class)",
              "artifacts/burgers_multiseed_packed.json", 6.24e-13,
              lambda a: a["polished_snapshot_mse"]["median"]),
        Claim("lv_adaptive_faithful",
              "README: reference-regime adaptive run (XLA path) 6.6e-7",
              "artifacts/lv_adaptive_full.json", 6.6e-7,
              lambda a: a["best_train_mse"]),
        Claim("lv_adaptive_fused_mse",
              "EXPERIMENTS: whole-adaptive-solve kernel run (kernel since "
              "removed) best 5.69e-7",
              "artifacts/lv_adaptive_fused_full.json", 5.69e-7,
              lambda a: a["best_train_mse"]),
        # ---- MLP baselines (README row; trend_plotter.py anchors) -----
        Claim("mlp52_best", "README: 52-param MLP 2.2e-5",
              "artifacts/mlp_full_budget.json", 2.2e-5,
              lambda a: a["52"]["best_train_mse"], rtol=2e-2),
        Claim("mlp252_best", "README: 252-param MLP 1.26e-5",
              "artifacts/mlp_full_budget.json", 1.26e-5,
              lambda a: a["252"]["best_train_mse"]),
        Claim("mlp502_best", "README: 502-param MLP 6.5e-6",
              "artifacts/mlp_full_budget.json", 6.5e-6,
              lambda a: a["502"]["best_train_mse"]),
        # ---- surrogate records (README rows) ---------------------------
        Claim("burgers_record", "README: Burgers 3.81e-14 deliverable",
              "artifacts/surrogate_best.json", 3.81e-14,
              sur("burgers", "polished_snapshot_mse")),
        Claim("allen_cahn_record", "README: Allen-Cahn 3.49e-15",
              "artifacts/surrogate_best.json", 3.49e-15,
              sur("allen_cahn", "polished_snapshot_mse")),
        Claim("schrodinger_record", "README: Schrödinger seed-0 6.70e-14",
              "artifacts/surrogate_best.json", 6.70e-14,
              sur("schrodinger", "polished_snapshot_mse")),
        Claim("schrodinger_record_seed1",
              "README: Schrödinger record 2.19e-14 (seed-1 fast recipe)",
              "artifacts/surrogate_fast_seed1.json", 2.19e-14,
              sur("schrodinger", "polished_snapshot_mse")),
        Claim("ac2d_record", "README: 2-D AC seed-0 full budget 3.09e-13",
              "artifacts/surrogate_best.json", 3.09e-13,
              sur("allen_cahn_2d", "polished_snapshot_mse")),
        Claim("ac2d_record_seed4",
              "README: 2-D AC record 2.13e-15 (seed-4 fast recipe)",
              "artifacts/surrogate_fast_seed4.json", 2.13e-15,
              sur("allen_cahn_2d", "polished_snapshot_mse")),
        # ---- surrogate seed robustness (README/EXPERIMENTS round 4) ----
        Claim("ssr_allen_cahn_median",
              "EXPERIMENTS: AC 5-seed polished median 6.0e-15",
              "artifacts/surrogate_seed_robustness.json", 6.0e-15,
              lambda a: _by("problem", "allen_cahn",
                            a)["polished_snapshot_mse"]["median"]),
        Claim("ssr_schrodinger_median",
              "EXPERIMENTS: Schrödinger 5-seed polished median 2.4e-14",
              "artifacts/surrogate_seed_robustness.json", 2.4e-14,
              lambda a: _by("problem", "schrodinger",
                            a)["polished_snapshot_mse"]["median"]),
        Claim("ssr_burgers_median",
              "EXPERIMENTS: Burgers 5-seed polished median 3.8e-14",
              "artifacts/surrogate_seed_robustness.json", 3.8e-14,
              lambda a: _by("problem", "burgers",
                            a)["polished_snapshot_mse"]["median"]),
        Claim("ssr_ac2d_median",
              "EXPERIMENTS: 2-D AC 5-seed polished median 3.6e-15",
              "artifacts/surrogate_seed_robustness.json", 3.6e-15,
              lambda a: _by("problem", "allen_cahn_2d",
                            a)["polished_snapshot_mse"]["median"]),
        Claim("ssr_burgers_seed3_full_mse",
              "EXPERIMENTS: Burgers seed-3 (the fast-recipe outlier) "
              "polishes to 6.14e-12 under the full recipe",
              "artifacts/surrogate_best_seed3.json", 6.14e-12,
              lambda a: _by("problem", "burgers",
                            a)["polished_snapshot_mse"]),
        # ---- recovered physics (README rows) ---------------------------
        Claim("fisher2d_recovered", "README: 2-D Fisher-KPP x - 1.0032x^2",
              "artifacts/fisher2d_full.json", "-1.0032*x0**2 + x0",
              lambda a: a["recovered_gp"]),
        Claim("ac2d_recovered", "README: 2-D AC 5.046x - 5.0727x^3",
              "artifacts/ac2d_full.json", "-5.0727*x0**3 + 5.046*x0",
              lambda a: a["recovered_gp"]),
        # ---- PINN (README rows) ----------------------------------------
        Claim("pinn_best_val", "README: PINN best val 0.0124",
              "artifacts/pinn_adaptive_diagnostics.json", 0.0124,
              lambda a: a["best_val"]),
        Claim("pinn_gates", "README: all 5 PINN gates pass",
              "artifacts/pinn_adaptive_diagnostics.json", True,
              lambda a: a["all_gates_pass"]),
        # ---- deep: reload deliverable params, recompute the records ----
        Claim("deep_lv_rbf",
              "lv_best.json reproduces from params: <=5% against the "
              "recompute value stored for THIS backend at record time "
              "(scripts/record_recompute.py), plus record-classness",
              "artifacts/lv_best.json",
              True,
              lambda a: _deep_lv("rbf", _by("basis", "rbf", a)),
              deep=True),
        Claim("deep_lv_iqf",
              "lv_best.json reproduces from params (backend-keyed <=5%)",
              "artifacts/lv_best.json",
              True,
              lambda a: _deep_lv("iqf", _by("basis", "iqf", a)),
              deep=True),
        Claim("deep_burgers",
              "surrogate_best.json reproduces from params: cross-flow "
              "XLA recompute <=5% against this backend's stored value",
              "artifacts/surrogate_best.json",
              True,
              lambda a: _deep_surrogate(
                  "burgers", _by("problem", "burgers", a)),
              deep=True),
        Claim("deep_schrodinger_seed1",
              "surrogate_fast_seed1.json's params reproduce from the "
              "file: cross-flow XLA recompute <=5% against this "
              "backend's stored value",
              "artifacts/surrogate_fast_seed1.json",
              True,
              lambda a: _deep_surrogate(
                  "schrodinger", _by("problem", "schrodinger", a),
                  "artifacts/schrodinger_fast_seed1_polished_params.npy"),
              deep=True),
        Claim("deep_schrodinger_seed1_record",
              "NOT reproduced on the current paths: the 2.19e-14 record "
              "was measured through a since-removed kernel, and the same "
              "step grid through XLA (impl='fused' at this width) gives "
              "~1e-12 from the same params — at this floor the params "
              "fit the rounding of the flow that trained them",
              "artifacts/surrogate_fast_seed1.json",
              False,
              lambda a: _record_reproduced(
                  "schrodinger", _by("problem", "schrodinger", a),
                  "artifacts/schrodinger_fast_seed1_polished_params.npy"),
              deep=True),
        Claim("deep_ac2d_seed4",
              "surrogate_fast_seed4.json's params reproduce from the "
              "file (cross-flow, backend-keyed <=5%)",
              "artifacts/surrogate_fast_seed4.json",
              True,
              lambda a: _deep_surrogate(
                  "allen_cahn_2d", _by("problem", "allen_cahn_2d", a),
                  "artifacts/allen_cahn_2d_fast_seed4_polished_params.npy"),
              deep=True),
        Claim("deep_ac2d_seed4_record",
              "NOT reproduced on the current paths (2.13e-15 record; "
              "same reason as the Schrödinger record)",
              "artifacts/surrogate_fast_seed4.json",
              False,
              lambda a: _record_reproduced(
                  "allen_cahn_2d", _by("problem", "allen_cahn_2d", a),
                  "artifacts/allen_cahn_2d_fast_seed4_polished_params.npy"),
              deep=True),
    ]


def _surrogate_recompute_record_flow(problem: str, params_rel: str) -> float:
    """Snapshot MSE on the step grid the record was trained on:
    impl="fused" at the record's solver config
    (scripts/surrogate_best.py's `cfg_hi`) — every snapshot interval cut
    into steps of the shortest one's."""
    from kanodes.experiments.pde_surrogate import (SurrogateConfig,
                                                   make_data,
                                                   make_fns, make_model)

    solver, substeps = {"burgers": ("tsit5", 20)}.get(problem, ("rk4", 24))
    cfg = SurrogateConfig(problem=problem, impl="fused", rk_solver=solver,
                          substeps=substeps, solve_mode="fixed",
                          bwd_precision="highest")
    data = make_data(cfg)
    model = make_model(cfg, data)
    params = _load_params(params_rel)
    _, snapshot_loss, _ = make_fns(cfg, model, data)
    return float(snapshot_loss(params))


def _deep_lv(basis: str, row: dict) -> bool:
    """Backend-keyed: the artifact stores the recompute value of the
    committed params on EACH backend (`scripts/record_recompute.py`);
    the check asserts <=5% against the matching backend plus
    record-classness (train >=10x under the 8.3e-7 reference trend
    point). A 3x param-file regression now fails on every backend."""
    train, test = _lv_recompute(basis)
    ok = (_within(train, _expected(row, "train_mse"))
          and _within(test, _expected(row, "test_mse"))
          and train < 8.3e-7 / 10.0)
    if not ok:
        print(f"  deep_lv_{basis} [{_backend()}]: recomputed train "
              f"{train:.3e} test {test:.3e} vs stored "
              f"{_expected(row, 'train_mse')} / "
              f"{_expected(row, 'test_mse')} "
              "(missing? run scripts/record_recompute.py)")
    return ok


def _deep_surrogate(problem: str, row: dict,
                    params_rel: str | None = None) -> bool:
    """Backend-keyed <=5% against the stored cross-flow recompute value
    for this backend (the 1e-14-class record itself lives at f32 eps^2
    where cross-backend/cross-flow rounding is a few x — that spread
    was measured ONCE at record time and frozen into the artifact)."""
    mse = _surrogate_recompute(problem, params_rel)
    ok = _within(mse, _expected(row, "snapshot_mse"))
    if not ok:
        print(f"  deep_{problem} [{_backend()}]: recomputed {mse:.3e} "
              f"vs stored {_expected(row, 'snapshot_mse')} "
              "(missing? run scripts/record_recompute.py)")
    return ok


def _record_reproduced(problem: str, row: dict, params_rel: str,
                       rtol: float = 1e-2) -> bool:
    """Whether the record-flow recompute from the committed params
    matches the claimed polished_snapshot_mse to 1%."""
    mse = _surrogate_recompute_record_flow(problem, params_rel)
    claim = row["polished_snapshot_mse"]
    ok = bool(np.isclose(mse, claim, rtol=rtol, atol=0.0))
    print(f"  {problem} record [{_backend()}]: record-flow recompute "
          f"{mse:.3e} vs claim {claim:.3e}"
          + ("" if ok else f" ({mse / claim:.0f}x)"))
    return ok


def check(deep: bool = False) -> list[dict]:
    """Evaluate the ledger; returns one record per claim."""
    out = []
    for c in _claims():
        if c.deep and not deep:
            continue
        try:
            derived = c.derive(_load_json(c.artifact))
            ok = _cmp(c.claimed, derived, c.rtol)
        except Exception as e:  # missing artifact == failed claim
            derived, ok = f"ERROR: {e!r}", False
        out.append({"name": c.name, "doc": c.doc, "artifact": c.artifact,
                    "claimed": c.claimed, "derived": derived, "ok": ok})
    return out


def main(argv: list[str] | None = None) -> int:
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    deep = "--deep" in argv
    results = check(deep=deep)
    bad = [r for r in results if not r["ok"]]
    for r in results:
        mark = "ok  " if r["ok"] else "FAIL"
        print(f"[{mark}] {r['name']}: claimed {r['claimed']} derived "
              f"{r['derived']}  ({r['artifact']})")
    print(f"{len(results) - len(bad)}/{len(results)} claims verified"
          + (" (incl. deep param reloads)" if deep else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
