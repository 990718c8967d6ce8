"""The Fig-3C KAN d=2 trend sweep trained as ONE device program.

The reference produced its param-efficiency trend by hand-editing
`layer_width`/`grid_size` and re-running 1e5 CPU iterations per point,
then hardcoding the 8 converged losses into `trend_plotter.py:7-8`.
`run_sweep` (sweep_results.json) collapses each point to a short run
but still trains the sizes sequentially. This script runs
`experiments.sweep.packed_trend_sweep`: all 8 sizes — different hidden
widths AND different grid sizes — pack block-diagonally into one
heterogeneous chain (`models.packed.HeteroPacked`) and train
simultaneously through the shared 22k-iteration curriculum, cashing
SURVEY §2.9's DP promise ("train the A2 sweep of KAN sizes as one
sharded vmap") in its stronger packed form.

Writes artifacts/lv_trend_packed.json.
Usage: python scripts/lv_trend_packed.py [--lr-factors] [--polish N]
  --lr-factors additionally records a variant trained under per-member
  learning rates (width-scaled), exercising `train(lr_scales=...)` on
  device.
  --polish N appends the mask-aware packed L-BFGS stage
  (`train.packed_polish`): all 8 heterogeneous members polish
  SIMULTANEOUSLY with per-member curvature + line searches.
One process per card.
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

from kanodes.experiments.sweep import (KAN_SWEEP, REFERENCE_KAN_TREND,
                                       packed_trend_sweep)


def annotate(rows):
    beat = 0
    for r in rows:
        ref = REFERENCE_KAN_TREND.get(r["n_params"])
        r["reference_loss"] = ref
        r["beats_reference"] = bool(ref is not None
                                    and r["train_loss"] < ref)
        beat += r["beats_reference"]
    return beat


def main():
    polish_iters = 0
    if "--polish" in sys.argv:
        i = sys.argv.index("--polish")
        if i + 1 >= len(sys.argv):
            sys.exit("usage: --polish N")
        polish_iters = int(sys.argv[i + 1])
    t0 = time.time()
    out = packed_trend_sweep(KAN_SWEEP, polish_iters=polish_iters)
    out["points_beating_reference"] = annotate(out["results"])
    out["wall_seconds"] = round(time.time() - t0, 2)
    out["device"] = jax.devices()[0].device_kind

    # the same-recipe sequential baseline, if recorded
    seq_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "sweep_results.json")
    if os.path.exists(seq_path):
        with open(seq_path) as f:
            seq = [r for r in json.load(f)
                   if r["model"] == "kan" and r.get("depth", 2) == 2]
        out["sequential_baseline"] = {
            "total_seconds": round(sum(r["seconds"] for r in seq), 2),
            "train_losses": {r["n_params"]: r["train_loss"] for r in seq},
        }

    for r in out["results"]:
        pol = (f" polished {r['polished_train_loss']:.2e}"
               if "polished_train_loss" in r else "")
        print(f"[{r['n_params']:>4} params w={r['layer_width']:>2} "
              f"g={r['grid_size']}] train {r['train_loss']:.2e} "
              f"test {r['test_loss']:.2e}{pol}  "
              f"ref {r['reference_loss']:.1e} "
              f"{'BEAT' if r['beats_reference'] else 'MISS'}")
    print(f"{out['points_beating_reference']}/8 beat the reference; "
          f"one program, {out['total_seconds']} s train "
          f"(phases {out['phase_seconds']}"
          + (f", polish {out['polish_seconds']} s" if polish_iters else "")
          + ")")

    if "--lr-factors" in sys.argv:
        # width-scaled per-member lr: larger members train colder
        factors = [10.0 / p.layer_width for p in KAN_SWEEP]
        v = packed_trend_sweep(KAN_SWEEP, lr_factors=factors)
        v["lr_factors"] = factors
        v["points_beating_reference"] = annotate(v["results"])
        out["lr_factors_variant"] = v
        print(f"lr-factors variant: {v['points_beating_reference']}/8 "
              f"beat, {v['total_seconds']} s")

    path = os.path.join("artifacts", "lv_trend_packed.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)


if __name__ == "__main__":
    main()
