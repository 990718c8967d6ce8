"""LV symbolic pipeline smoke (tiny budget on CPU)."""

import numpy as np
import pytest

from kanodes.experiments.lv_symbolic import (SymbolicPipelineConfig,
                                             run_pipeline)


@pytest.mark.slow
def test_pipeline_end_to_end_tiny():
    cfg = SymbolicPipelineConfig(sparse_iters=300, retrain_iters=200,
                                 prune_threshold=1e-3,
                                 sr_generations=40, sr_restarts=1)
    out = run_pipeline(cfg)
    assert out["kept_nodes"].size >= 1
    assert np.isfinite(out["pruned_train_loss"])
    assert len(out["global_equations"]) == 2
    assert all(isinstance(e, str) and e for e in out["global_equations"])
    assert np.isfinite(out["symbolic_resim_mse"])
    # per-edge equations: (2 x W) + (W x 2) fits
    w = out["kept_nodes"].size
    assert len(out["edge_equations"]) == 2 * w + w * 2
