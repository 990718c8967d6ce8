"""Sanitizers + profiling instrumentation."""

import jax.numpy as jnp
import numpy as np
import pytest

from kanodes.utils.debug import (check_finite, validate_finite,
                                 nan_guard)
from kanodes.diag.profiling import (StepTimer, rhs_evals_per_iteration)


def test_check_finite():
    assert bool(check_finite({"a": jnp.ones(3), "b": jnp.zeros(2)}))
    assert not bool(check_finite({"a": jnp.asarray([1.0, jnp.nan])}))


def test_validate_finite_raises_with_path():
    with pytest.raises(FloatingPointError, match="a.*non-finite"):
        validate_finite({"a": jnp.asarray([jnp.inf]), "b": jnp.ones(2)})


def test_nan_guard():
    @nan_guard
    def ok(x):
        return x * 2

    assert float(ok(jnp.asarray(2.0))) == 4.0

    @nan_guard
    def bad(x):
        return x / 0.0

    with pytest.raises(FloatingPointError):
        bad(jnp.asarray(1.0))


def test_step_timer_and_eval_counts():
    t = StepTimer()
    with t.phase("a", iters=100, rhs_evals_per_iter=10):
        pass
    assert "a:" in t.summary() and "100 iters" in t.summary()
    # tsit5 fixed-step: 6 effective stages (FSAL pruned)
    n = rhs_evals_per_iteration("tsit5", n_intervals=35, substeps=1,
                                with_backward=False)
    assert n == 6 * 35
    assert rhs_evals_per_iteration("rk4", 10, 2,
                                   with_backward=False) == 4 * 20
