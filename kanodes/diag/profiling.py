"""Profiling / throughput instrumentation.

The reference's telemetry is limited to sec/epoch prints and tqdm bars
(SURVEY.md §5.1). Here:

  * `StepTimer` — wall-clock per-phase timing with throughput summaries
    (it/s, RHS evals/s given a per-iteration eval count);
  * `rhs_evals_per_iteration(...)` — static counts for the fixed-step
    pipelines (the "KAN RHS evals/sec/chip" bench metric's numerator);
  * `trace(path)` — context manager around `jax.profiler` for on-demand
    device traces (view with TensorBoard/XProf).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax

from kanodes.ode.tableaus import get_tableau


@dataclasses.dataclass
class PhaseStats:
    name: str
    seconds: float
    iters: int
    rhs_evals_per_iter: int = 0

    @property
    def iters_per_sec(self) -> float:
        return self.iters / max(self.seconds, 1e-12)

    @property
    def rhs_evals_per_sec(self) -> float:
        return self.rhs_evals_per_iter * self.iters_per_sec


class StepTimer:
    def __init__(self):
        self.phases: list[PhaseStats] = []

    @contextlib.contextmanager
    def phase(self, name: str, iters: int, rhs_evals_per_iter: int = 0):
        t0 = time.time()
        yield
        self.phases.append(PhaseStats(name, time.time() - t0, iters,
                                      rhs_evals_per_iter))

    def summary(self) -> str:
        lines = []
        for p in self.phases:
            line = (f"{p.name}: {p.seconds:.2f}s, {p.iters} iters "
                    f"({p.iters_per_sec:.0f} it/s")
            if p.rhs_evals_per_iter:
                line += f", {p.rhs_evals_per_sec:.3g} RHS evals/s"
            lines.append(line + ")")
        return "\n".join(lines)


def rhs_evals_per_iteration(solver: str, n_intervals: int, substeps: int,
                            batch: int = 1, with_backward: bool = True
                            ) -> int:
    """Static RHS-eval count for one fixed-grid training iteration.

    Backward through the discrete adjoint re-evaluates each stage once
    (recompute) plus its VJP — counted as 2x forward.
    """
    tab = get_tableau(solver)
    stages = sum(1 for i in range(tab.stages)
                 if tab.b[i] != 0.0 or any(tab.a[j][i] != 0.0
                                           for j in range(i + 1,
                                                          tab.stages)))
    fwd = stages * n_intervals * substeps * batch
    return fwd * 3 if with_backward else fwd


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (TensorBoard-viewable)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
