"""kanodes — a JAX/XLA/Pallas framework for KAN-ODEs.

A from-scratch rebuild of the capabilities of maharshi-coding/KAN-ODEs
(CMAME 2024, "KAN-ODEs: Kolmogorov-Arnold Network Ordinary Differential
Equations...") as a layered, tested, jit-first JAX library:

  ops/         basis functions (rbf/rswaf/iqf/bspline) + fused Pallas kernels
  models/      KDense KAN layer, chains, MLP baselines, B-spline KAN, PINN nets
  ode/         adaptive Tsit5 / fixed RK steppers (lax control flow),
               direct-backprop and continuous-adjoint differentiation
  pde/         method-of-lines operators, gray-box RHS composition, data gen
  pinn/        collocation samplers, nested-grad residuals, loss curricula
  train/       jitted optimization loops, checkpointing, configs
  sparsify/    L1+entropy regularization, activation extraction, pruning,
               grid refinement
  symbolic/    symbolic-regression post-pass over trained activations
  parallel/    mesh/sharding helpers (grid-sharded RHS, batched sweeps)
  experiments/ one config-driven module per reference experiment
  diag/        metrics, plots, pass/fail gates

The reference implementation is a set of Julia (Lux + OrdinaryDiffEq + Zygote)
and PyTorch scripts; this library is NOT a port — control flow is `lax.scan`/
`lax.while_loop`, hot kernels are Pallas, parallelism is `jax.sharding`.
"""

__version__ = "0.1.0"

from kanodes.ops import basis as basis
from kanodes.models.kdense import KDense, KDense1, KANChain
from kanodes.models.mlp import MLP
from kanodes.models.bspline import BSplineKAN, BSplineKANChain
from kanodes.models.hybrid import DataNormalizer, HybridKANMLP
from kanodes.ode.integrate import odeint, odeint_fixed, odeint_adjoint
from kanodes.ode.stiff import odeint_implicit

__all__ = [
    "basis",
    "KDense",
    "KDense1",
    "KANChain",
    "MLP",
    "BSplineKAN",
    "BSplineKANChain",
    "DataNormalizer",
    "HybridKANMLP",
    "odeint",
    "odeint_fixed",
    "odeint_adjoint",
    "odeint_implicit",
]
