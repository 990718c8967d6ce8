"""Matmul precision policy.

XLA's DEFAULT matmul precision may round float32 inputs (TF32 on an
NVIDIA GPU keeps about three decimal digits, bfloat16 on other
accelerators two) — fine for big-transformer training, fatal for
ODE-solver numerics chasing 1e-7 losses. Every matmul in this library
goes through this policy; the default is HIGHEST (IEEE float32)
because all reference workloads are tiny and latency-bound.
"""

from __future__ import annotations

import jax

_PRECISION = jax.lax.Precision.HIGHEST


def matmul_precision() -> jax.lax.Precision:
    return _PRECISION


def set_matmul_precision(p) -> None:
    """p: jax.lax.Precision or one of 'default' | 'high' | 'highest'."""
    global _PRECISION
    if isinstance(p, str):
        p = {"default": jax.lax.Precision.DEFAULT,
             "high": jax.lax.Precision.HIGH,
             "highest": jax.lax.Precision.HIGHEST}[p.lower()]
    _PRECISION = p
