"""Persistent compilation cache location.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX keeps its cache there and
nothing is set in code. Otherwise the cache lives in `.jax_cache/` at the
root of the checkout (listed in .gitignore), a fixed path, so a later
process finds what an earlier one compiled.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
