"""Shared pieces of the whole-RK-step kernels (`ops/rk_fused.py`,
`ops/graybox_fused.py`): the static description of a 2-layer KDense
chain, its parameter layout, the pointwise math of a layer, the
contraction helpers, and the rule that decides how a kernel runs on the
current backend.

Reference semantics: `kdense.jl:109-130` (two stacked layers,
`LV_driver_KANODE.jl:136-142`) and the rbf VJP `utils.jl:15-21`.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import triton as plgpu

Array = jax.Array

# Pallas route of every kernel in this package.
KERNEL_BACKEND = "triton"

# Backward dot precision. "tf32" runs the backward's dots in TF32 on
# the tensor cores (about three decimal digits per product); the forward
# always stays IEEE float32.
BWD_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,   # IEEE float32
    "tf32": jax.lax.Precision.DEFAULT,
}
FWD_PRECISION = jax.lax.Precision.HIGHEST


def check_bwd_precision(bwd_precision: str) -> str:
    """Fail fast at call time: an invalid option would otherwise only
    surface when the backward first traces."""
    if bwd_precision not in BWD_PRECISIONS:
        raise ValueError(
            f"bwd_precision must be one of {sorted(BWD_PRECISIONS)}, "
            f"got {bwd_precision!r}")
    return bwd_precision


def kernel_interpret() -> bool:
    """How a kernel runs on the default backend: the Pallas interpreter
    on the CPU (tests), compiled through Triton on a GPU. Any other
    backend has no kernel route and raises."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(f"no kernel route for backend {backend!r}; "
                       "use impl='xla'")


def pow2(n: int) -> int:
    """Padded kernel width of a dimension: the smallest power of two
    >= max(n, DOT_MIN)."""
    n = max(int(n), DOT_MIN)
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# contractions inside a kernel
# ---------------------------------------------------------------------------

# Triton's dot needs every dimension >= 16, so every kernel width is
# padded to at least this with zeros. (The alternative, a broadcast
# multiply and a reduction, compiled several times slower on the H100
# and Triton returned wrong sums when reducing the middle axis of a 3-D
# block.)
DOT_MIN = 16


def _dot_general(a, b, contract, prec):
    assert min(a.shape + b.shape) >= DOT_MIN, (a.shape, b.shape)
    return jax.lax.dot_general(a, b, (contract, ((), ())), precision=prec,
                               preferred_element_type=jnp.float32)


def dot(a, b, prec):
    """a [M, N] @ b [N, P]."""
    return _dot_general(a, b, ((1,), (0,)), prec)


def dot_t0(a, b, prec):
    """a[M, N]^T @ b [M, P] -> [N, P] (sums over the rows)."""
    return _dot_general(a, b, ((0,), (0,)), prec)


def dot_t1(a, b, prec):
    """a [M, P] @ b[N, P]^T -> [M, N]."""
    return _dot_general(a, b, ((1,), (1,)), prec)


def masked_load(ref, shape, valid):
    """Load a padded [rp, cp] block of which the leading `valid` = (r, c)
    entries exist; the rest reads as zero."""
    (rp, cp), (r, c) = shape, valid
    m = (jnp.arange(rp) < r)[:, None] & (jnp.arange(cp) < c)[None, :]
    return plgpu.load(ref, mask=m, other=0.0)


def masked_store(ref, val, valid):
    rp, cp = val.shape
    r, c = valid
    m = (jnp.arange(rp) < r)[:, None] & (jnp.arange(cp) < c)[None, :]
    plgpu.store(ref, val, mask=m)


# ---------------------------------------------------------------------------
# pointwise math of a KDense layer
# ---------------------------------------------------------------------------

def norm(x, kind: str):
    if kind == "tanh":
        return jnp.tanh(x)
    if kind == "softsign":
        return x / (1.0 + jnp.abs(x))
    raise ValueError(kind)


def dnorm(x, kind: str):
    if kind == "tanh":
        t = jnp.tanh(x)
        return 1.0 - t * t
    if kind == "softsign":
        d = 1.0 + jnp.abs(x)
        return 1.0 / (d * d)
    raise ValueError(kind)


def basis_val(u, kind: str):
    """Radial basis value B(u) on the normalized distance u — the three
    local bases of `ops/basis.py` (utils.jl:8-62); global bases (cheby/
    fourier) are XLA-path only."""
    if kind == "rbf":
        return jnp.exp(-(u * u))
    if kind == "iqf":
        return 1.0 / (1.0 + u * u)
    if kind == "rswaf":
        t = jnp.tanh(u)
        return 1.0 - t * t
    raise ValueError(kind)


def basis_du(u, b, kind: str):
    """dB/du given the already-computed B."""
    if kind == "rbf":
        return -2.0 * u * b
    if kind == "iqf":
        return -2.0 * u * b * b
    if kind == "rswaf":
        return -2.0 * jnp.tanh(u) * b
    raise ValueError(kind)


def swish(x):
    return x * jax.nn.sigmoid(x)


def dswish(x):
    s = jax.nn.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


# ---------------------------------------------------------------------------
# chain description and parameter layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static description of a 2-layer KDense chain (local basis, swish
    base act, tanh or softsign normalizer)."""
    in_dims: int
    hidden: int
    out_dims: int
    grid_len: int
    grid_lims: tuple[float, float] = (-1.0, 1.0)
    denominator: float | None = None
    normalizer: str = "tanh"
    basis: str = "rbf"                 # rbf | iqf | rswaf (local bases)

    @property
    def h(self) -> float:
        if self.denominator is not None:
            return self.denominator
        return (self.grid_lims[1] - self.grid_lims[0]) / (self.grid_len - 1)

    @property
    def centers(self) -> tuple[float, ...]:
        return tuple(float(v) for v in np.linspace(
            self.grid_lims[0], self.grid_lims[1], self.grid_len,
            dtype=np.float32))


def chain_spec_of(chain) -> ChainSpec:
    """Build a ChainSpec from a 2-layer KANChain (validates fusability)."""
    if len(chain.layers) != 2:
        raise ValueError("fused path supports exactly 2 layers")
    l1, l2 = chain.layers
    for l in (l1, l2):
        if l.basis not in ("rbf", "iqf", "rswaf") or \
                (l.base_act, l.use_base_act) != ("swish", True) or \
                l.normalizer not in ("tanh", "softsign") or \
                l.trainable_grid:
            raise ValueError("fused path requires a local basis "
                             "(rbf/iqf/rswaf), swish base act, a "
                             "tanh/softsign normalizer and a static grid")
        if l.grid_len != l1.grid_len or l.grid_lims != l1.grid_lims \
                or l.normalizer != l1.normalizer or l.basis != l1.basis:
            raise ValueError("fused path requires shared "
                             "grid/normalizer/basis")
    return ChainSpec(l1.in_dims, l1.out_dims, l2.out_dims, l1.grid_len,
                     tuple(float(v) for v in l1.grid_lims),
                     l1.denominator, l1.normalizer, l1.basis)


def fused_params(chain_params) -> tuple[Array, Array, Array, Array]:
    """KANChain params -> (C1 [I, G, H], W1 [I, H], C2 [H, G, O],
    W2 [H, O]), the layout the kernels read directly."""
    p1, p2 = chain_params
    return p1["C"], p1["W"], p2["C"], p2["W"]
