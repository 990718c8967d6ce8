"""Packed (block-diagonal) KAN ensembles — S replicas as ONE wider chain.

Motivation (measured, EXPERIMENTS.md multi-seed section): `jax.vmap`
over member params lifts the member axis into the Pallas kernel GRID,
which SERIALIZES the latency-bound in-kernel step chain S times — the
vmapped 8-seed LV sweep ran only 1.5x faster than sequential. Packing
instead embeds the S member chains as block-diagonal weights of a
single [S*I, S*H, S*O] chain: the member axis rides the GEMM
width, where extra width is free at these latency-bound
sizes, so the whole ensemble steps at ~single-member latency.

Correctness: a KDense output is a sum over input edges of per-edge
functions of a SINGLE input (`models/kdense.py:5-7` — elementwise
normalizer/basis/base-act, then one GEMM over (input, grid) pairs).
With C and W zero outside the member-diagonal blocks, member s outputs
therefore depend only on member s inputs — the packed chain computes S
independent forwards exactly (up to f32 summation-order rounding: the
dense GEMM accumulates the member's terms alongside exact zeros).

Gradient isolation is by construction: train the dense params through
`apply_mask` (multiply by the 0/1 block mask inside the loss), so
off-block gradients are exactly zero and Adam never moves off-block
entries from zero. The packed state vector is member-major:
member s owns dims [s*d, (s+1)*d).

Adaptive stepping: the plain `odeint` over a packed state would share
ONE controller (a joint error norm) and couple members through dt, so
packed adaptive solves go through `ode.odeint_members` instead — one
independent save-clipped controller per member (member-blocked error
norms, per-member dt/t/save_idx vectors). `experiments.lv.make_ode_fns`
routes there when given `reduce_fn` + `n_members` with
solve_mode="adaptive", making the reference-faithful adaptive protocol
(`LV_driver_KANODE.jl:180-184`) available to packed ensembles.

The reference has no ensemble concept at all (seed studies are
hand-edited sequential reruns, `Lotka-Volterra/LV_driver_KANODE.jl:114`);
this is an accelerator-first capability.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from kanodes.models.kdense import KANChain, KDense

Array = jax.Array


def _check(chain: KANChain) -> None:
    for l in chain.layers:
        if not isinstance(l, KDense):
            raise ValueError("packing supports KDense chains only")
        if l.trainable_grid:
            raise ValueError("a packed layer shares one grid; "
                             "trainable_grid would couple members")


def pack_chain(chain: KANChain, n_members: int) -> KANChain:
    """The S-member packed chain: every layer's in/out dims scaled by S
    (grid/basis/normalizer unchanged — they are elementwise/per-dim and
    member-independent)."""
    _check(chain)
    layers = [dataclasses.replace(l, in_dims=n_members * l.in_dims,
                                  out_dims=n_members * l.out_dims)
              for l in chain.layers]
    return KANChain(*layers)


def pack_params(chain: KANChain, member_params: list) -> list:
    """Block-diagonal dense params from S per-member param trees.

    `member_params` is a list of S chain-param lists (as returned by
    `chain.init`). Returns the packed chain's param list: per layer,
    C [S*I, G, S*O] and W [S*I, S*O] with member s occupying the
    (s*I:(s+1)*I, :, s*O:(s+1)*O) block and exact zeros elsewhere.
    """
    _check(chain)
    S = len(member_params)
    packed = []
    for li, l in enumerate(chain.layers):
        I, G, O = l.in_dims, l.grid_len, l.out_dims
        C = jnp.zeros((S * I, G, S * O),
                      member_params[0][li]["C"].dtype)
        for s in range(S):
            C = C.at[s * I:(s + 1) * I, :, s * O:(s + 1) * O].set(
                member_params[s][li]["C"])
        p = {"C": C}
        if l.use_base_act:
            W = jnp.zeros((S * I, S * O),
                          member_params[0][li]["W"].dtype)
            for s in range(S):
                W = W.at[s * I:(s + 1) * I, s * O:(s + 1) * O].set(
                    member_params[s][li]["W"])
            p["W"] = W
        packed.append(p)
    return packed


def extract_member(chain: KANChain, packed_params: list, n_members: int,
                   member: int) -> list:
    """Member `member`'s original-shape params out of the packed tree."""
    _check(chain)
    out = []
    for li, l in enumerate(chain.layers):
        I, O = l.in_dims, l.out_dims
        sI, sO = member * I, member * O
        p = {"C": packed_params[li]["C"][sI:sI + I, :, sO:sO + O]}
        if l.use_base_act:
            p["W"] = packed_params[li]["W"][sI:sI + I, sO:sO + O]
        out.append(p)
    return out


def block_mask(chain: KANChain, n_members: int) -> list:
    """The 0/1 block-diagonal mask with the packed params' structure."""
    _check(chain)
    one = [{k: jnp.ones_like(v) for k, v in p.items()}
           for p in chain.init(jax.random.PRNGKey(0))]
    return pack_params(chain, [one] * n_members)


def apply_mask(mask: list, packed_params: list) -> list:
    """mask * params, leafwise — used INSIDE the loss so off-block
    gradients vanish exactly (d/dp of f(mask*p) carries the mask)."""
    return jax.tree_util.tree_map(jnp.multiply, mask, packed_params)


def member_mean(n_members: int):
    """`reduce_fn` for `make_ode_fns`-style losses over a packed state:
    squared-error tensor [..., S*d] -> per-member mean vector [S]."""
    def reduce(err: Array) -> Array:
        d = err.shape[-1] // n_members
        e = err.reshape(err.shape[:-1] + (n_members, d))
        axes = tuple(i for i in range(e.ndim) if i != e.ndim - 2)
        return e.mean(axis=axes)
    return reduce


def tile_state(x: Array, n_members: int) -> Array:
    """Tile data/state along the last axis for the packed chain
    ([..., d] -> [..., S*d], member-major)."""
    return jnp.tile(x, (1,) * (x.ndim - 1) + (n_members,))


def member_ids(chain: KANChain, n_members: int) -> list:
    """Int32 member-index tree with the packed params' structure:
    member s's block entries carry the value s. Off-block entries carry
    0 — always pair with `block_mask`, which zeroes them, so the
    ambiguity with member 0 never matters (`train/packed_polish.py`
    consumes (ids, mask) together)."""
    _check(chain)
    one = [{k: jnp.ones_like(v) for k, v in p.items()}
           for p in chain.init(jax.random.PRNGKey(0))]
    trees = [jax.tree_util.tree_map(lambda x, s=float(s): x * s, one)
             for s in range(n_members)]
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.int32),
                                  pack_params(chain, trees))


def member_lr_scales(chain: KANChain, factors) -> list:
    """Per-member learning-rate factor tree for the (homogeneous) packed
    layout: every entry of member s's blocks carries `factors[s]`
    (off-block entries get 0 — their gradients are already exactly zero
    under `apply_mask`). Feed to `train(..., lr_scales=...)`; member s
    then steps exactly as under `adam(cfg.lr * factors[s])`."""
    _check(chain)
    one = [{k: jnp.ones_like(v) for k, v in p.items()}
           for p in chain.init(jax.random.PRNGKey(0))]
    trees = [jax.tree_util.tree_map(lambda x, f=float(f): x * f, one)
             for f in factors]
    return pack_params(chain, trees)


# ---------------------------------------------------------------------------
# heterogeneous packing: members of DIFFERENT widths / grid sizes
# ---------------------------------------------------------------------------

class HeteroKDense:
    """One layer of a heterogeneous packed ensemble.

    Same math as `KDense` except the grid is PER-INPUT-ROW: input dim i
    evaluates its basis on `grid_rows[i]` with bandwidth `h_rows[i]`, so
    members with different grid sizes/spacings coexist in one GEMM
    (members with fewer grid points than G_max repeat their last center
    in the padded slots; the corresponding C entries are zero-masked, so
    the padding contributes exactly nothing). The radial bases broadcast
    `x[..., I, 1] - grid[I, G]` natively (`ops/basis.py:52-68`).
    """

    def __init__(self, in_dims: int, out_dims: int, grid_len: int,
                 grid_rows, h_rows, normalizer: str = "tanh",
                 basis: str = "rbf", base_act: str = "swish",
                 use_base_act: bool = True, dtype: str = "float32"):
        self.in_dims = in_dims
        self.out_dims = out_dims
        self.grid_len = grid_len
        self.grid_rows = jnp.asarray(grid_rows, jnp.dtype(dtype))  # [I, G]
        self.h_rows = jnp.asarray(h_rows, jnp.dtype(dtype))        # [I]
        self.normalizer = normalizer
        self.basis = basis
        self.base_act = base_act
        self.use_base_act = use_base_act
        self.dtype = dtype

    def apply(self, params: dict, x: Array) -> Array:
        from kanodes.ops import basis as B
        from kanodes.utils.precision import matmul_precision
        xn = B.get_normalizer(self.normalizer)(x)
        bas = B.get_basis(self.basis)(
            xn, self.grid_rows, self.h_rows[:, None])      # [..., I, G]
        flat = bas.reshape(*bas.shape[:-2], self.in_dims * self.grid_len)
        C2 = params["C"].reshape(self.in_dims * self.grid_len,
                                 self.out_dims)
        y = jnp.matmul(flat, C2, preferred_element_type=flat.dtype,
                       precision=matmul_precision())
        if self.use_base_act:
            base = B.get_base_act(self.base_act)(x)
            y = y + jnp.matmul(base, params["W"],
                               preferred_element_type=flat.dtype,
                               precision=matmul_precision())
        return y

    def __call__(self, params, x):
        return self.apply(params, x)


class HeteroPacked:
    """S member `KANChain`s of DIFFERENT architectures (hidden widths
    and/or grid sizes; same depth/basis/normalizer) packed as ONE
    block-diagonal chain — the heterogeneous upgrade of `pack_chain`,
    cashing SURVEY §2.9's promise of training a whole size sweep (the
    Fig-3C A2 study, `Lotka-Volterra/trend_plotter.py:7-8`) as a single
    device program. Blocks are variable-sized (no width padding: layer
    dims are the SUMS of member dims); only the grid axis pads to
    G_max with zero-masked columns. XLA path (per-row grids are outside
    the fused kernels' shared-grid contract).
    """

    def __init__(self, members: list[KANChain]):
        if not members:
            raise ValueError("need at least one member chain")
        depth = len(members[0].layers)
        for m in members:
            _check(m)
            if len(m.layers) != depth:
                raise ValueError("members must share depth")
            for l, l0 in zip(m.layers, members[0].layers):
                for attr in ("normalizer", "basis", "base_act",
                             "use_base_act", "grid_lims", "dtype"):
                    if getattr(l, attr) != getattr(l0, attr):
                        raise ValueError(
                            f"members must share {attr}; packing only "
                            "varies widths and grid sizes")
        self.members = tuple(members)
        self.n_members = len(members)
        layers = []
        self.in_offs, self.out_offs = [], []   # per layer: member offsets
        for li in range(depth):
            ls = [m.layers[li] for m in members]
            g_max = max(l.grid_len for l in ls)
            in_off = [0]
            for l in ls:
                in_off.append(in_off[-1] + l.in_dims)
            out_off = [0]
            for l in ls:
                out_off.append(out_off[-1] + l.out_dims)
            grid_rows, h_rows = [], []
            for l in ls:
                g = list(jax.device_get(l.grid()))
                g = g + [g[-1]] * (g_max - l.grid_len)   # pad: repeat last
                grid_rows.extend([g] * l.in_dims)
                h_rows.extend([l.h] * l.in_dims)
            layers.append(HeteroKDense(
                in_off[-1], out_off[-1], g_max, grid_rows, h_rows,
                normalizer=ls[0].normalizer, basis=ls[0].basis,
                base_act=ls[0].base_act, use_base_act=ls[0].use_base_act,
                dtype=ls[0].dtype))
            self.in_offs.append(tuple(in_off))
            self.out_offs.append(tuple(out_off))
        self.layers = tuple(layers)

    # -- chain protocol (enough for make_ode_fns' XLA path) ---------------
    def apply(self, params, x: Array) -> Array:
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x

    def __call__(self, params, x):
        return self.apply(params, x)

    def num_params(self) -> int:
        return sum(m.num_params() for m in self.members)

    def init(self, key: Array) -> list:
        keys = jax.random.split(key, self.n_members)
        return self.pack([m.init(k) for m, k in zip(self.members, keys)])

    # -- pack / extract / mask ---------------------------------------------
    def pack(self, member_params: list) -> list:
        """Member param trees -> packed dense params (exact zeros off
        the blocks and in the padded grid columns)."""
        packed = []
        for li, layer in enumerate(self.layers):
            C = jnp.zeros((layer.in_dims, layer.grid_len, layer.out_dims),
                          jnp.dtype(layer.dtype))
            W = jnp.zeros((layer.in_dims, layer.out_dims),
                          jnp.dtype(layer.dtype))
            for s, m in enumerate(self.members):
                i0 = self.in_offs[li][s]
                o0 = self.out_offs[li][s]
                l = m.layers[li]
                C = C.at[i0:i0 + l.in_dims, :l.grid_len,
                         o0:o0 + l.out_dims].set(member_params[s][li]["C"])
                if layer.use_base_act:
                    W = W.at[i0:i0 + l.in_dims,
                             o0:o0 + l.out_dims].set(
                                 member_params[s][li]["W"])
            p = {"C": C}
            if layer.use_base_act:
                p["W"] = W
            packed.append(p)
        return packed

    def extract_member(self, packed_params: list, member: int) -> list:
        out = []
        m = self.members[member]
        for li, l in enumerate(m.layers):
            i0 = self.in_offs[li][member]
            o0 = self.out_offs[li][member]
            p = {"C": packed_params[li]["C"][i0:i0 + l.in_dims,
                                             :l.grid_len,
                                             o0:o0 + l.out_dims]}
            if l.use_base_act:
                p["W"] = packed_params[li]["W"][i0:i0 + l.in_dims,
                                                o0:o0 + l.out_dims]
            out.append(p)
        return out

    def mask(self) -> list:
        one = [[{k: jnp.ones_like(v) for k, v in p.items()}
                for p in m.init(jax.random.PRNGKey(0))]
               for m in self.members]
        return self.pack(one)

    def member_ids(self) -> list:
        """Int32 member-index tree (heterogeneous analogue of the
        module-level `member_ids`); pair with `mask()` — off-block and
        padded-grid entries carry 0 there."""
        trees = [jax.tree_util.tree_map(
            lambda x, s=float(s): jnp.ones_like(x) * s,
            m.init(jax.random.PRNGKey(0)))
            for s, m in enumerate(self.members)]
        return jax.tree_util.tree_map(lambda x: x.astype(jnp.int32),
                                      self.pack(trees))

    def lr_scales(self, factors) -> list:
        trees = [jax.tree_util.tree_map(
            lambda x, f=float(f): jnp.ones_like(x) * f,
            m.init(jax.random.PRNGKey(0)))
            for m, f in zip(self.members, factors)]
        return self.pack(trees)

    def member_mean(self):
        """Per-member mean reduce_fn over the FINAL layer's output
        blocks (members may have different state dims)."""
        sizes = [self.out_offs[-1][s + 1] - self.out_offs[-1][s]
                 for s in range(self.n_members)]
        total = self.out_offs[-1][-1]
        ind = jnp.zeros((total, self.n_members))
        for s in range(self.n_members):
            o0 = self.out_offs[-1][s]
            ind = ind.at[o0:o0 + sizes[s], s].set(1.0 / sizes[s])

        def reduce(err: Array) -> Array:
            flat = err.reshape(-1, total)
            return flat.mean(axis=0) @ ind
        return reduce

    def tile_state(self, x: Array) -> Array:
        """Tile a shared dataset across member input blocks (requires
        every member's state dim to equal x's last axis)."""
        d = x.shape[-1]
        for s in range(self.n_members):
            if self.in_offs[0][s + 1] - self.in_offs[0][s] != d:
                raise ValueError("tile_state needs uniform member state "
                                 "dims matching the data")
        return tile_state(x, self.n_members)
