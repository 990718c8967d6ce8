"""Hidden-node pruning for 2-layer KAN chains.

Rebuild of `prune` (`Lotka-Volterra/LV_driver_KANODE.jl:52-108`): score
every hidden node by the activations flowing through it on training
inputs; a node survives when BOTH its strongest incoming edge and its
strongest outgoing edge exceed the threshold
    keep_j = min(max_i max_t |phi_{i->j}|, max_o max_t |phi_{j->o}|) > theta
(:76-84, theta = 1e-2 in the paper, 1e-1 at the call site :169), then
rebuild a narrower chain copying the surviving parameter slices
(:87-107).

Under jit, shapes are static — pruning is an explicit repack-and-
recompile boundary (build the new chain, slice the params, re-jit
training), exactly how the reference restarts its driver after pruning
(:18-25).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from kanodes.models import KANChain
from kanodes.sparsify.activations import activation_magnitudes

Array = jax.Array


@dataclasses.dataclass
class PruneResult:
    chain: KANChain
    params: list
    kept: np.ndarray          # indices of surviving hidden nodes
    scores: np.ndarray        # per-node min(in, out) scores


def node_scores(chain: KANChain, params, x: Array) -> np.ndarray:
    """min(strongest-in, strongest-out) activation magnitude per hidden
    node of a 2-layer chain (LV_driver_KANODE.jl:76-84)."""
    if len(chain.layers) != 2:
        raise ValueError("prune supports 2-layer chains (as the reference)")
    mags = activation_magnitudes(chain, params, x)
    in_score = jnp.max(mags[0], axis=0)       # [hidden] strongest incoming
    out_score = jnp.max(mags[1], axis=1)      # [hidden] strongest outgoing
    return np.asarray(jnp.minimum(in_score, out_score))


def prune(chain: KANChain, params, x: Array,
          threshold: float = 1e-2) -> PruneResult:
    """Drop weak hidden nodes; returns the repacked smaller chain.

    x: [N, in_dims] sample states (the reference uses the training
    trajectory). Keeps at least one node.
    """
    scores = node_scores(chain, params, x)
    kept = np.where(scores > threshold)[0]
    if kept.size == 0:
        kept = np.asarray([int(scores.argmax())])
    l1, l2 = chain.layers
    new_chain = KANChain(
        dataclasses.replace(l1, out_dims=int(kept.size)),
        dataclasses.replace(l2, in_dims=int(kept.size)),
    )
    p1, p2 = params
    new_params = [
        {"C": p1["C"][:, :, kept], "W": p1["W"][:, kept]},
        {"C": p2["C"][kept, :, :], "W": p2["W"][kept, :]},
    ]
    if not l1.use_base_act:
        new_params[0].pop("W", None)
    if not l2.use_base_act:
        new_params[1].pop("W", None)
    return PruneResult(new_chain, new_params, kept, scores)
