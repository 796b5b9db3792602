"""On-device multi-source BFS / shortest-path distances via min-plus edge
propagation — the on-device form of the BFS kernels behind the reference
engine's SPINE/WINE sketch embedders (SURVEY.md §2.2 "degree/label
propagation sketches") and the visualizer's distance queries.

distances[:, j] = shortest hop (or weighted) distance from anchor set j.
Each iteration is one segment-min over edges — a sparse min-plus product —
so D anchor sets propagate simultaneously as a [N, D] dense matrix, one
wide elementwise pass per iteration.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..graph.graph import DeviceGraph

UNREACHED = 1e9  # plain float: module import must not touch the backend


@functools.partial(jax.jit, static_argnames=("max_depth", "weighted"))
def multi_source_distances(
    dg: DeviceGraph,
    anchor_init: jnp.ndarray,   # [N, D] 0.0 at anchor members, +inf elsewhere
    max_depth: int = 32,
    weighted: bool = False,
) -> jnp.ndarray:
    """[N, D] distances, clamped at UNREACHED for unreachable pairs."""
    rows = jnp.searchsorted(
        dg.row_ptr, jnp.arange(dg.n_arcs, dtype=jnp.int32), side="right"
    ).astype(jnp.int32) - 1
    cols = dg.col_idx
    if weighted:
        if dg.weights is None:
            raise ValueError("Weighted distances require edge weights.")
        w = dg.weights[:, None]
    else:
        w = 1.0

    def body(dist, _):
        # candidate distance at rows via incoming col values (reverse arcs are
        # present for undirected graphs; directed graphs propagate forward).
        cand = jax.ops.segment_min(
            dist[cols] + w, rows, num_segments=dg.n_nodes
        )
        new = jnp.minimum(dist, cand)
        return new, None

    dist, _ = jax.lax.scan(body, anchor_init, None, length=max_depth)
    return dist


def anchor_init_from_sets(n_nodes: int, anchor_sets) -> jnp.ndarray:
    """Build the [N, D] init matrix from a list of anchor node-id arrays."""
    import numpy as np

    d = len(anchor_sets)
    init = np.full((n_nodes, d), float(UNREACHED), dtype=np.float32)
    for j, nodes in enumerate(anchor_sets):
        init[np.asarray(nodes, dtype=np.int64), j] = 0.0
    return jnp.asarray(init)


@functools.partial(jax.jit, static_argnames=("window_size",))
def window_cooccurrence_counts(
    dg: DeviceGraph,
    anchor_membership: jnp.ndarray,  # [N, D] 1.0 where node in anchor set j
    window_size: int = 2,
) -> jnp.ndarray:
    """[N, D] number of (multi-)paths of length <= window_size from each node
    into each anchor set — the window co-occurrence sketch behind WINE
    (reference `degree_wine.py:50`, window_size default 2)."""
    rows = jnp.searchsorted(
        dg.row_ptr, jnp.arange(dg.n_arcs, dtype=jnp.int32), side="right"
    ).astype(jnp.int32) - 1
    cols = dg.col_idx

    def hop(x):
        return jax.ops.segment_sum(x[cols], rows, num_segments=dg.n_nodes)

    total = jnp.zeros_like(anchor_membership)
    reach = anchor_membership
    for _ in range(window_size):
        reach = hop(reach)
        total = total + reach
    return total
