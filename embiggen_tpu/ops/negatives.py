"""On-device minibatch and negative sampling — the counterpart of the
reference engine's `get_edge_prediction_mini_batch` (reference call site
`embiggen/sequences/gcn_edge_prediction_training_sequence.py:174-250`),
`get_siamese_mini_batch[_with_edge_types]` (`siamese_sequence.py:72-91`) and
the TF log-uniform NCE negative sampler.

Scale-free destination sampling is a single trick on-device: the destination
of a uniformly random arc is exactly degree-distributed, so no alias table
over the degree distribution is needed — one randint + one gather.
False-negative avoidance uses the CSR binary search from `walks.py`.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..graph.graph import DeviceGraph
from .walks import _bsearch_iters, csr_has_edges


def sample_nodes_scale_free(
    dg: DeviceGraph, key: jnp.ndarray, shape
) -> jnp.ndarray:
    """Degree-proportional node sample: destination of a uniform random arc."""
    arc = jax.random.randint(key, shape, 0, max(dg.n_arcs, 1))
    return dg.col_idx[arc]


def sample_nodes_uniform(dg: DeviceGraph, key: jnp.ndarray, shape) -> jnp.ndarray:
    return jax.random.randint(key, shape, 0, dg.n_nodes, dtype=jnp.int32)


def sample_positive_arcs(
    dg: DeviceGraph, key: jnp.ndarray, batch_size: int
) -> jnp.ndarray:
    """[B] uniform arc indices."""
    return jax.random.randint(key, (batch_size,), 0, max(dg.n_arcs, 1))



def arc_sources(dg: DeviceGraph, arc: jnp.ndarray) -> jnp.ndarray:
    """Source node of each arc id: one element gather when the graph was
    exported with `device(with_sources=True)`, else a log2(N)-round
    searchsorted over row_ptr (~20x the gather descriptors at 1M nodes)."""
    if dg.sources is not None:
        return dg.sources[arc]
    return jnp.searchsorted(dg.row_ptr, arc, side="right").astype(jnp.int32) - 1


@functools.partial(
    jax.jit,
    static_argnames=(
        "batch_size", "negative_samples_rate", "use_scale_free_distribution",
        "avoid_false_negatives", "n_attempts",
    ),
)
def edge_prediction_mini_batch(
    dg: DeviceGraph,
    key: jnp.ndarray,
    batch_size: int,
    negative_samples_rate: float = 0.5,
    use_scale_free_distribution: bool = True,
    avoid_false_negatives: bool = True,
    n_attempts: int = 2,
    graph_to_avoid: Optional[DeviceGraph] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(sources [B], destinations [B], labels [B] f32) with the first
    (1 - rate) * B entries positive arcs and the rest corrupted negatives.

    Negatives pair a scale-free (or uniform) source with a scale-free
    destination; with `avoid_false_negatives` each colliding pair is
    re-sampled up to n_attempts times (remaining collisions keep label 0
    with probability ~collision_rate^(n_attempts+1), matching the
    reference's best-effort semantics). Each round costs a full-width CSR
    membership sweep (log2(max_degree) element-gather rounds), so the
    default is the smallest count whose residual is negligible: after the
    initial draw plus 2 re-rounds the residual is collision_rate^3 — at a
    1%-collision graph that is 1e-6 of the negatives.
    """
    n_neg = int(round(batch_size * negative_samples_rate))
    n_pos = batch_size - n_neg
    k_pos, k_neg = jax.random.split(key)

    arc = sample_positive_arcs(dg, k_pos, n_pos)
    pos_src = arc_sources(dg, arc)
    pos_dst = dg.col_idx[arc]

    avoid = graph_to_avoid if graph_to_avoid is not None else dg

    def sample_neg(k):
        k_s, k_d = jax.random.split(k)
        if use_scale_free_distribution:
            src = sample_nodes_scale_free(dg, k_s, (n_neg,))
            dst = sample_nodes_scale_free(dg, k_d, (n_neg,))
        else:
            src = sample_nodes_uniform(dg, k_s, (n_neg,))
            dst = sample_nodes_uniform(dg, k_d, (n_neg,))
        return src, dst

    src, dst = sample_neg(k_neg)
    if avoid_false_negatives:
        # Sequential check-and-resample rounds. (A single wide sweep over
        # all rounds' candidates was measured SLOWER — it pays
        # (rounds+1)/rounds the binary-search elements and the per-width
        # gather-rate gain does not compensate.)
        for i in range(n_attempts):
            bad = csr_has_edges(
                avoid.row_ptr, avoid.col_idx, src, dst,
                n_iters=_bsearch_iters(avoid),
            ) | (src == dst)
            k_neg = jax.random.fold_in(k_neg, i)
            new_src, new_dst = sample_neg(k_neg)
            src = jnp.where(bad, new_src, src)
            dst = jnp.where(bad, new_dst, dst)

    sources = jnp.concatenate([pos_src, src]).astype(jnp.int32)
    destinations = jnp.concatenate([pos_dst, dst]).astype(jnp.int32)
    labels = jnp.concatenate(
        [jnp.ones(n_pos, jnp.float32), jnp.zeros(n_neg, jnp.float32)]
    )
    return sources, destinations, labels


@functools.partial(
    jax.jit,
    static_argnames=("batch_size", "use_scale_free_distribution", "with_edge_types"),
)
def siamese_mini_batch(
    dg: DeviceGraph,
    key: jnp.ndarray,
    batch_size: int,
    use_scale_free_distribution: bool = True,
    with_edge_types: bool = False,
):
    """(src, dst, corrupted_src, corrupted_dst[, edge_type]) uint32 vectors —
    the reference's siamese/triple batch (`siamese_sequence.py:82-90`). One of
    (src, dst) is corrupted per sample, chosen by coin flip, as in standard
    KGE bernoulli-free corruption."""
    k_arc, k_node, k_side = jax.random.split(key, 3)
    arc = sample_positive_arcs(dg, k_arc, batch_size)
    src = arc_sources(dg, arc)
    dst = dg.col_idx[arc]
    if use_scale_free_distribution:
        rand_node = sample_nodes_scale_free(dg, k_node, (batch_size,))
    else:
        rand_node = sample_nodes_uniform(dg, k_node, (batch_size,))
    corrupt_src_side = jax.random.bernoulli(k_side, 0.5, (batch_size,))
    corr_src = jnp.where(corrupt_src_side, rand_node, src)
    corr_dst = jnp.where(corrupt_src_side, dst, rand_node)
    out = (src, dst, corr_src.astype(jnp.int32), corr_dst.astype(jnp.int32))
    if with_edge_types:
        etype = (
            dg.edge_types[arc]
            if dg.edge_types is not None
            else jnp.zeros(batch_size, jnp.int32)
        )
        out = out + (etype,)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_negatives", "use_scale_free_distribution", "per_walk",
    ),
)
def negative_nodes_for_nce(
    dg: DeviceGraph,
    key: jnp.ndarray,
    n_negatives: int,
    use_scale_free_distribution: bool = True,
    per_walk: int = 0,
) -> jnp.ndarray:
    """Negative node sample for an NCE/sampled-softmax step: [n_negatives]
    shared, or [per_walk, n_negatives] with one negative set per walk when
    `per_walk` > 0. Scale-free draw replaces TF's log-uniform sampler
    (which the reference approximates by degree-sorting node ids —
    `tensorflow_embedders/node2vec.py:204`); a degree-proportional draw is
    the exact distribution the log-uniform trick approximates.

    Per-walk negatives are the scale-correct regime (word2vec / the
    reference's Rust trainers sample negatives per CENTER): with one
    GLOBAL set, every negative row accumulates a gradient summed over ALL
    centers in the batch — at a 32k-walker production batch that is a
    ~10^6-term sum landing on 10 rows, which first freezes those rows at
    the margin and eventually drives a loss runaway."""
    shape = (
        (per_walk, n_negatives) if per_walk else (n_negatives,)
    )
    if use_scale_free_distribution:
        return sample_nodes_scale_free(dg, key, shape)
    return sample_nodes_uniform(dg, key, shape)


def edge_chunk(
    dg: DeviceGraph, chunk_index: int, chunk_size: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Deterministic enumeration of arcs in fixed-size chunks for inference —
    replaces `get_edge_prediction_chunk_mini_batch` (reference
    `generic_sequences/edge_prediction_sequence.py:77-99`). The final chunk is
    padded by clamping to the last arc; callers mask with `chunk_mask`."""
    start = chunk_index * chunk_size
    idx = jnp.clip(start + jnp.arange(chunk_size), 0, max(dg.n_arcs - 1, 0))
    return arc_sources(dg, idx), dg.col_idx[idx]


def chunk_mask(dg: DeviceGraph, chunk_index: int, chunk_size: int) -> jnp.ndarray:
    start = chunk_index * chunk_size
    return (start + jnp.arange(chunk_size)) < dg.n_arcs
