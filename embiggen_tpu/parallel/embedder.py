"""Model-parallel SkipGram training under shard_map: embedding tables sharded
along the embedding dimension ("model" axis).

Why dim-sharding (vs row-sharding or data parallelism): row gathers become
local column-slice gathers with ZERO communication; the only collective is a
`psum` of the per-shard partial dot products to form the NCE logits — a few
KB per step. Gradients w.r.t. each table shard are exact locally (the logit
adjoints are replicated after the psum), so the sparse scatter-add SGD
update needs no gradient synchronization at all. This is the counterpart of
the reference's single-host Rust trainer parallelism (SURVEY.md §2.10).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..graph.graph import DeviceGraph
from ..ops.negatives import negative_nodes_for_nce
from ..ops.walks import node2vec_batch


def shard_skipgram_params(
    params: Dict[str, jnp.ndarray], mesh: Mesh, axis: str = "model"
) -> Dict[str, jnp.ndarray]:
    """Place tables with columns sharded over `axis`, bias replicated."""
    col_sharded = NamedSharding(mesh, P(None, axis))
    replicated = NamedSharding(mesh, P())
    return {
        "node_embedding": jax.device_put(params["node_embedding"], col_sharded),
        "context_embedding": jax.device_put(
            params["context_embedding"], col_sharded
        ),
        "context_bias": jax.device_put(params["context_bias"], replicated),
    }


def make_sharded_skipgram_step(
    mesh: Mesh,
    dg: DeviceGraph,
    batch_size: int,
    walk_length: int,
    window_size: int,
    iterations: int = 1,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    number_of_negative_samples: int = 10,
    axis: str = "model",
):
    """Returns a jittable step(params, key, lr) -> (params, loss) running
    model-parallel over `axis`. Walks are computed redundantly on every device
    from the replicated graph and identical PRNG key (deterministic), so no
    batch scatter is needed."""

    dg_spec = jax.tree_util.tree_map(lambda _: P(), dg)
    param_specs = {
        "node_embedding": P(None, axis),
        "context_embedding": P(None, axis),
        "context_bias": P(),
    }

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_specs, dg_spec, P(), P()),
        out_specs=(param_specs, P()),
    )
    def step(params, dg_l, key, lr):
        k_pairs, k_walk, k_neg = jax.random.split(key, 3)
        starts = jax.random.randint(
            k_pairs, (batch_size,), 0, dg_l.n_nodes, dtype=jnp.int32
        )
        contexts, words = node2vec_batch(
            dg_l, starts, walk_length=walk_length, window_size=window_size,
            key=k_walk, iterations=iterations,
            return_weight=return_weight, explore_weight=explore_weight,
            max_neighbours=100,
        )
        negs = negative_nodes_for_nce(dg_l, k_neg, number_of_negative_samples)

        emb, ctx, bias = (
            params["node_embedding"],
            params["context_embedding"],
            params["context_bias"],
        )
        w = emb[words]                     # [N, D/P] local columns
        c_pos = ctx[contexts]              # [N, 2w, D/P]
        c_neg = ctx[negs]                  # [K, D/P]
        # Partial dots -> full logits via psum over the model axis.
        pos_logits = jax.lax.psum(
            jnp.einsum("nd,npd->np", w, c_pos), axis
        ) + bias[contexts]
        neg_logits = jax.lax.psum(w @ c_neg.T, axis) + bias[negs][None, :]
        n = w.shape[0]
        loss = (
            jax.nn.softplus(-pos_logits).sum()
            + jax.nn.softplus(neg_logits).sum()
        ) / n

        # Manual adjoints (replicated across shards after the psum).
        d_pos = -jax.nn.sigmoid(-pos_logits) / n          # [N, 2w]
        d_neg = jax.nn.sigmoid(neg_logits) / n            # [N, K]
        g_w = (
            jnp.einsum("np,npd->nd", d_pos, c_pos)
            + d_neg @ c_neg
        )                                                  # [N, D/P]
        g_cpos = d_pos[:, :, None] * w[:, None, :]         # [N, 2w, D/P]
        g_cneg = d_neg.T @ w                               # [K, D/P]
        g_bpos = d_pos                                     # [N, 2w]
        g_bneg = d_neg.sum(axis=0)                         # [K]

        dloc = w.shape[1]
        params = {
            "node_embedding": emb.at[words].add(-lr * g_w),
            "context_embedding": (
                ctx.at[contexts.reshape(-1)].add(
                    -lr * g_cpos.reshape(-1, dloc)
                ).at[negs].add(-lr * g_cneg)
            ),
            "context_bias": (
                bias.at[contexts.reshape(-1)].add(-lr * g_bpos.reshape(-1))
                .at[negs].add(-lr * g_bneg)
            ),
        }
        return params, loss

    # dg rides the jit ARGUMENT path via functools.partial (a closure
    # would lower the CSR arrays as inline HLO constants at graph scale).
    @functools.partial(jax.jit, donate_argnums=1)
    def jitted(dg, params, key, lr):
        return step(params, dg, key, lr)

    return functools.partial(jitted, dg)


def make_dp_skipgram_step(
    mesh: Mesh,
    dg: DeviceGraph,
    batch_size: int,
    walk_length: int,
    window_size: int,
    iterations: int = 1,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    number_of_negative_samples: int = 10,
    axis: str = "data",
):
    """Data-parallel SkipGram step: embedding tables replicated, each device
    walks its OWN batch (PRNG folded with the axis index), and the sparse
    per-batch gradients are exchanged as (indices, rows) pairs via
    `all_gather` — communication ∝ global batch size, never [N, D]. This is
    the counterpart of the reference's MultiWorkerMirroredStrategy
    data parallelism (`tensorflow_embedder.py:73-79,234-240`), which
    all-reduces DENSE embedding gradients. Suits small-to-medium tables with
    large batches; for HBM-bounded tables use the dim-sharded
    `make_sharded_skipgram_step` instead."""
    dg_spec = jax.tree_util.tree_map(lambda _: P(), dg)
    param_specs = {
        "node_embedding": P(),
        "context_embedding": P(),
        "context_bias": P(),
    }
    per_device_batch = max(1, batch_size // mesh.devices.size)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_specs, dg_spec, P(), P()),
        out_specs=(param_specs, P()),
        check_vma=False,
    )
    def step(params, dg_l, key, lr):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        k_pairs, k_walk, k_neg = jax.random.split(key, 3)
        starts = jax.random.randint(
            k_pairs, (per_device_batch,), 0, dg_l.n_nodes, dtype=jnp.int32
        )
        contexts, words = node2vec_batch(
            dg_l, starts, walk_length=walk_length, window_size=window_size,
            key=k_walk, iterations=iterations,
            return_weight=return_weight, explore_weight=explore_weight,
            max_neighbours=100,
        )
        negs = negative_nodes_for_nce(dg_l, k_neg, number_of_negative_samples)

        emb, ctx, bias = (
            params["node_embedding"],
            params["context_embedding"],
            params["context_bias"],
        )
        w = emb[words]
        c_pos = ctx[contexts]
        c_neg = ctx[negs]
        pos_logits = jnp.einsum("nd,npd->np", w, c_pos) + bias[contexts]
        neg_logits = w @ c_neg.T + bias[negs][None, :]
        n = w.shape[0]
        loss = (
            jax.nn.softplus(-pos_logits).sum()
            + jax.nn.softplus(neg_logits).sum()
        ) / n

        d_pos = -jax.nn.sigmoid(-pos_logits) / n
        d_neg = jax.nn.sigmoid(neg_logits) / n
        g_w = jnp.einsum("np,npd->nd", d_pos, c_pos) + d_neg @ c_neg
        g_cpos = d_pos[:, :, None] * w[:, None, :]
        g_cneg = d_neg.T @ w
        g_bpos = d_pos
        g_bneg = d_neg.sum(axis=0)

        d = w.shape[1]
        p = jax.lax.axis_size(axis)
        # Exchange sparse (index, grad-row) pairs; every device applies the
        # identical global update so tables stay replicated bit-for-bit.
        words_g = jax.lax.all_gather(words, axis).reshape(-1)
        g_w_g = jax.lax.all_gather(g_w, axis).reshape(-1, d)
        ctx_idx_g = jax.lax.all_gather(
            contexts.reshape(-1), axis
        ).reshape(-1)
        g_cpos_g = jax.lax.all_gather(
            g_cpos.reshape(-1, d), axis
        ).reshape(-1, d)
        negs_g = jax.lax.all_gather(negs, axis).reshape(-1)
        g_cneg_g = jax.lax.all_gather(g_cneg, axis).reshape(-1, d)
        g_bpos_g = jax.lax.all_gather(
            g_bpos.reshape(-1), axis
        ).reshape(-1)
        g_bneg_g = jax.lax.all_gather(g_bneg, axis).reshape(-1)

        params = {
            "node_embedding": emb.at[words_g].add(-lr * g_w_g),
            "context_embedding": (
                ctx.at[ctx_idx_g].add(-lr * g_cpos_g)
                .at[negs_g].add(-lr * g_cneg_g)
            ),
            "context_bias": (
                bias.at[ctx_idx_g].add(-lr * g_bpos_g)
                .at[negs_g].add(-lr * g_bneg_g)
            ),
        }
        loss = jax.lax.psum(loss, axis) / p
        return params, loss

    # dg rides the jit ARGUMENT path via functools.partial (a closure
    # would lower the CSR arrays as inline HLO constants at graph scale).
    @functools.partial(jax.jit, donate_argnums=1)
    def jitted(dg, params, key, lr):
        return step(params, dg, key, lr)

    return functools.partial(jitted, dg)
