"""Row-sharded embedding tables — the counterpart of the
reference's mmap-backed out-of-core embedding matrices (reference
`ensmallen_embedders/node2vec_skipgram.py:25-26` `central_nodes_embedding_path`
etc., SURVEY §2.10 "Out-of-core scale"): instead of spilling [N, D] to disk,
the table is partitioned by ROWS across the device mesh, so aggregate HBM
capacity — and therefore the maximum embedding-table size — scales linearly
with the number of chips.

Communication is bounded by the BATCH, never the table: a row gather is a
local masked lookup on each shard followed by one `psum` of the [B, D] batch
rows over the mesh axis; the sparse SGD scatter needs no communication at
all because each shard applies exactly the updates for rows it owns (the
gradient rows are replicated after the psum).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..graph.graph import DeviceGraph
from ..ops.negatives import negative_nodes_for_nce
from ..ops.walks import node2vec_batch


def padded_rows(n_rows: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= n_rows (shard_map needs even rows)."""
    return ((n_rows + n_shards - 1) // n_shards) * n_shards


def shard_rows_skipgram_params(
    params: Dict[str, jnp.ndarray], mesh: Mesh, axis: str = "nodes"
) -> Dict[str, jnp.ndarray]:
    """Pad tables to a multiple of the mesh size and place them row-sharded
    over `axis` (bias row-sharded too — it is per-node state)."""
    p = int(np.prod([mesh.shape[a] for a in (axis,)]))
    row_sharded = NamedSharding(mesh, P(axis))
    mat_sharded = NamedSharding(mesh, P(axis, None))

    def pad(x, sharding):
        n = x.shape[0]
        n_pad = padded_rows(n, p)
        if n_pad != n:
            widths = [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1)
            x = jnp.pad(x, widths)
        return jax.device_put(x, sharding)

    return {
        "node_embedding": pad(params["node_embedding"], mat_sharded),
        "context_embedding": pad(params["context_embedding"], mat_sharded),
        "context_bias": pad(params["context_bias"], row_sharded),
    }


def _owned(idx: jnp.ndarray, shard_rows: int, axis: str):
    """(local_index, ownership_mask) of each global index on this shard."""
    p_idx = jax.lax.axis_index(axis)
    local = idx - p_idx * shard_rows
    ok = (local >= 0) & (local < shard_rows)
    return jnp.clip(local, 0, shard_rows - 1), ok


def _gather_rows(shard: jnp.ndarray, idx: jnp.ndarray, axis: str):
    """Gather global rows `idx` from a row-sharded table: masked local
    lookup + one psum of the [B, ...] batch rows (comm ∝ batch size)."""
    local, ok = _owned(idx, shard.shape[0], axis)
    rows = shard[local]
    mask = ok[:, None] if rows.ndim > 1 else ok
    return jax.lax.psum(jnp.where(mask, rows, 0), axis)


def _scatter_add_owned(shard, idx, updates, axis):
    """Apply `updates` (replicated) only to rows this shard owns — no comm."""
    local, ok = _owned(idx, shard.shape[0], axis)
    mask = ok[:, None] if updates.ndim > 1 else ok
    return shard.at[local].add(jnp.where(mask, updates, 0))


def _mean_scatter_owned(shard, idx, grads, lr, axis, counts=None):
    """Row-sharded counterpart of `walk_based._mean_scatter`: a row appearing
    k times in the (replicated, global) `idx` receives the AVERAGE of its k
    gradients, once, at full lr — applied only by the owning shard, no comm.
    Counts use only a [shard_rows] buffer, shared across same-idx tables via
    the `counts` pass-back. Returns (updated_shard, counts).

    `idx`/`grads` may be tuples of aligned multiset segments (matching
    `_mean_scatter`'s segment API): segments scatter directly, skipping
    their concatenation."""
    segs = idx if isinstance(idx, tuple) else (idx,)
    gsegs = grads if isinstance(grads, tuple) else (grads,)
    owned = [_owned(s, shard.shape[0], axis) for s in segs]
    if counts is None:
        c = jnp.zeros((shard.shape[0],), jnp.float32)
        for local, ok in owned:
            c = c.at[local].add(ok.astype(jnp.float32))
        counts = c
    for (local, ok), g in zip(owned, gsegs):
        scale = ok.astype(jnp.float32) / jnp.maximum(counts[local], 1.0)
        if g.ndim > 1:
            scale = scale[:, None]
        shard = shard.at[local].add(-lr * g * scale)
    return shard, counts


class _RowShardView:
    """Read-only `table[idx]` facade over a row-sharded table inside a
    `shard_map` region: global-index gathers become masked local lookups +
    one psum (`_gather_rows`). Lets the minibatch embedder hooks
    (`models/embedders/minibatch.py::MinibatchEmbedder._batch_updates`),
    which were written against plain arrays, run unchanged under
    distribution='rows'."""

    __slots__ = ("shard", "axis")

    def __init__(self, shard, axis: str):
        self.shard = shard
        self.axis = axis

    def __getitem__(self, idx):
        idx = jnp.asarray(idx)
        flat = idx.reshape(-1)
        rows = _gather_rows(self.shard, flat, self.axis)
        return rows.reshape(idx.shape + self.shard.shape[1:])

    @property
    def ndim(self):
        return self.shard.ndim

    @property
    def dtype(self):
        return self.shard.dtype


def make_row_sharded_skipgram_step(
    mesh: Mesh,
    dg: DeviceGraph,
    batch_size: int,
    walk_length: int,
    window_size: int,
    iterations: int = 1,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    number_of_negative_samples: int = 10,
    axis: str = "nodes",
):
    """step(params, key, lr) -> (params, loss) with every table row-sharded
    over `axis`. Same objective as `make_sharded_skipgram_step` (the
    dim-sharded variant) — losses of the two paths agree to float tolerance —
    but HBM for the tables is split across chips by rows, the out-of-core
    axis (reference mmap paths, SURVEY §2.10)."""
    dg_spec = jax.tree_util.tree_map(lambda _: P(), dg)
    param_specs = {
        "node_embedding": P(axis, None),
        "context_embedding": P(axis, None),
        "context_bias": P(axis),
    }

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(param_specs, dg_spec, P(), P()),
        out_specs=(param_specs, P()),
        check_vma=False,
    )
    def step(params, dg_l, key, lr):
        # Identical replicated sampling on every shard (deterministic key).
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
        # Batch-bounded psum gathers of the needed rows.
        w = _gather_rows(emb, words, axis)                      # [N, D]
        flat_ctx = contexts.reshape(-1)
        c_pos = _gather_rows(ctx, flat_ctx, axis).reshape(
            contexts.shape + (emb.shape[1],)
        )
        c_neg = _gather_rows(ctx, negs, axis)                   # [K, D]
        b_pos = _gather_rows(bias, flat_ctx, axis).reshape(contexts.shape)
        b_neg = _gather_rows(bias, negs, axis)

        pos_logits = jnp.einsum("nd,npd->np", w, c_pos) + b_pos
        neg_logits = w @ c_neg.T + b_neg[None, :]
        n = w.shape[0]
        loss = (
            jax.nn.softplus(-pos_logits).sum()
            + jax.nn.softplus(neg_logits).sum()
        ) / n

        # Manual adjoints (replicated across shards after the psums).
        d_pos = -jax.nn.sigmoid(-pos_logits) / n           # [N, 2w]
        d_neg = jax.nn.sigmoid(neg_logits) / n             # [N, K]
        g_w = jnp.einsum("np,npd->nd", d_pos, c_pos) + d_neg @ c_neg
        g_cpos = d_pos[:, :, None] * w[:, None, :]
        g_cneg = d_neg.T @ w
        g_bpos = d_pos.reshape(-1)
        g_bneg = d_neg.sum(axis=0)

        d = emb.shape[1]
        params = {
            "node_embedding": _scatter_add_owned(
                emb, words, -lr * g_w, axis
            ),
            "context_embedding": _scatter_add_owned(
                _scatter_add_owned(
                    ctx, flat_ctx, -lr * g_cpos.reshape(-1, d), axis
                ),
                negs, -lr * g_cneg, axis,
            ),
            "context_bias": _scatter_add_owned(
                _scatter_add_owned(bias, flat_ctx, -lr * g_bpos, axis),
                negs, -lr * g_bneg, axis,
            ),
        }
        return params, loss

    # dg rides the jit ARGUMENT path via functools.partial (a closure
    # would lower the CSR arrays as inline HLO constants at graph scale).
    @functools.partial(jax.jit, donate_argnums=1)
    def jitted(dg, params, key, lr):
        return step(params, dg, key, lr)

    return functools.partial(jitted, dg)
