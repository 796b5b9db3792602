"""Walklets: multi-scale embeddings from stride-k walk pairs — reference
`ensmallen.models.Walklets{CBOW,SkipGram,GloVe}` via
`embiggen/embedders/ensmallen_embedders/node2vec.py:16-26`.

For each power p in 1..P, training pairs are walk positions exactly p apart
(capturing the p-hop scale); each power trains its own table of width
embedding_size // P and the result concatenates the scales.

Distribution (VERDICT r3 item 1): the SkipGram/CBOW variants express their
per-power sparse updates through the `minibatch.Update` protocol, so
`mesh=` runs the data-parallel step (walk slices per device, all-gathered
sparse payloads). The stacked [P, N, sub] tables shard per-POWER on axis 0,
not per-row, so the walk-embedder row-sharded strategy does not apply —
`distribution="rows"` falls back to data parallelism with a warning.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.graph import DeviceGraph, Graph
from ...ops.negatives import negative_nodes_for_nce
from ...ops.walks import random_walks
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .minibatch import Update, apply_updates, gather_updates
from .walk_based import WalkBasedEmbedder


class _WalkletsBase(WalkBasedEmbedder):
    def __init__(self, power: int = 4, **kwargs):
        self._power = power
        kwargs.setdefault("window_size", 4)
        super().__init__(**kwargs)
        if self.embedding_size % power:
            raise ValueError(
                f"embedding_size ({self.embedding_size}) must be divisible "
                f"by power ({power})."
            )

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "power": self._power}

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 4, "power": 2, "epochs": 1, "walk_length": 8,
            "window_size": 2, "batch_size": 32,
        }

    def _init_params(self, graph: Graph, key: jnp.ndarray):
        n = graph.number_of_nodes
        sub = self.embedding_size // self._power
        k1, k2 = jax.random.split(key)
        scale = 1.0 / np.sqrt(sub)
        return {
            # [P, N, sub] stacked per-power tables
            "node_embedding": scale
            * jax.random.normal(k1, (self._power, n, sub), jnp.float32),
            "context_embedding": scale
            * jax.random.normal(k2, (self._power, n, sub), jnp.float32),
            "context_bias": jnp.zeros((self._power, n), jnp.float32),
        }

    def _walks(self, dg: DeviceGraph, key):
        k_start, k_walk = jax.random.split(key)
        starts = jax.random.randint(
            k_start, (self._run_batch(),), 0, dg.n_nodes, dtype=jnp.int32
        )
        starts = jnp.tile(starts, self._iterations)
        return random_walks(
            dg, starts, self._walk_length, k_walk,
            return_weight=self._return_weight,
            explore_weight=self._explore_weight,
            max_neighbours=self._max_neighbours,
            change_node_type_weight=self._change_node_type_weight,
            change_edge_type_weight=self._change_edge_type_weight,
        )

    def _sample_walklets(self, dg: DeviceGraph, key):
        # Negatives are PER WALK ([B, K] — each walk's stride pairs
        # contrast against its own K draws), the scale-correct regime (see
        # `WalkBasedEmbedder._sample_batch`): a batch-shared set accumulates a
        # pair-count-sized gradient sum on K rows at production batches.
        k_walk, k_neg = jax.random.split(key)
        walks = self._walks(dg, k_walk)
        negs = negative_nodes_for_nce(
            dg, k_neg, self._number_of_negative_samples,
            self._use_scale_free_distribution,
            per_walk=walks.shape[0],
        )
        return walks, negs

    # ------------------------------------------------------ update protocol
    def _walklet_updates(self, params, walks, negs, full_walkers):
        """(loss, updates) over a slice of walks. Per-power losses are
        normalized by the FULL pair count so per-slice gradients sum to the
        single-chip gradients; `loss` psums to the mean-over-pairs summed
        over powers (divide by power for the reported value)."""
        raise NotImplementedError

    @classmethod
    def supports_distribution(cls) -> bool:
        return (
            cls._walklet_updates is not _WalkletsBase._walklet_updates
        )

    def _choose_distribution(self, mesh, graph: Graph) -> str:
        strategy = super()._choose_distribution(mesh, graph)
        if strategy == "rows":
            import warnings

            warnings.warn(
                "Walklets tables are stacked per-power; the row-sharded "
                "strategy does not apply — using data parallelism."
            )
            return "data"
        return strategy

    def _step(self, dg, params, key, lr):
        walks, negs = self._sample_walklets(dg, key)
        loss, updates = self._walklet_updates(
            params, walks, negs, walks.shape[0]
        )
        params = apply_updates(params, updates, lr)
        return params, loss / self._power

    def _make_dp_step(self, mesh, batch_size: int):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        axis = mesh.axis_names[0]
        p = int(mesh.devices.size)
        n_walkers = batch_size * self._iterations
        assert n_walkers % p == 0, (n_walkers, p)
        bp = n_walkers // p
        model = self

        def step(dg, params, key, lr):
            dg_spec = jax.tree_util.tree_map(lambda _: P(), dg)
            param_specs = jax.tree_util.tree_map(lambda _: P(), params)

            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(dg_spec, param_specs, P(), P()),
                out_specs=(param_specs, P()),
                check_vma=False,
            )
            def _run(dg_l, params_l, key_l, lr_l):
                walks, negs = model._sample_walklets(dg_l, key_l)
                i = jax.lax.axis_index(axis)
                my_walks = jax.lax.dynamic_slice_in_dim(
                    walks, i * bp, bp, axis=0
                )
                my_negs = jax.lax.dynamic_slice_in_dim(
                    negs, i * bp, bp, axis=0
                )
                loss, updates = model._walklet_updates(
                    params_l, my_walks, my_negs, n_walkers
                )
                params_l = apply_updates(
                    params_l, gather_updates(updates, axis), lr_l
                )
                return params_l, jax.lax.psum(loss, axis)

            params, loss = _run(dg, params, key, lr)
            return params, loss / self._power

        return step

    def _extract(self, params, graph):
        p, n, sub = params["node_embedding"].shape
        node = np.asarray(params["node_embedding"]).transpose(1, 0, 2).reshape(
            n, p * sub
        )
        ctx = np.asarray(params["context_embedding"]).transpose(1, 0, 2).reshape(
            n, p * sub
        )
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[
                self._post_process(node, graph),
                self._post_process(ctx, graph),
            ],
            node_names=graph.get_node_names(),
        )


@register_model
class WalkletsSkipGram(_WalkletsBase):
    @classmethod
    def model_name(cls) -> str:
        return "Walklets SkipGram"

    def _walklet_updates(self, params, walks, negs, full_walkers):
        total = 0.0
        updates = []
        length = walks.shape[1]
        for p_idx in range(self._power):
            stride = p_idx + 1
            m = length - stride
            a = walks[:, :m]
            c = walks[:, stride:]
            # Both directions, banded per walk: [b, 2m] word/context pairs
            # against the walk's own [b, K] negatives (one [b,2m,K]
            # batched matmul — pair-tiled negatives would need
            # [pairs, K, D] memory).
            words = jnp.concatenate([a, c], axis=1)
            contexts = jnp.concatenate([c, a], axis=1)
            n_full = 2 * full_walkers * m
            emb = params["node_embedding"][p_idx]
            ctx = params["context_embedding"][p_idx]
            bias = params["context_bias"][p_idx]

            def loss_fn(w_rows, c_rows, cb, n_rows, nb):
                # Per-pair NCE with num_true = 1: softplus(l) - l for the
                # positive, softplus for each of the walk's K negatives —
                # identical per-pair semantics to the shared-negative
                # formulation, only the negative identities moved per walk.
                # The loss is a raw SUM over pairs; the mean-mode row
                # update then gives every touched row one full-lr step on
                # the AVERAGE of its pair-gradients (the `_mean_scatter`
                # policy every other SGD family uses). Round-4 divided by
                # the full pair count AND raw-added — an effective
                # per-pair learning rate of lr/pairs that left Walklets at
                # link-AUROC ~0.5 (untrained) on the quality-gate graph.
                pos = jnp.sum(w_rows * c_rows, axis=-1) + cb     # [b, 2m]
                neg = jnp.einsum(
                    "bmd,bkd->bmk", w_rows, n_rows,
                    preferred_element_type=jnp.float32,
                ) + nb[:, None, :]
                return (
                    (jax.nn.softplus(pos) - pos).sum()
                    + jax.nn.softplus(neg).sum()
                )

            loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4))(
                emb[words], ctx[contexts], bias[contexts],
                ctx[negs], bias[negs],
            )
            g_w, g_c, g_cb, g_n, g_nb = grads
            sub = emb.shape[1]
            updates += [
                Update(
                    "node_embedding", (p_idx, words.reshape(-1)),
                    g_w.reshape(-1, sub), "mean",
                ),
                Update(
                    "context_embedding",
                    (p_idx, (contexts.reshape(-1), negs.reshape(-1))),
                    (g_c.reshape(-1, sub), g_n.reshape(-1, sub)), "mean",
                ),
                Update(
                    "context_bias",
                    (p_idx, (contexts.reshape(-1), negs.reshape(-1))),
                    (g_cb.reshape(-1), g_nb.reshape(-1)), "mean",
                ),
            ]
            total = total + loss / n_full
        return total, updates


@register_model
class WalkletsCBOW(_WalkletsBase):
    """CBOW at each scale: the stride-p 'context' is the single node p hops
    away (degenerate context of size 1 per side)."""

    @classmethod
    def model_name(cls) -> str:
        return "Walklets CBOW"

    def _walklet_updates(self, params, walks, negs, full_walkers):
        total = 0.0
        updates = []
        length = walks.shape[1]
        for p_idx in range(self._power):
            stride = p_idx + 1
            m = length - stride
            a = walks[:, :m]
            c = walks[:, stride:]
            # Both directions, banded per walk (see WalkletsSkipGram).
            contexts = jnp.concatenate([a, c], axis=1)   # CBOW input
            words = jnp.concatenate([c, a], axis=1)      # predicted centre
            n_full = 2 * full_walkers * m
            emb = params["node_embedding"][p_idx]
            out = params["context_embedding"][p_idx]
            bias = params["context_bias"][p_idx]

            def loss_fn(c_rows, t_rows, t_b, n_rows, n_b):
                # Sampled softmax, one true class vs the walk's K draws.
                # Raw SUM + mean-mode row updates (see WalkletsSkipGram).
                true_logit = jnp.sum(c_rows * t_rows, axis=-1) + t_b
                neg_logits = jnp.einsum(
                    "bmd,bkd->bmk", c_rows, n_rows,
                    preferred_element_type=jnp.float32,
                ) + n_b[:, None, :]
                logits = jnp.concatenate(
                    [true_logit[..., None], neg_logits], axis=-1
                )
                per = -jax.nn.log_softmax(logits, axis=-1)[..., 0]
                return per.sum()

            loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4))(
                emb[contexts], out[words], bias[words], out[negs], bias[negs]
            )
            g_c, g_t, g_tb, g_n, g_nb = grads
            sub = emb.shape[1]
            updates += [
                Update(
                    "node_embedding", (p_idx, contexts.reshape(-1)),
                    g_c.reshape(-1, sub), "mean",
                ),
                Update(
                    "context_embedding",
                    (p_idx, (words.reshape(-1), negs.reshape(-1))),
                    (g_t.reshape(-1, sub), g_n.reshape(-1, sub)), "mean",
                ),
                Update(
                    "context_bias",
                    (p_idx, (words.reshape(-1), negs.reshape(-1))),
                    (g_tb.reshape(-1), g_nb.reshape(-1)), "mean",
                ),
            ]
            total = total + loss / n_full
        return total, updates


@register_model
class WalkletsGloVe(_WalkletsBase):
    """True GloVe WLS per scale: exact-stride co-occurrence counts are
    accumulated once from a walk corpus, then each power's table minimizes
    f(X)(w·c + b_w + b_c − log X)² over its own non-zero entries. With
    `mesh=`, each power's SGD loop runs data-parallel over entry slices."""

    def __init__(self, alpha: float = 0.75, x_max: float = 100.0, **kwargs):
        self._alpha = alpha
        self._x_max = x_max
        super().__init__(**kwargs)

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(), "alpha": self._alpha, "x_max": self._x_max
        }

    @classmethod
    def model_name(cls) -> str:
        return "Walklets GloVe"

    @classmethod
    def supports_distribution(cls) -> bool:
        return True

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        from jax import lax

        from ...parallel.mesh import resolve_mesh

        dg = self._device_graph(graph)
        key = jax.random.PRNGKey(self.random_state or 0)
        n = graph.number_of_nodes
        starts = jnp.tile(jnp.arange(n, dtype=jnp.int32), self._iterations)
        walks = np.asarray(
            random_walks(
                dg, starts, self._walk_length, key,
                return_weight=self._return_weight,
                explore_weight=self._explore_weight,
                max_neighbours=self._max_neighbours,
                change_node_type_weight=self._change_node_type_weight,
                change_edge_type_weight=self._change_edge_type_weight,
            )
        )
        mesh = resolve_mesh(self._mesh)
        strategy = self._choose_distribution(mesh, graph)
        params = self._init_params(graph, key)
        last = None
        for p_idx in range(self._power):
            stride = p_idx + 1
            a = walks[:, :-stride].reshape(-1).astype(np.int64)
            b = walks[:, stride:].reshape(-1).astype(np.int64)
            keys_np = np.concatenate([a * n + b, b * n + a])
            keys_np.sort(kind="stable")
            uniq, start_idx = np.unique(keys_np, return_index=True)
            counts = np.diff(np.concatenate([start_idx, [len(keys_np)]]))
            ci_np = (uniq // n).astype(np.int32)
            cj_np = (uniq % n).astype(np.int32)
            keep = ci_np != cj_np
            ci = jnp.asarray(ci_np[keep])
            cj = jnp.asarray(cj_np[keep])
            counts = counts[keep].astype(np.float32)
            log_x = jnp.asarray(np.log(np.maximum(counts, 1e-9)))
            f_x = jnp.asarray(
                np.minimum(1.0, (counts / self._x_max) ** self._alpha)
            )
            n_entries = len(counts)
            batch = min(self._batch_size or 4096, n_entries)
            state = {
                "emb": params["node_embedding"][p_idx],
                "ctx": params["context_embedding"][p_idx],
                "bw": params["context_bias"][p_idx],
                "bc": jnp.zeros_like(params["context_bias"][p_idx]),
            }

            def sample(ctx_data, k, bsz):
                ci_d, cj_d, f_d, lx_d = ctx_data
                idx = jax.random.randint(k, (bsz,), 0, n_entries)
                return (ci_d[idx], cj_d[idx], f_d[idx], lx_d[idx])

            def batch_updates(st, sl, full_batch):
                i, j, f_d, lx_d = sl

                def loss_fn(w, c, bw, bc):
                    pred = jnp.sum(w * c, axis=1) + bw + bc
                    return (f_d * (pred - lx_d) ** 2).sum() / full_batch

                loss, (gw, gc, gbw, gbc) = jax.value_and_grad(
                    loss_fn, argnums=(0, 1, 2, 3)
                )(st["emb"][i], st["ctx"][j], st["bw"][i], st["bc"][j])
                return loss, [
                    Update("emb", i, gw, "add"),
                    Update("ctx", j, gc, "add"),
                    Update("bw", i, gbw, "add"),
                    Update("bc", j, gbc, "add"),
                ]

            ctx_data = (ci, cj, f_x, log_x)
            if strategy == "data":
                from jax import shard_map
                from jax.sharding import (
                    NamedSharding, PartitionSpec as P,
                )

                p = int(mesh.devices.size)
                # Round UP to the mesh (sampling is with replacement, so a
                # batch may exceed n_entries).
                batch = -(-batch // p) * p
                bp = batch // p
                axis = mesh.axis_names[0]

                def step(ctx_d, st, k, lr):
                    specs = jax.tree_util.tree_map(lambda _: P(), st)
                    ctx_specs = jax.tree_util.tree_map(lambda _: P(), ctx_d)

                    @functools.partial(
                        shard_map, mesh=mesh,
                        in_specs=(ctx_specs, specs, P(), P()),
                        out_specs=(specs, P()), check_vma=False,
                    )
                    def _run(ctx_l, st_l, k_l, lr_l):
                        sl = sample(ctx_l, k_l, batch)
                        i = jax.lax.axis_index(axis)
                        sl_i = jax.tree_util.tree_map(
                            lambda x: jax.lax.dynamic_slice_in_dim(
                                x, i * bp, bp, 0
                            ),
                            sl,
                        )
                        loss, ups = batch_updates(st_l, sl_i, batch)
                        st_l = apply_updates(
                            st_l, gather_updates(ups, axis), lr_l
                        )
                        return st_l, jax.lax.psum(loss, axis)

                    return _run(ctx_d, st, k, lr)

                replicated = NamedSharding(mesh, P())
                state = jax.device_put(state, replicated)
                ctx_data = jax.device_put(ctx_data, replicated)
            else:
                def step(ctx_d, st, k, lr):
                    sl = sample(ctx_d, k, batch)
                    loss, ups = batch_updates(st, sl, batch)
                    return apply_updates(st, ups, lr), loss

            steps = max(1, n_entries // batch)

            # Co-occurrence arrays ride the jit ARGUMENT path: closed-over
            # jax arrays lower as inline HLO constants (GBs at scale).
            @functools.partial(jax.jit, donate_argnums=1)
            def epoch_fn(ctx_d, st, epoch_key, lr):
                st, losses = lax.scan(
                    lambda s, k: step(ctx_d, s, k, lr),
                    st,
                    jax.random.split(epoch_key, steps),
                )
                return st, losses.mean()

            for epoch in range(self._epochs):
                lr = jnp.float32(
                    self._learning_rate * self._learning_rate_decay ** epoch
                )
                state, last = epoch_fn(
                    ctx_data, state, jax.random.fold_in(key, epoch * 131 + p_idx),
                    lr,
                )
            params["node_embedding"] = (
                params["node_embedding"].at[p_idx].set(
                    jax.device_get(state["emb"])
                )
            )
            params["context_embedding"] = (
                params["context_embedding"].at[p_idx].set(
                    jax.device_get(state["ctx"])
                )
            )
            params["context_bias"] = params["context_bias"].at[p_idx].set(
                jax.device_get(state["bw"])
            )
        self._last_loss = None if last is None else float(last)
        return self._extract(params, graph)
