"""Walk-based embedders: SkipGram / CBOW / GloVe over node2vec walks, plus the
DeepWalk / Node2Vec / Walklets presets — the JAX counterpart of both the
reference's TF embedders (`embiggen/embedders/tensorflow_embedders/{skipgram,
cbow,node2vec}.py`) and the Rust whole-training models
(`ensmallen_embedders/node2vec.py:16-112`).

Architecture (BASELINE.json north star): walks, window extraction, negative
sampling, loss and the sparse SGD update all run inside ONE jitted step; an
epoch is a `lax.scan` over steps with the embedding tables donated, so the
entire training loop lives on-device with zero host round-trips per step.
Gradients are taken w.r.t. *gathered* rows only and scatter-added back —
embedding-table-sparse SGD, never densified.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...graph.graph import DeviceGraph, Graph
from ...ops import losses as L
from ...ops.negatives import negative_nodes_for_nce
from ...ops.walks import node2vec_batch, random_walks, skipgram_pairs
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from ..registry import register_model


class WalkBasedEmbedder(AbstractEmbeddingModel):
    """Shared training skeleton for walk-based embedders.

    Walk hyper-parameters mirror the reference surface
    (`abstract_random_walked_based_embedder_model.py:8-158`): window_size,
    walk_length, iterations, return_weight (1/p), explore_weight (1/q),
    max_neighbours; SGD hyper-parameters mirror the Rust trainers
    (`ensmallen_embedders/node2vec_skipgram.py:14-36`): epochs, learning_rate
    with multiplicative decay, number_of_negative_samples, scale-free negative
    distribution."""

    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 10,
        batch_size: Optional[int] = None,
        walk_length: int = 64,
        iterations: int = 1,
        window_size: int = 5,
        return_weight: float = 1.0,
        explore_weight: float = 1.0,
        change_node_type_weight: float = 1.0,
        change_edge_type_weight: float = 1.0,
        max_neighbours: Optional[int] = 100,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.9,
        number_of_negative_samples: int = 10,
        use_scale_free_distribution: bool = True,
        clipping_value: float = 6.0,
        normalize_by_degree: bool = False,
        stochastic_downsample_by_degree: bool = False,
        normalize_learning_rate_by_degree: bool = False,
        early_stopping_min_delta: float = 0.001,
        early_stopping_patience: int = 1,
        learning_rate_plateau_min_delta: float = 0.001,
        learning_rate_plateau_patience: int = 1,
        mesh=None,
        distribution: str = "auto",
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 1,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        # batch_size=None auto-scales with the graph (see `_resolve_batch`):
        # a fixed tiny walker batch leaves the device idle on large graphs.
        # `mesh` (None | "auto" | int | jax.sharding.Mesh) opts into
        # multi-device training — the counterpart of the reference's
        # `use_mirrored_strategy` flag (`tensorflow_embedder.py:73-79`);
        # `distribution` picks the strategy: "auto" (data-parallel, or
        # row-sharded tables once they outgrow one device's memory, see
        # `parallel.mesh.auto_distribution`), "data", "rows", or "none".
        self._epochs = epochs
        self._batch_size = batch_size
        self._mesh = mesh
        if distribution not in ("auto", "data", "rows", "none"):
            raise ValueError(
                "distribution must be one of 'auto', 'data', 'rows', "
                f"'none'; got {distribution!r}."
            )
        self._distribution = distribution
        self._walk_length = walk_length
        self._iterations = iterations
        self._window_size = window_size
        self._return_weight = return_weight
        self._explore_weight = explore_weight
        # Typed transition re-weighting (reference
        # `abstract_random_walked_based_embedder_model.py:8-158`); factors
        # are inert on graphs without the corresponding type annotations.
        self._change_node_type_weight = change_node_type_weight
        self._change_edge_type_weight = change_edge_type_weight
        self._max_neighbours = max_neighbours
        self._learning_rate = learning_rate
        self._learning_rate_decay = learning_rate_decay
        self._number_of_negative_samples = number_of_negative_samples
        self._use_scale_free_distribution = use_scale_free_distribution
        self._clipping_value = clipping_value
        # Degree-conditioned SGD knobs of the reference Rust trainers
        # (`ensmallen_embedders/node2vec_skipgram.py:25-36`):
        # - stochastic_downsample_by_degree: word2vec-style frequency
        #   subsampling of walk CENTERS — a centre of degree d is kept with
        #   probability min(1, sqrt(1e-3 · E / d)) (node frequency in the
        #   walk corpus is d/E under the stationary distribution);
        # - normalize_learning_rate_by_degree: each centre's pair-gradients
        #   are scaled by mean_degree / degree(centre), damping hub updates
        #   without changing the global step size;
        # - normalize_by_degree: final embedding rows divided by their
        #   node's degree at extraction.
        self._normalize_by_degree = normalize_by_degree
        self._stochastic_downsample_by_degree = stochastic_downsample_by_degree
        self._normalize_learning_rate_by_degree = (
            normalize_learning_rate_by_degree
        )
        # Early stopping + LR-on-plateau, default-on like the reference's
        # Keras callbacks (`tensorflow_embedder.py:264-277`: EarlyStopping
        # min_delta 0.001 patience 1; ReduceLROnPlateau factor 0.5).
        self._early_stopping_min_delta = early_stopping_min_delta
        self._early_stopping_patience = early_stopping_patience
        self._learning_rate_plateau_min_delta = learning_rate_plateau_min_delta
        self._learning_rate_plateau_patience = learning_rate_plateau_patience
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = max(1, checkpoint_interval)
        super().__init__(
            embedding_size=embedding_size,
            enable_cache=enable_cache,
            random_state=random_state,
        )
        if walk_length <= 2 * window_size:
            raise ValueError(
                f"walk_length ({walk_length}) must exceed 2*window_size "
                f"({2 * window_size})."
            )

    def _resolve_batch(self, graph: Graph) -> int:
        """Concrete walker batch for this graph: explicit value, or an
        auto-scaled default — N/8 concurrent walkers, so that one step has
        enough work to keep the device busy (a batch of 128 walkers leaves
        it nearly idle at 1M nodes), capped at 32768 so the [B, L, D]
        gathered-row intermediates stay small against device memory."""
        if self._batch_size is not None:
            return self._batch_size
        return int(min(32768, max(128, graph.number_of_nodes // 8)))

    def parameters(self) -> Dict[str, Any]:
        mesh = self._mesh
        if mesh is not None and not isinstance(mesh, (int, str)):
            mesh = int(np.prod(list(mesh.devices.shape)))
        return {
            **super().parameters(),
            "epochs": self._epochs,
            "batch_size": self._batch_size,
            "mesh": mesh,
            "distribution": self._distribution,
            "walk_length": self._walk_length,
            "iterations": self._iterations,
            "window_size": self._window_size,
            "return_weight": self._return_weight,
            "explore_weight": self._explore_weight,
            "change_node_type_weight": self._change_node_type_weight,
            "change_edge_type_weight": self._change_edge_type_weight,
            "max_neighbours": self._max_neighbours,
            "learning_rate": self._learning_rate,
            "learning_rate_decay": self._learning_rate_decay,
            "number_of_negative_samples": self._number_of_negative_samples,
            "use_scale_free_distribution": self._use_scale_free_distribution,
            "clipping_value": self._clipping_value,
            "normalize_by_degree": self._normalize_by_degree,
            "stochastic_downsample_by_degree":
                self._stochastic_downsample_by_degree,
            "normalize_learning_rate_by_degree":
                self._normalize_learning_rate_by_degree,
            "early_stopping_min_delta": self._early_stopping_min_delta,
            "early_stopping_patience": self._early_stopping_patience,
            "learning_rate_plateau_min_delta":
                self._learning_rate_plateau_min_delta,
            "learning_rate_plateau_patience":
                self._learning_rate_plateau_patience,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 5,
            "epochs": 1,
            "walk_length": 8,
            "window_size": 2,
            "batch_size": 32,
            "iterations": 1,
        }

    @classmethod
    def can_use_edge_weights(cls) -> bool:
        return True

    def is_using_edge_weights(self) -> bool:
        return True

    # Typed-walk capability contract, mirroring the reference exactly
    # (`abstract_random_walked_based_embedder_model.py:147-158`):
    # is_using_node_types ⇔ change_node_type_weight != 1.0, and likewise
    # for edge types.
    @classmethod
    def can_use_node_types(cls) -> bool:
        return True

    def is_using_node_types(self) -> bool:
        return self._change_node_type_weight != 1.0

    @classmethod
    def can_use_edge_types(cls) -> bool:
        return True

    def is_using_edge_types(self) -> bool:
        return self._change_edge_type_weight != 1.0

    # ------------------------------------------------------- subclass surface
    def _init_params(self, graph: Graph, key: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        raise NotImplementedError

    def _gathered_grads(self, gather, walks, negs, center_w=None):
        """(loss_sum, row_grads, neg_grads) for a slice of walks.

        `gather(table_name, idx)` returns the table rows for `idx` — plain
        indexing single-chip, psum-gather when tables are row-sharded.
        `row_grads` are per-walk-position gradients [b, L, ...] (one entry
        per table touched by walk rows), `neg_grads` are [b, K, ...]
        gradients of the slice's per-walk negatives. `center_w` ([b, L] or
        None) multiplies each centre's pair losses (degree-conditioned SGD
        knobs). Implementing this hook (plus `_apply_table_grads`) is what
        makes a model distributable."""
        raise NotImplementedError

    def _apply_table_grads(
        self, params, flat, row_grads, negs_flat, neg_grads, lr,
        mean_scatter,
    ):
        """Apply flattened walk-row gradients (`flat` indices) and
        flattened per-walk negative gradients (`negs_flat` indices) to the
        tables. `mean_scatter(table, idx, grads, lr)` abstracts over
        single-chip vs owned-row-sharded scatters; negatives use the SAME
        per-row-mean policy as walk rows (symmetric word2vec-style
        treatment — each touched row takes one full-lr averaged step per
        batch)."""
        raise NotImplementedError

    @classmethod
    def supports_distribution(cls) -> bool:
        """True when the model implements the gathered-grads hooks (and can
        therefore train data-parallel / row-sharded on a mesh)."""
        return (
            cls._gathered_grads is not WalkBasedEmbedder._gathered_grads
            and cls._apply_table_grads
            is not WalkBasedEmbedder._apply_table_grads
        )

    def _extract(
        self, params: Dict[str, jnp.ndarray], graph: Graph
    ) -> EmbeddingResult:
        raise NotImplementedError

    def _post_process(self, table, graph: Graph):
        """Extraction-time post-processing: `normalize_by_degree` divides
        each node's embedding row by its degree (reference Rust trainer
        flag, `node2vec_skipgram.py:27`)."""
        from ...utils.transfer import pull_to_host

        table = pull_to_host(table)
        if self._normalize_by_degree:
            deg = np.maximum(graph.degrees.astype(np.float32), 1.0)
            table = table / deg[(...,) + (None,) * (table.ndim - 1)]
        return table

    # ----------------------------------------------------------- training loop
    def _walks_are_biased(self) -> bool:
        """True when walks need per-candidate weighting (p/q and/or typed
        factors) — these route through the ELL row-gather sampler."""
        return (
            self._return_weight != 1.0
            or self._explore_weight != 1.0
            or self._change_node_type_weight != 1.0
            or self._change_edge_type_weight != 1.0
        )

    def _ell_cap_for_walks(self):
        """ELLPACK cap to build at `graph.device()` time: biased (p/q or
        typed) walks route through the row-gather sampler
        (`ops/walks.py::_second_order_step_ell`), which needs the capped
        adjacency table; plain first-order walks don't."""
        if not self._walks_are_biased():
            return None
        return self._max_neighbours or 100

    def _device_graph(self, graph: Graph) -> DeviceGraph:
        """Export the graph for this model's walk configuration: alias
        tables on weighted graphs, ELL adjacency for biased walks (with a
        random_state-seeded hub subsample), typed-slot tables when typed
        factors are active."""
        typed = (
            self._change_node_type_weight != 1.0
            or self._change_edge_type_weight != 1.0
        )
        return graph.device(
            with_alias=graph.has_edge_weights,
            ell_cap=self._ell_cap_for_walks(),
            with_walk_types=typed,
            ell_seed=self.random_state or 0,
        )

    def _run_batch(self) -> int:
        """Walker batch in effect for the current run (set by
        `_fit_transform`; constructor value or 128 when stepping outside a
        fit, e.g. benchmarks driving `_step` directly)."""
        b = getattr(self, "_run_batch_size", None)
        if b is not None:
            return b
        return self._batch_size if self._batch_size is not None else 128

    def _sample_pairs(
        self, dg: DeviceGraph, key: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(contexts [N, 2w], words [N]) for one step: random start nodes →
        walks → windows, all on device (used by pair-based models, e.g.
        Role2Vec)."""
        k_start, k_walk = jax.random.split(key)
        starts = jax.random.randint(
            k_start, (self._run_batch(),), 0, dg.n_nodes, dtype=jnp.int32
        )
        return node2vec_batch(
            dg,
            starts,
            walk_length=self._walk_length,
            window_size=self._window_size,
            key=k_walk,
            iterations=self._iterations,
            return_weight=self._return_weight,
            explore_weight=self._explore_weight,
            max_neighbours=self._max_neighbours,
            change_node_type_weight=self._change_node_type_weight,
            change_edge_type_weight=self._change_edge_type_weight,
        )

    def _sample_batch(
        self, dg: DeviceGraph, key: jnp.ndarray, batch_size: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(walks [B·iters, L], negatives [B·iters, K]) for one step — the
        SAME key stream on every device, so the distributed paths train on
        exactly the batches the single-chip path would (replicated
        sampling, sharded math). Negatives are PER WALK (each walk's L−2w
        centres contrast against its own K draws): with one batch-global
        set, every negative row would accumulate a gradient summed over
        ALL centres — a ~10^6-term sum at the 32k-walker production batch
        that freezes those rows and eventually drives a loss runaway
        (word2vec and the reference's Rust trainers sample negatives per
        centre for the same reason)."""
        k_start, k_walk, k_neg = jax.random.split(key, 3)
        starts = jax.random.randint(
            k_start, (batch_size,), 0, dg.n_nodes, dtype=jnp.int32
        )
        walks = random_walks(
            dg,
            jnp.tile(starts, self._iterations),
            self._walk_length,
            k_walk,
            return_weight=self._return_weight,
            explore_weight=self._explore_weight,
            max_neighbours=self._max_neighbours,
            change_node_type_weight=self._change_node_type_weight,
            change_edge_type_weight=self._change_edge_type_weight,
        )
        negs = negative_nodes_for_nce(
            dg, k_neg, self._number_of_negative_samples,
            self._use_scale_free_distribution,
            per_walk=batch_size * self._iterations,
        )
        return walks, negs

    def _center_weights(
        self, dg: DeviceGraph, walks: jnp.ndarray, key: jnp.ndarray
    ) -> Optional[jnp.ndarray]:
        """[B, L] per-centre loss weight implementing the degree-conditioned
        SGD knobs (see __init__ comment), or None when both are off. The
        weight multiplies every pair loss whose CENTRE sits at that walk
        position, which is exactly a per-pair learning rate in SGD."""
        if not (
            self._stochastic_downsample_by_degree
            or self._normalize_learning_rate_by_degree
        ):
            return None
        deg = jnp.maximum(dg.degrees[walks].astype(jnp.float32), 1.0)
        w = jnp.ones(walks.shape, jnp.float32)
        if self._normalize_learning_rate_by_degree:
            mean_deg = max(dg.n_arcs / max(dg.n_nodes, 1), 1.0)
            w = w * jnp.minimum(mean_deg / deg, 1.0)
        if self._stochastic_downsample_by_degree:
            keep_p = jnp.minimum(
                jnp.sqrt(1e-3 * max(dg.n_arcs, 1) / deg), 1.0
            )
            keep = jax.random.uniform(
                jax.random.fold_in(key, 0xD0DD), walks.shape
            ) < keep_p
            w = w * keep.astype(jnp.float32)
        return w

    def _step(
        self,
        dg: DeviceGraph,
        params: Dict[str, jnp.ndarray],
        key: jnp.ndarray,
        lr: jnp.ndarray,
    ) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
        """Single-chip fused step via the gathered-grads hooks: sample →
        gather rows → grads → sparse scatter update. Models that don't
        implement the hooks override this directly."""
        batch = self._run_batch()
        walks, negs = self._sample_batch(dg, key, batch)
        center_w = self._center_weights(dg, walks, key)

        def gather(name, idx):
            return params[name][idx]

        loss, row_grads, neg_grads = self._gathered_grads(
            gather, walks, negs, center_w
        )
        flat = walks.reshape(-1)
        row_flat = tuple(
            g.reshape((-1,) + g.shape[2:]) for g in row_grads
        )
        neg_flat = tuple(
            g.reshape((-1,) + g.shape[2:]) for g in neg_grads
        )
        params = self._apply_table_grads(
            params, flat, row_flat, negs.reshape(-1), neg_flat, lr,
            mean_scatter=_mean_scatter,
        )
        n_centers = walks.shape[0] * (
            self._walk_length - 2 * self._window_size
        )
        return params, loss / n_centers

    # ------------------------------------------------- distributed step paths
    def _make_dp_step(self, mesh, batch_size: int):
        """Data-parallel step over `mesh` (replicated tables): every device
        samples the identical global batch, computes gradients for ITS slice
        of the walks, all-gathers the sparse (walk-position → grad-row)
        payload — communication ∝ batch, never [N, D], unlike the dense
        all-reduce of the reference's MirroredStrategy — and applies the
        identical global update. Bit-equal to the single-chip step up to
        float reduction order."""
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
                walks, negs = model._sample_batch(dg_l, key_l, batch_size)
                center_w = model._center_weights(dg_l, walks, key_l)
                i = jax.lax.axis_index(axis)
                my_walks = jax.lax.dynamic_slice_in_dim(
                    walks, i * bp, bp, axis=0
                )
                my_negs = jax.lax.dynamic_slice_in_dim(
                    negs, i * bp, bp, axis=0
                )
                my_cw = None if center_w is None else (
                    jax.lax.dynamic_slice_in_dim(center_w, i * bp, bp, axis=0)
                )

                def gather(name, idx):
                    return params_l[name][idx]

                loss, row_grads, neg_grads = model._gathered_grads(
                    gather, my_walks, my_negs, my_cw
                )
                # Sparse exchange: concatenate per-device grad rows in axis
                # order — matches walks.reshape(-1) (and negs.reshape(-1))
                # element order exactly.
                row_flat = tuple(
                    jax.lax.all_gather(
                        g.reshape((-1,) + g.shape[2:]), axis, tiled=True
                    )
                    for g in row_grads
                )
                neg_flat = tuple(
                    jax.lax.all_gather(
                        g.reshape((-1,) + g.shape[2:]), axis, tiled=True
                    )
                    for g in neg_grads
                )
                params_l = model._apply_table_grads(
                    params_l, walks.reshape(-1), row_flat,
                    negs.reshape(-1), neg_flat, lr_l,
                    mean_scatter=_mean_scatter,
                )
                loss = jax.lax.psum(loss, axis)
                return params_l, loss

            params, loss = _run(dg, params, key, lr)
            n_centers = n_walkers * (
                self._walk_length - 2 * self._window_size
            )
            return params, loss / n_centers

        return step

    def _make_row_sharded_step(self, mesh, batch_size: int):
        """Row-sharded-table step over `mesh` — the out-of-core axis
        (reference mmap embedding paths, `node2vec_skipgram.py:25-26`):
        aggregate HBM for the [N, D] tables scales with chips. Row gathers
        are masked local lookups + one psum (comm ∝ batch); scatter updates
        touch only owned rows (no comm). Same replicated sampling → same
        batches as single-chip."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from ...parallel.sharded_table import (
            _gather_rows,
            _mean_scatter_owned,
        )

        axis = mesh.axis_names[0]
        n_walkers = batch_size * self._iterations
        model = self

        def step(dg, params, key, lr):
            dg_spec = jax.tree_util.tree_map(lambda _: P(), dg)
            param_specs = jax.tree_util.tree_map(
                lambda leaf: P(axis, *([None] * (leaf.ndim - 1))), params
            )

            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(dg_spec, param_specs, P(), P()),
                out_specs=(param_specs, P()),
                check_vma=False,
            )
            def _run(dg_l, params_l, key_l, lr_l):
                walks, negs = model._sample_batch(dg_l, key_l, batch_size)
                center_w = model._center_weights(dg_l, walks, key_l)

                def gather(name, idx):
                    table = params_l[name]
                    flat_idx = idx.reshape(-1)
                    rows = _gather_rows(table, flat_idx, axis)
                    return rows.reshape(idx.shape + table.shape[1:])

                loss, row_grads, neg_grads = model._gathered_grads(
                    gather, walks, negs, center_w
                )
                row_flat = tuple(
                    g.reshape((-1,) + g.shape[2:]) for g in row_grads
                )
                neg_flat = tuple(
                    g.reshape((-1,) + g.shape[2:]) for g in neg_grads
                )
                params_l = model._apply_table_grads(
                    params_l, walks.reshape(-1), row_flat,
                    negs.reshape(-1), neg_flat, lr_l,
                    mean_scatter=functools.partial(
                        _mean_scatter_owned, axis=axis
                    ),
                )
                return params_l, loss

            params, loss = _run(dg, params, key, lr)
            n_centers = n_walkers * (
                self._walk_length - 2 * self._window_size
            )
            return params, loss / n_centers

        return step

    def _choose_distribution(self, mesh, graph: Graph) -> str:
        """'data' | 'rows' | 'none' for this (mesh, graph)."""
        if mesh is None or self._distribution == "none":
            return "none"
        if not self.supports_distribution():
            import warnings

            warnings.warn(
                f"{type(self).__name__} does not implement the distributed "
                "training hooks; falling back to single-device training."
            )
            return "none"
        if self._distribution != "auto":
            return self._distribution
        # Auto: row-shard once the two [N, D] tables + bias stop fitting
        # comfortably on one device, else data-parallel.
        from ...parallel.mesh import auto_distribution

        table_bytes = graph.number_of_nodes * (
            2 * self.embedding_size * 4 + 4
        )
        return auto_distribution(table_bytes, mesh.devices.flat[0])

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        from ...parallel.mesh import resolve_mesh

        dg = self._device_graph(graph)
        key = jax.random.PRNGKey(self.random_state or 0)
        mesh = resolve_mesh(self._mesh)
        strategy = self._choose_distribution(mesh, graph)
        batch = self._resolve_batch(graph)
        if strategy in ("data", "rows"):
            # Walk slices must divide evenly over the mesh.
            p = int(mesh.devices.size)
            batch = -(-batch // p) * p
        self._run_batch_size = batch
        params = self._init_params(graph, key)
        steps_per_epoch = max(1, graph.number_of_nodes // batch)

        place_fn = None
        if strategy == "data":
            step_fn = self._make_dp_step(mesh, batch)
            from jax.sharding import NamedSharding, PartitionSpec as P

            replicated = NamedSharding(mesh, P())
            place_fn = lambda prm: jax.device_put(prm, replicated)  # noqa: E731
            dg = jax.device_put(dg, replicated)
            key = jax.device_put(key, replicated)
        elif strategy == "rows":
            step_fn = self._make_row_sharded_step(mesh, batch)
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ...parallel.sharded_table import padded_rows

            p = int(mesh.devices.size)

            def place(leaf):
                n = leaf.shape[0]
                n_pad = padded_rows(n, p)
                if n_pad != n:
                    leaf = jnp.pad(
                        leaf,
                        [(0, n_pad - n)] + [(0, 0)] * (leaf.ndim - 1),
                    )
                spec = P(mesh.axis_names[0], *([None] * (leaf.ndim - 1)))
                return jax.device_put(leaf, NamedSharding(mesh, spec))

            place_fn = lambda prm: jax.tree_util.tree_map(place, prm)  # noqa: E731
            dg = jax.device_put(dg, NamedSharding(mesh, P()))
            key = jax.device_put(key, NamedSharding(mesh, P()))
        else:
            step_fn = self._step
        if place_fn is not None:
            params = place_fn(params)

        # Mid-training checkpointing (SURVEY §5.4: a capability the reference
        # lacks). Per-epoch PRNG keys are fold_in(key, epoch) and lr is a pure
        # function of the epoch index, so resuming from (params, epoch) is
        # bit-identical to an uninterrupted run. The checkpoint carries a
        # fingerprint of (model, graph, hyper-params); a file written by a
        # different run is ignored, and the file is deleted on completion —
        # otherwise a finished 34-node run would silently serve its embedding
        # to a later 100-node fit sharing the checkpoint_dir.
        from ...utils.plateau import PlateauController

        ctrl = PlateauController(
            early_stopping_min_delta=self._early_stopping_min_delta,
            early_stopping_patience=self._early_stopping_patience,
            learning_rate_plateau_min_delta=(
                self._learning_rate_plateau_min_delta
            ),
            learning_rate_plateau_patience=(
                self._learning_rate_plateau_patience
            ),
        )
        ckpt_path = None
        ckpt_fp = None
        start_epoch = 0
        if self._checkpoint_dir is not None:
            import os

            from ...utils.checkpoint import (
                checkpoint_exists,
                checkpoint_matches,
                load_pytree,
                save_pytree,
            )

            ckpt_path = os.path.join(self._checkpoint_dir, "embed_state")
            ckpt_fp = "|".join(
                str(x)
                for x in (
                    type(self).__name__,
                    getattr(graph, "name", ""),
                    graph.number_of_nodes,
                    graph.number_of_directed_edges,
                    self.embedding_size,
                    self._epochs,
                    self._batch_size,
                    self._walk_length,
                    self.random_state,
                )
            )
            if checkpoint_exists(ckpt_path):
                if checkpoint_matches(ckpt_path, ckpt_fp):
                    state = load_pytree(
                        ckpt_path,
                        like={
                            "params": params,
                            "epoch": np.int64(0),
                            "ctrl": ctrl.state_array(),
                        },
                    )
                    params = jax.tree_util.tree_map(
                        jnp.asarray, state["params"]
                    )
                    if place_fn is not None:
                        params = place_fn(params)
                    start_epoch = int(state["epoch"])
                    ctrl.load_state_array(state["ctrl"])
                else:
                    import warnings

                    warnings.warn(
                        f"Ignoring checkpoint at {ckpt_path}: it was written "
                        "by a different model/graph/hyper-parameter run."
                    )

        # dg is a jit ARGUMENT (pytree), not a closure constant: captured
        # device arrays would otherwise be serialized into the program on
        # remote-compile backends.
        @functools.partial(jax.jit, donate_argnums=1)
        def epoch_fn(dg, params, epoch_key, lr):
            keys = jax.random.split(epoch_key, steps_per_epoch)

            def body(p, k):
                return step_fn(dg, p, k, lr)

            params, losses = lax.scan(body, params, keys)
            return params, losses.mean()

        # Per-epoch plateau control, default-on like the reference
        # (`tensorflow_embedder.py:264-277`): the scanned epoch-mean loss is
        # read host-side between epochs; LR picks up the plateau factor on
        # top of the multiplicative decay, and training stops once the loss
        # stalls for `early_stopping_patience` epochs.
        last_loss = None
        for epoch in range(start_epoch, self._epochs):
            lr = jnp.float32(
                self._learning_rate
                * self._learning_rate_decay ** epoch
                * ctrl.lr_scale
            )
            params, last_loss = epoch_fn(
                dg, params, jax.random.fold_in(key, epoch), lr
            )
            stop = ctrl.update(float(last_loss))
            if (
                ckpt_path is not None
                and (epoch + 1) % self._checkpoint_interval == 0
                and epoch + 1 < self._epochs
                and not stop
            ):
                save_pytree(
                    ckpt_path,
                    {
                        "params": jax.tree_util.tree_map(np.asarray, params),
                        "epoch": np.int64(epoch + 1),
                        "ctrl": ctrl.state_array(),
                    },
                    fingerprint=ckpt_fp,
                )
            if stop:
                ctrl.stopped_epoch = epoch
                break
        if ckpt_path is not None:
            from ...utils.checkpoint import delete_checkpoint

            delete_checkpoint(ckpt_path)
        self._last_loss = None if last_loss is None else float(last_loss)
        self._stopped_epoch = ctrl.stopped_epoch
        if strategy == "rows":
            # Trim the mesh-padding rows before extraction.
            n = graph.number_of_nodes
            params = jax.tree_util.tree_map(
                lambda leaf: np.asarray(leaf)[:n], params
            )
        return self._extract(params, graph)


def _st_clip(x, c):
    """Straight-through score clip: forward value is clip(x, -c, c), but the
    gradient passes through unscaled — so downstream sigmoids evaluate at the
    clipped score (word2vec/ensmallen `clipping_value` semantics: the update
    is `target - sigmoid(clip(s))`, bounded but never zeroed the way a hard
    clip's dead zone would)."""
    return x + jax.lax.stop_gradient(jnp.clip(x, -c, c) - x)


def _mean_scatter(table, idx, grads, lr, counts=None):
    """SGD scatter-update with per-row MEAN accumulation: a row appearing k
    times in `idx` receives the AVERAGE of its k pair-gradients, once, at
    full lr. This makes the per-row step size invariant to both graph size
    and batch revisit count — a sum (word2vec's sequential per-pair updates
    collapsed into one batch) explodes on small graphs where each row is
    revisited dozens of times per batch, while a batch-mean (Keras reduction
    semantics) vanishes on large graphs where each row appears in a tiny
    fraction of pairs. Only an [N] count vector is materialized — and when
    several tables share the same `idx` (SkipGram/CBOW update three), the
    caller passes the count vector back in, paying its scatter once.
    Returns (updated_table, counts).

    Two lowerings (selected on STATIC shapes, so each jit picks once):
    when the index multiset is large relative to the table — the
    production-walk regime — the raw gradients scatter-add into a ZERO
    buffer and one dense fused `table - lr·sums/counts` pass applies the
    mean: the zero-init scatter has no read-modify-scale dependency on
    the live table, and the combine is a memory-bound map. For small
    multisets on big tables the dense O(N·D) pass would dominate, so the
    inline scaled scatter is kept below an |idx| ≥ N/8 threshold.

    `idx`/`grads` may be TUPLES of aligned multiset segments (e.g.
    SkipGram's context rows + per-walk negative rows): each segment
    scatters into the shared buffer directly, skipping the [ΣM, D]
    concatenation the tuple would otherwise need (1.25 GB of HBM traffic
    per step at the 32k-walker bench batch)."""
    segs = idx if isinstance(idx, tuple) else (idx,)
    gsegs = grads if isinstance(grads, tuple) else (grads,)
    total = sum(int(s.shape[0]) for s in segs)
    if counts is None:
        c = jnp.zeros((table.shape[0],), jnp.float32)
        for s in segs:
            c = c.at[s].add(1.0)
        counts = c
    ndim = gsegs[0].ndim
    if total * 8 >= table.shape[0]:
        sums = jnp.zeros_like(table)
        for s, g in zip(segs, gsegs):
            sums = sums.at[s].add(g)
        denom = jnp.maximum(counts, 1.0)
        if ndim > 1:
            denom = denom[:, None]
        return table - lr * (sums / denom), counts
    for s, g in zip(segs, gsegs):
        scale = 1.0 / jnp.maximum(counts[s], 1.0)
        if ndim > 1:
            scale = scale[:, None]
        table = table.at[s].add(-lr * g * scale)
    return table, counts


@register_model
class SkipGram(WalkBasedEmbedder):
    """Node2Vec SkipGram with NCE loss over per-walk scale-free negatives —
    capability match for reference `SkipGramTensorFlow`
    (`tensorflow_embedders/skipgram.py:13-61`, NCE positive_samples = 2·window)
    and `Node2VecSkipGramEnsmallen` (whose Rust trainer samples negatives
    per centre; per-walk is the batched equivalent at the same
    negative-pressure scale)."""

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec SkipGram"

    def _init_params(self, graph: Graph, key: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        n, d = graph.number_of_nodes, self.embedding_size
        k1, k2 = jax.random.split(key)
        scale = 1.0 / np.sqrt(d)
        return {
            "node_embedding": scale * jax.random.normal(k1, (n, d), jnp.float32),
            "context_embedding": scale * jax.random.normal(k2, (n, d), jnp.float32),
            "context_bias": jnp.zeros((n,), jnp.float32),
        }

    def _gathered_grads(self, gather, walks, negs, center_w=None):
        """Fused banded NCE gradients: each walk's embedding rows are
        gathered ONCE as [B, L, D]; center×context window scores are
        computed BLOCK-BANDED — centre blocks of T=16 positions against
        their (T+2w)-wide context slabs, one [B, nblk, T, S] einsum — so
        only the window band is ever materialized (a full [B, L, L] score
        cube spends 85% of its entries on masked-out pairs at L=64, w=5).
        Still ~8x less device-memory gather/scatter traffic
        than the per-pair gathers of the reference's NCE layer
        (`noise_contrastive_estimation.py:8-93`). Loss semantics match
        `nce_loss` over `skipgram_pairs` exactly. `center_w` [B, L] scales
        each centre's pair losses (degree-conditioned SGD knobs)."""
        length = self._walk_length
        w = self._window_size
        clip = self._clipping_value
        T = 16
        nblk = -(-length // T)
        Lp = nblk * T                       # centres padded to block grid
        S = T + 2 * w                       # context slab width per block
        # Masks on the [nblk, T, S] grid: centre l = blk·T + t, slab entry
        # s maps to context j = blk·T − w + s, offset = j − l = s − w − t.
        t_idx = jnp.arange(T)
        s_idx = jnp.arange(S)
        blk_idx = jnp.arange(nblk)
        l_glob = blk_idx[:, None, None] * T + t_idx[None, :, None]
        j_glob = blk_idx[:, None, None] * T - w + s_idx[None, None, :]
        off = j_glob - l_glob
        center_ok_blk = (l_glob >= w) & (l_glob < length - w)
        j_valid = (j_glob >= 0) & (j_glob < length)
        band = (jnp.abs(off) <= w) & (off != 0)
        pair_mask = (center_ok_blk & j_valid & band).astype(jnp.float32)
        pos = jnp.arange(length)
        center_ok = (pos >= w) & (pos < length - w)          # [L]
        if center_w is None:
            pair_w = pair_mask[None]                  # [1, nblk, T, S]
            neg_center_w = center_ok.astype(jnp.float32)[None, :, None]
        else:
            cw_pad = jnp.pad(center_w, ((0, 0), (0, Lp - length)))
            pair_w = (
                pair_mask[None]
                * cw_pad.reshape(-1, nblk, T)[:, :, :, None]
            )                                         # [B, nblk, T, S]
            neg_center_w = (
                center_ok.astype(jnp.float32)[None, :] * center_w
            )[:, :, None]

        def loss_fn(w_rows, c_rows, b_rows, neg_emb, neg_b):
            # w_rows, c_rows: [B, L, D]; banded scores per (center, context).
            # Positive target is 1/(2w) per context — exact tf.nn.nce_loss
            # num_true semantics (see ops/losses.nce_loss). The loss is a
            # SUM over pairs; the `_mean_scatter` row update in
            # `_apply_table_grads` then averages each row's accumulated
            # pair-gradients, giving one full-lr SGD step per touched row
            # per batch — invariant to graph size (a Keras-style batch mean
            # vanishes at 1M nodes) and to revisit count (a raw sum explodes
            # on 34-node graphs). Scores are clipped at ±clipping_value via
            # a straight-through clip (reference ensmallen SkipGram
            # `clipping_value=6.0`, `node2vec_skipgram.py:16`).
            B = w_rows.shape[0]
            D = w_rows.shape[-1]
            wb = jnp.pad(
                w_rows, ((0, 0), (0, Lp - length), (0, 0))
            ).reshape(B, nblk, T, D)
            cpad = jnp.pad(c_rows, ((0, 0), (w, w + Lp - length), (0, 0)))
            bpad = jnp.pad(b_rows, ((0, 0), (w, w + Lp - length)))
            slabs = jnp.stack(
                [
                    jax.lax.dynamic_slice_in_dim(cpad, i * T, S, axis=1)
                    for i in range(nblk)
                ],
                axis=1,
            )                                          # [B, nblk, S, D]
            bslabs = jnp.stack(
                [
                    jax.lax.dynamic_slice_in_dim(bpad, i * T, S, axis=1)
                    for i in range(nblk)
                ],
                axis=1,
            )                                          # [B, nblk, S]
            scores = jnp.einsum(
                "bntd,bnsd->bnts", wb, slabs,
                preferred_element_type=jnp.float32,
            ) + bslabs[:, :, None, :]
            scores = _st_clip(scores, clip)
            pos_loss = (
                (jax.nn.softplus(scores) - scores / (2 * w)) * pair_w
            ).sum()
            # Per-walk negatives: neg_emb [B, K, D] — each walk's centres
            # contrast against its own K draws (one batched matmul).
            neg_scores = jnp.einsum(
                "bld,bkd->blk", w_rows, neg_emb,
                preferred_element_type=jnp.float32,
            ) + neg_b[:, None, :]
            neg_scores = _st_clip(neg_scores, clip)
            neg_loss = (jax.nn.softplus(neg_scores) * neg_center_w).sum()
            return pos_loss + neg_loss

        w_rows = gather("node_embedding", walks)
        c_rows = gather("context_embedding", walks)
        b_rows = gather("context_bias", walks)
        neg_emb = gather("context_embedding", negs)
        neg_b = gather("context_bias", negs)
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4))(
            w_rows, c_rows, b_rows, neg_emb, neg_b
        )
        g_w, g_c, g_b, g_neg, g_nb = grads
        return loss, (g_w, g_c, g_b), (g_neg, g_nb)

    def _apply_table_grads(
        self, params, flat, row_grads, negs_flat, neg_grads, lr,
        mean_scatter,
    ):
        # Every touched row — context, bias AND negative — takes one
        # full-lr step on the MEAN of its accumulated pair gradients (the
        # batched collapse of word2vec's per-occurrence SGD). Context and
        # negative contributions to the same table share one combined
        # index multiset so a row serving both roles still averages once.
        g_w, g_c, g_b = row_grads
        g_neg, g_nb = neg_grads
        params["node_embedding"], _ = mean_scatter(
            params["node_embedding"], flat, g_w, lr
        )
        # Context + negative contributions ride the segment API: one shared
        # count multiset, segments scattered directly (no [ΣM, D] concat).
        params["context_embedding"], counts_ctx = mean_scatter(
            params["context_embedding"], (flat, negs_flat),
            (g_c, g_neg), lr,
        )
        params["context_bias"], _ = mean_scatter(
            params["context_bias"], (flat, negs_flat),
            (g_b, g_nb), lr, counts=counts_ctx,
        )
        return params

    def _extract(self, params, graph):
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[
                self._post_process(params["node_embedding"], graph),
                self._post_process(params["context_embedding"], graph),
            ],
            node_names=graph.get_node_names(),
        )


@register_model
class CBOW(WalkBasedEmbedder):
    """Node2Vec CBOW: mean context embedding predicts the centre word via
    sampled softmax — reference `CBOWTensorFlow`
    (`tensorflow_embedders/cbow.py:13-61`). Embedding order in the result is
    (contextual, central) reversed vs SkipGram, matching the reference quirk
    (`ensmallen_embedders/node2vec.py:101-102`)."""

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec CBOW"

    def _init_params(self, graph: Graph, key: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        n, d = graph.number_of_nodes, self.embedding_size
        k1, k2 = jax.random.split(key)
        scale = 1.0 / np.sqrt(d)
        return {
            "node_embedding": scale * jax.random.normal(k1, (n, d), jnp.float32),
            "output_embedding": scale * jax.random.normal(k2, (n, d), jnp.float32),
            "output_bias": jnp.zeros((n,), jnp.float32),
        }

    def _gathered_grads(self, gather, walks, negs, center_w=None):
        """Fused banded CBOW gradients: per-walk row gather [B, L, D], window
        mean via a matmul with a constant banded averaging matrix, sampled
        softmax against centre words + per-walk negatives (same
        memory-traffic win as the SkipGram step). `center_w` [B, L] scales each centre's
        loss (degree-conditioned SGD knobs)."""
        length = self._walk_length
        w = self._window_size
        pos = jnp.arange(length)
        center_ok = ((pos >= w) & (pos < length - w)).astype(jnp.float32)
        off = pos[None, :] - pos[:, None]
        band = ((jnp.abs(off) <= w) & (off != 0)).astype(jnp.float32)
        avg = band / (2 * w)                                  # [L, L]
        clip = self._clipping_value
        per_center_w = (
            center_ok[None, :] if center_w is None
            else center_ok[None, :] * center_w
        )

        def loss_fn(in_rows, out_rows, out_b, neg_emb, neg_b):
            # SUM over centres (per-example SGD semantics, as in the
            # SkipGram step above) with logits clipped at ±clipping_value
            # (ensmallen `clipping_value=6.0`).
            hidden = jnp.einsum(
                "lm,bmd->bld", avg, in_rows,
                preferred_element_type=jnp.float32,
            )
            true_logit = jnp.sum(hidden * out_rows, axis=2) + out_b  # [B, L]
            # Per-walk negatives: neg_emb [B, K, D].
            neg_logits = jnp.einsum(
                "bld,bkd->blk", hidden, neg_emb,
                preferred_element_type=jnp.float32,
            ) + neg_b[:, None, :]
            logits = jnp.concatenate(
                [true_logit[..., None], neg_logits], axis=2
            )
            logits = _st_clip(logits, clip)
            per = -jax.nn.log_softmax(logits, axis=2)[..., 0]   # [B, L]
            return (per * per_center_w).sum()

        in_rows = gather("node_embedding", walks)
        out_rows = gather("output_embedding", walks)
        out_b = gather("output_bias", walks)
        neg_emb = gather("output_embedding", negs)
        neg_b = gather("output_bias", negs)
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3, 4))(
            in_rows, out_rows, out_b, neg_emb, neg_b
        )
        g_in, g_out, g_ob, g_neg, g_nb = grads
        return loss, (g_in, g_out, g_ob), (g_neg, g_nb)

    def _apply_table_grads(
        self, params, flat, row_grads, negs_flat, neg_grads, lr,
        mean_scatter,
    ):
        # Same scatter policy as SkipGram: every touched row (outputs AND
        # negatives) takes one full-lr mean step; shared combined index
        # multiset for the output table + bias.
        g_in, g_out, g_ob = row_grads
        g_neg, g_nb = neg_grads
        params["node_embedding"], _ = mean_scatter(
            params["node_embedding"], flat, g_in, lr
        )
        params["output_embedding"], counts_out = mean_scatter(
            params["output_embedding"], (flat, negs_flat),
            (g_out, g_neg), lr,
        )
        params["output_bias"], _ = mean_scatter(
            params["output_bias"], (flat, negs_flat),
            (g_ob, g_nb), lr, counts=counts_out,
        )
        return params

    def _extract(self, params, graph):
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[
                self._post_process(params["node_embedding"], graph),
                self._post_process(params["output_embedding"], graph),
            ],
            node_names=graph.get_node_names(),
        )


class _FixedPQMixin:
    """DeepWalk presets: p = q = 1 (uniform first-order walks), reference
    `DeepWalk*Ensmallen` classes."""

    def __init__(self, **kwargs):
        for forbidden in ("return_weight", "explore_weight"):
            if forbidden in kwargs:
                raise ValueError(
                    f"{type(self).__name__} does not accept {forbidden!r}: "
                    "DeepWalk walks are first-order (p = q = 1)."
                )
        super().__init__(return_weight=1.0, explore_weight=1.0, **kwargs)

    def parameters(self):
        params = super().parameters()
        params.pop("return_weight", None)
        params.pop("explore_weight", None)
        return params


@register_model
class DeepWalkSkipGram(_FixedPQMixin, SkipGram):
    @classmethod
    def model_name(cls) -> str:
        return "DeepWalk SkipGram"


@register_model
class DeepWalkCBOW(_FixedPQMixin, CBOW):
    @classmethod
    def model_name(cls) -> str:
        return "DeepWalk CBOW"


@register_model
class Node2Vec(SkipGram):
    """Generic "Node2Vec" — the model name the reference registers from its
    PecanPy, fastnode2vec and PyTorch Geometric adapters
    (`pecanpy_embedders/node2vec.py`, `fastnode2vec_embedders/node2vec.py`,
    `pytorch_geometric/node2vec.py`), all of which train SkipGram over
    p/q-biased second-order walks. Here it is the native fused SkipGram."""

    @classmethod
    def model_name(cls) -> str:
        return "Node2Vec"
