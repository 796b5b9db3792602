"""Edge-level GCNs: edge prediction and edge-label prediction — reference
counterparts: `embiggen/utils/abstract_edge_gcn.py` (src/dst lookup of conv
outputs `:487-494`, FFNN towers `:625-700`, edge-embedding combination
`:769-838`) and the per-task quartets
`edge_prediction_tensorflow/{gcn,kipf_gcn,graph_sage,gnn}.py`,
`edge_label_prediction_tensorflow/...`.

Training runs full-graph convolution per step with an on-device edge
minibatch: positives are uniform arcs, negatives scale-free corruptions
(replacing the reference's Rust `get_edge_prediction_mini_batch`), so the
whole step — sampling, SpMM, gather, head, loss, update — is one jit region.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.graph import DeviceGraph, Graph
from ...ops import edge_ops
from ...ops.edge_metrics import N_EDGE_METRICS
from ...ops.edge_metrics import edge_metrics as device_edge_metrics
from ...ops.negatives import edge_prediction_mini_batch
from ..classifier import AbstractClassifierModel
from ..edge_label_prediction.model import AbstractEdgeLabelPredictionModel
from ..edge_prediction.model import AbstractEdgePredictionModel
from ..registry import register_model
from .core import (
    GCNEncoder,
    graph_fingerprint,
    TrainLoop,
    apply_mlp,
    assemble_node_features,
    init_mlp,
)


# Per-instance jitted predict closures (weak: models must stay picklable).
_PREDICT_JITS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# Per-instance convolved node representations for inference (keyed on the
# fitted params object; see _chunked_logits).
_PREDICT_H: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _EdgeGCNBase(AbstractClassifierModel):
    """Shared encoder + towers + edge-combination + head machinery."""

    DEFAULT_KERNELS = ["Symmetric Normalized Laplacian"]

    def __init__(
        self,
        kernels: Optional[Sequence[str]] = None,
        units: Sequence[int] = (128, 128),
        tower_units: Sequence[int] = (64,),
        head_units: Sequence[int] = (32,),
        edge_embedding_method: str = "Concatenate",
        siamese_towers: bool = True,
        combiner: str = "sum",
        dropout_rate: float = 0.5,
        residual: bool = False,
        use_node_embedding: bool = False,
        node_embedding_size: int = 50,
        use_node_type_embedding: bool = False,
        node_type_embedding_size: int = 50,
        use_edge_type_embedding: bool = False,
        edge_type_embedding_size: int = 16,
        use_edge_metrics: bool = False,
        edge_feature_models=None,
        batch_size: Optional[int] = None,
        epochs: int = 200,
        learning_rate: float = 0.001,
        early_stopping_patience: int = 20,
        mesh=None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 10,
        handling_multi_graph: str = "warn",
        random_state: int = 42,
    ):
        # `mesh` (None | "auto" | int | jax.sharding.Mesh) trains the REAL
        # model multi-chip: node-partitioned features + halo-exchange SpMM
        # per conv layer (`parallel/halo.py`), replicated weights. Seeded
        # sharded fits match single-chip fits to float-reduction tolerance.
        self._mesh = mesh
        self._handling_multi_graph = handling_multi_graph
        self._kernels = (
            list(kernels) if kernels is not None else list(self.DEFAULT_KERNELS)
        )
        self._units = list(units)
        self._tower_units = list(tower_units)
        self._head_units = list(head_units)
        self._edge_embedding_method = edge_embedding_method
        self._siamese_towers = siamese_towers
        self._combiner = combiner
        self._dropout_rate = dropout_rate
        self._residual = residual
        self._use_node_embedding = use_node_embedding
        self._node_embedding_size = node_embedding_size
        self._use_node_type_embedding = use_node_type_embedding
        self._node_type_embedding_size = node_type_embedding_size
        self._use_edge_type_embedding = use_edge_type_embedding
        self._edge_type_embedding_size = edge_type_embedding_size
        # Append the on-device per-edge topological heuristics (Adamic-Adar,
        # Jaccard, resource allocation, log1p preferential attachment) to the
        # edge representation before the head — reference
        # `abstract_edge_gcn.py:78,319-341` (`use_edge_metrics` threading the
        # Rust metrics through the training sequence into the Keras model).
        self._use_edge_metrics = use_edge_metrics
        self._edge_feature_models = (
            list(edge_feature_models) if edge_feature_models else []
        )
        self._batch_size = batch_size
        self._epochs = epochs
        self._learning_rate = learning_rate
        self._early_stopping_patience = early_stopping_patience
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = checkpoint_interval
        self._needs_edge_lookup = False
        self._static_edge_feats: List[Any] = []
        self._edge_type_feat_tables: List[Any] = []
        self._edge_types_by_arc = None
        edge_ops.resolve(edge_embedding_method, edge_ops.EDGE_GCN_METHODS)
        super().__init__(random_state=random_state)

    # GCNs consume all four feature classes (reference
    # `abstract_edge_gcn.py:395-510`).
    @classmethod
    def can_use_node_type_features(cls) -> bool:
        return True

    @classmethod
    def can_use_edge_type_features(cls) -> bool:
        return True

    @classmethod
    def can_use_edge_features(cls) -> bool:
        return True

    def parameters(self) -> Dict[str, Any]:
        mesh = self._mesh
        if mesh is not None and not isinstance(mesh, (int, str)):
            mesh = int(np.prod(list(mesh.devices.shape)))
        return {
            **super().parameters(),
            "mesh": mesh,
            "kernels": self._kernels,
            "units": self._units,
            "tower_units": self._tower_units,
            "head_units": self._head_units,
            "edge_embedding_method": self._edge_embedding_method,
            "siamese_towers": self._siamese_towers,
            "combiner": self._combiner,
            "dropout_rate": self._dropout_rate,
            "residual": self._residual,
            "use_node_embedding": self._use_node_embedding,
            "node_embedding_size": self._node_embedding_size,
            "use_node_type_embedding": self._use_node_type_embedding,
            "node_type_embedding_size": self._node_type_embedding_size,
            "use_edge_type_embedding": self._use_edge_type_embedding,
            "edge_type_embedding_size": self._edge_type_embedding_size,
            "use_edge_metrics": self._use_edge_metrics,
            "edge_feature_models": self._edge_feature_models,
            "batch_size": self._batch_size,
            "epochs": self._epochs,
            "learning_rate": self._learning_rate,
            "early_stopping_patience": self._early_stopping_patience,
            "checkpoint_dir": self._checkpoint_dir,
            "checkpoint_interval": self._checkpoint_interval,
            "handling_multi_graph": self._handling_multi_graph,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "units": [8], "tower_units": [8], "head_units": [8],
            "epochs": 5, "batch_size": 64,
        }

    def _resolve_batch_size(self, n_examples: int) -> int:
        """Edge batch per training step. Explicit values win; the default
        mirrors the reference's full-batch rule for convolutional models
        (`abstract_gcn.py:452-456` forces batch = n_nodes whenever conv
        layers exist): every step pays a FULL-graph convolution, so tiny
        edge batches leave the conv cost amortized over almost nothing —
        at 1M nodes / 20M arcs a 1024-edge batch would run ~19.5k
        convolutions per epoch. Non-convolutional models (pure
        embedding/FFNN "GNN" preset) keep a classic minibatch."""
        if self._batch_size is not None:
            return max(1, min(self._batch_size, max(n_examples, 8)))
        if self._units and self._kernels:
            n_nodes = getattr(self, "_n_nodes_hint", None)
            base = n_nodes if n_nodes else n_examples
            return max(1, min(max(base, 1024), max(n_examples, 8)))
        return max(1, min(1024, max(n_examples, 8)))

    # --------------------------------------------------------------- assembly
    def _build_common(self, graph: Graph, support: Graph, node_features, key,
                      node_type_features=None, edge_type_features=None,
                      edge_features=None):
        from ...parallel.mesh import resolve_mesh

        self._resolved_mesh = resolve_mesh(self._mesh, axis="nodes")
        self._encoder = GCNEncoder(
            self._kernels if self._units else None,
            self._units,
            combiner=self._combiner,
            dropout_rate=self._dropout_rate,
            residual=self._residual,
            handling_multi_graph=self._handling_multi_graph,
        )
        if self._resolved_mesh is not None:
            self._encoder.enable_halo(
                self._resolved_mesh, self._resolved_mesh.axis_names[0]
            )
        kernels = self._encoder.build_kernels(support)
        self._kernels_coo = kernels

        key, k_feat, k_enc, k_tower_s, k_tower_d, k_head = jax.random.split(key, 6)
        embed_params, spec = assemble_node_features(
            graph, node_features,
            self._use_node_embedding, self._node_embedding_size,
            self._use_node_type_embedding, self._node_type_embedding_size,
            k_feat, node_type_features=node_type_features,
        )
        if spec.dim(embed_params) == 0:
            embed_params, spec = assemble_node_features(
                graph, node_features, True, self._node_embedding_size,
                self._use_node_type_embedding, self._node_type_embedding_size,
                k_feat, node_type_features=node_type_features,
            )
        self._spec = spec

        # Split normalized edge features into lazy models (AbstractEdgeFeature
        # protocol) and static [n_directed_edges, d] matrices; the latter are
        # served per-(src, dst) pair via the device arc-key lookup below,
        # zeros for non-edges (reference consumption at
        # `abstract_edge_gcn.py:510-560`).
        static_edge_feats: List[np.ndarray] = []
        lazy_edge_models = list(self._edge_feature_models)
        for ef in (edge_features or []):
            if hasattr(ef, "device_feature_fn"):
                lazy_edge_models.append(ef)
            else:
                static_edge_feats.append(np.asarray(ef, np.float32))
        self._needs_edge_lookup = bool(static_edge_feats) or (
            (self._use_edge_type_embedding or bool(edge_type_features))
            and graph.has_edge_types
        )
        if self._needs_edge_lookup:
            self._lookup_row_ptr = jnp.asarray(
                graph.row_ptr.astype(np.int32)
            )
            self._lookup_col_idx = jnp.asarray(
                graph.col_idx.astype(np.int32)
            )
            self._lookup_iters = max(
                1, int(np.ceil(np.log2(int(graph.degrees.max(initial=1)) + 1)))
            )
            if graph.has_edge_types:
                self._edge_types_by_arc = jnp.asarray(
                    graph.edge_types.astype(np.int32)
                )
            else:
                self._edge_types_by_arc = None
        # Static edge-feature matrices with a trailing zeros row for
        # non-edges (index E).
        self._static_edge_feats = [
            jnp.asarray(np.vstack([f, np.zeros((1, f.shape[1]), np.float32)]))
            for f in static_edge_feats
        ]
        # Edge-type feature tables [n_edge_types + 1, d]: row 0 = unknown.
        self._edge_type_feat_tables = [
            jnp.asarray(
                np.vstack([np.zeros((1, f.shape[1]), np.float32),
                           np.asarray(f, np.float32)])
            )
            for f in (edge_type_features or [])
        ]

        in_dim = spec.dim(embed_params)
        enc_params = self._encoder.init(k_enc, in_dim)
        rep_dim = self._encoder.output_dim(in_dim)
        tower_dims = [rep_dim] + self._tower_units
        src_tower = init_mlp(k_tower_s, tower_dims)
        dst_tower = (
            src_tower
            if self._siamese_towers
            else init_mlp(k_tower_d, tower_dims)
        )
        tower_out = tower_dims[-1]
        combine_fn = edge_ops.resolve(
            self._edge_embedding_method, edge_ops.EDGE_GCN_METHODS
        )
        edge_dim = edge_ops.output_dim(self._edge_embedding_method, tower_out)
        if self._use_edge_type_embedding:
            edge_dim += self._edge_type_embedding_size
        # Lazy per-batch edge features (e.g. HyperSketching sketches), fitted
        # on the support graph; queried inside the jitted step (reference
        # AbstractEdgeFeature protocol, `abstract_edge_feature.py:49-80`).
        self._edge_feature_fns = []
        self._edge_feature_tables = []
        for ef in lazy_edge_models:
            ef.fit(support)
            self._edge_feature_fns.append(ef.device_feature_fn())
            tables_of = getattr(ef, "device_feature_tables", None)
            self._edge_feature_tables.append(
                tables_of() if tables_of is not None else None
            )
            edge_dim += sum(
                int(np.prod(shape))
                for shape in ef.get_feature_dictionary_shapes().values()
            )
        edge_dim += sum(int(f.shape[1]) for f in self._static_edge_feats)
        edge_dim += sum(int(t.shape[1]) for t in self._edge_type_feat_tables)
        # Topological edge metrics are computed on the SUPPORT graph (the
        # reference's training sequences query the support too,
        # `gcn_edge_prediction_training_sequence.py:174-250`).
        self._metrics_dg = (
            support.device(with_weights=False) if self._use_edge_metrics
            else None
        )
        if self._use_edge_metrics:
            edge_dim += N_EDGE_METRICS
        head = init_mlp(k_head, [edge_dim] + self._head_units + [self._n_outputs])
        params = {
            "embed": embed_params,
            "enc": enc_params,
            "src_tower": src_tower,
            "head": head,
        }
        if not self._siamese_towers:
            params["dst_tower"] = dst_tower
        if self._use_edge_type_embedding:
            key, k_et = jax.random.split(key)
            n_et = max(graph.number_of_edge_types, 1)
            params["edge_type_embedding"] = (
                jax.random.normal(
                    k_et, (n_et + 1, self._edge_type_embedding_size), jnp.float32
                )
                / np.sqrt(self._edge_type_embedding_size)
            )
        self._combine_fn = combine_fn
        if self._resolved_mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            params = jax.device_put(
                params, NamedSharding(self._resolved_mesh, P())
            )
        return params, kernels

    def _lookup_edge_ids(self, src, dst, ctx=None):
        """Device arc lookup: (edge_id, is_edge) per (src, dst) pair via
        CSR row binary search (`ops.walks.csr_edge_ids`). Non-edges map to
        the sentinel id `n_arcs` (the zeros row of static edge-feature
        tables)."""
        from ...ops.walks import csr_edge_ids

        row_ptr = self._lookup_row_ptr
        col_idx = self._lookup_col_idx
        if ctx is not None and ctx.get("lookup_row_ptr") is not None:
            row_ptr = ctx["lookup_row_ptr"]
            col_idx = ctx["lookup_col_idx"]
        return csr_edge_ids(
            row_ptr, col_idx, src, dst, n_iters=self._lookup_iters,
        )

    def _train_ctx(self, kernels, dg):
        """Device-context pytree for the jitted training step. Every
        graph-sized array the loss needs rides this ARGUMENT into
        `TrainLoop.run(data=...)` — if the loss closed over them instead,
        they would lower as inline HLO constants (≈2 GB of program text at
        1M nodes/20M arcs) and crash the compiler."""
        return {
            "kernels": kernels,
            "dg": dg,
            "x_static": self._spec.static,
            "lookup_row_ptr": self._lookup_row_ptr
            if self._needs_edge_lookup else None,
            "lookup_col_idx": self._lookup_col_idx
            if self._needs_edge_lookup else None,
            "edge_types_by_arc": self._edge_types_by_arc,
            "static_edge_feats": list(self._static_edge_feats),
            "edge_type_feat_tables": list(self._edge_type_feat_tables),
            "lazy_edge_tables": list(
                getattr(self, "_edge_feature_tables", [])
            ),
            "metrics_dg": getattr(self, "_metrics_dg", None),
        }

    def _encode_nodes(
        self, params, kernels, n_nodes, training=False, key=None, ctx=None
    ):
        """Feature materialization + convolution stack → [N, H] node
        representations (the per-graph half of `_edge_logits`)."""
        get = (ctx or {}).get
        x = self._spec.materialize(params["embed"], static=get("x_static"))
        return self._encoder.apply(
            params["enc"], kernels, x, n_nodes, training=training, key=key
        )

    def _edge_logits(
        self, params, kernels, src, dst, n_nodes, training=False, key=None,
        edge_types=None, ctx=None,
    ):
        h = self._encode_nodes(
            params, kernels, n_nodes, training=training, key=key, ctx=ctx
        )
        return self._score_edges(
            params, h, src, dst, edge_types=edge_types, ctx=ctx
        )

    def _chunked_logits(
        self, src: np.ndarray, dst: np.ndarray, chunk: int = 1 << 22,
        representation: bool = False,
    ) -> np.ndarray:
        """Inference logits for an arbitrary candidate set: the convolution
        runs ONCE, then (src, dst) pairs are scored in fixed-size chunks
        (last chunk padded) so a 10M-arc train graph — or a full bipartite
        candidate set — never materializes [E, H] tower activations at once
        (the reference chunks inference at 2^15 edges,
        `sklearn_like_edge_prediction_adapter.py:17-88`; 2^22 pairs give each
        dispatch enough work and bound the number of dispatch+sync round
        trips). Graph-sized tables ride the ctx ARGUMENT path."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        n = len(src)
        # Power-of-two chunk bucket (see perceptron._chunked): bounds the
        # number of compiled shapes across arbitrary candidate-set sizes.
        chunk = min(chunk, 1 << max(int(np.ceil(np.log2(max(n, 1)))), 6))
        ctx = self._train_ctx(self._kernels_coo, None)
        ctx.pop("dg", None)
        # Jitted closures are cached per instance (weakly, NOT as attrs —
        # models pickle via utils/persistence.dump_model and jitted
        # functions don't) so repeated predict calls reuse one compile.
        got = _PREDICT_JITS.get(self)
        if got is None:
            got = (
                jax.jit(
                    lambda params, ctx: self._encode_nodes(
                        params, ctx["kernels"], self._n_nodes, ctx=ctx
                    )
                ),
                jax.jit(
                    lambda params, h, s, d, ctx: self._score_edges(
                        params, h, s, d, ctx=ctx
                    )
                ),
                jax.jit(
                    lambda params, h, s, d, ctx: self._score_edges(
                        params, h, s, d, ctx=ctx,
                        return_representation=True,
                    )
                ),
            )
            _PREDICT_JITS[self] = got
        encode = got[0]
        score = got[2] if representation else got[1]
        # The convolved node representations depend only on the fitted
        # params (dropout off at inference) — the evaluation loop predicts
        # train/test/negative sets back to back, so cache h per params
        # object (a refit installs a fresh dict; weak keys keep the model
        # picklable).
        cached = _PREDICT_H.get(self)
        if cached is not None and cached[0] is self._params:
            h = cached[1]
        else:
            h = encode(self._params, ctx)
            _PREDICT_H[self] = (self._params, h)
        outs = []
        # Dispatch-ahead pipeline: keep a couple of chunks in flight so a
        # chunk's logit download overlaps the next chunk's tower compute. The window is small
        # because representation=True outputs are [chunk, H] — an
        # unbounded queue would hold the whole candidate set on device.
        # Logit chunks are [chunk, 1]; representation chunks are
        # [chunk, H] (~2 GB at chunk=2^22, H=128), so keep at most one
        # of those in flight beyond the current dispatch.
        window = 2 if representation else 3
        pending: list = []
        for i in range(0, n, chunk):
            s = src[i:i + chunk]
            d = dst[i:i + chunk]
            take = len(s)
            if take < chunk:
                s = np.pad(s, (0, chunk - take))
                d = np.pad(d, (0, chunk - take))
            out = score(
                self._params, h, jnp.asarray(s), jnp.asarray(d), ctx
            )
            pending.append((out, take))
            if len(pending) >= window:
                done, tk = pending.pop(0)
                outs.append(np.asarray(done)[:tk])
        for done, tk in pending:
            outs.append(np.asarray(done)[:tk])
        return np.concatenate(outs, axis=0)

    def _score_edges(self, params, h, src, dst, edge_types=None, ctx=None,
                     return_representation=False):
        """Towers → edge combination → feature concat → head for a batch of
        (src, dst) pairs over precomputed node representations `h` (the
        per-edge half of `_edge_logits` — inference runs it over chunks so
        candidate sets of any size score in bounded memory).
        `return_representation` yields the pre-head edge representation
        instead of logits (the reference's beheaded edge model,
        `abstract_edge_gcn.py:908-927`: output = the EdgeFeaturesDropout
        input, i.e. the combined edge embedding + features)."""
        get = (ctx or {}).get
        h_src = apply_mlp(params["src_tower"], h[src], final_activation=jax.nn.relu)
        dst_tower = params.get("dst_tower", params["src_tower"])
        h_dst = apply_mlp(dst_tower, h[dst], final_activation=jax.nn.relu)
        e = self._combine_fn(h_src, h_dst)
        lazy_tables = (
            get("lazy_edge_tables") if ctx is not None
            else getattr(self, "_edge_feature_tables", None)
        )
        if not lazy_tables:
            lazy_tables = [None] * len(self._edge_feature_fns)
        for fn, tb in zip(self._edge_feature_fns, lazy_tables):
            feat = fn(src, dst) if tb is None else fn(src, dst, tb)
            e = jnp.concatenate([e, feat], axis=1)
        edge_ids = None
        types_by_arc = (
            get("edge_types_by_arc") if ctx is not None
            else self._edge_types_by_arc
        )
        if self._needs_edge_lookup:
            edge_ids, is_edge = self._lookup_edge_ids(src, dst, ctx=ctx)
            if edge_types is None and types_by_arc is not None:
                # Known arcs contribute their real type; non-edges (e.g.
                # sampled negatives) fall to the unknown row (-1 → index 0).
                safe = jnp.minimum(edge_ids, types_by_arc.shape[0] - 1)
                edge_types = jnp.where(is_edge, types_by_arc[safe], -1)
        static_feats = (
            get("static_edge_feats") if ctx is not None
            else self._static_edge_feats
        )
        for table in static_feats:
            rows = (
                table[edge_ids]
                if edge_ids is not None
                else jnp.zeros((src.shape[0], table.shape[1]), table.dtype)
            )
            e = jnp.concatenate([e, rows], axis=1)
        if self._use_edge_metrics:
            mdg = (
                get("metrics_dg") if ctx is not None
                else self._metrics_dg
            )
            m = device_edge_metrics(mdg, src, dst)
            # log1p on preferential attachment (deg*deg reaches ~1e10 on
            # scale-free graphs; same convention as the perceptron's
            # feature assembly, `edge_prediction/perceptron.py:145`).
            m = jnp.concatenate([m[:, :3], jnp.log1p(m[:, 3:4])], axis=1)
            e = jnp.concatenate([e, m], axis=1)
        type_tables = (
            get("edge_type_feat_tables") if ctx is not None
            else self._edge_type_feat_tables
        )
        if type_tables or self._use_edge_type_embedding:
            et = (
                edge_types
                if edge_types is not None
                else jnp.full(src.shape, -1, jnp.int32)
            )
            for table in type_tables:
                e = jnp.concatenate([e, table[et + 1]], axis=1)
            if self._use_edge_type_embedding:
                e = jnp.concatenate(
                    [e, params["edge_type_embedding"][et + 1]], axis=1
                )
        if return_representation:
            return e
        return apply_mlp(params["head"], e)

    # ------------------------------------------------ beheaded edge model
    def transform_edges_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        """Pre-head edge representations for arbitrary (src, dst) pairs —
        the fitted edge GCN as a feature extractor (reference
        `into_beheaded_edge_model`, `abstract_edge_gcn.py:908-927`)."""
        return self._chunked_logits(src, dst, representation=True)

    def transform_edges(self, graph: Graph):
        """Edge embeddings for every arc of `graph` as an EmbeddingResult
        (the beheaded-model workflow: extract the edge-embedding layer of a
        fitted edge GCN and reuse it downstream)."""
        from ..embedding_result import EmbeddingResult

        reps = self.transform_edges_from_edge_node_ids(
            graph.sources, graph.col_idx
        )
        return EmbeddingResult(
            embedding_method_name=f"Beheaded {self.model_name()}",
            edge_embeddings=[reps],
        )


class GCNEdgePrediction(_EdgeGCNBase, AbstractEdgePredictionModel):
    """Configurable edge-prediction GCN (reference "Everything Bagel GCN",
    `edge_prediction_tensorflow/gcn.py:420-421`)."""

    @classmethod
    def model_name(cls) -> str:
        return "Everything Bagel GCN"

    def __init__(self, negative_samples_rate: float = 0.5,
                 use_scale_free_distribution: bool = True, **kwargs):
        self._negative_samples_rate = negative_samples_rate
        self._use_scale_free_distribution = use_scale_free_distribution
        super().__init__(**kwargs)

    def parameters(self):
        return {
            **super().parameters(),
            "negative_samples_rate": self._negative_samples_rate,
            "use_scale_free_distribution": self._use_scale_free_distribution,
        }

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        key = jax.random.PRNGKey(self.random_state or 0)
        self._n_outputs = 1
        params, kernels = self._build_common(
            graph, support, node_features, key,
            node_type_features=kwargs.get("node_type_features"),
            edge_type_features=kwargs.get("edge_type_features"),
            edge_features=kwargs.get("edge_features"),
        )
        dg = graph.device(with_sources=True)
        n_nodes = graph.number_of_nodes
        self._n_nodes_hint = n_nodes
        batch_size = self._resolve_batch_size(
            graph.number_of_directed_edges
        )
        rate = self._negative_samples_rate
        scale_free = self._use_scale_free_distribution
        model = self

        def loss_fn(params, k, data):
            k_batch, k_drop = jax.random.split(k)
            src, dst, labels = edge_prediction_mini_batch(
                data["dg"], k_batch, batch_size,
                negative_samples_rate=rate,
                use_scale_free_distribution=scale_free,
            )
            logits = model._edge_logits(
                params, data["kernels"], src, dst, n_nodes,
                training=True, key=k_drop, ctx=data,
            )[:, 0]
            return (jax.nn.softplus(logits) - labels * logits).mean()

        loop = TrainLoop(
            epochs=self._epochs, learning_rate=self._learning_rate,
            early_stopping_patience=self._early_stopping_patience,
            steps_per_epoch=max(
                1, graph.number_of_directed_edges // batch_size
            ),
            checkpoint_dir=self._checkpoint_dir,
            checkpoint_interval=self._checkpoint_interval,
        )
        self._params, self._history = loop.run(
            params, jax.value_and_grad(loss_fn), key,
            fingerprint=graph_fingerprint(graph),
            data=self._train_ctx(kernels, dg),
        )
        self._epoch_seconds = list(loop.epoch_seconds)
        self._n_nodes = n_nodes

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        """Sigmoid scores for every arc of `graph` (the candidate edge set),
        convolving over the fitted support kernels."""
        logits = self._chunked_logits(graph.sources, graph.col_idx)[:, 0]
        return np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        logits = self._chunked_logits(src, dst)[:, 0]
        return np.asarray(jax.nn.sigmoid(jnp.asarray(logits)))


class GCNEdgeLabelPrediction(_EdgeGCNBase, AbstractEdgeLabelPredictionModel):
    """Configurable edge-label prediction GCN (reference
    `edge_label_prediction_tensorflow/gcn.py`). Edge-type features and the
    edge-type embedding are rejected — the edge type IS the target
    (reference `edge_label_prediction_model.py:294-297`,
    `edge_label_prediction_tensorflow/gcn.py:337-342`)."""

    def __init__(self, **kwargs):
        kwargs.pop("use_edge_type_embedding", None)
        kwargs.pop("edge_type_embedding_size", None)
        super().__init__(**kwargs)

    def parameters(self):
        p = super().parameters()
        p.pop("use_edge_type_embedding", None)
        p.pop("edge_type_embedding_size", None)
        return p

    @classmethod
    def can_use_edge_type_features(cls) -> bool:
        return False

    @classmethod
    def model_name(cls) -> str:
        return "Everything Bagel GCN"

    def is_binary_prediction_task(self) -> bool:
        return self._n_outputs == 2

    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        key = jax.random.PRNGKey(self.random_state or 0)
        self._n_outputs = max(graph.number_of_edge_types, 2)
        params, kernels = self._build_common(
            graph, support, node_features, key,
            node_type_features=kwargs.get("node_type_features"),
            edge_type_features=kwargs.get("edge_type_features"),
            edge_features=kwargs.get("edge_features"),
        )
        n_nodes = graph.number_of_nodes

        known = graph.get_known_edge_types_mask()
        known_idx = np.nonzero(known)[0]
        if len(known_idx) == 0:
            raise ValueError("Graph has no known edge types to train on.")
        src_all = jnp.asarray(graph.sources[known_idx], jnp.int32)
        dst_all = jnp.asarray(graph.col_idx[known_idx], jnp.int32)
        y_all = jnp.asarray(graph.edge_types[known_idx], jnp.int32)
        n_known = len(known_idx)
        self._n_nodes_hint = graph.number_of_nodes
        batch_size = self._resolve_batch_size(n_known)
        model = self

        def loss_fn(params, k, data):
            k_batch, k_drop = jax.random.split(k)
            pick = jax.random.randint(k_batch, (batch_size,), 0, n_known)
            src = data["src_all"][pick]
            dst = data["dst_all"][pick]
            y = data["y_all"][pick]
            logits = model._edge_logits(
                params, data["kernels"], src, dst, n_nodes,
                training=True, key=k_drop, ctx=data,
            )
            logp = jax.nn.log_softmax(logits, axis=1)
            return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

        loop = TrainLoop(
            epochs=self._epochs, learning_rate=self._learning_rate,
            early_stopping_patience=self._early_stopping_patience,
            steps_per_epoch=max(1, n_known // batch_size),
            checkpoint_dir=self._checkpoint_dir,
            checkpoint_interval=self._checkpoint_interval,
        )
        data = self._train_ctx(kernels, None)
        data.pop("dg")
        data.update(src_all=src_all, dst_all=dst_all, y_all=y_all)
        self._params, self._history = loop.run(
            params, jax.value_and_grad(loss_fn), key,
            fingerprint=graph_fingerprint(graph, known_idx, y_all),
            data=data,
        )
        self._epoch_seconds = list(loop.epoch_seconds)
        self._n_nodes = n_nodes

    def _predict_proba(self, graph: Graph, **kwargs) -> np.ndarray:
        logits = self._chunked_logits(graph.sources, graph.col_idx)
        return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=1))


def _kernel_preset(base, name, kernel_list, doc):
    """Create a Kipf/GraphSAGE/GNN preset subclass of an edge GCN."""

    def __init__(self, **kwargs):
        kwargs.pop("kernels", None)
        if not kernel_list:
            kwargs.setdefault("use_node_embedding", True)
            base.__init__(self, kernels=[], units=(), **kwargs)
        else:
            base.__init__(self, kernels=list(kernel_list), **kwargs)

    def parameters(self):
        p = base.parameters(self)
        p.pop("kernels", None)
        if not kernel_list:
            p.pop("units", None)
        return p

    cls = type(
        name,
        (base,),
        {
            "__init__": __init__,
            "parameters": parameters,
            "model_name": classmethod(lambda cls: doc),
            "DEFAULT_KERNELS": list(kernel_list),
            "__doc__": f"{doc} preset of {base.__name__}.",
        },
    )
    if not kernel_list:
        cls.smoke_test_parameters = classmethod(
            lambda cls: {"tower_units": [8], "head_units": [8], "epochs": 5,
                         "batch_size": 64}
        )
    return register_model(cls)


KipfGCNEdgePrediction = _kernel_preset(
    GCNEdgePrediction, "KipfGCNEdgePrediction",
    ["Symmetric Normalized Laplacian"], "Kipf GCN",
)
GraphSAGEEdgePrediction = _kernel_preset(
    GCNEdgePrediction, "GraphSAGEEdgePrediction",
    ["Left Normalized Laplacian"], "GraphSAGE",
)
GNNEdgePrediction = _kernel_preset(
    GCNEdgePrediction, "GNNEdgePrediction", [], "GNN",
)
KipfGCNEdgeLabelPrediction = _kernel_preset(
    GCNEdgeLabelPrediction, "KipfGCNEdgeLabelPrediction",
    ["Symmetric Normalized Laplacian"], "Kipf GCN",
)
GraphSAGEEdgeLabelPrediction = _kernel_preset(
    GCNEdgeLabelPrediction, "GraphSAGEEdgeLabelPrediction",
    ["Left Normalized Laplacian"], "GraphSAGE",
)
GNNEdgeLabelPrediction = _kernel_preset(
    GCNEdgeLabelPrediction, "GNNEdgeLabelPrediction", [], "GNN",
)

register_model(GCNEdgePrediction)
register_model(GCNEdgeLabelPrediction)
