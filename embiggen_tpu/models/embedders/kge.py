"""Knowledge-graph-embedding model family — the JAX counterpart of
the reference's PyKEEN adapter surface
(`embiggen/embedders/pykeen_embedders/*.py`: TransR/TransD/TransF/RotatE/
ComplEx/DistMult/HolE/ConvE/BoxE/CrossE/DistMA/ERMLP(E)/NodePiece/PairRE/
ProjE/QuatE/RESCAL/TorusE/TuckER/AutoSF, base loop
`pykeen_embedder.py:20-90`). Instead of wrapping torch, every model is a
scoring function over (head, relation, tail) embeddings trained with the
same fused on-device pipeline as the siamese embedders: corrupted-triple
batches sampled on device (`ops/negatives.py::siamese_mini_batch`), margin
ranking loss, sparse scatter SGD updates inside one `lax.scan` per epoch.

Scoring functions follow the original papers; distances are "lower is
better" so that `margin_loss(pos, neg, margin)` matches the siamese
convention. Score-based models (DistMult & co.) use distance = -score.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.graph import Graph
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .siamese import SiameseEmbedder


def _normal(key, shape, scale):
    return jax.random.normal(key, shape, jnp.float32) * scale


class KGEModel(SiameseEmbedder):
    """Generic triple-scoring skeleton — the declarative ENTITY/REL/GLOBAL
    table scheme plus `_distance` / `_triple_distance` scoring now lives in
    `SiameseEmbedder` (siamese.py), so every KGE model inherits `mesh=`
    data-parallel training and the plateau callbacks from the shared
    `MinibatchEmbedder` base. This class adds the KGE-wide defaults:
    edge types required, embedding-dimension divisibility for
    complex/quaternion/block models."""

    REL_KEYS = ("edge_type_embedding",)
    # embedding_size must be divisible by this (complex/quaternion/block
    # models).
    DIM_MULTIPLE = 1

    def __init__(self, embedding_size: int = 100, **kwargs):
        if embedding_size % self.DIM_MULTIPLE:
            raise ValueError(
                f"{self.model_name()} requires embedding_size divisible by "
                f"{self.DIM_MULTIPLE}; got {embedding_size}."
            )
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def requires_edge_types(cls) -> bool:
        return True

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 8, "epochs": 2, "batch_size": 64}


# ---------------------------------------------------------------------------
# Translation / projection family
# ---------------------------------------------------------------------------


@register_model
class TransR(KGEModel):
    """Relation-space projection + translation: ||M_r h + r - M_r t||^2
    (reference `pykeen_embedders/transr.py:98`)."""

    REL_KEYS = ("edge_type_embedding", "relation_projection")

    @classmethod
    def model_name(cls) -> str:
        return "TransR"

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        d = self.embedding_size
        k1, k2 = jax.random.split(key)
        eye = jnp.eye(d, dtype=jnp.float32)
        return {
            "edge_type_embedding": _normal(k1, (r, d), 1 / np.sqrt(d)),
            "relation_projection": eye[None]
            + _normal(k2, (r, d, d), 0.1 / np.sqrt(d)),
        }

    def _distance(self, h, t, rel, glob):
        m = rel["relation_projection"]
        proj = lambda e: jnp.einsum("bij,bj->bi", m, e)
        diff = proj(h) + rel["edge_type_embedding"] - proj(t)
        return jnp.sum(diff ** 2, axis=-1)


@register_model
class TransD(KGEModel):
    """Dynamic projection: h_perp = h + (h_p . h) r_p, translation in the
    projected space (reference `pykeen_embedders/transd.py:92`)."""

    ENTITY_KEYS = ("node_embedding", "node_projection")
    REL_KEYS = ("edge_type_embedding", "relation_projection")

    @classmethod
    def model_name(cls) -> str:
        return "TransD"

    def _init_entity_tables(self, graph, key):
        n, d = graph.number_of_nodes, self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "node_embedding": _normal(k1, (n, d), 1 / np.sqrt(d)),
            "node_projection": _normal(k2, (n, d), 1 / np.sqrt(d)),
        }

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        d = self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "edge_type_embedding": _normal(k1, (r, d), 1 / np.sqrt(d)),
            "relation_projection": _normal(k2, (r, d), 1 / np.sqrt(d)),
        }

    def _triple_distance(self, h_dict, t_dict, rel, glob):
        r = rel["edge_type_embedding"]
        rp = rel["relation_projection"]
        perp = lambda e, ep: e + jnp.sum(ep * e, -1, keepdims=True) * rp
        h = perp(h_dict["node_embedding"], h_dict["node_projection"])
        t = perp(t_dict["node_embedding"], t_dict["node_projection"])
        diff = h + r - t
        return jnp.sum(diff ** 2, axis=-1)


@register_model
class TransF(KGEModel):
    """Flexible translation: score = (h + r).t + (t - r).h (reference
    `pykeen_embedders/transf.py:14`)."""

    @classmethod
    def model_name(cls) -> str:
        return "TransF"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        score = jnp.sum((h + r) * t, -1) + jnp.sum((t - r) * h, -1)
        return -score


@register_model
class PairRE(KGEModel):
    """Paired relation vectors on normalized entities:
    ||h' * r_h - t' * r_t||_1 (reference `pykeen_embedders/pairre.py:89`)."""

    REL_KEYS = ("head_relation_embedding", "tail_relation_embedding")
    EXTRACT_REL = ("head_relation_embedding", "tail_relation_embedding")

    @classmethod
    def model_name(cls) -> str:
        return "PairRE"

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        d = self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "head_relation_embedding": _normal(k1, (r, d), 1 / np.sqrt(d)),
            "tail_relation_embedding": _normal(k2, (r, d), 1 / np.sqrt(d)),
        }

    def _distance(self, h, t, rel, glob):
        unit = lambda e: e / jnp.maximum(
            jnp.linalg.norm(e, axis=-1, keepdims=True), 1e-9
        )
        diff = (
            unit(h) * rel["head_relation_embedding"]
            - unit(t) * rel["tail_relation_embedding"]
        )
        return jnp.sum(jnp.abs(diff), axis=-1)


@register_model
class TorusE(KGEModel):
    """Translation on the torus: wrap h + r - t to [-0.5, 0.5) per
    dimension, L1 distance (reference `pykeen_embedders/toruse.py:89`)."""

    @classmethod
    def model_name(cls) -> str:
        return "TorusE"

    def _distance(self, h, t, rel, glob):
        diff = h + rel["edge_type_embedding"] - t
        wrapped = diff - jnp.round(diff)
        return jnp.sum(jnp.abs(wrapped), axis=-1)


# ---------------------------------------------------------------------------
# (Semi-)bilinear family
# ---------------------------------------------------------------------------


@register_model
class DistMult(KGEModel):
    """Diagonal bilinear: score = <h, r, t> (reference
    `pykeen_embedders/distmult.py:14`)."""

    @classmethod
    def model_name(cls) -> str:
        return "DistMult"

    def _distance(self, h, t, rel, glob):
        return -jnp.sum(h * rel["edge_type_embedding"] * t, axis=-1)


@register_model
class ComplEx(KGEModel):
    """Complex diagonal bilinear: Re(<h, r, conj(t)>) with the first/second
    half of each vector as real/imaginary parts (reference
    `pykeen_embedders/complex.py:14`)."""

    DIM_MULTIPLE = 2

    @classmethod
    def model_name(cls) -> str:
        return "ComplEx"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        hr, hi = jnp.split(h, 2, axis=-1)
        rr, ri = jnp.split(r, 2, axis=-1)
        tr, ti = jnp.split(t, 2, axis=-1)
        score = jnp.sum(
            rr * (hr * tr + hi * ti) + ri * (hi * tr - hr * ti), axis=-1
        )
        return -score


@register_model
class RotatE(KGEModel):
    """Rotation in the complex plane: || h o e^{i theta} - t ||, relation =
    phase vector (reference `pykeen_embedders/rotate.py:14`)."""

    DIM_MULTIPLE = 2

    @classmethod
    def model_name(cls) -> str:
        return "RotatE"

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        return {
            "edge_type_embedding": jax.random.uniform(
                key, (r, self.embedding_size // 2), jnp.float32,
                -np.pi, np.pi,
            )
        }

    def _distance(self, h, t, rel, glob):
        theta = rel["edge_type_embedding"]
        hr, hi = jnp.split(h, 2, axis=-1)
        tr, ti = jnp.split(t, 2, axis=-1)
        c, s = jnp.cos(theta), jnp.sin(theta)
        rot_r = hr * c - hi * s
        rot_i = hr * s + hi * c
        mod = jnp.sqrt((rot_r - tr) ** 2 + (rot_i - ti) ** 2 + 1e-12)
        return jnp.sum(mod, axis=-1)


@register_model
class HolE(KGEModel):
    """Holographic embeddings: score = <r, circ_corr(h, t)> computed via
    rFFT (reference `pykeen_embedders/hole.py:14`)."""

    @classmethod
    def model_name(cls) -> str:
        return "HolE"

    def _distance(self, h, t, rel, glob):
        d = h.shape[-1]
        corr = jnp.fft.irfft(
            jnp.conj(jnp.fft.rfft(h, axis=-1)) * jnp.fft.rfft(t, axis=-1),
            n=d, axis=-1,
        )
        return -jnp.sum(rel["edge_type_embedding"] * corr, axis=-1)


@register_model
class RESCAL(KGEModel):
    """Full bilinear relation matrices: score = h^T M_r t (reference
    `pykeen_embedders/rescal.py:14`)."""

    REL_KEYS = ("relation_matrix",)
    EXTRACT_REL = ()

    @classmethod
    def model_name(cls) -> str:
        return "RESCAL"

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        d = self.embedding_size
        return {"relation_matrix": _normal(key, (r, d, d), 1 / d)}

    def _distance(self, h, t, rel, glob):
        return -jnp.einsum("bi,bij,bj->b", h, rel["relation_matrix"], t)


@register_model
class TuckER(KGEModel):
    """Tucker decomposition with a shared core tensor:
    score = W x1 h x2 r x3 t (reference `pykeen_embedders/tucker.py:104`)."""

    GLOBAL_KEYS = ("core_tensor",)

    @classmethod
    def model_name(cls) -> str:
        return "TuckER"

    def _init_global_tables(self, graph, key):
        d = self.embedding_size
        return {"core_tensor": _normal(key, (d, d, d), 1 / d)}

    def _distance(self, h, t, rel, glob):
        return -jnp.einsum(
            "bi,ijk,bj,bk->b",
            h, glob["core_tensor"], rel["edge_type_embedding"], t,
        )


@register_model
class QuatE(KGEModel):
    """Quaternion rotation: score = <h (x) r_unit, t> with Hamilton product
    (reference `pykeen_embedders/quate.py:14`)."""

    DIM_MULTIPLE = 4

    @classmethod
    def model_name(cls) -> str:
        return "QuatE"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        ha, hb, hc, hd = jnp.split(h, 4, axis=-1)
        ra, rb, rc, rd = jnp.split(r, 4, axis=-1)
        ta, tb, tc, td = jnp.split(t, 4, axis=-1)
        norm = jnp.sqrt(ra**2 + rb**2 + rc**2 + rd**2 + 1e-12)
        ra, rb, rc, rd = ra / norm, rb / norm, rc / norm, rd / norm
        # Hamilton product h (x) r
        pa = ha * ra - hb * rb - hc * rc - hd * rd
        pb = ha * rb + hb * ra + hc * rd - hd * rc
        pc = ha * rc - hb * rd + hc * ra + hd * rb
        pd = ha * rd + hb * rc - hc * rb + hd * ra
        score = jnp.sum(pa * ta + pb * tb + pc * tc + pd * td, axis=-1)
        return -score


@register_model
class DistMA(KGEModel):
    """Additive dot products: score = <h,r> + <r,t> + <h,t> (reference
    `pykeen_embedders/distma.py:14`)."""

    @classmethod
    def model_name(cls) -> str:
        return "DistMA"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        score = (
            jnp.sum(h * r, -1) + jnp.sum(r * t, -1) + jnp.sum(h * t, -1)
        )
        return -score


@register_model
class AutoSF(KGEModel):
    """Block-bilinear scoring function from the AutoSF search space, using
    the SimplE-pattern seed structure over 4 blocks:
    f = <h1,r1,t1> + <h2,r2,t2> + <h3,r3,t4> - <h4,r4,t3>
    (reference `pykeen_embedders/auto_sf.py:84`)."""

    DIM_MULTIPLE = 4

    @classmethod
    def model_name(cls) -> str:
        return "AutoSF"

    def _distance(self, h, t, rel, glob):
        r = rel["edge_type_embedding"]
        h1, h2, h3, h4 = jnp.split(h, 4, axis=-1)
        r1, r2, r3, r4 = jnp.split(r, 4, axis=-1)
        t1, t2, t3, t4 = jnp.split(t, 4, axis=-1)
        score = (
            jnp.sum(h1 * r1 * t1, -1)
            + jnp.sum(h2 * r2 * t2, -1)
            + jnp.sum(h3 * r3 * t4, -1)
            - jnp.sum(h4 * r4 * t3, -1)
        )
        return -score


# ---------------------------------------------------------------------------
# Neural / interaction family
# ---------------------------------------------------------------------------


@register_model
class ProjE(KGEModel):
    """Shared combination operator: e = tanh(d_e o h + d_r o r + b);
    score = <e, t> (reference `pykeen_embedders/proje.py:14`)."""

    GLOBAL_KEYS = ("entity_weight", "relation_weight", "combination_bias")

    @classmethod
    def model_name(cls) -> str:
        return "ProjE"

    def _init_global_tables(self, graph, key):
        d = self.embedding_size
        return {
            "entity_weight": jnp.ones((d,), jnp.float32),
            "relation_weight": jnp.ones((d,), jnp.float32),
            "combination_bias": jnp.zeros((d,), jnp.float32),
        }

    def _distance(self, h, t, rel, glob):
        e = jnp.tanh(
            glob["entity_weight"] * h
            + glob["relation_weight"] * rel["edge_type_embedding"]
            + glob["combination_bias"]
        )
        return -jnp.sum(e * t, axis=-1)


@register_model
class CrossE(KGEModel):
    """Crossover interactions: q = tanh(c o h + c o h o r + b);
    score = <q, t> (reference `pykeen_embedders/crosse.py:84`)."""

    REL_KEYS = ("edge_type_embedding", "interaction_embedding")
    GLOBAL_KEYS = ("combination_bias",)

    @classmethod
    def model_name(cls) -> str:
        return "CrossE"

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        d = self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "edge_type_embedding": _normal(k1, (r, d), 1 / np.sqrt(d)),
            "interaction_embedding": jnp.ones((r, d), jnp.float32)
            + _normal(k2, (r, d), 0.1 / np.sqrt(d)),
        }

    def _init_global_tables(self, graph, key):
        return {
            "combination_bias": jnp.zeros(
                (self.embedding_size,), jnp.float32
            )
        }

    def _distance(self, h, t, rel, glob):
        c = rel["interaction_embedding"]
        r = rel["edge_type_embedding"]
        q = jnp.tanh(c * h + c * h * r + glob["combination_bias"])
        return -jnp.sum(q * t, axis=-1)


@register_model
class ERMLP(KGEModel):
    """MLP over the concatenated triple: score = w2 . tanh(W1 [h;r;t] + b1)
    (reference `pykeen_embedders/ermlp.py:92`)."""

    GLOBAL_KEYS = ("mlp_w1", "mlp_b1", "mlp_w2")

    @classmethod
    def model_name(cls) -> str:
        return "ERMLP"

    def _init_global_tables(self, graph, key):
        d = self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "mlp_w1": _normal(k1, (3 * d, d), 1 / np.sqrt(3 * d)),
            "mlp_b1": jnp.zeros((d,), jnp.float32),
            "mlp_w2": _normal(k2, (d,), 1 / np.sqrt(d)),
        }

    def _distance(self, h, t, rel, glob):
        x = jnp.concatenate([h, rel["edge_type_embedding"], t], axis=-1)
        hidden = jnp.tanh(x @ glob["mlp_w1"] + glob["mlp_b1"])
        return -(hidden @ glob["mlp_w2"])


@register_model
class ERMLPE(KGEModel):
    """ERMLP (E) variant: a two-layer MLP encodes [h; r] into entity space,
    scored against t by dot product (reference
    `pykeen_embedders/ermlpe.py:92`)."""

    GLOBAL_KEYS = ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2")

    @classmethod
    def model_name(cls) -> str:
        return "ERMLPE"

    def _init_global_tables(self, graph, key):
        d = self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "mlp_w1": _normal(k1, (2 * d, d), 1 / np.sqrt(2 * d)),
            "mlp_b1": jnp.zeros((d,), jnp.float32),
            "mlp_w2": _normal(k2, (d, d), 1 / np.sqrt(d)),
            "mlp_b2": jnp.zeros((d,), jnp.float32),
        }

    def _distance(self, h, t, rel, glob):
        x = jnp.concatenate([h, rel["edge_type_embedding"]], axis=-1)
        hidden = jax.nn.relu(x @ glob["mlp_w1"] + glob["mlp_b1"])
        e = jax.nn.relu(hidden @ glob["mlp_w2"] + glob["mlp_b2"])
        return -jnp.sum(e * t, axis=-1)


@register_model
class ConvE(KGEModel):
    """2D convolution over the stacked [h; r] feature map, projected back to
    entity space and scored against t (reference
    `pykeen_embedders/conve.py:132`). Feature-map height is the largest
    divisor of embedding_size <= sqrt(embedding_size)."""

    GLOBAL_KEYS = ("conv_kernel", "conv_bias", "fc_weight", "fc_bias")

    def __init__(
        self, embedding_size: int = 100, number_of_filters: int = 8,
        **kwargs,
    ):
        self._number_of_filters = number_of_filters
        hh = int(np.floor(np.sqrt(embedding_size)))
        while embedding_size % hh:
            hh -= 1
        ww = embedding_size // hh
        if 2 * hh < 3 or ww < 3:
            raise ValueError(
                f"ConvE needs a feature map of at least 3x3 after stacking; "
                f"embedding_size={embedding_size} reshapes to "
                f"({2 * hh}, {ww})."
            )
        self._map_shape = (hh, ww)
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "ConvE"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "number_of_filters": self._number_of_filters,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 9, "epochs": 2, "batch_size": 64,
            "number_of_filters": 2,
        }

    def _init_global_tables(self, graph, key):
        d = self.embedding_size
        hh, ww = self._map_shape
        f = self._number_of_filters
        flat = f * (2 * hh - 2) * (ww - 2)
        k1, k2 = jax.random.split(key)
        return {
            "conv_kernel": _normal(k1, (f, 1, 3, 3), 1 / 3.0),
            "conv_bias": jnp.zeros((f,), jnp.float32),
            "fc_weight": _normal(k2, (flat, d), 1 / np.sqrt(flat)),
            "fc_bias": jnp.zeros((d,), jnp.float32),
        }

    def _distance(self, h, t, rel, glob):
        hh, ww = self._map_shape
        b = h.shape[0]
        image = jnp.concatenate(
            [h.reshape(b, hh, ww), rel["edge_type_embedding"].reshape(b, hh, ww)],
            axis=1,
        )[:, None]  # (B, 1, 2hh, ww)
        conv = jax.lax.conv_general_dilated(
            image, glob["conv_kernel"], (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
        ) + glob["conv_bias"][None, :, None, None]
        conv = jax.nn.relu(conv).reshape(b, -1)
        e = jax.nn.relu(conv @ glob["fc_weight"] + glob["fc_bias"])
        return -jnp.sum(e * t, axis=-1)


# ---------------------------------------------------------------------------
# Spatial / box family
# ---------------------------------------------------------------------------


@register_model
class BoxE(KGEModel):
    """Box embeddings: each entity is a point + a translational bump; each
    relation defines a head box and a tail box. The head point (bumped by
    the tail entity) must fall in the head box and vice versa; the distance
    grows slowly inside the box and sharply outside, continuous at the
    boundary (reference `pykeen_embedders/boxe.py:96`)."""

    ENTITY_KEYS = ("node_embedding", "node_bump")
    REL_KEYS = (
        "head_box_center", "head_box_size",
        "tail_box_center", "tail_box_size",
    )
    EXTRACT_REL = ("head_box_center", "tail_box_center")

    @classmethod
    def model_name(cls) -> str:
        return "BoxE"

    def _init_entity_tables(self, graph, key):
        n, d = graph.number_of_nodes, self.embedding_size
        k1, k2 = jax.random.split(key)
        return {
            "node_embedding": _normal(k1, (n, d), 1 / np.sqrt(d)),
            "node_bump": _normal(k2, (n, d), 1 / np.sqrt(d)),
        }

    def _init_relation_tables(self, graph, key):
        r = max(graph.number_of_edge_types, 1)
        d = self.embedding_size
        keys = jax.random.split(key, 4)
        return {
            "head_box_center": _normal(keys[0], (r, d), 1 / np.sqrt(d)),
            "head_box_size": jnp.zeros((r, d), jnp.float32),
            "tail_box_center": _normal(keys[1], (r, d), 1 / np.sqrt(d)),
            "tail_box_size": jnp.zeros((r, d), jnp.float32),
        }

    @staticmethod
    def _point_box_distance(p, center, raw_size):
        w = jax.nn.softplus(raw_size) + 1e-6  # positive width
        dist = jnp.abs(p - center)
        inside = dist <= w / 2
        # continuity constant: inside and outside branches agree at w/2
        k = 0.5 * w * (w + 2) * w / (w + 1) / (w + 1)
        per_dim = jnp.where(
            inside, dist / (w + 1), dist * (w + 1) - k
        )
        return jnp.sum(per_dim, axis=-1)

    def _triple_distance(self, h_dict, t_dict, rel, glob):
        h_point = h_dict["node_embedding"] + t_dict["node_bump"]
        t_point = t_dict["node_embedding"] + h_dict["node_bump"]
        return self._point_box_distance(
            h_point, rel["head_box_center"], rel["head_box_size"]
        ) + self._point_box_distance(
            t_point, rel["tail_box_center"], rel["tail_box_size"]
        )


# ---------------------------------------------------------------------------
# Tokenized entities
# ---------------------------------------------------------------------------


@register_model
class NodePiece(KGEModel):
    """Anchor-tokenized entities: each node is represented by its k nearest
    anchor nodes (BFS distance, computed host-side at init); the entity
    embedding is an encoder over the anchor-token embeddings, scored with a
    DistMult head (reference `pykeen_embedders/node_piece.py:84`; original
    NodePiece paper). The anchor vocabulary replaces the O(n) entity table —
    the point of NodePiece is parameter efficiency."""

    ENTITY_KEYS = ()  # entities are encoded, not stored
    REL_KEYS = ("edge_type_embedding",)
    GLOBAL_KEYS = ("anchor_embedding", "encoder_weight", "encoder_bias")

    def __init__(
        self,
        embedding_size: int = 100,
        number_of_anchors: int = 256,
        tokens_per_node: int = 8,
        **kwargs,
    ):
        self._number_of_anchors = number_of_anchors
        self._tokens_per_node = tokens_per_node
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "NodePiece"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "number_of_anchors": self._number_of_anchors,
            "tokens_per_node": self._tokens_per_node,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {
            "embedding_size": 8, "epochs": 2, "batch_size": 64,
            "number_of_anchors": 8, "tokens_per_node": 2,
        }

    def _tokenize(self, graph: Graph) -> np.ndarray:
        """(n, k) anchor-token ids per node; id == n_anchors is padding for
        nodes that cannot reach enough anchors."""
        n = graph.number_of_nodes
        n_anchors = min(self._number_of_anchors, n)
        k = self._tokens_per_node
        anchors = np.argsort(-graph.degrees, kind="stable")[:n_anchors]
        row_ptr, col_idx = graph.row_ptr, graph.col_idx
        # BFS from each anchor; record distances (multi-source per anchor).
        dist = np.full((n_anchors, n), np.iinfo(np.int32).max, np.int32)
        for a_i, a in enumerate(anchors):
            d = dist[a_i]
            d[a] = 0
            frontier = np.array([a], dtype=np.int64)
            level = 0
            while len(frontier):
                level += 1
                neigh = np.concatenate(
                    [
                        col_idx[row_ptr[v]: row_ptr[v + 1]]
                        for v in frontier
                    ]
                ) if len(frontier) else np.empty(0, np.int64)
                neigh = np.unique(neigh)
                new = neigh[d[neigh] > level]
                d[new] = level
                frontier = new
        order = np.argsort(dist, axis=0, kind="stable")[:k]  # (k, n)
        tokens = order.T.astype(np.int32)  # (n, k)
        # mask unreachable anchors with the padding id
        reach = np.take_along_axis(dist.T, tokens, axis=1) < np.iinfo(
            np.int32
        ).max
        tokens = np.where(reach, tokens, n_anchors)
        return tokens

    def _prepare_data(self, graph: Graph):
        # Tokens ride the jit ARGUMENT path (via the batch's shared leaves):
        # a closure over the [N, k] token table would lower it as an inline
        # HLO constant (tens of MB at bench scale — the failure class that
        # broke the Perceptron on the remote compile backend).
        self._tokens = self._tokenize(graph)
        return {
            "dg": super()._prepare_data(graph),
            "tokens": jnp.asarray(self._tokens),
        }

    def _sample_batch(self, ctx, key, batch_size: int):
        sl, _ = super()._sample_batch(ctx["dg"], key, batch_size)
        return sl, (ctx["tokens"],)

    def _init_params(self, graph: Graph, key):
        d = self.embedding_size
        n_anchors = min(self._number_of_anchors, graph.number_of_nodes)
        r = max(graph.number_of_edge_types, 1)
        k1, k2, k3 = jax.random.split(key, 3)
        anchor = _normal(k1, (n_anchors + 1, d), 1 / np.sqrt(d))
        anchor = anchor.at[n_anchors].set(0.0)  # padding token
        return {
            "anchor_embedding": anchor,
            "encoder_weight": jnp.eye(d, dtype=jnp.float32)
            + _normal(k2, (d, d), 0.1 / np.sqrt(d)),
            "encoder_bias": jnp.zeros((d,), jnp.float32),
            "edge_type_embedding": _normal(k3, (r, d), 1 / np.sqrt(d)),
        }

    def _encode(self, node_ids, glob, tokens):
        toks = tokens[node_ids]  # (..., k)
        emb = glob["anchor_embedding"][toks]  # (..., k, d)
        pooled = emb.mean(axis=-2)
        return jnp.tanh(
            pooled @ glob["encoder_weight"] + glob["encoder_bias"]
        )

    def _batch_updates(self, params, batch, full_batch):
        from .minibatch import Update

        (src, dst, csrc, cdst, etype), (tokens,) = batch
        rel = {"edge_type_embedding": params["edge_type_embedding"][etype]}
        glob = {n: params[n] for n in self.GLOBAL_KEYS}
        bias = self._relu_bias

        def loss_fn(rel, glob):
            score = lambda a, b: -jnp.sum(
                self._encode(a, glob, tokens)
                * rel["edge_type_embedding"]
                * self._encode(b, glob, tokens),
                axis=-1,
            )
            margin = jnp.maximum(
                bias + score(src, dst) - score(csrc, cdst), 0.0
            )
            return margin.sum() / full_batch

        loss, (g_rel, g_glob) = jax.value_and_grad(
            loss_fn, argnums=(0, 1)
        )(rel, glob)
        updates = [
            Update(
                "edge_type_embedding", etype,
                g_rel["edge_type_embedding"], "add",
            )
        ] + [Update(n, None, g_glob[n], "dense") for n in self.GLOBAL_KEYS]
        return loss * full_batch, updates

    def _extract(self, params, graph):
        # Materialize encoded node embeddings once at the end.
        glob = {n: params[n] for n in self.GLOBAL_KEYS}
        node_ids = jnp.arange(graph.number_of_nodes)
        emb = jax.jit(self._encode)(
            node_ids, glob, jnp.asarray(self._tokens)
        )
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[np.asarray(emb)],
            edge_type_embeddings=[np.asarray(params["edge_type_embedding"])],
            node_names=graph.get_node_names(),
        )


KGE_MODELS = (
    TransR, TransD, TransF, PairRE, TorusE,
    DistMult, ComplEx, RotatE, HolE, RESCAL, TuckER, QuatE, DistMA, AutoSF,
    ProjE, CrossE, ERMLP, ERMLPE, ConvE,
    BoxE, NodePiece,
)
