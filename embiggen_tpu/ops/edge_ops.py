"""Edge-embedding operators: combine source/destination node embeddings into
edge features. Mirrors the reference's `EdgeTransformer.methods` table
(`embiggen/embedding_transformers/edge_transformer.py:348-364`, functions
`:12-344`) plus the GCN edge-combination set
(`embiggen/utils/abstract_edge_gcn.py:356-370`).

All operators are pure jnp (differentiable, jit/vmap-safe); they work equally
on host numpy arrays via jnp's array coercion.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Union

import jax.numpy as jnp
import numpy as np

EPS = 1e-6


def _xp(*arrays):
    """Array namespace of the inputs: jnp for device arrays/tracers, numpy
    for host arrays. Every op below serves BOTH worlds — inside jitted GCN
    combination code and in host feature pipelines (perceptron, edge
    transformers). Host inputs stay in numpy: sending them through jnp
    would copy the feature rows to the device and back on every call."""
    import jax

    return (
        jnp if any(isinstance(a, jax.Array) for a in arrays) else np
    )


def hadamard(src, dst):
    return src * dst


def sum_op(src, dst):
    return src + dst


def average(src, dst):
    return (src + dst) / 2.0


def l1(src, dst):
    """Signed difference (the reference's 'L1')."""
    return src - dst


def absolute_l1(src, dst):
    return _xp(src, dst).abs(src - dst)


def squared_l2(src, dst):
    return (src - dst) ** 2


def l2(src, dst):
    """Element-wise sqrt of squared difference = |src - dst| (reference 'L2')."""
    return _xp(src, dst).sqrt((src - dst) ** 2)


def concatenate(src, dst):
    return _xp(src, dst).concatenate([src, dst], axis=-1)


def minimum(src, dst):
    return _xp(src, dst).minimum(src, dst)


def maximum(src, dst):
    return _xp(src, dst).maximum(src, dst)


def l2_distance(src, dst):
    xp = _xp(src, dst)
    return xp.sqrt(xp.sum((src - dst) ** 2, axis=-1, keepdims=True))


def cosine_similarity(src, dst):
    xp = _xp(src, dst)
    num = xp.sum(src * dst, axis=-1, keepdims=True)
    norm = xp.sqrt(
        xp.sum(src ** 2, axis=-1, keepdims=True)
        * xp.sum(dst ** 2, axis=-1, keepdims=True)
    )
    return num / xp.maximum(norm, EPS)


def subtract(src, dst):
    return src - dst


def l1_norm(edge_embedding):
    """Row-wise L1 norm of an edge embedding → [B, 1] (reference
    `get_l1_norm_edge_embedding`, `edge_transformer.py:107-122`)."""
    xp = _xp(edge_embedding)
    return xp.sum(xp.abs(edge_embedding), axis=-1, keepdims=True)


def l2_norm(edge_embedding):
    """Row-wise L2 norm of an edge embedding → [B, 1] (reference
    `get_l2_norm_edge_embedding`, `edge_transformer.py:176-189`; used by the
    reference to normalize cosine similarity)."""
    xp = _xp(edge_embedding)
    return xp.sqrt(xp.sum(edge_embedding ** 2, axis=-1, keepdims=True))


def dot(src, dst):
    return _xp(src, dst).sum(src * dst, axis=-1, keepdims=True)


def l1_norm_op(src, dst):
    """'L1Norm' method: row L1 norm of the signed-difference edge embedding
    (composition of reference `get_l1_edge_embedding` +
    `get_l1_norm_edge_embedding`, `edge_transformer.py:85-122`) → [B, 1]."""
    return l1_norm(src - dst)


def l2_norm_op(src, dst):
    """'L2Norm' method: row L2 norm of the signed-difference edge embedding
    (composition of reference `get_l1_edge_embedding` +
    `get_l2_norm_edge_embedding`, `edge_transformer.py:176-189`) → [B, 1]."""
    return l2_norm(src - dst)


# Reference EdgeTransformer method table (edge_transformer.py:348-364).
EDGE_TRANSFORMER_METHODS: Dict[str, Callable] = {
    "Hadamard": hadamard,
    "Sum": sum_op,
    "Average": average,
    "L1": l1,
    "AbsoluteL1": absolute_l1,
    "SquaredL2": squared_l2,
    "L2": l2,
    "Concatenate": concatenate,
    "Min": minimum,
    "Max": maximum,
    "L2Distance": l2_distance,
    "CosineSimilarity": cosine_similarity,
    # Row-norm operators exposed as module helpers by the reference
    # (edge_transformer.py:107-122,176-189); registered here as first-class
    # methods so every reference edge-operator name resolves.
    "L1Norm": l1_norm_op,
    "L2Norm": l2_norm_op,
}

# Reference edge-GCN combination set (abstract_edge_gcn.py:356-370).
EDGE_GCN_METHODS: Dict[str, Callable] = {
    "Concatenate": concatenate,
    "Average": average,
    "Hadamard": hadamard,
    "Maximum": maximum,
    "Minimum": minimum,
    "Add": sum_op,
    "Subtract": subtract,
    "L1": absolute_l1,
    "L2": squared_l2,
    "Dot": dot,
}

# Reference perceptron edge-embedding set
# (edge_prediction_ensmallen/perceptron.py:15-117).
PERCEPTRON_EDGE_METHODS: Dict[str, Callable] = {
    "CosineSimilarity": cosine_similarity,
    "EuclideanDistance": l2_distance,
    "Concatenate": concatenate,
    "Hadamard": hadamard,
    "L1": absolute_l1,
    "L2": squared_l2,
    "Add": sum_op,
    "Sub": subtract,
    "Maximum": maximum,
    "Minimum": minimum,
}


def resolve(method: Union[str, Callable], table: Dict[str, Callable] = None) -> Callable:
    if callable(method):
        return method
    table = table or EDGE_TRANSFORMER_METHODS
    # Case-insensitive resolution with a helpful error.
    for name, fn in table.items():
        if name.lower() == method.lower():
            return fn
    raise ValueError(
        f"Unknown edge-embedding method {method!r}; available: {sorted(table)}"
    )


def output_dim(method: str, embedding_dim: int) -> int:
    """Feature width the operator produces for a given node-embedding width."""
    name = method.lower()
    if name == "concatenate":
        return 2 * embedding_dim
    if name in (
        "l2distance", "cosinesimilarity", "dot", "euclideandistance",
        "l1norm", "l2norm",
    ):
        return 1
    return embedding_dim
