"""HyperLogLog k-hop neighborhood sketches on device — the kernel behind
HyperSketching (reference `ensmallen.models.HyperSketching` via
`embiggen/embedders/ensmallen_embedders/hyper_sketching.py:15-140`).

HLL union is register-wise max, so the k-hop sketch propagation is one
`segment_max` over edges per hop — the same sparse-propagation shape as the
SpMM/BFS kernels, fully parallel over registers and nodes.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.graph import DeviceGraph


def _hash32(x: jnp.ndarray) -> jnp.ndarray:
    """32-bit avalanche hash (lowbias32-style), uint32 in/out."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> jnp.uint32(15))
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> jnp.uint32(16))
    return x


def singleton_registers(
    n_nodes: int, precision: int = 8, bits: int = 6, seed: int = 0
) -> jnp.ndarray:
    """[N, 2^precision] uint8 HLL registers for the singleton sets {v}."""
    m = 1 << precision
    ids = jnp.arange(n_nodes, dtype=jnp.uint32) + jnp.uint32(
        (seed * 1_000_003) & 0x7FFFFFFF
    )
    h = _hash32(ids)
    reg_idx = (h & jnp.uint32(m - 1)).astype(jnp.int32)
    rest = (h >> jnp.uint32(precision)).astype(jnp.int32)
    # rho = leading zeros within the (32 - precision)-bit value + 1;
    # lax.clz counts over 32 bits, so subtract the masked-off prefix.
    clz_in_width = jax.lax.clz(rest) - precision
    rho = jnp.where(rest == 0, (1 << bits) - 1, clz_in_width + 1)
    rho = jnp.clip(rho, 1, (1 << bits) - 1).astype(jnp.uint8)
    regs = jnp.zeros((n_nodes, m), dtype=jnp.uint8)
    return regs.at[jnp.arange(n_nodes), reg_idx].set(rho)


@functools.partial(jax.jit, static_argnames=("hops",))
def khop_sketches(dg: DeviceGraph, base: jnp.ndarray, hops: int) -> jnp.ndarray:
    """[hops, N, M] registers of the 1..hops-hop balls (register-wise max
    propagation; each hop includes the previous ball)."""
    rows = jnp.searchsorted(
        dg.row_ptr, jnp.arange(dg.n_arcs, dtype=jnp.int32), side="right"
    ).astype(jnp.int32) - 1
    cols = dg.col_idx

    out = []
    current = base
    for _ in range(hops):
        neigh = jax.ops.segment_max(
            current[cols], rows, num_segments=dg.n_nodes,
            indices_are_sorted=True,
        )
        current = jnp.maximum(current, neigh)
        out.append(current)
    return jnp.stack(out)


def hll_cardinality(regs: jnp.ndarray, precision: int) -> jnp.ndarray:
    """HLL cardinality estimate over the last axis ([..., M] registers)."""
    m = 1 << precision
    alpha = {4: 0.673, 5: 0.697, 6: 0.709}.get(
        precision, 0.7213 / (1 + 1.079 / m)
    )
    inv = jnp.power(2.0, -regs.astype(jnp.float32))
    raw = alpha * m * m / inv.sum(axis=-1)
    zeros = (regs == 0).sum(axis=-1).astype(jnp.float32)
    # linear counting small-range correction
    linear = m * jnp.log(m / jnp.maximum(zeros, 1e-9))
    return jnp.where(
        (raw <= 2.5 * m) & (zeros > 0), linear, raw
    )


@functools.partial(jax.jit, static_argnames=("precision",))
def edge_sketch_features(
    src_regs: jnp.ndarray,   # [B, H, M]
    dst_regs: jnp.ndarray,   # [B, H, M]
    precision: int,
) -> jnp.ndarray:
    """[B, H*H + 2H] features: pairwise hop-ball overlap cardinalities
    |B_i(s) ∩ B_j(d)| (inclusion-exclusion on HLL unions), plus left/right
    difference cardinalities vs the largest opposite ball."""
    b, h, m = src_regs.shape
    card_s = hll_cardinality(src_regs, precision)        # [B, H]
    card_d = hll_cardinality(dst_regs, precision)        # [B, H]
    union = jnp.maximum(
        src_regs[:, :, None, :], dst_regs[:, None, :, :]
    )                                                     # [B, H, H, M]
    card_u = hll_cardinality(union, precision)            # [B, H, H]
    overlap = jnp.maximum(
        card_s[:, :, None] + card_d[:, None, :] - card_u, 0.0
    )
    left = jnp.maximum(card_s - overlap[:, :, h - 1], 0.0)   # [B, H]
    right = jnp.maximum(card_d - overlap[:, h - 1, :], 0.0)  # [B, H]
    return jnp.concatenate(
        [overlap.reshape(b, h * h), left, right], axis=1
    )
