"""Comparisons of production kernels with plain references.

Each check returns one `Comparison` per output: the largest absolute error,
that error relative to the reference's largest magnitude, the tolerance it
is held to, and the matmul precision it ran under. The CPU tests run them
at small sizes; `tests/test_gpu.py` and `chip_smoke.py` run them on a GPU at
real widths.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# ELL vs COO SpMM. No matmul is involved: both sum the same f32 products,
# ELL in neighbour-slot order, COO through `segment_sum` (atomics on a
# GPU, in an order that changes between runs). A row of degree d then
# differs by about d·eps32 times its largest term, far below these bounds
# for any degree this layout serves.
SPMM_RTOL = 1e-5
SPMM_ATOL_PER_MAX = 1e-5     # atol = SPMM_ATOL_PER_MAX * max|input|

# Banded SkipGram vs per-pair NCE, both float32 under "highest": the band
# and the per-pair form sum the same pair terms in different orders.
SKIPGRAM_RTOL = 1e-5
SKIPGRAM_ATOL_PER_MAX = 1e-6  # atol = SKIPGRAM_ATOL_PER_MAX * max|grad|


@dataclasses.dataclass(frozen=True)
class Comparison:
    name: str
    max_abs: float
    max_rel: float      # max_abs / max|reference|
    rtol: float
    atol: float
    precision: str
    ok: bool
    # False for an error that is reported but not held to the tolerance:
    # `ok` then only says that the output is finite.
    held: bool = True

    def line(self) -> str:
        err = (
            f"{self.name}: max_abs={self.max_abs:.3e} "
            f"max_rel={self.max_rel:.3e}"
        )
        if not self.held:
            verdict = "reported, not held" if self.ok else "FAILED (non-finite)"
            return f"{err} precision={self.precision} {verdict}"
        verdict = "ok" if self.ok else "FAILED"
        return (
            f"{err} tol(rtol={self.rtol:g}, atol={self.atol:.3e}) "
            f"precision={self.precision} {verdict}"
        )


def compare(name, got, want, rtol, atol, precision) -> Comparison:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"{name}: shape {got.shape} != {want.shape}")
    diff = np.abs(got - want)
    max_abs = float(diff.max(initial=0.0))
    scale = float(np.abs(want).max(initial=0.0))
    ok = bool(
        np.isfinite(got).all()
        and (diff <= atol + rtol * np.abs(want)).all()
    )
    return Comparison(
        name, max_abs, max_abs / scale if scale else max_abs,
        rtol, float(atol), precision, ok,
    )


def _precision(precision: str):
    if precision == "default":
        return contextlib.nullcontext()
    return jax.default_matmul_precision(precision)


def check_spmm(
    graph,
    x,
    combiners: Sequence[str] = ("sum", "mean", "sqrtn"),
    kernel: str = "Symmetric Normalized Laplacian",
    seed: int = 0,
) -> List[Comparison]:
    """`spmm_padded` (forward, and its transposed-kernel custom VJP)
    against COO `spmm` and autodiff, over `graph`'s `kernel`."""
    from ..graph import kernel_coo
    from ..ops.spmm import coo_to_device, pad_coo, spmm, spmm_padded

    n = graph.number_of_nodes
    rows, cols, vals = kernel_coo(graph, kernel)
    pk = pad_coo(rows, cols, vals, n, with_transpose=True)
    r, c, v = coo_to_device(rows, cols, vals)
    x = jnp.asarray(x, jnp.float32)
    g = jax.random.normal(jax.random.PRNGKey(seed), x.shape, jnp.float32)
    atol_x = SPMM_ATOL_PER_MAX * float(jnp.abs(x).max())
    atol_g = SPMM_ATOL_PER_MAX * float(jnp.abs(g).max())
    out = []
    for comb in combiners:
        y_ell, vjp_ell = jax.vjp(lambda a: spmm_padded(pk, a, comb), x)
        y_coo, vjp_coo = jax.vjp(lambda a: spmm(r, c, v, a, n, comb), x)
        (dx_ell,) = vjp_ell(g)
        (dx_coo,) = vjp_coo(g)
        out.append(compare(
            f"spmm_padded {comb} forward vs COO", y_ell, y_coo,
            SPMM_RTOL, atol_x, "float32, no matmul",
        ))
        out.append(compare(
            f"spmm_padded {comb} VJP vs COO autodiff", dx_ell, dx_coo,
            SPMM_RTOL, atol_g, "float32, no matmul",
        ))
    return out


def per_pair_skipgram_loss(w_rows, c_rows, b_rows, neg_emb, neg_b, window):
    """Plain SkipGram NCE over gathered walk rows: every (centre, context)
    pair is gathered on its own and scored by `ops.losses.nce_loss` terms,
    each walk against its own negatives. Returns the loss summed over
    pairs, the quantity the banded step differentiates."""
    from ..ops.losses import nce_loss_per_sample
    from ..ops.walks import skipgram_pairs

    length = w_rows.shape[1]
    ctx_pos, centre_pos = skipgram_pairs(
        jnp.arange(length, dtype=jnp.int32)[None], window
    )
    centre = w_rows[:, centre_pos]          # [B, C, D]
    ctx = c_rows[:, ctx_pos]                # [B, C, 2w, D]
    ctx_b = b_rows[:, ctx_pos]              # [B, C, 2w]
    per = jax.vmap(nce_loss_per_sample)(centre, ctx, ctx_b, neg_emb, neg_b)
    return per.sum()


def check_skipgram_band(
    n_nodes: int,
    batch: int = 1024,
    walk_length: int = 64,
    window: int = 5,
    dim: int = 128,
    negatives: int = 10,
    precision: str = "highest",
    seed: int = 0,
) -> List[Comparison]:
    """Loss and gathered-row gradients of `SkipGram._gathered_grads` (the
    banded step) at `precision`, against `per_pair_skipgram_loss` under
    "highest". Held to SKIPGRAM_RTOL/ATOL only under "highest"; at other
    precisions the comparison reports the error of that precision."""
    from ..models.embedders import SkipGram

    model = SkipGram(
        embedding_size=dim, walk_length=walk_length, window_size=window,
        number_of_negative_samples=negatives,
    )
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    scale = 1.0 / np.sqrt(dim)
    params = {
        "node_embedding": scale * jax.random.normal(ks[0], (n_nodes, dim)),
        "context_embedding": scale * jax.random.normal(ks[1], (n_nodes, dim)),
        "context_bias": 0.1 * jax.random.normal(ks[2], (n_nodes,)),
    }
    walks = jax.random.randint(ks[3], (batch, walk_length), 0, n_nodes)
    negs = jax.random.randint(ks[4], (batch, negatives), 0, n_nodes)

    @jax.jit
    def banded(params):
        loss, row_grads, neg_grads = model._gathered_grads(
            lambda name, idx: params[name][idx], walks, negs
        )
        return (loss,) + tuple(row_grads) + tuple(neg_grads)

    @jax.jit
    def reference(params):
        gathered = (
            params["node_embedding"][walks],
            params["context_embedding"][walks],
            params["context_bias"][walks],
            params["context_embedding"][negs],
            params["context_bias"][negs],
        )
        loss, grads = jax.value_and_grad(
            per_pair_skipgram_loss, argnums=(0, 1, 2, 3, 4)
        )(*gathered, window)
        return (loss,) + tuple(grads)

    with _precision(precision):
        got = banded(params)
    with _precision("highest"):
        want = reference(params)
    names = (
        "loss", "d node rows", "d context rows", "d context bias",
        "d negative rows", "d negative bias",
    )
    out = []
    for name, a, b in zip(names, got, want):
        atol = 0.0 if name == "loss" else (
            SKIPGRAM_ATOL_PER_MAX * float(jnp.abs(b).max())
        )
        c = compare(
            f"banded SkipGram {name} vs per-pair", a, b,
            SKIPGRAM_RTOL, atol, precision,
        )
        if precision != "highest":
            c = dataclasses.replace(
                c, ok=bool(np.isfinite(np.asarray(a)).all()), held=False
            )
        out.append(c)
    return out
