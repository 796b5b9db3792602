"""Sparse matrix ops for graph convolution: SpMM and SDDMM.

Replaces the reference's `embedding_ops.embedding_lookup_sparse_v2` hot op in
`GraphConvolution` (reference
`embiggen/layers/tensorflow/graph_convolution_layer.py:160-166`).

Two formulations:

1. `spmm` — COO + `segment_sum`: one gathered row per edge, summed into
   its output row by a scatter-add (atomics on a GPU). General; used by
   the small / generic paths (feature preprocessor, SPINE sketches) and as
   the reference the ELL path is tested against.
2. `PaddedKernel` + `spmm_padded` — the GCN path. The kernel is
   re-laid-out host-side into an ELLPACK-style padded neighbour matrix
   [N, K] (K = `ELL_WIDTH`, less when every row is shorter) plus a COO
   overflow list for rows longer than K. The SpMM is then
   gather-and-contract: K full-height row gathers, weighted and summed
   elementwise — no scatter for the padded part, contiguous writes. Device-memory traffic ≈
   N·K·D·4 bytes, the bound for a row-gather SpMM.

Combiners mirror the reference surface: sum / mean / sqrtn
(`graph_convolution_layer.py:16-174`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# Edge chunks are sized so the [chunk, D] gather intermediate stays ~1 GB —
# without chunking, XLA materializes the full [E, D] gather (10 GB at
# E=20M, D=128) and thrashes HBM.
_CHUNK_ELEMENTS = 1 << 28


@functools.partial(
    jax.jit, static_argnames=("n_out", "combiner", "sorted_rows")
)
def spmm(
    rows: jnp.ndarray,      # [E] output row per edge
    cols: jnp.ndarray,      # [E] input row per edge
    vals: jnp.ndarray,      # [E] kernel weights
    x: jnp.ndarray,         # [N_in, D] dense features
    n_out: int,
    combiner: str = "sum",
    sorted_rows: bool = True,
) -> jnp.ndarray:
    """out[r] = combine_{e: rows[e]=r} vals[e] * x[cols[e]]  → [n_out, D].

    CSR-derived COO has sorted rows; `sorted_rows=True` lets XLA skip the
    sort inside the segment reduction. Edges are processed in fixed-size
    chunks to bound the gather intermediate."""
    e = rows.shape[0]
    d = x.shape[1] if x.ndim == 2 else 1
    chunk = max(1, _CHUNK_ELEMENTS // max(d, 1))

    if e <= chunk:
        gathered = x[cols] * vals[:, None].astype(x.dtype)
        out = jax.ops.segment_sum(
            gathered, rows, num_segments=n_out,
            indices_are_sorted=sorted_rows,
        )
    else:
        n_chunks = -(-e // chunk)
        pad = n_chunks * chunk - e
        # out-of-range row sentinel: dropped by the segment reduction
        rows_p = jnp.concatenate(
            [rows, jnp.full((pad,), n_out, rows.dtype)]
        )
        cols_p = jnp.concatenate([cols, jnp.zeros((pad,), cols.dtype)])
        vals_p = jnp.concatenate([vals, jnp.zeros((pad,), vals.dtype)])

        def body(i, out):
            rs = jax.lax.dynamic_slice(rows_p, (i * chunk,), (chunk,))
            cs = jax.lax.dynamic_slice(cols_p, (i * chunk,), (chunk,))
            vs = jax.lax.dynamic_slice(vals_p, (i * chunk,), (chunk,))
            part = jax.ops.segment_sum(
                x[cs] * vs[:, None].astype(x.dtype), rs,
                num_segments=n_out, indices_are_sorted=sorted_rows,
            )
            return out + part

        out = jax.lax.fori_loop(
            0, n_chunks, body, jnp.zeros((n_out, d), x.dtype)
        )
    if combiner == "sum":
        return out
    counts = jax.ops.segment_sum(
        jnp.abs(vals), rows, num_segments=n_out,
        indices_are_sorted=sorted_rows,
    )
    if combiner == "mean":
        return out / jnp.maximum(counts, 1e-9)[:, None].astype(out.dtype)
    if combiner == "sqrtn":
        # sqrtn divides by sqrt(sum of squared weights), TF semantics.
        sq = jax.ops.segment_sum(
            vals * vals, rows, num_segments=n_out,
            indices_are_sorted=sorted_rows,
        )
        return out / jnp.maximum(jnp.sqrt(sq), 1e-9)[:, None].astype(out.dtype)
    raise ValueError(f"Unknown combiner {combiner!r}")


@jax.jit
def sddmm(
    rows: jnp.ndarray, cols: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray
) -> jnp.ndarray:
    """Sampled dense-dense matmul: per-edge scores (a[rows] · b[cols]) → [E]."""
    return jnp.sum(a[rows] * b[cols], axis=-1)


def coo_to_device(
    rows, cols, vals
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    return (
        jnp.asarray(rows, dtype=jnp.int32),
        jnp.asarray(cols, dtype=jnp.int32),
        jnp.asarray(vals, dtype=jnp.float32),
    )



# --------------------------------------------------------------------------
# Single-K ELLPACK SpMM — the GCN path.
#
#   * ONE [n_out, K] padded neighbour table in natural row order — a single
#     full-height gather-contract per slot, no permutation, contiguous
#     writes;
#   * K = ELL_WIDTH (fewer when no row is that long, see `_choose_k`);
#   * rows longer than K send their tail through the sorted segment-sum
#     overflow path;
#   * mean/sqrtn denominators are per-row constants of the kernel,
#     precomputed host-side.
#
# The padded slots gather row 0 with weight 0.
# --------------------------------------------------------------------------

# ELL width. Measured on H100 80GB HBM3 cards (`scripts/spmm_rates.py`,
# D=128 float32, the "Symmetric Normalized Laplacian" of ER(1M nodes, 10M
# edges) and of a heavy-tailed graph of that size). A row costs about as
# much in the gather-contract (4.2e9-4.9e9 rows/s) as in the sorted
# segment-sum overflow at scale (4.3e9-4.5e9 rows/s at 16M rows, 1.0e9-
# 1.2e9 at 1M). Forward+backward `spmm_padded`, medians of three rounds on
# a 700 W card: ER K=4 8.30 ms, K=8 8.44, K=24 9.38; heavy-tailed K=8 5.97
# (the fastest), K=16 6.73. K=24 and K=16 are what the cost model
# n_out*K/gather_rate + overflow/scatter_rate picks at those rates (scatter
# at 1M rows). One single pass on a 400 W card had ER K=8 at 8.63 ms and
# K=24 at 8.17. Wide padding gains at most a few percent on a uniform
# graph, loses on a heavy-tailed one, and compile time grows with K.
ELL_WIDTH = 8


@dataclasses.dataclass(frozen=True)
class PaddedKernel:
    """Single-K ELLPACK layout of a sparse kernel (see above)."""

    cols_pad: "jax.Array"                  # [n_out, K] int32 (0 padded)
    vals_pad: "jax.Array"                  # [n_out, K] f32 (0 padded)
    ov_rows: "jax.Array"                   # [E_ov] int32 (sorted)
    ov_cols: "jax.Array"                   # [E_ov] int32
    ov_vals: "jax.Array"                   # [E_ov] f32
    abs_weight_sum: "jax.Array"            # [n_out] f32 (mean combiner)
    sq_weight_sum: "jax.Array"             # [n_out] f32 (sqrtn combiner)
    n_out: int
    # Transposed-kernel twin (built by `pad_coo(with_transpose=True)`):
    # powers the gather-only custom VJP — backprop through an SpMM is the
    # transposed SpMM, NOT the unsorted scatter-add autodiff would emit.
    pk_t: Optional["PaddedKernel"] = None

    @property
    def padded_elements(self) -> int:
        """Total gathered rows per SpMM pass (the perf accounting unit)."""
        return int(np.prod(self.cols_pad.shape)) + int(self.ov_rows.shape[0])

    def tree_flatten(self):
        children = (
            self.cols_pad, self.vals_pad,
            self.ov_rows, self.ov_cols, self.ov_vals,
            self.abs_weight_sum, self.sq_weight_sum, self.pk_t,
        )
        return children, (self.n_out,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:7], aux[0], children[7])


jax.tree_util.register_pytree_node(
    PaddedKernel, PaddedKernel.tree_flatten, PaddedKernel.tree_unflatten
)


def _choose_k(counts: np.ndarray, cap: int, min_k: int) -> int:
    """ELLPACK width for rows of these degrees: ELL_WIDTH, or the longest
    row rounded up to a multiple of 4 when that is shorter, bounded by
    `cap` and at least `min_k`."""
    widest = ((int(counts.max(initial=0)) + 3) // 4) * 4
    return max(min_k, min(cap, ELL_WIDTH, widest))


def pad_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_out: int,
    cap: int = 512,
    min_k: int = 4,
    n_in: Optional[int] = None,
    with_transpose: bool = False,
) -> PaddedKernel:
    """Host-side relayout of a COO kernel into a single-K PaddedKernel.

    `cap` bounds the ELLPACK width (see `_choose_k`); per-row edges beyond
    the chosen K overflow to the COO segment-sum path. `min_k` is the
    narrowest width.
    `with_transpose` additionally builds the transposed kernel (`pk_t`,
    [n_in, K_t] over n_in = `n_in` or `n_out`), enabling the gather-only
    custom VJP used by GCN training."""
    if with_transpose:
        base = pad_coo(rows, cols, vals, n_out, cap=cap, min_k=min_k)
        pk_t = pad_coo(
            cols, rows, vals, n_in if n_in is not None else n_out,
            cap=cap, min_k=min_k,
        )
        return dataclasses.replace(base, pk_t=pk_t)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    counts = np.bincount(rows, minlength=n_out).astype(np.int64)
    k = _choose_k(counts, cap, min_k)
    n_overflow = int(rows.shape[0] - np.minimum(counts, k).sum())

    # The relayout itself is one native counting-sort pass (C++,
    # `native/graph_algos.cpp::ell_relayout`) — it accepts UNSORTED COO, so
    # the transposed kernel (cols, rows) costs the same O(E) as the forward
    # one instead of an O(E log E) argsort; combiner denominators
    # accumulate in the same pass.
    from .. import native

    got = native.ell_relayout(rows, cols, vals, int(n_out), k, n_overflow)
    if got is not None:
        cp, vp, ovr, ovc, ovv, absw, sqw = got
        return PaddedKernel(
            cols_pad=jnp.asarray(cp),
            vals_pad=jnp.asarray(vp),
            ov_rows=jnp.asarray(ovr),
            ov_cols=jnp.asarray(ovc),
            ov_vals=jnp.asarray(ovv),
            abs_weight_sum=jnp.asarray(absw),
            sq_weight_sum=jnp.asarray(sqw),
            n_out=int(n_out),
        )

    # Vectorized numpy fallback. Combiner denominators over ALL edges
    # (padded + overflow); weighted bincount, not np.add.at (which is an
    # order of magnitude slower at bench scale).
    absw = np.bincount(rows, weights=np.abs(vals), minlength=n_out).astype(
        np.float32
    )
    sqw = np.bincount(rows, weights=vals * vals, minlength=n_out).astype(
        np.float32
    )

    # Per-edge position within its row. CSR-derived COO arrives sorted —
    # skip the O(E log E) stable sort then; arbitrary order still works
    # through the sort path.
    if rows.shape[0] == 0 or bool((rows[1:] >= rows[:-1]).all()):
        r_sorted, c_sorted, v_sorted = rows, cols, vals
    else:
        order = np.argsort(rows, kind="stable")
        r_sorted = rows[order]
        c_sorted = cols[order]
        v_sorted = vals[order]
    row_start = np.zeros(n_out, np.int64)
    row_start[1:] = np.cumsum(counts)[:-1]
    pos = np.arange(rows.shape[0], dtype=np.int64) - row_start[r_sorted]

    in_pad = pos < k
    cp = np.zeros((n_out, k), np.int32)
    vp = np.zeros((n_out, k), np.float32)
    cp[r_sorted[in_pad], pos[in_pad]] = c_sorted[in_pad]
    vp[r_sorted[in_pad], pos[in_pad]] = v_sorted[in_pad]

    ov = ~in_pad
    return PaddedKernel(
        cols_pad=jnp.asarray(cp),
        vals_pad=jnp.asarray(vp),
        ov_rows=jnp.asarray(r_sorted[ov], jnp.int32),
        ov_cols=jnp.asarray(c_sorted[ov], jnp.int32),
        ov_vals=jnp.asarray(v_sorted[ov], jnp.float32),
        abs_weight_sum=jnp.asarray(absw),
        sq_weight_sum=jnp.asarray(sqw),
        n_out=int(n_out),
    )


def _ell_spmm(cols_pad, vals_pad, xf):
    """Gather-contract: out[r] = sum_k vals[r,k] * x[cols[r,k]].

    Contracted as K accumulated full-height 2-D gathers: each gather is an
    [n_out]-row op and the weighted add fuses elementwise behind it, so no
    [n_out, K, D] intermediate is ever materialized (10 GB at K=20,
    D=128, 1M rows). The Python loop unrolls K gathers into the program,
    so compile time grows with K."""
    nb, k = cols_pad.shape
    out = vals_pad[:, 0:1] * xf[cols_pad[:, 0]]
    for j in range(1, k):
        out = out + vals_pad[:, j:j + 1] * xf[cols_pad[:, j]]
    return out


def _spmm_padded_impl(
    pk: PaddedKernel, x: jnp.ndarray, combiner: str
) -> jnp.ndarray:
    xf = x.astype(jnp.float32)
    out = _ell_spmm(pk.cols_pad, pk.vals_pad, xf)
    if pk.ov_rows.shape[0]:
        out = out + jax.ops.segment_sum(
            xf[pk.ov_cols] * pk.ov_vals[:, None],
            pk.ov_rows, num_segments=pk.n_out, indices_are_sorted=True,
        )
    if combiner == "sum":
        return out.astype(x.dtype)
    if combiner == "mean":
        den = jnp.maximum(pk.abs_weight_sum, 1e-9)
    elif combiner == "sqrtn":
        den = jnp.maximum(jnp.sqrt(pk.sq_weight_sum), 1e-9)
    else:
        raise ValueError(f"Unknown combiner {combiner!r}")
    return (out / den[:, None]).astype(x.dtype)


def _zero_cotangent(tree):
    """Zero cotangents for a kernel pytree: float0 for integer leaves."""
    return jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, jax.dtypes.float0)
        if jnp.issubdtype(a.dtype, jnp.integer)
        else jnp.zeros_like(a),
        tree,
    )


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _spmm_padded_diff(pk: PaddedKernel, x: jnp.ndarray, combiner: str):
    return _spmm_padded_impl(pk, x, combiner)


def _spmm_padded_fwd(pk, x, combiner):
    return _spmm_padded_impl(pk, x, combiner), pk


def _spmm_padded_bwd(combiner, pk, g):
    """d/dx of y = D^-1 A x is A^T D^-1 g — ONE transposed gather-SpMM.
    Autodiff of the gather formulation would instead emit an unsorted
    scatter-add over every gathered row; the host-precomputed `pk_t` keeps
    the backward a gather-contract too. Kernel weights are structural
    constants: zero cotangents."""
    gf = g.astype(jnp.float32)
    if combiner == "mean":
        gf = gf / jnp.maximum(pk.abs_weight_sum, 1e-9)[:, None]
    elif combiner == "sqrtn":
        gf = gf / jnp.maximum(jnp.sqrt(pk.sq_weight_sum), 1e-9)[:, None]
    dx = _spmm_padded_impl(pk.pk_t, gf, "sum").astype(g.dtype)
    return (_zero_cotangent(pk), dx)


_spmm_padded_diff.defvjp(_spmm_padded_fwd, _spmm_padded_bwd)


@functools.partial(jax.jit, static_argnames=("combiner",))
def spmm_padded(
    pk: PaddedKernel, x: jnp.ndarray, combiner: str = "sum"
) -> jnp.ndarray:
    """Scatter-free SpMM over a single-K PaddedKernel → [n_out, D].

    When `pk` carries its transpose (`pad_coo(with_transpose=True)`), the
    op is differentiable with a gather-only backward; otherwise autodiff
    falls through to XLA's scatter-add."""
    if pk.pk_t is not None:
        return _spmm_padded_diff(pk, x, combiner)
    return _spmm_padded_impl(pk, x, combiner)
