"""Numerical parity vs the reference's TensorFlow compute path
(BASELINE.json north star: GCN activations allclose, SkipGram
embedding-gradient parity).

The reference's GraphConvolution hot op is
`embedding_ops.embedding_lookup_sparse_v2` (reference
`embiggen/layers/tensorflow/graph_convolution_layer.py:160-166`); its NCE /
sampled-softmax layers wrap `tf.nn.nce_loss` / `tf.nn.sampled_softmax_loss`
(`noise_contrastive_estimation.py:8-93`, `sampled_softmax.py:9-97`). These
tests run the actual TF ops on CPU and require our kernels to match.
"""
import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax
import jax.numpy as jnp

from embiggen_tpu.graph import karate_club, kernel_coo
from embiggen_tpu.ops.losses import nce_loss, sampled_softmax_loss
from embiggen_tpu.ops.spmm import spmm


@pytest.fixture(scope="module")
def karate():
    return karate_club()


def _tf_sparse_conv(rows, cols, vals, x, combiner):
    """The reference conv: embedding_lookup_sparse over the kernel."""
    n = x.shape[0]
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    # sparse ids: indices (row, position-within-row)
    position = np.zeros(len(rows), dtype=np.int64)
    counts = {}
    for i, r in enumerate(rows):
        position[i] = counts.get(r, 0)
        counts[r] = position[i] + 1
    indices = np.stack([rows, position], axis=1)
    sp_ids = tf.sparse.SparseTensor(
        indices=indices, values=cols.astype(np.int64),
        dense_shape=(n, max(counts.values())),
    )
    sp_weights = tf.sparse.SparseTensor(
        indices=indices, values=vals.astype(np.float32),
        dense_shape=(n, max(counts.values())),
    )
    return tf.nn.embedding_lookup_sparse(
        tf.constant(x), sp_ids, sp_weights, combiner=combiner
    ).numpy()


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_spmm_matches_tf_embedding_lookup_sparse(karate, combiner):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(34, 16)).astype(np.float32)
    rows, cols, vals = kernel_coo(karate, "Symmetric Normalized Laplacian")
    ours = np.asarray(
        spmm(
            jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
            jnp.asarray(vals, jnp.float32), jnp.asarray(x), 34, combiner,
        )
    )
    theirs = _tf_sparse_conv(rows, cols, vals, x, combiner)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


def test_gcn_layer_activation_parity(karate):
    """Full reference conv layer: sparse combine -> Dense -> relu."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(34, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    rows, cols, vals = kernel_coo(karate, "Left Normalized Laplacian")
    agg_tf = _tf_sparse_conv(rows, cols, vals, x, "sum")
    act_tf = tf.nn.relu(tf.constant(agg_tf) @ w + b).numpy()
    agg_ours = np.asarray(
        spmm(
            jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
            jnp.asarray(vals, jnp.float32), jnp.asarray(x), 34, "sum",
        )
    )
    act_ours = np.asarray(jax.nn.relu(jnp.asarray(agg_ours) @ w + b))
    np.testing.assert_allclose(act_ours, act_tf, rtol=1e-4, atol=1e-5)


def _fixed_sampled_values(negs, n_pos, batch):
    """sampled_values with unit expected counts so TF skips the log-Q logit
    adjustment, making the losses directly comparable."""
    return (
        tf.constant(negs.astype(np.int64)),
        tf.ones((batch, n_pos), tf.float32),
        tf.ones((len(negs),), tf.float32),
    )


def test_nce_loss_matches_tf(karate):
    rng = np.random.default_rng(2)
    v, d, batch, n_pos, k = 34, 16, 12, 4, 7
    emb_w = rng.normal(size=(v, d)).astype(np.float32)   # context table
    bias = rng.normal(size=(v,)).astype(np.float32)
    inputs = rng.normal(size=(batch, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(batch, n_pos))
    negs = rng.choice(v, size=k, replace=False)

    tf_loss = tf.reduce_mean(
        tf.nn.nce_loss(
            weights=tf.constant(emb_w),
            biases=tf.constant(bias),
            labels=tf.constant(labels.astype(np.int64)),
            inputs=tf.constant(inputs),
            num_sampled=k,
            num_classes=v,
            num_true=n_pos,
            sampled_values=_fixed_sampled_values(negs, n_pos, batch),
            remove_accidental_hits=False,
        )
    ).numpy()

    ours = float(
        nce_loss(
            jnp.asarray(inputs),
            jnp.asarray(emb_w[labels]),          # [B, P, D]
            jnp.asarray(bias[labels]),           # [B, P]
            jnp.asarray(emb_w[negs]),            # [K, D]
            jnp.asarray(bias[negs]),             # [K]
        )
    )
    np.testing.assert_allclose(ours, tf_loss, rtol=1e-5)


def test_sampled_softmax_matches_tf(karate):
    rng = np.random.default_rng(3)
    v, d, batch, k = 34, 16, 12, 7
    emb_w = rng.normal(size=(v, d)).astype(np.float32)
    bias = rng.normal(size=(v,)).astype(np.float32)
    inputs = rng.normal(size=(batch, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(batch, 1))
    negs = rng.choice(v, size=k, replace=False)

    tf_loss = tf.reduce_mean(
        tf.nn.sampled_softmax_loss(
            weights=tf.constant(emb_w),
            biases=tf.constant(bias),
            labels=tf.constant(labels.astype(np.int64)),
            inputs=tf.constant(inputs),
            num_sampled=k,
            num_classes=v,
            num_true=1,
            sampled_values=_fixed_sampled_values(negs, 1, batch),
            remove_accidental_hits=False,
        )
    ).numpy()

    ours = float(
        sampled_softmax_loss(
            jnp.asarray(inputs),
            jnp.asarray(emb_w[labels[:, 0]]),
            jnp.asarray(bias[labels[:, 0]]),
            jnp.asarray(emb_w[negs]),
            jnp.asarray(bias[negs]),
        )
    )
    np.testing.assert_allclose(ours, tf_loss, rtol=1e-5)


def test_skipgram_gradient_parity(karate):
    """Embedding gradients of the NCE objective match TF's (BASELINE:
    'SkipGram embedding-gradient parity')."""
    rng = np.random.default_rng(4)
    v, d, batch, n_pos, k = 34, 8, 6, 2, 5
    emb_w = rng.normal(size=(v, d)).astype(np.float32)
    bias = np.zeros((v,), np.float32)
    inputs = rng.normal(size=(batch, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(batch, n_pos))
    negs = rng.choice(v, size=k, replace=False)

    inp_tf = tf.Variable(inputs)
    with tf.GradientTape() as tape:
        loss_tf = tf.reduce_mean(
            tf.nn.nce_loss(
                weights=tf.constant(emb_w),
                biases=tf.constant(bias),
                labels=tf.constant(labels.astype(np.int64)),
                inputs=inp_tf,
                num_sampled=k,
                num_classes=v,
                num_true=n_pos,
                sampled_values=_fixed_sampled_values(negs, n_pos, batch),
                remove_accidental_hits=False,
            )
        )
    grad_tf = tape.gradient(loss_tf, inp_tf).numpy()

    grad_ours = np.asarray(
        jax.grad(
            lambda inp: nce_loss(
                inp,
                jnp.asarray(emb_w[labels]),
                jnp.asarray(bias[labels]),
                jnp.asarray(emb_w[negs]),
                jnp.asarray(bias[negs]),
            )
        )(jnp.asarray(inputs))
    )
    np.testing.assert_allclose(grad_ours, grad_tf, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_spmm_padded_matches_tf_embedding_lookup_sparse(karate, combiner):
    """The production bucketed-ELLPACK path (the one GCNEncoder uses) must
    match tf.nn.embedding_lookup_sparse for all combiners — including with a
    cap below the max degree, which forces rows through the overflow path."""
    from embiggen_tpu.ops.spmm import pad_coo, spmm_padded

    rng = np.random.default_rng(0)
    x = rng.normal(size=(34, 16)).astype(np.float32)
    rows, cols, vals = kernel_coo(karate, "Symmetric Normalized Laplacian")
    theirs = _tf_sparse_conv(rows, cols, vals, x, combiner)
    max_deg = int(np.bincount(rows).max())
    for cap in (512, 8, 4):  # 8 and 4 are < karate max degree (17)
        pk = pad_coo(rows, cols, vals, 34, cap=cap, min_k=4)
        if cap < max_deg:
            assert pk.ov_rows.shape[0] > 0, "cap below max degree must overflow"
        ours = np.asarray(spmm_padded(pk, jnp.asarray(x), combiner))
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_spmm_padded_transpose_vjp_matches_autodiff(karate, combiner):
    """The gather-only custom VJP (transposed-kernel backward) must produce
    the same input gradients as plain autodiff through the scatter path."""
    from embiggen_tpu.ops.spmm import pad_coo, spmm_padded

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(34, 16)).astype(np.float32))
    rows, cols, vals = kernel_coo(karate, "Symmetric Normalized Laplacian")
    pk_plain = pad_coo(rows, cols, vals, 34, cap=8)  # overflow + no pk_t
    pk_vjp = pad_coo(rows, cols, vals, 34, cap=8, with_transpose=True)
    assert pk_vjp.pk_t is not None and pk_vjp.pk_t.pk_t is None

    def loss(pk, x):
        y = spmm_padded(pk, x, combiner)
        return jnp.sum(jnp.sin(y) * y)

    g_auto = jax.grad(loss, argnums=1)(pk_plain, x)
    g_vjp = jax.grad(loss, argnums=1)(pk_vjp, x)
    np.testing.assert_allclose(
        np.asarray(g_vjp), np.asarray(g_auto), rtol=1e-4, atol=1e-5
    )


def test_spmm_padded_unsorted_coo_and_empty_rows():
    """pad_coo must be robust to arbitrary COO order and rows with no edges."""
    from embiggen_tpu.ops.spmm import pad_coo, spmm_padded
    from embiggen_tpu.ops.spmm import spmm

    rng = np.random.default_rng(7)
    n, e = 50, 300
    rows = rng.integers(0, n, e)
    rows[rows == 13] = 14  # make row 13 empty
    cols = rng.integers(0, n, e)
    vals = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    expect = np.asarray(
        spmm(
            jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32),
            jnp.asarray(vals), jnp.asarray(x), n, "sum", sorted_rows=False,
        )
    )
    pk = pad_coo(rows, cols, vals, n, cap=8, min_k=4)
    got = np.asarray(spmm_padded(pk, jnp.asarray(x), "sum"))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
    assert np.allclose(got[13], 0.0)


def test_choose_k_tracks_degree_distribution():
    """The ELLPACK width is ELL_WIDTH slots, narrower only when no row is
    that long. A gathered row costs the same in the padded block as in the
    sorted segment-sum overflow on an H100, so wide uniform rows and hub
    tails both go to the overflow beyond ELL_WIDTH instead of widening K
    (the uniform-degree-20 case used to pick K=20 under the cost model this
    rule replaced)."""
    from embiggen_tpu.ops.spmm import ELL_WIDTH, _choose_k

    uniform = np.full(10_000, 20, np.int64)
    k_u = _choose_k(uniform, cap=512, min_k=4)
    assert k_u == ELL_WIDTH, k_u

    # 99% degree-4 rows, 1% degree-5000 hubs: padding everyone to a hub
    # width would cost 1000x the gathers; K must stay near the bulk.
    heavy = np.full(10_000, 4, np.int64)
    heavy[:100] = 5000
    k_h = _choose_k(heavy, cap=512, min_k=4)
    assert k_h <= 64, k_h

    narrow = np.full(10_000, 3, np.int64)
    assert _choose_k(narrow, cap=512, min_k=4) == 4
    assert _choose_k(uniform, cap=4, min_k=4) == 4
    assert _choose_k(uniform, cap=12, min_k=12) == 12
