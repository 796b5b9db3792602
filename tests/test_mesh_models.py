"""Multi-chip training through the PRODUCTION model API (VERDICT r2 item 1):
`SkipGram(mesh=...)`, `CBOW(mesh=...)`, `KipfGCNNodeLabelPrediction(mesh=...)`
and `KipfGCNEdgePrediction(mesh=...)` on the 8-device CPU mesh produce
results equal (seeded) to single-device runs — bitwise for row-sharded
tables, float-reduction tolerance for the data-parallel and halo paths.
The reference's counterpart is the `use_mirrored_strategy` model flag
(`tensorflow_embedders/tensorflow_embedder.py:73-79,234-240`)."""
import numpy as np
import pytest

from embiggen_tpu.graph import karate_club
from embiggen_tpu.graph.generators import planted_partition

EMB_KWARGS = dict(
    embedding_size=8, epochs=2, batch_size=16, walk_length=8,
    window_size=2, number_of_negative_samples=4, random_state=7,
)


def _emb(model_cls, **extra):
    g = karate_club()
    res = model_cls(**EMB_KWARGS, **extra).fit_transform(g)
    return np.asarray(res.node_embeddings[0])


@pytest.mark.parametrize("model_name", ["SkipGram", "CBOW"])
def test_walk_embedder_dp_matches_single_device(model_name):
    from embiggen_tpu.models import embedders

    cls = getattr(embedders, model_name)
    ref = _emb(cls)
    dp = _emb(cls, mesh=8, distribution="data")
    np.testing.assert_allclose(dp, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("model_name", ["SkipGram", "CBOW"])
def test_walk_embedder_row_sharded_matches_single_device(model_name):
    from embiggen_tpu.models import embedders

    cls = getattr(embedders, model_name)
    ref = _emb(cls)
    rows = _emb(cls, mesh=8, distribution="rows")
    # Replicated sampling + exact psum-gather/owned-scatter algebra:
    # bit-identical on the CPU mesh.
    np.testing.assert_allclose(rows, ref, rtol=1e-6, atol=1e-7)


def test_second_order_dp_and_auto_mesh():
    """p/q walks through the DP path + mesh='auto' resolution."""
    from embiggen_tpu.models.embedders import SkipGram

    g = karate_club()
    kwargs = {**EMB_KWARGS, "return_weight": 2.0, "explore_weight": 0.5}
    ref = SkipGram(**kwargs).fit_transform(g).node_embeddings[0]
    dp = SkipGram(**kwargs, mesh="auto").fit_transform(g).node_embeddings[0]
    np.testing.assert_allclose(
        np.asarray(dp), np.asarray(ref), rtol=2e-5, atol=2e-6
    )


def test_unsupported_model_falls_back_with_warning():
    """A model that opts out of the distributed hooks still trains (single
    chip) with a warning. Every REGISTERED minibatch/walk embedder now
    supports `mesh=` (VERDICT r3 item 1), so the fallback is exercised via
    a minimal subclass."""
    from embiggen_tpu.models.embedders import SkipGram

    class NoMeshSkipGram(SkipGram):
        @classmethod
        def supports_distribution(cls):
            return False

    g = karate_club()
    with pytest.warns(UserWarning, match="falling back to single-device"):
        res = NoMeshSkipGram(**EMB_KWARGS, mesh=8).fit_transform(g)
    assert np.isfinite(np.asarray(res.node_embeddings[0])).all()


def test_every_registered_sgd_embedder_supports_mesh():
    """The fallback list is now exactly the non-SGD families: every
    registered embedder exposing the `mesh` flag supports distribution
    (the reference exposes distribution at the embedder base class,
    `tensorflow_embedder.py:73-79`)."""
    import inspect

    from embiggen_tpu.models.registry import MODELS_LIBRARY

    for name, libs in MODELS_LIBRARY["Node Embedding"].items():
        cls = libs.get("JAX")
        if cls is None:
            continue
        sig = inspect.signature(cls.__init__)
        takes_mesh = "mesh" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        ) and hasattr(cls, "supports_distribution")
        if hasattr(cls, "supports_distribution") and takes_mesh:
            assert cls.supports_distribution(), name


@pytest.fixture(scope="module")
def typed_karate():
    import dataclasses

    g = karate_club()
    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    return dataclasses.replace(g, edge_types=etypes)


@pytest.mark.parametrize(
    "model_name,kwargs",
    [
        ("FirstOrderLINE", {}),
        ("SecondOrderLINE", {}),
        ("TransE", {}),
        ("RotatE", {}),
        ("NodePiece", {"number_of_anchors": 8, "tokens_per_node": 2}),
    ],
)
def test_minibatch_embedder_dp_matches_single_device(
    typed_karate, model_name, kwargs
):
    """VERDICT r3 item 1: LINE / siamese / KGE families take `mesh=` and
    reproduce the single-chip result (replicated sampling, sharded math)."""
    from embiggen_tpu.models import embedders

    cls = getattr(embedders, model_name)
    kw = dict(
        embedding_size=8, epochs=2, batch_size=64, random_state=7, **kwargs
    )
    ref = np.asarray(
        cls(**kw).fit_transform(typed_karate).node_embeddings[0]
    )
    dp = np.asarray(
        cls(**kw, mesh=8).fit_transform(typed_karate).node_embeddings[0]
    )
    np.testing.assert_allclose(dp, ref, rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("model_name", ["WalkletsSkipGram", "WalkletsCBOW"])
def test_walklets_dp_matches_single_device(model_name):
    from embiggen_tpu.models import embedders

    cls = getattr(embedders, model_name)
    kw = dict(
        embedding_size=8, power=2, epochs=2, batch_size=16, walk_length=8,
        window_size=2, number_of_negative_samples=4, random_state=7,
    )
    g = karate_club()
    ref = np.asarray(cls(**kw).fit_transform(g).node_embeddings[0])
    dp = np.asarray(
        cls(**kw, mesh=8, distribution="data")
        .fit_transform(g).node_embeddings[0]
    )
    np.testing.assert_allclose(dp, ref, rtol=2e-4, atol=2e-6)


def test_glove_dp_matches_single_device():
    from embiggen_tpu.models.embedders import GloVe, WalkletsGloVe

    g = karate_club()
    kw = dict(
        embedding_size=8, epochs=2, walk_length=8, window_size=2,
        iterations=1, batch_size=64, random_state=7,
    )
    ref = np.asarray(GloVe(**kw).fit_transform(g).node_embeddings[0])
    dp = np.asarray(
        GloVe(**kw, mesh=8).fit_transform(g).node_embeddings[0]
    )
    np.testing.assert_allclose(dp, ref, rtol=2e-4, atol=2e-6)

    kw_w = dict(
        embedding_size=8, power=2, epochs=2, walk_length=8, window_size=2,
        batch_size=16, random_state=7,
    )
    ref_w = np.asarray(
        WalkletsGloVe(**kw_w).fit_transform(g).node_embeddings[0]
    )
    dp_w = np.asarray(
        WalkletsGloVe(**kw_w, mesh=8).fit_transform(g).node_embeddings[0]
    )
    np.testing.assert_allclose(dp_w, ref_w, rtol=2e-4, atol=2e-6)


@pytest.fixture(scope="module")
def sbm():
    return planted_partition(
        n_nodes=200, n_communities=3, p_in=0.12, p_out=0.01, seed=1
    )


def test_gcn_node_label_mesh_matches_single_device(sbm):
    from embiggen_tpu.models.gcn.node_label import KipfGCNNodeLabelPrediction

    kw = dict(
        units=[16, 16], head_units=[8], epochs=5, random_state=0,
        dropout_rate=0.0,
    )
    m1 = KipfGCNNodeLabelPrediction(**kw)
    m1.fit(sbm)
    m2 = KipfGCNNodeLabelPrediction(**kw, mesh=8)
    m2.fit(sbm)
    np.testing.assert_allclose(
        m2.predict_proba(sbm), m1.predict_proba(sbm), rtol=1e-4, atol=1e-5
    )


def test_gcn_edge_prediction_mesh_matches_single_device(sbm):
    from embiggen_tpu.models.gcn.edge import KipfGCNEdgePrediction

    kw = dict(
        units=[16], tower_units=[8], head_units=[8], epochs=3,
        batch_size=64, random_state=0, dropout_rate=0.0,
    )
    m1 = KipfGCNEdgePrediction(**kw)
    m1.fit(sbm)
    m2 = KipfGCNEdgePrediction(**kw, mesh=8)
    m2.fit(sbm)
    np.testing.assert_allclose(
        m2.predict_proba(sbm), m1.predict_proba(sbm), rtol=1e-4, atol=1e-5
    )


def test_gcn_mesh_with_dropout_trains(sbm):
    """Dropout-on sharded fit runs and improves the loss."""
    from embiggen_tpu.models.gcn.node_label import KipfGCNNodeLabelPrediction

    m = KipfGCNNodeLabelPrediction(
        units=[16, 16], head_units=[8], epochs=10, random_state=0, mesh=8
    )
    m.fit(sbm)
    assert np.isfinite(m._history).all()
    assert m._history[-1] < m._history[0]


def test_resolve_mesh_contract():
    import jax

    from embiggen_tpu.parallel import make_mesh, resolve_mesh

    assert resolve_mesh(None) is None
    assert resolve_mesh(1) is None
    m = resolve_mesh("auto")
    assert m is not None and m.devices.size == len(jax.devices())
    m4 = resolve_mesh(4)
    assert m4.devices.size == 4
    assert resolve_mesh(m4) is m4
    with pytest.raises(ValueError):
        resolve_mesh(10_000)
    with pytest.raises(TypeError):
        resolve_mesh(3.5)


@pytest.mark.parametrize(
    "model_name", ["FirstOrderLINE", "SecondOrderLINE", "TransE", "RotatE"]
)
def test_minibatch_embedder_rows_matches_single_device(
    typed_karate, model_name
):
    """distribution='rows' (out-of-core row-sharded entity tables — the
    analogue of the reference's mmap embedding paths,
    `ensmallen_embedders/transe.py:20-21`) reproduces the single-chip
    result for the minibatch families too."""
    from embiggen_tpu.models import embedders

    cls = getattr(embedders, model_name)
    kw = dict(embedding_size=8, epochs=2, batch_size=64, random_state=7)
    ref = np.asarray(
        cls(**kw).fit_transform(typed_karate).node_embeddings[0]
    )
    rows = np.asarray(
        cls(**kw, mesh=8, distribution="rows")
        .fit_transform(typed_karate).node_embeddings[0]
    )
    np.testing.assert_allclose(rows, ref, rtol=1e-5, atol=1e-7)


def test_glove_rows_matches_single_device():
    from embiggen_tpu.models.embedders import GloVe

    g = karate_club()
    kw = dict(
        embedding_size=8, epochs=2, walk_length=8, window_size=2,
        iterations=1, batch_size=64, random_state=7,
    )
    ref = np.asarray(GloVe(**kw).fit_transform(g).node_embeddings[0])
    rows = np.asarray(
        GloVe(**kw, mesh=8, distribution="rows")
        .fit_transform(g).node_embeddings[0]
    )
    np.testing.assert_allclose(rows, ref, rtol=1e-5, atol=1e-7)


def test_nodepiece_rows_falls_back_to_data():
    """NodePiece stores no [N] tables (that's its point); asking for rows
    warns and data-parallelizes instead."""
    from embiggen_tpu.models.embedders import NodePiece

    g = karate_club()
    import dataclasses

    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    gt = dataclasses.replace(g, edge_types=etypes)
    with pytest.warns(UserWarning, match="no node-row tables"):
        res = NodePiece(
            embedding_size=8, epochs=1, batch_size=32, random_state=0,
            number_of_anchors=8, tokens_per_node=2,
            mesh=8, distribution="rows",
        ).fit_transform(gt)
    assert np.isfinite(np.asarray(res.node_embeddings[0])).all()
