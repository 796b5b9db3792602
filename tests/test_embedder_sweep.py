"""Registry-driven sweep: EVERY registered embedder trains end-to-end at
smoke scale on a real small graph — the reference's dominant test pattern
(`tests/test_node_embedding_pipelines.py:17-42`)."""
import dataclasses

import numpy as np
import pytest

from embiggen_tpu import embed_graph
from embiggen_tpu.graph import karate_club
from embiggen_tpu.models.registry import MODELS_LIBRARY


def _typed_weighted_karate():
    g = karate_club()
    rng = np.random.default_rng(0)
    labels = g.get_single_label_node_type_ids()
    etypes = (labels[g.sources] != labels[g.col_idx]).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, g.number_of_directed_edges).astype(
        np.float32
    )
    # weights must be symmetric for an undirected graph
    eid = g.get_edge_ids(g.col_idx, g.sources)
    weights = (weights + weights[eid]) / 2
    return dataclasses.replace(g, edge_types=etypes, weights=weights)


GRAPH = _typed_weighted_karate()
# Stub models (e.g. "Non Existent Model") have no JAX implementation; the
# stub machinery has its own tests in test_registry_parity.py.
EMBEDDERS = sorted(
    name
    for name, libs in MODELS_LIBRARY["Node Embedding"].items()
    if "JAX" in libs
)


@pytest.mark.parametrize("model_name", EMBEDDERS)
def test_embedder_smoke(model_name):
    kwargs = {}
    cls = MODELS_LIBRARY["Node Embedding"][model_name]["JAX"]
    if cls.is_stochastic():
        kwargs["random_state"] = 11
    if "Score-based" in model_name:
        kwargs["scores"] = GRAPH.degrees.astype(float)
    result = embed_graph(GRAPH, model_name, smoke_test=True, **kwargs)
    embeddings = (
        result.node_embeddings
        + result.edge_type_embeddings
        + result.node_type_embeddings
        + result.edge_embeddings  # HyperSketching emits edge features
    )
    assert embeddings, model_name
    for emb in result.node_embeddings:
        assert np.asarray(emb).shape[0] == GRAPH.number_of_nodes
        assert np.isfinite(np.asarray(emb, dtype=np.float64)).all()


def test_model_recreation_sweep():
    """Rebuild each model from parameters() and compare consistent_hash
    (reference `test_model_recreation`)."""
    for model_name in EMBEDDERS:
        cls = MODELS_LIBRARY["Node Embedding"][model_name]["JAX"]
        kwargs = {"random_state": 11} if cls.is_stochastic() else {}
        model = cls.into_smoke_test(**kwargs)
        params = model.parameters()
        clone = type(model)(**params)
        assert clone.consistent_hash() == model.consistent_hash(), model_name
