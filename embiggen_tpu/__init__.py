"""embiggen_tpu — a JAX graph representation-learning framework.

Brand-new JAX/XLA/Pallas implementation of the capability surface of Embiggen
(the graph-ML half of GRAPE): node embedding, edge prediction, edge-label
prediction and node-label prediction, with on-device random-walk and
negative-sampling kernels, SpMM/SDDMM graph convolutions, and multi-chip
scaling via `jax.sharding` meshes. See SURVEY.md for the blueprint.
"""
__version__ = "0.1.0"

from . import graph
from .graph import Graph
from . import models
from . import transformers
from .pipelines import (
    classification_evaluation_pipeline,
    edge_label_prediction_evaluation,
    edge_prediction_evaluation,
    embed_graph,
    node_label_prediction_evaluation,
)

__all__ = [
    "graph", "Graph", "models", "transformers",
    "embed_graph", "classification_evaluation_pipeline",
    "edge_prediction_evaluation", "edge_label_prediction_evaluation",
    "node_label_prediction_evaluation",
    "__version__",
]
