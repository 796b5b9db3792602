"""Model registry — the capability surface of the reference's
`AbstractModel.MODELS_LIBRARY` static registry and resolution helpers
(reference `embiggen/utils/abstract_models/abstract_model.py:30,626-760`),
without the AST-metaprogramming: models register at import time via the
`@register_model` decorator.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Type

# task_name -> model_name -> library_name -> class
MODELS_LIBRARY: Dict[str, Dict[str, Dict[str, type]]] = {}

TASK_NAMES = [
    "Node Embedding",
    "Edge Prediction",
    "Edge Label Prediction",
    "Node Label Prediction",
    "Feature Preprocessor",
]


def register_model(cls):
    """Class decorator: register by (task_name, model_name, library_name)."""
    task = cls.task_name()
    model = cls.model_name()
    library = cls.library_name()
    MODELS_LIBRARY.setdefault(task, {}).setdefault(model, {})[library] = cls
    return cls


def get_model_from_library(
    model_name: str,
    task_name: Optional[str] = None,
    library_name: Optional[str] = None,
) -> type:
    """Resolve a model class by name; prefers the native 'JAX' library on
    ambiguity (the reference prefers 'Ensmallen', `abstract_model.py:674`)."""
    candidates = []
    tasks = [task_name] if task_name else list(MODELS_LIBRARY)
    for task in tasks:
        models = MODELS_LIBRARY.get(task, {})
        for m_name, libs in models.items():
            if m_name.lower() != model_name.lower():
                continue
            for lib, cls in libs.items():
                if library_name is None or lib.lower() == library_name.lower():
                    candidates.append(cls)
    if not candidates:
        available = sorted(
            {
                m
                for task in (tasks if task_name else MODELS_LIBRARY)
                for m in MODELS_LIBRARY.get(task, {})
            }
        )
        raise ValueError(
            f"Model {model_name!r} not found"
            + (f" for task {task_name!r}" if task_name else "")
            + (f" in library {library_name!r}" if library_name else "")
            + f". Available models: {available}"
        )
    for cls in candidates:
        if cls.library_name() == "JAX":
            return cls
    return candidates[0]


def find_available_models(task_name: str) -> List[type]:
    return [
        cls
        for libs in MODELS_LIBRARY.get(task_name, {}).values()
        for cls in libs.values()
    ]


def get_models_dataframe():
    """Tidy catalog of every registered model (reference
    `get_models_dataframe`, `abstract_model.py:763-836`)."""
    import pandas as pd

    def _cap(cls, name):
        try:
            return bool(getattr(cls, name)())
        except Exception:
            return None

    rows = []
    for task, models in MODELS_LIBRARY.items():
        for model, libs in models.items():
            for lib, cls in libs.items():
                rows.append(
                    {
                        "task_name": task,
                        "model_name": model,
                        "library_name": lib,
                        "requires_node_types": _cap(
                            cls, "requires_node_types"
                        ),
                        "requires_edge_types": _cap(
                            cls, "requires_edge_types"
                        ),
                        "requires_edge_weights": _cap(
                            cls, "requires_edge_weights"
                        ),
                        "can_use_node_types": _cap(
                            cls, "can_use_node_types"
                        ),
                        "can_use_edge_types": _cap(
                            cls, "can_use_edge_types"
                        ),
                        "can_use_edge_weights": _cap(
                            cls, "can_use_edge_weights"
                        ),
                        "is_stochastic": _cap(cls, "is_stochastic"),
                    }
                )
    return pd.DataFrame(rows)


def get_available_models_for_node_embedding():
    return find_available_models("Node Embedding")


def get_available_models_for_edge_prediction():
    return find_available_models("Edge Prediction")


def get_available_models_for_edge_label_prediction():
    return find_available_models("Edge Label Prediction")


def get_available_models_for_node_label_prediction():
    return find_available_models("Node Label Prediction")
