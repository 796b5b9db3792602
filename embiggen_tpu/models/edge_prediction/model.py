"""AbstractEdgePredictionModel — task machinery mirroring reference
`embiggen/edge_prediction/edge_prediction_model.py`: evaluation schemas
(Connected Monte Carlo / Monte Carlo / Kfold, `:36-117`), negative evaluation
graphs with scale-free destinations by default (`:119-187`), per-unbalance
train/test evaluation rows (`:231-364`), and bipartite/clique batch
prediction helpers (`:457-1875`).
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...graph.graph import Graph
from ...graph.holdouts import (
    connected_holdout,
    edge_prediction_kfold,
    random_holdout,
)
from ...graph.sampling import sample_negative_graph
from ..classifier import AbstractClassifierModel


class AbstractEdgePredictionModel(AbstractClassifierModel):
    """Binary link prediction."""

    @classmethod
    def task_name(cls) -> str:
        return "Edge Prediction"

    def is_binary_prediction_task(self) -> bool:
        return True

    # ------------------------------------------------------------- schemas
    @classmethod
    def get_available_evaluation_schemas(cls) -> List[str]:
        return ["Connected Monte Carlo", "Monte Carlo", "Kfold"]

    @classmethod
    def split_graph_following_evaluation_schema(
        cls,
        graph: Graph,
        evaluation_schema: str,
        holdout_number: int,
        random_state: int = 42,
        holdouts_kwargs: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Graph, Graph]:
        kwargs = dict(holdouts_kwargs or {})
        seed = random_state + holdout_number
        schema = evaluation_schema.lower()
        if schema == "connected monte carlo":
            return connected_holdout(
                graph, random_state=seed,
                train_size=kwargs.get("train_size", 0.8),
            )
        if schema == "monte carlo":
            return random_holdout(
                graph, random_state=seed,
                train_size=kwargs.get("train_size", 0.8),
            )
        if schema == "kfold":
            return edge_prediction_kfold(
                graph, k=kwargs.get("k", 10),
                holdout_number=holdout_number, random_state=random_state,
            )
        raise ValueError(
            f"Unknown evaluation schema {evaluation_schema!r}; available: "
            f"{cls.get_available_evaluation_schemas()}"
        )

    # ------------------------------------------------------------ evaluation
    def _evaluate(
        self,
        graph: Graph,
        train: Graph,
        test: Graph,
        support: Optional[Graph] = None,
        unbalance_rates: Sequence[float] = (1.0,),
        use_scale_free_distribution: bool = True,
        random_state: int = 42,
        subgraph_of_interest: Optional[Graph] = None,
        **kwargs,
    ) -> List[Dict[str, Any]]:
        """Rows = {train, test} × unbalance rates with the full binary panel
        (reference `edge_prediction_model.py:231-364`).

        With `subgraph_of_interest` (already in `graph`'s node-id space),
        evaluation negatives are drawn from the SUBGRAPH's node/degree
        distribution while still avoiding every edge of the full graph —
        reference `edge_prediction_model.py:138-141` (sampler_graph)."""
        if not use_scale_free_distribution:
            warnings.warn(
                "Using uniform negative sampling for evaluation; the model "
                "was likely trained with scale-free negatives — metrics will "
                "look optimistic (reference warning, "
                "edge_prediction_model.py:143-153)."
            )
        import time as _time

        support = support or train
        rows = []
        t0 = _time.perf_counter()
        train_scores = self.predict_proba(train, support=support)
        predict_pos_s = {"train": _time.perf_counter() - t0}
        t0 = _time.perf_counter()
        test_scores = self.predict_proba(test, support=support)
        predict_pos_s["test"] = _time.perf_counter() - t0
        for unbalance in unbalance_rates:
            for split, pos_scores, pos_graph, seed_off in (
                ("train", train_scores, train, 0),
                ("test", test_scores, test, 1),
            ):
                n_neg = max(1, int(round(pos_graph.number_of_edges * unbalance)))
                t0 = _time.perf_counter()
                neg = sample_negative_graph(
                    subgraph_of_interest
                    if subgraph_of_interest is not None else graph,
                    number_of_negative_samples=n_neg,
                    random_state=random_state + seed_off,
                    use_scale_free_distribution=use_scale_free_distribution,
                    support=graph,
                )
                neg_sample_s = _time.perf_counter() - t0
                t0 = _time.perf_counter()
                neg_scores = self.predict_proba(neg, support=support)
                predict_neg_s = _time.perf_counter() - t0
                labels = np.concatenate(
                    [np.ones(len(pos_scores)), np.zeros(len(neg_scores))]
                )
                scores = np.concatenate([pos_scores, neg_scores])
                t0 = _time.perf_counter()
                metrics = self.evaluate_prediction_probabilities(labels, scores)
                metrics_s = _time.perf_counter() - t0
                metrics.update(
                    {
                        "evaluation_mode": split,
                        "unbalance_rate": unbalance,
                        "size_of_positive_set": len(pos_scores),
                        "size_of_negative_set": len(neg_scores),
                        # Per-phase decomposition of the evaluation wall
                        # time (reference per-phase timing discipline,
                        # `abstract_classifier_model.py:2904-2915`).
                        "predict_positive_seconds": predict_pos_s[split],
                        "negative_sampling_seconds": neg_sample_s,
                        "predict_negative_seconds": predict_neg_s,
                        "metrics_seconds": metrics_s,
                    }
                )
                rows.append(metrics)
        return rows

    # ----------------------------------------------- candidate-set prediction
    #
    # The full 16-method bipartite/clique surface of the reference
    # (`edge_prediction_model.py:457-1875`): {predict, predict_proba} ×
    # {bipartite, clique} × {ids, names, prefixes, node types}. All routes
    # score the |S|×|D| candidate product in fixed-size chunks — each chunk's
    # (src, dst) index arrays are synthesized from the flat pair index, so
    # the product is never materialized on the host.
    # The reference uses prediction_batch_size=2**15 sized for host numpy
    # pipelines; here each chunk is one jitted dispatch with a fixed
    # overhead, and a [2^20] pair batch is still small on the device —
    # 32x fewer dispatches than 2^15.
    PREDICTION_CHUNK_SIZE = 1 << 20

    def _score_pair_product(
        self,
        source_node_ids: np.ndarray,
        destination_node_ids: np.ndarray,
    ) -> np.ndarray:
        """[|S|, |D|] probabilities, computed in bounded-memory chunks of
        `PREDICTION_CHUNK_SIZE` pairs (padded to a single static shape so
        jitted scorers compile once)."""
        src_ids = np.asarray(source_node_ids, dtype=np.int64).reshape(-1)
        dst_ids = np.asarray(destination_node_ids, dtype=np.int64).reshape(-1)
        s, d = len(src_ids), len(dst_ids)
        total = s * d
        chunk = int(self.PREDICTION_CHUNK_SIZE)
        out = np.empty(total, dtype=np.float32)
        for start in range(0, total, chunk):
            stop = min(start + chunk, total)
            flat = np.arange(start, stop, dtype=np.int64)
            src = src_ids[flat // d]
            dst = dst_ids[flat % d]
            if stop - start < chunk and total > chunk:
                # pad to the compiled chunk shape; padded scores discarded
                pad = chunk - (stop - start)
                src = np.concatenate([src, np.repeat(src[-1:], pad)])
                dst = np.concatenate([dst, np.repeat(dst[-1:], pad)])
            scores = np.asarray(
                self.predict_proba_from_edge_node_ids(
                    src.astype(np.int32), dst.astype(np.int32)
                )
            ).reshape(-1)
            out[start:stop] = scores[: stop - start]
        return out.reshape(s, d)

    @staticmethod
    def _as_dataframe(matrix, graph, src_ids, dst_ids, return_node_names):
        import pandas as pd

        if return_node_names:
            names = graph.get_node_names()
            index = names[np.asarray(src_ids, dtype=np.int64)]
            columns = names[np.asarray(dst_ids, dtype=np.int64)]
        else:
            index, columns = src_ids, dst_ids
        return pd.DataFrame(matrix, index=index, columns=columns)

    # --- proba × bipartite
    def predict_proba_bipartite_graph_from_edge_node_ids(
        self,
        source_node_ids: np.ndarray,
        destination_node_ids: np.ndarray,
        support: Optional[Graph] = None,
        graph: Optional[Graph] = None,
        return_predictions_dataframe: bool = False,
        return_node_names: bool = True,
    ):
        """[|S|, |D|] probabilities for the full bipartite candidate set
        (reference `edge_prediction_model.py:1226`)."""
        matrix = self._score_pair_product(
            source_node_ids, destination_node_ids
        )
        if return_predictions_dataframe:
            if graph is None:
                raise ValueError(
                    "return_predictions_dataframe requires the graph to "
                    "resolve node names."
                )
            return self._as_dataframe(
                matrix, graph, source_node_ids, destination_node_ids,
                return_node_names,
            )
        return matrix

    def predict_proba_bipartite_graph_from_edge_node_names(
        self, graph: Graph, source_node_names, destination_node_names,
        **kwargs,
    ):
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            graph.get_node_ids_from_names(source_node_names),
            graph.get_node_ids_from_names(destination_node_names),
            graph=graph, **kwargs,
        )

    def predict_proba_bipartite_graph_from_edge_node_prefixes(
        self, graph: Graph, source_node_prefixes, destination_node_prefixes,
        **kwargs,
    ):
        """Candidate set = nodes whose names match the given prefixes
        (reference `edge_prediction_model.py:1394`)."""
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            graph.get_node_ids_from_prefixes(source_node_prefixes),
            graph.get_node_ids_from_prefixes(destination_node_prefixes),
            graph=graph, **kwargs,
        )

    def predict_proba_bipartite_graph_from_edge_node_types(
        self, graph: Graph, source_node_types, destination_node_types,
        **kwargs,
    ):
        """Candidate set = nodes having the given node types (reference
        `edge_prediction_model.py:1478`)."""
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            graph.get_node_ids_from_node_type_names(source_node_types),
            graph.get_node_ids_from_node_type_names(destination_node_types),
            graph=graph, **kwargs,
        )

    # --- proba × clique
    def predict_proba_clique_graph_from_node_ids(
        self, node_ids: np.ndarray, **kwargs
    ):
        """[k, k] probabilities over the clique of the given nodes (reference
        `edge_prediction_model.py:1562`)."""
        return self.predict_proba_bipartite_graph_from_edge_node_ids(
            node_ids, node_ids, **kwargs
        )

    def predict_proba_clique_graph_from_node_names(
        self, graph: Graph, node_names, **kwargs
    ):
        ids = graph.get_node_ids_from_names(node_names)
        return self.predict_proba_clique_graph_from_node_ids(
            ids, graph=graph, **kwargs
        )

    def predict_proba_clique_graph_from_node_prefixes(
        self, graph: Graph, node_prefixes, **kwargs
    ):
        ids = graph.get_node_ids_from_prefixes(node_prefixes)
        return self.predict_proba_clique_graph_from_node_ids(
            ids, graph=graph, **kwargs
        )

    def predict_proba_clique_graph_from_node_type_names(
        self, graph: Graph, node_type_names, **kwargs
    ):
        ids = graph.get_node_ids_from_node_type_names(node_type_names)
        return self.predict_proba_clique_graph_from_node_ids(
            ids, graph=graph, **kwargs
        )

    # --- hard-label variants (reference `edge_prediction_model.py:457-1017`)
    def _hard(self, result):
        if hasattr(result, "loc"):  # DataFrame
            return result > 0.5
        return result > 0.5

    def predict_bipartite_graph_from_edge_node_ids(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_bipartite_graph_from_edge_node_ids(
                *args, **kwargs
            )
        )

    def predict_bipartite_graph_from_edge_node_names(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_bipartite_graph_from_edge_node_names(
                *args, **kwargs
            )
        )

    def predict_bipartite_graph_from_edge_node_prefixes(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_bipartite_graph_from_edge_node_prefixes(
                *args, **kwargs
            )
        )

    def predict_bipartite_graph_from_edge_node_types(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_bipartite_graph_from_edge_node_types(
                *args, **kwargs
            )
        )

    def predict_clique_graph_from_node_ids(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_clique_graph_from_node_ids(*args, **kwargs)
        )

    def predict_clique_graph_from_node_names(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_clique_graph_from_node_names(*args, **kwargs)
        )

    def predict_clique_graph_from_node_prefixes(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_clique_graph_from_node_prefixes(*args, **kwargs)
        )

    def predict_clique_graph_from_node_type_names(self, *args, **kwargs):
        return self._hard(
            self.predict_proba_clique_graph_from_node_type_names(
                *args, **kwargs
            )
        )

    def predict_proba_from_edge_node_ids(
        self, src: np.ndarray, dst: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement arbitrary-pair "
            "prediction."
        )
