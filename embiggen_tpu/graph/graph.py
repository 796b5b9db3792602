"""Immutable CSR graph container — the JAX counterpart of the ensmallen
Graph object (reference usage census: SURVEY.md §2.9; e.g. reference
`embiggen/utils/abstract_gcn.py:136-147`, `graph_embedding_pipeline.py:92`).

Design: host-side storage is vectorized numpy (build/query/holdouts run on host);
`Graph.device()` exports a `DeviceGraph` pytree of jnp arrays that the Pallas/XLA
sampling and SpMM kernels consume. All shapes are static per graph instance, which
is what XLA tracing requires.

Undirected graphs store both arcs (symmetrized CSR), mirroring the reference
engine's adjacency semantics: `number_of_directed_edges` counts arcs, while
`number_of_edges` counts undirected edges when `directed=False`.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _as_names(names: Optional[Sequence[str]], count: int, prefix: str) -> np.ndarray:
    if names is None:
        return np.asarray([f"{prefix}{i}" for i in range(count)], dtype=object)
    arr = np.asarray(names, dtype=object)
    if arr.shape[0] != count:
        raise ValueError(f"Expected {count} {prefix} names, got {arr.shape[0]}")
    return arr


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """JAX pytree view of a Graph's CSR arrays, ready for on-device kernels."""

    row_ptr: "jax.Array"            # [N+1] int32
    col_idx: "jax.Array"            # [E] int32 (sorted within each row)
    degrees: "jax.Array"            # [N] int32
    weights: Optional["jax.Array"]  # [E] f32 or None
    edge_types: Optional["jax.Array"]  # [E] int32 or None
    # Alias tables for O(1) weighted neighbour sampling, aligned with col_idx.
    alias_prob: Optional["jax.Array"]  # [E] f32
    alias_idx: Optional["jax.Array"]   # [E] int32 (intra-row offsets)
    n_nodes: int
    n_arcs: int
    max_degree: int = 0
    # Capped ELLPACK adjacency for the row-gather p/q walk kernel: row i holds
    # the first min(deg(i), ell_cap) neighbour ids (-1 padding). One 4*cap-byte
    # row gather replaces ~50 element gathers per second-order step (see
    # ops/walks.py::_second_order_step_ell).
    ell_cols: Optional["jax.Array"] = None  # [N, ell_cap] int32, -1 padded
    ell_w: Optional["jax.Array"] = None     # [N, ell_cap] f32 edge weights
    ell_cap: int = 0
    # Per-arc source node ([E] int32, `device(with_sources=True)`): turns
    # arc→source recovery into ONE element gather instead of a 20-round
    # searchsorted over row_ptr (the positive-arc sampler's hot path).
    sources: Optional["jax.Array"] = None
    # Typed-walk exports (`device(with_walk_types=True)`): primary node type
    # per node plus per-ELL-slot candidate node / edge types, so the typed
    # transition factors (`change_node_type_weight` / `change_edge_type_weight`,
    # reference `abstract_random_walked_based_embedder_model.py:8-158`) cost
    # row gathers, not per-candidate element gathers.
    node_type_of: Optional["jax.Array"] = None  # [N] int32, -1 unknown
    ell_ntypes: Optional["jax.Array"] = None    # [N, ell_cap] int32
    ell_etypes: Optional["jax.Array"] = None    # [N, ell_cap] int32

    def tree_flatten(self):
        children = (self.row_ptr, self.col_idx, self.degrees, self.weights,
                    self.edge_types, self.alias_prob, self.alias_idx,
                    self.ell_cols, self.ell_w, self.sources,
                    self.node_type_of, self.ell_ntypes, self.ell_etypes)
        aux = (self.n_nodes, self.n_arcs, self.max_degree, self.ell_cap)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        (row_ptr, col_idx, degrees, weights, edge_types, alias_prob,
         alias_idx, ell_cols, ell_w, sources,
         node_type_of, ell_ntypes, ell_etypes) = children
        n_nodes, n_arcs, max_degree, ell_cap = aux
        return cls(row_ptr, col_idx, degrees, weights, edge_types,
                   alias_prob, alias_idx, n_nodes, n_arcs, max_degree,
                   ell_cols, ell_w, ell_cap, sources,
                   node_type_of, ell_ntypes, ell_etypes)


def _register_device_graph():
    import jax
    try:
        jax.tree_util.register_pytree_node(
            DeviceGraph, DeviceGraph.tree_flatten, DeviceGraph.tree_unflatten
        )
    except ValueError:
        pass  # already registered (module reloaded)


_register_device_graph()


def build_alias_tables(
    row_ptr: np.ndarray, weights: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized Walker alias-table construction for every node's neighbour
    distribution at once. Returns (prob, alias) aligned with col_idx; alias holds
    intra-row neighbour offsets.

    Replaces the per-walk weighted sampling done inside the reference engine's
    Rust walk kernel (reference `embiggen/sequences/node2vec_sequence.py:190-203`
    delegates to `graph.node2vec`).
    """
    from .. import native

    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    got = native.alias_tables(row_ptr, weights)
    if got is not None:
        return got

    # Pure-numpy fallback: uniform rows (the common case) resolve fully
    # vectorized; only rows with genuinely non-uniform weights run the
    # two-stack pairing loop.
    n_edges = weights.shape[0]
    prob = np.ones(n_edges, dtype=np.float32)
    alias = np.zeros(n_edges, dtype=np.int32)
    degrees = np.diff(row_ptr)
    row_of_edge = np.repeat(np.arange(len(degrees)), degrees)
    row_sums = np.zeros(len(degrees), dtype=np.float64)
    np.add.at(row_sums, row_of_edge, weights.astype(np.float64))
    safe = np.where(row_sums == 0, 1.0, row_sums)
    scaled = weights.astype(np.float64) * degrees[row_of_edge] / safe[row_of_edge]

    # identity alias per edge (intra-row offsets), valid for uniform rows
    row_start = row_ptr[:-1]
    alias[:] = (
        np.arange(n_edges, dtype=np.int64) - np.repeat(row_start, degrees)
    ).astype(np.int32)

    non_uniform_edges = np.abs(scaled - 1.0) > 1e-9
    rows_to_fix = np.unique(row_of_edge[non_uniform_edges])
    for r in rows_to_fix:
        s, e = row_ptr[r], row_ptr[r + 1]
        p = scaled[s:e].copy()
        d = e - s
        pr = prob[s:e]
        al = alias[s:e]
        small = [i for i in range(d) if p[i] < 1.0]
        large = [i for i in range(d) if p[i] >= 1.0]
        while small and large:
            sm = small.pop()
            lg = large.pop()
            pr[sm] = p[sm]
            al[sm] = lg
            p[lg] = p[lg] - (1.0 - p[sm])
            (small if p[lg] < 1.0 else large).append(lg)
        for i in large + small:
            pr[i] = 1.0
            al[i] = i
    return prob, alias


from .compat import ReferenceGraphAPI


@dataclasses.dataclass(frozen=True)
class Graph(ReferenceGraphAPI):
    """Immutable graph: CSR adjacency + optional weights, node/edge types and
    string vocabularies. The pythonic property API below is the primary
    surface; `ReferenceGraphAPI` adds the full reference-named method surface
    (SURVEY §2.9.1 census) as delegates."""

    row_ptr: np.ndarray                     # [N+1] int64
    col_idx: np.ndarray                     # [E] int32, sorted per row
    directed: bool = True
    name: str = "Graph"
    weights: Optional[np.ndarray] = None    # [E] f32
    edge_types: Optional[np.ndarray] = None  # [E] int32
    # Multilabel node types: CSR of type ids per node.
    node_type_ptr: Optional[np.ndarray] = None  # [N+1]
    node_type_ids: Optional[np.ndarray] = None  # [sum labels]
    node_names: Optional[np.ndarray] = None
    node_type_names: Optional[np.ndarray] = None
    edge_type_names: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ basic
    @property
    def number_of_nodes(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    @property
    def number_of_directed_edges(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def number_of_edges(self) -> int:
        if self.directed:
            return self.number_of_directed_edges
        n_self = int(np.sum(self.sources == self.col_idx))
        return (self.number_of_directed_edges - n_self) // 2 + n_self

    @cached_property
    def sources(self) -> np.ndarray:
        """[E] source node of each arc (CSR row expansion)."""
        return np.repeat(
            np.arange(self.number_of_nodes, dtype=self.col_idx.dtype), self.degrees
        )

    @cached_property
    def arcs_fingerprint(self) -> str:
        """Content hash of the adjacency structure + weights — the cache
        key for derived device layouts (e.g. the GCN kernel cache,
        `models/gcn/core.py`): two holdout/graph objects with identical
        arcs share one fingerprint, so expensive host relayouts are built
        once per SPLIT, not once per (model, split) pair (VERDICT r3
        item 3). ~0.1 s/20M arcs (sha1 over the raw arrays); computed
        lazily and cached on the immutable graph."""
        import hashlib

        h = hashlib.sha1()
        h.update(np.int64(self.number_of_nodes).tobytes())
        h.update(np.ascontiguousarray(self.row_ptr).tobytes())
        h.update(np.ascontiguousarray(self.col_idx).tobytes())
        if self.weights is not None:
            h.update(np.ascontiguousarray(self.weights).tobytes())
        return h.hexdigest()

    @property
    def destinations(self) -> np.ndarray:
        return self.col_idx

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int32)

    @property
    def has_edge_weights(self) -> bool:
        return self.weights is not None

    @property
    def has_edge_types(self) -> bool:
        return self.edge_types is not None

    @property
    def has_node_types(self) -> bool:
        return self.node_type_ids is not None

    @property
    def density(self) -> float:
        n = self.number_of_nodes
        if n < 2:
            return 0.0
        return self.number_of_directed_edges / (n * (n - 1))

    @cached_property
    def node_name_to_id(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.get_node_names())}

    def get_node_names(self) -> np.ndarray:
        return _as_names(self.node_names, self.number_of_nodes, "node_")

    def get_node_ids_from_names(self, names: Sequence[str]) -> np.ndarray:
        m = self.node_name_to_id
        return np.asarray([m[n] for n in names], dtype=np.int32)

    def get_node_ids_from_prefixes(
        self, prefixes: Sequence[str]
    ) -> np.ndarray:
        """Ids of nodes whose name starts with any prefix (reference
        `Graph.get_node_ids_from_node_curie_prefixes` surface used by the
        bipartite/clique prefix helpers, `edge_prediction_model.py:603`)."""
        if isinstance(prefixes, str):
            prefixes = [prefixes]
        names = self.get_node_names()
        mask = np.zeros(self.number_of_nodes, dtype=bool)
        for p in prefixes:
            mask |= np.char.startswith(names.astype(str), p)
        return np.nonzero(mask)[0].astype(np.int32)

    def get_node_ids_from_node_type_names(
        self, type_names: Sequence[str]
    ) -> np.ndarray:
        """Ids of nodes having at least one of the given node types
        (reference bipartite/clique node-type helpers,
        `edge_prediction_model.py:676,951`)."""
        if isinstance(type_names, str):
            type_names = [type_names]
        if self.node_type_ptr is None:
            raise ValueError(f"Graph {self.name} has no node types.")
        all_names = list(self.get_node_type_names())
        wanted = set()
        for t in type_names:
            if t not in all_names:
                raise ValueError(
                    f"Unknown node type {t!r}; available: {all_names}"
                )
            wanted.add(all_names.index(t))
        counts = np.diff(self.node_type_ptr)
        rows = np.repeat(np.arange(self.number_of_nodes), counts)
        hits = np.isin(self.node_type_ids, list(wanted))
        mask = np.zeros(self.number_of_nodes, dtype=bool)
        mask[rows[hits]] = True
        return np.nonzero(mask)[0].astype(np.int32)

    def get_edge_type_names(self) -> Optional[np.ndarray]:
        if self.edge_types is None:
            return None
        n_types = int(self.edge_types.max()) + 1 if len(self.edge_types) else 0
        return _as_names(self.edge_type_names, n_types, "edge_type_")

    def get_node_type_names(self) -> Optional[np.ndarray]:
        if self.node_type_ids is None:
            return None
        n_types = int(self.node_type_ids.max()) + 1 if len(self.node_type_ids) else 0
        return _as_names(self.node_type_names, n_types, "node_type_")

    @property
    def number_of_node_types(self) -> int:
        if self.node_type_ids is None or len(self.node_type_ids) == 0:
            return 0
        return int(self.node_type_ids.max()) + 1

    @property
    def number_of_edge_types(self) -> int:
        if self.edge_types is None or len(self.edge_types) == 0:
            return 0
        return int(self.edge_types.max()) + 1

    def has_multilabel_node_types(self) -> bool:
        if self.node_type_ptr is None:
            return False
        return bool(np.any(np.diff(self.node_type_ptr) > 1))

    def get_maximum_multilabel_count(self) -> int:
        if self.node_type_ptr is None:
            return 0
        return int(np.max(np.diff(self.node_type_ptr), initial=0))

    def get_one_hot_encoded_node_types(self) -> np.ndarray:
        """[N, n_types] float32 multi-hot node-type matrix (reference:
        `Graph.get_one_hot_encoded_node_types`)."""
        n, t = self.number_of_nodes, self.number_of_node_types
        out = np.zeros((n, t), dtype=np.float32)
        if t == 0:
            return out
        rows = np.repeat(np.arange(n), np.diff(self.node_type_ptr))
        out[rows, self.node_type_ids] = 1.0
        return out

    def get_single_label_node_type_ids(self) -> np.ndarray:
        """[N] int32 first node-type id per node (-1 if unknown)."""
        n = self.number_of_nodes
        out = np.full(n, -1, dtype=np.int32)
        if self.node_type_ptr is None:
            return out
        counts = np.diff(self.node_type_ptr)
        has = counts > 0
        out[has] = self.node_type_ids[self.node_type_ptr[:-1][has]]
        return out

    def get_known_node_types_mask(self) -> np.ndarray:
        if self.node_type_ptr is None:
            return np.zeros(self.number_of_nodes, dtype=bool)
        return np.diff(self.node_type_ptr) > 0

    def get_known_edge_types_mask(self) -> np.ndarray:
        if self.edge_types is None:
            return np.zeros(self.number_of_directed_edges, dtype=bool)
        return self.edge_types >= 0

    # ----------------------------------------------------------------- lookup
    def neighbors(self, node: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[node]: self.row_ptr[node + 1]]

    def has_edges(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Vectorized membership test: threaded open-addressing hash probes
        via the native runtime (one cache miss per query — numpy's
        searchsorted over 10M+ sorted keys is log2(E) DEPENDENT misses per
        query and measured ~14 s per 7.5M-query batch at bench scale);
        numpy searchsorted fallback when no compiler is available."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        if self.number_of_directed_edges == 0:
            return np.zeros(len(src), dtype=bool)
        q = src.astype(np.int64) * self.number_of_nodes + dst.astype(np.int64)
        table = self._arc_hash_table
        if table is not None:
            from .. import native

            got = native.arc_hash_contains(table, q.astype(np.uint64))
            if got is not None:
                return got
        keys = self._sorted_arc_keys
        idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return keys[idx] == q

    # kept as an alias: earlier call sites distinguish the two paths
    has_edges_fast = has_edges

    @cached_property
    def _arc_hash_table(self) -> Optional[np.ndarray]:
        """Lazy native hash table over the encoded arc keys (None when the
        native lib is unavailable); cached on the immutable graph."""
        from .. import native

        return native.arc_hash_build(
            self._sorted_arc_keys.astype(np.uint64)
        )

    # Derived caches are dropped from pickles (a bench-scale graph's hash
    # table + encoded keys are ~300 MB of recomputable state; models pickle
    # their support graph via utils/persistence.dump_model).
    _DERIVED_CACHES = (
        "sources", "arcs_fingerprint", "degrees", "node_name_to_id",
        "_arc_hash_table", "_sorted_arc_keys",
    )

    def __getstate__(self):
        state = dict(self.__dict__)
        for k in self._DERIVED_CACHES:
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    @cached_property
    def _sorted_arc_keys(self) -> np.ndarray:
        # CSR invariant: sources are non-decreasing and col_idx is sorted per
        # row, so the encoded keys are already sorted — no sort needed.
        return (
            self.sources.astype(np.int64) * self.number_of_nodes
            + self.col_idx.astype(np.int64)
        )

    def get_edge_ids(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Arc index for (src, dst), -1 if absent (vectorized searchsorted
        over the sorted arc keys, which index arcs in CSR order)."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        keys = self._sorted_arc_keys
        if len(keys) == 0:
            return np.full(len(src), -1, dtype=np.int64)
        q = src.astype(np.int64) * self.number_of_nodes + dst.astype(np.int64)
        idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return np.where(keys[idx] == q, idx, -1)

    # ------------------------------------------------------------- transforms
    def sort_by_decreasing_outbound_node_degree(self) -> "Graph":
        """Relabel nodes so ids are ordered by decreasing out-degree — required
        by NCE/sampled-softmax models whose log-uniform negative sampler assumes
        a scale-free id ordering (reference
        `embiggen/embedders/tensorflow_embedders/node2vec.py:204`,
        `graph_embedding_pipeline.py:92`)."""
        order = np.argsort(-self.degrees, kind="stable")
        return self.relabel(order)

    def is_sorted_by_decreasing_outbound_node_degree(self) -> bool:
        d = self.degrees
        return bool(np.all(d[:-1] >= d[1:]))

    def relabel(self, order: np.ndarray) -> "Graph":
        """Return graph with node i renamed to position of i in `order`."""
        inverse = np.empty_like(order)
        inverse[order] = np.arange(len(order))
        new_src = inverse[self.sources]
        new_dst = inverse[self.col_idx]
        return Graph.from_edge_arrays(
            new_src,
            new_dst,
            n_nodes=self.number_of_nodes,
            weights=self.weights,
            edge_types=self.edge_types,
            directed=True,  # arcs already symmetrized if undirected
            directed_flag=self.directed,
            name=self.name,
            # Materialize names even when auto-generated so node identity
            # survives the relabelling.
            node_names=self.get_node_names()[order],
            node_type_ptr=(
                None
                if self.node_type_ptr is None
                else np.concatenate(
                    [[0], np.cumsum(np.diff(self.node_type_ptr)[order])]
                ).astype(self.node_type_ptr.dtype)
            ),
            node_type_ids=(
                None
                if self.node_type_ids is None
                else np.concatenate(
                    [
                        self.node_type_ids[
                            self.node_type_ptr[o]: self.node_type_ptr[o + 1]
                        ]
                        for o in order
                    ]
                ).astype(self.node_type_ids.dtype)
                if len(self.node_type_ids)
                else self.node_type_ids
            ),
            node_type_names=self.node_type_names,
            edge_type_names=self.edge_type_names,
        )

    def filter_edges(self, keep_mask: np.ndarray, name: Optional[str] = None) -> "Graph":
        """Subgraph with the same node set and only arcs where keep_mask."""
        return Graph.from_edge_arrays(
            self.sources[keep_mask],
            self.col_idx[keep_mask],
            n_nodes=self.number_of_nodes,
            weights=None if self.weights is None else self.weights[keep_mask],
            edge_types=None if self.edge_types is None else self.edge_types[keep_mask],
            directed=True,
            directed_flag=self.directed,
            name=name or self.name,
            node_names=self.node_names,
            node_type_ptr=self.node_type_ptr,
            node_type_ids=self.node_type_ids,
            node_type_names=self.node_type_names,
            edge_type_names=self.edge_type_names,
        )

    def intersection(self, other: "Graph") -> "Graph":
        """Edge-set intersection (reference `graph & subgraph`,
        `abstract_classifier_model.py:2516-2535`). Node sets must match."""
        mask = other.has_edges_fast(self.sources, self.col_idx)
        return self.filter_edges(mask, name=f"{self.name}&{other.name}")

    def __and__(self, other: "Graph") -> "Graph":
        return self.intersection(other)

    def difference(self, other: "Graph") -> "Graph":
        mask = ~other.has_edges_fast(self.sources, self.col_idx)
        return self.filter_edges(mask, name=f"{self.name}-{other.name}")

    def remove_selfloops(self) -> "Graph":
        return self.filter_edges(self.sources != self.col_idx)

    def set_name(self, name: str) -> "Graph":
        return dataclasses.replace(self, name=name)

    def drop_weights(self) -> "Graph":
        return dataclasses.replace(self, weights=None)

    def remove_disconnected_nodes(self) -> "Graph":
        keep = self.degrees > 0
        # also keep nodes with inbound edges
        inbound = np.zeros(self.number_of_nodes, dtype=bool)
        inbound[self.col_idx] = True
        keep = keep | inbound
        order = np.nonzero(keep)[0]
        remap = np.full(self.number_of_nodes, -1, dtype=np.int64)
        remap[order] = np.arange(len(order))
        return Graph.from_edge_arrays(
            remap[self.sources],
            remap[self.col_idx],
            n_nodes=len(order),
            weights=self.weights,
            edge_types=self.edge_types,
            directed=True,
            directed_flag=self.directed,
            name=self.name,
            node_names=(
                self.get_node_names()[order] if self.node_names is not None else None
            ),
        )

    # ------------------------------------------------------------ construction
    @staticmethod
    def from_edge_arrays(
        src: np.ndarray,
        dst: np.ndarray,
        n_nodes: Optional[int] = None,
        weights: Optional[np.ndarray] = None,
        edge_types: Optional[np.ndarray] = None,
        directed: bool = False,
        directed_flag: Optional[bool] = None,
        name: str = "Graph",
        node_names: Optional[Sequence[str]] = None,
        node_type_ptr: Optional[np.ndarray] = None,
        node_type_ids: Optional[np.ndarray] = None,
        node_type_names: Optional[Sequence[str]] = None,
        edge_type_names: Optional[Sequence[str]] = None,
        deduplicate: bool = True,
    ) -> "Graph":
        """Build CSR from (src, dst[, weights, types]) arc arrays.

        If directed=False, arcs are symmetrized. `directed_flag` overrides the
        stored directedness flag (used internally when arcs are pre-symmetrized).
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if n_nodes is None:
            n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        if (
            not directed and weights is None and edge_types is None
            and deduplicate and len(src)
        ):
            # Unweighted untyped undirected dedup build — the hot
            # constructor of negative-sample and holdout graphs — fuses
            # symmetrize + per-row sort + dedup in one native pass
            # (~5x the numpy concat/sort/dedup pipeline at 20M pairs).
            from .. import native

            built = native.build_sym_csr(src, dst, n_nodes)
            if built is not None:
                row_ptr, col_idx = built
                return Graph(
                    row_ptr=row_ptr,
                    col_idx=col_idx,
                    directed=(
                        directed if directed_flag is None else directed_flag
                    ),
                    name=name,
                    node_names=(
                        None if node_names is None
                        else np.asarray(node_names, dtype=object)
                    ),
                    node_type_ptr=(
                        None if node_type_ptr is None
                        else np.asarray(node_type_ptr)
                    ),
                    node_type_ids=(
                        None if node_type_ids is None
                        else np.asarray(node_type_ids)
                    ),
                    node_type_names=(
                        None if node_type_names is None
                        else np.asarray(node_type_names, dtype=object)
                    ),
                    edge_type_names=(
                        None if edge_type_names is None
                        else np.asarray(edge_type_names, dtype=object)
                    ),
                )
        if not directed:
            non_loop = src != dst
            src_all = np.concatenate([src, dst[non_loop]])
            dst_all = np.concatenate([dst, src[non_loop]])
            if weights is not None:
                weights = np.concatenate([weights, weights[non_loop]])
            if edge_types is not None:
                edge_types = np.concatenate([edge_types, edge_types[non_loop]])
            src, dst = src_all, dst_all
        # (src, dst) sort via the native two-pass counting sort when
        # available — numpy's lexsort is comparison-based and takes ~7 s
        # per 10M arcs on the bench host (every negative graph and holdout
        # split pays it).
        from .. import native

        order = native.sort_pairs(src, dst, n_nodes)
        if order is None:
            order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32)[order]
        if edge_types is not None:
            edge_types = np.asarray(edge_types, dtype=np.int32)[order]
        if deduplicate and len(src):
            uniq = np.concatenate([[True], (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])])
            src, dst = src[uniq], dst[uniq]
            if weights is not None:
                weights = weights[uniq]
            if edge_types is not None:
                edge_types = edge_types[uniq]
        counts = np.bincount(src, minlength=n_nodes)
        row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return Graph(
            row_ptr=row_ptr,
            col_idx=dst.astype(np.int32),
            directed=directed if directed_flag is None else directed_flag,
            name=name,
            weights=weights,
            edge_types=edge_types,
            node_type_ptr=None if node_type_ptr is None else np.asarray(node_type_ptr),
            node_type_ids=None if node_type_ids is None else np.asarray(node_type_ids),
            node_names=None if node_names is None else np.asarray(node_names, dtype=object),
            node_type_names=(
                None if node_type_names is None
                else np.asarray(node_type_names, dtype=object)
            ),
            edge_type_names=(
                None if edge_type_names is None
                else np.asarray(edge_type_names, dtype=object)
            ),
        )

    # ----------------------------------------------------------------- device
    def device(
        self,
        with_alias: bool = False,
        with_weights: bool = True,
        dtype=None,
        ell_cap: Optional[int] = None,
        with_sources: bool = False,
        with_walk_types: bool = False,
        ell_seed: int = 0,
    ) -> DeviceGraph:
        """Export as a DeviceGraph pytree of jnp arrays for on-device kernels.

        `ell_cap` additionally builds the capped ELLPACK adjacency ([N, cap]
        int32, -1 padded) that powers the row-gather p/q walk kernel
        (`ops/walks.py::_second_order_step_ell`). Rows whose degree exceeds
        the cap hold a SEEDED UNIFORM SUBSAMPLE of their neighbours (not the
        first `cap` CSR entries — that would make high-column-id hub
        neighbours unreachable by capped walks). This mirrors the reference's
        approximate-walk mode for high-degree nodes
        (`abstract_random_walked_based_embedder_model.py:57-60`:
        max_neighbours "approximated walks"); `ell_seed` (e.g. the model's
        random_state) varies the subsample across fits.

        `with_walk_types` exports the primary node type per node and, when
        the ELL table is built, the per-slot candidate node/edge types used
        by the typed transition factors (change_node_type_weight /
        change_edge_type_weight)."""
        import jax.numpy as jnp

        alias_prob = alias_idx = None
        if with_alias and self.weights is not None:
            prob, alias = build_alias_tables(self.row_ptr, self.weights)
            alias_prob = jnp.asarray(prob)
            alias_idx = jnp.asarray(alias)
        node_type_of = None
        if with_walk_types and self.has_node_types:
            node_type_of = jnp.asarray(self.get_single_label_node_type_ids())
        ell_cols = ell_w = ell_ntypes = ell_etypes = None
        if ell_cap is not None and ell_cap > 0:
            cap = int(min(ell_cap, max(int(self.degrees.max(initial=1)), 1)))
            n = self.number_of_nodes
            degrees = self.degrees.astype(np.int64)
            row_start = self.row_ptr[:-1].astype(np.int64)
            rows = np.repeat(np.arange(n, dtype=np.int64), degrees)
            pos = np.arange(rows.shape[0], dtype=np.int64) - row_start[rows]
            over = degrees > cap
            if over.any():
                # Random within-row order for over-cap rows only; keeping
                # the first `cap` of a random order IS a uniform subsample.
                sub = over[rows]
                rng = np.random.default_rng(ell_seed)
                order = np.lexsort((rng.random(int(sub.sum())), rows[sub]))
                ranks = np.empty(order.shape[0], dtype=np.int64)
                sub_rows = rows[sub][order]
                starts = np.concatenate(
                    [[0], np.flatnonzero(sub_rows[1:] != sub_rows[:-1]) + 1]
                )
                ranks[order] = (
                    np.arange(order.shape[0], dtype=np.int64)
                    - np.repeat(starts, np.diff(np.concatenate(
                        [starts, [order.shape[0]]]
                    )))
                )
                pos = pos.copy()
                pos[sub] = ranks
            keep = pos < cap
            ecols = np.full((n, cap), -1, np.int32)
            ecols[rows[keep], pos[keep]] = self.col_idx[keep]
            ell_cols = jnp.asarray(ecols)
            if self.weights is not None:
                ew = np.zeros((n, cap), np.float32)
                ew[rows[keep], pos[keep]] = self.weights[keep]
                ell_w = jnp.asarray(ew)
            if with_walk_types:
                if node_type_of is not None:
                    ent = np.full((n, cap), -1, np.int32)
                    ntypes = self.get_single_label_node_type_ids()
                    ent[rows[keep], pos[keep]] = ntypes[self.col_idx[keep]]
                    ell_ntypes = jnp.asarray(ent)
                if self.edge_types is not None:
                    eet = np.full((n, cap), -1, np.int32)
                    eet[rows[keep], pos[keep]] = self.edge_types[keep]
                    ell_etypes = jnp.asarray(eet)
            ell_cap = cap
        else:
            ell_cap = 0
        return DeviceGraph(
            row_ptr=jnp.asarray(self.row_ptr, dtype=jnp.int32),
            col_idx=jnp.asarray(self.col_idx, dtype=jnp.int32),
            degrees=jnp.asarray(self.degrees, dtype=jnp.int32),
            weights=(
                jnp.asarray(self.weights, dtype=dtype or jnp.float32)
                if (with_weights and self.weights is not None)
                else None
            ),
            edge_types=(
                jnp.asarray(self.edge_types, dtype=jnp.int32)
                if self.edge_types is not None
                else None
            ),
            alias_prob=alias_prob,
            alias_idx=alias_idx,
            n_nodes=self.number_of_nodes,
            n_arcs=self.number_of_directed_edges,
            max_degree=int(self.degrees.max(initial=0)),
            ell_cols=ell_cols,
            ell_w=ell_w,
            ell_cap=ell_cap,
            sources=(
                jnp.asarray(self.sources, dtype=jnp.int32)
                if with_sources else None
            ),
            node_type_of=node_type_of,
            ell_ntypes=ell_ntypes,
            ell_etypes=ell_etypes,
        )

    # -------------------------------------------------------------- analysis
    def connected_components(self) -> Tuple[np.ndarray, int]:
        """(component_id per node [N], number of components) treating arcs as
        undirected. Runs scipy.sparse.csgraph (C) when available, else the
        native C++ union-find, else vectorized label propagation — all scale
        to the multi-million-arc bench graphs."""
        n = self.number_of_nodes
        try:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import connected_components as _cc

            mat = csr_matrix(
                (
                    np.ones(self.number_of_directed_edges, np.int8),
                    self.col_idx,
                    self.row_ptr,
                ),
                shape=(n, n),
            )
            n_comp, labels = _cc(mat, directed=False)
            return labels.astype(np.int32), int(n_comp)
        except ImportError:
            pass
        from .. import native

        got = native.native_connected_components(self.sources, self.col_idx, n)
        if got is not None:
            comp, n_comp = got
            return comp, n_comp
        # Vectorized label propagation: O(E) per pass, O(diameter) passes.
        labels = np.arange(n, dtype=np.int64)
        src, dst = self.sources, self.col_idx
        while True:
            new = labels.copy()
            np.minimum.at(new, src, labels[dst])
            np.minimum.at(new, dst, labels[src])
            # pointer-jump to accelerate convergence
            new = new[new]
            if np.array_equal(new, labels):
                break
            labels = new
        uniq, comp = np.unique(labels, return_inverse=True)
        return comp.astype(np.int32), len(uniq)

    @property
    def number_of_connected_components(self) -> int:
        return self.connected_components()[1]

    def is_connected(self) -> bool:
        return self.number_of_connected_components == 1

    def to_dot(self) -> str:
        """GraphViz dot representation (reference `Graph.to_dot`).
        Vectorized: undirected dedup via the upper-triangular arc mask and
        one `str.join` — no per-edge Python loop."""
        names = np.asarray(self.get_node_names(), dtype=object)
        kind = "digraph" if self.directed else "graph"
        arrow = "->" if self.directed else "--"
        src, dst = self.sources, self.col_idx
        if not self.directed:
            keep = src <= dst
            src, dst = src[keep], dst[keep]
        body = "".join(
            np.char.add(
                np.char.add(
                    np.char.add('  "', names[src].astype(str)),
                    f'" {arrow} "',
                ),
                np.char.add(names[dst].astype(str), '";\n'),
            )
        ) if len(src) else ""
        return f"{kind} {{\n{body}}}"

    def filter_from_names(
        self,
        node_names_to_keep: Optional[Sequence[str]] = None,
        node_names_to_remove: Optional[Sequence[str]] = None,
    ) -> "Graph":
        """Subgraph keeping/removing the named nodes (reference
        `filter_from_names`)."""
        keep = np.ones(self.number_of_nodes, dtype=bool)
        if node_names_to_keep is not None:
            keep[:] = False
            keep[self.get_node_ids_from_names(node_names_to_keep)] = True
        if node_names_to_remove is not None:
            keep[self.get_node_ids_from_names(node_names_to_remove)] = False
        ids = np.nonzero(keep)[0]
        remap = np.full(self.number_of_nodes, -1, dtype=np.int64)
        remap[ids] = np.arange(len(ids))
        mask = keep[self.sources] & keep[self.col_idx]
        return Graph.from_edge_arrays(
            remap[self.sources[mask]],
            remap[self.col_idx[mask]],
            n_nodes=len(ids),
            weights=None if self.weights is None else self.weights[mask],
            edge_types=None if self.edge_types is None else self.edge_types[mask],
            directed=True,
            directed_flag=self.directed,
            name=self.name,
            node_names=self.get_node_names()[ids],
        )

    # -------------------------------------------------------------- reporting
    def __repr__(self) -> str:
        return (
            f"Graph(name={self.name!r}, nodes={self.number_of_nodes}, "
            f"arcs={self.number_of_directed_edges}, directed={self.directed}, "
            f"weighted={self.has_edge_weights}, "
            f"node_types={self.number_of_node_types}, "
            f"edge_types={self.number_of_edge_types})"
        )

    def consistent_hash(self) -> str:
        import hashlib

        h = hashlib.sha256()
        h.update(self.name.encode())
        for arr in (self.row_ptr, self.col_idx, self.weights, self.edge_types):
            if arr is not None:
                h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()
