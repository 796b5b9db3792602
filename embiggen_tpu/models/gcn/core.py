"""GCN core: functional encoder + training loop — the JAX counterpart
of the reference's `AbstractGCN` (`embiggen/utils/abstract_gcn.py:201-1066`).

The reference assembles Keras graphs with sparse-tensor inputs and
`embedding_lookup_sparse` convolutions; here the model is a pure function
`(params, features, kernels) -> node representations` built on the
scatter-free bucketed-ELLPACK SpMM (`ops/spmm.py::spmm_padded`), trained
full-graph with optax under jit. Kernel choice
per model mirrors the reference trio: Kipf GCN = Symmetric Normalized
Laplacian (`kipf_gcn.py:175`), GraphSAGE = Left Normalized Laplacian
(`graph_sage.py:172`), GNN = no kernels (`gnn.py:163`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ...graph.graph import Graph
from ...graph.laplacians import kernel_coo
from ...ops.spmm import pad_coo, spmm_padded

Params = Dict[str, Any]


def graph_fingerprint(graph: Graph, *extras) -> str:
    """Cheap identity string for checkpoint gating: graph name/shape plus a
    CRC of the edge structure and any extra arrays (train masks, labels) —
    enough to distinguish holdout splits of the same graph."""
    import zlib

    crc = zlib.crc32(np.ascontiguousarray(graph.row_ptr).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(graph.col_idx).tobytes(), crc)
    for extra in extras:
        crc = zlib.crc32(
            np.ascontiguousarray(np.asarray(extra)).tobytes(), crc
        )
    return (
        f"{getattr(graph, 'name', '')}|{graph.number_of_nodes}|"
        f"{graph.number_of_directed_edges}|{crc:08x}"
    )


_KERNEL_CACHE: "OrderedDict[tuple, Any]" = __import__(
    "collections"
).OrderedDict()
# Small LRU: entries hold DEVICE arrays (a 20M-arc PaddedKernel with its
# transpose is ~350 MB of HBM), and one holdout rarely needs more than two
# distinct kernels.
_KERNEL_CACHE_SIZE = 4


def _cached_kernel(graph: Graph, name: str, halo_mesh, halo_axis):
    """Module-level LRU of relaid-out kernels, keyed on the graph's content
    fingerprint (`Graph.arcs_fingerprint`) + kernel name + halo config —
    shared across model instances (see `GCNEncoder.build_kernels`)."""
    key = (
        graph.arcs_fingerprint, name,
        None if halo_mesh is None else (
            tuple(d.id for d in halo_mesh.devices.flat), halo_axis,
        ),
    )
    hit = _KERNEL_CACHE.get(key)
    if hit is not None:
        _KERNEL_CACHE.move_to_end(key)
        return hit
    rows, cols, vals = kernel_coo(graph, name)
    if halo_mesh is not None:
        from ...parallel.halo import build_halo_partition

        built = build_halo_partition(
            rows, cols, vals, graph.number_of_nodes,
            int(halo_mesh.devices.size),
        )
    else:
        built = pad_coo(
            rows, cols, vals, graph.number_of_nodes, with_transpose=True
        )
    _KERNEL_CACHE[key] = built
    while len(_KERNEL_CACHE) > _KERNEL_CACHE_SIZE:
        _KERNEL_CACHE.popitem(last=False)
    return built


def glorot(key, shape):
    limit = np.sqrt(6.0 / (shape[0] + shape[1]))
    return jax.random.uniform(key, shape, jnp.float32, -limit, limit)


def init_mlp(key, dims: Sequence[int]) -> List[Dict[str, jnp.ndarray]]:
    layers = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        layers.append(
            {
                "w": glorot(sub, (dims[i], dims[i + 1])),
                "b": jnp.zeros((dims[i + 1],), jnp.float32),
            }
        )
    return layers


def apply_mlp(layers, x, activation=jax.nn.relu, final_activation=None,
              dropout_rate=0.0, key=None, training=False):
    n = len(layers)
    for i, layer in enumerate(layers):
        if training and dropout_rate > 0 and key is not None:
            key, sub = jax.random.split(key)
            keep = jax.random.bernoulli(sub, 1.0 - dropout_rate, x.shape)
            x = jnp.where(keep, x / (1.0 - dropout_rate), 0.0)
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


class GCNEncoder:
    """Stack of graph convolutions over one or more propagation kernels.

    Per kernel k and layer l:  H = act( A_k @ (dropout(H)) W_l + b_l );
    outputs of all kernels are concatenated; with `residual` the input features
    are concatenated to the final representation (the reference's residual
    concat of conv layers, `abstract_gcn.py:608-789`)."""

    def __init__(
        self,
        kernel_names: Optional[Sequence[str]],
        units: Sequence[int],
        combiner: str = "sum",
        dropout_rate: float = 0.5,
        residual: bool = False,
        handling_multi_graph: str = "warn",
    ):
        self.kernel_names = list(kernel_names) if kernel_names else []
        self.units = list(units)
        self.combiner = combiner
        self.dropout_rate = dropout_rate
        self.residual = residual
        self.handling_multi_graph = handling_multi_graph
        self._halo_mesh = None
        self._halo_axis = None

    @property
    def has_convolutions(self) -> bool:
        return bool(self.kernel_names) and bool(self.units)

    def enable_halo(self, mesh, axis: str = "nodes") -> None:
        """Switch the encoder to the node-partitioned halo-exchange SpMM
        (`parallel/halo.py`): features row-sharded over `mesh`, per-layer
        communication ∝ boundary nodes. `build_kernels` then produces
        `HaloPartition`s instead of `PaddedKernel`s. Dropout masks are drawn
        on the UNPADDED [N, D] activations in the same key order as the
        single-chip path, so a seeded sharded fit matches a single-chip fit
        to float-reduction tolerance."""
        self._halo_mesh = mesh
        self._halo_axis = axis

    def build_kernels(self, graph: Graph):
        """One single-K ELLPACK `PaddedKernel` per kernel name — the
        scatter-free gather-contract layout `spmm_padded` consumes (built
        once here; the reference builds its tf.SparseTensor equivalents once
        per fit, `abstract_gcn.py:1202-1221`). In halo mode: one
        `HaloPartition` per kernel instead.

        Kernels are cached in a module-level LRU keyed on the support
        graph's CONTENT fingerprint + kernel name (VERDICT r3 item 3): in
        the evaluation harness every model evaluated on one holdout sees
        the same train split, so the host relayout runs once per
        (split, kernel name), not once per model — and models sharing a
        kernel (e.g. Kipf edge- and node-label GCNs both use the Symmetric
        Normalized Laplacian) share the device arrays too."""
        if self.kernel_names:
            # Multigraph/singleton policy runs pre-cache so "raise"/"warn"
            # fire even when the relaid-out kernel is already cached
            # (reference `abstract_gcn.py:97-118`).
            from ...graph.laplacians import validate_convolution_graph

            validate_convolution_graph(graph, self.handling_multi_graph)
        return [
            _cached_kernel(graph, name, self._halo_mesh, self._halo_axis)
            for name in self.kernel_names
        ]

    def _conv(self, pk, h: jnp.ndarray) -> jnp.ndarray:
        """One kernel application: A @ h — bucketed gather-contract on one
        chip, halo-exchange SpMM over the mesh in halo mode."""
        if self._halo_mesh is None:
            return spmm_padded(pk, h, self.combiner)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ...parallel.halo import halo_spmm

        mesh, axis = self._halo_mesh, self._halo_axis
        n = h.shape[0]
        n_pad = pk.n_shards * pk.shard_size
        hp = jnp.pad(h, ((0, n_pad - n), (0, 0)))
        hp = jax.lax.with_sharding_constraint(
            hp, NamedSharding(mesh, P(axis))
        )
        return halo_spmm(mesh, axis, pk, hp, self.combiner)[:n]

    def init(self, key, in_dim: int) -> Params:
        params: Params = {"kernels": []}
        for _ in self.kernel_names:
            key, sub = jax.random.split(key)
            params["kernels"].append(init_mlp(sub, [in_dim] + self.units))
        return params

    def output_dim(self, in_dim: int) -> int:
        if not self.has_convolutions:
            return in_dim
        d = self.units[-1] * len(self.kernel_names)
        if self.residual:
            d += in_dim
        return d

    def apply(
        self,
        params: Params,
        kernels,  # list of (rows, cols, vals) device COO
        x: jnp.ndarray,
        n_nodes: int,
        training: bool = False,
        key=None,
    ) -> jnp.ndarray:
        if not self.has_convolutions:
            return x
        outs = []
        for layers, pk in zip(params["kernels"], kernels):
            h = x
            for layer in layers:
                if training and self.dropout_rate > 0 and key is not None:
                    key, sub = jax.random.split(key)
                    keep = jax.random.bernoulli(
                        sub, 1.0 - self.dropout_rate, h.shape
                    )
                    h = jnp.where(keep, h / (1.0 - self.dropout_rate), 0.0)
                h = self._conv(pk, h)
                h = jax.nn.relu(h @ layer["w"] + layer["b"])
            outs.append(h)
        h = jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]
        if self.residual:
            h = jnp.concatenate([h, x], axis=1)
        return h


def materialize_node_type_features(
    graph: Graph, node_type_features: List[np.ndarray]
) -> List[np.ndarray]:
    """Per-node rows from [n_node_types, d] matrices: mean over each node's
    known types, zeros for unknown-type nodes (the reference's masked
    average for multilabel graphs,
    `gcn_edge_prediction_sequence.py:168-187`)."""
    onehot = graph.get_one_hot_encoded_node_types()  # [N, T]
    counts = np.maximum(onehot.sum(axis=1, keepdims=True), 1.0)
    return [
        (onehot @ np.asarray(f, np.float32)) / counts
        for f in node_type_features
    ]


def assemble_node_features(
    graph: Graph,
    node_features: Optional[List[np.ndarray]],
    use_node_embedding: bool,
    node_embedding_size: int,
    use_node_type_embedding: bool,
    node_type_embedding_size: int,
    key,
    node_type_features: Optional[List[np.ndarray]] = None,
) -> Tuple[Params, "StaticFeatureSpec"]:
    """Build the static feature matrix and any learned embedding tables
    (reference optional learned node / node-type embeddings,
    `abstract_gcn.py:201-419`); `node_type_features` are [n_node_types, d]
    matrices folded in as per-node type-averaged rows
    (`abstract_gcn.py:612-709`)."""
    mats = [np.asarray(f, np.float32) for f in (node_features or [])]
    if node_type_features:
        mats.extend(materialize_node_type_features(graph, node_type_features))
    static = (
        np.concatenate(mats, axis=1)
        if mats
        else np.zeros((graph.number_of_nodes, 0), np.float32)
    )
    params: Params = {}
    type_ids = None
    if use_node_embedding:
        key, sub = jax.random.split(key)
        params["node_embedding"] = (
            jax.random.normal(
                sub, (graph.number_of_nodes, node_embedding_size), jnp.float32
            )
            / np.sqrt(node_embedding_size)
        )
    if use_node_type_embedding:
        if not graph.has_node_types:
            raise ValueError(
                "use_node_type_embedding requires a graph with node types."
            )
        key, sub = jax.random.split(key)
        n_types = graph.number_of_node_types
        params["node_type_embedding"] = (
            jax.random.normal(
                sub, (n_types + 1, node_type_embedding_size), jnp.float32
            )
            / np.sqrt(node_type_embedding_size)
        )
        # single-label gather (+1 shift, 0 = unknown)
        type_ids = jnp.asarray(
            graph.get_single_label_node_type_ids() + 1, jnp.int32
        )
    spec = StaticFeatureSpec(
        static=jnp.asarray(static),
        type_ids=type_ids,
        use_node_embedding=use_node_embedding,
        use_node_type_embedding=use_node_type_embedding,
    )
    return params, spec


class StaticFeatureSpec:
    def __init__(self, static, type_ids, use_node_embedding, use_node_type_embedding):
        self.static = static
        self.type_ids = type_ids
        self.use_node_embedding = use_node_embedding
        self.use_node_type_embedding = use_node_type_embedding

    def dim(self, embed_params: Params) -> int:
        d = self.static.shape[1]
        if self.use_node_embedding:
            d += embed_params["node_embedding"].shape[1]
        if self.use_node_type_embedding:
            d += embed_params["node_type_embedding"].shape[1]
        return d

    def materialize(self, embed_params: Params, static=None) -> jnp.ndarray:
        """`static` overrides the captured feature matrix — training steps
        pass it through the jit ARGUMENT path (TrainLoop `data`); closing
        over a graph-sized array would bake it into the lowered program as
        an inline constant (gigabytes of HLO at 1M nodes, which kills the
        compiler)."""
        parts = [static if static is not None else self.static]
        if self.use_node_embedding:
            parts.append(embed_params["node_embedding"])
        if self.use_node_type_embedding:
            parts.append(embed_params["node_type_embedding"][self.type_ids])
        return jnp.concatenate(parts, axis=1)


class TrainLoop:
    """Host-side epoch loop with the reference's Keras callbacks re-created:
    EarlyStopping, ReduceLROnPlateau and TerminateOnNaN on training loss
    (`abstract_gcn.py:899-1066`)."""

    def __init__(
        self,
        epochs: int = 1000,
        learning_rate: float = 0.001,
        early_stopping_patience: int = 10,
        early_stopping_min_delta: float = 1e-4,
        reduce_lr_patience: int = 5,
        reduce_lr_factor: float = 0.5,
        steps_per_epoch: int = 1,
        verbose: bool = False,
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 10,
    ):
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_min_delta = early_stopping_min_delta
        self.reduce_lr_patience = reduce_lr_patience
        self.reduce_lr_factor = reduce_lr_factor
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = max(1, checkpoint_interval)

    def _ckpt_path(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        import os

        return os.path.join(self.checkpoint_dir, "train_state")

    def run(self, params, loss_step, key, fingerprint: str = "", data=None):
        """loss_step(params, key) -> (loss, grads) — or, when `data` is
        given, loss_step(params, key, data). One epoch = `steps_per_epoch`
        optimizer steps scanned inside a single jit.

        `data` is the device-context pytree (kernels, feature matrices,
        device graph, label/mask arrays): anything graph-sized MUST ride
        this argument rather than a closure — closed-over jax arrays lower
        to inline HLO constants, and at 1M nodes that is a multi-GB program
        that crashes the compiler.

        If `checkpoint_dir` is set, the FULL host loop state (params,
        optimizer state, PRNG key, callback counters, loss history) is saved
        every `checkpoint_interval` epochs and restored on the next call, so
        a killed run resumes bit-identically (mid-training checkpointing is a
        capability the reference lacks — SURVEY §5.4). The checkpoint is
        fingerprinted against the params tree (treedef + shapes), the loop
        config and the caller-supplied `fingerprint` (graph/holdout
        identity), and deleted when the run COMPLETES — without both, a
        model refit on holdout k≥2 would resume from holdout 1's final
        state: silent cross-holdout leakage."""
        optimizer = optax.adam(self.learning_rate)
        opt_state = optimizer.init(params)
        n_steps = self.steps_per_epoch

        @jax.jit
        def step(params, opt_state, epoch_key, lr_scale, data):
            def body(carry, k):
                params, opt_state = carry
                loss, grads = (
                    loss_step(params, k)
                    if data is None
                    else loss_step(params, k, data)
                )
                grads = jax.tree_util.tree_map(lambda g: g * lr_scale, grads)
                updates, opt_state = optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            keys = jax.random.split(epoch_key, n_steps)
            (params, opt_state), losses = jax.lax.scan(
                body, (params, opt_state), keys
            )
            return params, opt_state, losses.mean()

        best = np.inf
        best_params = params
        patience = 0
        lr_patience = 0
        lr_scale = 1.0
        history = []
        start_epoch = 0
        # Wall time per epoch (first entry includes jit compile); read by
        # benchmarks to separate compile from steady-state epoch cost.
        self.epoch_seconds = []

        ckpt_path = self._ckpt_path()
        ckpt_fp = None
        if ckpt_path is not None:
            from ...utils.checkpoint import (
                checkpoint_exists,
                checkpoint_matches,
                load_pytree,
            )

            shapes = jax.tree_util.tree_map(
                lambda l: tuple(np.shape(l)), params
            )
            ckpt_fp = "|".join(
                str(x)
                for x in (
                    fingerprint,
                    jax.tree_util.tree_structure(params),
                    sorted(jax.tree_util.tree_leaves(shapes)),
                    self.epochs,
                    self.steps_per_epoch,
                    self.learning_rate,
                )
            )
            if checkpoint_exists(ckpt_path) and not checkpoint_matches(
                ckpt_path, ckpt_fp
            ):
                import warnings

                warnings.warn(
                    f"Ignoring checkpoint at {ckpt_path}: it was written by "
                    "a different model/graph/holdout run."
                )
            elif checkpoint_exists(ckpt_path):
                like = self._pack_state(
                    params, opt_state, key, 0, best, best_params,
                    patience, lr_patience, lr_scale, history,
                )
                state = load_pytree(ckpt_path, like=like)
                params = state["params"]
                opt_state = state["opt_state"]
                key = jnp.asarray(state["key"], jnp.uint32)
                start_epoch = int(state["epoch"])
                best = float(state["best"])
                best_params = state["best_params"]
                patience = int(state["patience"])
                lr_patience = int(state["lr_patience"])
                lr_scale = float(state["lr_scale"])
                history = [float(x) for x in np.asarray(state["history"])]

        import time as _time

        for epoch in range(start_epoch, self.epochs):
            _t0 = _time.perf_counter()
            key, sub = jax.random.split(key)
            params, opt_state, loss = step(
                params, opt_state, sub, jnp.float32(lr_scale), data
            )
            loss = float(loss)
            self.epoch_seconds.append(_time.perf_counter() - _t0)
            history.append(loss)
            if not np.isfinite(loss):  # TerminateOnNaN
                params = best_params
                break
            if loss < best - self.early_stopping_min_delta:
                best = loss
                best_params = params
                patience = 0
                lr_patience = 0
            else:
                patience += 1
                lr_patience += 1
                if lr_patience >= self.reduce_lr_patience:
                    lr_scale *= self.reduce_lr_factor
                    lr_patience = 0
                if patience >= self.early_stopping_patience:
                    break
            if (
                ckpt_path is not None
                and (epoch + 1) % self.checkpoint_interval == 0
                and epoch + 1 < self.epochs
            ):
                from ...utils.checkpoint import save_pytree

                save_pytree(
                    ckpt_path,
                    self._pack_state(
                        params, opt_state, key, epoch + 1, best,
                        best_params, patience, lr_patience, lr_scale,
                        history,
                    ),
                    fingerprint=ckpt_fp,
                )
        if ckpt_path is not None:
            from ...utils.checkpoint import delete_checkpoint

            delete_checkpoint(ckpt_path)
        return best_params, history

    @staticmethod
    def _pack_state(params, opt_state, key, epoch, best, best_params,
                    patience, lr_patience, lr_scale, history):
        return {
            "params": params,
            "opt_state": opt_state,
            "key": np.asarray(key),
            "epoch": np.int64(epoch),
            "best": np.float64(best),
            "best_params": best_params,
            "patience": np.int64(patience),
            "lr_patience": np.int64(lr_patience),
            "lr_scale": np.float64(lr_scale),
            "history": np.asarray(history, np.float64),
        }
