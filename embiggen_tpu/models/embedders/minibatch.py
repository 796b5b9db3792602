"""Shared minibatch-SGD training skeleton with multi-device data parallelism
— the generalization of the reference's base-class distribution flag
(`embiggen/embedders/tensorflow_embedders/tensorflow_embedder.py:73-79,234-240`:
every Keras embedder gets `use_mirrored_strategy`). Here every
edge/triple/entry-minibatch embedder family (LINE, siamese, the KGE family,
GloVe, Walklets) gets `mesh=` through one protocol (VERDICT r3 item 1):

- `_sample_batch(ctx, key, batch_size) -> (sliceable, shared)` draws the
  batch with a REPLICATED key, so every device sees the identical global
  batch; `sliceable` leaves have leading dim batch and are split across
  devices, `shared` leaves (e.g. NCE negatives) are used whole.
- `_batch_updates(params, batch, full_batch) -> (loss_sum, updates)` computes
  sparse gradients for its slice as a list of `Update`s. Gradients must be
  sums over the slice's samples (normalize by `full_batch`, never by the
  slice length, so per-device grads SUM to the single-chip grads).

The data-parallel step slices the batch, computes per-slice updates,
all-gathers the sparse (index, grad) payloads — communication ∝ batch, never
[N, D], unlike a dense mirrored-strategy all-reduce — and applies the
identical global update on every device. Equal to the single-chip step up to
float reduction order (equality-tested in tests/test_mesh_models.py).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...graph.graph import Graph
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from .walk_based import _mean_scatter


class Update(NamedTuple):
    """One sparse (or dense) SGD update against a named parameter table.

    idx: [M] int array of rows, or a tuple of aligned [Mi] arrays (multiset
         SEGMENTS sharing one count multiset — see `_mean_scatter`); either
         may be wrapped as (static_prefix, rows) for stacked tables indexed
         `table[prefix, rows]`; or None with mode="dense".
    grad: [M, ...] gradients aligned with idx (tuple of [Mi, ...] for
         segments; dense table shape for mode="dense"). Sum-semantics
         across batch slices.
    mode: "add"  — scatter-add -lr*grad (order-insensitive);
          "mean" — per-row mean accumulation at full lr (walk_based
                   `_mean_scatter` policy; counts computed over the full
                   gathered multiset, so DP == single-chip);
          "dense" — whole-table SGD step (psum-reduced across devices).
    """

    name: str
    idx: Any
    grad: Any
    mode: str = "add"


def _split_prefix(idx):
    """(static_prefix, rows) -> (prefix, rows); plain rows -> (None, rows).
    A stacked-table prefix is a static int; segment tuples contain only
    index arrays, so the two tuple shapes are unambiguous."""
    if isinstance(idx, tuple) and isinstance(idx[0], int):
        return idx[0], idx[1]
    return None, idx


def apply_updates(
    params: Dict[str, Any], updates: List[Update], lr
) -> Dict[str, Any]:
    for u in updates:
        t = params[u.name]
        if u.mode == "dense":
            params[u.name] = t - lr * u.grad
            continue
        prefix, rows = _split_prefix(u.idx)
        if u.mode == "mean":
            if prefix is None:
                params[u.name], _ = _mean_scatter(t, rows, u.grad, lr)
            else:
                sub, _ = _mean_scatter(t[prefix], rows, u.grad, lr)
                params[u.name] = t.at[prefix].set(sub)
        elif prefix is None:
            params[u.name] = t.at[rows].add(-lr * u.grad)
        else:
            params[u.name] = t.at[prefix, rows].add(-lr * u.grad)
    return params


def gather_updates(updates: List[Update], axis: str) -> List[Update]:
    """Turn per-slice updates into the global update: all-gather sparse
    payloads in axis order (tiled), psum dense grads. Segment tuples
    gather per segment (each stays aligned with its gathered grads)."""

    def ag(a):
        return lax.all_gather(a, axis, tiled=True)

    out = []
    for u in updates:
        if u.mode == "dense":
            out.append(u._replace(grad=lax.psum(u.grad, axis)))
            continue
        prefix, rows = _split_prefix(u.idx)
        if isinstance(rows, tuple):
            rows_g = tuple(ag(a) for a in rows)
            grad_g = tuple(ag(g) for g in u.grad)
        else:
            rows_g = ag(rows)
            grad_g = ag(u.grad)
        idx_g = rows_g if prefix is None else (prefix, rows_g)
        out.append(u._replace(idx=idx_g, grad=grad_g))
    return out


def slice_batch(sliceable, i, per_device):
    """Slice every leaf's leading batch axis for device i."""
    return jax.tree_util.tree_map(
        lambda a: lax.dynamic_slice_in_dim(a, i * per_device, per_device, 0),
        sliceable,
    )


class MinibatchEmbedder(AbstractEmbeddingModel):
    """Training template: jitted epoch = `lax.scan` over fused sample → grad
    → sparse-update steps with donated tables; host-side plateau callbacks
    between epochs (reference `tensorflow_embedder.py:264-277`); optional
    `mesh=` data parallelism via the Update protocol above."""

    def __init__(
        self,
        embedding_size: int = 100,
        epochs: int = 30,
        batch_size: Optional[int] = None,
        learning_rate: float = 0.05,
        learning_rate_decay: float = 0.9,
        early_stopping_min_delta: float = 0.001,
        early_stopping_patience: int = 1,
        learning_rate_plateau_min_delta: float = 0.001,
        learning_rate_plateau_patience: int = 1,
        mesh=None,
        distribution: str = "auto",
        checkpoint_dir: Optional[str] = None,
        checkpoint_interval: int = 1,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._epochs = epochs
        self._batch_size = batch_size
        self._learning_rate = learning_rate
        self._learning_rate_decay = learning_rate_decay
        self._early_stopping_min_delta = early_stopping_min_delta
        self._early_stopping_patience = early_stopping_patience
        self._learning_rate_plateau_min_delta = learning_rate_plateau_min_delta
        self._learning_rate_plateau_patience = learning_rate_plateau_patience
        self._mesh = mesh
        if distribution not in ("auto", "data", "rows", "none"):
            raise ValueError(
                "distribution must be one of 'auto', 'data', 'rows', "
                f"'none'; got {distribution!r}."
            )
        self._distribution = distribution
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_interval = max(1, checkpoint_interval)
        super().__init__(
            embedding_size=embedding_size,
            enable_cache=enable_cache,
            random_state=random_state,
        )

    def parameters(self) -> Dict[str, Any]:
        mesh = self._mesh
        if mesh is not None and not isinstance(mesh, (int, str)):
            mesh = int(np.prod(list(mesh.devices.shape)))
        return {
            **super().parameters(),
            "epochs": self._epochs,
            "batch_size": self._batch_size,
            "learning_rate": self._learning_rate,
            "learning_rate_decay": self._learning_rate_decay,
            "early_stopping_min_delta": self._early_stopping_min_delta,
            "early_stopping_patience": self._early_stopping_patience,
            "learning_rate_plateau_min_delta":
                self._learning_rate_plateau_min_delta,
            "learning_rate_plateau_patience":
                self._learning_rate_plateau_patience,
            "mesh": mesh,
            "distribution": self._distribution,
        }

    # ------------------------------------------------------- subclass hooks
    def _pre_fit_check(self, graph: Graph) -> None:
        pass

    def _prepare_data(self, graph: Graph):
        """Device pytree the sampler draws from (DeviceGraph for edge/triple
        models, co-occurrence arrays for GloVe)."""
        raise NotImplementedError

    def _init_params(self, graph: Graph, key) -> Dict[str, Any]:
        raise NotImplementedError

    def _resolve_batch_size(self, graph: Graph, ctx) -> int:
        """Auto-scaled batch: enough samples per step to fill the chip,
        epochs still covering the data once."""
        if self._batch_size is not None:
            return self._batch_size
        return int(
            min(65536, max(1024, graph.number_of_directed_edges // 64))
        )

    def _steps_per_epoch(self, graph: Graph, ctx, batch: int) -> int:
        return max(1, graph.number_of_directed_edges // batch)

    def _sample_batch(self, ctx, key, batch_size: int):
        """(sliceable, shared) pytrees; sliceable leaves have leading dim
        batch_size."""
        raise NotImplementedError

    def _batch_updates(
        self, params: Dict[str, Any], batch, full_batch: int
    ) -> Tuple[jnp.ndarray, List[Update]]:
        """(loss_sum, updates) for `batch` = (sliceable_slice, shared).
        Gradients must be batch-sums normalized by `full_batch` where the
        single-chip semantics demand a batch mean."""
        raise NotImplementedError

    def _extract(self, params: Dict[str, Any], graph: Graph) -> EmbeddingResult:
        raise NotImplementedError

    @classmethod
    def supports_distribution(cls) -> bool:
        """Distributable iff the model implements the Update-protocol hooks
        (models overriding `_step` directly stay single-chip)."""
        return (
            cls._batch_updates is not MinibatchEmbedder._batch_updates
            and cls._sample_batch is not MinibatchEmbedder._sample_batch
        )

    def _row_sharded_keys(self, graph: Graph, params) -> Tuple[str, ...]:
        """Param tables sharded by NODE rows under distribution='rows' —
        the out-of-core axis (the reference exposes mmap embedding paths on
        these same models, e.g. `ensmallen_embedders/transe.py:20-21`,
        `first_order_line.py:72`): aggregate HBM for the [N, ...] tables
        scales with chips. Default: every table whose leading dimension is
        the node count."""
        n = graph.number_of_nodes
        return tuple(
            name for name, t in params.items() if t.shape[0] == n
        )

    # ----------------------------------------------------------- step paths
    def _run_batch(self) -> int:
        b = getattr(self, "_run_batch_size", None)
        if b is not None:
            return b
        return self._batch_size if self._batch_size is not None else 1024

    def _step(self, ctx, params, key, lr):
        """Single-chip fused step via the hooks (models may override)."""
        batch = self._run_batch()
        sl, sh = self._sample_batch(ctx, key, batch)
        loss, updates = self._batch_updates(params, (sl, sh), batch)
        params = apply_updates(params, updates, lr)
        return params, loss / batch

    def _make_dp_step(self, mesh, batch_size: int):
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        axis = mesh.axis_names[0]
        p = int(mesh.devices.size)
        assert batch_size % p == 0, (batch_size, p)
        bp = batch_size // p
        model = self

        def step(ctx, params, key, lr):
            ctx_spec = jax.tree_util.tree_map(lambda _: P(), ctx)
            param_specs = jax.tree_util.tree_map(lambda _: P(), params)

            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(ctx_spec, param_specs, P(), P()),
                out_specs=(param_specs, P()),
                check_vma=False,
            )
            def _run(ctx_l, params_l, key_l, lr_l):
                sl, sh = model._sample_batch(ctx_l, key_l, batch_size)
                i = lax.axis_index(axis)
                sl_i = slice_batch(sl, i, bp)
                loss, updates = model._batch_updates(
                    params_l, (sl_i, sh), batch_size
                )
                params_l = apply_updates(
                    params_l, gather_updates(updates, axis), lr_l
                )
                return params_l, lax.psum(loss, axis)

            params, loss = _run(ctx, params, key, lr)
            return params, loss / batch_size

        return step

    def _make_row_sharded_step(self, mesh, batch_size: int, row_keys):
        """Row-sharded-table step: every device draws the SAME full batch,
        gathers the needed rows from the sharded tables (masked local
        lookup + one psum per gather — comm ∝ batch) and applies updates
        only to rows it owns (no comm). Bit-equal to single-chip on a CPU
        mesh up to psum ordering."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from ...parallel.sharded_table import (
            _RowShardView,
            _mean_scatter_owned,
            _scatter_add_owned,
        )

        axis = mesh.axis_names[0]
        row_keys = frozenset(row_keys)
        model = self

        def step(ctx, params, key, lr):
            ctx_spec = jax.tree_util.tree_map(lambda _: P(), ctx)
            param_specs = {
                n: (
                    P(axis, *([None] * (t.ndim - 1)))
                    if n in row_keys else P()
                )
                for n, t in params.items()
            }

            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=(ctx_spec, param_specs, P(), P()),
                out_specs=(param_specs, P()),
                check_vma=False,
            )
            def _run(ctx_l, params_l, key_l, lr_l):
                views = {
                    n: (
                        _RowShardView(t, axis) if n in row_keys else t
                    )
                    for n, t in params_l.items()
                }
                sl, sh = model._sample_batch(ctx_l, key_l, batch_size)
                loss, updates = model._batch_updates(
                    views, (sl, sh), batch_size
                )
                for u in updates:
                    t = params_l[u.name]
                    if u.name not in row_keys:
                        params_l = apply_updates(params_l, [u], lr_l)
                        continue
                    assert u.mode in ("add", "mean"), u.mode
                    assert not isinstance(u.idx, tuple)
                    if u.mode == "mean":
                        params_l[u.name], _ = _mean_scatter_owned(
                            t, u.idx, u.grad, lr_l, axis
                        )
                    else:
                        params_l[u.name] = _scatter_add_owned(
                            t, u.idx, -lr_l * u.grad, axis
                        )
                # Gathered rows are identical on every shard, so the loss
                # is already replicated.
                return params_l, loss

            params, loss = _run(ctx, params, key, lr)
            return params, loss / batch_size

        return step

    # -------------------------------------------------------- training loop
    def _choose_distribution(self, mesh, graph: Graph, params) -> str:
        if mesh is None or self._distribution == "none":
            return "none"
        if not self.supports_distribution():
            import warnings

            warnings.warn(
                f"{type(self).__name__} does not implement the distributed "
                "training hooks; falling back to single-device training."
            )
            return "none"
        from ...parallel.mesh import auto_distribution

        keys = self._row_sharded_keys(graph, params)
        wanted = self._distribution
        if wanted == "auto":
            table_bytes = sum(
                int(np.prod(t.shape)) * 4
                for n, t in params.items() if n in keys
            )
            wanted = auto_distribution(table_bytes, mesh.devices.flat[0])
        if wanted == "rows":
            if not keys:
                import warnings

                warnings.warn(
                    f"{type(self).__name__} has no node-row tables to "
                    "shard; using data parallelism."
                )
                return "data"
            return "rows"
        return "data"

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        from ...parallel.mesh import resolve_mesh
        from ...utils.plateau import PlateauController

        self._pre_fit_check(graph)
        ctx = self._prepare_data(graph)
        key = jax.random.PRNGKey(self.random_state or 0)
        params = self._init_params(graph, key)
        mesh = resolve_mesh(self._mesh)
        strategy = self._choose_distribution(mesh, graph, params)
        batch = self._resolve_batch_size(graph, ctx)
        row_keys = ()
        orig_rows = {}
        place_fn = None
        if strategy == "data":
            p = int(mesh.devices.size)
            batch = -(-batch // p) * p
            step_fn = self._make_dp_step(mesh, batch)
            from jax.sharding import NamedSharding, PartitionSpec as P

            replicated = NamedSharding(mesh, P())
            place_fn = lambda prm: jax.device_put(prm, replicated)  # noqa: E731
            ctx = jax.device_put(ctx, replicated)
            key = jax.device_put(key, replicated)
        elif strategy == "rows":
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ...parallel.sharded_table import padded_rows

            p = int(mesh.devices.size)
            row_keys = self._row_sharded_keys(graph, params)
            step_fn = self._make_row_sharded_step(mesh, batch, row_keys)
            orig_rows = {n: params[n].shape[0] for n in row_keys}

            def place_fn(prm):
                out = {}
                for n, t in prm.items():
                    t = jnp.asarray(t)
                    if n in row_keys:
                        n_pad = padded_rows(t.shape[0], p)
                        if n_pad != t.shape[0]:
                            t = jnp.pad(
                                t,
                                [(0, n_pad - t.shape[0])]
                                + [(0, 0)] * (t.ndim - 1),
                            )
                        spec = P(
                            mesh.axis_names[0], *([None] * (t.ndim - 1))
                        )
                        out[n] = jax.device_put(
                            t, NamedSharding(mesh, spec)
                        )
                    else:
                        out[n] = jax.device_put(
                            t, NamedSharding(mesh, P())
                        )
                return out

            ctx = jax.device_put(ctx, NamedSharding(mesh, P()))
            key = jax.device_put(key, NamedSharding(mesh, P()))
        else:
            step_fn = self._step
        if place_fn is not None:
            params = place_fn(params)
        self._run_batch_size = batch
        steps_per_epoch = self._steps_per_epoch(graph, ctx, batch)

        # ctx rides the jit ARGUMENT path — closed-over device arrays lower
        # as inline HLO constants (GBs at scale).
        @functools.partial(jax.jit, donate_argnums=1)
        def epoch_fn(ctx, params, epoch_key, lr):
            keys = jax.random.split(epoch_key, steps_per_epoch)
            params, losses = lax.scan(
                lambda prm, k: step_fn(ctx, prm, k, lr), params, keys
            )
            return params, losses.mean()

        ctrl = PlateauController(
            early_stopping_min_delta=self._early_stopping_min_delta,
            early_stopping_patience=self._early_stopping_patience,
            learning_rate_plateau_min_delta=(
                self._learning_rate_plateau_min_delta
            ),
            learning_rate_plateau_patience=(
                self._learning_rate_plateau_patience
            ),
        )

        # Mid-training checkpointing (same scheme as the walk embedders,
        # SURVEY §5.4): per-epoch keys are fold_in(key, epoch) and lr is a
        # pure function of (epoch, plateau state), both checkpointed, so a
        # killed run resumes bit-identically. Fingerprinted against
        # (model, graph, hyper-params); deleted on completion.
        ckpt_path = None
        ckpt_fp = None
        start_epoch = 0
        if self._checkpoint_dir is not None:
            import os

            from ...utils.checkpoint import (
                checkpoint_exists,
                checkpoint_matches,
                load_pytree,
                save_pytree,
            )

            ckpt_path = os.path.join(self._checkpoint_dir, "embed_state")
            ckpt_fp = "|".join(
                str(x)
                for x in (
                    type(self).__name__,
                    getattr(graph, "name", ""),
                    graph.number_of_nodes,
                    graph.number_of_directed_edges,
                    self.embedding_size,
                    self._epochs,
                    self._batch_size,
                    self.random_state,
                )
            )
            if checkpoint_exists(ckpt_path):
                if checkpoint_matches(ckpt_path, ckpt_fp):
                    state = load_pytree(
                        ckpt_path,
                        like={
                            "params": jax.tree_util.tree_map(
                                np.asarray, params
                            ),
                            "epoch": np.int64(0),
                            "ctrl": ctrl.state_array(),
                        },
                    )
                    params = jax.tree_util.tree_map(
                        jnp.asarray, state["params"]
                    )
                    if place_fn is not None:
                        params = place_fn(params)
                    start_epoch = int(state["epoch"])
                    ctrl.load_state_array(state["ctrl"])
                else:
                    import warnings

                    warnings.warn(
                        f"Ignoring checkpoint at {ckpt_path}: it was "
                        "written by a different model/graph/hyper-parameter "
                        "run."
                    )

        last = None
        for epoch in range(start_epoch, self._epochs):
            lr = jnp.float32(
                self._learning_rate
                * self._learning_rate_decay ** epoch
                * ctrl.lr_scale
            )
            params, last = epoch_fn(
                ctx, params, jax.random.fold_in(key, epoch), lr
            )
            stop = ctrl.update(float(last))
            if (
                ckpt_path is not None
                and (epoch + 1) % self._checkpoint_interval == 0
                and epoch + 1 < self._epochs
                and not stop
            ):
                save_pytree(
                    ckpt_path,
                    {
                        "params": jax.tree_util.tree_map(
                            np.asarray, params
                        ),
                        "epoch": np.int64(epoch + 1),
                        "ctrl": ctrl.state_array(),
                    },
                    fingerprint=ckpt_fp,
                )
            if stop:
                ctrl.stopped_epoch = epoch
                break
        if ckpt_path is not None:
            from ...utils.checkpoint import delete_checkpoint

            delete_checkpoint(ckpt_path)
        self._last_loss = None if last is None else float(last)
        self._stopped_epoch = ctrl.stopped_epoch
        for n, rows in orig_rows.items():
            # Trim the mesh-padding rows before extraction.
            params[n] = np.asarray(params[n])[:rows]
        return self._extract(params, graph)
