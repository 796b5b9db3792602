"""Smoke run of embiggen_tpu's main path on a GPU, through the public API.

    python chip_smoke.py               # phases 0-5 on one card
    python chip_smoke.py --four-cards  # mesh=4 fits against one card

Phases (one card):
  0. environment: card, JAX, compile cache, native host library;
  1. graph and walks: ER(1M nodes, 10M edges), first-order and p/q walks;
  2. SkipGram at full width through `embed_graph`;
  3. Kipf GCN edge prediction at full width, `predict_proba` on 2^20 pairs;
  4. one holdout of the edge-prediction protocol (split, SkipGram
     features, perceptron, negatives, metrics), without pandas;
  5. production kernels against plain references at real widths.

Each phase prints one line, with its wall time labelled as a smoke time: it
includes compilation and is not a benchmark number. A failed check raises,
so the script exits non-zero and prints no result. Only when every phase
passed is the last line of stdout the JSON object
`{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}`.
The script needs a GPU: on any other platform it fails in phase 0.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    nodes: int = 1_000_000
    edges: int = 10_000_000         # undirected: 20M arcs
    dim: int = 128
    walkers: int = 65_536
    walk_length: int = 64
    window: int = 5
    negatives: int = 10
    skipgram_batch: int = 32_768
    gcn_batch: int = 1 << 20
    pairs: int = 1 << 20
    checked_walkers: int = 4096
    eval_nodes: int = 200_000
    eval_edges: int = 2_000_000
    eval_dim: int = 64
    eval_epochs: int = 100
    band_batch: int = 1024


FULL = Sizes()


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ------------------------------------------------------------------ phase 0
def nvidia_smi() -> str:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return " | ".join(out.stdout.strip().splitlines())


def require_gpu():
    """The JAX devices; raises unless they are GPUs."""
    import jax

    devices = jax.devices()
    check(
        devices[0].platform == "gpu",
        f"no GPU: JAX's default platform is {devices[0].platform!r}",
    )
    return devices


def load_native() -> str:
    """Build (if needed) and load the native host library; raises if it
    does not load, since every host stage would silently fall back to
    numpy."""
    from embiggen_tpu import native

    t0 = time.perf_counter()
    lib = native.get_lib()
    check(lib is not None, "native host library failed to build or load")
    return f"native library loaded in {time.perf_counter() - t0:.1f} s"


def phase_environment(state) -> str:
    import jax

    from embiggen_tpu.utils.compile_cache import enable_compile_cache

    devices = require_gpu()
    smi = nvidia_smi()
    cache = enable_compile_cache()
    d = devices[0]
    limit = (d.memory_stats() or {}).get("bytes_limit", 0)
    state["device"] = {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }
    return (
        f"nvidia-smi: {smi}; jax {jax.__version__}; devices "
        f"{d.platform}/{d.device_kind} x{len(devices)}; "
        f"bytes_limit {limit / 2**30:.1f} GiB; compile cache {cache}; "
        + load_native()
    )


# ------------------------------------------------------------------ phase 1
def steps_follow_arcs(graph, walks) -> bool:
    """True when every step of every walk follows an arc of the CSR (or
    stays put on a node with no neighbours)."""
    n = graph.number_of_nodes
    row_ptr = np.asarray(graph.row_ptr, np.int64)
    cols = np.asarray(graph.col_idx, np.int64)
    deg = np.diff(row_ptr)
    keys = np.repeat(np.arange(n, dtype=np.int64), deg) * n + cols
    w = np.asarray(walks, np.int64)
    a, b = w[:, :-1].ravel(), w[:, 1:].ravel()
    q = a * n + b
    pos = np.minimum(np.searchsorted(keys, q), max(len(keys) - 1, 0))
    found = keys[pos] == q if len(keys) else np.zeros(q.shape, bool)
    return bool((found | ((a == b) & (deg[a] == 0))).all())


def phase_walks(state, s: Sizes) -> str:
    import jax
    import jax.numpy as jnp

    from embiggen_tpu.graph import erdos_renyi
    from embiggen_tpu.ops.walks import random_walks

    graph = erdos_renyi(s.nodes, s.edges, seed=0)
    dg = graph.device(ell_cap=32)
    starts = jnp.arange(s.walkers, dtype=jnp.int32) % graph.number_of_nodes
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    first = random_walks(dg, starts, s.walk_length, k1)
    pq = random_walks(
        dg, starts, s.walk_length, k2, return_weight=2.0,
        explore_weight=0.5, max_neighbours=32,
    )
    jax.block_until_ready((first, pq))
    for name, w in (("first-order", first), ("p/q", pq)):
        check(w.shape == (s.walkers, s.walk_length), f"{name} walks {w.shape}")
        check(
            steps_follow_arcs(graph, np.asarray(w[:s.checked_walkers])),
            f"{name} walks left the graph",
        )
    state["graph"] = graph
    return (
        f"{graph.name}: {graph.number_of_nodes} nodes, "
        f"{graph.number_of_directed_edges} arcs; first-order and p/q "
        f"(2.0/0.5, 32 neighbours) walks [{s.walkers}, {s.walk_length}]; "
        f"{s.checked_walkers} walkers per kind checked, every step on an arc"
    )


# ------------------------------------------------------------------ phase 2
def phase_skipgram(state, s: Sizes) -> str:
    from embiggen_tpu import embed_graph
    from embiggen_tpu.models.registry import get_model_from_library

    graph = state["graph"]

    def model(epochs):
        return get_model_from_library(
            "Node2Vec SkipGram", task_name="Node Embedding"
        )(
            embedding_size=s.dim, walk_length=s.walk_length,
            window_size=s.window, number_of_negative_samples=s.negatives,
            batch_size=s.skipgram_batch, epochs=epochs, random_state=0,
        )

    # One epoch through embed_graph; the same seed for two epochs then
    # repeats that epoch, so its second epoch's mean loss shows the fall.
    one = model(1)
    emb = np.asarray(embed_graph(graph, one).node_embeddings[0])
    two = model(2)
    two.fit_transform(graph)
    first, second = one._last_loss, two._last_loss
    check(emb.shape == (graph.number_of_nodes, s.dim), f"embedding {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite embedding")
    check(bool(np.isfinite([first, second]).all()), "non-finite loss")
    check(second < first, f"loss did not fall: {first:.4f} -> {second:.4f}")
    return (
        f"embed_graph SkipGram: embedding {emb.shape}; mean loss of epoch 1 "
        f"{first:.4f}, of epoch 2 (same seed) {second:.4f}"
    )


# ------------------------------------------------------------------ phase 3
def phase_gcn(state, s: Sizes) -> str:
    from embiggen_tpu.models.gcn.edge import KipfGCNEdgePrediction

    graph = state["graph"]
    n = graph.number_of_nodes
    x = np.random.default_rng(0).standard_normal((n, s.dim), np.float32)
    state["features"] = x
    model = KipfGCNEdgePrediction(
        units=(s.dim, s.dim), batch_size=s.gcn_batch, epochs=2,
        dropout_rate=0.0, early_stopping_patience=10**6, random_state=0,
    )
    model.fit(graph, node_features=[x])
    k = int(model._kernels_coo[0].cols_pad.shape[1])
    epochs = list(model._epoch_seconds)
    rng = np.random.default_rng(1)
    src = rng.integers(0, n, s.pairs).astype(np.int32)
    dst = rng.integers(0, n, s.pairs).astype(np.int32)
    proba = np.asarray(model.predict_proba_from_edge_node_ids(src, dst))
    check(proba.shape == (s.pairs,), f"predict_proba shape {proba.shape}")
    check(bool(np.isfinite(proba).all()), "non-finite predictions")
    check(bool(((proba >= 0) & (proba <= 1)).all()), "probabilities out of [0, 1]")
    check(len(epochs) == 2, f"{len(epochs)} epochs ran")
    return (
        f"KipfGCNEdgePrediction: ELL width K={k}; epoch times "
        f"{epochs[0]:.1f} s and {epochs[1]:.1f} s, so the first epoch's "
        f"compilation took about {epochs[0] - epochs[1]:.1f} s; "
        f"predict_proba on {s.pairs} pairs finite in [0, 1]"
    )


# ------------------------------------------------------------------ phase 4
# 90% of the planted-partition edges join nodes of one community, so the
# community posterior alone puts test AUROC near 0.9; SkipGram features
# reach 0.90 at 2k and 20k nodes with these settings. A floor well below
# that catches features that carry no community signal.
MIN_TEST_AUROC = 0.75


def phase_holdout(state, s: Sizes) -> str:
    from embiggen_tpu.graph import (
        connected_holdout,
        planted_partition_edges,
        sample_negative_graph,
    )
    from embiggen_tpu.models.edge_prediction import PerceptronEdgePrediction
    from embiggen_tpu.models.embedders import SkipGram
    from embiggen_tpu.ops.metrics import all_binary_metrics

    graph = planted_partition_edges(s.eval_nodes, s.eval_edges, seed=0)
    train, test = connected_holdout(graph, train_size=0.8, random_state=42)
    features = SkipGram(
        embedding_size=s.eval_dim, epochs=s.eval_epochs, walk_length=16,
        window_size=2, number_of_negative_samples=5,
        learning_rate_decay=0.99, random_state=0,
        early_stopping_patience=10**6, learning_rate_plateau_patience=10**6,
    ).fit_transform(train).node_embeddings[0]
    model = PerceptronEdgePrediction(
        edge_features=["Degree"], edge_embeddings=["CosineSimilarity"],
        number_of_epochs=15, random_state=0,
    )
    model.fit(train, support=train, node_features=[np.asarray(features)])
    pos = np.asarray(model.predict_proba(test, support=train))
    negatives = sample_negative_graph(
        graph, number_of_negative_samples=test.number_of_edges,
        random_state=43, support=graph,
    )
    neg = np.asarray(model.predict_proba(negatives, support=train))
    labels = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    scores = np.concatenate([pos, neg])
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    m = all_binary_metrics(labels, scores)
    check(
        m["auroc"] >= MIN_TEST_AUROC,
        f"test AUROC {m['auroc']:.4f} < {MIN_TEST_AUROC}",
    )
    return (
        f"{graph.name}: {train.number_of_edges} train / "
        f"{test.number_of_edges} test edges, {len(neg)} negatives; "
        f"test AUROC {m['auroc']:.4f}, AUPRC {m['auprc']:.4f}"
    )


# ------------------------------------------------------------------ phase 5
def phase_references(state, s: Sizes):
    """Yields one line per comparison; raises after the last if any
    comparison held to its tolerance failed."""
    from embiggen_tpu.utils.reference_checks import (
        check_skipgram_band,
        check_spmm,
    )

    graph = state["graph"]
    comparisons = list(check_spmm(graph, state["features"]))
    band = dict(
        n_nodes=graph.number_of_nodes, batch=s.band_batch,
        walk_length=s.walk_length, window=s.window, dim=s.dim,
        negatives=s.negatives,
    )
    comparisons += check_skipgram_band(precision="highest", **band)
    comparisons += check_skipgram_band(precision="default", **band)
    for c in comparisons:
        yield c.line()
    failed = [c.name for c in comparisons if not c.ok]
    check(not failed, f"comparisons out of tolerance: {failed}")
    yield (
        f"{len(comparisons)} comparisons above; every one held to a "
        "tolerance is within it"
    )


# --------------------------------------------------------------- four cards
# A mesh fit and a one-card fit from the same seed sum the same terms in
# other orders: scatter-adds lower to atomics on a GPU, whose order changes
# from run to run even on one card, and the halo SpMM adds local and remote
# neighbours separately. Each rounding is ~1e-7 relative, but training
# compounds it (Adam's normalisation amplifies it most). So the one-card
# fit runs twice, and the mesh fit must agree with one card to within
# MESH_SPREAD_FACTOR times the spread between those two runs, and never
# needs to be closer than MESH_ATOL_PER_MAX * max|one-card result|.
MESH_SPREAD_FACTOR = 10.0
MESH_ATOL_PER_MAX = 1e-4


class MemoryWatch:
    """Samples the devices on a thread while a fit runs: every device's
    `bytes_in_use` (the allocator's own peak counter cannot be reset
    between fits), and the bytes each device holds of the live arrays of
    shape [>= `rows`, `cols`] made during the fit (when `rows` is given):
    a SkipGram fit's tables. Such arrays
    are read from their sharding, not their buffers. The split seen in
    the most samples is kept, the one that holds while the fit trains:
    before placement the tables sit whole on one device, and extraction
    may copy them once more before they go to the host."""

    def __init__(self, devices, rows=None, cols=None, period_s=0.01):
        import threading
        import weakref

        import jax

        self.devices = devices
        self.rows, self.cols = rows, cols
        self.period_s = period_s
        # arrays live before the fit, held weakly: an id reused by a new
        # array does not make it old
        self._old = {id(a): weakref.ref(a) for a in jax.live_arrays()}
        self.before = self._in_use()
        self.most = list(self.before)
        self._splits = collections.Counter()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _in_use(self):
        return [
            int((d.memory_stats() or {}).get("bytes_in_use", 0))
            for d in self.devices
        ]

    def _table_bytes(self):
        import jax

        per = dict.fromkeys(self.devices, 0)
        for a in jax.live_arrays():
            if a.ndim != 2 or a.shape[0] < self.rows or a.shape[1] != self.cols:
                continue
            old = self._old.get(id(a))
            if old is not None and old() is a:
                continue
            shard = a.sharding.shard_shape(a.shape)
            for d in a.sharding.device_set:
                if d in per:
                    per[d] += shard[0] * shard[1] * a.dtype.itemsize
        return [per[d] for d in self.devices]

    def _run(self):
        while not self._stop.wait(self.period_s):
            self.most = [max(a, b) for a, b in zip(self.most, self._in_use())]
            tables = self._table_bytes() if self.rows else []
            if any(tables):
                self._splits[tuple(tables)] += 1

    @property
    def tables(self):
        """Bytes per device of the fit's [N, D] arrays, in most samples."""
        if not self._splits:
            return [0] * len(self.devices)
        return list(self._splits.most_common(1)[0][0])

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.after = self._in_use()
        self.most = [max(a, b) for a, b in zip(self.most, self.after)]

    def line(self) -> str:
        def mib(values):
            return ", ".join(
                f"{d.id}: {v / 2**20:.1f}" for d, v in zip(self.devices, values)
            )

        tables = (
            f"[N, {self.cols}] arrays made by the fit, MiB per device in "
            f"most samples {mib(self.tables)}; " if self.rows else ""
        )
        return (
            f"{tables}bytes_in_use MiB per device before "
            f"{mib(self.before)}, most during {mib(self.most)}, after "
            f"{mib(self.after)}"
        )


def phase_four_cards(s: Sizes, n_cards: int = 4):
    """SkipGram (data-parallel and row-sharded) and the halo-SpMM Kipf GCN
    on `n_cards` devices against the same fits on one. Each mesh fit's
    line shows every card's memory in use, and SkipGram's how much of its
    two [N, D] tables every card held: a quarter each when row-sharded,
    all of them when data-parallel (977 MiB at N = 1M, D = 128, float32).
    The GCN keeps its sharded features and halo kernels on the cards after
    the fit."""
    import jax

    from embiggen_tpu.graph import erdos_renyi
    from embiggen_tpu.models.embedders import SkipGram
    from embiggen_tpu.models.gcn.edge import KipfGCNEdgePrediction
    from embiggen_tpu.utils.reference_checks import compare

    devices = jax.devices()
    check(len(devices) >= n_cards, f"{len(devices)} devices, need {n_cards}")
    graph = erdos_renyi(s.nodes, s.edges, seed=0)
    n = graph.number_of_nodes
    x = np.random.default_rng(0).standard_normal((n, s.dim), np.float32)
    rng = np.random.default_rng(1)
    src = rng.integers(0, n, s.pairs).astype(np.int32)
    dst = rng.integers(0, n, s.pairs).astype(np.int32)

    def skipgram(**kw):
        return np.asarray(SkipGram(
            embedding_size=s.dim, walk_length=s.walk_length,
            window_size=s.window, number_of_negative_samples=s.negatives,
            batch_size=s.skipgram_batch, epochs=1, random_state=0, **kw,
        ).fit_transform(graph).node_embeddings[0])

    def gcn(**kw):
        m = KipfGCNEdgePrediction(
            units=(s.dim, s.dim), batch_size=s.gcn_batch, epochs=2,
            dropout_rate=0.0, early_stopping_patience=10**6,
            random_state=0, **kw,
        )
        m.fit(graph, node_features=[x])
        return np.asarray(m.predict_proba_from_edge_node_ids(src, dst))

    runs = []
    fits = [
        (f"SkipGram mesh={n_cards} distribution={dist}",
         lambda dist=dist: skipgram(mesh=n_cards, distribution=dist))
        for dist in ("rows", "data")
    ]
    fits.append((f"KipfGCNEdgePrediction mesh={n_cards} predict_proba",
                 lambda: gcn(mesh=n_cards)))
    for (name, fit), tables in zip(fits, (True, True, False)):
        t0 = time.perf_counter()
        watch = MemoryWatch(devices[:n_cards], *((n, s.dim) if tables else ()))
        with watch:
            out = fit()
        runs.append((name, out, time.perf_counter() - t0, watch.line()))
    sg = (skipgram(), skipgram())
    gc = (gcn(), gcn())
    failed = []
    for (name, got, secs, mem), (want, again) in zip(runs, (sg, sg, gc)):
        spread = float(np.abs(want - again).max())
        atol = max(
            MESH_SPREAD_FACTOR * spread,
            MESH_ATOL_PER_MAX * float(np.abs(want).max()),
        )
        c = compare(f"{name} vs one card", got, want, 0.0, atol, "default")
        yield (
            f"{c.line()}; one-card run-to-run spread {spread:.3e}; "
            f"fit {secs:.1f} s (smoke time); {mem}"
        )
        if not c.ok:
            failed.append(name)
    check(not failed, f"mesh fits out of tolerance: {failed}")
    yield f"{len(runs)} mesh={n_cards} fits within tolerance of one card"


# ------------------------------------------------------------------- runner
def run(phases) -> None:
    """Run each phase; a phase returns its line, or yields several, the
    last of which becomes the phase line. Lines print as they arrive, so a
    failing phase still shows what it measured before it failed."""
    for label, fn in phases:
        t0 = time.perf_counter()
        out = fn()
        pending = None
        try:
            for line in [out] if isinstance(out, str) else out:
                if pending is not None:
                    print(f"  {pending}", flush=True)
                pending = line
        except BaseException:
            if pending is not None:
                print(f"  {pending}", flush=True)
            raise
        secs = time.perf_counter() - t0
        print(f"phase {label}: {pending} [smoke time {secs:.1f} s]",
              flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the mesh=4 fits and the one-card fits they are "
             "compared with (needs four GPUs)",
    )
    args = parser.parse_args(argv)
    s = FULL
    state: dict = {}
    phases = [("0 environment", lambda: phase_environment(state))]
    if args.four_cards:
        phases.append(
            ("four cards", lambda: phase_four_cards(s, n_cards=4))
        )
    else:
        phases += [
            ("1 graph and walks", lambda: phase_walks(state, s)),
            ("2 SkipGram", lambda: phase_skipgram(state, s)),
            ("3 GCN edge prediction", lambda: phase_gcn(state, s)),
            ("4 holdout", lambda: phase_holdout(state, s)),
            ("5 references", lambda: phase_references(state, s)),
        ]
    run(phases)
    print(json.dumps({"ok": True, "device": state["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
