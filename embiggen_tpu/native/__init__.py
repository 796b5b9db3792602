"""Native (C++) host components, loaded via ctypes. The library is not
shipped: it is compiled (g++ -O3 -march=native) from the sources beside
this file on first use, on the host that runs it, and rebuilt when a
source is newer. Falls back to the pure-Python paths when no compiler is
available; `get_lib()` returning None says so."""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(__file__)
_LIB_PATH = os.path.join(_HERE, "libembiggen_native.so")
_lib = None


class _ParsedEdgeList(ctypes.Structure):
    _fields_ = [
        ("n_edges", ctypes.c_int64),
        ("n_nodes", ctypes.c_int64),
        ("n_edge_types", ctypes.c_int64),
        ("sources", ctypes.POINTER(ctypes.c_int32)),
        ("destinations", ctypes.POINTER(ctypes.c_int32)),
        ("weights", ctypes.POINTER(ctypes.c_float)),
        ("edge_types", ctypes.POINTER(ctypes.c_int32)),
        ("node_names", ctypes.c_char_p),
        ("node_names_len", ctypes.c_int64),
        ("edge_type_names", ctypes.c_char_p),
        ("edge_type_names_len", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
    ]


_SOURCES = ("edge_list_parser.cpp", "graph_algos.cpp")


def _stale() -> bool:
    return not os.path.exists(_LIB_PATH) or any(
        os.path.getmtime(_LIB_PATH)
        < os.path.getmtime(os.path.join(_HERE, s))
        for s in _SOURCES
    )


def _build() -> bool:
    """Compile the library. Concurrent processes (e.g. test workers) take
    an exclusive lock; the first builds into a temporary file renamed into
    place, so no process ever loads a half-written library."""
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        with open(_LIB_PATH + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stale():
                return True
            subprocess.run(
                [
                    "g++", "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", *srcs, "-o", tmp, "-lpthread",
                ],
                check=True,
                capture_output=True,
                timeout=300,
            )
            os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.parse_edge_list.restype = ctypes.POINTER(_ParsedEdgeList)
    lib.parse_edge_list.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.free_parsed_edge_list.argtypes = [ctypes.POINTER(_ParsedEdgeList)]
    lib.build_alias_tables.restype = None
    lib.build_alias_tables.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.connected_components.restype = ctypes.c_int64
    lib.connected_components.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.random_walks_cpu.restype = None
    lib.random_walks_cpu.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.skipgram_train_cpu.restype = None
    lib.skipgram_train_cpu.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.ell_relayout.restype = None
    lib.ell_relayout.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.arc_hash_build.restype = None
    lib.arc_hash_build.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
    ]
    lib.arc_hash_contains.restype = None
    lib.arc_hash_contains.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.ranking_metrics_sorted.restype = None
    lib.ranking_metrics_sorted.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.spanning_forest.restype = None
    lib.spanning_forest.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.counting_sort_pairs.restype = None
    lib.counting_sort_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sort_unique_pairs.restype = ctypes.c_int64
    lib.sort_unique_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.radix_argsort_u64.restype = None
    lib.radix_argsort_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.dag_mica_block.restype = None
    lib.dag_mica_block.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    lib.build_sym_csr.restype = ctypes.c_int64
    lib.build_sym_csr.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def alias_tables(row_ptr: np.ndarray, weights: np.ndarray):
    """Native Walker alias-table construction over all CSR rows at once.
    Returns (prob[E] f32, alias[E] int32) or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    e = weights.shape[0]
    prob = np.empty(e, dtype=np.float32)
    alias = np.empty(e, dtype=np.int32)
    lib.build_alias_tables(
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(row_ptr.shape[0] - 1),
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(e),
        prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        alias.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return prob, alias


def ell_relayout(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_out: int,
    k: int,
    n_overflow: int,
):
    """Native single-K ELLPACK relayout (see graph_algos.cpp::ell_relayout).
    Returns (cols_pad [n_out, k], vals_pad, ov_rows, ov_cols, ov_vals,
    absw, sqw) or None if the lib is unavailable. Accepts UNSORTED COO —
    the counting-sort pass replaces the argsort the numpy path needs for
    transposed kernels."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    e = rows.shape[0]
    cp = np.empty((n_out, k), np.int32)
    vp = np.empty((n_out, k), np.float32)
    ovr = np.empty(n_overflow, np.int32)
    ovc = np.empty(n_overflow, np.int32)
    ovv = np.empty(n_overflow, np.float32)
    absw = np.empty(n_out, np.float32)
    sqw = np.empty(n_out, np.float32)
    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    as_f32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.ell_relayout(
        as_i32(rows), as_i32(cols), as_f32(vals),
        ctypes.c_int64(e), ctypes.c_int64(n_out), ctypes.c_int64(k),
        as_i32(cp), as_f32(vp),
        as_i32(ovr), as_i32(ovc), as_f32(ovv),
        as_f32(absw), as_f32(sqw),
    )
    return cp, vp, ovr, ovc, ovv, absw, sqw


def arc_hash_build(keys: np.ndarray):
    """Open-addressing hash table over encoded arc keys (uint64).
    Returns the table array (power-of-two size >= 2*len) or None."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = keys.shape[0]
    size = 1
    while size < max(2 * n, 16):
        size <<= 1
    table = np.empty(size, dtype=np.uint64)
    lib.arc_hash_build(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(n),
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(size),
    )
    return table


def arc_hash_contains(table: np.ndarray, queries: np.ndarray):
    """bool[m] membership of `queries` in a table from `arc_hash_build`,
    threaded. Returns None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, dtype=np.uint64)
    out = np.empty(queries.shape[0], dtype=np.uint8)
    lib.arc_hash_contains(
        table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(table.shape[0]),
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(queries.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        0,
    )
    return out.astype(bool)


def ranking_metrics_sorted(scores_asc: np.ndarray, labels_asc: np.ndarray):
    """(auroc, auprc) from score-ascending-sorted float64 scores and uint8
    labels, or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    scores_asc = np.ascontiguousarray(scores_asc, dtype=np.float64)
    labels_asc = np.ascontiguousarray(labels_asc, dtype=np.uint8)
    auroc = ctypes.c_double()
    auprc = ctypes.c_double()
    lib.ranking_metrics_sorted(
        scores_asc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels_asc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(scores_asc.shape[0]),
        ctypes.byref(auroc), ctypes.byref(auprc),
    )
    return float(auroc.value), float(auprc.value)


def spanning_forest(
    src: np.ndarray, dst: np.ndarray, order: np.ndarray, n_nodes: int
):
    """bool[m] mask of edges joining the union-find forest when processed
    in `order`. Returns None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    out = np.empty(src.shape[0], dtype=np.uint8)
    lib.spanning_forest(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(src.shape[0]),
        ctypes.c_int64(int(n_nodes)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.astype(bool)


def sort_pairs(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Stable lexicographic argsort of (src, dst) id pairs via two
    counting-sort passes — the COO→CSR sort. Returns int64[e] or None."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    order = np.empty(src.shape[0], dtype=np.int64)
    lib.counting_sort_pairs(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(src.shape[0]),
        ctypes.c_int64(int(n_nodes)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order


def sort_unique_pairs(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Original indices of the first occurrence of each distinct (src, dst)
    pair, in sorted pair order (fused counting sort + adjacent-run dedup).
    Returns int64[k] or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    first = np.empty(src.shape[0], dtype=np.int64)
    k = lib.sort_unique_pairs(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(src.shape[0]),
        ctypes.c_int64(int(n_nodes)),
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return first[:k].copy()


def build_sym_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Fused symmetrize + per-row sort + dedup CSR build for unweighted,
    untyped undirected graphs (the negative-sample / generator hot path).
    Returns (row_ptr int64[N+1], col_idx int32[arcs]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n_pairs = src.shape[0]
    row_ptr = np.empty(n_nodes + 1, dtype=np.int64)
    col_idx = np.empty(max(2 * n_pairs, 1), dtype=np.int32)
    n_arcs = lib.build_sym_csr(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n_pairs),
        ctypes.c_int64(int(n_nodes)),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return row_ptr, col_idx[:n_arcs].copy()


def radix_argsort(keys: np.ndarray):
    """Stable argsort of non-negative int64/uint64 keys via LSD radix
    (skips constant-byte passes). Returns int64[n] order or None."""
    lib = get_lib()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    order = np.empty(keys.shape[0], dtype=np.int64)
    lib.radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(keys.shape[0]),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order


def native_connected_components(
    sources: np.ndarray, destinations: np.ndarray, n_nodes: int
):
    """Union-find components over an arc list. Returns (comp[N] int32,
    n_components) or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(sources, dtype=np.int32)
    dst = np.ascontiguousarray(destinations, dtype=np.int32)
    comp = np.empty(n_nodes, dtype=np.int32)
    n = lib.connected_components(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(src.shape[0]),
        ctypes.c_int64(n_nodes),
        comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return comp, int(n)


def parse_edge_list(
    path: str,
    sep: str = "\t",
    skip_header: bool = True,
    src_col: int = 0,
    dst_col: int = 1,
    weight_col: int = -1,
    type_col: int = -1,
):
    """Returns (src, dst, weights|None, edge_types|None, node_names,
    edge_type_names|None) or None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = lib.parse_edge_list(
        path.encode(), sep.encode(), int(skip_header),
        src_col, dst_col, weight_col, type_col,
    )
    try:
        p = ptr.contents
        if p.error and p.error != b"":
            raise IOError(p.error.decode())
        e = p.n_edges
        src = np.ctypeslib.as_array(p.sources, shape=(e,)).copy()
        dst = np.ctypeslib.as_array(p.destinations, shape=(e,)).copy()
        weights = (
            np.ctypeslib.as_array(p.weights, shape=(e,)).copy()
            if weight_col >= 0
            else None
        )
        edge_types = (
            np.ctypeslib.as_array(p.edge_types, shape=(e,)).copy()
            if type_col >= 0
            else None
        )
        node_names = np.asarray(
            ctypes.string_at(p.node_names, p.node_names_len)
            .decode()
            .split("\n")[:-1],
            dtype=object,
        )
        edge_type_names = (
            np.asarray(
                ctypes.string_at(p.edge_type_names, p.edge_type_names_len)
                .decode()
                .split("\n")[:-1],
                dtype=object,
            )
            if type_col >= 0
            else None
        )
        return src, dst, weights, edge_types, node_names, edge_type_names
    finally:
        lib.free_parsed_edge_list(ptr)


def native_random_walks(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    starts: np.ndarray,
    length: int,
    return_weight: float = 1.0,
    explore_weight: float = 1.0,
    seed: int = 0,
    n_threads: Optional[int] = None,
):
    """Multithreaded CPU walk kernel (GRAPE-Rust-class baseline for bench).
    Returns [batch, length] int32 walks or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    batch = starts.shape[0]
    out = np.empty((batch, length), dtype=np.int32)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.random_walks_cpu(
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(row_ptr.shape[0] - 1),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(batch),
        ctypes.c_int64(length),
        ctypes.c_double(return_weight),
        ctypes.c_double(explore_weight),
        ctypes.c_uint64(seed),
        ctypes.c_int(int(n_threads)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def native_skipgram_train(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    batch: int,
    length: int,
    window: int,
    n_negatives: int,
    dim: int,
    lr: float = 0.05,
    seed: int = 0,
    n_threads: Optional[int] = None,
    emb: Optional[np.ndarray] = None,
    ctx: Optional[np.ndarray] = None,
):
    """Threaded hogwild CPU SkipGram trainer (walks + negatives + SGD on f32
    tables) — the whole-trainer baseline standing in for GRAPE's Rust
    `ensmallen.models.SkipGram.fit_transform` (reference
    `ensmallen_embedders/node2vec.py:93-112`). Mutates/returns (emb, ctx)
    or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    n_nodes = row_ptr.shape[0] - 1
    rng = np.random.default_rng(seed)
    if emb is None:
        emb = (rng.random((n_nodes, dim), dtype=np.float32) - 0.5) / dim
    if ctx is None:
        ctx = np.zeros((n_nodes, dim), dtype=np.float32)
    emb = np.ascontiguousarray(emb, dtype=np.float32)
    ctx = np.ascontiguousarray(ctx, dtype=np.float32)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.skipgram_train_cpu(
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        col_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n_nodes),
        ctypes.c_int64(col_idx.shape[0]),
        ctypes.c_int64(batch),
        ctypes.c_int64(length),
        ctypes.c_int64(window),
        ctypes.c_int64(n_negatives),
        ctypes.c_int64(dim),
        ctypes.c_float(lr),
        ctypes.c_uint64(seed),
        ctypes.c_int(int(n_threads)),
        emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctx.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return emb, ctx


def dag_mica_block(
    indptr: np.ndarray,
    ranks: np.ndarray,
    ic_by_rank: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    n_threads: Optional[int] = None,
):
    """Threaded MICA-IC block query over a rank-sorted CSR ancestor closure
    (see DAGResnik CSR path in `similarities.py`). Returns [|src|, |dst|]
    float64 or None if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    ranks = np.ascontiguousarray(ranks, dtype=np.int32)
    ic_by_rank = np.ascontiguousarray(ic_by_rank, dtype=np.float64)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    out = np.empty((src.shape[0], dst.shape[0]), dtype=np.float64)
    if n_threads is None:
        n_threads = os.cpu_count() or 1
    lib.dag_mica_block(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ranks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ic_by_rank.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(src.shape[0]),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(dst.shape[0]),
        ctypes.c_int(int(n_threads)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
