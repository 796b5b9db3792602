"""Matrix-factorization / sketching embedder family — the native
counterpart of the reference's KarateClub adapter surface
(`embiggen/embedders/karateclub_embedders/{netmf,grarep,boostne,randne,
node_sketch,mnmf,nmfadmm,nnsed,role2vec}.py`; the remaining KarateClub
wrappers — DeepWalk/SkipGram/Walklets/HOPE/LaplacianEigenmaps/GLEE/SocioDim
— are already covered by the native walk-based and spectral families).

Design: these models are dense-linear-algebra shaped (matrix powers, log
filters, truncated factorizations), which maps directly onto dense
matrix products — the heavy matmuls run in jnp on device; truncated SVDs use randomized SVD on
host (as KarateClub itself does via sklearn)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ...graph.graph import Graph
from ..abstract import AbstractEmbeddingModel
from ..embedding_result import EmbeddingResult
from ..registry import register_model
from .walk_based import WalkBasedEmbedder

# Dense n x n intermediates cap (KarateClub's own algorithms are dense too).
DENSE_NODE_LIMIT = 32_768


def _check_dense_ok(graph: Graph, model_name: str):
    if graph.number_of_nodes > DENSE_NODE_LIMIT:
        raise ValueError(
            f"{model_name} materializes dense n x n matrices; graph "
            f"{graph.name} has {graph.number_of_nodes} nodes "
            f"(limit {DENSE_NODE_LIMIT}). Use a walk-based or LINE-family "
            "embedder at this scale."
        )


def _dense_adjacency(graph: Graph) -> np.ndarray:
    n = graph.number_of_nodes
    a = np.zeros((n, n), np.float32)
    a[graph.sources, graph.col_idx] = (
        graph.weights if graph.has_edge_weights else 1.0
    )
    return a


def _row_normalized(a: np.ndarray) -> np.ndarray:
    deg = a.sum(axis=1, keepdims=True)
    return a / np.maximum(deg, 1e-12)


def _randomized_svd(mat: np.ndarray, k: int, n_iter: int, seed: int):
    from sklearn.utils.extmath import randomized_svd

    k = min(k, min(mat.shape) - 1) if min(mat.shape) > 1 else 1
    u, s, vt = randomized_svd(
        mat, n_components=k, n_iter=n_iter, random_state=seed
    )
    return u, s, vt


def _svd_embedding(mat: np.ndarray, k: int, n_iter: int, seed: int):
    u, s, _ = _randomized_svd(mat, k, n_iter, seed)
    emb = u * np.sqrt(np.maximum(s, 0.0))
    if emb.shape[1] < k:  # degenerate tiny graphs: pad to the contract
        emb = np.pad(emb, ((0, 0), (0, k - emb.shape[1])))
    return emb.astype(np.float32)


class _FactorizationModel(AbstractEmbeddingModel):
    """Shared bits: deterministic unless stated, embedding contract."""

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4}

    def _wrap(self, emb: np.ndarray, graph: Graph) -> EmbeddingResult:
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[np.asarray(emb, np.float32)],
            node_names=graph.get_node_names(),
        )


@register_model
class NetMF(_FactorizationModel):
    """DeepWalk-matrix factorization: SVD of
    log max(vol/(T b) * sum_{r<=T} P^r D^-1, 1)
    (reference `karateclub_embedders/netmf.py:81`; NetMF paper). The matrix
    power accumulation runs as dense matmuls on device."""

    def __init__(
        self,
        embedding_size: int = 100,
        iteration: int = 10,
        order: int = 2,
        negative_samples: int = 1,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._iteration = iteration
        self._order = order
        self._negative_samples = negative_samples
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "NetMF"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iteration": self._iteration,
            "order": self._order,
            "negative_samples": self._negative_samples,
        }

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        _check_dense_ok(graph, self.model_name())
        a = _dense_adjacency(graph)
        vol = float(a.sum())
        deg = np.maximum(a.sum(axis=1), 1e-12)

        @jax.jit
        def power_sum(a_dev, inv_deg):
            p = a_dev * inv_deg[:, None]  # D^-1 A

            def body(carry, _):
                acc, cur = carry
                cur = cur @ p
                return (acc + cur, cur), None

            eye = jnp.eye(a_dev.shape[0], dtype=jnp.float32)
            (acc, _), _ = jax.lax.scan(
                body, (jnp.zeros_like(p), eye), None, length=self._order
            )
            return acc * inv_deg[None, :]

        s = np.asarray(power_sum(jnp.asarray(a), jnp.asarray(1.0 / deg)))
        m = s * (vol / (self._order * max(self._negative_samples, 1)))
        target = np.log(np.maximum(m, 1.0))
        emb = _svd_embedding(
            target, self.embedding_size, self._iteration,
            self.random_state or 0,
        )
        return self._wrap(emb, graph)


@register_model
class GraRep(_FactorizationModel):
    """Concatenated per-order SVDs of log-filtered transition-matrix powers
    (reference `karateclub_embedders/grarep.py:75`; GraRep paper). Each of
    the `order` blocks gets embedding_size // order dimensions."""

    def __init__(
        self,
        embedding_size: int = 100,
        iteration: int = 10,
        order: int = 5,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        if embedding_size % order:
            raise ValueError(
                f"GraRep concatenates {order} per-order blocks; "
                f"embedding_size ({embedding_size}) must be divisible by "
                f"order ({order})."
            )
        self._iteration = iteration
        self._order = order
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "GraRep"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iteration": self._iteration,
            "order": self._order,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "order": 2}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        _check_dense_ok(graph, self.model_name())
        a = _dense_adjacency(graph)
        n = graph.number_of_nodes
        p = jnp.asarray(_row_normalized(a))
        per_block = self.embedding_size // self._order
        blocks: List[np.ndarray] = []
        cur = p
        matmul = jax.jit(lambda x, y: x @ y)
        for k in range(self._order):
            if k > 0:
                cur = matmul(cur, p)
            target = np.log(np.maximum(np.asarray(cur) * n, 1.0))
            blocks.append(
                _svd_embedding(
                    target, per_block, self._iteration,
                    (self.random_state or 0) + k,
                )
            )
        return self._wrap(np.concatenate(blocks, axis=1), graph)


@register_model
class BoostNE(_FactorizationModel):
    """Gradient-boosted NMF: successive non-negative factorizations of the
    residual target matrix, blocks concatenated (reference
    `karateclub_embedders/boostne.py:81`; BoostNE paper)."""

    def __init__(
        self,
        embedding_size: int = 100,
        iterations: int = 16,
        order: int = 2,
        alpha: float = 0.01,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        if embedding_size % (iterations + 1):
            raise ValueError(
                f"BoostNE concatenates iterations+1 = {iterations + 1} "
                f"blocks; embedding_size ({embedding_size}) must be "
                "divisible by it."
            )
        self._iterations = iterations
        self._order = order
        self._alpha = alpha
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "BoostNE"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "order": self._order,
            "alpha": self._alpha,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 1, "order": 1}

    @staticmethod
    def _nmf(target: jnp.ndarray, k: int, key, inner_iters: int = 30):
        """Multiplicative-update NMF on device."""
        n, m = target.shape
        k1, k2 = jax.random.split(key)
        w = jax.random.uniform(k1, (n, k), jnp.float32, 0.01, 1.0)
        h = jax.random.uniform(k2, (k, m), jnp.float32, 0.01, 1.0)

        def body(carry, _):
            w, h = carry
            h = h * (w.T @ target) / jnp.maximum(w.T @ w @ h, 1e-9)
            w = w * (target @ h.T) / jnp.maximum(w @ h @ h.T, 1e-9)
            return (w, h), None

        (w, h), _ = jax.lax.scan(body, (w, h), None, length=inner_iters)
        return w, h

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        _check_dense_ok(graph, self.model_name())
        a = _dense_adjacency(graph)
        p = jnp.asarray(_row_normalized(a))
        # base target: mean of transition powers 1..order
        cur, acc = p, p
        for _ in range(self._order - 1):
            cur = cur @ p
            acc = acc + cur
        target = acc / self._order
        per_block = self.embedding_size // (self._iterations + 1)
        key = jax.random.PRNGKey(self.random_state or 0)
        nmf = jax.jit(
            lambda t, k: self._nmf(t, per_block, k)
        )
        blocks = []
        residual = target
        for i in range(self._iterations + 1):
            w, h = nmf(residual, jax.random.fold_in(key, i))
            blocks.append(np.asarray(w))
            residual = jnp.maximum(residual - w @ h, 0.0)
        return self._wrap(np.concatenate(blocks, axis=1), graph)


@register_model
class RandNE(_FactorizationModel):
    """Iterative Gaussian random projection smoothing:
    emb = sum_l alpha_l (D^-1 A)^l R — pure matmuls, fully on device
    (reference `karateclub_embedders/randne.py:60`; RandNE paper)."""

    def __init__(
        self,
        embedding_size: int = 100,
        alphas: Sequence[float] = (0.5, 0.5),
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._alphas = tuple(float(x) for x in alphas)
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "RandNE"

    def parameters(self) -> Dict[str, Any]:
        return {**super().parameters(), "alphas": self._alphas}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        # Sparse-friendly: uses SpMM-style gather instead of dense n x n
        # when the graph is large; dense matmul otherwise.
        n, d = graph.number_of_nodes, self.embedding_size
        key = jax.random.PRNGKey(self.random_state or 0)
        base = jax.random.normal(key, (n, d), jnp.float32) / np.sqrt(d)
        src = jnp.asarray(graph.sources.astype(np.int32))
        dst = jnp.asarray(graph.col_idx.astype(np.int32))
        inv_deg = jnp.asarray(
            1.0 / np.maximum(graph.degrees, 1).astype(np.float32)
        )
        alphas = jnp.asarray(self._alphas, jnp.float32)

        # Edge arrays as jit ARGUMENTS, not closures (closure capture lowers
        # them as inline HLO constants — hundreds of MB at bench scale).
        @jax.jit
        def smooth(base, src, dst, inv_deg, alphas):
            def body(carry, alpha):
                cur, acc = carry
                gathered = cur[dst]
                nxt = (
                    jax.ops.segment_sum(gathered, src, num_segments=n)
                    * inv_deg[:, None]
                )
                return (nxt, acc + alpha * nxt), None

            (_, acc), _ = jax.lax.scan(
                body, (base, jnp.zeros_like(base)), alphas
            )
            return acc

        return self._wrap(
            np.asarray(smooth(base, src, dst, inv_deg, alphas)), graph
        )


@register_model
class NodeSketch(_FactorizationModel):
    """Recursive min-hash sketches of the self-loop-augmented adjacency:
    each iteration merges a node's sketch with its neighbours' via an
    exponential race weighted by `decay` (reference
    `karateclub_embedders/node_sketch.py:75`; NodeSketch paper). The
    embedding is the (categorical) sketch matrix, as in KarateClub."""

    def __init__(
        self,
        embedding_size: int = 100,
        iterations: int = 10,
        decay: float = 0.01,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._iterations = iterations
        self._decay = decay
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "NodeSketch"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "decay": self._decay,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 2}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        n, d = graph.number_of_nodes, self.embedding_size
        key = jax.random.PRNGKey(self.random_state or 0)
        src = jnp.asarray(graph.sources.astype(np.int32))
        dst = jnp.asarray(graph.col_idx.astype(np.int32))

        # initial sketch: per-(node, dim) exponential race over self-loops
        race0 = jax.random.exponential(key, (n, d), jnp.float32)
        sketch = jnp.tile(jnp.arange(n, dtype=jnp.int32)[:, None], (1, d))
        decay = jnp.float32(self._decay)

        @jax.jit
        def run(sketch, race0):
            def body(carry, it_key):
                sketch, race = carry
                # candidate races from neighbours, decayed
                noise = jax.random.exponential(it_key, race.shape)
                cand_race = race[dst] / decay + noise[dst]
                # per-target min over incoming edges
                best = jax.ops.segment_min(cand_race, src, num_segments=n)
                improved = best < race
                # which neighbour achieved the min: recover via argmin trick
                winner_val = best[src]
                is_winner = cand_race <= winner_val + 1e-30
                cand_sketch = jnp.where(
                    is_winner, sketch[dst], jnp.iinfo(jnp.int32).max
                )
                winner_sketch = jax.ops.segment_min(
                    cand_sketch, src, num_segments=n
                )
                sketch = jnp.where(improved, winner_sketch, sketch)
                race = jnp.minimum(race, best)
                return (sketch, race), None

            keys = jax.random.split(
                jax.random.PRNGKey(1), self._iterations
            )
            (sketch, _), _ = jax.lax.scan(body, (sketch, race0), keys)
            return sketch

        out = np.asarray(run(sketch, race0), np.float32)
        return self._wrap(out, graph)


@register_model
class MNMF(_FactorizationModel):
    """Community-preserving NMF: joint factorization A ~ M U^T with a
    community factor H tied to U by a cluster matrix C and regularized by
    modularity (reference `karateclub_embedders/mnmf.py:105`; M-NMF paper).
    Multiplicative updates run as dense matmuls on device."""

    def __init__(
        self,
        embedding_size: int = 128,
        clusters: int = 10,
        lambd: float = 0.2,
        alpha: float = 0.05,
        beta: float = 0.05,
        iterations: int = 200,
        lower_control: float = 1e-15,
        eta: float = 5.0,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._clusters = clusters
        self._lambd = lambd
        self._alpha = alpha
        self._beta = beta
        self._iterations = iterations
        self._lower_control = lower_control
        self._eta = eta
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "MNMF"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "clusters": self._clusters,
            "lambd": self._lambd,
            "alpha": self._alpha,
            "beta": self._beta,
            "iterations": self._iterations,
            "lower_control": self._lower_control,
            "eta": self._eta,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "clusters": 2, "iterations": 10}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        _check_dense_ok(graph, self.model_name())
        n, d, k = (
            graph.number_of_nodes, self.embedding_size, self._clusters,
        )
        a = jnp.asarray(_dense_adjacency(graph))
        deg = a.sum(axis=1)
        two_m = jnp.maximum(deg.sum(), 1.0)
        # S = first-order + eta * cosine second-order proximity
        norm = jnp.maximum(jnp.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        s2 = (a / norm) @ (a / norm).T
        s = a + self._eta * s2
        b_mod = a - jnp.outer(deg, deg) / two_m  # modularity matrix
        key = jax.random.PRNGKey(self.random_state or 0)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        m = jax.random.uniform(k1, (n, d), jnp.float32, 0.01, 1.0)
        u = jax.random.uniform(k2, (n, d), jnp.float32, 0.01, 1.0)
        h = jax.random.uniform(k3, (n, k), jnp.float32, 0.01, 1.0)
        c = jax.random.uniform(k4, (k, d), jnp.float32, 0.01, 1.0)
        lo = jnp.float32(self._lower_control)
        al, be, lam = (
            jnp.float32(self._alpha), jnp.float32(self._beta),
            jnp.float32(self._lambd),
        )

        @jax.jit
        def run(m, u, h, c):
            def body(carry, _):
                m, u, h, c = carry
                m = m * (s @ u) / jnp.maximum(m @ (u.T @ u), lo)
                num_u = s.T @ m + al * (h @ c)
                den_u = u @ (m.T @ m + al * (c.T @ c))
                u = u * num_u / jnp.maximum(den_u, lo)
                c = c * (h.T @ u) / jnp.maximum(c @ (u.T @ u), lo)
                # H update with modularity term (M-NMF eq. 9, with the
                # positive/negative split of B)
                b_pos = jnp.maximum(b_mod, 0.0)
                b_neg = jnp.maximum(-b_mod, 0.0)
                num_h = be * (b_pos @ h) + lam * (u @ c.T)
                den_h = (
                    be * (b_neg @ h)
                    + lam * h @ (c @ c.T)
                    + 2.0 * lam * h * (h * h).sum()  # orthogonality pressure
                )
                h = h * jnp.sqrt(
                    num_h / jnp.maximum(den_h, lo)
                )
                h = jnp.maximum(h, lo)
                return (m, u, h, c), None

            (m, u, h, c), _ = jax.lax.scan(
                body, (m, u, h, c), None, length=self._iterations
            )
            return u

        return self._wrap(np.asarray(run(m, u, h, c)), graph)


@register_model
class NMFADMM(_FactorizationModel):
    """ADMM-split non-negative matrix factorization of the row-normalized
    adjacency (reference `karateclub_embedders/nmfadmm.py:75`; Sun &
    Fevotte ADMM-NMF). The least-squares solves and projections run on
    device inside one scan."""

    def __init__(
        self,
        embedding_size: int = 100,
        iterations: int = 100,
        rho: float = 1.0,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._iterations = iterations
        self._rho = rho
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "NMFADMM"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "rho": self._rho,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 10}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        _check_dense_ok(graph, self.model_name())
        n, d = graph.number_of_nodes, self.embedding_size
        x = jnp.asarray(_row_normalized(_dense_adjacency(graph)))
        key = jax.random.PRNGKey(self.random_state or 0)
        k1, k2 = jax.random.split(key)
        w = jax.random.uniform(k1, (n, d), jnp.float32, 0.01, 1.0)
        h = jax.random.uniform(k2, (d, n), jnp.float32, 0.01, 1.0)
        rho = jnp.float32(self._rho)
        eye = jnp.eye(d, dtype=jnp.float32)

        @jax.jit
        def run(w, h):
            w_plus, h_plus = w, h
            dual_w = jnp.zeros_like(w)
            dual_h = jnp.zeros_like(h)

            def body(carry, _):
                w, h, w_plus, h_plus, dual_w, dual_h = carry
                # W least squares: (H H^T + rho I) W^T = H X^T + rho(W+ - dualW)^T
                gram_h = h @ h.T + rho * eye
                rhs_w = h @ x.T + rho * (w_plus - dual_w).T
                w = jnp.linalg.solve(gram_h, rhs_w).T
                gram_w = w.T @ w + rho * eye
                rhs_h = w.T @ x + rho * (h_plus - dual_h)
                h = jnp.linalg.solve(gram_w, rhs_h)
                w_plus = jnp.maximum(w + dual_w, 0.0)
                h_plus = jnp.maximum(h + dual_h, 0.0)
                dual_w = dual_w + w - w_plus
                dual_h = dual_h + h - h_plus
                return (w, h, w_plus, h_plus, dual_w, dual_h), None

            carry, _ = jax.lax.scan(
                body, (w, h, w_plus, h_plus, dual_w, dual_h), None,
                length=self._iterations,
            )
            return carry[2]  # W_plus: the non-negative basis

        return self._wrap(np.asarray(run(w, h)), graph)


@register_model
class NNSED(_FactorizationModel):
    """Non-negative symmetric encoder-decoder: A ~ W Z with the code
    Z = max(W^T A, 0) re-derived each step (reference
    `karateclub_embedders/nnsed.py:73`; NNSED paper). Embedding = Z^T."""

    def __init__(
        self,
        embedding_size: int = 32,
        iterations: int = 10,
        noise: float = 1e-6,
        random_state: int = 42,
        enable_cache: bool = False,
    ):
        self._iterations = iterations
        self._noise = noise
        super().__init__(
            embedding_size=embedding_size, enable_cache=enable_cache,
            random_state=random_state,
        )

    @classmethod
    def model_name(cls) -> str:
        return "NNSED"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "iterations": self._iterations,
            "noise": self._noise,
        }

    @classmethod
    def smoke_test_parameters(cls) -> Dict[str, Any]:
        return {"embedding_size": 4, "iterations": 3}

    def _fit_transform(self, graph: Graph) -> EmbeddingResult:
        _check_dense_ok(graph, self.model_name())
        n, d = graph.number_of_nodes, self.embedding_size
        a = jnp.asarray(_dense_adjacency(graph))
        key = jax.random.PRNGKey(self.random_state or 0)
        w = jax.random.uniform(key, (n, d), jnp.float32, 0.01, 1.0)
        noise = jnp.float32(self._noise)

        @jax.jit
        def run(w):
            def body(w, _):
                z = jnp.maximum(w.T @ a, 0.0)  # encoder code (d, n)
                num = a @ z.T
                den = w @ (z @ z.T) + noise
                w = w * num / jnp.maximum(den, noise)
                return w, None

            w, _ = jax.lax.scan(body, w, None, length=self._iterations)
            z = jnp.maximum(w.T @ a, 0.0)
            return z.T

        return self._wrap(np.asarray(run(w)), graph)


@register_model
class Role2Vec(WalkBasedEmbedder):
    """Structural-role embeddings: random walks are generated on device
    (the same node2vec kernel as SkipGram), but each context node is
    replaced by its Weisfeiler-Lehman structural role id; nodes are trained
    to predict the roles around them with a sigmoid-NCE objective
    (reference `karateclub_embedders/role2vec.py:123`; Role2Vec paper's
    attributed-walk factorization, with WL-hashed degree features as the
    attribute function)."""

    def __init__(
        self,
        embedding_size: int = 100,
        weisfeiler_lehman_hashing_iterations: int = 2,
        erase_base_features: bool = False,
        **kwargs,
    ):
        self._wl_iterations = weisfeiler_lehman_hashing_iterations
        self._erase_base_features = erase_base_features
        super().__init__(embedding_size=embedding_size, **kwargs)

    @classmethod
    def model_name(cls) -> str:
        return "Role2Vec"

    def parameters(self) -> Dict[str, Any]:
        return {
            **super().parameters(),
            "weisfeiler_lehman_hashing_iterations": self._wl_iterations,
            "erase_base_features": self._erase_base_features,
        }

    def _wl_roles(self, graph: Graph) -> np.ndarray:
        """Compact structural role id per node: log-degree bins refined by
        WL iterations with a commutative multiset hash."""
        n = graph.number_of_nodes
        row_ptr, col_idx = graph.row_ptr, graph.col_idx
        labels = np.floor(
            np.log2(np.maximum(graph.degrees, 1))
        ).astype(np.int64)
        base = labels.copy()
        rng = np.random.default_rng(7)
        for _ in range(self._wl_iterations):
            _, labels = np.unique(labels, return_inverse=True)
            salt = rng.integers(1, 2**62, labels.max() + 1)
            hashed = salt[labels]
            neigh_sum = np.zeros(n, np.int64)
            np.add.at(
                neigh_sum,
                np.repeat(np.arange(n), np.diff(row_ptr)),
                hashed[col_idx],
            )
            labels = hashed * 31 + neigh_sum
        if not self._erase_base_features:
            labels = labels * 131 + base
        _, roles = np.unique(labels, return_inverse=True)
        return roles.astype(np.int32)

    def _init_params(self, graph: Graph, key):
        n, d = graph.number_of_nodes, self.embedding_size
        roles = self._wl_roles(graph)
        self._roles = jnp.asarray(roles)
        n_roles = int(roles.max()) + 1
        self._n_roles = n_roles
        k1, k2 = jax.random.split(key)
        return {
            "node_embedding": jax.random.normal(k1, (n, d), jnp.float32)
            / np.sqrt(d),
            "role_embedding": jax.random.normal(
                k2, (n_roles, d), jnp.float32
            ) / np.sqrt(d),
        }

    def _sample_role_pairs(self, dg, key):
        """(words [N], roles [N, 2w], neg_roles [N, K]) — replicated given
        the same key, sliceable along the pair axis for data parallelism."""
        k_pairs, k_neg = jax.random.split(key)
        contexts, words = self._sample_pairs(dg, k_pairs)
        roles = self._roles[contexts]  # (N, 2w) role ids
        neg_roles = jax.random.randint(
            k_neg,
            (words.shape[0], self._number_of_negative_samples),
            0, self._n_roles, dtype=jnp.int32,
        )
        return words, roles, neg_roles

    def _pair_updates(self, params, words, roles, neg_roles, n_full):
        """Update-protocol gradients for a slice of pairs; losses normalized
        by the FULL pair count so slices sum to the single-chip step."""
        from .minibatch import Update

        emb = params["node_embedding"]
        role = params["role_embedding"]
        w = roles.shape[1]
        k = neg_roles.shape[1]

        def loss_fn(w_rows, pos_rows, neg_rows):
            pos_logit = jnp.einsum("nd,nwd->nw", w_rows, pos_rows)
            neg_logit = jnp.einsum("nd,nkd->nk", w_rows, neg_rows)
            return (
                jax.nn.softplus(-pos_logit).sum() / (n_full * w)
                + jax.nn.softplus(neg_logit).sum() / (n_full * k)
            )

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(
            emb[words], role[roles], role[neg_roles]
        )
        d = emb.shape[1]
        return loss, [
            Update("node_embedding", words, grads[0], "add"),
            Update(
                "role_embedding", roles.reshape(-1),
                grads[1].reshape(-1, d), "add",
            ),
            Update(
                "role_embedding", neg_roles.reshape(-1),
                grads[2].reshape(-1, d), "add",
            ),
        ]

    @classmethod
    def supports_distribution(cls) -> bool:
        return True

    def _choose_distribution(self, mesh, graph) -> str:
        strategy = super()._choose_distribution(mesh, graph)
        # Role tables don't follow the node-row sharding scheme.
        return "data" if strategy == "rows" else strategy

    def _step(self, dg, params, key, lr):
        from .minibatch import apply_updates

        words, roles, neg_roles = self._sample_role_pairs(dg, key)
        loss, updates = self._pair_updates(
            params, words, roles, neg_roles, words.shape[0]
        )
        return apply_updates(params, updates, lr), loss

    def _make_dp_step(self, mesh, batch_size: int):
        import functools

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from .minibatch import apply_updates, gather_updates

        axis = mesh.axis_names[0]
        p = int(mesh.devices.size)
        n_pairs = (
            batch_size * self._iterations
            * (self._walk_length - 2 * self._window_size)
        )
        assert n_pairs % p == 0, (n_pairs, p)
        bp = n_pairs // p
        model = self

        def step_outer(dg, params, key, lr):
            dg_spec = jax.tree_util.tree_map(lambda _: P(), dg)
            param_specs = jax.tree_util.tree_map(lambda _: P(), params)

            @functools.partial(
                shard_map, mesh=mesh,
                in_specs=(dg_spec, param_specs, P(), P()),
                out_specs=(param_specs, P()), check_vma=False,
            )
            def _run(dg_l, params_l, key_l, lr_l):
                words, roles, neg_roles = model._sample_role_pairs(
                    dg_l, key_l
                )
                i = jax.lax.axis_index(axis)
                sl = lambda a: jax.lax.dynamic_slice_in_dim(
                    a, i * bp, bp, 0
                )
                loss, updates = model._pair_updates(
                    params_l, sl(words), sl(roles), sl(neg_roles), n_pairs
                )
                params_l = apply_updates(
                    params_l, gather_updates(updates, axis), lr_l
                )
                return params_l, jax.lax.psum(loss, axis)

            return _run(dg, params, key, lr)

        return step_outer

    def _extract(self, params, graph):
        return EmbeddingResult(
            embedding_method_name=self.model_name(),
            node_embeddings=[np.asarray(params["node_embedding"])],
            node_names=graph.get_node_names(),
        )


FACTORIZATION_MODELS = (
    NetMF, GraRep, BoostNE, RandNE, NodeSketch, MNMF, NMFADMM, NNSED,
    Role2Vec,
)
