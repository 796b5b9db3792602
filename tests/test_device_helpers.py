"""Device-dependent choices made from what the device reports, and the
reference checks' own arithmetic, on the CPU."""
import dataclasses
import os

import jax
import numpy as np
import pytest

from embiggen_tpu.parallel.mesh import REPLICATED_TABLE_SHARE, auto_distribution
from embiggen_tpu.utils import compile_cache
from embiggen_tpu.utils import reference_checks as rc


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


GIB = 1 << 30


@pytest.mark.parametrize(
    "stats, table_bytes, want",
    [
        ({"bytes_limit": 60 * GIB}, 40 * GIB, "rows"),
        ({"bytes_limit": 60 * GIB}, 20 * GIB, "data"),
        ({"bytes_limit": 16 * GIB}, 9 * GIB, "rows"),
        ({"bytes_in_use": 0}, 400 * GIB, "data"),
        (None, 400 * GIB, "data"),
    ],
)
def test_auto_distribution(stats, table_bytes, want):
    assert auto_distribution(table_bytes, _Device(stats)) == want


def test_auto_distribution_boundary_is_the_stated_share():
    limit = 10 * GIB
    at = int(REPLICATED_TABLE_SHARE * limit)
    assert auto_distribution(at, _Device({"bytes_limit": limit})) == "data"
    assert auto_distribution(at + 1, _Device({"bytes_limit": limit})) == "rows"


def test_cpu_mesh_auto_distribution_is_data_parallel(karate):
    from embiggen_tpu.models.embedders import SkipGram
    from embiggen_tpu.parallel import make_mesh

    mesh = make_mesh(("data",), devices=jax.devices()[:4])
    model = SkipGram(embedding_size=8, walk_length=8, window_size=2, mesh=mesh)
    assert model._choose_distribution(mesh, karate) == "data"


def test_compile_cache_defaults_to_fixed_checkout_path(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    # the same path on every call: no pid, time or temporary name in it
    assert compile_cache.enable_compile_cache() == path


def test_compile_cache_leaves_env_setting_to_jax(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compare_flags_an_error_beyond_tolerance():
    want = np.linspace(-1.0, 1.0, 101)
    assert rc.compare("same", want, want, 1e-5, 0.0, "p").ok
    c = rc.compare("off", want * (1 + 1e-3), want, 1e-5, 0.0, "p")
    assert not c.ok
    assert c.max_abs == pytest.approx(1e-3)
    assert not rc.compare("nan", want * np.nan, want, 1e-5, 1.0, "p").ok


def test_default_precision_error_is_reported_not_held():
    """Away from "highest" the banded check reports its error without a
    tolerance: the line must not read as a pass at rtol 1e-5."""
    comparisons = rc.check_skipgram_band(
        300, batch=8, walk_length=16, window=3, dim=8, negatives=3,
        precision="default",
    )
    for c in comparisons:
        assert not c.held
        assert "tol(" not in c.line()
        assert c.line().endswith("precision=default reported, not held")
    nan = rc.compare("nan", np.array([np.nan]), np.ones(1), 0.0, 0.0, "p")
    bad = dataclasses.replace(nan, ok=False, held=False)
    assert bad.line().endswith("FAILED (non-finite)")


def test_spmm_reference_check_on_a_small_graph():
    from embiggen_tpu.graph import erdos_renyi

    g = erdos_renyi(500, 3000, seed=3)
    x = np.random.default_rng(1).standard_normal((500, 16), np.float32)
    comparisons = rc.check_spmm(g, x)
    assert len(comparisons) == 6
    assert all(c.ok for c in comparisons), [c.line() for c in comparisons]


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_skipgram_band_reference_check_small(precision):
    comparisons = rc.check_skipgram_band(
        300, batch=8, walk_length=16, window=3, dim=8, negatives=3,
        precision=precision,
    )
    assert all(c.ok for c in comparisons), [c.line() for c in comparisons]


def test_per_pair_loss_counts_every_window_pair():
    """With zero embeddings and biases every score is 0: each of the
    (L-2w)·2w positive pairs costs softplus(0) and each of the (L-2w)·K
    negative pairs costs softplus(0)."""
    b, length, w, d, k = 2, 12, 2, 4, 3
    z = np.zeros((b, length, d), np.float32)
    loss = rc.per_pair_skipgram_loss(
        z, z, np.zeros((b, length), np.float32),
        np.zeros((b, k, d), np.float32), np.zeros((b, k), np.float32), w,
    )
    pairs = b * (length - 2 * w) * (2 * w + k)
    assert float(loss) == pytest.approx(pairs * np.log(2.0), rel=1e-6)


@pytest.mark.parametrize(
    "markexpr, want",
    [("gpu", True), ("gpu and not slow", True), ("(gpu)", True),
     ("not gpu", False), ("not slow", False), ("", False), ("gpus", False)],
)
def test_gpu_selection_reads_the_mark_expression(markexpr, want):
    from test_gpu import gpu_selected

    assert gpu_selected(markexpr) is want


def test_selected_gpu_tests_fail_without_a_card():
    """`-m gpu` on a host with no card fails instead of skipping, so a run
    that silently tested nothing cannot pass."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "tests/test_gpu.py::test_banded_skipgram_matches_per_pair_under_highest"],
        cwd=os.path.dirname(here), env={**os.environ, "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0, proc.stdout[-2000:]
    assert "selected with -m gpu" in proc.stdout
