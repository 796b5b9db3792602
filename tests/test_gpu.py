"""Production kernels against plain references at real widths, on a GPU
(the same comparisons `chip_smoke.py` runs in its phase 5). They skip where
JAX finds no GPU, unless they were selected with `-m gpu`: then they fail.
On a GPU host run them with
`JAX_PLATFORMS=cuda python -m pytest -m gpu -p no:xdist tests/test_gpu.py`
(`tests/conftest.py` pins the CPU when JAX_PLATFORMS is unset)."""
import numpy as np
import pytest

from embiggen_tpu.utils import reference_checks as rc

pytestmark = pytest.mark.gpu

N_NODES = 1_000_000


def gpu_selected(markexpr: str) -> bool:
    """True when a `-m` expression asks for the gpu tests by name."""
    words = markexpr.replace("(", " ").replace(")", " ").split()
    return any(
        w == "gpu" and (i == 0 or words[i - 1] != "not")
        for i, w in enumerate(words)
    )


@pytest.fixture(scope="module")
def gpu(request):
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu":
        return
    why = f"needs a GPU; JAX's default platform is {platform!r}"
    if gpu_selected(request.config.getoption("markexpr") or ""):
        pytest.fail(f"{why}: selected with -m gpu, so this fails (run with "
                    "JAX_PLATFORMS=cuda on a GPU host)")
    pytest.skip(why)


@pytest.fixture(scope="module")
def graph(gpu):
    from embiggen_tpu.graph import erdos_renyi

    return erdos_renyi(N_NODES, 10_000_000, seed=0)


def _failures(comparisons):
    return [c.line() for c in comparisons if not c.ok]


def test_spmm_padded_matches_coo_at_d128(graph):
    x = np.random.default_rng(0).standard_normal((N_NODES, 128), np.float32)
    assert not _failures(rc.check_spmm(graph, x))


def test_banded_skipgram_matches_per_pair_under_highest(gpu):
    assert not _failures(rc.check_skipgram_band(N_NODES, precision="highest"))


def test_banded_skipgram_at_default_precision_is_finite(gpu):
    comparisons = rc.check_skipgram_band(N_NODES, precision="default")
    for c in comparisons:
        print(c.line())
    assert not _failures(comparisons)
