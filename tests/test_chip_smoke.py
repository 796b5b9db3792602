"""`chip_smoke.py` on the CPU: the script itself must refuse to run, and
every phase function must pass at a tiny size."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(
    nodes=2000, edges=10_000, dim=16, walkers=256, walk_length=16,
    window=2, negatives=4, skipgram_batch=128, gcn_batch=1024, pairs=4096,
    checked_walkers=256, eval_nodes=2000, eval_edges=10_000, eval_dim=16,
    eval_epochs=100, band_batch=16,
)
HEAVY = ("pandas", "sklearn", "matplotlib", "tensorflow", "torch", "orbax")


def _cpu_env():
    return {**os.environ, "JAX_PLATFORMS": "cpu"}


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu(tmp_path, alone):
    """On the CPU, and in a directory holding nothing of the repo but the
    script, it exits non-zero and prints no result."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_environment_phase_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.phase_environment({})


def test_native_library_loads():
    assert "native library loaded" in cs.load_native()


@pytest.fixture(scope="module")
def state():
    st = {}
    st["walks_line"] = cs.phase_walks(st, TINY)
    return st


def test_walk_phase(state):
    assert "every step on an arc" in state["walks_line"]
    assert state["graph"].number_of_nodes == TINY.nodes


def test_steps_follow_arcs_rejects_a_jump(state):
    g = state["graph"]
    u = 0
    v = int(np.asarray(g.col_idx)[g.row_ptr[u]])
    assert cs.steps_follow_arcs(g, np.array([[u, v, u]]))
    far = next(
        w for w in range(g.number_of_nodes)
        if w != u and w not in set(
            np.asarray(g.col_idx)[g.row_ptr[u]:g.row_ptr[u + 1]].tolist()
        )
    )
    assert not cs.steps_follow_arcs(g, np.array([[u, far]]))


def test_skipgram_phase(state):
    line = cs.phase_skipgram(state, TINY)
    assert f"embedding ({TINY.nodes}, {TINY.dim})" in line


def test_gcn_phase(state):
    line = cs.phase_gcn(state, TINY)
    assert "ELL width K=" in line
    assert state["features"].shape == (TINY.nodes, TINY.dim)


def test_holdout_phase():
    assert "test AUROC" in cs.phase_holdout({}, TINY)


def test_reference_phase(state):
    st = dict(state)
    st["features"] = np.random.default_rng(0).standard_normal(
        (TINY.nodes, TINY.dim), np.float32
    )
    lines = list(cs.phase_references(st, TINY))
    # 3 combiners x (forward, VJP) + 2 precisions x 6 banded outputs
    assert len(lines) == 6 + 12 + 1
    held, reported = lines[:12], lines[12:-1]
    assert all(line.endswith(" ok") for line in held)
    assert all("precision=highest" in line for line in held[6:])
    assert all(
        line.endswith("precision=default reported, not held")
        for line in reported
    )


def test_four_card_phase():
    lines = list(cs.phase_four_cards(TINY, n_cards=4))
    assert len(lines) == 4
    assert all("arrays made by the fit" in line for line in lines[:2])
    assert all("bytes_in_use MiB per device" in line for line in lines[:-1])


@pytest.mark.parametrize("distribution, share", [("rows", 4), ("data", 1)])
def test_memory_watch_sees_how_the_tables_are_spread(karate, distribution,
                                                     share):
    """On four virtual CPU devices, row-sharded SkipGram holds a quarter
    of its two [N, D] tables on each device, data-parallel SkipGram all of
    them; the CPU reports no bytes_in_use."""
    import jax

    from embiggen_tpu.models.embedders import SkipGram

    devices = jax.devices()[:4]
    dim = 8
    with cs.MemoryWatch(devices, 16, dim, period_s=0.001) as watch:
        SkipGram(
            embedding_size=dim, walk_length=10, window_size=2, epochs=20,
            mesh=4, distribution=distribution, random_state=0,
        ).fit_transform(karate)
    # row sharding pads the tables to a multiple of the mesh size
    rows = -(-karate.number_of_nodes // 4) * 4 if share == 4 else (
        karate.number_of_nodes
    )
    assert watch.tables == [2 * rows * dim * 4 // share] * 4
    assert watch.most == [0, 0, 0, 0]
    assert "arrays made by the fit" in watch.line()


def test_smoke_phases_import_no_heavy_packages():
    """The phases run in a fresh process without pandas, sklearn,
    matplotlib, tensorflow, torch or orbax ever being imported."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import test_chip_smoke as t\n"
        "cs = t.cs\n"
        "st = {}\n"
        "cs.load_native()\n"
        "for fn in (cs.phase_walks, cs.phase_skipgram, cs.phase_gcn,\n"
        "           cs.phase_holdout):\n"
        "    fn(st, t.TINY)\n"
        "list(cs.phase_references(st, t.TINY))\n"
        "print(sorted(m for m in t.HEAVY if m in sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=os.path.dirname(__file__),
        env=_cpu_env(), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
