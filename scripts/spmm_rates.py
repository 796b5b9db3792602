"""Measure the rates behind `ops/spmm.py::ELL_WIDTH` and time the two SpMM
formulations, on a GPU, on ER(1M nodes, 10M edges) at D=128 float32.

    python scripts/spmm_rates.py [--rounds 3]

Prints one line per measurement and, last, one JSON object. Rates:
  * gather rows/s: `_ell_spmm` (the ELL gather-contract), n_out*K gathered
    rows per call, at several K;
  * scatter rows/s: the overflow path, a sorted `segment_sum` of weighted
    gathered rows, at several overflow sizes.
Timings: COO `spmm`, and `spmm_padded` at ELL widths K = 4..32 (every
multiple of 4) and at the width `_choose_k` picks, forward and
forward+backward, on the "Symmetric Normalized Laplacian" of the ER graph
and of a heavy-tailed graph of the same size. Each case is compiled and
run once, then timed once per round, in an order rotated from round to
round so that drift spreads over every case; a round's time is the median
of `REPS` calls, each ended by `block_until_ready`. The line of a case
gives its median over rounds and each round's time.

For each graph the script also prints the width a cost model would pick:
minimise n_out*K / gather_rate + overflow(K) / scatter_rate over multiples
of 4 (the rule `_choose_k` followed before `ELL_WIDTH`), once with the
previous constants (190e6 and 85e6 rows/s) and once with this run's rates
(gather: median over K; scatter: at 1M rows, the overflow size of the
widths that model picks on ER).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 5
WIDTHS = (4, 8, 12, 16, 20, 24, 28, 32)
PREVIOUS_RATES = (190e6, 85e6)


def median_ms(fn, *args):
    import jax

    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def rounds_ms(cases, rounds):
    """{name: (fn, args)} -> {name: [ms in each round]}. Every case is run
    once first (compilation), then timed once per round in a rotated
    order."""
    import jax

    for fn, args in cases.values():
        jax.block_until_ready(fn(*args))
    names = list(cases)
    out = {name: [] for name in names}
    for r in range(rounds):
        shift = (r * len(names)) // rounds
        for name in names[shift:] + names[:shift]:
            fn, args = cases[name]
            out[name].append(median_ms(fn, *args))
    return out


def summary(times):
    return (f"{float(np.median(times)):.3f} ms (rounds "
            + ", ".join(f"{t:.3f}" for t in times) + ")")


def cost_model_k(counts, gather_rate, scatter_rate, cap=512, min_k=4):
    """Width minimising n_out*K/gather_rate + overflow(K)/scatter_rate over
    K = min_k, min_k+4, ... up to the longest row (bounded by `cap`)."""
    n_out = counts.shape[0]
    hi = min(max(cap, min_k), max(int(counts.max(initial=0)), min_k))
    hi = ((hi + 3) // 4) * 4
    best_k, best_cost = min_k, float("inf")
    for k in range(min_k, hi + 1, 4):
        overflow = float(np.maximum(counts - k, 0).sum())
        cost = n_out * k / gather_rate + overflow / scatter_rate
        if cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def heavy_tailed(n, n_edges, seed=0):
    """Chung-Lu style graph: endpoints drawn with probability ∝ rank^-0.8,
    so degrees follow a power law with hubs of tens of thousands."""
    from embiggen_tpu.graph import Graph

    rng = np.random.default_rng(seed)
    p = np.arange(1, n + 1, dtype=np.float64) ** -0.8
    p /= p.sum()
    src = rng.choice(n, n_edges, p=p)
    dst = rng.choice(n, n_edges, p=p)
    keep = src != dst
    return Graph.from_edge_arrays(
        src[keep], dst[keep], n_nodes=n, directed=False, name="heavy"
    )


def fwd_and_grad(f, k, x, g):
    """Jitted forward and forward+backward of x -> f(k, x), with the kernel
    `k` passed as an argument (not captured, which would embed its arrays
    in the program). The backward is taken through jax.value_and_grad with
    the value kept, so the forward is not dead code."""
    import jax
    import jax.numpy as jnp

    both = jax.value_and_grad(lambda a, k, g: jnp.vdot(f(k, a), g))
    return (jax.jit(f), (k, x)), (jax.jit(both), (x, k, g))


def measure_rates(n, d, rounds, rng):
    import jax
    import jax.numpy as jnp

    from embiggen_tpu.ops.spmm import _ell_spmm

    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    ell = jax.jit(_ell_spmm)

    @jax.jit
    def overflow(r, c, v, x):
        return jax.ops.segment_sum(
            x[c] * v[:, None], r, num_segments=n, indices_are_sorted=True
        )

    cases, rows_per_call = {}, {}
    for k in (8, 16, 24, 32):
        cp = jnp.asarray(rng.integers(0, n, (n, k)), jnp.int32)
        vp = jnp.asarray(rng.random((n, k)), jnp.float32)
        cases[f"gather K={k}"] = (ell, (cp, vp, x))
        rows_per_call[f"gather K={k}"] = n * k
    for e in (n, 4 * n, 16 * n):
        r = jnp.asarray(np.sort(rng.integers(0, n, e)), jnp.int32)
        c = jnp.asarray(rng.integers(0, n, e), jnp.int32)
        v = jnp.asarray(rng.random(e), jnp.float32)
        cases[f"segment_sum E={e}"] = (overflow, (r, c, v, x))
        rows_per_call[f"segment_sum E={e}"] = e
    times = rounds_ms(cases, rounds)
    rates = {}
    for name, ts in times.items():
        rates[name] = rows_per_call[name] / (float(np.median(ts)) * 1e-3)
        print(f"{name}: {summary(ts)}, {rates[name]:.4g} rows/s", flush=True)
    gather = float(np.median([v for k, v in rates.items() if "gather" in k]))
    return {"times_ms": times, "rows_per_s": rates,
            "gather_rate": gather, "scatter_rate_1x": rates[f"segment_sum E={n}"]}


def measure_graph(name, graph, d, rounds, rates):
    import jax
    import jax.numpy as jnp

    from embiggen_tpu.graph import kernel_coo
    from embiggen_tpu.ops.spmm import coo_to_device, pad_coo, spmm, spmm_padded

    n = graph.number_of_nodes
    rows, cols, vals = kernel_coo(graph, "Symmetric Normalized Laplacian")
    counts = np.bincount(rows, minlength=n)
    picks = {
        "previous constants": cost_model_k(counts, *PREVIOUS_RATES),
        "this run's rates": cost_model_k(
            counts, rates["gather_rate"], rates["scatter_rate_1x"]
        ),
    }
    print(f"{name}: {graph.number_of_directed_edges} arcs, max degree "
          f"{int(counts.max())}; cost model picks "
          + ", ".join(f"K={k} ({w})" for w, k in picks.items()), flush=True)
    x = jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32)
    g = jax.random.normal(jax.random.PRNGKey(1), (n, d), jnp.float32)

    def coo(rcv, a):
        return spmm(*rcv, a, n, "sum")

    def ell(pk, a):
        return spmm_padded(pk, a, "sum")

    cases = {}
    cases["COO forward"], cases["COO forward+backward"] = fwd_and_grad(
        coo, coo_to_device(rows, cols, vals), x, g
    )
    auto = pad_coo(rows, cols, vals, n, with_transpose=True)
    k_auto = int(auto.cols_pad.shape[1])
    widths = sorted(set(WIDTHS) | {k_auto} | set(picks.values()))
    overflow = {}
    for k in widths:
        pk = auto if k == k_auto else pad_coo(
            rows, cols, vals, n, cap=k, min_k=k, with_transpose=True
        )
        overflow[k] = int(pk.ov_rows.shape[0])
        cases[f"K={k} forward"], cases[f"K={k} forward+backward"] = (
            fwd_and_grad(ell, pk, x, g)
        )
    times = rounds_ms(cases, rounds)
    for case in ("COO forward", "COO forward+backward"):
        print(f"{name} {case}: {summary(times[case])}", flush=True)
    for k in widths:
        tags = [w for w, pk in picks.items() if pk == k]
        if k == k_auto:
            tags.insert(0, "_choose_k")
        print(f"{name} ELL K={k}{' [' + ', '.join(tags) + ']' if tags else ''}"
              f", overflow {overflow[k]} rows: forward "
              f"{summary(times[f'K={k} forward'])}; forward+backward "
              f"{summary(times[f'K={k} forward+backward'])}", flush=True)
    return {"times_ms": times, "overflow_rows": overflow, "k_auto": k_auto,
            "model_picks": picks, "max_degree": int(counts.max())}


def measure(n, n_edges, d, rounds):
    from embiggen_tpu.graph import erdos_renyi

    rng = np.random.default_rng(0)
    out = {"rates": measure_rates(n, d, rounds, rng)}
    out["ER"] = measure_graph(
        "ER", erdos_renyi(n, n_edges, seed=0), d, rounds, out["rates"]
    )
    out["heavy"] = measure_graph(
        "heavy-tailed", heavy_tailed(n, n_edges), d, rounds, out["rates"]
    )
    return out


def main(argv=None) -> int:
    import jax

    from embiggen_tpu.utils.compile_cache import enable_compile_cache

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is {dev.platform!r}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(f"device {dev.device_kind}; nvidia-smi: {smi}", flush=True)
    out = {"device_kind": dev.device_kind, "nvidia_smi": smi}
    out.update(measure(1_000_000, 10_000_000, 128, args.rounds))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
