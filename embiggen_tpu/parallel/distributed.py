"""Multi-host initialization + holdout-level parallelism — the counterpart
of the reference's SLURM round-robin holdout scheduling
(`abstract_classifier_model.py:2788-2804,2917-2993`) plus the
`jax.distributed` bring-up the reference has no equivalent of (SURVEY §5.8).

Holdout workers are separate processes, and a JAX process reserves most of
a card's memory when it starts, so each worker takes its own card: start
worker i with `CUDA_VISIBLE_DEVICES=i EMBIGGEN_TPU_WORKER_ID=i
EMBIGGEN_TPU_WORKER_COUNT=<workers>`. Nothing in this package starts a
second JAX process itself.
"""
from __future__ import annotations

import os
from typing import Optional


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed across hosts; a no-op single-process setup
    when no coordinator is configured. Returns True when multi-host."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "EMBIGGEN_TPU_COORDINATOR"
    )
    if coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def holdout_belongs_to_this_worker(
    holdout_number: int,
    number_of_workers: Optional[int] = None,
    worker_id: Optional[int] = None,
) -> bool:
    """Round-robin assignment of independent holdouts to workers — the
    reference's SLURM modulo filter (`slurm_node_id % N == holdout % N`),
    generalized: worker identity comes from explicit args, the
    EMBIGGEN_TPU_WORKER_{ID,COUNT} env vars, or jax process indices."""
    if number_of_workers is None:
        number_of_workers = int(os.environ.get("EMBIGGEN_TPU_WORKER_COUNT", 0))
    if worker_id is None:
        worker_id = int(os.environ.get("EMBIGGEN_TPU_WORKER_ID", 0))
    if not number_of_workers:
        try:
            import jax

            number_of_workers = jax.process_count()
            worker_id = jax.process_index()
        except Exception:
            number_of_workers = 1
            worker_id = 0
    if number_of_workers <= 1:
        return True
    return holdout_number % number_of_workers == worker_id % number_of_workers
