"""Mid-training step checkpointing — a capability the reference LACKS
(SURVEY.md §5.4: "No mid-training checkpointing anywhere"), wired into
`TrainLoop.run` (GCN classifiers) and `WalkBasedEmbedder._fit_transform`
(walk embedders) so long runs resume bit-identically after a kill.

Format: a single .npz of host numpy leaves (atomic via rename). This is the
default because it is backend-agnostic and needs no package beyond numpy.
For multi-host sharded pytrees pass `backend="orbax"`.
"""
from __future__ import annotations

import os
from typing import Any, Optional


def checkpoint_exists(path: str) -> bool:
    """True if `save_pytree(path, ...)` previously wrote a checkpoint here
    (npz file or orbax directory)."""
    path = os.path.abspath(path)
    return os.path.exists(path + ".npz") or os.path.isdir(path)


def checkpoint_matches(path: str, fingerprint: Optional[str]) -> bool:
    """True if the npz checkpoint at `path` exists AND carries the given
    fingerprint string. A checkpoint with no stored fingerprint only matches
    `fingerprint=None` (legacy files must not silently resume a different
    run — a stale checkpoint once returned a 34-node graph's embedding for a
    100-node graph because nothing tied the file to its run)."""
    path = os.path.abspath(path)
    if not os.path.exists(path + ".npz"):
        return os.path.isdir(path) and fingerprint is None
    import numpy as np

    try:
        data = np.load(path + ".npz")
        stored = (
            str(data["__fingerprint__"])
            if "__fingerprint__" in data.files
            else None
        )
    except Exception:
        return False
    return stored == fingerprint


def delete_checkpoint(path: str) -> None:
    """Remove a checkpoint written by `save_pytree` (no-op if absent).
    Called on successful run completion so a finished run can never be
    mistaken for a resumable one."""
    path = os.path.abspath(path)
    if os.path.exists(path + ".npz"):
        os.remove(path + ".npz")
    elif os.path.isdir(path):
        import shutil

        shutil.rmtree(path)


def save_pytree(
    path: str,
    pytree: Any,
    backend: str = "npz",
    fingerprint: Optional[str] = None,
) -> None:
    """Atomically save a jax/numpy pytree.

    backend="npz" (default): host .npz, leaves fetched to numpy first.
    backend="orbax": orbax PyTreeCheckpointer (sharded/multi-host trees).
    `fingerprint` (npz only): an identity string for the run (graph/model/
    hyper-params); `checkpoint_matches` gates restores on it.
    """
    path = os.path.abspath(path)
    if backend == "orbax":
        import orbax.checkpoint as ocp

        ckptr = ocp.PyTreeCheckpointer()
        ckptr.save(path, pytree, force=True)
        return
    import numpy as np
    import jax

    leaves, _ = jax.tree_util.tree_flatten(pytree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    payload = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    if fingerprint is not None:
        payload["__fingerprint__"] = np.asarray(fingerprint)
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path + ".npz")


def load_pytree(path: str, like: Optional[Any] = None) -> Any:
    """Restore a pytree saved by `save_pytree`. `like` provides the tree
    structure for the npz format (required); orbax directories restore with
    or without it."""
    path = os.path.abspath(path)
    import numpy as np
    import jax

    if os.path.exists(path + ".npz"):
        if like is None:
            raise ValueError(
                "load_pytree needs `like` (a structure template) for npz "
                f"checkpoints: {path}.npz"
            )
        data = np.load(path + ".npz")
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        treedef = jax.tree_util.tree_structure(like)
        return jax.tree_util.tree_unflatten(treedef, leaves)
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    return ckptr.restore(path, item=like)
