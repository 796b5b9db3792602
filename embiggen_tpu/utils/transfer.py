"""Device→host transfer helpers.

`pull_to_host` copies a large array to the host as several slices of its
leading axis, each pulled by its own thread, so that the copies of the
slices overlap; arrays under 32 MB are copied in one piece. Whether the
threads help on a given host link is not measured yet.
"""
from __future__ import annotations

import numpy as np

_MIN_PARALLEL_BYTES = 32 << 20  # single np.asarray below 32 MB


def pull_to_host(arr, streams: int = 8) -> np.ndarray:
    """np.asarray(arr) with the leading axis pulled in parallel slices."""
    nbytes = int(getattr(arr, "nbytes", 0) or 0)
    ndim = int(getattr(arr, "ndim", 0) or 0)
    if (
        nbytes < _MIN_PARALLEL_BYTES
        or ndim == 0
        or arr.shape[0] < streams
        or isinstance(arr, np.ndarray)
    ):
        return np.asarray(arr)
    import concurrent.futures as cf

    n = arr.shape[0]
    c = -(-n // streams)
    parts = [arr[i * c:min((i + 1) * c, n)] for i in range(streams) if i * c < n]
    with cf.ThreadPoolExecutor(len(parts)) as ex:
        outs = list(ex.map(np.asarray, parts))
    return np.concatenate(outs, axis=0)
