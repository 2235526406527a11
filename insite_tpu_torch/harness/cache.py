"""Dataset-collection disk cache, keyed by the run's dataset config.

The key is the JAX package's (`insite_tpu.harness.runner._collection_for`)
plus the device type and the dtype: the port's EQ_4 cohorts come from a
`torch.Generator` on the collection's device, so one seed gives another
cohort on the host than on the card. The pickles hold the port's
collections and live in a directory of their own
(``$INSITE_TPU_TORCH_CACHE``, default ``.insite_torch_cache``): unpickling
one of the JAX cache's would import the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import pickle

CACHE_DIR = os.environ.get('INSITE_TPU_TORCH_CACHE', '.insite_torch_cache')


def _path(key) -> str:
    digest = hashlib.sha256(repr(key).encode()).hexdigest()[:24]
    return os.path.join(CACHE_DIR, f'collection_{digest}.pkl')


def get_cached(key):
    """The collection stored under ``key``, or None. Unpickling runs code
    from the file, so the cache directory must hold only this program's
    own pickles."""
    path = _path(key)
    if os.path.exists(path):
        with open(path, 'rb') as f:
            return pickle.load(f)
    return None


def put_cached(key, collection):
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f'{_path(key)}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(collection, f)
    # atomic: a concurrent reader sees the old file or the whole new one
    os.replace(tmp, _path(key))
