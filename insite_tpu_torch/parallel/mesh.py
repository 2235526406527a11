"""A batch mesh in one process: an ordered tuple of devices, each holding
one shard of the rows (or one block of the seeds) of a batch.

The JAX package puts a 1-D `jax.sharding.Mesh` on the batch axis and lets
XLA partition its programs. Here a shard is a tensor on its own device:
`shard_rows` pads the rows to a multiple of the mesh size by repeating the
last row and sends each shard to its device, every per-row computation
then runs shard by shard (the CUDA kernels launch on each shard's card),
and `gather_rows` concatenates the results on the lead device, the mesh's
first, and drops the padding. A cross-row reduction weighs each shard's
rows by its `row_mask`, so that the padding contributes nothing.

One device may appear more than once: the shards then run one after
another on it. A mesh of CPU devices (``[torch.device('cpu')] * k``) runs
every shard's plain versions on the host, which is how the tests hold a
sharded run to an unsharded one.
"""

from __future__ import annotations

import torch


def batch_mesh(devices=None) -> tuple:
    """The mesh over ``devices`` (any device names or `torch.device`s, in
    order) or, without them, over every visible CUDA card; raises when
    there is none."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError('batch_mesh() needs a CUDA device; pass '
                               'devices=[...] for another mesh')
        devices = [torch.device('cuda', i) for i in range(n)]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError('a mesh needs at least one device')
    return mesh


def pad_rows(x, multiple: int):
    """Pad the leading axis up to a multiple of ``multiple`` by repeating
    the last row; ``x`` itself when it is one already."""
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])])


def unpad_rows(x, n: int):
    return x[:n]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _shard_bounds(n_padded: int, mesh) -> list:
    k = n_padded // len(mesh)
    return [(i * k, (i + 1) * k) for i in range(len(mesh))]


def row_mask(n: int, mesh, dtype=torch.float32) -> list:
    """Per shard of ``n`` rows sharded by `shard_rows`, a 0/1 mask on the
    shard's device: 1 on real rows, 0 on the padding."""
    total = n + (-n) % len(mesh)
    mask = (torch.arange(total) < n).to(dtype)
    return [mask[a:b].to(d) for d, (a, b) in zip(mesh,
                                                   _shard_bounds(total, mesh))]


def shard_rows(tree, mesh):
    """Pad every leaf's leading axis (numpy arrays or tensors, one row
    count) to a multiple of the mesh size and split it into one shard per
    device. Returns (a list of per-shard trees, each on its device, of the
    structure of ``tree``; the real row count)."""
    leaves = _leaves(tree)
    n = leaves[0].shape[0]
    if any(x.shape[0] != n for x in leaves):
        raise ValueError('shard_rows: the leaves have different row counts')
    tree = _tree_map(lambda x: pad_rows(torch.as_tensor(x), len(mesh)), tree)
    bounds = _shard_bounds(n + (-n) % len(mesh), mesh)
    return [_tree_map(lambda x, a=a, b=b, d=d: x[a:b].to(d), tree)
            for d, (a, b) in zip(mesh, bounds)], n


def gather_rows(shards, n: int):
    """The shards' results concatenated on the first shard's device, the
    padding dropped: ``shards`` is a list of tensors, or of tuples of
    tensors (then a tuple is returned)."""
    if isinstance(shards[0], (tuple, list)):
        return tuple(gather_rows([s[i] for s in shards], n)
                     for i in range(len(shards[0])))
    lead = shards[0].device
    return torch.cat([s.to(lead) for s in shards])[:n]


def seed_blocks(n_seeds: int, mesh) -> list:
    """The seed axis of a column split over the mesh: one ``(device,
    slice)`` per device, in order. ``n_seeds`` must be a multiple of the
    mesh size, as in the JAX package."""
    if n_seeds % len(mesh):
        raise ValueError(f'n_seeds={n_seeds} must be a multiple of the mesh '
                         f'size {len(mesh)}')
    k = n_seeds // len(mesh)
    return [(d, slice(i * k, (i + 1) * k)) for i, d in enumerate(mesh)]

