"""Masks of ragged sequence batches held at a fixed width: a row's
``sequence_lengths`` entry as a 0/1 prefix."""

from __future__ import annotations

import torch


def prefix_mask(length: int, n, dtype=torch.float32):
    """``[1] * n + [0] * (length - n)``; with ``n`` a tensor of lengths, one
    such row per entry, on its device."""
    n = torch.as_tensor(n)
    idx = torch.arange(length, device=n.device)
    return (idx < n[..., None] if n.ndim else idx < n).to(dtype)


def length_mask(lengths, max_length: int, dtype=torch.float32):
    """``[B, max_length]`` with row ``i`` holding ``lengths[i]`` ones."""
    lengths = torch.as_tensor(lengths)
    idx = torch.arange(max_length, device=lengths.device)
    return (idx[None, :] < lengths[:, None]).to(dtype)
