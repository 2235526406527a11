"""Fixtures of the benchmark's tests: the repository root (the benchmark
reads `BENCHMARK.json` from the working directory) and, for the tests
that need a card, a CUDA device decided here, never at import."""

import os
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)
    return ROOT


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA)')
    return torch.device('cuda', 0)


@pytest.fixture(autouse=True)
def one_thread():
    """The plain rollouts are thousands of tiny ops: one intra-op thread a
    test process keeps parallel test workers from oversubscribing."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cells():
    import json
    with open(ROOT / 'BENCHMARK.json') as f:
        return [w['name'] for w in json.load(f)['workloads']]


os.environ.setdefault('USE_FLAX', '0')
