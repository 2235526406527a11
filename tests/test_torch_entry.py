"""The flagship forward step: the port's `entry()` against the JAX
package's `__graft_entry__.entry()` on the CPU (float32, atol 1e-5;
measured: 1.9e-06 on predictions up to 25.7)."""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from insite_tpu_torch.entry import entry
from insite_tpu_torch.ops import rollout


def test_entry_matches_jax():
    jax_fn, jax_args = jax_entry()
    want = np.asarray(jax.jit(jax_fn)(*jax_args))
    fn, args = entry('cpu')
    for got_a, want_a in zip(args, jax_args):
        assert got_a.device.type == 'cpu'
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        assert got_a.numpy().dtype == np.asarray(want_a).dtype
    rollout.reset_launch_counts()
    got = fn(*args)
    assert (rollout.ROLLOUT_LAUNCHES, rollout.SENS_LAUNCHES) == (0, 0)
    assert got.shape == want.shape == (64, 59)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_entry_defaults_to_the_card():
    """Without a device the example tensors go to cuda:0: on a machine
    without a card that raises, as a kernel wrapper given no card does."""
    if torch.cuda.is_available():
        _, args = entry()
        assert {a.device for a in args} == {torch.device('cuda', 0)}
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            entry()

