"""The flagship forward step: the port's `entry()` against the JAX
package's `__graft_entry__.entry()` on the CPU (float32, atol 1e-5;
measured: 1.9e-06 on predictions up to 25.7); and the port's
`dryrun_multichip` over a mesh of two CPU devices."""

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import entry as jax_entry
from insite_tpu_torch import ops
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
    ops.reset_launch_counts()
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



def test_dryrun_multichip_on_two_cpu_devices():
    """Every step of the dry run over a 2-shard mesh of CPU devices (the
    plain versions stand in for the kernels): finite results of the JAX
    dry run's shapes, the data-parallel CT step equal to the unsharded one
    (asserted inside, rtol 1e-5), and the seed-sharded sindy column equal
    to the unsharded column bit for bit."""
    from insite_tpu_torch.entry import dryrun_multichip
    from insite_tpu_torch.harness.vectorized import vectorized_eq4_sweep
    cpu = torch.device('cpu')
    r = dryrun_multichip(2, devices=[cpu, cpu])
    assert set(r['walls']) == {'stlsq', 'finetune', 'ct_step', 'sindy_column',
                               'ct_column', 'gnet_column', 'sens_kernel'}
    assert r['stlsq_coefs'].shape == (7,)
    assert r['finetune_preds'].shape == (8, 11)
    assert np.isfinite(r['ct_loss'])
    ref = vectorized_eq4_sweep('EQ_4_D', n_seeds=2, n_train=16, n_test=4,
                               seq_length=12, method='sindy', device=cpu)
    for k in ref:
        np.testing.assert_array_equal(r['sindy_column'][k], ref[k])
    for col, key in (('ct_column', 'encoder_test_rmse_orig'),
                     ('gnet_column', 'decoder_test_rmse_6-step')):
        assert r[col][key].shape == (2,) and np.isfinite(r[col][key]).all()
