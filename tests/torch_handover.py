"""Shared by the whole-row parity tests of the neural baselines: the
port's runner takes its cohorts from the JAX package, and a JAX fit's
initial parameters are recorded to be loaded into the port's networks."""

import copy

import jax
import jax.numpy as jnp
import numpy as np

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.harness import runner

SIZES = dict(train_samples=16, val_samples=2, test_samples=2)
RMSE_KEYS = ['encoder_test_rmse_all', 'encoder_test_rmse_orig',
             'encoder_test_rmse_last'] + [f'decoder_test_rmse_{k}-step'
                                          for k in range(2, 7)]


def hand_over_jax_cohorts(monkeypatch):
    """Let the port's runner take every cohort from the JAX package (a
    copy of its unprocessed subsets, made in float64)."""
    def make_collection(dataset_name, num_patients, seed, coeff, *, device,
                        dtype=None, **kwargs):
        ref = jax_make_collection(dataset_name, num_patients, seed, coeff,
                                  dtype=jnp.float64, **kwargs)
        raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
        return convert.collection_from_numpy(
            raw, ref.train_scaling_params, dataset_name,
            projection_horizon=ref.projection_horizon,
            treatment_mode=kwargs['treatment_mode'], seed=seed)
    monkeypatch.setattr(runner, 'make_collection', make_collection)


def record_initial_params(monkeypatch, module, fit_name, initial,
                          params_arg=1):
    """Wrap ``module.fit_name`` so that each call appends its initial
    parameters (positional argument ``params_arg``, as numpy) to
    ``initial``."""
    fit = getattr(module, fit_name)

    def record(*args, **kwargs):
        initial.append(jax.tree_util.tree_map(np.asarray, args[params_arg]))
        return fit(*args, **kwargs)

    monkeypatch.setattr(module, fit_name, record)


def build_with_initial(monkeypatch, nets_of, initial):
    """Let the port's runner load ``initial`` into the networks
    ``nets_of(model)`` of every model it builds."""
    build = runner._build_model

    def build_from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        nets = nets_of(model)
        assert len(nets) == len(initial)
        for net, params in zip(nets, initial):
            net.load_state_dict(convert.state_dict_from_flax(params, net))
        return model

    monkeypatch.setattr(runner, '_build_model', build_from_jax_init)


def assert_rows_close(ours, ref, keys, what, rtol=1e-4):
    """The port's row has the JAX row's keys in its order, and its RMSEs
    agree to ``rtol``; prints the largest relative deviation."""
    assert list(ours) == list(ref) == keys
    worst = max(abs(ours[k] / ref[k] - 1) for k in RMSE_KEYS)
    print(f'{what}: largest relative RMSE deviation {worst:.3e}')
    for k in RMSE_KEYS:
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, err_msg=k)
    assert runner._plain(ours) == ours
