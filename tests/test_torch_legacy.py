"""The legacy eq_1-eq_8 generators: the port's `sim/legacy.py` fed the JAX
package's own draws (its key splits, uniforms and normals) reproduces the
JAX package's `load_dataset` splits, in float64 on the CPU (rtol 1e-12;
measured: 4.5e-15 relative at most, actions equal); then the behaviour
checks of tests/test_sim_legacy.py on the port's own generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from insite_tpu.sim import legacy as jax_legacy
from insite_tpu_torch.sim import legacy

F64 = dict(device='cpu', dtype=torch.float64)
torch.set_num_threads(1)
# equal splits: the JAX simulators compile once per shape
SIZES = dict(train_samples=4, val_samples=4, test_samples=4)
T_STEPS = 24


def _jax_draws(key, family, n, T):
    """The draws of `insite_tpu.sim.legacy._simulate_*` for one split, as
    the port's `simulate` takes them (float64 numpy)."""
    D, A = legacy.DIMS[family]
    k_x0, k_p, k_act, k_obs = random.split(key, 4)
    keys = random.split(k_act, T - 1)
    draws = {
        'x0_uniform': random.uniform(k_x0, (n, 1), jnp.float64),
        'act_uniforms': jax.vmap(
            lambda k: random.uniform(k, (n, A), jnp.float64))(keys),
        'obs_normals': random.normal(k_obs, (n, T, D), jnp.float64)}
    if family == 'single':
        draws['param_normals'] = jax.vmap(
            lambda i: random.normal(random.fold_in(k_p, i), (n,),
                                    jnp.float64))(
            jnp.arange(len(legacy.SINGLE_PARAMS)))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize('name', list(legacy.EQUATIONS))
def test_equals_jax_on_its_draws(name):
    """Every split of ``name`` (train confounded at gamma 2, val and test
    at 0, actions redrawn every 7 steps) from the JAX package's draws."""
    T, seed = T_STEPS, 3
    want = jax_legacy.load_dataset(name, seed, gamma=2.0, step_actions=7,
                                   total_time_steps=T, **SIZES)
    family, variant = legacy.EQUATIONS[name]
    assert jax_legacy.EQUATIONS[name] == (family, variant)
    key = random.PRNGKey(seed)
    worst = 0.0
    for i, g in enumerate((2.0, 0.0, 0.0)):
        draws = _jax_draws(random.fold_in(key, i), family, 4, T)
        states, actions = legacy.simulate(family, draws, g, step_actions=7,
                                          **variant)
        ref = want[i]
        np.testing.assert_array_equal(actions.numpy(), ref['a'])
        np.testing.assert_allclose(states.numpy(), ref['x'], rtol=1e-12,
                                   atol=1e-14)
        worst = max(worst, float(np.max(np.abs(states.numpy() - ref['x'])
                                        / np.abs(ref['x']))))
    print(f'{name}: largest relative deviation {worst:.3e}')


def test_port_load_dataset_has_the_jax_layout():
    """The same dict keys, shapes, dtypes and metadata as the JAX
    package's, from the port's own generator."""
    ours = legacy.load_dataset('eq_6', 0, total_time_steps=T_STEPS,
                               **SIZES, **F64)
    ref = jax_legacy.load_dataset('eq_6', 0, total_time_steps=T_STEPS,
                                  **SIZES)
    for a, b in zip(ours[:3], ref[:3]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
    assert {k: v for k, v in ours[3].items() if k != 't'} == \
        {k: v for k, v in ref[3].items() if k != 't'}
    np.testing.assert_array_equal(ours[3]['t'], ref[3]['t'])


def test_seed_repeats_and_unknown_name_raises():
    a = legacy.load_dataset('eq_3', 5, total_time_steps=12, **SIZES, **F64)
    b = legacy.load_dataset('eq_3', 5, total_time_steps=12, **SIZES, **F64)
    np.testing.assert_array_equal(a[0]['x'], b[0]['x'])
    with pytest.raises(NotImplementedError):
        legacy.load_dataset('eq_9', 0, **F64)


# ---------------------------------------------------------------------------
# the behaviour checks of tests/test_sim_legacy.py, on the port's generator

@pytest.mark.parametrize('name', list(legacy.EQUATIONS))
def test_shapes_and_finiteness(name):
    train, val, test, meta = legacy.load_dataset(
        name, seed=0, train_samples=8, val_samples=4, test_samples=4,
        gamma=1.0, total_time_steps=30, **F64)
    D = meta['x_dim']
    A = meta['action_dim']
    assert train['x'].shape == (8, 30, D)
    assert train['a'].shape == (8, 30, A)
    assert val['x'].shape[0] == 4
    assert np.isfinite(train['x']).all()
    assert set(np.unique(train['a'])) <= {0.0, 1.0}
    if name.startswith(('eq_5', 'eq_6', 'eq_7', 'eq_8')):
        assert D == 2 and A == 2
        assert train['y'].shape[-1] == 1
    else:
        assert D == 1 and A == 1


def test_single_dynamics_direction():
    """Untreated trajectories grow (dx = +x), treated decay (dx = -x)."""
    train, _, _, _ = legacy.load_dataset('eq_1', seed=0, train_samples=64,
                                         val_samples=2, test_samples=2,
                                         gamma=0.0, total_time_steps=30,
                                         step_actions=30, **F64)
    x, a = train['x'][:, :, 0], train['a'][:, :, 0]
    always_on = a.all(axis=1) & (x[:, 0] > 1e-3)
    always_off = (~a.astype(bool)).all(axis=1) & (x[:, 0] > 1e-3)
    assert always_on.any() and always_off.any()
    assert (x[always_on, -1] < x[always_on, 0]).all()
    assert (x[always_off, -1] > x[always_off, 0]).all()


def test_actions_held_for_step_actions():
    train, _, _, _ = legacy.load_dataset('eq_1', seed=1, train_samples=16,
                                         val_samples=2, test_samples=2,
                                         gamma=2.0, total_time_steps=60,
                                         step_actions=30, **F64)
    a = train['a'][:, :, 0]
    # actions redrawn every 30 steps: within [1, 31) they are constant
    assert (a[:, 1:31].std(axis=1) == 0).all()


def test_confounding_direction():
    """gamma > 0 ties treatment to large x (the policy sigmoid)."""
    train, _, _, _ = legacy.load_dataset('eq_1', seed=0, train_samples=400,
                                         val_samples=2, test_samples=2,
                                         gamma=10.0, total_time_steps=30,
                                         step_actions=30, **F64)
    x0 = train['x'][:, 0, 0]
    a0 = train['a'][:, 1, 0]
    assert a0[x0 > 7.5].mean() > a0[x0 < 7.5].mean() + 0.2


def test_bsv_variants_differ():
    t3, _, _, _ = legacy.load_dataset('eq_3', seed=0, train_samples=8,
                                      val_samples=2, test_samples=2,
                                      total_time_steps=20, **F64)
    t1, _, _, _ = legacy.load_dataset('eq_1', seed=0, train_samples=8,
                                      val_samples=2, test_samples=2,
                                      total_time_steps=20, **F64)
    assert not np.allclose(t3['x'], t1['x'])
