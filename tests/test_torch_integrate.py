"""The port's Euler integration and sequence masks (`insite_tpu_torch/core/
integrate.py`, `core/masking.py`) against the JAX package's, in float64 on
the CPU: the five cases of `tests/test_integrate.py`, each also held to
the JAX function on the same inputs (rtol 1e-12, except the gradient,
held to JAX's and to central differences at rtol 1e-5), and the masks
(exact). Each test prints its largest deviation."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from insite_tpu.core import integrate as jax_integrate
from insite_tpu.core import masking as jax_masking
from insite_tpu_torch.core import (MAX_SEQUENCE_LENGTH, MAX_TIME_HORIZON,
                                   controlled_rollout, euler_odeint,
                                   euler_rollout, euler_step, length_mask,
                                   prefix_mask)

F64 = torch.float64


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    dev = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-300)))
    print(f'{what}: largest relative deviation {dev:.3e}')
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_constant_derivative_dense_grid():
    # dy/dt = 1  ->  y(t) = t  (exact for Euler)
    dt = MAX_TIME_HORIZON / MAX_SEQUENCE_LENGTH
    ts = torch.arange(0, MAX_TIME_HORIZON, dt, dtype=F64)
    y = euler_rollout(lambda y, t: torch.ones_like(y), t64(0.0), ts)
    assert torch.mean((y - ts) ** 2) < 1e-16
    ref = jax_integrate.euler_rollout(lambda y, t: jnp.ones_like(y),
                                      jnp.array(0.0), jnp.asarray(ts.numpy()))
    _close(y.numpy(), ref, 1e-12, 'constant derivative')


def test_exponential_decay_matches_substeps():
    # 5 substeps of linear decay == multiplicative factor (1 - c h)^5
    c, dt = 0.7, 1.0 / 6.0
    y = euler_step(lambda y, t: -c * y, t64(2.0), 0.0, dt)
    np.testing.assert_allclose(float(y), 2.0 * (1 - c * dt / 5) ** 5,
                               rtol=1e-12)
    ref = jax_integrate.euler_step(lambda y, t: -c * y, jnp.array(2.0), 0.0,
                                   dt)
    _close(float(y), float(ref), 1e-12, 'euler_step')


def test_batched_rollout_matches_scalar():
    c = t64(np.random.RandomState(0).uniform(0.1, 1.0, 32))
    ts = torch.linspace(0.0, 5.0, 30, dtype=F64)
    y0 = torch.full((32,), 10.0, dtype=F64)
    batched = euler_rollout(lambda y, t: -c * y, y0, ts)
    for i in [0, 7, 31]:
        single = euler_odeint(lambda y, t: -c[i] * y, y0[i], ts)
        np.testing.assert_allclose(batched[:, i].numpy(), single.numpy(),
                                   rtol=1e-12)
    cj = jnp.asarray(c.numpy())
    ref = jax_integrate.euler_rollout(lambda y, t: -cj * y,
                                      jnp.asarray(y0.numpy()),
                                      jnp.asarray(ts.numpy()))
    _close(batched.numpy(), ref, 1e-12, 'batched rollout')


def test_controlled_rollout_switches_dynamics():
    # alternating decay constants chosen by the control signal
    controls = torch.tensor([0, 1, 0, 1])
    c = t64([0.2, 0.9])

    def f(y, t, u):
        return -c[u] * y

    ys = controlled_rollout(f, t64(1.0), controls, 0.5)
    manual = t64(1.0)
    for u in [0, 1, 0, 1]:
        manual = euler_step(lambda y, t: -c[u] * y, manual, 0.0, 0.5)
    np.testing.assert_allclose(float(ys[-1]), float(manual), rtol=1e-12)
    assert ys.shape == (4,)
    cj = jnp.asarray(c.numpy())
    ref = jax_integrate.controlled_rollout(
        lambda y, t, u: -cj[u] * y, jnp.array(1.0),
        jnp.asarray(controls.numpy()), 0.5)
    _close(ys.numpy(), ref, 1e-12, 'controlled rollout')


def test_gradient_through_rollout():
    # INSITE backpropagates through the rollout; check d(final)/dc
    def loss(c):
        ts = torch.linspace(0.0, 1.0, 7, dtype=F64)
        return euler_rollout(lambda y, t: -c * y, t64(1.0), ts)[-1]

    c = t64(0.5).requires_grad_()
    g, = torch.autograd.grad(loss(c), c)
    eps = 1e-6
    with torch.no_grad():
        fd = (loss(t64(0.5 + eps)) - loss(t64(0.5 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-5)

    def jax_loss(c):
        ts = jnp.linspace(0.0, 1.0, 7)
        return jax_integrate.euler_rollout(lambda y, t: -c * y,
                                           jnp.array(1.0), ts)[-1]

    _close(float(g), float(jax.grad(jax_loss)(jnp.array(0.5))), 1e-5,
           'gradient')


def test_masks_match_jax():
    lengths = np.array([0, 3, 7, 5])
    got = length_mask(torch.as_tensor(lengths), 7)
    want = np.asarray(jax_masking.length_mask(jnp.asarray(lengths), 7))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        prefix_mask(6, 4).numpy(), np.asarray(jax_masking.prefix_mask(6, 4)))
    np.testing.assert_array_equal(
        prefix_mask(7, torch.as_tensor(lengths)).numpy(),
        np.asarray(jax_masking.prefix_mask(7, jnp.asarray(lengths))))
    print('masks: equal')
