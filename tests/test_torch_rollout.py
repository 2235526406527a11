"""Rollout and rollout-with-sensitivities: the port's plain versions (the
CPU path) against the JAX rollout and the Pallas kernels in interpret
mode, on the cases of tests/test_pallas_rollout.py. The kernels' own tests
are in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.models.sindy import batched_rollout as jax_rollout
from insite_tpu.ops.pallas_rollout import (pallas_batched_rollout,
                                           pallas_rollout_with_sens)
from insite_tpu_torch.ops import rollout
from test_torch_kernels import (active, diverging_case, eq4_case,
                                four_arm_case, run_port,
                                wide_support_case)


def _jax_refs(case, y_clip=None):
    spec, coefs, y0, statics, arms, dt = case
    lib = JaxLibrary(**spec)
    args = (lib, jnp.asarray(coefs), jnp.asarray(y0), jnp.asarray(statics),
            jnp.asarray(arms), dt)
    shared = coefs.shape[0] == 1
    xla = jax_rollout(*args, shared_coefs=shared, y_clip=y_clip)
    pallas = pallas_batched_rollout(*args, shared_coefs=shared,
                                    y_clip=y_clip, interpret=True)
    return np.asarray(xla), np.asarray(pallas)


CASES = {'shared': lambda: eq4_case(37, 15, True),
         'per_patient': lambda: eq4_case(5, 9, False),
         'four_arms': four_arm_case}


@pytest.mark.parametrize('name', sorted(CASES))
def test_rollout_matches_jax_and_pallas(name):
    case = CASES[name]()
    xla, pallas = _jax_refs(case)
    out = run_port(rollout.batched_rollout, case).numpy()
    # f32, as the JAX kernel test: the same Euler arithmetic, sums and
    # products grouped differently
    np.testing.assert_allclose(out, xla, rtol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=1e-6)


def test_rollout_y_clip_matches_jax_and_pallas():
    case = diverging_case()
    free = run_port(rollout.batched_rollout, case)
    assert float(free.max()) > 1e6
    clip = (0.0, 10.0)
    xla, pallas = _jax_refs(case, y_clip=clip)
    out = run_port(rollout.batched_rollout, case, y_clip=clip).numpy()
    assert out.max() <= 10.0 and np.isfinite(out).all()
    np.testing.assert_allclose(out, xla, rtol=1e-6)
    np.testing.assert_allclose(out, pallas, rtol=1e-6)


def test_sens_matches_pallas_sens_kernel():
    case = eq4_case(6, 12, False, spread=0.05)
    spec, coefs, y0, statics, arms, dt = case
    act = active(coefs)
    ref_y, ref_s = (np.asarray(a) for a in pallas_rollout_with_sens(
        JaxLibrary(**spec), jnp.asarray(coefs), jnp.asarray(y0),
        jnp.asarray(statics), jnp.asarray(arms), dt, act, interpret=True))
    y, s = (a.numpy()
            for a in run_port(rollout.rollout_with_sens, case, act))
    assert s.shape == (6, 12, len(act))
    # f32 tolerances of the JAX kernel test against jacfwd
    np.testing.assert_allclose(y, ref_y, rtol=2e-5)
    np.testing.assert_allclose(s, ref_s, rtol=2e-4, atol=1e-5)


def test_sens_wide_support_matches_jacfwd():
    """Kr = 16 coordinates of the degree-4 library: the width at which the
    CUDA sensitivity kernel switches to its Kr <= 72 instantiation. The
    reference is jacfwd through the JAX rollout (the Pallas kernel unrolls
    F * Kr monomials per sub-step, too slow to trace in interpret mode)."""
    import jax
    spec, coefs, y0, statics, arms, dt = wide_support_case()
    coefs = coefs.astype(np.float64)
    case = (spec, coefs, y0.astype(np.float64), statics.astype(np.float64),
            arms, dt)
    act = np.asarray(active(coefs))
    assert len(act) == 16 and coefs.shape[-1] == 35

    def roll(c_act):
        c = jnp.asarray(coefs).reshape(-1).at[act].set(c_act)
        return jax_rollout(JaxLibrary(**spec), c.reshape(coefs.shape),
                           *map(jnp.asarray, case[2:5]), dt,
                           shared_coefs=True)

    c_act = jnp.asarray(coefs.reshape(-1)[act])
    ref_y = np.asarray(roll(c_act))
    ref_s = np.asarray(jax.jacfwd(roll)(c_act))             # [B, T, Kr]
    y, s = (a.numpy() for a in run_port(rollout.rollout_with_sens, case,
                                        tuple(act), dtype=torch.float64))
    # f64: the same recurrence as the jvp, its terms grouped differently
    np.testing.assert_allclose(y, ref_y, rtol=1e-12)
    np.testing.assert_allclose(s, ref_s, rtol=1e-9, atol=1e-12)


def test_sens_y_clip_zeroes_sensitivity_like_pallas():
    spec, coefs, y0, statics, arms, dt = diverging_case(B=3, T=10)
    coefs = np.repeat(coefs, 3, 0)
    y0 = np.array([1.0, 2.0, 3.0], np.float32)
    case = (spec, coefs, y0, statics, arms, dt)
    act = (1,)
    ref_y, ref_s = (np.asarray(a) for a in pallas_rollout_with_sens(
        JaxLibrary(**spec), jnp.asarray(coefs), jnp.asarray(y0),
        jnp.asarray(statics), jnp.asarray(arms), dt, act, y_clip=(0.0, 5.0),
        interpret=True))
    y, s = (a.numpy() for a in run_port(rollout.rollout_with_sens, case,
                                        act, y_clip=(0.0, 5.0)))
    assert y.max() <= 5.0
    assert np.all(s[:, -1] == 0.0)          # clipped: jnp.clip's jvp is 0
    np.testing.assert_allclose(y, ref_y, rtol=2e-5)
    np.testing.assert_allclose(s, ref_s, rtol=2e-4, atol=1e-5)
