"""The rollout kernels' dispatch: plain versions on CPU tensors (runs
everywhere), the CUDA kernels against their plain versions on a card.

This file imports no JAX, so the card-side tests run where JAX is absent:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.ops import build, rollout

BASE = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                 [0, -0.2, 0, 0, 0, -1.0, 0]]).astype(np.float32)


def eq4_case(B, T, shared, seed=0, spread=0.1):
    """(library keywords, coefs, y0, statics, arms, dt) on the EQ_4
    library."""
    rng = np.random.RandomState(seed)
    coefs = (BASE[None] if shared else
             BASE[None] * (1 + spread * rng.randn(B, 1, 1))).astype(
                 np.float32)
    y0 = (np.abs(rng.randn(B)) * 10 + 1).astype(np.float32)
    statics = rng.rand(B, 2).astype(np.float32)
    arms = rng.randint(0, 2, (B, T)).astype(np.int32)
    return dict(n_inputs=3), coefs, y0, statics, arms, 1 / 6


def four_arm_case():
    """Tumor-family layout: 4 arms on the (y, u) library, F=4."""
    rng = np.random.RandomState(1)
    B, T, A, F = 9, 7, 4, 4
    coefs = (0.1 * rng.randn(1, A, F)).astype(np.float32)
    y0 = (np.abs(rng.randn(B)) + 1).astype(np.float32)
    statics = rng.rand(B, 1).astype(np.float32)
    arms = rng.randint(0, A, (B, T)).astype(np.int32)
    return dict(n_inputs=2), coefs, y0, statics, arms, 1.0


def diverging_case(B=8, T=40, y0=5.0):
    """dy/dt = +y on the (y, u) library: diverges unless clipped."""
    coefs = np.zeros((1, 2, 4), np.float32)
    coefs[:, :, 1] = 1.0                      # feature 1 is y
    return (dict(n_inputs=2), coefs, np.full(B, y0, np.float32),
            np.ones((B, 1), np.float32), np.zeros((B, T), np.int32), 1.0)


DEGREE4 = dict(n_inputs=3, degree=4, interaction_only=False)


def wide_support_case(B=7, T=6, seed=3, n_small=14):
    """The degree-4 ablation library (F=35 over [y, c0, c1], powers of y up
    to 4) with 2 + n_small active coordinates over both arms: with the
    default 16, more than 8. Both take the kernels' shared-memory model.
    Decay on y plus n_small small terms keeps the state near 1."""
    rng = np.random.RandomState(seed)
    F = PolynomialLibrary(**DEGREE4).n_features
    coefs = np.zeros((1, 2, F), np.float32)
    coefs[0, :, 1] = -1.0                     # feature 1 is y
    others = rng.choice(np.delete(np.arange(2 * F), [1, F + 1]), n_small,
                        replace=False)
    coefs.reshape(-1)[others] = (0.05 * rng.choice([-1, 1], n_small)
                                 * (0.5 + rng.rand(n_small)))
    y0 = (rng.rand(B) + 0.5).astype(np.float32)
    statics = rng.rand(B, 2).astype(np.float32)
    arms = rng.randint(0, 2, (B, T)).astype(np.int32)
    return DEGREE4, coefs, y0, statics, arms, 1 / 6


def statics_zero_case():
    """Statics that are exactly 0 in some rows: every monomial of them is
    0, and their zeroth power is 1."""
    spec, coefs, y0, statics, arms, dt = eq4_case(50, 11, False, seed=8)
    statics[::3, 0] = 0
    statics[1::4, 1] = 0
    return spec, coefs, y0, statics, arms, dt


def eq4_six_coordinate_case():
    """The EQ_4 library with two more small terms: Kr = 6 active
    coordinates at D = 1, more than the register model's 4."""
    spec, coefs, y0, statics, arms, dt = eq4_case(41, 17, False, seed=9)
    coefs[:, 0, 2] = 0.05
    coefs[:, 1, 6] = -0.05
    return spec, coefs, y0, statics, arms, dt


def four_input_case():
    """The interaction-only library over four inputs [y, c0, c1, c2]: F=11,
    more than the 8 features of one of the kernel prologue's chunks."""
    rng = np.random.RandomState(11)
    B, T = 37, 12
    coefs = (0.2 * rng.randn(B, 2, 11)).astype(np.float32)
    return (dict(n_inputs=4), coefs, (rng.rand(B) + 0.5).astype(np.float32),
            rng.rand(B, 3).astype(np.float32),
            rng.randint(0, 2, (B, T)).astype(np.int32), 0.25)


TUMOUR_DEATH_THRESHOLD = 4.0 / 3.0 * np.pi * 6.5 ** 3


def tumor_case(B=61, T=29, seed=12):
    """The EQ_5 main table's layout: 4 arms switching per step on the
    interaction-only library over [y, patient type, dosage] (F=7), the
    four features 1, y, u0, y*u0 active on every arm (Kr=16: the kernels'
    shared-memory model), volumes up to the death threshold, and the state
    clipped to (0, TUMOUR_DEATH_THRESHOLD). Arms 0 and 1 grow into the
    upper bound, arm 3 decays into the lower one."""
    rng = np.random.RandomState(seed)
    base = np.array([[0.5, 0.6, 0.2, 0, -0.004, 0, 0],
                     [0.2, 0.3, 0.1, 0, 0.02, 0, 0],
                     [1.0, -0.2, -0.3, 0, 0.03, 0, 0],
                     [-40.0, -0.5, 2.0, 0, -0.05, 0, 0]])
    coefs = (base[None] * (1 + 0.1 * rng.randn(B, 4, 7))).astype(np.float32)
    y0 = (rng.rand(B) * TUMOUR_DEATH_THRESHOLD).astype(np.float32)
    statics = np.stack([rng.randint(1, 4, B), 10 * rng.rand(B)],
                       axis=1).astype(np.float32)
    arms = rng.randint(0, 4, (B, T)).astype(np.int32)
    return dict(n_inputs=3), coefs, y0, statics, arms, 1 / 6


TUMOR_CLIP = (0.0, TUMOUR_DEATH_THRESHOLD)


CASES = {'shared': lambda: eq4_case(37, 15, True),
         'per_patient': lambda: eq4_case(5, 9, False),
         'per_patient_333': lambda: eq4_case(333, 20, False, seed=2),
         'four_arms': four_arm_case,
         'wide_support': wide_support_case,
         # the degree-4 library with Kr = 6 <= 8
         'degree4_small_kr': lambda: wide_support_case(40, 13, n_small=4),
         # B a multiple of neither block, T of no time tile
         'ragged_b70_t37': lambda: eq4_case(70, 37, False, seed=5),
         'statics_zero': statics_zero_case,
         'eq4_kr6': eq4_six_coordinate_case,
         'four_inputs': four_input_case}


def active(coefs):
    return tuple(int(i) for i in
                 np.flatnonzero(np.abs(coefs[0].reshape(-1)) > 1e-3))


def run_port(fn, case, *extra, device='cpu', dtype=torch.float32, **kw):
    spec, coefs, y0, statics, arms, dt = case
    f = dict(dtype=dtype, device=device)
    return fn(PolynomialLibrary(**spec), torch.as_tensor(coefs, **f),
              torch.as_tensor(y0, **f), torch.as_tensor(statics, **f),
              torch.as_tensor(arms, device=device), dt, *extra, **kw)


def test_cpu_tensors_take_the_plain_path():
    rollout.reset_launch_counts()
    case = eq4_case(5, 9, False)
    out = run_port(rollout.batched_rollout, case)
    ref = run_port(rollout.batched_rollout_plain, case)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    y, s = run_port(rollout.rollout_with_sens, case, active(case[1]))
    y_ref, s_ref = run_port(rollout.rollout_with_sens_plain, case,
                            active(case[1]))
    torch.testing.assert_close((y, s), (y_ref, s_ref), rtol=0, atol=0)
    assert rollout.ROLLOUT_LAUNCHES == 0 and rollout.SENS_LAUNCHES == 0


@pytest.mark.parametrize('fn,extra', [
    (rollout._rollout_cuda, (rollout.STEPS_FOR_DT, None)),
    (rollout._sens_cuda, ((1, 4), rollout.STEPS_FOR_DT, None))])
def test_kernel_wrappers_refuse_cpu_tensors(fn, extra):
    with pytest.raises(ValueError, match='CUDA tensors'):
        run_port(fn, eq4_case(5, 9, False), *extra)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setattr(build, 'DEFAULT_NVCC', tmp_path / 'nvcc')
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.find_nvcc()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, 'find_nvcc', lambda: 'false')
    monkeypatch.setattr(build, 'BUILD_ROOT', tmp_path)
    with pytest.raises(RuntimeError, match='nvcc failed'):
        build.build_library()
    assert not list(tmp_path.rglob('*.so'))


def test_tumor_case_plain_versions_agree():
    """Both plain versions on the tumor layout in f64: the same clipped
    states, both bounds reached, and sensitivities zero wherever a step
    was clipped."""
    case = tumor_case()
    act = active(case[1])
    assert len(act) == 16
    y = run_port(rollout.batched_rollout_plain, case, dtype=torch.float64,
                 y_clip=TUMOR_CLIP)
    ys, s = run_port(rollout.rollout_with_sens_plain, case, act,
                     dtype=torch.float64, y_clip=TUMOR_CLIP)
    torch.testing.assert_close(ys, y, rtol=0, atol=0)
    at_bound = (y == 0) | (y == TUMOR_CLIP[1])
    assert (y == 0).any() and (y == TUMOR_CLIP[1]).any()
    assert not s[at_bound].any() and s[~at_bound].abs().sum() > 0


def test_sensitivity_is_the_derivative_of_the_rollout():
    """The plain recurrence against central differences of the plain
    rollout in f64 (what the kernel is then held to on the card)."""
    spec, coefs, y0, statics, arms, dt = eq4_case(4, 10, False)
    coefs = coefs.astype(np.float64)
    act = active(coefs)
    _, s = run_port(rollout.rollout_with_sens_plain,
                    (spec, coefs, y0, statics, arms, dt), act,
                    dtype=torch.float64)
    eps = 1e-6
    for j, i in enumerate(act):
        up, down = coefs.copy(), coefs.copy()
        up.reshape(4, -1)[:, i] += eps
        down.reshape(4, -1)[:, i] -= eps
        fd = (run_port(rollout.batched_rollout_plain,
                       (spec, up, y0, statics, arms, dt),
                       dtype=torch.float64)
              - run_port(rollout.batched_rollout_plain,
                         (spec, down, y0, statics, arms, dt),
                         dtype=torch.float64)) / (2 * eps)
        # central difference: truncation ~eps^2, rounding ~1e-16/eps
        torch.testing.assert_close(s[..., j], fd, rtol=1e-7, atol=1e-8)


# ---------------------------------------------------------------------------
# on a CUDA card (skipped without one: a CUDA kernel has no CPU mode)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# (rtol, atol): f32 kernels contract to FMA and sum in another order than
# the plain version over T * 5 sub-steps; f64 is held tightly
TOL = {torch.float32: (2e-5, 1e-5), torch.float64: (1e-10, 1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('name', sorted(CASES) + ['y_clip'])
def test_kernels_match_plain_on_cuda(cuda, dtype, name):
    case = diverging_case() if name == 'y_clip' else CASES[name]()
    clip = (0.0, 10.0) if name == 'y_clip' else None
    act = active(case[1])
    rtol, atol = TOL[dtype]
    rollout.reset_launch_counts()
    out = run_port(rollout.batched_rollout, case, device=cuda, dtype=dtype,
                   y_clip=clip)
    ref = run_port(rollout.batched_rollout_plain, case, device=cuda,
                   dtype=dtype, y_clip=clip)
    y, s = run_port(rollout.rollout_with_sens, case, act, device=cuda,
                    dtype=dtype, y_clip=clip)
    y_ref, s_ref = run_port(rollout.rollout_with_sens_plain, case, act,
                            device=cuda, dtype=dtype, y_clip=clip)
    torch.cuda.synchronize()
    assert rollout.ROLLOUT_LAUNCHES == 1 and rollout.SENS_LAUNCHES == 1
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(s, s_ref, rtol=10 * rtol, atol=10 * atol)


@pytest.mark.cuda
def test_kernel_rejects_shapes_outside_its_bounds(cuda):
    # the bounds compiled into the kernels take the degree-4 library over
    # both arms (F=35, every one of its 70 coordinates) and the tumor
    # family's 4 arms
    bound = rollout.kernel_bounds()
    assert (bound['F'] >= 35 and bound['n_inputs'] >= 3
            and bound['arms'] >= 4 and bound['Kr'] >= 70)
    lib = PolynomialLibrary(n_inputs=3, degree=6, interaction_only=False)
    B, T = 4, 3
    coefs = torch.zeros(1, 2, lib.n_features, device=cuda)   # F = 84 > 64
    with pytest.raises(ValueError, match='kernel bounds'):
        rollout.batched_rollout(lib, coefs, torch.ones(B, device=cuda),
                                torch.ones(B, 2, device=cuda),
                                torch.zeros(B, T, dtype=torch.int32,
                                            device=cuda), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('A', [4, 8])
def test_out_of_range_arm_selects_arm_zero_on_cuda(cuda, dtype, A):
    """Arms -1 and A select arm 0's coefficients, as the Pallas kernel's
    select chain does, and also drive arm 0's sensitivities (the Pallas
    kernel tests the raw arm there), so the sensitivities stay derivatives
    of the output. The plain version, which indexes by the arm, is given
    arm 0 there. A=4 takes the register model, A=8 the shared-memory one."""
    rng = np.random.RandomState(4)
    B, T, F = 45, 23, 4
    coefs = (0.3 * rng.randn(B, A, F)).astype(np.float32)
    arms = rng.randint(-1, A + 1, (B, T)).astype(np.int32)
    assert (arms == -1).any() and (arms == A).any()
    in_range = np.where((arms >= 0) & (arms < A), arms, 0)
    spec, y0 = dict(n_inputs=2), (np.abs(rng.randn(B)) + 1).astype(np.float32)
    statics = rng.rand(B, 1).astype(np.float32)
    act = (1, 3, 6, 4 * F - 1)
    case = (spec, coefs, y0, statics, arms, 0.5)
    ref_case = (spec, coefs, y0, statics, in_range, 0.5)
    rtol, atol = TOL[dtype]
    out = run_port(rollout.batched_rollout, case, device=cuda, dtype=dtype)
    ref = run_port(rollout.batched_rollout_plain, ref_case, device=cuda,
                   dtype=dtype)
    y, s = run_port(rollout.rollout_with_sens, case, act, device=cuda,
                    dtype=dtype)
    y_ref, s_ref = run_port(rollout.rollout_with_sens_plain, ref_case, act,
                            device=cuda, dtype=dtype)
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(s, s_ref, rtol=10 * rtol, atol=10 * atol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_unclipped_divergence_is_non_finite_on_cuda(cuda, dtype):
    """dy/dt = +y without y_clip: the rows that start near the type's
    largest value overflow within the 200 sub-steps, and exactly those
    rows are non-finite in the kernels' outputs and the plain versions'.
    The other rows stay finite and agree."""
    spec, coefs, _, statics, arms, dt = diverging_case()
    big = 1e30 if dtype == torch.float32 else 1e300
    y0 = np.array([5.0, big] * 4)
    case = (spec, coefs, y0, statics, arms, dt)
    act = active(coefs)
    rtol, atol = TOL[dtype]
    out = run_port(rollout.batched_rollout, case, device=cuda, dtype=dtype)
    ref = run_port(rollout.batched_rollout_plain, case, device=cuda,
                   dtype=dtype)
    y, s = run_port(rollout.rollout_with_sens, case, act, device=cuda,
                    dtype=dtype)
    y_ref, s_ref = run_port(rollout.rollout_with_sens_plain, case, act,
                            device=cuda, dtype=dtype)
    overflow = torch.tensor([False, True] * 4, device=cuda)
    for got, want in ((out, ref), (y, y_ref), (s, s_ref)):
        assert torch.equal(~torch.isfinite(want).flatten(1).all(1), overflow)
        assert torch.equal(~torch.isfinite(got).flatten(1).all(1), overflow)
    torch.testing.assert_close(out[~overflow], ref[~overflow], rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(s[~overflow], s_ref[~overflow],
                               rtol=10 * rtol, atol=10 * atol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_tumor_shape_matches_plain_on_cuda(cuda, dtype):
    """A = 4, F = 7 over 3 inputs, Kr = 16 (the shared-memory model) and
    y_clip = (0, TUMOUR_DEATH_THRESHOLD): the kernels against their plain
    versions."""
    case = tumor_case()
    act = active(case[1])
    rtol, atol = TOL[dtype]
    rollout.reset_launch_counts()
    out = run_port(rollout.batched_rollout, case, device=cuda, dtype=dtype,
                   y_clip=TUMOR_CLIP)
    ref = run_port(rollout.batched_rollout_plain, case, device=cuda,
                   dtype=dtype, y_clip=TUMOR_CLIP)
    y, s = run_port(rollout.rollout_with_sens, case, act, device=cuda,
                    dtype=dtype, y_clip=TUMOR_CLIP)
    y_ref, s_ref = run_port(rollout.rollout_with_sens_plain, case, act,
                            device=cuda, dtype=dtype, y_clip=TUMOR_CLIP)
    torch.cuda.synchronize()
    assert rollout.ROLLOUT_LAUNCHES == 1 and rollout.SENS_LAUNCHES == 1
    assert (ref == 0).any() and (ref == TUMOR_CLIP[1]).any()
    torch.testing.assert_close(out, ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(s, s_ref, rtol=10 * rtol, atol=10 * atol)
