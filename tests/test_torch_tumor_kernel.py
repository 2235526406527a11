"""The tumour simulator's day-loop kernels (`ops/tumor_sim.py`,
`csrc/tumor_sim.cu`): the route and the wrapper's refusal on the host, and
on a card each kernel against the Python loop it replaces
(`sim/tumor.py::_factual_loop`, `_cf_factual_loop`) on the same tensors.

Tolerances on the card: in float64 every value agrees to rtol 1e-12 and
every decision, length and flag is equal. In float32 values agree to rtol
1e-5 (the kernels round each operation as the loop's PyTorch operation
does; only the window's sum runs in another order), and a patient's
decisions may part only where the loop's draw lies within 1e-5 of its
probability or threshold; the days before that are compared.

This file imports no JAX, so the card-side tests run where JAX is absent:

    python -m pytest tests/test_torch_tumor_kernel.py --noconftest -m cuda -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from insite_tpu_torch import ops
from insite_tpu_torch.harness import vectorized
from insite_tpu_torch.ops import tumor_sim
from insite_tpu_torch.sim import cancer
from insite_tpu_torch.sim import tumor
from insite_tpu_torch.utils import profiling

T, PH = 60, 5
THR = tumor.TUMOUR_DEATH_THRESHOLD
TIE = 1e-5
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
FACTUAL_DECISIONS = ('chemo_application', 'radio_application',
                     'death_flags', 'recovery_flags')


def cohort(B, window, lag, noise_len, device, dtype, seed=0):
    """Parameters and draws of B patients: every fourth from the second on
    starts near the death threshold, every fourth from the third at a volume
    whose recovery draw fires, so both stops and the masking after them
    run."""
    rs = np.random.RandomState(seed)
    params = cancer.generate_params(B, 2.0, 2.0, window, lag, rs)
    params['initial_volumes'][1::4] = 0.97 * THR
    params['initial_volumes'][2::4] = 1e-10
    rvs = {'noise': 0.01 * rs.randn(B, noise_len),
           'recovery': rs.rand(B, T), 'chemo_rv': rs.rand(B, T),
           'radio_rv': rs.rand(B, T)}
    return (cancer.device_params(params, device, dtype),
            {k: torch.as_tensor(v, dtype=dtype, device=device)
             for k, v in rvs.items()})


# ---------------------------------------------------------------------------
# the route and the wrapper on the host (run everywhere)

def _refuse(*args, **kwargs):
    raise AssertionError('the kernel ran on host tensors')


def test_cores_take_the_loop_on_the_host_and_count_each_call(monkeypatch):
    params, rvs = cohort(12, 15, 1, T + PH, 'cpu', torch.float64)
    monkeypatch.setattr(tumor.tumor_sim, 'factual', _refuse)
    monkeypatch.setattr(tumor.tumor_sim, 'cf_factual', _refuse)
    tumor_sim.SIM_LAUNCHES = 5
    ops.reset_launch_counts()
    assert tumor_sim.SIM_LAUNCHES == 0
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = tumor.factual_core(params, rvs, T, 15, 1)
            got_cf = tumor.cf_factual_core(params, rvs, T, 15, 1)
            tumor.cf_factual_core(params, rvs, T, 15, 0)
        counted = profiling.totals()
    finally:
        profiling.reset()
    assert counted['sim.cores'] == 3
    assert 'sim.kernel_cores' not in counted
    want = tumor._factual_loop(params, rvs, T, 15, 1)
    want_cf = tumor._cf_factual_loop(params, rvs, T, 15, 1)
    for g, w in ((got, want), (got_cf, want_cf)):
        assert set(g) == set(w)
        for k in w:
            assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize('core', [tumor_sim.factual, tumor_sim.cf_factual])
def test_wrapper_refuses_host_tensors(core):
    params, rvs = cohort(4, 15, 0, T, 'cpu', torch.float32)
    with pytest.raises(ValueError, match='CUDA tensors only'):
        core([params[k] for k in tumor.PARAM_KEYS], rvs, T, 15, 0)


def test_kernel_names_leave_the_rollout_rooflines_alone():
    """The benchmark finds the rollout kernels by the substrings
    'rollout_kernel<' and 'rollout_sens_kernel<' of a kernel's name."""
    src = (Path(tumor_sim.__file__).parent.parent / 'csrc' /
           'tumor_sim.cu').read_text()
    names = re.findall(r'__global__ void (\w+)', src)
    assert names == ['tumor_factual_kernel', 'tumor_cf_factual_kernel']
    assert not any('rollout' in n for n in names)


# ---------------------------------------------------------------------------
# on a CUDA card (skipped without one: a CUDA kernel has no CPU mode)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    return torch.device('cuda')


def _host(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _diameter(v):
    return (v / (4.0 / 3.0 * np.pi)) ** (1.0 / 3.0) * 2.0


def _probability(metric, params, which, b):
    beta = params[f'{which}_sigmoid_betas'][b].item()
    icept = params[f'{which}_sigmoid_intercepts'][b].item()
    return 1.0 / (1.0 + np.exp(-beta * (metric - icept)))


def _stop_margin(v, draw, rule):
    """How far volume ``v`` lies from a stop: death (relative to the
    threshold) or recovery (the draw against exp(-v * cell density))."""
    if rule == 'death':
        return abs(THR - v) / THR
    return abs(draw - np.exp(-float(v) * tumor.TUMOUR_CELL_DENSITY))


def _first_parting(got, want, names, days):
    """Per patient, the first day on which any decision of ``names``
    differs (``days`` where none does)."""
    B = got[names[0]].shape[0]
    differs = np.zeros((B, days), bool)
    for k in names:
        differs[:, :got[k].shape[1]] |= got[k] != want[k]
    return np.where(differs.any(1), differs.argmax(1), days)


def _assert_tie_factual(b, d, got, want, rvs):
    """Each decision of patient b that parts on day d had its draw within
    TIE of its probability or threshold, as the loop has them."""
    for which in ('chemo', 'radio'):
        k = f'{which}_application'
        if got[k][b, d] != want[k][b, d]:
            margin = abs(rvs[f'{which}_rv'][b, d] -
                         want[f'{which}_probabilities'][b, d])
            assert margin < TIE, (b, d, k, margin)
    for k, rule in (('death_flags', 'death'), ('recovery_flags', 'recovery')):
        if got[k][b, d] != want[k][b, d]:
            stayed = got if got[k][b, d] == 0 else want
            margin = _stop_margin(stayed['cancer_volume'][b, d],
                                  rvs['recovery'][b, d], rule)
            assert margin < TIE, (b, d, k, margin)


def _cf_metric(volumes, b, t, window, lag):
    count = min(t - lag + 1, window + 1) if t >= lag else 0
    if count == 0:
        return 0.0
    first = t - lag - count + 1
    return _diameter(volumes[b, first:first + count].astype(float)).mean()


def _assert_tie_cf(b, d, got, want, stops, rvs, params, window, lag):
    metric = _cf_metric(want['volumes'], b, d, window, lag)
    for which in ('chemo', 'radio'):
        k = f'{which}_application'
        if got[k][b, d] != want[k][b, d]:
            margin = abs(rvs[f'{which}_rv'][b, d] -
                         _probability(metric, params, which, b))
            assert margin < TIE, (b, d, k, margin)
    if stops['got'][b, d] != stops['want'][b, d]:
        stayed = got if not stops['got'][b, d] else want
        v = stayed['volumes'][b, d + 1]
        margin = min(_stop_margin(v, rvs['recovery'][b, d], rule)
                     for rule in ('death', 'recovery'))
        assert margin < TIE, (b, d, 'stop', margin)


def _assert_agree(got, want, upto, days, dtype):
    """Every output equal (discrete) or within rtol, on each patient's days
    before ``upto``; the lengths of patients that never part."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.ndim == 1:
            keep = upto == days
            g, w = g[keep], w[keep]
        else:
            # an output of day t sits in column t (t + 1: cf volumes)
            shift = 1 if k == 'volumes' else 0
            keep = np.arange(w.shape[1])[None, :] < upto[:, None] + shift
            g, w = np.where(keep, g, 0), np.where(keep, w, 0)
        if w.dtype.kind == 'f' and k not in FACTUAL_DECISIONS:
            np.testing.assert_allclose(g, w, rtol=RTOL[dtype], atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


SHAPES = [(B, window, lag) for B in (1, 100, 1_000, 1_001)
          for window in (1, 15) for lag in (0, 1, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('B,window,lag', SHAPES)
def test_factual_kernel_matches_the_loop_on_cuda(cuda, dtype, B, window,
                                                 lag):
    for noise_len in (T, T + PH):
        params, rvs = cohort(B, window, lag, noise_len, cuda, dtype,
                             seed=B + window + lag)
        p = [params[k] for k in tumor.PARAM_KEYS]
        got = _host(tumor_sim.factual(p, rvs, T, window, lag))
        want = _host(tumor._factual_loop(params, rvs, T, window, lag))
        upto = _first_parting(got, want, FACTUAL_DECISIONS, T)
        if dtype == torch.float64:
            assert (upto == T).all(), np.flatnonzero(upto < T)
        h = {k: v.cpu().numpy().astype(float) for k, v in rvs.items()}
        for b in np.flatnonzero(upto < T):
            _assert_tie_factual(b, upto[b], got, want, h)
        _assert_agree(got, want, upto, T, dtype)
        if B >= 100:
            assert want['death_flags'].sum() > 0
            assert want['recovery_flags'].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('B,window,lag', SHAPES)
def test_cf_factual_kernel_matches_the_loop_on_cuda(cuda, dtype, B, window,
                                                    lag):
    for noise_len in (T, T + PH):
        params, rvs = cohort(B, window, lag, noise_len, cuda, dtype,
                             seed=B + window + lag + 1)
        p = [params[k] for k in tumor.PARAM_KEYS]
        got = _host(tumor_sim.cf_factual(p, rvs, T, window, lag))
        want = _host(tumor._cf_factual_loop(params, rvs, T, window, lag))
        # a stop on day t shows as active[t + 1]
        stops = {k: np.pad(side['active'][:, 1:] != side['active'][:, :-1],
                           ((0, 0), (0, 1)))
                 for k, side in (('got', got), ('want', want))}
        upto = _first_parting(
            dict(got, stop=stops['got']), dict(want, stop=stops['want']),
            ('chemo_application', 'radio_application', 'stop'), T - 1)
        if dtype == torch.float64:
            assert (upto == T - 1).all(), np.flatnonzero(upto < T - 1)
        h = {k: v.cpu().numpy().astype(float) for k, v in rvs.items()}
        hp = {k: v.cpu() for k, v in params.items()}
        for b in np.flatnonzero(upto < T - 1):
            _assert_tie_cf(b, upto[b], got, want, stops, h, hp, window, lag)
        _assert_agree(got, want, upto, T - 1, dtype)
        if B >= 100:
            assert not want['active'].all() and want['active'].any()


@pytest.mark.cuda
def test_kernel_path_counts_and_neither_reads_nor_waits_on_cuda(cuda):
    params, rvs = cohort(100, 15, 0, T + PH, cuda, torch.float32)
    tumor.factual_core(params, rvs, T, 15, 0)        # builds the library
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            torch.cuda.set_sync_debug_mode('error')
            try:
                tumor.factual_core(params, rvs, T, 15, 0)
                tumor.cf_factual_core(params, rvs, T, 15, 0)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counted = profiling.totals()
    finally:
        profiling.reset()
    assert counted['sim.cores'] == counted['sim.kernel_cores'] == 2
    assert tumor_sim.SIM_LAUNCHES == 2
    assert 'd2h.reads' not in counted


@pytest.mark.cuda
def test_a_tumor_cohort_through_the_kernels_is_the_loops_on_cuda(
        cuda, monkeypatch):
    draws = vectorized.tumor_draws(2**33 + 7, 'cancer_sim', 1_000, 100, T,
                                   2.0, PH, device=cuda, dtype=torch.float64)
    got = vectorized.tumor_cohort(draws, T, PH)
    monkeypatch.setattr(vectorized, 'factual_core', tumor._factual_loop)
    monkeypatch.setattr(vectorized, 'cf_factual_core',
                        tumor._cf_factual_loop)
    want = vectorized.tumor_cohort(draws, T, PH)
    assert set(got) == set(want) == {'train', 'one_step', 'n_step'}
    for name in want:
        assert len(got[name]) == len(want[name])
        for i, (g, w) in enumerate(zip(got[name], want[name])):
            assert g.shape == w.shape and g.dtype == w.dtype, (name, i)
            if w.dtype.is_floating_point:
                torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12,
                                           msg=f'{name}[{i}]')
            else:
                assert torch.equal(g, w), (name, i)
