#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`insite_tpu_torch`) on one NVIDIA
card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device   require CUDA; print the card and its power limit; TF32 off.
2. build    compile csrc/rollout.cu with nvcc for sm_90a (timed); print
            each kernel's registers, stack and spills from ptxas, and
            fail unless ptxas lists all 8 instantiations and no
            SmallModel one spills or uses a stack.
3. kernels  each rollout kernel against its plain PyTorch version on the
            card, f32 and f64, at the north-star shape (B=10,000, T=59,
            A=2, F=7, S=2, Kr=3), at B=2048, T=60, in a 4-arm case
            with y_clip, on the degree-4 library (F=35) with Kr=16
            active coordinates (the kernels' shared-memory model), and at
            the main table's shapes, taken from an EQ_4_D collection of
            the default size: the n-step test set (B=59,000, T=64,
            per-step arms, per-row coefficients, Kr = the fitted support)
            and the 1-step test set (B=11,800, T=59, shared
            coefficients), and at the tumor main table's shapes, taken from
            a cancer_sim and an EQ_5_D collection of the default size (4
            arms switching per step, y_clip (0, TUMOUR_DEATH_THRESHOLD),
            Kr = the fitted support, ~16: the shared-memory model; n-step
            with per-row coefficients, 1-step shared). First, before any
            plain version runs, the device time of one launch of each
            kernel (torch.profiler, median of 20 launches, one session) at
            the north-star, n-step, 1-step, degree-4 and tumor shapes, each
            beside its bound: the
            larger of the bytes the call must move over 3.35 TB/s and the
            floating-point operations of the collapsed recurrence over
            67 TFLOP/s (f32). Timed shapes also get the call time (CUDA
            events, median of 20 calls) of kernel and plain version.
4. path     the 10,000-patient EQ_4_D north star (simulate -> discover ->
            INSITE fine-tune), after an untimed warm-up and a check of the
            f32 card path against the f64 CPU path on a small cohort;
            asserts that the fine-tune went through the kernels.
5. table    the EQ_4 main table through the port's sweep: sindy and insite
            on EQ_4_A..D, one seed, 1,000 / 100 / 100 patients, f32, with
            faults raised (debug mode); asserts 8 rows, the kernel launches
            of the path (16 rollout, 104 sensitivity) and the RMSE bands,
            and prints each run's stage times and peak device memory and
            the LaTeX tables. Then one EQ_4_D collection (200 / 10 / 10):
            insite f32 on the card against insite f64 on the host (the
            same support, coefficients within rtol 1e-3, RMSEs within 5 %).
6. tumor    the tumor main table through the port's sweep: sindy and insite
            on cancer_sim and EQ_5_A..D, seed 0, 1,000 / 100 / 100, f32,
            debug mode; asserts 10 rows, the launches of the path (20
            rollout; 130 sensitivity unless a fit has an empty support,
            which it then names), every 1-step and 6-step RMSE within 1 %
            of the JAX package's at the same seed (`TUMOR_REF`), and insite
            below sindy at 1 step on every dataset; prints each run's stage
            times, peak device memory and fitted Kr. Then one cancer_sim
            collection (200 / 10 / 10): insite f32 on the card against
            insite f64 on the host, as for EQ_4_D (the same support,
            coefficients within rtol 1e-3, RMSEs within 5 %).

The last two lines of stdout are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import re
import statistics
import subprocess
import sys
import tempfile
from time import perf_counter

import numpy as np

N_PATIENTS = 10_000
GN_ITERS = 12
KERNEL_SOURCE = 'insite_tpu_torch/csrc/rollout.cu'
DATASETS = ('EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D')
TUMOR_DATASETS = ('cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D')
# The JAX package's tumor main table at seed 0, 1,000 / 100 / 100 patients,
# float64 on the CPU: (encoder_test_rmse_orig, decoder_test_rmse_6-step), %,
# from `JAX_PLATFORMS=cpu python3 tools/tumor_reference_rmses.py --seed 0`.
# On EQ_5_A and EQ_5_B the JAX package's unbias refit raises LinAlgError
# (their single patient type makes 'u0' a copy of '1'); their values are the
# same command's rerun with the minimum-norm refit, which the port takes.
TUMOR_REF = {
    ('cancer_sim', 'sindy'): (1.375753841190088, 1.1567399989461096),
    ('cancer_sim', 'insite'): (0.9495069999323345, 0.9166988174165825),
    ('EQ_5_A', 'sindy'): (1.092156744755332, 1.5449219959967768),
    ('EQ_5_A', 'insite'): (0.6309203215798459, 1.0836684597035349),
    ('EQ_5_B', 'sindy'): (1.5722963802898904, 1.0111978452568968),
    ('EQ_5_B', 'insite'): (1.1344229551012321, 0.7550049068694608),
    ('EQ_5_C', 'sindy'): (0.969143904860586, 1.2316755144716176),
    ('EQ_5_C', 'insite'): (0.5085251061091012, 0.7123398744724335),
    ('EQ_5_D', 'sindy'): (1.3093144947186854, 1.1824034119827571),
    ('EQ_5_D', 'insite'): (0.7795798356068124, 0.8881275139276769)}
# card f32 against the JAX package's f64 at the same cohort: the largest gap
# measured is 0.003 % (EQ_5_B insite, 1 step)
TUMOR_RTOL = 0.01
# the main table's accuracy bands (normalised RMSE, %), set from the JAX
# package's 10-seed means: insite 1-step 0.0014 (A) and 0.020-0.021 (B-D),
# 6-step 0.025-0.049; sindy 0.11-0.14 at both horizons
BANDS = {('insite', 'encoder_test_rmse_orig'): {'EQ_4_A': 0.01,
                                                'default': 0.05},
         ('sindy', 'encoder_test_rmse_orig'): {'default': 0.3},
         ('insite', 'decoder_test_rmse_6-step'): {'default': 0.15},
         ('sindy', 'decoder_test_rmse_6-step'): {'default': 0.3}}
# (rtol, atol), elementwise |kernel - plain| <= atol + rtol * |plain|.
# f32: nvcc contracts multiply-adds to FMA and the kernel sums the library
# terms in another order than PyTorch, over T * 5 dependent sub-steps
# (~300 roundings of 6e-8 each); sensitivities add a product per sub-step.
# f64: the same differences at 1e-16 per rounding.
TOL = {'f32': {'y': (1e-4, 1e-4), 'sens': (1e-3, 1e-3)},
       'f64': {'y': (1e-10, 1e-10), 'sens': (1e-9, 1e-9)}}
# NVIDIA H100 SXM at its 700 W limit (data sheet): device memory rate and
# the float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
KERNEL_NAMES = {'rollout': 'rollout_kernel<', 'sens': 'rollout_sens_kernel<'}
# every instantiation in csrc/rollout.cu, as ptxas_report labels it: the
# no-spill gate must see each SmallModel one
PTXAS_KERNELS = [f'{k}<{r}, {m}<{r}>>'
                 for k in ('rollout_kernel', 'rollout_sens_kernel')
                 for r in ('float', 'double')
                 for m in ('SmallModel', 'GeneralModel')]


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Median wall time per call on the stream (CUDA events), launch
    overhead included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_times(jobs, reps=20):
    """{label: median device time of one launch (ms)} for jobs of
    (label, kernel key, fn), from one torch.profiler session: each fn runs
    reps times, after a warm-up call outside the session, and a fill kernel
    marks the boundary between jobs. One session only: the profiler has
    returned no kernel events at all in a later session of the same process.
    A launch the profiler misses costs one sample, not the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _, _, fn in jobs:
        fn()
    marker = torch.zeros(1, device='cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker.fill_(1.0)
        for _, _, fn in jobs:
            marker.fill_(1.0)
            for _ in range(reps):
                fn()
        marker.fill_(1.0)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spans, span = [], []
    for e in events:
        if 'FillFunctor' in e.name:
            if span:
                spans.append(span)
            span = []
        else:
            span.append(e)
    if len(spans) != len(jobs):
        raise AssertionError(f'the profiler session split into {len(spans)} '
                             f'spans for {len(jobs)} jobs')
    out = {}
    for (label, kernel, _), span in zip(jobs, spans):
        us = [e.time_range.end - e.time_range.start for e in span
              if KERNEL_NAMES[kernel] in e.name]
        if len(us) < reps // 2:
            raise AssertionError(f'the profiler saw {len(us)} {kernel} '
                                 f'kernel launches in {reps} calls ({label})')
        out[label] = statistics.median(us) / 1e3
    return out


def kernel_times(cases, device):
    """Device time of one launch and the bound of both kernels, f32, at the
    given shapes: {tag: {'rollout_device_ms', 'rollout_bound_ms',
    'rollout_bound_by', and the same for 'sens'}}."""
    import torch
    from insite_tpu_torch.ops import rollout
    jobs = []
    for tag, case in cases.items():
        a = tensors(case, torch.float32, device)
        act, clip = case['active_idx'], case['y_clip']
        jobs.append(((tag, 'rollout'), 'rollout',
                     lambda a=a, clip=clip: rollout.batched_rollout(
                         *a, y_clip=clip)))
        jobs.append(((tag, 'sens'), 'sens',
                     lambda a=a, act=act, clip=clip: rollout.rollout_with_sens(
                         *a, act, y_clip=clip)))
    dev = device_times(jobs)
    out = {}
    for tag, case in cases.items():
        t = out[tag] = {}
        for key in ('rollout', 'sens'):
            t[f'{key}_device_ms'] = dev[tag, key]
            t[f'{key}_bound_ms'], t[f'{key}_bound_by'] = kernel_bound(case,
                                                                      key)
            dev_ms, bound = t[f'{key}_device_ms'], t[f'{key}_bound_ms']
            log(f'  {tag} f32 {key} device time per launch (profiler, median '
                f'of 20) {dev_ms:.4f} ms; bound {bound:.4f} ms '
                f'({t[f"{key}_bound_by"]}), {100 * bound / dev_ms:.1f} % of '
                'it')
    return out


def kernel_bound(case, kernel):
    """The least time (ms) the card could take for one f32 call: the larger
    of the bytes it must move (each input read once: coefficients, y0,
    statics, int32 arms; each output written once: y [B, T] and, for the
    sensitivities, [B, T, Kr]) over the memory rate, and the floating-point
    operations of the collapsed recurrence over the f32 rate. Per sub-step
    of a patient: Horner's rule for p (2 D), the update y + h p (2); the
    sensitivities add Horner for p' (2 (D - 1)) and, per coordinate j,
    y^e_j for its drive (e_j) and s + h (p' s + drive) (4). Per patient,
    2 A F for the collapse of the library. Returns (ms, 'bytes' or
    'operations')."""
    from insite_tpu_torch.core.constants import STEPS_FOR_DT
    coefs, arms = np.asarray(case['coefs']), case['arms']
    B, T = arms.shape
    A, F = coefs.shape[-2:]
    S = case['statics'].shape[1]
    exps = case['library'].exponents()
    D = int(exps[:, 0].max())
    n_bytes = 4 * (coefs.size + B + B * S + B * T)
    per_substep = 2 * D + 2
    n_out = 1
    if kernel == 'sens':
        act = case['active_idx']
        n_out += len(act)
        per_substep += (2 * max(D - 1, 0) + 4 * len(act)
                        + sum(int(exps[i % F, 0]) for i in act))
    n_bytes += 4 * B * T * n_out
    flops = B * T * STEPS_FOR_DT * per_substep + 2 * B * A * F
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            'bytes' if t_bytes >= t_ops else 'operations')


def ptxas_report(log_text):
    """Per kernel in nvcc's -Xptxas -v output: (label, registers, stack
    bytes, spill store bytes, spill load bytes)."""
    rows, name, frame = [], None, None
    for line in log_text.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            name = m.group(1)
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            frame = tuple(map(int, m.groups()))
        m = re.search(r'Used (\d+) registers', line)
        if m and name and frame and 'kernel' in name:
            kernel = ('rollout_sens_kernel' if 'rollout_sens_kernel' in name
                      else 'rollout_kernel')
            real = 'double' if f'{len(kernel)}{kernel}Id' in name else 'float'
            model = ('SmallModel' if 'SmallModel' in name
                     else 'GeneralModel') + f'<{real}>'
            rows.append((f'{kernel}<{real}, {model}>', int(m.group(1)))
                        + frame)
            name = frame = None
    return rows


def check_close(name, got, want, rtol, atol, rows=None):
    """Raise unless every entry (of the given rows) is within tolerance;
    returns the largest absolute error."""
    err = (got - want).abs()
    ok = err <= atol + rtol * want.abs()
    if rows is not None:
        err, ok = err[rows], ok[rows]
    n_bad = int((~ok).sum())
    max_err = float(err.max())
    if n_bad:
        raise AssertionError(f'{name}: {n_bad} entries outside rtol={rtol} '
                             f'atol={atol}; max abs err {max_err:.3e}')
    return max_err


# ---------------------------------------------------------------------------
# kernel cases

def eq4_case(B, T, per_patient, seed):
    """EQ_4-like inputs: the discovered model's support (x0*u0 on arm 0,
    x0 and x0*u1 on arm 1: flat indices 4, 8, 12), statics 0.5 +- 0.05,
    volumes in [1, 50), a time-constant arm per patient."""
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    rng = np.random.RandomState(seed)
    base = np.zeros((2, 7))
    base[0, 4] = -1.05
    base[1, 1], base[1, 5] = -0.14, -1.02
    coefs = (base[None] * (1 + 0.05 * rng.randn(B, 2, 7)) if per_patient
             else base[None])
    arms = np.repeat(rng.randint(0, 2, (B, 1)), T, axis=1)
    return dict(library=PolynomialLibrary(n_inputs=3), coefs=coefs,
                y0=rng.rand(B) * 49 + 1,
                statics=0.5 + 0.05 * rng.randn(B, 2), arms=arms,
                dt=1 / 6, active_idx=(4, 8, 12), y_clip=None)


def four_arm_clip_case(B, T, seed):
    """Tumor-family layout: 4 arms switching per step, growth on two of
    them, the state clipped to (0, 60)."""
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    rng = np.random.RandomState(seed)
    base = np.array([[0.0, 0.8, 0.0, 0.0],       # 1, y, u, y*u
                     [0.0, 0.0, 0.0, -1.5],
                     [2.0, 0.5, 0.0, -0.3],
                     [5.0, -2.0, 0.0, 0.0]])
    coefs = base[None] * (1 + 0.05 * rng.randn(B, 4, 4))
    active = tuple(int(i) for i in np.flatnonzero(base.reshape(-1)))
    return dict(library=PolynomialLibrary(n_inputs=2), coefs=coefs,
                y0=rng.rand(B) * 49 + 1, statics=0.5 + 0.05 * rng.randn(B, 1),
                arms=rng.randint(0, 4, (B, T)), dt=1 / 6, active_idx=active,
                y_clip=(0.0, 60.0))


def wide_support_case(B, T, seed):
    """The degree-4 ablation library (F=35 over [y, c0, c1]) with 16
    active coordinates over both arms (Kr > 8: the sensitivity kernel's
    Kr <= 72 instantiation). Decay on y plus 14 small terms keeps the state
    near 1."""
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    rng = np.random.RandomState(seed)
    library = PolynomialLibrary(n_inputs=3, degree=4, interaction_only=False)
    F = library.n_features
    base = np.zeros((2, F))
    base[:, 1] = -1.0                            # feature 1 is y
    others = rng.choice(np.delete(np.arange(2 * F), [1, F + 1]), 14,
                        replace=False)
    base.reshape(-1)[others] = (0.05 * rng.choice([-1, 1], 14)
                                * (0.5 + rng.rand(14)))
    active = tuple(int(i) for i in np.flatnonzero(base.reshape(-1)))
    assert len(active) == 16
    return dict(library=library,
                coefs=base[None] * (1 + 0.05 * rng.randn(B, 2, F)),
                y0=rng.rand(B) + 0.5, statics=rng.rand(B, 2),
                arms=rng.randint(0, 2, (B, T)), dt=1 / 6,
                active_idx=active, y_clip=None)


def table_cases(name, device, seeds):
    """Kernel inputs at a main table's shapes, from one collection of
    ``name`` of the default size on the card and the INSITE model fitted
    on it: the n-step test set (per-step arms, per-row coefficients 5 %
    around the fitted ones, drawn from ``seeds[0]``) and the 1-step test
    set (the shared fitted coefficients), both with the model's clip."""
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import (model_dataset_name,
                                                 sindy_params_for)
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection(name, {'train': 1000, 'val': 100, 'test': 100},
                           seed=0, coeff=2.0, device=device)
    cfg = SINDyConfig(dataset_name=model_dataset_name(name),
                      sindy_threshold=sindy_params_for(name)[0], insite=True)
    model = SINDyRegressor(cfg, coll, device=device).fit(coll.train_f)
    active, clip = model._active_idx(), model._y_clip()

    def case(ds, per_row, seed):
        prev, statics, arms, _ = model._unscaled_arrays(ds)
        coefs = model.coefs.astype(np.float64)[None]
        if per_row:
            rng = np.random.RandomState(seed)
            coefs = coefs * (1 + 0.05 * rng.randn(len(prev), *coefs.shape[1:]))
        return dict(library=model.library, coefs=coefs, y0=prev[:, 0],
                    statics=statics, arms=arms, dt=model.dt,
                    active_idx=active, y_clip=clip)

    n_step = case(coll.test_cf_treatment_seq, True, seeds[0])
    one_step = case(coll.test_cf_one_step, False, seeds[1])
    switches = int((np.diff(n_step['arms'], axis=1) != 0).any(1).sum())
    log(f'  {name} cases: n-step arms {n_step["arms"].shape} ({switches} '
        f'rows switch arm), 1-step arms {one_step["arms"].shape}, '
        f'F={model.coefs.shape[1]}, Kr={len(active)}, y_clip {clip}: '
        f'{model.global_equation_string}')
    assert n_step['arms'].shape[1] == 64 and switches > 0
    assert one_step['arms'].shape[1] == 59
    return n_step, one_step


def tensors(case, dtype, device):
    import torch
    f = dict(dtype=dtype, device=device)
    return (case['library'], torch.as_tensor(case['coefs'], **f),
            torch.as_tensor(case['y0'], **f),
            torch.as_tensor(case['statics'], **f),
            torch.as_tensor(case['arms'], dtype=torch.int32, device=device),
            case['dt'])


def clip_flips(y_k, y_p, y_clip):
    """Rows where kernel and plain disagree on whether a step was clipped
    (a state within rounding of a bound): their sensitivities differ by
    construction, so they are left out of the sensitivity comparison."""
    if y_clip is None:
        return None
    lo, hi = y_clip
    flagged_k = (y_k == lo) | (y_k == hi)
    flagged_p = (y_p == lo) | (y_p == hi)
    return (flagged_k != flagged_p).any(dim=1)


def run_kernel_case(name, case, device, timed):
    import torch
    from insite_tpu_torch.ops import rollout
    out = {}
    for tag, dtype in (('f32', torch.float32), ('f64', torch.float64)):
        args = tensors(case, dtype, device)
        act, clip = case['active_idx'], case['y_clip']
        y_k = rollout.batched_rollout(*args, y_clip=clip)
        y_p = rollout.batched_rollout_plain(*args, y_clip=clip)
        ys_k, s_k = rollout.rollout_with_sens(*args, act, y_clip=clip)
        ys_p, s_p = rollout.rollout_with_sens_plain(*args, act, y_clip=clip)
        torch.cuda.synchronize()
        tol = TOL[tag]
        err_roll = check_close(f'{name} {tag} rollout', y_k, y_p, *tol['y'])
        err_y = check_close(f'{name} {tag} sens y', ys_k, ys_p, *tol['y'])
        flips = clip_flips(ys_k, ys_p, clip)
        keep = None
        if flips is not None:
            n_flip = int(flips.sum())
            if n_flip > max(1, flips.numel() // 1000):
                raise AssertionError(f'{name} {tag}: {n_flip} rows with '
                                     'different clip decisions')
            keep = ~flips
            log(f'  {name} {tag}: {n_flip} rows differ in a clip decision')
        err_s = check_close(f'{name} {tag} sens', s_k, s_p, *tol['sens'],
                            rows=keep)
        log(f'  {name} {tag}: max abs err rollout {err_roll:.3e}, '
            f'sens y {err_y:.3e}, sens {err_s:.3e}')
        out[tag] = {'rollout_err': err_roll, 'sens_err': max(err_y, err_s)}
        if timed and tag == 'f32':
            t = {
                'rollout_ms': time_ms(lambda: rollout.batched_rollout(
                    *args, y_clip=clip)),
                'rollout_plain_ms': time_ms(
                    lambda: rollout.batched_rollout_plain(*args,
                                                          y_clip=clip)),
                'sens_ms': time_ms(lambda: rollout.rollout_with_sens(
                    *args, act, y_clip=clip)),
                'sens_plain_ms': time_ms(
                    lambda: rollout.rollout_with_sens_plain(*args, act,
                                                            y_clip=clip)),
            }
            log(f'  {name} f32 time per call (median of 20): rollout '
                f'{t["rollout_ms"]:.4f} ms vs plain '
                f'{t["rollout_plain_ms"]:.2f} ms; sens {t["sens_ms"]:.4f} '
                f'ms vs plain {t["sens_plain_ms"]:.2f} ms')
            out['times'] = t
    return out


# ---------------------------------------------------------------------------
# main path

def check_small_cohort(device):
    """The f32 card path against the f64 CPU path on one small cohort."""
    import torch
    from insite_tpu_torch.harness.northstar import (discover_and_finetune,
                                                    simulate_cohort)
    cohort = simulate_cohort(256, seed=2, device=device)
    r_gpu = discover_and_finetune(cohort, projection_horizon=1)
    r_cpu = discover_and_finetune(
        tuple(x.cpu().to(torch.float64) if x.is_floating_point() else x.cpu()
              for x in cohort), projection_horizon=1)
    support = np.abs(r_cpu['coefs']) > 1e-3
    if not ((np.abs(r_gpu['coefs']) > 1e-3) == support).all():
        raise AssertionError(f'support differs: {r_gpu["coefs"]} vs '
                             f'{r_cpu["coefs"]}')
    coef_err = float(np.abs(r_gpu['coefs'] - r_cpu['coefs']).max())
    pred_err = float((r_gpu['preds'].cpu().double()
                      - r_cpu['preds']).abs().max())
    rmse_rel = abs(r_gpu['rmse_orig'] / r_cpu['rmse_orig'] - 1)
    log(f'  256-patient cohort, card f32 vs CPU f64: coef max abs diff '
        f'{coef_err:.3e}, preds max abs diff {pred_err:.3e}, rmse_orig '
        f'{r_gpu["rmse_orig"]:.6f} vs {r_cpu["rmse_orig"]:.6f}')
    # f32 QR and LM against f64: coefficients to 1e-3 (the unbiased
    # support solve is well conditioned), volumes (1..50) to 1e-2, RMSE 5%
    np.testing.assert_allclose(r_gpu['coefs'], r_cpu['coefs'], rtol=1e-3,
                               atol=1e-6)
    if pred_err > 1e-2 or rmse_rel > 0.05:
        raise AssertionError('card and CPU fine-tunes disagree')


@contextlib.contextmanager
def stage_timer(records, device):
    """Time each sweep run's stages between device synchronisations:
    collection (simulation + host copy), processing, fit, 1-step and
    n-step predictions; and its peak device memory. One record per run,
    in sweep order."""
    import torch
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.models.sindy import SINDyRegressor
    hooks = [(runner, '_collection_for', 'collection'),
             (runner, '_build_model', 'process'),
             (SINDyRegressor, 'fit', 'fit'),
             (SINDyRegressor, 'get_predictions', 'predict_1_step'),
             (SINDyRegressor, 'get_autoregressive_predictions',
              'predict_n_step')]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in hooks]

    def timed(fn, stage):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if stage == 'collection':
                torch.cuda.reset_peak_memory_stats(device)
                records.append({'run': args[:2]})
            torch.cuda.synchronize(device)
            t0 = perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(device)
            records[-1][stage] = perf_counter() - t0
            if stage == 'fit':          # the fitted support, Kr
                records[-1]['kr'] = len(args[0]._active_idx())
            records[-1]['peak_mib'] = \
                torch.cuda.max_memory_allocated(device) / 2**20
            return out
        return inner

    for (owner, name, stage), (_, _, fn) in zip(hooks, saved):
        setattr(owner, name, timed(fn, stage))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def check_bands(rows):
    """8 rows, none errored; every RMSE within its band; insite below
    sindy on every dataset at 1 and 6 steps."""
    if len(rows) != 2 * len(DATASETS) or any(r['errored'] for r in rows):
        raise AssertionError(f'expected 8 rows, none errored: {rows}')
    by = {(r['dataset_name'], r['method_name']): r for r in rows}
    for (method, metric), band in BANDS.items():
        for ds in DATASETS:
            limit = band.get(ds, band['default'])
            if not by[ds, method][metric] < limit:
                raise AssertionError(f'{method} {ds} {metric} = '
                                     f'{by[ds, method][metric]} >= {limit}')
    for ds in DATASETS:
        for metric in ('encoder_test_rmse_orig', 'decoder_test_rmse_6-step'):
            if not by[ds, 'insite'][metric] < by[ds, 'sindy'][metric]:
                raise AssertionError(f'{ds} {metric}: insite not below sindy')


def run_sweep(device, datasets, tag):
    """The port's sweep of sindy and insite over ``datasets`` on the card
    (one seed, 1,000 / 100 / 100, debug mode), with each run's stage times,
    peak memory and Kr printed. Returns (rows, records, launches)."""
    import torch
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.harness.logging_utils import (
        create_logger_in_process, generate_log_file_path)
    from insite_tpu_torch.harness.runner import sweep
    from insite_tpu_torch.ops import rollout
    records = []
    with tempfile.TemporaryDirectory() as log_dir:
        cfg = RunConfig(methods=('sindy', 'insite'), datasets=datasets,
                        seed_runs=1, log_dir=log_dir, debug_mode=True)
        logger = create_logger_in_process(generate_log_file_path('run',
                                                                 log_dir))
        with stage_timer(records, device):
            torch.cuda.synchronize(device)
            rollout.reset_launch_counts()
            t0 = perf_counter()
            rows, tables = sweep(cfg, log=logger, device=device)
            torch.cuda.synchronize(device)
            wall = perf_counter() - t0
            launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                        'sens': rollout.SENS_LAUNCHES}
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    stages = ('collection', 'process', 'fit', 'predict_1_step',
              'predict_n_step')
    for row, rec in zip(rows, records):
        assert rec['run'] == (row['dataset_name'], row['method_name'])
        log(f'  {row["dataset_name"]} {row["method_name"]:6s} '
            f'1-step {row["encoder_test_rmse_orig"]:.6f} % | 6-step '
            f'{row["decoder_test_rmse_6-step"]:.6f} % | seconds_taken '
            f'{row["seconds_taken"]:.4f} s | ' + ' '.join(
                f'{s} {rec[s]:.4f}' for s in stages) +
            f' s | peak {rec["peak_mib"]:.1f} MiB | Kr {rec["kr"]}')
        log(f'    {row["global_equation_string"]}')
    log(f'[{tag}] sweep wall {wall:.4f} s; kernel launches: {launches}')
    for metric, table in tables.items():
        log(f'[{tag}] LaTeX {metric}:\n{table}')
    if len(rows) != 2 * len(datasets) or any(r['errored'] for r in rows):
        raise AssertionError(f'expected {2 * len(datasets)} rows, none '
                             f'errored: {rows}')
    return rows, records, launches


def expected_launches(rows, records):
    """Per run: 2 rollouts (1-step and n-step predictions); an insite run
    with a non-empty support adds 2 fine-tunes of gn_iters + 1 sensitivity
    launches (with an empty support nothing moves and none is launched)."""
    sens = sum(2 * (GN_ITERS + 1) for row, rec in zip(rows, records)
               if row['method_name'] == 'insite' and rec['kr'] > 0)
    return {'rollout': 2 * len(rows), 'sens': sens}


def run_main_table(device):
    """Phase 5: the port's sweep over the EQ_4 main table on the card."""
    rows, records, launches = run_sweep(device, DATASETS, 'table')
    want = {'rollout': 2 * 2 * len(DATASETS),
            'sens': 2 * (GN_ITERS + 1) * len(DATASETS)}
    if launches != want:
        raise AssertionError(f'expected {want} launches, got {launches}')
    check_bands(rows)
    return launches


def run_tumor_table(device):
    """Phase 6: the port's sweep over the tumor main table on the card,
    held to the JAX package's RMSEs at the same seed."""
    rows, records, launches = run_sweep(device, TUMOR_DATASETS, 'tumor')
    want = expected_launches(rows, records)
    if want != {'rollout': 20, 'sens': 130}:
        empty = [r['dataset_name'] for r, rec in zip(rows, records)
                 if r['method_name'] == 'insite' and rec['kr'] == 0]
        log(f'[tumor] insite fits with an empty support on {empty}: the '
            f'path launches {want}, not 20 rollouts and 130 sensitivities')
    if launches != want:
        raise AssertionError(f'expected {want} launches, got {launches}')
    by = {(r['dataset_name'], r['method_name']): r for r in rows}
    for (ds, method), ref in TUMOR_REF.items():
        for metric, want_v in zip(('encoder_test_rmse_orig',
                                   'decoder_test_rmse_6-step'), ref):
            got = by[ds, method][metric]
            log(f'  {ds} {method} {metric}: card {got:.6f} % vs JAX '
                f'{want_v:.6f} % ({100 * (got / want_v - 1):+.2f} %)')
            if not abs(got / want_v - 1) <= TUMOR_RTOL:
                raise AssertionError(f'{ds} {method} {metric} = {got} is not '
                                     f'within {TUMOR_RTOL:.0%} of {want_v}')
    for ds in TUMOR_DATASETS:
        if not (by[ds, 'insite']['encoder_test_rmse_orig'] <
                by[ds, 'sindy']['encoder_test_rmse_orig']):
            raise AssertionError(f'{ds}: insite not below sindy at 1 step')
    return launches


def check_card_against_host(device, name='EQ_4_D'):
    """insite f32 on the card against insite f64 on the host, on one
    collection of ``name`` (200 / 10 / 10): the same support, coefficients
    within rtol 1e-3 and RMSEs within 5 %."""
    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import (model_dataset_name,
                                                 sindy_params_for)
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection(name, {'train': 200, 'val': 10, 'test': 10},
                           seed=7, coeff=2.0, device=device)
    cfg = SINDyConfig(dataset_name=model_dataset_name(name),
                      sindy_threshold=sindy_params_for(name)[0], insite=True)
    out = {}
    for tag, dev, dtype in (('card', device, None),
                            ('host', 'cpu', torch.float64)):
        m = SINDyRegressor(cfg, coll, device=dev, dtype=dtype).fit(
            coll.train_f)
        one = m.get_normalised_masked_rmse(coll.test_cf_one_step,
                                           one_step_counterfactual=True)[0]
        six = float(m.get_normalised_n_step_rmses(
            coll.test_cf_treatment_seq)[-1])
        out[tag] = (m.coefs, one, six)
    (c_k, one_k, six_k), (c_h, one_h, six_h) = out['card'], out['host']
    log(f'  {name} card f32 vs host f64: coef max abs diff '
        f'{np.abs(c_k - c_h).max():.3e} (max rel '
        f'{(np.abs(c_k - c_h) / np.maximum(np.abs(c_h), 1e-12)).max():.3e});'
        f' 1-step {one_k:.6f} vs {one_h:.6f} %; 6-step {six_k:.6f} vs '
        f'{six_h:.6f} %')
    if not ((np.abs(c_k) > 1e-3) == (np.abs(c_h) > 1e-3)).all():
        raise AssertionError(f'support differs: {c_k} vs {c_h}')
    np.testing.assert_allclose(c_k, c_h, rtol=1e-3, atol=1e-6)
    if abs(one_k / one_h - 1) > 0.05 or abs(six_k / six_h - 1) > 0.05:
        raise AssertionError('card and host RMSEs differ by more than 5 %')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this smoke '
              'run needs an NVIDIA card', file=sys.stderr)
        return 1
    from insite_tpu_torch.harness.northstar import fused_northstar
    from insite_tpu_torch.ops import build, rollout

    # 1. device
    device = torch.device('cuda', 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'[device] {kind}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}')
    print(smi, flush=True)

    # 2. build
    t0 = perf_counter()
    build.load_library()
    log(f'[build] nvcc sm_90a build + load: {perf_counter() - t0:.2f} s')
    report = ptxas_report((build.build_dir() / 'nvcc.log').read_text())
    for label, regs, stack, spill_st, spill_ld in report:
        log(f'  {label}: {regs} registers, {stack} bytes stack, '
            f'{spill_st} / {spill_ld} bytes spill stores / loads')
        if 'SmallModel' in label and (stack or spill_st or spill_ld):
            raise AssertionError(f'{label} uses a stack or spills')
    if sorted(r[0] for r in report) != sorted(PTXAS_KERNELS):
        raise AssertionError(f'ptxas reported {[r[0] for r in report]}; '
                             f'expected {PTXAS_KERNELS}')

    # 3. kernels: device time and bound, then against their plain versions
    northstar_case = eq4_case(N_PATIENTS, 59, True, 0)
    degree4_case = wide_support_case(N_PATIENTS, 59, 4)
    n_step_case, one_step_case = table_cases('EQ_4_D', device, (5, 6))
    assert n_step_case['arms'].shape == (59_000, 64)
    assert one_step_case['arms'].shape == (11_800, 59)
    tumor_cases = {}
    for ds, short in (('cancer_sim', 'cancer_sim'), ('EQ_5_D', 'eq5d')):
        n_case, one_case = table_cases(ds, device, (7, 8))
        # 4 arms; the tumor fits' support takes the sensitivity kernel's
        # shared-memory model
        assert n_case['coefs'].shape[1] == 4 and len(n_case['active_idx']) > 4
        tumor_cases[f'tumor_{short}_nstep'] = n_case
        tumor_cases[f'tumor_{short}_1step_shared'] = one_case
    log('[kernels] device time per launch, f32, before any plain version '
        'runs')
    dev_times = kernel_times({'northstar': northstar_case,
                              'nstep_b59000_t64': n_step_case,
                              '1step_shared_b11800_t59': one_step_case,
                              'degree4_f35_kr16_b10000_t59': degree4_case,
                              **tumor_cases},
                             device)
    log('[kernels] kernel vs plain PyTorch version on the card')
    main_case = run_kernel_case('northstar B=10000 T=59 per-patient',
                                northstar_case, device, timed=True)
    run_kernel_case('northstar B=10000 T=59 shared',
                    eq4_case(N_PATIENTS, 59, False, 1), device,
                    timed=False)
    profile = run_kernel_case('B=2048 T=60 per-patient',
                              eq4_case(2048, 60, True, 2), device,
                              timed=True)
    run_kernel_case('4-arm y_clip B=10000 T=59',
                    four_arm_clip_case(N_PATIENTS, 59, 3), device,
                    timed=False)
    run_kernel_case('degree-4 F=35 Kr=16 B=10000 T=59', degree4_case,
                    device, timed=True)
    n_step = run_kernel_case('main table n-step B=59000 T=64 per-row',
                             n_step_case, device, timed=True)
    one_step = run_kernel_case('main table 1-step B=11800 T=59 shared',
                               one_step_case, device, timed=True)
    tumor = {tag: run_kernel_case(
        f'{tag} B={case["arms"].shape[0]} T={case["arms"].shape[1]} '
        f'Kr={len(case["active_idx"])}', case, device, timed=True)
        for tag, case in tumor_cases.items()}
    torch.cuda.synchronize()

    # 4. main path
    log('[path] warm-up: fused_northstar(64, seed=1)')
    fused_northstar(64, seed=1, device=device)
    check_small_cohort(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    rollout.reset_launch_counts()
    r = fused_northstar(N_PATIENTS, seed=0, equation_name='EQ_4_D',
                        projection_horizon=1, gn_iters=GN_ITERS,
                        device=device)
    launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                'sens': rollout.SENS_LAUNCHES}
    peak_mib = torch.cuda.max_memory_allocated(device) / 2**20
    log(f'[path] {N_PATIENTS} patients EQ_4_D: sim+design+QR '
        f'{r["t_sim_design"]:.4f} s | host STLSQ {r["t_stlsq"]:.4f} s | '
        f'fine-tune {r["t_finetune"]:.4f} s | metric {r["t_metric"]:.4f} s'
        f' | total {r["total"]:.4f} s')
    log(f'[path] {r["global_equation_string"]}')
    log(f'[path] factual normalised RMSE: orig={r["rmse_orig"]:.6f}% '
        f'all={r["rmse_all"]:.6f}%')
    log(f'[path] kernel launches: {launches}; peak device memory '
        f'{peak_mib:.1f} MiB')
    if launches != {'rollout': 1, 'sens': GN_ITERS + 1}:
        raise AssertionError(f'expected 1 rollout and {GN_ITERS + 1} '
                             f'sensitivity launches, got {launches}')
    preds = r['preds']
    if preds.shape != (N_PATIENTS, 59) or not torch.isfinite(preds).all():
        raise AssertionError('predictions are not finite [10000, 59]')
    if not r['rmse_orig'] < 0.1:
        raise AssertionError(f'rmse_orig {r["rmse_orig"]}% >= 0.1%')

    # 5. main table
    log('[table] sweep: sindy, insite x EQ_4_A..D, 1 seed, 1000/100/100')
    table_launches = run_main_table(device)
    log('[table] card f32 against host f64, one EQ_4_D collection')
    check_card_against_host(device)

    # 6. tumor main table
    log('[tumor] sweep: sindy, insite x cancer_sim, EQ_5_A..D, seed 0, '
        '1000/100/100')
    tumor_launches = run_tumor_table(device)
    log('[tumor] card f32 against host f64, one cancer_sim collection')
    check_card_against_host(device, 'cancer_sim')

    kernels = []
    for name, key, replaces in (('rollout', 'rollout', ':40'),
                                ('rollout_with_sens', 'sens', ':85')):
        err = 'rollout_err' if key == 'rollout' else 'sens_err'
        per_shape = {}
        for tag, t in dev_times.items():
            dev, bound = t[f'{key}_device_ms'], t[f'{key}_bound_ms']
            per_shape.update({f'device_ms_{tag}': dev,
                              f'bound_ms_{tag}': bound,
                              f'bound_share_{tag}': bound / dev})
        for tag, res in tumor.items():
            per_shape.update({f'max_abs_err_{tag}': res['f32'][err],
                              f'ms_{tag}': res['times'][f'{key}_ms'],
                              f'plain_ms_{tag}':
                                  res['times'][f'{key}_plain_ms']})
        kernels.append({
            'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE,
            'replaces': 'insite_tpu/ops/pallas_rollout.py' + replaces,
            'launches': table_launches[key],
            'launches_northstar': launches[key],
            'launches_tumor_table': tumor_launches[key],
            'max_abs_err': main_case['f32'][err],
            'ms': main_case['times'][f'{key}_ms'],
            'plain_ms': main_case['times'][f'{key}_plain_ms'],
            'bound_ms': dev_times['northstar'][f'{key}_bound_ms'],
            'bound_by': dev_times['northstar'][f'{key}_bound_by'],
            # no single PyTorch call computes the recurrence
            'library_ms': None,
            'ms_b2048_t60': profile['times'][f'{key}_ms'],
            'plain_ms_b2048_t60': profile['times'][f'{key}_plain_ms'],
            'max_abs_err_nstep': n_step['f32'][err],
            'ms_nstep_b59000_t64': n_step['times'][f'{key}_ms'],
            'plain_ms_nstep_b59000_t64': n_step['times'][f'{key}_plain_ms'],
            'ms_1step_shared_b11800_t59': one_step['times'][f'{key}_ms'],
            'plain_ms_1step_shared_b11800_t59':
                one_step['times'][f'{key}_plain_ms'],
            **per_shape})
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
