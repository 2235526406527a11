#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`insite_tpu_torch`) on one NVIDIA
card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device   require CUDA; print the card and its power limit; TF32 off.
2. build    compile csrc/rollout.cu with nvcc for sm_90a (timed).
3. kernels  each rollout kernel against its plain PyTorch version on the
            card, f32 and f64, at the north-star shape (B=10,000, T=59,
            A=2, F=7, S=2, Kr=3), at B=2048, T=60, in a 4-arm case
            with y_clip, and on the degree-4 library (F=35) with Kr=16
            active coordinates, the sensitivity kernel's wide
            instantiation; timed with CUDA events (median of 20 calls).
4. path     the 10,000-patient EQ_4_D north star (simulate -> discover ->
            INSITE fine-tune), after an untimed warm-up and a check of the
            f32 card path against the f64 CPU path on a small cohort;
            asserts that the fine-tune went through the kernels.

The last two lines of stdout are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
from time import perf_counter

import numpy as np

N_PATIENTS = 10_000
GN_ITERS = 12
KERNEL_SOURCE = 'insite_tpu_torch/csrc/rollout.cu'
# (rtol, atol), elementwise |kernel - plain| <= atol + rtol * |plain|.
# f32: nvcc contracts multiply-adds to FMA and the kernel sums the library
# terms in another order than PyTorch, over T * 5 dependent sub-steps
# (~300 roundings of 6e-8 each); sensitivities add a product per sub-step.
# f64: the same differences at 1e-16 per rounding.
TOL = {'f32': {'y': (1e-4, 1e-4), 'sens': (1e-3, 1e-3)},
       'f64': {'y': (1e-10, 1e-10), 'sens': (1e-9, 1e-9)}}


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
    for line in (build.build_dir() / 'nvcc.log').read_text().splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'  {line.strip()}')

    # 3. kernels against their plain versions
    log('[kernels] kernel vs plain PyTorch version on the card')
    main_case = run_kernel_case(
        'northstar B=10000 T=59 per-patient',
        eq4_case(N_PATIENTS, 59, True, 0), device, timed=True)
    run_kernel_case('northstar B=10000 T=59 shared',
                    eq4_case(N_PATIENTS, 59, False, 1), device,
                    timed=False)
    profile = run_kernel_case('B=2048 T=60 per-patient',
                              eq4_case(2048, 60, True, 2), device,
                              timed=True)
    run_kernel_case('4-arm y_clip B=10000 T=59',
                    four_arm_clip_case(N_PATIENTS, 59, 3), device,
                    timed=False)
    run_kernel_case('degree-4 F=35 Kr=16 B=10000 T=59',
                    wide_support_case(N_PATIENTS, 59, 4), device,
                    timed=True)
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

    t_main, t_prof = main_case['times'], profile['times']
    kernels = [
        {'name': 'rollout', 'route': 'cuda', 'source': KERNEL_SOURCE,
         'replaces': 'insite_tpu/ops/pallas_rollout.py:40',
         'launches': launches['rollout'],
         'max_abs_err': main_case['f32']['rollout_err'],
         'ms': t_main['rollout_ms'], 'plain_ms': t_main['rollout_plain_ms'],
         'ms_b2048_t60': t_prof['rollout_ms'],
         'plain_ms_b2048_t60': t_prof['rollout_plain_ms']},
        {'name': 'rollout_with_sens', 'route': 'cuda',
         'source': KERNEL_SOURCE,
         'replaces': 'insite_tpu/ops/pallas_rollout.py:85',
         'launches': launches['sens'],
         'max_abs_err': main_case['f32']['sens_err'],
         'ms': t_main['sens_ms'], 'plain_ms': t_main['sens_plain_ms'],
         'ms_b2048_t60': t_prof['sens_ms'],
         'plain_ms_b2048_t60': t_prof['sens_plain_ms']},
    ]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
