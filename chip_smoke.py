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
            with per-row coefficients, 1-step shared), and at the shapes
            of phase 7, per-row coefficients throughout: the joint
            (one-ODE) model of a cancer_sim and of an EQ_4_D fit folded
            onto the kernels (4 combinations x 4 reduced features, up to 16
            effective coordinates; 2 x 7, up to 14), on the n-step and 1-step
            test sets, the kernels at the folded shape and, at n-step, the
            fold's rollout and ``s_eff @ M`` against the plain joint
            rollout and sensitivity recurrence; one chunk of the degree-4
            fine-tune on EQ_4_D (the first 2,048 rows of the n-step and of
            the 1-step test set, F=35, the fitted support); the recovery's
            validation cohort (B=100, T=59); and a 4-arm degree-4 case
            with 100 active coordinates, which goes through the
            sensitivity kernel in two
            groups; and at the noise sweep's shapes of phase 8, taken from
            an EQ_4_B collection of the default size (n-step with per-row
            coefficients, 1-step shared; the fit keeps a smaller support
            than EQ_4_D's), and at phase 11's seed-stacked shapes: the
            n-step rows of 10 EQ_4_D seeds (B=590,000, T=64) and the 1-step
            rows of 10 cancer_sim seeds (B=236,000, T=59, A=4, y_clip),
            simulated as `harness/vectorized.py` simulates them, with
            per-row models from 10 different supports (each seed's fit
            with a subset of the union dropped) and the union as the
            active set, and at phase 13's lam tune: the validation cohort
            of an EQ_4_D fit (100 patients) stacked once per value of the
            7-value grid (B=700, per-row coefficients, the fit's
            support), and at phase 17's half of the n-step set, one of
            two shards (B=29,500, T=64, per-row coefficients, Kr = the
            fitted support). Every case asserts its launches. First, before any
            plain version runs, the device time of one call of each
            kernel (torch.profiler, median of 20 calls, one session; a
            call is one launch, two for the case that goes in groups, and
            the session must hold every launch of such a call) at the
            north-star, n-step, 1-step, degree-4, tumor, phase-7 and
            noise-sweep shapes, each beside its bound: the
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
7. family   the rest of the SINDy family through the port's sweep, seed 0,
            1,000 / 100 / 100, f32, debug mode, each part's launches
            asserted exactly: (a) wsindy on EQ_4_A..D, cancer_sim and
            EQ_5_A..D (9 rows; 18 rollout launches, no sensitivity launch);
            (b) ABLATION_ONE_ODE, sindy and insite on EQ_4_D and cancer_sim
            (4 rows; the joint model folded onto the kernels: 8 rollout and
            52 sensitivity launches); (c) the degree-4 ablation, sindy and
            insite on EQ_4_D (2 rows; the fine-tune in chunks of 2,048 rows:
            per chunk 1 rollout and 13 sensitivity launches per group of 72
            active coordinates); (d) INSIGHT_RECOVER_PARAMETRIC_DIST, insite
            on EQ_4_D (1 row; the validation cohort is fine-tuned once: 3
            rollout and 39 sensitivity launches), with both arms' Pearson r
            between recovered and hidden decay constants above 0.99. Gates
            (`SINDY_FAMILY_REF`: the JAX package at seed 0, f64 on the CPU,
            from `tools/sindy_family_reference.py`): tumor-family rows, whose
            cohorts equal the JAX package's, within 1 %; EQ_4 rows, whose
            cohorts come from another generator, inside bands 2-3.1x above
            the JAX package's value (`FAMILY_BANDS`); insite below sindy at
            1 step wherever both ran.
8. msm      (a) msm on EQ_4_A..D, cancer_sim and EQ_5_A..D through the
            port's sweep (9 rows, seed 0, 1,000 / 100 / 100; a host model in
            float64 on a cohort simulated in f32 on the card): no kernel
            launch at all; tumor-family rows within 1 % of the JAX package's
            at all six horizons (`MSM_REF`), EQ_4 rows between 0.5x (1 step)
            or 0.15x (2..6 steps) and 3x its value (`MSM_EQ4_BAND`).
            (b) the three robustness sweeps, sindy, insite and msm, seed 0,
            three settings of each default grid (the main table's and both
            ends): INSIGHT_CONFOUNDING (EQ_4_D, gamma 0, 2, 4),
            INSIGHT_NOISE (EQ_4_B, noise scale 0, 1, 5),
            INSIGHT_LESS_SAMPLES (EQ_4_D, 50, 250, 1,000 training
            patients): 27 rows, the launches asserted exactly (2 rollout a
            sindy or insite row, 26 sensitivity an insite row with a
            support, none for msm: 36 and 234); rows of
            the noise sweep carry `noise_scale`, of the sample sweep
            `train_samples`; insite below sindy at 1 step in every setting,
            insite 1-step < 0.05 % at noise 1.0 and at gamma 2, and every
            RMSE inside a two-sided band around the JAX package's
            (`INSIGHT_REF`; `INSIGHT_BANDS`: sindy 0.4-2.5x, insite 0.4-2.5x
            at 1 step and 0.3-2.5x at 6 steps, msm as in (a)).
9. neural  ct and crn on EQ_4_D and cancer_sim through the port's sweep
            (4 rows, seed 0, 1,000 / 100 / 100, f32 on the card, built
            from PyTorch ops: no kernel launch at all; epochs from
            `NEURAL_EPOCHS`: ct the JAX package's 100, crn `NEURAL_E`, a
            cut the script's time limit forces): the JAX package's row
            keys in its order, every RMSE inside a two-sided band around
            the JAX package's at seed 0 and the same epochs (`NEURAL_REF`;
            `NEURAL_BANDS`, from each method's own spread over seeds 0-3
            in the JAX package), and on EQ_4_D both above phase 5's
            insite at 1 step; each run's stages, the fit of each network
            with its batches per second, and peak device memory. Then ct
            and crn f32 on the card against f32 on the host from the same
            initial weights (EQ_4_D, 200 / 10 / 10, dropout 0, one batch
            per epoch, 3 epochs; predictions within rtol 1e-3), and the
            device's idle share during one crn fit of one epoch
            (torch.profiler, in a process of its own: `tools/
            profile_torch_northstar.py --path fit`).
10. neural  rmsn, gnet and edct as phase 9 runs ct and crn, at full width
            (the JAX package's config defaults: hidden sizes, layers,
            heads, batch sizes, dropout, holdout ratio 0.1, 25
            Monte-Carlo samples, rmsn's encoder at 3x the epochs): 6 rows,
            rmsn's with `sw_mode`; gnet at 100 epochs, rmsn and edct at
            `NEURAL_E`; no kernel launch; bands and the insite check as in
            phase 9; each run's stages, each network's fit and peak
            memory. Then the three f32 on the card against f32 on the
            host, as in phase 9 (gnet's Monte-Carlo n-step with each
            side's residual noise, drawn by numpy alike).

11. vectorized the port's `vectorized_sweep` (``run.py --vectorized``) on the
            card, 10 seeds a column, 1,000 / 100 / 100, f32, debug mode:
            sindy, insite and wsindy on EQ_4_D, sindy and insite on
            cancer_sim and EQ_5_D, msm on EQ_4_D and cancer_sim, and
            INSIGHT_CONFOUNDING insite at gamma 0 and 4 (every seed's
            test rows of a column in one batch through the kernels). Per
            call: 10 rows a column with the JAX package's keys in order,
            none errored; the launches exactly (a column: sindy and
            wsindy 2 rollouts, insite 3 rollouts and 26 sensitivities, a
            confounding column 4 and 26, msm none); each column's 10-seed
            mean inside a two-sided band around the JAX package's
            vectorized mean at 1 and at 2..6 steps (`VECTORIZED_REF`,
            `VECTORIZED_BANDS`, from `tools/vectorized_reference_rmses.py`);
            seed 0 of EQ_4_D sindy and insite, phase 5's cohort, within
            rtol 0.2 of phase 5's 1-step RMSE; each call's wall time and
            peak device memory. Then a 2-seed EQ_4_D insite column (200 /
            10) on the card in f32 against the same cohorts on the host in
            f64: the same supports, coefficients within rtol 1e-3.
12. vectorized neural  the neural methods' `vectorized_sweep` columns on
            the card, 10 seeds a column, 1,000 / 100 / 100, f32, full
            width, debug mode: ct, crn, edct, rmsn and gnet on EQ_4_D, ct
            and gnet on cancer_sim, each stage of a column one
            seed-stacked fit (epochs `VEC_NEURAL_EPOCHS`: ct and gnet
            `VEC_NEURAL_FAST_E`, the rest `VEC_NEURAL_E`, cuts the time
            limit forces). Per column: 10 rows with the JAX package's keys
            in order (rmsn's with `sw_mode`), every RMSE finite; no kernel
            launch; the 10-seed mean at 1 step and at each of 2..6 steps
            inside a two-sided band around the JAX package's vectorized
            column (`VECTORIZED_NEURAL_REF`, `VECTORIZED_NEURAL_BANDS`, from
            `tools/vectorized_neural_reference_rmses.py`); on EQ_4_D the
            1-step mean above phase 11's insite column; peak device memory
            within 40 GiB; each column's wall time and peak printed. Then a
            2-seed column a method (EQ_4_D, 200 / 10 / 10, 3 epochs,
            dropout 0, one batch an epoch) f32 on the card against f32 on
            the host, the same cohorts and bitwise-equal initial weights:
            RMSEs within rtol 1e-3; and the device's idle share of one
            epoch of the stacked crn encoder fit of a 10-seed column
            (`tools/profile_torch_northstar.py --path column-fit`).
13. harness the sweep harness around the runs, on the card at the
            reference size (1,000 / 100 / 100, f32), each step's wall time
            printed, every run writing its JSONL records into a temporary
            metrics sink: (a) an insite EQ_4_D run with ``tune_hparams``:
            ``tuned_lam`` first in the row, as in the JAX package, and
            exactly 3 rollout and 39 sensitivity launches (an untuned
            run's 2 + 26 and one fine-tune over the 700 stacked validation
            rows); then `tune_insite_lam` f32 on the card against f64 on
            the host on one EQ_4_D collection (200 / 100 / 10): one call
            is 1 + 13 launches, all seven scores within rtol 1e-3, the
            same best lam wherever the best two differ by more; (b) ct
            with ``tune_hparams``: `grid_search` of 2 trials at 2 epochs,
            `successive_halving_search` of 3 trials in rungs of 1 and 3
            epochs: ``tuned_hparams`` from the grid, finite RMSEs, no
            launch; (c) a sindy EQ_4_D run twice with the dataset cache in
            a temporary directory: the second simulates nothing and its
            row equals the first; (d) a sindy + insite sweep on EQ_4_A at
            1 seed, resumed at 2 seeds from its log (only seed 1 runs),
            and under other epochs (all 4 run); (e) `run_isolated` of
            insite on EQ_4_D equal to the in-process row (rtol 1e-6), a
            2-seed `run_isolated_column`, and a failing isolated run
            raising, the children loading the library built in phase 2;
            (f) the sink holds 2 records a run.
14. real    the real-data path at the reference's cohort size: a
            `RealDatasetCollection` built on the card from an EQ_4_D cohort
            (1,000 / 100 / 100, seq 60, gamma 2, multilabel) with a
            fabricated 2-wide vitals stream (a numpy `RandomState`, no data
            file); ct, crn, rmsn, gnet and edct fitted on it through their
            normal API at their config widths, `REAL_EPOCHS` epochs: every
            1-step and n-step RMSE finite, ct's and gnet's predictions
            changed by zeroing the vitals, gnet's residual bank 1 + 2 wide,
            crn's encoder keys holding ``vitals``, 0 + 0 launches; the five
            f32 on the card against f32 on the host on a 200 / 10 / 10
            vitals collection, as in phases 9-10 (ct's augmentation off:
            its split draws come from each device's generator); ct's and
            edct's encoder's attention maps on 256 test rows, [B, heads, T,
            T], rows summing to 1 within 1e-4; a checkpoint of each of the
            seven families (sindy-family insite and msm fitted on EQ_4_D
            1,000 / 100 / 100) saved and loaded into a fresh estimator,
            whose 1-step and n-step predictions equal the saved one's bit
            for bit, the reloaded insite model's predict call on the EQ_4_D
            1-step test set launching 1 + 13 kernels; each step's wall
            printed.
15. slice8  (a) an EQ_4_D insite run through `run_experiment` with
            ``model_overrides`` {insite_solver: 'bfgs', bfgs_maxiter: 100}
            on phase 5's cohort (1,000 / 100 / 100, seed 0), in f32 and in
            f64: finite RMSEs, phase 5's Gauss-Newton 1-step RMSE at most
            1.05 x BFGS's (the JAX package's rule), BFGS below phase 5's
            sindy at 1 step; launches asserted exactly: one sensitivity
            launch per batched BFGS evaluation and one rollout per
            fine-tune; for each fine-tune the share of rows ending in each
            status, iterations, evaluations, launches and wall; (b) the BFGS
            fine-tune f64 on the card against f64 on the host (EQ_4_D,
            200 / 10 / 10, its 1-step test set, bfgs_maxiter 20):
            coefficients within rtol 1e-6 on the rows that end with the
            same status and iteration count, every other row ending with
            the zoom failed (status 3, the edge of the precision) on one
            side or converged on both (then within 2 gtol K / (2 lam) of
            each other), at most 10 % of the rows with the zoom failed on
            either, and the rows the card changes when the global model
            moves by 1e-13 printed; (c) the lam tune under BFGS (7 x 100
            stacked rows, one fine-tune), card f64 against host f64, its
            rows held as in (b), scores and best lams printed; the card in
            f32 printed beside them (in f32 most rows end with the zoom
            failed and keep the masked global model, as in the JAX
            package); (d) rollout_backend='xla' set by
            ``model_overrides``: an EQ_4_D insite model fitted and
            predicting its 1-step test set with 0 + 0 launches, within
            1e-3 of the largest prediction of the same model on the
            kernels, walls printed; (e) the
            legacy eq_1..eq_8 `load_dataset` at 1,000 / 100 / 100 on the
            card (shapes, finite), and each equation f64 on the card
            against the host on the same draws (rtol 1e-10, actions
            equal); (f) `sr3_l1` on the weak system of one EQ_4_D arm,
            card against host in f64 (rtol 1e-8, the same support); (g)
            `utils.profiling.trace` around one warm north star in a
            process of its own, run beside (b), (c), (e) and (f): the
            Chrome trace names the sensitivity kernel 13 times and the
            rollout kernel once. (d) runs last, alone.
16. entry   the repository's own entry points, ported: (a) the bench
            (`insite_tpu_torch.bench.main`) in this process at 10,000
            patients, fused with 2 device-time repeats and standard: the
            JSON line's keys (`bench.py`'s) and metric name, rmse_orig <
            0.1 %, the launches of the timed part asserted exactly (fused
            (1 + 2) x (1 + 13), standard 1 + 13; the untimed warm-up's
            counted apart); (b) one ``python -m insite_tpu_torch.bench``
            child, as a user runs it, beside (c)-(e): its last line parses
            with `bench.py`'s keys; (c) the results CLI (``python -m
            insite_tpu_torch.process_result_file``) on the logs that phases
            5, 6 and 11 wrote: its tables equal `generate_main_results_table`
            of the rows built in this process, each cell's row from the
            last log that holds it, and its CSV has one line a row; (d) the
            figure CLI's row functions on those logs, phase 8's
            INSIGHT_LESS_SAMPLES log and the tracked result JSONs (rows
            made, group means finite; the figures are drawn by the CPU
            tests); (e) `entry()`: one rollout launch, against the plain
            version within `TOL`'s f32 rollout tolerance.
17. mesh    the batch mesh (`insite_tpu_torch.parallel`): the visible cards
            repeated in turn to at least two shards (one card holds
            several; the number of distinct cards is printed): (a) both
            kernels on tensors on the last card while cuda:0 is current,
            against their plain versions (`TOL`, f32); (b) insite on an
            EQ_4_D collection at the reference size (1,000 / 100 / 100,
            seq 60, horizon 5, gamma 2), its 1-step (B=11,800) and n-step
            (B=59,000) predictions unsharded and split over the shards,
            launches asserted as shards x the unsharded run's, predictions
            and fine-tuned coefficients within `MESH_RTOL` / `MESH_ATOL`;
            (c) 10-seed sindy and insite columns of `vectorized_eq4_sweep`
            (1,000 / 100) unsharded and seed-sharded, launches and per-seed
            results held the same way; (d) ct, crn, edct, rmsn and gnet
            columns (EQ_4_D, 200 / 10 / 10, one seed a shard, 2 epochs,
            dropout 0) sharded against unsharded the same way, then ct
            with dropout on, its sharded means inside phase 12's ct band
            of the unsharded ones; (e) `dryrun_multichip(2)` and
            `dryrun_multichip(max(2, cards))`. Each step's wall time and
            the sharded against the unsharded wall are printed; on one
            card the shards run one after another.
18. surface the port's public surface on the card machine (no JAX, pandas
            or PyYAML): (a) a fresh interpreter imports every name in the
            ``__all__`` of every subpackage; it must load neither the
            kernel library nor, before the harness's names are asked for,
            the runner (`harness/__init__.py` exports lazily), and its
            wall is printed; (b) `masked_ridge` on the card in f32 and f64
            (59,000 x 10, a mask and 0/1 weights) against the host's f64
            solve of the same values (`SURFACE_RIDGE_RTOL`); (c) ``python
            -m insite_tpu_torch.seed_gaps`` as children, on the tracked
            logs and on the logs of phases 5, 6 and 11, as the default
            table and as ``--next-cell``: exit 0, the table's header and
            total line, the total equal to the cells' gaps, and phase 5's
            cells counted; (d) phase 16's bench-child wall beside
            `BENCH_CHILD_BEFORE_S`, its wall before the exports.

The last two lines of stdout are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import types
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
# The JAX package's values for phase 7 at seed 0, 1,000 / 100 / 100 patients,
# float64 on the CPU: (encoder_test_rmse_orig, decoder_test_rmse_6-step), %,
# from `JAX_PLATFORMS=cpu python3 tools/sindy_family_reference.py --seed 0
# --degree4-insite`. Its recovery run gave Pearson r 0.99999 (arm 0) and
# 0.99978 (arm 1).
SINDY_FAMILY_REF = {
    ('MAIN_TABLE', 'EQ_4_A', 'wsindy'):
        (0.11149814452920724, 0.10762660073174721),
    ('MAIN_TABLE', 'EQ_4_B', 'wsindy'):
        (0.11179434875485214, 0.1081825907019281),
    ('MAIN_TABLE', 'EQ_4_C', 'wsindy'):
        (0.1257148506574914, 0.11853013063857584),
    ('MAIN_TABLE', 'EQ_4_D', 'wsindy'):
        (0.11491651432142917, 0.12431666302953646),
    ('MAIN_TABLE', 'cancer_sim', 'wsindy'):
        (1.285279107306778, 0.9968521314669468),
    ('MAIN_TABLE', 'EQ_5_A', 'wsindy'):
        (1.0754092405222897, 1.577265176385164),
    ('MAIN_TABLE', 'EQ_5_B', 'wsindy'):
        (1.5407965013747953, 1.0441303762750553),
    ('MAIN_TABLE', 'EQ_5_C', 'wsindy'):
        (1.02823636650314, 1.4494338353753906),
    ('MAIN_TABLE', 'EQ_5_D', 'wsindy'):
        (1.323420660499555, 1.1637321710135953),
    ('ABLATION_ONE_ODE', 'EQ_4_D', 'sindy'):
        (1.113608592748673, 0.8039541750965564),
    ('ABLATION_ONE_ODE', 'EQ_4_D', 'insite'):
        (0.19348056318873064, 0.4115931792526939),
    ('ABLATION_ONE_ODE', 'cancer_sim', 'sindy'):
        (1.3901352171716772, 1.1538701584860442),
    ('ABLATION_ONE_ODE', 'cancer_sim', 'insite'):
        (0.8183083332482903, 1.3726092697018502),
    ('ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', 'EQ_4_D', 'sindy'):
        (0.11444516103182682, 0.12379586379311668),
    ('ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', 'EQ_4_D', 'insite'):
        (0.02059411963965915, 0.05844668899721181),
    ('INSIGHT_RECOVER_PARAMETRIC_DIST', 'EQ_4_D', 'insite'):
        (0.020592835193914624, 0.05833500336190106)}
# phase 7's EQ_4 rows (the port's EQ_4 cohorts are not the JAX package's):
# upper limits (1-step, 6-step), %, 2-3.1x above `SINDY_FAMILY_REF`
FAMILY_BANDS = {
    ('MAIN_TABLE', 'wsindy'): (0.3, 0.3),
    ('ABLATION_ONE_ODE', 'sindy'): (3.0, 2.5),
    ('ABLATION_ONE_ODE', 'insite'): (0.6, 1.2),
    ('ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', 'sindy'): (0.3, 0.3),
    ('ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', 'insite'): (0.05, 0.15),
    ('INSIGHT_RECOVER_PARAMETRIC_DIST', 'insite'): (0.05, 0.15)}
RECOVERY_MIN_PEARSON_R = 0.99
RMSE_METRICS = ('encoder_test_rmse_orig',) + tuple(
    f'decoder_test_rmse_{k}-step' for k in range(2, 7))
# The JAX package's msm main table (`MSM_REF`: the 1-step and the 2..6-step
# RMSE, %) and its three INSIGHT sweeps (`INSIGHT_REF`: by setting and
# method, the 1-step and the 6-step RMSE, %) at seed 0, 1,000 / 100 / 100
# patients, float64 on the CPU, from
# `JAX_PLATFORMS=cpu python3 tools/msm_reference_rmses.py --seed 0`.
MSM_REF = {
    'EQ_4_A': (0.5727038163744641, 1.335399121089225,
               1.2444460371095838, 1.1683249969366116,
               1.1048491470150483, 1.052195556989429),
    'EQ_4_B': (0.5716596671215946, 1.2971608913379733,
               1.1301777035259915, 0.9762443736259917,
               0.8611796749833674, 0.7936369299366037),
    'EQ_4_C': (0.683526644891274, 1.4249065508827183,
               1.2520029324629145, 1.095593614557633,
               1.0264116547408004, 1.0120041672742868),
    'EQ_4_D': (0.6864643503785016, 2.0491729795805496,
               2.7509585325946397, 3.3878567861418905,
               4.037667166904121, 4.683780380011738),
    'cancer_sim': (0.7836912849449799, 1.6170795308585308,
                   1.9331640215828696, 2.157319002941856,
                   2.280494002012223, 2.335717893156625),
    'EQ_5_A': (0.7330278685069352, 1.827229038674894,
               2.120576514604736, 2.295728643689116,
               2.384467263126995, 2.3946769448704894),
    'EQ_5_B': (0.8987577474827048, 1.4962720612180136,
               1.7429560870827518, 1.8896858729137322,
               1.9665217442813152, 1.9645927955725575),
    'EQ_5_C': (0.9389924518480395, 1.2014056045347699,
               1.3983856489592843, 1.504375022900562,
               1.537230643690286, 1.514939158612904),
    'EQ_5_D': (0.8855004068939554, 1.8154939459024082,
               2.173614435157774, 2.424419432457872,
               2.5639284099333977, 2.608877998000173)}
INSIGHT_REF = {
    'INSIGHT_CONFOUNDING': {
        (0, 'sindy'):
            (0.10287247138576457, 0.12322031709937108),
        (0, 'insite'):
            (0.02079535600805752, 0.07036723852664836),
        (0, 'msm'):
            (0.6312153127063544, 5.808240936832728),
        (1, 'sindy'):
            (0.10801231975922777, 0.12353604617936702),
        (1, 'insite'):
            (0.02074279013220756, 0.06637054439804328),
        (1, 'msm'):
            (0.6562944431816179, 4.79821712923159),
        (2, 'sindy'):
            (0.1148315570668703, 0.12415334267924073),
        (2, 'insite'):
            (0.020592835193914624, 0.05833500336190106),
        (2, 'msm'):
            (0.6864643503785016, 4.683780380011738),
        (3, 'sindy'):
            (0.11869510174773874, 0.12441988947964827),
        (3, 'insite'):
            (0.02054036487341026, 0.05439355084958437),
        (3, 'msm'):
            (0.7050298474624536, 5.457401263123677),
        (4, 'sindy'):
            (0.12271050067016669, 0.12479850250715256),
        (4, 'insite'):
            (0.02049110021341857, 0.0498902638444498),
        (4, 'msm'):
            (0.7277579175770125, 4.585886358513958)},
    'INSIGHT_NOISE': {
        (0.0, 'sindy'):
            (0.11129297277776362, 0.10746228391572145),
        (0.0, 'insite'):
            (0.001339816071678564, 0.024456156509644892),
        (0.0, 'msm'):
            (0.5727038163744641, 1.052195556989429),
        (0.5, 'sindy'):
            (0.11193866620598347, 0.10814745003919483),
        (0.5, 'insite'):
            (0.010159058798594833, 0.027161256411938967),
        (0.5, 'msm'):
            (0.5723707375793228, 0.8520904086104399),
        (1.0, 'sindy'):
            (0.11353698989342617, 0.1097763401160888),
        (1.0, 'insite'):
            (0.020183868673291902, 0.03385688710314082),
        (1.0, 'msm'):
            (0.5716596671215946, 0.7936369299366037),
        (2.0, 'sindy'):
            (0.11941581410999566, 0.11568277988888627),
        (2.0, 'insite'):
            (0.04029955476591568, 0.052595964158036385),
        (2.0, 'msm'):
            (0.5714783571066747, 0.8204330455902018),
        (5.0, 'sindy'):
            (0.1534870643029215, 0.1495019348142458),
        (5.0, 'insite'):
            (0.10069814735500388, 0.11818600822665598),
        (5.0, 'msm'):
            (0.5853138434640983, 0.8456910028542687)},
    'INSIGHT_LESS_SAMPLES': {
        (50, 'sindy'):
            (0.11060756660885092, 0.11927432514922202),
        (50, 'insite'):
            (0.020565876681581333, 0.05603538370791794),
        (50, 'msm'):
            (0.6818196935994867, 3.6184576516859197),
        (100, 'sindy'):
            (0.11479347876387457, 0.12407306457592295),
        (100, 'insite'):
            (0.02059756346622633, 0.05872747933211201),
        (100, 'msm'):
            (0.684228236679949, 4.767103050082675),
        (250, 'sindy'):
            (0.11471418870179532, 0.12393329853619692),
        (250, 'insite'):
            (0.020594065336749578, 0.05844291999964887),
        (250, 'msm'):
            (0.682633231928502, 5.974414417961108),
        (500, 'sindy'):
            (0.11511501160673569, 0.12431911312441409),
        (500, 'insite'):
            (0.020597363851467713, 0.058695399535438786),
        (500, 'msm'):
            (0.6871066642578182, 4.66576237376385),
        (1000, 'sindy'):
            (0.1148315570668703, 0.12415334267924073),
        (1000, 'insite'):
            (0.020592835193914624, 0.05833500336190106),
        (1000, 'msm'):
            (0.6864643503785016, 4.683780380011738)}}
# msm's EQ_4 rows (the port's EQ_4 cohorts are not the JAX package's): the
# (lower, upper) factors on `MSM_REF` at 1 step and at 2..6 steps. msm
# varies much between cohorts (EQ_4_D over 10 seeds: 1-step 0.51-1.08 %,
# 6-step 2.60 +- 2.20 %, PARITY.md), and its quasi-separable propensity fit
# moves the 6-step RMSE of one cohort from 3.2 % (f64) to 1.3 % (f32 cohort)
# on the host. Readings on the card (NVIDIA H100 80GB HBM3, 700.00 W):
# 1 step x0.877-0.983, 2..6 steps x0.322-1.082. The lower edges are half the
# lowest reading, roughly: a target that leaks into the features or a horizon that
# loses its rows reads near 0.
MSM_EQ4_BAND = ((0.5, 3.0), (0.15, 3.0))
# the INSIGHT rows (all EQ_4): the (lower, upper) factors on `INSIGHT_REF` at
# 1 step and at 6 steps. Readings on the same card: sindy x0.860-1.082,
# insite x0.857-1.004 at 1 step and x0.593-0.986 at 6 steps.
INSIGHT_BANDS = {'sindy': ((0.4, 2.5), (0.4, 2.5)),
                 'insite': ((0.4, 2.5), (0.3, 2.5)),
                 'msm': MSM_EQ4_BAND}
# Epochs of each neural method in phases 9 and 10. ct and gnet train the
# JAX package's 100. A crn, rmsn or edct fit is eager PyTorch, host-bound
# (the card idles > 90 % of a crn fit): at 100 epochs their six runs alone
# take ~2,100 s, past the script's 1,200-s limit (per epoch and dataset on
# an H100 80GB HBM3 at 700 W: crn 2.2-2.5 s, rmsn 4.0-4.1 s, edct 4.1-4.2
# s), so the three take one common count, `NEURAL_E`: 10 since phase 12
# joined the script (18 before), so that the whole script ends within
# ~1,000 s on a slow host.
NEURAL_E = 10
NEURAL_EPOCHS = {'ct': 100, 'crn': NEURAL_E, 'rmsn': NEURAL_E, 'gnet': 100,
                 'edct': NEURAL_E}
# The JAX package's neural rows at seed 0, 1,000 / 100 / 100 patients, at
# `NEURAL_EPOCHS`, float32 on the CPU: the 1-step and the 2..6-step RMSE, %,
# from `JAX_PLATFORMS=cpu python3 tools/neural_reference_rmses.py --seed 0
# --methods <m> --epochs <NEURAL_EPOCHS[m]>`.
NEURAL_REF = {
    ('EQ_4_D', 'ct'): (0.2500825587081397, 0.32450028360104394,
                       0.40761769817619947, 0.4582020154822059,
                       0.5005952555899437, 0.5134947044379061),
    ('cancer_sim', 'ct'): (0.8858592719360117, 0.9425512460934417,
                           1.1226936225562807, 1.237430379912266,
                           1.3042949139986377, 1.3198181423820459),
    ('EQ_4_D', 'crn'): (0.8964328625654182, 1.6648490998423773,
                        1.6226396429651804, 1.7540845373073617,
                        1.942868419108158, 2.128375747125765),
    ('cancer_sim', 'crn'): (1.0880361850355103, 1.349400582058068,
                            1.5604214589040795, 1.706503943817816,
                            1.802972887069848, 1.8687638813062262),
    ('EQ_4_D', 'rmsn'): (2.8474944217193205, 2.4256322036159244,
                         2.3007300505524126, 2.2880095779938,
                         2.3291561414608037, 2.3949409660533094),
    ('cancer_sim', 'rmsn'): (1.0159156509949918, 1.6657647824328885,
                             1.6270083606765022, 1.6150454737731104,
                             1.5928081428271117, 1.57230056840634),
    ('EQ_4_D', 'gnet'): (0.5761336616204725, 0.7134392317710364,
                         0.836870714568908, 0.9349265885428446,
                         1.0150799195641653, 1.0779590501092622),
    ('cancer_sim', 'gnet'): (0.6903167401447208, 0.7484567915665562,
                             0.9251468560789172, 1.0587084438666867,
                             1.1640690248672214, 1.2548171652271778),
    ('EQ_4_D', 'edct'): (0.6475848557332772, 0.6621655976428016,
                         0.5940026977200824, 0.5142882399038425,
                         0.48980424632252706, 0.4771176733832437),
    ('cancer_sim', 'edct'): (1.277184631111807, 1.1444911758971008,
                             1.2743055635365468, 1.3894512947447633,
                             1.4722506996693432, 1.5378630290235815)}
NEURAL_DATASETS = ('EQ_4_D', 'cancer_sim')
# phase 9's methods, then phase 10's
NEURAL_METHODS = ('ct', 'crn')
NEURAL_6B_METHODS = ('rmsn', 'gnet', 'edct')
# by method, the (lower, upper) factors on `NEURAL_REF` at 1 step and at
# 2..6 steps: the two packages' training draws differ (shuffles, dropout
# masks, initial weights) and so do their EQ_4 cohorts, so a row lands
# anywhere in the method's spread over seeds. That spread is the JAX
# package's own rows at seeds 0-3 (the tool above with --seed 0..3), as
# ratios to seed 0, over both datasets:
#   ct   1 step x0.613-1.739, 2..6 steps x0.575-3.395 (EQ_4_D 2-step, seed 2)
#   crn  1 step x0.781-1.360, 2..6 steps x0.593-1.945 (at 10 epochs)
#   rmsn 1 step x0.772-1.655, 2..6 steps x0.570-1.224 (at 10 epochs)
#   gnet 1 step x0.493-1.184, 2..6 steps x0.376-1.169
#   edct 1 step x0.733-1.362, 2..6 steps x0.619-3.971 (at 10 epochs)
# Each lower edge is half the lowest ratio, rounded down to 0.05; each upper
# edge 1.25x the highest, rounded up to 0.5. The port is read against these
# edges, which come from the reference alone.
NEURAL_BANDS = {'ct': ((0.3, 2.5), (0.25, 4.5)),
                'crn': ((0.35, 2.0), (0.25, 2.5)),
                'rmsn': ((0.35, 2.5), (0.25, 2.0)),
                'gnet': ((0.2, 1.5), (0.15, 1.5)),
                'edct': ((0.35, 2.0), (0.3, 5.0))}
# a neural row's keys in the JAX package's order; an rmsn row also names
# its stabilized weights' formula, before 'method'
NEURAL_ROW_KEYS = (['encoder_test_rmse_all', 'encoder_test_rmse_orig',
                    'encoder_test_rmse_last'] +
                   [f'decoder_test_rmse_{k}-step' for k in range(2, 7)] +
                   ['method', 'seed', 'seconds_taken', 'errored',
                    'dataset_name', 'method_name', 'domain_conf'])
# card f32 against host f32 from the same initial weights (dropout 0, one
# batch per epoch, 3 epochs): the predictions' relative tolerance
NEURAL_CARD_RTOL = 1e-3
# (experiment, dataset, the row key of the setting, the `RunConfig` field
# of the grid, the grid): three of each default grid's five settings, the
# main table's and both ends, to keep the script well inside its time limit
INSIGHT_SWEEPS = (
    ('INSIGHT_CONFOUNDING', 'EQ_4_D', 'domain_conf', 'domain_confs',
     (0, 2, 4)),
    ('INSIGHT_NOISE', 'EQ_4_B', 'noise_scale', 'noise_scales',
     (0.0, 1.0, 5.0)),
    ('INSIGHT_LESS_SAMPLES', 'EQ_4_D', 'train_samples', 'train_sample_grid',
     (50, 250, 1000)))
# phase 11: the port's `--vectorized` columns at the reference size (10
# seeds, 1,000 / 100 patients, seq 60, horizon 5, gamma 2, f32), by column
# "<dataset> <method>" or "INSIGHT_CONFOUNDING <gamma> insite".
VECTORIZED_SEEDS = 10
# The JAX package's vectorized columns at the same size, float32 on the
# CPU: the 10-seed means of the 1-step and the 2..6-step RMSE, %, from
# `JAX_PLATFORMS=cpu python3 tools/vectorized_reference_rmses.py`.
VECTORIZED_REF = {
    'EQ_4_D sindy':
        (0.116414, 0.117346, 0.118115,
         0.118471, 0.118187, 0.117203),
    'EQ_4_D insite':
        (0.020571, 0.029340, 0.035281,
         0.040667, 0.045103, 0.048483),
    'EQ_4_D wsindy':
        (0.115533, 0.116690, 0.117664,
         0.118189, 0.118051, 0.117169),
    'cancer_sim sindy':
        (1.349640, 1.453213, 1.433901,
         1.408644, 1.382065, 1.360747),
    'cancer_sim insite':
        (0.853513, 0.966506, 0.963714,
         0.956195, 0.951454, 0.958107),
    'EQ_5_D sindy':
        (1.349643, 1.453215, 1.433907,
         1.408648, 1.382071, 1.360756),
    'EQ_5_D insite':
        (0.730761, 0.847817, 0.856533,
         0.859254, 0.864328, 0.880332),
    'EQ_4_D msm':
        (0.716369, 1.583745, 1.775676,
         1.963711, 2.146114, 2.322637),
    'cancer_sim msm':
        (0.939803, 1.371279, 1.600412,
         1.727744, 1.784235, 1.784443),
    'INSIGHT_CONFOUNDING 0 insite':
        (0.021728, 0.029339, 0.035321,
         0.040730, 0.045218, 0.048653),
    'INSIGHT_CONFOUNDING 4 insite':
        (0.021728, 0.029188, 0.034896,
         0.040122, 0.044435, 0.047711),
}
# The same command's two-sided (lower, upper) factors on each mean at 1 step
# and at 2..6 steps, built as `NEURAL_BANDS` are: the JAX per-seed values
# as ratios to their column's mean, half the lowest ratio rounded down to
# 0.05, 1.25x the highest rounded up to 0.5. The port's EQ_4 cohorts come
# from another generator and its tumor cohorts match the JAX package's in
# distribution only, so its column mean is held to the JAX package's own
# spread.
VECTORIZED_BANDS = {
    'EQ_4_D sindy': ((0.4, 2.0), (0.4, 2.0)),
    'EQ_4_D insite': ((0.45, 1.5), (0.3, 3.0)),
    'EQ_4_D wsindy': ((0.4, 2.0), (0.4, 2.0)),
    'cancer_sim sindy': ((0.35, 2.0), (0.35, 2.0)),
    'cancer_sim insite': ((0.3, 2.0), (0.35, 2.0)),
    'EQ_5_D sindy': ((0.35, 2.0), (0.35, 2.0)),
    'EQ_5_D insite': ((0.3, 2.0), (0.35, 2.0)),
    'EQ_4_D msm': ((0.3, 2.5), (0.2, 5.0)),
    'cancer_sim msm': ((0.35, 2.0), (0.35, 2.0)),
    'INSIGHT_CONFOUNDING 0 insite': ((0.45, 2.0), (0.3, 3.0)),
    'INSIGHT_CONFOUNDING 4 insite': ((0.45, 1.5), (0.3, 2.5)),
}
# kernel launches of one column run as one batch: (rollout, sensitivity).
# A fine-tune is gn_iters + 1 sensitivity launches and 1 rollout; insite's
# n-step fine-tune is followed by the rollout of every plan row.
VECTORIZED_LAUNCHES = {'sindy': (2, 0), 'wsindy': (2, 0),
                       'insite': (3, 2 * (GN_ITERS + 1)), 'msm': (0, 0)}
# the confounding columns fine-tune the 1-step rows per prefix too
VECTORIZED_CONFOUNDING_GAMMAS = (0.0, 4.0)
# phase 11's calls of `vectorized_sweep`: (experiment, dataset, method,
# the `VECTORIZED_REF` keys of its columns)
VECTORIZED_CALLS = tuple(
    ('MAIN_TABLE', ds, m, (f'{ds} {m}',))
    for ds, m in (('EQ_4_D', 'sindy'), ('EQ_4_D', 'insite'),
                  ('EQ_4_D', 'wsindy'), ('cancer_sim', 'sindy'),
                  ('cancer_sim', 'insite'), ('EQ_5_D', 'sindy'),
                  ('EQ_5_D', 'insite'), ('EQ_4_D', 'msm'),
                  ('cancer_sim', 'msm'))) + (
    ('INSIGHT_CONFOUNDING', 'EQ_4_D', 'insite',
     tuple(f'INSIGHT_CONFOUNDING {g:g} insite'
           for g in VECTORIZED_CONFOUNDING_GAMMAS)),)
# a vectorized row's keys in the JAX package's order
VECTORIZED_ROW_KEYS = (['encoder_test_rmse_orig', 'encoder_test_rmse_all',
                        'encoder_test_rmse_last'] +
                       [f'decoder_test_rmse_{k}-step' for k in range(2, 7)] +
                       ['method', 'seed', 'seconds_taken', 'vectorized',
                        'errored', 'dataset_name', 'method_name',
                        'domain_conf'])
# phase 12: the neural `--vectorized` columns at the reference size (10
# seeds, 1,000 / 100 / 100 patients, f32, the JAX package's widths), by
# column "<dataset> <method>", and the epochs of each method there. A
# stacked fit is host-bound like a standard one (1.4-2.2x a standard epoch
# for ten seeds, `tools/vectorized_neural_epoch_times.py`), so the JAX
# package's 100 epochs do not fit phase 12's ~200 s: ct and gnet train
# `VEC_NEURAL_FAST_E`, crn, rmsn and edct `VEC_NEURAL_E` (the CLI at 100
# epochs: PERF.md).
VEC_NEURAL_FAST_E = 20
VEC_NEURAL_E = 2
VEC_NEURAL_EPOCHS = {'ct': VEC_NEURAL_FAST_E, 'gnet': VEC_NEURAL_FAST_E,
                     'crn': VEC_NEURAL_E, 'rmsn': VEC_NEURAL_E,
                     'edct': VEC_NEURAL_E}
VEC_NEURAL_COLUMNS = tuple(('EQ_4_D', m) for m in
                           ('ct', 'crn', 'edct', 'rmsn', 'gnet')) + (
    ('cancer_sim', 'ct'), ('cancer_sim', 'gnet'))
# The JAX package's vectorized neural columns at the same size and epochs,
# float32 on the CPU: the 10-seed means of the 1-step and the 2..6-step RMSE,
# %, from `JAX_PLATFORMS=cpu python3 tools/vectorized_neural_reference_rmses.py
# --column <dataset> <method> <epochs>`. ct and gnet: their columns' n-step
# evaluation (59,000 rows a seed; gnet 25 Monte-Carlo views of them) takes
# ~25 min and, for gnet, ~25 GB on the host at 10 seeds, so their means are
# over seeds 0-3 (`--seeds 4`).
VECTORIZED_NEURAL_REF = {
    'EQ_4_D ct': (0.983301, 1.407082, 1.532603,          # 4 seeds
                  1.588124, 1.623770, 1.640984),
    'EQ_4_D crn': (3.120782, 8.308597, 7.079283,
                   6.307690, 5.788508, 5.455981),
    'EQ_4_D edct': (3.771090, 4.028751, 3.478616,
                    3.116031, 2.934098, 2.833504),
    'EQ_4_D rmsn': (10.078219, 6.585369, 6.590902,
                    6.373551, 6.174568, 5.996847),
    'EQ_4_D gnet': (0.740218, 0.914764, 1.003316,        # 4 seeds
                    1.061683, 1.102282, 1.131378),
    'cancer_sim ct': (1.148871, 1.099857, 1.237579,      # 4 seeds
                      1.412552, 1.546744, 1.621830),
    'cancer_sim gnet': (0.720702, 0.849174, 0.875266,    # 4 seeds
                        0.914356, 0.955097, 0.992005),
}
# The same command's two-sided (lower, upper) factors on each mean at 1 step
# and at 2..6 steps, built as `VECTORIZED_BANDS` are: the JAX per-seed values
# as ratios to their column's mean, half the lowest ratio rounded down to
# 0.05, 1.25x the highest rounded up to 0.5. The two packages share no
# random stream (cohorts on EQ_4, initial weights, batches, masks), so a
# column's mean is held to the JAX package's own spread.
VECTORIZED_NEURAL_BANDS = {
    'EQ_4_D ct': ((0.3, 2.0), (0.3, 2.0)),
    'EQ_4_D crn': ((0.35, 2.5), (0.25, 2.5)),
    'EQ_4_D edct': ((0.3, 2.5), (0.2, 3.0)),
    'EQ_4_D rmsn': ((0.4, 2.0), (0.3, 2.0)),
    'EQ_4_D gnet': ((0.35, 1.5), (0.35, 2.0)),
    'cancer_sim ct': ((0.35, 1.5), (0.4, 2.0)),
    'cancer_sim gnet': ((0.35, 1.5), (0.35, 2.0)),
}
# a column's peak device memory may take half of the 80 GB card
VEC_NEURAL_PEAK_MIB = 40 * 1024
# the JAX package's tolerance between a vectorized seed and the standard
# run of the same cohort (tests/test_vectorized.py, 1-step RMSE)
VECTORIZED_SEED0_RTOL = 0.2
# phase 13: a lam tune stacks the validation cohort (100 patients) once
# per value of the 7-value grid; card f32 and host f64 scores agree to
# this relative tolerance
TUNING_ROWS = 700
TUNE_SCORE_RTOL = 1e-3
# phase 14: the real-data path. The neural baselines fit on a
# `RealDatasetCollection` of the reference's cohort size (an EQ_4_D cohort,
# seq 60, gamma 2, multilabel) with a fabricated vitals stream, at the JAX
# package's config widths, for `REAL_EPOCHS` epochs (the phase has ~90 s)
REAL_METHODS = ('ct', 'crn', 'rmsn', 'gnet', 'edct')
REAL_SIZES = {'train': 1000, 'val': 100, 'test': 100}
REAL_SMALL_SIZES = {'train': 200, 'val': 10, 'test': 10}
REAL_EPOCHS = 2
REAL_DIM_VITALS = 2
# attention maps of ct and edct's encoder on this many test rows, each row
# a distribution within this
ATTENTION_ROWS = 256
ATTENTION_ROW_ATOL = 1e-4
# phase 15: the BFGS fine-tune as a user's --config sets it (and the JAX
# package's tests and bench.py), and the gates of its checks
BFGS_OVERRIDES = {'insite_solver': 'bfgs', 'bfgs_maxiter': 100}
# the JAX package's rule (tests/test_e2e_eq4.py): Gauss-Newton's 1-step
# RMSE at most this times BFGS's
GN_OVER_BFGS = 1.05
BFGS_SMALL_MAXITER = 20
BFGS_CARD_HOST_RTOL = 1e-6
# BFGS's convergence test: the largest gradient entry below this (JAX's)
BFGS_GTOL = 1e-5
# in f64 a row whose line search ends with the zoom failed (status 3) sits
# at the edge of the precision: which rows end so depends on the last bits
# of the gradient, so the card and the host may differ there (and so do
# the JAX package and the port on the CPU), as may the iteration count at
# which a row converges (`check_bfgs_rows`); rows that differ otherwise
# fail, and so does a share of failed zooms above this
BFGS_MAX_ZOOM_FAILED = 0.10
XLA_RTOL = 1e-3
LEGACY_SIZES = dict(train_samples=1000, val_samples=100, test_samples=100)
LEGACY_RTOL = 1e-10
SR3_THRESHOLD = 0.05
SR3_RTOL = 1e-8
# phase 16: the bench as `bench.py` runs it by default (10,000 patients,
# two device-time repeats), its JSON keys and metric name
BENCH_REPEATS = 2
BENCH_LINE_KEYS = {'metric', 'value', 'unit', 'vs_baseline'}
BENCH_METRIC = 'eq4_10k_simulate_discover_finetune_wall_s'
BENCH_CHILD_TIMEOUT_S = 300
# phase 17: the batch mesh. Sharded against unsharded on the card, f32
# (predictions, coefficients, per-seed RMSEs)
MESH_RTOL, MESH_ATOL = 1e-5, 1e-7
MESH_SEEDS = 10
# phase 18: the public surface. `masked_ridge` on the card against the
# host's float64 solve of the same values: f64 to rounding, f32 to its
# cast of the float64 solve
SURFACE_RIDGE_RTOL = {'float64': 1e-10, 'float32': 1e-6}
SURFACE_CHILD_TIMEOUT_S = 120
# phase 16's `python -m insite_tpu_torch.bench` child, seconds from its
# start, before the subpackages exported their names: the median of two
# runs of `tools/time_bench_child.py` on the tree before them (NVIDIA H100
# 80GB HBM3, 700.00 W; the tree with the exports 10.671 s in the same call)
BENCH_CHILD_BEFORE_S = 10.178267237999997
# repetitions of a plain version in phase 3's call timing (each takes
# 0.1-0.3 s; the kernels take 20)
PLAIN_REPS = 5
# the settings that are the main table's EQ_4_D and EQ_4_B rows: insite's
# 1-step limit there is the main table's
INSIGHT_MAIN_TABLE_SETTINGS = {('INSIGHT_CONFOUNDING', 2),
                               ('INSIGHT_NOISE', 1.0),
                               ('INSIGHT_LESS_SAMPLES', 1000)}
INSIGHT_METHODS = ('sindy', 'insite', 'msm')
# rows per fine-tune call with the degree-4 library
# (models/sindy.py::SINDyRegressor._fine_tune)
DEGREE4_CHUNK = 2048
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
    """{label: median device time of one call (ms)} for jobs of
    (label, kernel key, fn, launches a call), from one torch.profiler
    session: each fn runs reps times, after a warm-up call outside the
    session, and a fill kernel marks the boundary between jobs. A call is
    one launch, or one launch per group of coordinates where the
    sensitivities go in groups: the call's time is then the sum of its
    launches, and the session must hold every one of them, since a missing
    one would pair launches of different calls. Where a call is one launch,
    a launch the profiler misses costs one sample, not the run. One session
    only: the profiler has returned no kernel events at all in a later
    session of the same process."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _, _, fn, _ in jobs:
        fn()
    marker = torch.zeros(1, device='cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        marker.fill_(1.0)
        for _, _, fn, _ in jobs:
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
    for (label, kernel, _, n), span in zip(jobs, spans):
        us = [e.time_range.end - e.time_range.start for e in span
              if KERNEL_NAMES[kernel] in e.name]
        if len(us) > reps * n or len(us) < (reps * n if n > 1
                                            else reps // 2):
            raise AssertionError(
                f'the profiler saw {len(us)} {kernel} kernel launches in '
                f'{reps} calls of {n} ({label})')
        calls = [sum(us[i:i + n]) for i in range(0, len(us), n)]
        out[label] = statistics.median(calls) / 1e3
    return out


def kernel_times(cases, device):
    """Device time of one call and the bound of both kernels, f32, at the
    given shapes: {tag: {'rollout_device_ms', 'rollout_bound_ms',
    'rollout_bound_by', and the same for 'sens'}}."""
    import torch
    from insite_tpu_torch.ops import rollout
    bound = rollout.kernel_bounds()['Kr']
    jobs = []
    for tag, case in cases.items():
        a = tensors(case, torch.float32, device)
        act, clip = case['active_idx'], case['y_clip']
        jobs.append(((tag, 'rollout'), 'rollout',
                     lambda a=a, clip=clip: rollout.batched_rollout(
                         *a, y_clip=clip), 1))
        jobs.append(((tag, 'sens'), 'sens',
                     lambda a=a, act=act, clip=clip: rollout.rollout_with_sens(
                         *a, act, y_clip=clip), -(-len(act) // bound)))
    dev = device_times(jobs)
    out = {}
    for tag, case in cases.items():
        t = out[tag] = {}
        for key in ('rollout', 'sens'):
            t[f'{key}_device_ms'] = dev[tag, key]
            t[f'{key}_bound_ms'], t[f'{key}_bound_by'] = kernel_bound(case,
                                                                      key)
            dev_ms, bound = t[f'{key}_device_ms'], t[f'{key}_bound_ms']
            log(f'  {tag} f32 {key} device time per call (profiler, median '
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


def split_case(B, T, seed, n_active=100):
    """The degree-4 library over 4 arms (4 x 35 = 140 coordinates) with 100
    of them active: more than the sensitivity kernel takes at once, so
    `rollout_with_sens` goes through it in groups. Decay on y plus small
    terms keeps the state near 1."""
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    rng = np.random.RandomState(seed)
    library = PolynomialLibrary(n_inputs=3, degree=4, interaction_only=False)
    F = library.n_features
    base = np.zeros((4, F))
    base[:, 1] = -1.0                            # feature 1 is y
    others = rng.choice(np.delete(np.arange(4 * F),
                                  [a * F + 1 for a in range(4)]),
                        n_active - 4, replace=False)
    base.reshape(-1)[others] = (0.02 * rng.choice([-1, 1], n_active - 4)
                                * (0.5 + rng.rand(n_active - 4)))
    active = tuple(int(i) for i in np.flatnonzero(base.reshape(-1)))
    assert len(active) == n_active
    return dict(library=library,
                coefs=base[None] * (1 + 0.05 * rng.randn(B, 4, F)),
                y0=rng.rand(B) + 0.5, statics=rng.rand(B, 2),
                arms=rng.randint(0, 4, (B, T)), dt=1 / 6,
                active_idx=active, y_clip=None)


def fitted_model(name, device, treatment_mode='multiclass', **flags):
    """One collection of ``name`` of the default size (1,000 / 100 / 100,
    seed 0) on the card and the INSITE model fitted on it, with the
    dataset's threshold; ``flags`` go to `SINDyConfig`."""
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import (model_dataset_name,
                                                 sindy_params_for)
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection(name, {'train': 1000, 'val': 100, 'test': 100},
                           seed=0, coeff=2.0, treatment_mode=treatment_mode,
                           device=device)
    cfg = SINDyConfig(dataset_name=model_dataset_name(name),
                      sindy_threshold=sindy_params_for(name)[0], insite=True,
                      treatment_mode=treatment_mode, **flags)
    return coll, SINDyRegressor(cfg, coll, device=device).fit(coll.train_f)


def model_case(model, ds, seed=None, rows=slice(None)):
    """The kernel inputs a fitted model gives on ``rows`` of dataset ``ds``,
    with its support and clip: the shared fitted coefficients or, with
    ``seed``, per-row ones 5 % around them. A joint (one-ODE) model gives
    the folded per-arm case the kernels run (the reduced library, one arm
    per combination of the treatment inputs, the effective coordinates);
    its entry 'joint' holds the joint library, the [B, 1, F_joint]
    coefficients and the per-step treatment inputs for the plain joint
    versions."""
    import torch
    from insite_tpu_torch.ops.joint_fold import combination_index
    prev, statics, arms, _ = model._unscaled_arrays(ds)
    prev, statics, arms = prev[rows], statics[rows], arms[rows]
    coefs = model.coefs.astype(np.float64)[None]
    if seed is not None:
        rng = np.random.RandomState(seed)
        coefs = coefs * (1 + 0.05 * rng.randn(len(prev), *coefs.shape[1:]))
    case = dict(library=model.library, coefs=coefs, y0=prev[:, 0],
                statics=statics, arms=arms, dt=model.dt,
                active_idx=model._active_idx(), y_clip=model._y_clip())
    fold = model._fold
    if fold is None:
        return case
    del case['arms']
    joint = dict(case, fold=fold, treatments=arms)
    return dict(case, library=fold.library,
                coefs=fold.effective(torch.as_tensor(coefs)).numpy(),
                arms=combination_index(arms),
                active_idx=fold.effective_active(case['active_idx'])[0],
                joint=joint)


def table_cases(name, device, seeds):
    """Kernel inputs at a main table's shapes, from the INSITE model fitted
    on one collection of ``name``: the n-step test set (per-step arms,
    per-row coefficients drawn from ``seeds[0]``) and the 1-step test set
    (the shared fitted coefficients)."""
    coll, model = fitted_model(name, device)
    n_step = model_case(model, coll.test_cf_treatment_seq, seeds[0])
    one_step = model_case(model, coll.test_cf_one_step)
    switches = int((np.diff(n_step['arms'], axis=1) != 0).any(1).sum())
    log(f'  {name} cases: n-step arms {n_step["arms"].shape} ({switches} '
        f'rows switch arm), 1-step arms {one_step["arms"].shape}, '
        f'F={model.coefs.shape[1]}, Kr={len(n_step["active_idx"])}, y_clip '
        f'{n_step["y_clip"]}: {model.global_equation_string}')
    assert n_step['arms'].shape[1] == 64 and switches > 0
    assert one_step['arms'].shape[1] == 59
    return n_step, one_step


def family_cases(device):
    """Kernel inputs at the shapes of the rest of the SINDy family, all
    with per-row coefficients, as the fine-tune's launches have them:

    - the one-ODE model of a cancer_sim and of an EQ_4_D fit folded onto the
      kernels, on the n-step and 1-step test sets (4 combinations x 4
      reduced features, up to 16 effective coordinates; 2 x 7, up to 14);
    - one chunk of the degree-4 fine-tune on EQ_4_D: the first 2,048 rows
      of the n-step (T=64) and of the 1-step (T=59) test set, F=35, the
      fitted support;
    - the recovery's validation cohort on EQ_4_D (B=100, T=59);
    - 4 arms x the degree-4 library with 100 active coordinates, which go
      through the sensitivity kernel in two groups."""
    cases = {}
    for name, short, n_arms in (('cancer_sim', 'cancer_sim', 4),
                                ('EQ_4_D', 'eq4d', 2)):
        coll, model = fitted_model(name, device, treatment_mode='multilabel',
                                   joint_model=True)
        for i, (tag, ds) in enumerate((('nstep', coll.test_cf_treatment_seq),
                                       ('1step', coll.test_cf_one_step))):
            case = model_case(model, ds, seed=9 + i)
            cases[f'fold_{short}_{tag}'] = case
            assert case['coefs'].shape[1] == n_arms and case['active_idx']
        joint = case['joint']
        log(f'  {name} one-ODE fold: joint F={model.coefs.shape[1]} Kr='
            f'{len(joint["active_idx"])} -> {n_arms} combinations x F='
            f'{case["library"].n_features}, Kr_eff='
            f'{len(case["active_idx"])}: '
            f'{model.global_equation_string}')
    coll, model = fitted_model('EQ_4_D', device,
                               ablation_more_complex_basis_functions=True)
    chunk = slice(0, DEGREE4_CHUNK)
    cases['degree4_chunk_nstep_b2048_t64'] = model_case(
        model, coll.test_cf_treatment_seq, seed=11, rows=chunk)
    cases['degree4_chunk_1step_b2048_t59'] = model_case(
        model, coll.test_cf_one_step, seed=12, rows=chunk)
    log(f'  EQ_4_D degree-4 chunk: F={model.coefs.shape[1]}, Kr='
        f'{len(model._active_idx())}: {model.global_equation_string}')
    assert model.coefs.shape[1] == 35 and model._active_idx()
    coll, model = fitted_model('EQ_4_D', device)
    cases['recovery_val_b100_t59'] = model_case(model, coll.val_f, seed=13)
    cases['split_a4_f35_kr100_b10000_t59'] = split_case(N_PATIENTS, 59, 10)
    for tag, case in cases.items():
        B, T = case['arms'].shape
        log(f'  {tag}: B={B} T={T} A={case["coefs"].shape[1]} '
            f'F={case["coefs"].shape[2]} Kr={len(case["active_idx"])}')
    return cases


def distinct_supports(fits):
    """Per-seed models [S, A, F] with S different supports, from the seeds'
    fitted models ``fits``: the union U of their supports (grown to at
    least 4 coordinates by the lowest others, each set to 1 % of its arm's
    largest coefficient) is filled in on every seed (with the other seeds'
    mean where a seed's own fit is zero), then seed s drops the s-th
    subset of U, in order of size (none, each single, each pair, ...).
    Returns (models, U: the active set, the union)."""
    import itertools
    S, A, F = fits.shape
    flat = fits.reshape(S, A * F).copy()
    U = [int(i) for i in np.flatnonzero((np.abs(flat) > 1e-3).any(0))]
    for i in range(A * F):
        if len(U) >= 4:
            break
        if i not in U:
            arm = flat[:, (i // F) * F:(i // F + 1) * F]
            flat[:, i] = 0.01 * np.abs(arm).max()
            U.append(i)
    for i in U:
        own = np.abs(flat[:, i]) > 1e-3
        flat[~own, i] = flat[own, i].mean()
    subsets = itertools.chain.from_iterable(
        itertools.combinations(sorted(U), k) for k in range(len(U) + 1))
    for s, drop in zip(range(S), subsets):
        flat[s, list(drop)] = 0.0
    supports = {tuple(np.flatnonzero(np.abs(row) > 1e-3)) for row in flat}
    assert len(supports) == S, 'the seeds\' supports are not all different'
    return flat.reshape(S, A, F), tuple(sorted(U))


def stacked_cases(device):
    """Kernel inputs at phase 11's seed-stacked shapes, simulated as
    `harness/vectorized.py` simulates a column of `VECTORIZED_SEEDS`
    seeds: the n-step test rows of EQ_4_D (B=590,000, T=64) and the 1-step
    test rows of cancer_sim (B=236,000, T=59, A=4, y_clip), each seed's
    rows with its own fitted model restricted to a support of its own
    (`distinct_supports`), the active set their union."""
    from insite_tpu_torch.core.constants import STANDARD_DT
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    from insite_tpu_torch.harness import vectorized
    from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD
    seeds = range(VECTORIZED_SEEDS)
    cases = {}
    for tag, eq4, subset in (('stacked_eq4d_nstep', True, 'n_step'),
                             ('stacked_cancer_sim_1step', False,
                              'one_step')):
        if eq4:
            cohorts = [vectorized.eq4_cohort(s, 'EQ_4_D', 1000, 100, 60, 2.0,
                                             5, device=device)
                       for s in seeds]
            thr, A, clip = 0.1, 2, None
        else:
            cohorts = [vectorized.tumor_cohort(vectorized.tumor_draws(
                s, 'cancer_sim', 1000, 100, 60, 2.0, 5, device=device),
                60, 5) for s in seeds]
            thr, A = 0.001, 4
            clip = (0.0, float(TUMOUR_DEATH_THRESHOLD))
        library = PolynomialLibrary(
            n_inputs=1 + cohorts[0]['train'][3].shape[-1])
        fits = vectorized._discover(cohorts, library, A, eq4, 'sindy', thr,
                                    0.5, STANDARD_DT)
        models, union = distinct_supports(fits)
        rows, arms, _, statics, _ = vectorized._stack(cohorts, subset)
        per_seed = rows.shape[0] // VECTORIZED_SEEDS
        cases[tag] = dict(library=library,
                          coefs=np.repeat(models, per_seed, axis=0),
                          y0=rows[:, 0].cpu().numpy(),
                          statics=statics.cpu().numpy(),
                          arms=arms.cpu().numpy(), dt=STANDARD_DT,
                          active_idx=union, y_clip=clip)
        log(f'  {tag}: {VECTORIZED_SEEDS} seeds x {per_seed} rows, B='
            f'{rows.shape[0]} T={arms.shape[1]} A={A} '
            f'F={models.shape[2]} Kr={len(union)} (the union of '
            f'{VECTORIZED_SEEDS} different supports)')
    assert cases['stacked_eq4d_nstep']['arms'].shape == (590_000, 64)
    assert cases['stacked_cancer_sim_1step']['arms'].shape == (236_000, 59)
    return cases


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
        rollout.reset_launch_counts()
        y_k = rollout.batched_rollout(*args, y_clip=clip)
        ys_k, s_k = rollout.rollout_with_sens(*args, act, y_clip=clip)
        groups = -(-len(act) // rollout.kernel_bounds()['Kr'])
        if (rollout.ROLLOUT_LAUNCHES, rollout.SENS_LAUNCHES) != (1, groups):
            raise AssertionError(
                f'{name} {tag}: expected 1 rollout and {groups} sensitivity '
                f'launches, got {rollout.ROLLOUT_LAUNCHES} and '
                f'{rollout.SENS_LAUNCHES}')
        y_p = rollout.batched_rollout_plain(*args, y_clip=clip)
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
                                                          y_clip=clip),
                    reps=PLAIN_REPS, warmup=1),
                'sens_ms': time_ms(lambda: rollout.rollout_with_sens(
                    *args, act, y_clip=clip)),
                'sens_plain_ms': time_ms(
                    lambda: rollout.rollout_with_sens_plain(*args, act,
                                                            y_clip=clip),
                    reps=PLAIN_REPS, warmup=1),
            }
            log(f'  {name} f32 time per call (median of 20, plain of '
                f'{PLAIN_REPS}): rollout '
                f'{t["rollout_ms"]:.4f} ms vs plain '
                f'{t["rollout_plain_ms"]:.2f} ms; sens {t["sens_ms"]:.4f} '
                f'ms vs plain {t["sens_plain_ms"]:.2f} ms')
            out['times'] = t
    return out


def run_fold_case(name, case, device):
    """The joint model through the kernels (`JointFold`: one launch of each
    kernel, then ``s_eff @ M``) against the plain joint rollout and the
    plain joint sensitivity recurrence, f32 and f64, within `TOL`."""
    import torch
    from insite_tpu_torch.ops import rollout
    from insite_tpu_torch.ops.joint_fold import combination_index
    fold, lib = case['fold'], case['library']
    act, clip, dt = case['active_idx'], case['y_clip'], case['dt']
    arms = torch.as_tensor(combination_index(case['treatments']),
                           device=device)
    zeros = torch.zeros_like(arms)
    out = {}
    for tag, dtype in (('f32', torch.float32), ('f64', torch.float64)):
        f = dict(dtype=dtype, device=device)
        c, y0, u, tr = (torch.as_tensor(case[k], **f) for k in
                        ('coefs', 'y0', 'statics', 'treatments'))
        rollout.reset_launch_counts()
        y_k = fold.rollout(c, y0, u, arms, dt, y_clip=clip)
        ys_k, s_k = fold.rollout_with_sens(c, y0, u, arms, dt, act,
                                           y_clip=clip)
        if (rollout.ROLLOUT_LAUNCHES, rollout.SENS_LAUNCHES) != (1, 1):
            raise AssertionError(f'{name} {tag}: the fold launched '
                                 f'{rollout.ROLLOUT_LAUNCHES} rollouts and '
                                 f'{rollout.SENS_LAUNCHES} sensitivities')
        y_p = rollout.batched_rollout_plain(lib, c, y0, u, zeros, dt,
                                            y_clip=clip, treatments=tr)
        ys_p, s_p = rollout.rollout_with_sens_plain(
            lib, c, y0, u, zeros, dt, act, y_clip=clip, treatments=tr)
        torch.cuda.synchronize()
        tol = TOL[tag]
        err_roll = check_close(f'{name} {tag} rollout', y_k, y_p, *tol['y'])
        err_y = check_close(f'{name} {tag} sens y', ys_k, ys_p, *tol['y'])
        flips = clip_flips(ys_k, ys_p, clip)
        n_flip = 0 if flips is None else int(flips.sum())
        if n_flip > max(1, ys_k.shape[0] // 1000):
            raise AssertionError(f'{name} {tag}: {n_flip} rows with '
                                 'different clip decisions')
        err_s = check_close(f'{name} {tag} sens', s_k, s_p, *tol['sens'],
                            rows=None if flips is None else ~flips)
        log(f'  {name} {tag}: max abs err rollout {err_roll:.3e}, sens y '
            f'{err_y:.3e}, sens (s_eff @ M vs the joint recurrence) '
            f'{err_s:.3e}; {n_flip} rows differ in a clip decision')
        out[tag] = {'rollout_err': err_roll, 'sens_err': max(err_y, err_s)}
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
    n-step predictions, of every method; the fit of each network apart
    (``fit_stages``: seconds, batches and the optimizer steps of a batch,
    in the order the networks train); the kernel launches since the run
    began (``launches_at_start``, read by `run_sweep`); and the run's peak
    device memory. One record per run, in sweep order."""
    import torch
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.models import gnet, rmsn
    from insite_tpu_torch.models.crn import CRN
    from insite_tpu_torch.models.ct import CausalTransformer
    from insite_tpu_torch.models.edct import EDCT
    from insite_tpu_torch.models.msm import MSM
    from insite_tpu_torch.models.nn.training import BRStage
    from insite_tpu_torch.models.sindy import SINDyRegressor
    from insite_tpu_torch.ops import rollout
    # ct's, crn's and edct's 1-step predictions (crn's and edct's: their
    # encoder's) go through BRStage.get_predictions; rmsn's decoder
    # processing asks for predictions too: the last call of a run is the
    # runner's
    hooks = [(runner, '_collection_for', 'collection'),
             (runner, '_build_model', 'process'),
             (BRStage, 'fit_stage', 'fit_stage'),
             (BRStage, 'get_predictions', 'predict_1_step'),
             (rmsn, 'fit_simple', 'fit_simple'),
             (gnet, 'fit_simple', 'fit_simple')]
    for cls in (SINDyRegressor, MSM, rmsn.RMSN, gnet.GNet):
        hooks.append((cls, 'get_predictions', 'predict_1_step'))
    for cls in (SINDyRegressor, MSM, CausalTransformer, CRN, rmsn.RMSN,
                gnet.GNet, EDCT):
        hooks += [(cls, 'fit', 'fit'),
                  (cls, 'get_autoregressive_predictions', 'predict_n_step')]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in hooks]

    def timed(fn, stage):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if stage == 'collection':
                torch.cuda.reset_peak_memory_stats(device)
                records.append({'run': args[:2], 'launches_at_start': {
                    'rollout': rollout.ROLLOUT_LAUNCHES,
                    'sens': rollout.SENS_LAUNCHES}})
            torch.cuda.synchronize(device)
            t0 = perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(device)
            records[-1][stage] = perf_counter() - t0
            if stage == 'fit' and isinstance(args[0], SINDyRegressor):
                # the fitted support, Kr, and the coordinates a sensitivity
                # call hands the kernel (the joint model: the folded ones)
                model = args[0]
                active = model._active_idx()
                records[-1]['kr'] = records[-1]['kr_kernel'] = len(active)
                if model._fold is not None and active:
                    records[-1]['kr_kernel'] = len(
                        model._fold.effective_active(active)[0])
            if stage.startswith('predict'):
                records[-1]['rows_' + stage] = len(args[1])
            if stage in ('fit_stage', 'fit_simple'):
                # BRStage.fit_stage(data): two optimizer steps a batch;
                # fit_simple(net, loss_fn, data, cfg, gen): one
                if stage == 'fit_stage':
                    cfg, data, steps = args[0].train_cfg, args[1], 2
                else:
                    cfg, data, steps = args[3], args[2], 1
                n = len(next(iter(data.values())))
                batches = cfg.epochs * (n // min(cfg.batch_size, n))
                records[-1].setdefault('fit_stages', []).append(
                    (records[-1].pop(stage), batches, steps))
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


# the networks of a neural run in the order they train, by their count
NETWORKS = {1: ('network',), 2: ('encoder', 'decoder'),
            4: ('propensity-treatment network', 'propensity-history network',
                'encoder', 'decoder')}


def run_sweep(device, datasets, tag, methods=('sindy', 'insite'),
              experiment='MAIN_TABLE', n_rows=None, keep_log=None,
              **settings):
    """The port's sweep of ``methods`` over ``datasets`` on the card (one
    seed, 1,000 / 100 / 100, debug mode), with each run's stage times,
    peak memory and Kr (none for msm) printed; ``n_rows`` where the
    experiment enumerates settings of its own dataset and not ``datasets``;
    ``keep_log``: a path the sweep's log is copied to; ``settings``:
    further `RunConfig` fields (an INSIGHT grid). Returns (rows, records,
    launches)."""
    import torch
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.harness.logging_utils import (
        create_logger_in_process, generate_log_file_path)
    from insite_tpu_torch.harness.runner import Experiment, sweep
    from insite_tpu_torch.ops import rollout
    records = []
    with tempfile.TemporaryDirectory() as log_dir:
        cfg = RunConfig(methods=methods, datasets=datasets, seed_runs=1,
                        log_dir=log_dir, debug_mode=True, **settings)
        log_path = generate_log_file_path('run', log_dir)
        logger = create_logger_in_process(log_path)
        with stage_timer(records, device):
            torch.cuda.synchronize(device)
            rollout.reset_launch_counts()
            t0 = perf_counter()
            rows, tables = sweep(cfg, Experiment[experiment], log=logger,
                                 device=device)
            torch.cuda.synchronize(device)
            wall = perf_counter() - t0
            launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                        'sens': rollout.SENS_LAUNCHES}
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        if keep_log:
            shutil.copyfile(log_path, keep_log)
    stages = ('collection', 'process', 'fit', 'predict_1_step',
              'predict_n_step')
    # each run's launches: from its start to the next run's, or the end
    for rec, end in zip(records, [r['launches_at_start']
                                  for r in records[1:]] + [launches]):
        rec['launches'] = {k: end[k] - rec['launches_at_start'][k]
                           for k in end}
    for row, rec in zip(rows, records):
        assert rec['run'] == (row['dataset_name'], row['method_name'])
        setting = ''.join(f' {k}={row[k]:g}' for k in
                          ('domain_conf', 'noise_scale', 'train_samples')
                          if experiment.startswith('INSIGHT_') and k in row)
        log(f'  {row["dataset_name"]}{setting} {row["method_name"]:6s} '
            f'1-step {row["encoder_test_rmse_orig"]:.6f} % | 6-step '
            f'{row["decoder_test_rmse_6-step"]:.6f} % | seconds_taken '
            f'{row["seconds_taken"]:.4f} s | ' + ' '.join(
                f'{s} {rec[s]:.4f}' for s in stages) +
            f' s | peak {rec["peak_mib"]:.1f} MiB | Kr {rec.get("kr")}')
        nets = NETWORKS.get(len(rec.get('fit_stages', ())))
        for net, (sec, batches, steps) in zip(nets or (),
                                              rec.get('fit_stages', ())):
            log(f'    fit of the {net}: {sec:.4f} s, {batches} batches of '
                f'{("one optimizer step", "two optimizer steps")[steps - 1]}'
                f', {batches / sec:.1f} batches/s')
        if 'global_equation_string' in row:
            log(f'    {row["global_equation_string"]}')
    log(f'[{tag}] sweep wall {wall:.4f} s; kernel launches: {launches}')
    for metric, table in tables.items():
        log(f'[{tag}] LaTeX {metric}:\n{table}')
    n_rows = n_rows or len(methods) * len(datasets)
    if len(rows) != n_rows or any(r['errored'] for r in rows):
        raise AssertionError(f'expected {n_rows} rows, none errored: {rows}')
    return rows, records, launches


def expected_launches(rows, records, experiment='MAIN_TABLE'):
    """What the runs must launch. An msm run: nothing. A sindy or wsindy
    run: 1 rollout per evaluation set (1-step, n-step). An insite run
    fine-tunes each set,
    and under INSIGHT_RECOVER_PARAMETRIC_DIST the validation cohort too:
    per fine-tune call 1 rollout and, with a non-empty support, gn_iters +
    1 sensitivity calls of one launch per group of the kernel's Kr bound
    (with an empty support nothing moves and none is launched). The
    degree-4 ablation makes one fine-tune call per chunk of 2,048 rows."""
    from insite_tpu_torch.ops import rollout
    bound = rollout.kernel_bounds()['Kr']
    want = {'rollout': 0, 'sens': 0}
    for row, rec in zip(rows, records):
        if row['method_name'] == 'msm':
            continue
        sets = [rec['rows_predict_1_step'], rec['rows_predict_n_step']]
        if row['method_name'] != 'insite':
            want['rollout'] += len(sets)
            continue
        if experiment == 'INSIGHT_RECOVER_PARAMETRIC_DIST':
            sets.append(1)              # the validation cohort, one call
        calls = sum(-(-n // DEGREE4_CHUNK) if experiment ==
                    'ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS' else 1
                    for n in sets)
        want['rollout'] += calls
        if rec['kr'] > 0:
            want['sens'] += (calls * (GN_ITERS + 1)
                             * -(-rec['kr_kernel'] // bound))
    return want


def run_main_table(device, keep_log=None):
    """Phase 5: the port's sweep over the EQ_4 main table on the card,
    its log copied to ``keep_log`` where given. Returns its launches and
    rows."""
    rows, records, launches = run_sweep(device, DATASETS, 'table',
                                        keep_log=keep_log)
    want = {'rollout': 2 * 2 * len(DATASETS),
            'sens': 2 * (GN_ITERS + 1) * len(DATASETS)}
    if launches != want:
        raise AssertionError(f'expected {want} launches, got {launches}')
    check_bands(rows)
    return launches, rows


def run_tumor_table(device, keep_log=None):
    """Phase 6: the port's sweep over the tumor main table on the card,
    held to the JAX package's RMSEs at the same seed; its log copied to
    ``keep_log`` where given."""
    rows, records, launches = run_sweep(device, TUMOR_DATASETS, 'tumor',
                                        keep_log=keep_log)
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


def run_sindy_family(device):
    """Phase 7: wsindy on both families, the one-ODE and degree-4
    ablations and the parametric-distribution recovery through the port's
    sweep on the card; launches asserted per part, RMSEs held to the JAX
    package's (`SINDY_FAMILY_REF`). Returns the launches of all parts."""
    parts = (
        ('wsindy', 'MAIN_TABLE', DATASETS + TUMOR_DATASETS, ('wsindy',),
         {'rollout': 18, 'sens': 0}),
        ('one-ode', 'ABLATION_ONE_ODE', ('EQ_4_D', 'cancer_sim'),
         ('sindy', 'insite'), {'rollout': 8, 'sens': 52}),
        ('degree-4', 'ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', ('EQ_4_D',),
         ('sindy', 'insite'), None),
        ('recovery', 'INSIGHT_RECOVER_PARAMETRIC_DIST', ('EQ_4_D',),
         ('insite',), {'rollout': 3, 'sens': 39}))
    total = {'rollout': 0, 'sens': 0}
    metrics = ('encoder_test_rmse_orig', 'decoder_test_rmse_6-step')
    for tag, experiment, datasets, methods, fixed in parts:
        log(f'[family] {tag}: {experiment}, {", ".join(methods)} x '
            f'{", ".join(datasets)}, seed 0, 1000/100/100')
        rows, records, launches = run_sweep(device, datasets, tag, methods,
                                            experiment)
        want = expected_launches(rows, records, experiment)
        if fixed is not None and want != fixed:
            raise AssertionError(f'{tag}: the fits give {want} launches, '
                                 f'not {fixed}: Kr '
                                 f'{[rec["kr"] for rec in records]}')
        if launches != want:
            raise AssertionError(f'{tag}: expected {want} launches, got '
                                 f'{launches}')
        if tag == 'degree-4':
            rec = records[-1]
            log(f'[family] degree-4 insite: Kr {rec["kr"]}, '
                f'{-(-rec["rows_predict_1_step"] // DEGREE4_CHUNK)} + '
                f'{-(-rec["rows_predict_n_step"] // DEGREE4_CHUNK)} chunks, '
                f'launches {launches}')
        for k in total:
            total[k] += launches[k]
        by = {(r['dataset_name'], r['method_name']): r for r in rows}
        for (ds, method), row in by.items():
            ref = SINDY_FAMILY_REF[experiment, ds, method]
            tumor = ds in TUMOR_DATASETS
            for i, metric in enumerate(metrics):
                got = row[metric]
                limit = (None if tumor
                         else FAMILY_BANDS[experiment, method][i])
                log(f'  {ds} {method} {metric}: card {got:.6f} % vs JAX '
                    f'{ref[i]:.6f} % ({100 * (got / ref[i] - 1):+.2f} %)'
                    + ('' if tumor else f'; band < {limit}'))
                if tumor and not abs(got / ref[i] - 1) <= TUMOR_RTOL:
                    raise AssertionError(
                        f'{tag} {ds} {method} {metric} = {got} is not within '
                        f'{TUMOR_RTOL:.0%} of {ref[i]}')
                if not tumor and not got < limit:
                    raise AssertionError(f'{tag} {ds} {method} {metric} = '
                                         f'{got} >= {limit}')
        for ds in datasets:
            if (ds, 'sindy') in by and (ds, 'insite') in by and not (
                    by[ds, 'insite'][metrics[0]] <
                    by[ds, 'sindy'][metrics[0]]):
                raise AssertionError(f'{tag} {ds}: insite not below sindy '
                                     'at 1 step')
        if tag == 'recovery':
            row = rows[0]
            for a in (0, 1):
                r = row[f'recover_arm{a}_pearson_r']
                log(f'  recovery arm {a}: Pearson r {r:.6f} over '
                    f'{row[f"recover_arm{a}_n"]} patients; decay constant '
                    f'true {row[f"recover_arm{a}_true_mean"]:.4f} +- '
                    f'{row[f"recover_arm{a}_true_std"]:.4f}, recovered '
                    f'{row[f"recover_arm{a}_recovered_mean"]:.4f} +- '
                    f'{row[f"recover_arm{a}_recovered_std"]:.4f}')
                if not r > RECOVERY_MIN_PEARSON_R:
                    raise AssertionError(f'recovery arm {a}: Pearson r {r} '
                                         f'<= {RECOVERY_MIN_PEARSON_R}')
            if np.shape(row['coef_mean']) != (2, 7) or \
                    np.shape(row['coef_std']) != (2, 7):
                raise AssertionError('coef_mean / coef_std are not [2][7]')
    log(f'[family] kernel launches of all parts: {total}')
    return total


def run_msm_table(device):
    """Phase 8a: msm on both families through the port's sweep on the card.
    The model is host numpy in float64, so no kernel may be launched; the
    tumor rows (the JAX package's cohorts) are held to `MSM_REF`, the EQ_4
    rows to the two-sided `MSM_EQ4_BAND` around it."""
    datasets = DATASETS + TUMOR_DATASETS
    log(f'[msm] sweep: msm x {", ".join(datasets)}, seed 0, 1000/100/100')
    rows, _, launches = run_sweep(device, datasets, 'msm', ('msm',))
    if launches != {'rollout': 0, 'sens': 0}:
        raise AssertionError(f'msm launched kernels: {launches}')
    for row in rows:
        ds = row['dataset_name']
        if 'global_equation_string' in row or 'fine_tuned' in row:
            raise AssertionError(f'msm {ds} row carries SINDy keys: {row}')
        tumor = ds in TUMOR_DATASETS
        for i, (metric, ref) in enumerate(zip(RMSE_METRICS, MSM_REF[ds])):
            got = row[metric]
            lo, hi = (f * ref for f in MSM_EQ4_BAND[min(i, 1)])
            log(f'  {ds} msm {metric}: card {got:.6f} % vs JAX {ref:.6f} % '
                f'({100 * (got / ref - 1):+.4f} %)'
                + ('' if tumor else f'; band ({lo:.4f}, {hi:.4f})'))
            if tumor and not abs(got / ref - 1) <= TUMOR_RTOL:
                raise AssertionError(f'msm {ds} {metric} = {got} is not '
                                     f'within {TUMOR_RTOL:.0%} of {ref}')
            if not tumor and not lo < got < hi:
                raise AssertionError(f'msm {ds} {metric} = {got} is not in '
                                     f'({lo}, {hi})')
    return launches


def run_insight_sweeps(device, keep_logs=None):
    """Phase 8b: the three robustness sweeps (sindy, insite, msm; seed 0;
    `INSIGHT_SWEEPS`) through the port's sweep on the card. Launches are
    asserted exactly per sweep; every RMSE is held to the two-sided
    `INSIGHT_BANDS` around the JAX package's (`INSIGHT_REF`). Each
    sweep's log is copied to ``keep_logs/<experiment>.txt`` where a
    directory is given. Returns the launches of all three."""
    total = {'rollout': 0, 'sens': 0}
    metrics = (RMSE_METRICS[0], RMSE_METRICS[-1])
    for experiment, dataset, key, field, grid in INSIGHT_SWEEPS:
        log(f'[insight] {experiment}: {", ".join(INSIGHT_METHODS)} on '
            f'{dataset}, {key} over {grid}, seed 0, 1000/100/100')
        rows, records, launches = run_sweep(
            device, (dataset,), experiment, INSIGHT_METHODS, experiment,
            n_rows=len(grid) * len(INSIGHT_METHODS),
            keep_log=keep_logs and f'{keep_logs}/{experiment}.txt',
            **{field: grid})
        want = expected_launches(rows, records, experiment)
        full = {'rollout': 4 * len(grid),
                'sens': 2 * (GN_ITERS + 1) * len(grid)}
        if want != full:
            empty = [row[key] for row, rec in zip(rows, records)
                     if row['method_name'] == 'insite' and rec['kr'] == 0]
            log(f'[insight] {experiment}: insite fits with an empty support '
                f'at {key} {empty}: the path launches {want}, not {full}')
        if launches != want:
            raise AssertionError(f'{experiment}: expected {want} launches, '
                                 f'got {launches}')
        for k in total:
            total[k] += launches[k]
        got_order = [(row['dataset_name'], row[key], row['method_name'])
                     for row in rows]
        if got_order != [(dataset, g, m) for g in grid
                         for m in INSIGHT_METHODS]:
            raise AssertionError(f'{experiment}: rows in order {got_order}')
        by = {(row[key], row['method_name']): row for row in rows}
        for (g, method), row in by.items():
            others = {'noise_scale', 'train_samples'} - {key}
            if others & set(row):
                raise AssertionError(f'{experiment} row carries '
                                     f'{others & set(row)}: {row}')
            for i, (metric, ref) in enumerate(zip(
                    metrics, INSIGHT_REF[experiment][g, method])):
                got = row[metric]
                lo, hi = (f * ref for f in INSIGHT_BANDS[method][i])
                if i == 0 and method == 'insite' and \
                        (experiment, g) in INSIGHT_MAIN_TABLE_SETTINGS:
                    hi = BANDS['insite', metric]['default']
                log(f'  {key} {g:g} {method} {metric}: card {got:.6f} % vs '
                    f'JAX {ref:.6f} % (x{got / ref:.3f}); band ({lo:.6f}, '
                    f'{hi:.6f})')
                if not lo < got < hi:
                    raise AssertionError(f'{experiment} {key} {g} {method} '
                                         f'{metric} = {got} is not in ({lo}, '
                                         f'{hi})')
        for g in grid:
            one_i = by[g, 'insite'][metrics[0]]
            one_s = by[g, 'sindy'][metrics[0]]
            if not one_i < one_s:
                raise AssertionError(f'{experiment} {key} {g}: insite '
                                     f'({one_i}) not below sindy ({one_s}) '
                                     'at 1 step')
        kr = [rec['kr'] for row, rec in zip(rows, records)
              if row['method_name'] == 'insite']
        log(f'[insight] {experiment}: insite Kr by setting {kr}')
    log(f'[insight] kernel launches of the three sweeps: {total}')
    return total


def check_card_against_host(device, name='EQ_4_D', n_train=200):
    """insite f32 on the card against insite f64 on the host, on one
    collection of ``name`` (``n_train`` / 10 / 10): the same support,
    coefficients within rtol 1e-3 and RMSEs within 5 %."""
    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import (model_dataset_name,
                                                 sindy_params_for)
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection(name, {'train': n_train, 'val': 10, 'test': 10},
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
    log(f'  {name} ({n_train} training patients) card f32 vs host f64: '
        f'coef max abs diff '
        f'{np.abs(c_k - c_h).max():.3e} (max rel '
        f'{(np.abs(c_k - c_h) / np.maximum(np.abs(c_h), 1e-12)).max():.3e});'
        f' 1-step {one_k:.6f} vs {one_h:.6f} %; 6-step {six_k:.6f} vs '
        f'{six_h:.6f} %')
    if not ((np.abs(c_k) > 1e-3) == (np.abs(c_h) > 1e-3)).all():
        raise AssertionError(f'support differs: {c_k} vs {c_h}')
    np.testing.assert_allclose(c_k, c_h, rtol=1e-3, atol=1e-6)
    if abs(one_k / one_h - 1) > 0.05 or abs(six_k / six_h - 1) > 0.05:
        raise AssertionError('card and host RMSEs differ by more than 5 %')


def run_neural(device, insite_eq4d_one_step, methods, tag):
    """Phases 9 and 10: ``methods`` on EQ_4_D and cancer_sim through the
    port's sweep on the card (seed 0, 1,000 / 100 / 100, `NEURAL_EPOCHS`,
    f32, the JAX package's config defaults: full width): a row each, none
    errored, with the JAX package's keys in its order, no kernel launch,
    every RMSE inside `NEURAL_BANDS` around `NEURAL_REF`, and on EQ_4_D
    each above phase 5's insite at 1 step. Returns the launches by
    method."""
    epochs = {m: NEURAL_EPOCHS[m] for m in methods}
    log(f'[{tag}] sweep: {", ".join(methods)} x '
        f'{", ".join(NEURAL_DATASETS)}, seed 0, 1000/100/100, epochs '
        f'{epochs} (the JAX package trains 100; crn, rmsn and edct cut to '
        f'{NEURAL_E} to keep the script within its time limit)')
    rows, records, launches = run_sweep(
        device, NEURAL_DATASETS, tag, methods,
        model_overrides={m: {'epochs': e} for m, e in epochs.items()})
    if launches != {'rollout': 0, 'sens': 0}:
        raise AssertionError(f'the neural rows launched kernels: {launches}')
    for row in rows:
        ds, method = row['dataset_name'], row['method_name']
        keys = list(NEURAL_ROW_KEYS)
        if method == 'rmsn':
            keys.insert(keys.index('method'), 'sw_mode')
        if list(row) != keys:
            raise AssertionError(f'{ds} {method} row keys {list(row)}')
        for i, (metric, ref) in enumerate(zip(RMSE_METRICS,
                                              NEURAL_REF[ds, method])):
            got = row[metric]
            lo, hi = (f * ref for f in NEURAL_BANDS[method][min(i, 1)])
            log(f'  {ds} {method} {metric}: card {got:.6f} % vs JAX '
                f'{ref:.6f} % (x{got / ref:.3f}); band ({lo:.6f}, {hi:.6f})')
            if not lo < got < hi:
                raise AssertionError(f'{ds} {method} {metric} = {got} is not '
                                     f'in ({lo}, {hi})')
    by = {(r['dataset_name'], r['method_name']): r for r in rows}
    for method in methods:
        got = by['EQ_4_D', method]['encoder_test_rmse_orig']
        if not got > insite_eq4d_one_step:
            raise AssertionError(f'EQ_4_D {method} 1-step {got} is not above '
                                 f'insite\'s {insite_eq4d_one_step}')
    by_method = {m: {'rollout': 0, 'sens': 0} for m in methods}
    for row, rec in zip(rows, records):
        for k, n in rec['launches'].items():
            by_method[row['method_name']][k] += n
    return by_method


# card against host (`check_neural_card_against_host`): by method, the
# model-config fields that turn dropout off and make every stage one batch
# an epoch on a 200-patient cohort
NEURAL_ONE_BATCH = {
    'ct': {'dropout_rate': 0.0, 'batch_size': 256},
    'crn': {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0,
            'enc_batch_size': 256, 'dec_batch_size': 1 << 15},
    'rmsn': {'prop_treat_dropout': 0.0, 'prop_hist_dropout': 0.0,
             'enc_dropout': 0.0, 'dec_dropout': 0.0, 'prop_treat_bs': 256,
             'prop_hist_bs': 256, 'enc_bs': 256, 'dec_bs': 1 << 15},
    'gnet': {'dropout_rate': 0.0, 'batch_size': 256},
    'edct': {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0,
             'enc_batch_size': 256, 'dec_batch_size': 1 << 15}}


def neural_networks(model):
    """A neural model's networks, in the order they train."""
    if hasattr(model, 'prop_treat'):                        # rmsn
        return [getattr(model, k).net for k in ('prop_treat', 'prop_hist',
                                                'encoder', 'decoder')]
    if hasattr(model, 'encoder'):                           # crn, edct
        return [model.encoder.net, model.decoder.net]
    return [model.net]                                      # ct, gnet


def check_neural_card_against_host(device, methods, base=None,
                                   overrides=None):
    """``methods`` f32 on the card against f32 on the host, on one EQ_4_D
    collection (200 / 10 / 10, or ``base``), each built by the runner: the
    same initial weights (one seed builds them on the host, whatever the
    device; checked bitwise), dropout 0, one batch per epoch in every stage
    (the shuffle then only reorders a sum; `NEURAL_ONE_BATCH`, updated by
    ``overrides``), 3 epochs; the 1-step predictions (crn, edct: the
    encoder's; rmsn: its encoder's) and the n-step ones (decoders on rows
    started from each side's own encoder; gnet: the Monte-Carlo rollouts
    with the residual noise of each side's own holdout fit, drawn by numpy
    alike) within `NEURAL_CARD_RTOL`."""
    import copy

    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.harness.config import RunConfig
    if base is None:
        base = make_collection('EQ_4_D', {'train': 200, 'val': 10,
                                          'test': 10}, seed=7, coeff=2.0,
                               device=device, treatment_mode='multilabel')
    for method in methods:
        fields = {**NEURAL_ONE_BATCH[method],
                  **(overrides or {}).get(method, {})}
        cfg = RunConfig(epochs=3, model_overrides={method: fields})
        models = {}
        for tag, dev in (('host', torch.device('cpu')), ('card', device)):
            coll = copy.deepcopy(base)
            model = runner._build_model(method, 'EQ_4_D', coll, cfg,
                                        device=dev)
            models[tag] = (model, coll, neural_networks(model))
        for card_net, host_net in zip(models['card'][2], models['host'][2]):
            for k, v in host_net.state_dict().items():
                if not torch.equal(card_net.state_dict()[k].cpu(), v):
                    raise AssertionError(f'{method} initial {k} differs')
        preds = {}
        for tag, (model, coll, _) in models.items():
            model.fit(coll.train_f)
            n_step = (coll.test_cf_treatment_seq_mc if method == 'gnet' else
                      coll.test_cf_treatment_seq)
            preds[tag] = (model.get_predictions(coll.test_cf_one_step),
                          model.get_autoregressive_predictions(n_step))
        for what, got, want in zip(('1-step', 'n-step'), preds['card'],
                                   preds['host']):
            rel = float(np.max(np.abs(got - want) /
                               np.maximum(np.abs(want), 1e-3)))
            log(f'  {method} {what} predictions {got.shape}, card f32 vs host '
                f'f32: max abs diff {np.abs(got - want).max():.3e}, largest '
                f'relative gap {rel:.3e}')
            np.testing.assert_allclose(got, want, rtol=NEURAL_CARD_RTOL,
                                       atol=1e-5, err_msg=f'{method} {what}')


def neural_idle_share(path='fit', tag='neural'):
    """The device's idle share during one epoch of a fit from
    torch.profiler, in a process of its own (a second profiler run in
    this process would see no kernel events): ``path`` 'fit', one crn fit
    (EQ_4_D, 1,000 patients: 15 encoder and ~103 decoder batches), or
    'column-fit', the stacked crn encoder fit of a 10-seed column (15
    batches of 64 rows a seed)."""
    from pathlib import Path
    tool = Path(__file__).resolve().parent / 'tools' / \
        'profile_torch_northstar.py'
    out = subprocess.run([sys.executable, str(tool), '--path', path,
                          '--epochs', '1'],
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    log(f'[{tag}] ' + out.strip().replace('\n', f'\n[{tag}] '))
    m = re.search(r'device busy .* idle ([0-9.]+) %', out)
    if m is None:
        raise AssertionError(f'the profile of the {path} gave no idle share')
    return float(m.group(1))


def run_vectorized(device, table_rows, keep_log=None):
    """Phase 11: the port's `vectorized_sweep` (``run.py --vectorized``)
    on the card, `VECTORIZED_SEEDS` seeds, 1,000 / 100 / 100, f32, debug
    mode, one call a column (the confounding call: a column per gamma).
    Asserts per call: a row per seed with the JAX package's keys in its
    order, none errored; the kernel launches exactly
    (`VECTORIZED_LAUNCHES` a column); each column's 10-seed mean inside
    `VECTORIZED_BANDS` around `VECTORIZED_REF` at 1 and at 2..6 steps.
    Seed 0 of EQ_4_D sindy and insite is phase 5's cohort: its 1-step RMSE
    within `VECTORIZED_SEED0_RTOL` of phase 5's row. Prints each call's
    wall time and peak device memory; the log is copied to ``keep_log``
    where given. Returns the launches of all calls and by column, and
    each column's 10-seed 1-step mean."""
    import torch
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.harness.logging_utils import (
        create_logger_in_process, generate_log_file_path)
    from insite_tpu_torch.harness.runner import vectorized_sweep
    from insite_tpu_torch.ops import rollout
    total = {'rollout': 0, 'sens': 0}
    by_column, one_step_means = {}, {}
    phase5 = {r['method_name']: r for r in table_rows
              if r['dataset_name'] == 'EQ_4_D'}
    with tempfile.TemporaryDirectory() as log_dir:
        log_path = generate_log_file_path('vectorized', log_dir)
        logger = create_logger_in_process(log_path)
        for experiment, ds, method, keys in VECTORIZED_CALLS:
            settings = {}
            if experiment == 'INSIGHT_CONFOUNDING':
                settings['domain_confs'] = VECTORIZED_CONFOUNDING_GAMMAS
            cfg = RunConfig(methods=(method,), datasets=(ds,),
                            experiment=experiment,
                            seed_runs=VECTORIZED_SEEDS, debug_mode=True,
                            log_dir=log_dir, **settings)
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            rollout.reset_launch_counts()
            t0 = perf_counter()
            rows, _ = vectorized_sweep(cfg, log=logger, device=device)
            torch.cuda.synchronize(device)
            wall = perf_counter() - t0
            launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                        'sens': rollout.SENS_LAUNCHES}
            peak = torch.cuda.max_memory_allocated(device) / 2**20
            tag = ' + '.join(keys)
            by_column[tag] = launches
            for k in total:
                total[k] += launches[k]
            log(f'[vectorized] {tag}: {len(rows)} rows, wall {wall:.4f} s, '
                f'peak device memory {peak:.1f} MiB, kernel launches '
                f'{launches}')
            n_rows = VECTORIZED_SEEDS * len(keys)
            if len(rows) != n_rows or any(r['errored'] for r in rows):
                raise AssertionError(f'{tag}: expected {n_rows} rows, none '
                                     f'errored: {rows}')
            for row in rows:
                if list(row) != VECTORIZED_ROW_KEYS or \
                        row['vectorized'] is not True:
                    raise AssertionError(f'{tag} row keys {list(row)}')
            roll, sens = VECTORIZED_LAUNCHES[method]
            if experiment == 'INSIGHT_CONFOUNDING':
                roll += 1                # the 1-step plan rows' rollout
            want = {'rollout': roll * len(keys), 'sens': sens * len(keys)}
            if launches != want:
                raise AssertionError(f'{tag}: expected {want} launches, got '
                                     f'{launches}')
            for i, key in enumerate(keys):
                col = rows[i * VECTORIZED_SEEDS:(i + 1) * VECTORIZED_SEEDS]
                for j, metric in enumerate(RMSE_METRICS):
                    mean = float(np.mean([r[metric] for r in col]))
                    ref = VECTORIZED_REF[key][j]
                    lo, hi = (f * ref for f in
                              VECTORIZED_BANDS[key][min(j, 1)])
                    log(f'  {key} {metric}: {VECTORIZED_SEEDS}-seed mean '
                        f'{mean:.6f} % vs JAX {ref:.6f} % (x{mean / ref:.3f});'
                        f' band ({lo:.6f}, {hi:.6f})')
                    if not lo < mean < hi:
                        raise AssertionError(f'{key} {metric} mean {mean} is '
                                             f'not in ({lo}, {hi})')
                    if j == 0:
                        one_step_means[key] = mean
            if experiment == 'MAIN_TABLE' and ds == 'EQ_4_D' and \
                    method in phase5:
                got = rows[0]['encoder_test_rmse_orig']
                want = phase5[method]['encoder_test_rmse_orig']
                gap = got / want - 1
                log(f'  EQ_4_D {method} seed 0: vectorized 1-step '
                    f'{got:.6f} % vs phase 5 {want:.6f} % on the same cohort '
                    f'({100 * gap:+.2f} %)')
                if abs(gap) > VECTORIZED_SEED0_RTOL:
                    raise AssertionError(f'EQ_4_D {method} seed 0: {got} is '
                                         f'not within rtol '
                                         f'{VECTORIZED_SEED0_RTOL} of {want}')
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        if keep_log:
            shutil.copyfile(log_path, keep_log)
    log(f'[vectorized] kernel launches of all columns: {total}')
    return total, by_column, one_step_means


def check_vectorized_card_against_host(device):
    """One small insite column (EQ_4_D, 2 seeds, 200 / 10) on the card in
    f32 against the same cohorts on the host in f64: the same supports,
    coefficients within rtol 1e-3, RMSEs within 5 %."""
    import torch
    from insite_tpu_torch.harness import vectorized
    cohorts = [vectorized.eq4_cohort(s, 'EQ_4_D', 200, 10, 60, 2.0, 5,
                                     device=device) for s in (0, 1)]
    host = [{k: tuple(None if x is None else
                      (x.cpu().double() if x.is_floating_point() else x.cpu())
                      for x in v) for k, v in c.items()} for c in cohorts]
    kw = dict(family='eq4', method='insite', threshold=0.1, alpha=0.5,
              lam=10.0, projection_horizon=5)
    card = vectorized.column(cohorts, **kw)
    ref = vectorized.column(host, **kw)
    c_k, c_h = card['global_coefs'], ref['global_coefs']
    rel = np.abs(c_k - c_h) / np.maximum(np.abs(c_h), 1e-12)
    gaps = {m: float(np.max(np.abs(card[m] / ref[m] - 1)))
            for m in RMSE_METRICS}
    worst = max(gaps, key=gaps.get)
    log(f'  EQ_4_D insite column, 2 seeds, 200 training patients, card f32 '
        f'vs host f64: coef max rel diff {rel[np.abs(c_h) > 1e-3].max():.3e}; '
        f'largest RMSE gap {gaps[worst]:.3e} ({worst})')
    if not ((np.abs(c_k) > 1e-3) == (np.abs(c_h) > 1e-3)).all():
        raise AssertionError(f'supports differ: {c_k} vs {c_h}')
    np.testing.assert_allclose(c_k, c_h, rtol=1e-3, atol=1e-6)
    if max(gaps.values()) > 0.05:
        raise AssertionError('card and host RMSEs differ by more than 5 %')


def run_vectorized_neural(device, insite_eq4d_column_mean):
    """Phase 12: the neural methods' `vectorized_sweep` columns on the card
    (`VEC_NEURAL_COLUMNS`, `VECTORIZED_SEEDS` seeds, 1,000 / 100 / 100,
    f32, `VEC_NEURAL_EPOCHS`, debug mode), one call a column. Asserts per
    column: a row per seed with the JAX package's keys in its order (rmsn
    rows with ``sw_mode`` last), none errored, every RMSE finite; no kernel
    launch; the 10-seed mean at 1 step and at each of 2..6 steps inside
    `VECTORIZED_NEURAL_BANDS` around `VECTORIZED_NEURAL_REF`; on EQ_4_D
    the 1-step mean above phase 11's insite column mean; the peak device
    memory within `VEC_NEURAL_PEAK_MIB`. Prints each column's wall time
    and peak. Returns the launches by method."""
    import torch
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.harness.logging_utils import (
        create_logger_in_process, generate_log_file_path)
    from insite_tpu_torch.harness.runner import vectorized_sweep
    from insite_tpu_torch.ops import rollout
    log(f'[vectorized-neural] epochs {VEC_NEURAL_EPOCHS} (the JAX package '
        f'trains 100; cut to keep the script within its time limit)')
    by_method = {}
    with tempfile.TemporaryDirectory() as log_dir:
        logger = create_logger_in_process(
            generate_log_file_path('vectorized-neural', log_dir))
        for ds, method in VEC_NEURAL_COLUMNS:
            key = f'{ds} {method}'
            cfg = RunConfig(methods=(method,), datasets=(ds,),
                            seed_runs=VECTORIZED_SEEDS,
                            epochs=VEC_NEURAL_EPOCHS[method],
                            debug_mode=True, log_dir=log_dir)
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            rollout.reset_launch_counts()
            t0 = perf_counter()
            rows, _ = vectorized_sweep(cfg, log=logger, device=device)
            torch.cuda.synchronize(device)
            wall = perf_counter() - t0
            launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                        'sens': rollout.SENS_LAUNCHES}
            peak = torch.cuda.max_memory_allocated(device) / 2**20
            for k, n in launches.items():
                by_method.setdefault(method, {'rollout': 0, 'sens': 0})
                by_method[method][k] += n
            log(f'[vectorized-neural] {key}: {len(rows)} rows, epochs '
                f'{VEC_NEURAL_EPOCHS[method]}, wall {wall:.4f} s, peak device '
                f'memory {peak:.1f} MiB, kernel launches {launches}')
            if launches != {'rollout': 0, 'sens': 0}:
                raise AssertionError(f'{key} launched kernels: {launches}')
            if peak > VEC_NEURAL_PEAK_MIB:
                raise AssertionError(f'{key} peaked at {peak:.1f} MiB')
            keys = VECTORIZED_ROW_KEYS + (['sw_mode'] if method == 'rmsn'
                                          else [])
            if len(rows) != VECTORIZED_SEEDS or any(
                    r['errored'] or list(r) != keys for r in rows):
                raise AssertionError(f'{key}: expected {VECTORIZED_SEEDS} '
                                     f'rows with keys {keys}: {rows}')
            for j, metric in enumerate(RMSE_METRICS):
                values = [r[metric] for r in rows]
                if not np.isfinite(values).all():
                    raise AssertionError(f'{key} {metric}: {values}')
                mean = float(np.mean(values))
                ref = VECTORIZED_NEURAL_REF[key][j]
                lo, hi = (f * ref for f in
                          VECTORIZED_NEURAL_BANDS[key][min(j, 1)])
                log(f'  {key} {metric}: {VECTORIZED_SEEDS}-seed mean '
                    f'{mean:.6f} % vs JAX {ref:.6f} % (x{mean / ref:.3f}); '
                    f'band ({lo:.6f}, {hi:.6f})')
                if not lo < mean < hi:
                    raise AssertionError(f'{key} {metric} mean {mean} is not '
                                         f'in ({lo}, {hi})')
            one = float(np.mean([r['encoder_test_rmse_orig'] for r in rows]))
            if ds == 'EQ_4_D' and not one > insite_eq4d_column_mean:
                raise AssertionError(f'{key} 1-step mean {one} is not above '
                                     f'the insite column\'s '
                                     f'{insite_eq4d_column_mean}')
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    return by_method


def check_vectorized_neural_card_against_host(device):
    """For each neural method, one 2-seed column (EQ_4_D, 200 / 10 / 10, 3
    epochs, dropout 0, one batch an epoch in every stage:
    `NEURAL_ONE_BATCH`; gnet with 2 Monte-Carlo samples, which keeps the
    host's rollouts short) f32 on the card against f32 on the host, on the
    same cohorts (simulated once on the card, a copy for each side) and
    from bitwise-equal initial weights (each seed's from the seed, built
    on the host whatever the device; checked per stage): every seed's
    RMSEs within `NEURAL_CARD_RTOL`. Prints each side's seconds."""
    import copy

    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness import vectorized_neural as vn
    cohorts = {seed: make_collection(
        'EQ_4_D', {'train': 200, 'val': 10, 'test': 10}, seed, coeff=2.0,
        device=device, treatment_mode='multilabel') for seed in (0, 1)}
    make, initial_stack = vn.make_collection, vn._initial_stack
    try:
        vn.make_collection = (lambda name, num, seed, **kw:
                              copy.deepcopy(cohorts[seed]))
        for method in ('ct', 'crn', 'edct', 'rmsn', 'gnet'):
            results, inits, secs = {}, {}, {}
            for tag, dev in (('card', device), ('host', torch.device('cpu'))):
                inits[tag] = []

                def record(build, seeds, device_, tag=tag):
                    base, params = initial_stack(build, seeds, device_)
                    inits[tag].append({k: p.detach().cpu().clone()
                                       for k, p in params.items()})
                    return base, params

                vn._initial_stack = record
                kw = dict(n_seeds=2, num_patients={'train': 200, 'val': 10,
                                                   'test': 10},
                          epochs=3, model_overrides=NEURAL_ONE_BATCH[method],
                          device=dev)
                t0 = perf_counter()
                if method == 'ct':
                    r = vn.vectorized_ct_sweep('EQ_4_D', **kw)
                elif method in ('crn', 'edct'):
                    r = vn.vectorized_enc_dec_sweep(method, 'EQ_4_D', **kw)
                elif method == 'rmsn':
                    r = vn.vectorized_rmsn_sweep('EQ_4_D', **kw)
                else:
                    r = vn.vectorized_gnet_sweep('EQ_4_D', mc_samples=2,
                                                 **kw)
                if dev.type == 'cuda':
                    torch.cuda.synchronize(dev)
                secs[tag] = perf_counter() - t0
                results[tag] = r
            for card, host in zip(inits['card'], inits['host']):
                for k in host:
                    if not torch.equal(card[k], host[k]):
                        raise AssertionError(f'{method} initial {k} differs')
            gap = max(float(np.max(np.abs(results['card'][m] /
                                          results['host'][m] - 1)))
                      for m in results['host'])
            log(f'  {method} 2-seed column, card f32 vs host f32: '
                f'{len(inits["card"])} stages from equal initial weights; '
                f'largest relative RMSE gap {gap:.3e}; card '
                f'{secs["card"]:.2f} s, host {secs["host"]:.2f} s')
            for m in results['host']:
                np.testing.assert_allclose(results['card'][m],
                                           results['host'][m],
                                           rtol=NEURAL_CARD_RTOL,
                                           err_msg=f'{method} {m}')
    finally:
        vn.make_collection, vn._initial_stack = make, initial_stack


# ---------------------------------------------------------------------------
# phase 13: the sweep harness


def tuning_case(device):
    """Kernel inputs at the shape of a lam tune's launches: the validation
    cohort of the EQ_4_D fit (100 patients) stacked once per value of
    `INSITE_LAM_GRID` (B = 700), per-row coefficients 5 % around the
    fit's, its support."""
    from insite_tpu_torch.harness.tuning import INSITE_LAM_GRID
    coll, model = fitted_model('EQ_4_D', device)
    case = model_case(model, coll.val_f)
    G = len(INSITE_LAM_GRID)
    B = G * len(case['y0'])
    rng = np.random.RandomState(16)
    case.update(y0=np.tile(case['y0'], G),
                statics=np.tile(case['statics'], (G, 1)),
                arms=np.tile(case['arms'], (G, 1)),
                coefs=case['coefs'] * (1 + 0.05 * rng.randn(
                    B, *case['coefs'].shape[1:])))
    assert case['arms'].shape[0] == TUNING_ROWS
    log(f'  tuning case: B={B}, T={case["arms"].shape[1]}, '
        f'Kr={len(case["active_idx"])}')
    return case


@contextlib.contextmanager
def patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def recording(calls):
    """A wrap for `patched` that appends the first three positional
    arguments of every call (a run's dataset, method and seed)."""
    def wrap(fn):
        def call(*args, **kwargs):
            calls.append(args[:3])
            return fn(*args, **kwargs)
        return call
    return wrap


def check_tune_card_against_host(device):
    """`tune_insite_lam` f32 on the card against f64 on the host, each on a
    model fitted on one EQ_4_D collection (200 / 100 / 10): all seven
    scores within rtol `TUNE_SCORE_RTOL`, the same best lam wherever the
    best two scores differ by more than that, relative. Returns the card
    call's launches (asserted: one fine-tune)."""
    import dataclasses

    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import sindy_params_for
    from insite_tpu_torch.harness.tuning import tune_insite_lam
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    from insite_tpu_torch.ops import rollout
    coll = make_collection('EQ_4_D', {'train': 200, 'val': 100, 'test': 10},
                           seed=7, coeff=2.0, device=device)
    cfg = SINDyConfig(dataset_name='EQ_4_D',
                      sindy_threshold=sindy_params_for('EQ_4_D')[0],
                      insite=True)
    out = {}
    for tag, dev, dtype in (('card', device, None),
                            ('host', 'cpu', torch.float64)):
        m = SINDyRegressor(dataclasses.replace(cfg), coll, device=dev,
                           dtype=dtype).fit(coll.train_f)
        rollout.reset_launch_counts()
        t0 = perf_counter()
        best, scores = tune_insite_lam(m, coll.val_f)
        secs = perf_counter() - t0
        out[tag] = (best, scores, {'rollout': rollout.ROLLOUT_LAUNCHES,
                                   'sens': rollout.SENS_LAUNCHES}, secs)
    (best_k, s_k, n_k, t_k), (best_h, s_h, _, t_h) = out['card'], out['host']
    gap = max(abs(s_k[lam] / s_h[lam] - 1) for lam in s_h)
    log(f'  lam tune card f32 vs host f64 (100 validation patients): best '
        f'{best_k} vs {best_h}; largest relative score gap {gap:.3e}; '
        f'card {t_k:.4f} s ({n_k}), host {t_h:.4f} s; card scores {s_k}')
    if n_k != {'rollout': 1, 'sens': GN_ITERS + 1}:
        raise AssertionError(f'one tune launched {n_k}, expected 1 rollout '
                             f'and {GN_ITERS + 1} sensitivity launches')
    if gap > TUNE_SCORE_RTOL:
        raise AssertionError(f'card and host lam scores differ by {gap:.3e}')
    first, second = sorted(s_h.values())[:2]
    if second / first - 1 > TUNE_SCORE_RTOL and best_k != best_h:
        raise AssertionError(f'best lam {best_k} on the card, {best_h} on '
                             'the host')
    return n_k


def run_harness(device):
    """Phase 13: the sweep harness on the card at the reference size
    (1,000 / 100 / 100, f32), every run writing its JSONL records into a
    temporary sink: the lam tune in an insite run and card against host,
    the neural grid and successive-halving searches, the dataset cache,
    resume, isolated runs and columns. Returns (the tuned run's launches,
    one tuning call's launches, the phase's wall by step)."""
    import dataclasses
    import logging

    import torch
    from insite_tpu_torch.harness import cache, isolated, runner, tuning
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.ops import build, rollout

    def launches():
        return {'rollout': rollout.ROLLOUT_LAUNCHES,
                'sens': rollout.SENS_LAUNCHES}

    walls = {}
    runs = 0                 # runs that write the sink: 2 records each

    def step(name, t0):
        torch.cuda.synchronize(device)
        walls[name] = perf_counter() - t0
        log(f'[harness] {name}: {walls[name]:.4f} s')

    with tempfile.TemporaryDirectory() as tmp:
        sink = f'{tmp}/metrics.jsonl'
        base = RunConfig(metrics_jsonl=sink)

        # 1. insite with the lam tune; then one tune card against host
        t0 = perf_counter()
        rollout.reset_launch_counts()
        row = runner.run_experiment(
            'EQ_4_D', 'insite', 0, 2.0,
            dataclasses.replace(base, tune_hparams=True), device=device)
        tuned = launches()
        runs += 1
        step('insite EQ_4_D run with --tune', t0)
        log(f'  tuned_lam {row["tuned_lam"]}; 1-step '
            f'{row["encoder_test_rmse_orig"]:.6f} %, 6-step '
            f'{row["decoder_test_rmse_6-step"]:.6f} %; launches {tuned}')
        if list(row)[:2] != ['tuned_lam', 'encoder_test_rmse_all'] or \
                row['tuned_lam'] not in tuning.INSITE_LAM_GRID:
            raise AssertionError(f'the tuned row starts {list(row)[:2]}')
        want = {'rollout': 3, 'sens': 3 * (GN_ITERS + 1)}
        if tuned != want:
            raise AssertionError(f'tuned insite run launched {tuned}, '
                                 f'expected {want}')
        t0 = perf_counter()
        tune_call = check_tune_card_against_host(device)
        step('lam tune card vs host', t0)

        # 2. the neural tuners on ct
        for algo, trials, epochs, rungs in (('grid', 2, 2, None),
                                            ('sha', 3, 3, [(0, 1)] * 3
                                             + [(1, 3)])):
            t0 = perf_counter()
            searches = []

            def keep_trials(fn):
                def search(*args, **kwargs):
                    out = fn(*args, **kwargs)
                    searches.append(out[2])
                    return out
                return search

            rollout.reset_launch_counts()
            name = ('successive_halving_search' if algo == 'sha'
                    else 'grid_search')
            with patched(tuning, name, keep_trials):
                row = runner.run_experiment(
                    'EQ_4_D', 'ct', 0, 2.0,
                    dataclasses.replace(base, tune_hparams=True,
                                        tune_algo=algo, tune_trials=trials,
                                        epochs=epochs), device=device)
            runs += 1
            step(f'ct --tune-algo {algo}', t0)
            (trial_list,) = searches
            hp = row['tuned_hparams']
            log(f'  {algo}: {len(trial_list)} trials, tuned_hparams {hp}; '
                f'1-step {row["encoder_test_rmse_orig"]:.6f} %')
            space = tuning.NEURAL_HPARAM_GRIDS['ct']
            if list(row)[0] != 'tuned_hparams' or set(hp) != set(space) or \
                    any(v not in space[k] for k, v in hp.items()):
                raise AssertionError(f'tuned_hparams {hp} not of the grid')
            if launches() != {'rollout': 0, 'sens': 0}:
                raise AssertionError(f'ct tune launched {launches()}')
            vals = [t['val_rmse_all'] for t in trial_list] + \
                [row[k] for k in RMSE_METRICS]
            if not np.isfinite(vals).all():
                raise AssertionError(f'non-finite RMSEs: {vals}')
            got = ([(t['rung'], t['epochs']) for t in trial_list]
                   if rungs else len(trial_list))
            if got != (rungs or trials):
                raise AssertionError(f'{algo} trials {got}')

        # 3. the dataset cache
        t0 = perf_counter()
        made = []
        cfg = dataclasses.replace(base, load_from_cache=True)
        cache_dir = cache.CACHE_DIR
        cache.CACHE_DIR = f'{tmp}/cache'
        try:
            with patched(runner, 'make_collection', recording(made)):
                rows = [runner.run_experiment('EQ_4_D', 'sindy', 0, 2.0, cfg,
                                              device=device)
                        for _ in range(2)]
        finally:
            cache.CACHE_DIR = cache_dir
        runs += 2
        step('sindy EQ_4_D twice from the cache', t0)
        timeless = [{k: v for k, v in r.items() if k != 'seconds_taken'}
                    for r in rows]
        log(f'  collections simulated {len(made)}; seconds '
            f'{[round(r["seconds_taken"], 4) for r in rows]}')
        if len(made) != 1 or timeless[0] != timeless[1]:
            raise AssertionError('the cached run simulated again or its '
                                 'row differs')

        # 4. resume
        t0 = perf_counter()
        log_path = f'{tmp}/resume.txt'
        sweep_log = logging.getLogger('chip_smoke.resume')
        sweep_log.propagate = False
        sweep_log.setLevel(logging.INFO)
        handler = logging.FileHandler(log_path)
        sweep_log.addHandler(handler)
        cfg = dataclasses.replace(base, methods=('sindy', 'insite'),
                                  datasets=('EQ_4_A',), seed_runs=1)
        executed = []
        try:
            first, _ = runner.sweep(cfg, log=sweep_log, device=device)
            with patched(runner, 'run_experiment', recording(executed)):
                resumed, _ = runner.sweep(
                    dataclasses.replace(cfg, seed_runs=2,
                                        resume_log=log_path),
                    log=sweep_log, device=device)
                n_resumed = len(executed)
                other, _ = runner.sweep(
                    dataclasses.replace(cfg, seed_runs=2, epochs=7,
                                        resume_log=log_path),
                    log=sweep_log, device=device)
        finally:
            sweep_log.removeHandler(handler)
            handler.close()
        runs += 2 + len(executed)
        step('resume: 1 seed, 2 seeds resumed, other epochs', t0)
        log(f'  resumed sweep ran {executed[:n_resumed]}; the sweep under '
            f'other epochs ran {len(executed) - n_resumed} runs')
        if executed[:n_resumed] != [('EQ_4_A', 'sindy', 1),
                                    ('EQ_4_A', 'insite', 1)] or \
                resumed[:2] != first or len(executed) - n_resumed != 4 or \
                len(other) != 4:
            raise AssertionError('resume reused or ran the wrong runs')

        # 5. isolation: the children load the library built above
        t0 = perf_counter()
        lib = build.build_dir() / 'libinsite_kernels.so'
        built = lib.stat().st_mtime_ns
        iso = isolated.run_isolated('EQ_4_D', 'insite', 0, 2.0, base,
                                    runner.Experiment.MAIN_TABLE,
                                    device=device)
        ref = runner.run_experiment('EQ_4_D', 'insite', 0, 2.0, base,
                                    device=device)
        runs += 2
        gap = max(abs(iso[k] / ref[k] - 1) for k in RMSE_METRICS)
        log(f'  isolated insite row vs in-process: largest relative RMSE '
            f'gap {gap:.3e}; seconds {iso["seconds_taken"]:.4f} vs '
            f'{ref["seconds_taken"]:.4f}')
        if list(iso) != list(ref) or gap > 1e-6 or \
                iso['global_equation_string'] != ref['global_equation_string']:
            raise AssertionError('the isolated row differs')
        r, seeds = isolated.run_isolated_column(
            'EQ_4_D', 'insite', dataclasses.replace(base, seed_runs=2),
            device=device)
        log(f'  isolated 2-seed insite column: seeds {seeds}, 1-step '
            f'{r["encoder_test_rmse_orig"]}')
        if seeds != [0, 1] or not all(np.isfinite(v).all() and len(v) == 2
                                      for v in r.values()):
            raise AssertionError('the isolated column is not 2 finite rows')
        try:
            isolated.run_isolated('NO_SUCH_DATASET', 'sindy', 0, 2.0, base,
                                  runner.Experiment.MAIN_TABLE,
                                  device=device)
        except RuntimeError as e:
            if 'isolated run' not in str(e):
                raise
        else:
            raise AssertionError('an isolated run on a bad dataset did not '
                                 'raise')
        if lib.stat().st_mtime_ns != built:
            raise AssertionError('an isolated child rebuilt the kernels')
        step('isolation: a run, a column, a failing run', t0)

        # 6. the metrics sink
        with open(sink) as f:
            recs = [json.loads(line) for line in f]
        log(f'  metrics sink: {len(recs)} records of {runs} runs')
        if len(recs) != 2 * runs or [r['kind'] for r in recs] != \
                ['params', 'metrics'] * runs:
            raise AssertionError(f'{len(recs)} sink records for {runs} runs')
    return tuned, tune_call, walls

# ---------------------------------------------------------------------------
# phase 14: the real-data path


def add_vitals(ds, seed):
    """A fabricated vitals stream for a processed dataset, as the JAX
    package's tests make it (`tests/test_vitals.py::_add_vitals`): a lagged
    function of the outcome plus noise from ``RandomState(seed)``, masked by
    activity, `REAL_DIM_VITALS` wide; ``next_vitals`` one step shorter."""
    rng = np.random.RandomState(seed)
    po = ds.data['prev_outputs']
    n, T, _ = po.shape
    base = np.concatenate([0.5 * po, -0.25 * po + 0.1], axis=-1)
    vit = (base + 0.05 * rng.randn(n, T, REAL_DIM_VITALS)) * \
        ds.data['active_entries']
    ds.data['vitals'] = vit
    ds.data['next_vitals'] = vit[:, 1:]
    return ds


def real_collection(device, num_patients, seed=0):
    """A `RealDatasetCollection` with a vitals stream: an EQ_4_D cohort
    (gamma 2, multilabel, seq 60) simulated on ``device`` and processed,
    its train and val sets and a copy of its val set as test_f, each with
    fabricated vitals (no data file)."""
    import copy

    from insite_tpu_torch.data.collection import (PkpdDatasetCollection,
                                                  RealDatasetCollection)
    coll = PkpdDatasetCollection(2.0, dict(num_patients), 'EQ_4_D', seed,
                                 treatment_mode='multilabel', device=device)
    coll.process_data_encoder()
    return RealDatasetCollection(
        add_vitals(coll.train_f, 0), add_vitals(coll.val_f, 1),
        add_vitals(copy.deepcopy(coll.val_f), 2), projection_horizon=5,
        treatment_mode='multilabel', seed=seed)


def zeroed_vitals(ds):
    import copy
    out = copy.deepcopy(ds)
    out.data['vitals'] = np.zeros_like(out.data['vitals'])
    return out


def check_attention_maps(name, maps, rows, heads, T):
    """Each map [rows, heads, T, T], every row summing to 1 within
    `ATTENTION_ROW_ATOL`; logs the largest gap."""
    if not maps:
        raise AssertionError(f'{name}: no attention map')
    worst = 0.0
    for path, m in maps.items():
        if m.shape != (rows, heads, T, T):
            raise AssertionError(f'{name} {path}: map {m.shape}, expected '
                                 f'{(rows, heads, T, T)}')
        gap = float(np.max(np.abs(m.sum(-1) - 1.0)))
        if not gap <= ATTENTION_ROW_ATOL:
            raise AssertionError(f'{name} {path}: rows sum to 1 within '
                                 f'{gap}')
        worst = max(worst, gap)
    log(f'  {name}: {len(maps)} maps {m.shape}, rows sum to 1 within '
        f'{worst:.3e} (limit {ATTENTION_ROW_ATOL}): {sorted(maps)}')


def run_real_data(device):
    """Phase 14: ct, crn, rmsn, gnet and edct on a full-width
    `RealDatasetCollection` with a vitals stream on the card, through
    their normal API; card against host on a small one; attention maps;
    a checkpoint round trip of each of the seven families. Returns (the
    fits' launches, the reloaded insite model's launches on its predict
    call, the wall of each step)."""
    import copy
    import torch
    from insite_tpu_torch.harness import checkpoint, runner
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.ops import rollout
    walls = {}

    def step(name, t0):
        torch.cuda.synchronize(device)
        walls[name] = perf_counter() - t0
        log(f'[real] {name}: {walls[name]:.4f} s')

    t0 = perf_counter()
    base = real_collection(device, REAL_SIZES)
    T = base.train_f.data['outputs'].shape[1]
    log(f'[real] RealDatasetCollection {REAL_SIZES}, seq {T + 1}, vitals '
        f'{REAL_DIM_VITALS} wide; has_vitals={base.has_vitals}')
    step('collection', t0)
    # the attention maps' rows: the first of the exploded factual test
    # trajectories (vitals and all steps)
    exploded = copy.deepcopy(base.test_f)
    exploded.explode_trajectories(base.projection_horizon)
    maps_rows = types.SimpleNamespace(data={
        k: v[:ATTENTION_ROWS] for k, v in exploded.data.items()})

    cfg = RunConfig(epochs=REAL_EPOCHS)
    fitted = {}
    rollout.reset_launch_counts()
    for method in REAL_METHODS:
        t0 = perf_counter()
        coll = copy.deepcopy(base)
        model = runner._build_model(method, 'EQ_4_D', coll, cfg,
                                    device=device)
        model.fit(coll.train_f, coll.val_f)
        one = model.get_normalised_masked_rmse(coll.test_cf_one_step)
        n_step = model.get_normalised_n_step_rmses(
            coll.test_cf_treatment_seq)
        rmses = np.array(list(one) + list(n_step), np.float64)
        log(f'  {method}: 1-step (orig, all) {one}, 2..6-step {n_step}')
        if not np.isfinite(rmses).all():
            raise AssertionError(f'{method} on vitals: RMSEs {rmses}')
        if method in ('ct', 'gnet'):
            test = coll.test_cf_one_step
            if np.allclose(model.get_predictions(test),
                           model.get_predictions(zeroed_vitals(test))):
                raise AssertionError(f'{method}: zeroing the vitals left '
                                     'its predictions unchanged')
        if method == 'gnet' and \
                model.holdout_resid.shape[-1] != 1 + REAL_DIM_VITALS:
            raise AssertionError(f'gnet residual bank '
                                 f'{model.holdout_resid.shape}')
        if method == 'crn' and 'vitals' not in model.encoder.keys:
            raise AssertionError(f'crn encoder keys {model.encoder.keys}')
        if method == 'ct':
            check_attention_maps('ct', model.get_attention_maps(maps_rows),
                                 ATTENTION_ROWS, model.cfg.num_heads, T)
        if method == 'edct':
            check_attention_maps(
                'edct encoder', model.encoder.get_attention_maps(maps_rows),
                ATTENTION_ROWS, model.cfg.num_heads, T)
        fitted[method] = (model, coll)
        step(f'{method} fit + RMSEs', t0)
    launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                'sens': rollout.SENS_LAUNCHES}
    log(f'[real] kernel launches of the five fits: {launches}')
    if launches != {'rollout': 0, 'sens': 0}:
        raise AssertionError(f'the real-data fits launched kernels: '
                             f'{launches}')

    t0 = perf_counter()
    log('[real] card f32 against host f32, a RealDatasetCollection (200 / '
        '10 / 10), 3 epochs, ct augmentation off')
    check_neural_card_against_host(
        device, REAL_METHODS, base=real_collection(device, REAL_SMALL_SIZES),
        overrides={'ct': {'augment_with_masked_vitals': False}})
    step('card against host', t0)

    t0 = perf_counter()
    sindy_coll = runner._collection_for('EQ_4_D', 'insite', 0, 2.0,
                                        RunConfig(), device=device)
    insite = runner._build_model('insite', 'EQ_4_D', sindy_coll,
                                 RunConfig(), device=device)
    insite.fit(sindy_coll.train_f)
    fitted['insite'] = (insite, sindy_coll)
    msm_coll = runner._collection_for('EQ_4_D', 'msm', 0, 2.0, RunConfig(),
                                      device=device)
    msm = runner._build_model('msm', 'EQ_4_D', msm_coll, RunConfig(),
                              device=device)
    msm.fit(msm_coll.train_f)
    fitted['msm'] = (msm, msm_coll)
    step('insite and msm fits', t0)

    t0 = perf_counter()
    reload_launches = None
    with tempfile.TemporaryDirectory() as tmp:
        for name, (model, coll) in fitted.items():
            method_cfg = cfg if name in REAL_METHODS else RunConfig()
            fresh = runner._build_model(name, 'EQ_4_D', coll, method_cfg,
                                        device=device)
            n_step = (coll.test_cf_treatment_seq_mc if name == 'gnet'
                      else coll.test_cf_treatment_seq)
            want = (model.get_predictions(coll.test_cf_one_step),
                    model.get_autoregressive_predictions(n_step))
            checkpoint.load_model(fresh, checkpoint.save_model(
                model, f'{tmp}/{name}'))
            rollout.reset_launch_counts()
            got_one = fresh.get_predictions(coll.test_cf_one_step)
            if name == 'insite':
                reload_launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                                   'sens': rollout.SENS_LAUNCHES}
            got = (got_one, fresh.get_autoregressive_predictions(n_step))
            for what, g, w in zip(('1-step', 'n-step'), got, want):
                if g.shape != w.shape or not np.array_equal(g, w):
                    raise AssertionError(f'{name} reloaded: {what} '
                                         'predictions differ')
            log(f'  {type(model).__name__} ({name}): saved, reloaded, 1-step '
                f'{got[0].shape} and n-step {got[1].shape} predictions '
                'bitwise equal')
    rows = len(sindy_coll.test_cf_one_step.data['prev_outputs'])
    log(f'[real] reloaded insite, predict on the EQ_4_D 1-step test set '
        f'(B={rows}): launches {reload_launches}')
    if reload_launches != {'rollout': 1, 'sens': GN_ITERS + 1}:
        raise AssertionError(f'the reloaded insite model launched '
                             f'{reload_launches}, expected 1 + '
                             f'{GN_ITERS + 1}')
    step('checkpoints', t0)
    return launches, reload_launches, walls


# ---------------------------------------------------------------------------
# phase 15: the BFGS and 'xla' fine-tunes, the legacy simulators, the weak
# fit's SR3 solve, a trace


@contextlib.contextmanager
def recording_bfgs(records):
    """Inside the block, every BFGS fine-tune (`insite_finetune_predict`)
    appends {rows, status, k, n_evals, launches, wall, coefs} to
    ``records``; its launches and wall are taken between device
    synchronisations."""
    import torch
    from insite_tpu_torch.models import sindy
    from insite_tpu_torch.ops import rollout

    def counts():
        return {'rollout': rollout.ROLLOUT_LAUNCHES,
                'sens': rollout.SENS_LAUNCHES}

    def wrap(fn):
        def call(*args, **kwargs):
            prev = args[2]
            if prev.is_cuda:
                torch.cuda.synchronize(prev.device)
            before, t0 = counts(), perf_counter()
            preds, coefs, res = fn(*args, **kwargs)
            if prev.is_cuda:
                torch.cuda.synchronize(prev.device)
            after = counts()
            records.append({
                'rows': prev.shape[0], 'status': res.status.cpu().numpy(),
                'k': res.k.cpu().numpy(), 'n_evals': res.n_evals,
                'launches': {k: after[k] - before[k] for k in after},
                'wall': perf_counter() - t0, 'coefs': coefs.cpu().numpy()})
            return preds, coefs, res
        return call

    with patched(sindy, 'insite_finetune_predict', wrap):
        yield


def log_bfgs(tag, rec):
    """One BFGS fine-tune: rows ending in each status, iterations,
    evaluations, launches and wall."""
    status, k = rec['status'], rec['k']
    shares = {int(s): f'{100 * np.mean(status == s):.2f} %'
              for s in (0, 1, 3, 5)}
    other = sorted(set(status.tolist()) - {0, 1, 3, 5})
    log(f'  {tag}: B={rec["rows"]}, status shares {shares}'
        + (f' (and {other})' if other else '')
        + f'; iterations mean {k.mean():.2f}, max {k.max()}; '
        f'{rec["n_evals"]} batched evaluations; launches '
        f'{rec["launches"]}; wall {rec["wall"]:.4f} s')


def check_bfgs_launches(records, launches, what):
    """A BFGS path launches one sensitivity kernel per batched evaluation
    and one rollout per fine-tune, and nothing else."""
    want = {'rollout': len(records),
            'sens': sum(r['n_evals'] for r in records)}
    if launches != want:
        raise AssertionError(f'{what} launched {launches}, expected {want} '
                             '(one rollout a fine-tune, one sensitivity '
                             'launch a BFGS evaluation)')
    for r in records:
        if r['launches'] != {'rollout': 1, 'sens': r['n_evals']}:
            raise AssertionError(f'{what}: a fine-tune launched '
                                 f'{r["launches"]} for {r["n_evals"]} '
                                 'evaluations')


def run_bfgs_run(device, table_rows):
    """(a) An EQ_4_D insite run through `run_experiment` with the BFGS
    fine-tune set by ``model_overrides``, on phase 5's cohort, in f32 (the
    default) and in f64: finite RMSEs, phase 5's Gauss-Newton 1-step RMSE
    at most `GN_OVER_BFGS` x BFGS's, BFGS below phase 5's sindy at 1 step;
    launches asserted against the BFGS's own evaluation count. Returns the
    launches by dtype."""
    import torch
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.ops import rollout
    cfg = RunConfig(model_overrides={'insite': dict(BFGS_OVERRIDES)})
    phase5 = {r['method_name']: r['encoder_test_rmse_orig']
              for r in table_rows if r['dataset_name'] == 'EQ_4_D'}
    out = {}
    for tag, dtype in (('f32', None), ('f64', torch.float64)):
        records = []
        torch.cuda.synchronize(device)
        rollout.reset_launch_counts()
        t0 = perf_counter()
        with recording_bfgs(records):
            row = runner.run_experiment('EQ_4_D', 'insite', 0, 2.0, cfg,
                                        device=device, dtype=dtype)
        torch.cuda.synchronize(device)
        wall = perf_counter() - t0
        launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                    'sens': rollout.SENS_LAUNCHES}
        for what, rec in zip(('1-step test set', 'n-step test set'),
                             records):
            log_bfgs(f'{tag}, {what}', rec)
        check_bfgs_launches(records, launches, f'the {tag} BFGS insite run')
        if len(records) != 2:
            raise AssertionError(f'{len(records)} BFGS fine-tunes, '
                                 'expected 2')
        rmses = np.array([row['encoder_test_rmse_orig'],
                          row['encoder_test_rmse_all']]
                         + [row[f'decoder_test_rmse_{k}-step']
                            for k in range(2, 7)], np.float64)
        bfgs = row['encoder_test_rmse_orig']
        log(f'  EQ_4_D insite BFGS {tag} (bfgs_maxiter '
            f'{BFGS_OVERRIDES["bfgs_maxiter"]}): 1-step {bfgs:.6f} %, '
            f'6-step {row["decoder_test_rmse_6-step"]:.6f} %; phase 5 '
            f'Gauss-Newton {phase5["insite"]:.6f} %, sindy '
            f'{phase5["sindy"]:.6f} %; run wall {wall:.4f} s; launches '
            f'{launches}')
        if not np.isfinite(rmses).all():
            raise AssertionError(f'BFGS {tag} RMSEs {rmses}')
        if not phase5['insite'] <= GN_OVER_BFGS * bfgs:
            raise AssertionError(f'Gauss-Newton {phase5["insite"]} % above '
                                 f'{GN_OVER_BFGS} x BFGS {tag} {bfgs} %')
        if not bfgs < phase5['sindy']:
            raise AssertionError(f'BFGS {tag} {bfgs} % not below sindy '
                                 f'{phase5["sindy"]} %')
        out[tag] = launches
    return out


@contextlib.contextmanager
def one_host_thread():
    """PyTorch on one host thread inside the block: the plain versions are
    thousands of small ops, which extra threads only slow (1.6x at 1,180
    rows on an 8-core host)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def check_bfgs_rows(card, host, lam, K, what):
    """Hold two BFGS fine-tunes of the same rows (`recording_bfgs`
    records, f64) row by row: coefficients within `BFGS_CARD_HOST_RTOL`
    where both end with the same status and iteration count; every other
    row ends with the zoom failed (status 3) on one side, or converged on
    both, and then, where its penalty ``lam`` (a float or one per row) is
    positive, within 2 gtol / (2 lam / K) of each other, the distance to
    the minimum that |grad| < gtol allows at the penalty's curvature; at
    most `BFGS_MAX_ZOOM_FAILED` of the rows end with the zoom failed on
    either side. Returns the rows that differ."""
    s_k, s_h = card['status'], host['status']
    same = (s_k == s_h) & (card['k'] == host['k'])
    c_k, c_h = card['coefs'].reshape(len(same), -1), \
        host['coefs'].reshape(len(same), -1)
    gap = float((np.abs(c_k - c_h) / np.maximum(np.abs(c_h), 1e-12))[same]
                .max(initial=0.0))
    pairs = {}
    for a, b, ka, kb in zip(s_k[~same], s_h[~same], card['k'][~same],
                            host['k'][~same]):
        key = f'{a}/{b}' + ('' if a != b else f' k {ka}/{kb}')
        pairs[key] = pairs.get(key, 0) + 1
    differ = int((~same).sum())
    log(f'  {what} ({len(same)} rows): {differ} end with another status or '
        f'iteration count (card/host status: {pairs}); largest relative '
        f'coefficient gap on the others {gap:.3e}')
    np.testing.assert_allclose(c_k[same], c_h[same], rtol=BFGS_CARD_HOST_RTOL,
                               atol=1e-12)
    edge = (s_k == 3) | (s_h == 3)
    both_converged = ~same & (s_k == 0) & (s_h == 0)
    if (~same & ~edge & ~both_converged).any():
        raise AssertionError(f'{what}: rows that differ otherwise: {pairs}')
    lam = np.broadcast_to(np.asarray(lam, np.float64), same.shape)
    held = both_converged & (lam > 0)
    bound = 2 * BFGS_GTOL / (2 * lam[held] / K)
    dist = np.abs(c_k[held] - c_h[held]).max(axis=1, initial=0.0)
    if (dist > bound).any():
        raise AssertionError(f'{what}: converged rows {dist} apart, bound '
                             f'{bound}')
    for tag, s in (('card', s_k), ('host', s_h)):
        if np.mean(s == 3) > BFGS_MAX_ZOOM_FAILED:
            raise AssertionError(f'{what}, {tag}: {np.mean(s == 3):.2%} of '
                                 'the rows end with the zoom failed')
    return differ


def check_bfgs_card_against_host(device):
    """(b) The BFGS fine-tune in f64 on the card against f64 on the host,
    on one EQ_4_D collection (200 / 10 / 10) handed to both, its 1-step
    test set at ``bfgs_maxiter`` `BFGS_SMALL_MAXITER`, held row by row by
    `check_bfgs_rows`. Also prints how many rows change their status or
    iteration count on the card alone when the global model moves by one
    part in 1e13, a change of the size of rounding."""
    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import sindy_params_for
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection('EQ_4_D', {'train': 200, 'val': 10, 'test': 10},
                           seed=7, coeff=2.0, device=device)
    cfg = SINDyConfig(dataset_name='EQ_4_D',
                      sindy_threshold=sindy_params_for('EQ_4_D')[0],
                      insite=True, insite_solver='bfgs',
                      bfgs_maxiter=BFGS_SMALL_MAXITER)
    out = {}
    for tag, dev in (('card', device), ('host', 'cpu')):
        m = SINDyRegressor(cfg, coll, device=dev,
                           dtype=torch.float64).fit(coll.train_f)
        records = []
        with recording_bfgs(records), one_host_thread():
            m.get_fine_tuned_coefficients(coll.test_cf_one_step)
            if tag == 'card':
                m.coefs = m.coefs * (1 + 1e-13)
                m.get_fine_tuned_coefficients(coll.test_cf_one_step)
        out[tag] = (m.coefs, records)
        log_bfgs(f'{tag} f64', records[0])
    (g_k, (r_k, r_moved)), (g_h, (r_h,)) = out['card'], out['host']
    if not ((np.abs(g_k) > 1e-3) == (np.abs(g_h) > 1e-3)).all():
        raise AssertionError(f'support differs: {g_k} vs {g_h}')
    moved = (r_moved['status'] != r_k['status']) | (r_moved['k'] != r_k['k'])
    log(f'  card f64, the global model moved by 1e-13: {int(moved.sum())} '
        f'rows change their status or iteration count')
    check_bfgs_rows(r_k, r_h, cfg.lam, g_k.size,
                    'BFGS card f64 vs host f64')


def check_bfgs_tune_card_against_host(device):
    """(c) `tune_insite_lam` under BFGS (EQ_4_D, 200 / 100 / 10, 7 x 100
    stacked rows, one BFGS fine-tune): f64 on the card against f64 on the
    host, its rows held by `check_bfgs_rows`, each with its lam; the
    scores and best lams printed (a row that ends with the zoom failed on
    one side keeps the global model there, and one such row moves a score
    by up to ~25 %); then the card in f32, printed beside them (in f32 most
    rows end with the zoom failed, as in the JAX package). Returns the
    card calls' launches by dtype (asserted)."""
    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.harness.config import sindy_params_for
    from insite_tpu_torch.harness.tuning import (INSITE_LAM_GRID,
                                                 tune_insite_lam)
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    from insite_tpu_torch.ops import rollout
    coll = make_collection('EQ_4_D', {'train': 200, 'val': 100, 'test': 10},
                           seed=7, coeff=2.0, device=device)
    cfg = SINDyConfig(dataset_name='EQ_4_D',
                      sindy_threshold=sindy_params_for('EQ_4_D')[0],
                      insite=True, insite_solver='bfgs',
                      bfgs_maxiter=BFGS_SMALL_MAXITER)
    out = {}
    for tag, dev, dtype in (('card f64', device, torch.float64),
                            ('host f64', 'cpu', torch.float64),
                            ('card f32', device, None)):
        m = SINDyRegressor(cfg, coll, device=dev, dtype=dtype).fit(
            coll.train_f)
        records = []
        rollout.reset_launch_counts()
        t0 = perf_counter()
        with recording_bfgs(records), one_host_thread():
            best, scores = tune_insite_lam(m, coll.val_f)
        secs = perf_counter() - t0
        launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                    'sens': rollout.SENS_LAUNCHES}
        log_bfgs(f'lam tune, {tag}', records[0])
        log(f'  lam tune, {tag}: best {best}, {secs:.4f} s, scores {scores}')
        if len(records) != 1 or records[0]['rows'] != TUNING_ROWS:
            raise AssertionError(f'the {tag} lam tune is not one fine-tune '
                                 f'of {TUNING_ROWS} rows')
        if dev != 'cpu':
            check_bfgs_launches(records, launches, f'the {tag} lam tune')
        out[tag] = (best, scores, launches, records[0], m.coefs.size)
    (best_k, s_k, _, r_k, K), (best_h, s_h, _, r_h, _) = \
        out['card f64'], out['host f64']
    gap = max(abs(s_k[lam] / s_h[lam] - 1) for lam in s_h)
    gap32 = max(abs(out['card f32'][1][lam] / s_h[lam] - 1) for lam in s_h)
    log(f'  BFGS lam tune card f64 vs host f64: best {best_k} vs {best_h}; '
        f'largest relative score gap {gap:.3e} (card f32 vs host f64 '
        f'{gap32:.3e}, best {out["card f32"][0]})')
    check_bfgs_rows(r_k, r_h, np.repeat(INSITE_LAM_GRID,
                                        TUNING_ROWS // len(INSITE_LAM_GRID)),
                    K, 'BFGS lam tune card f64 vs host f64')
    return {tag: out[tag][2] for tag in ('card f64', 'card f32')}


def run_xla_route(device):
    """(d) The 'xla' route: an EQ_4_D insite model built by the runner with
    ``rollout_backend='xla'`` from ``model_overrides`` (1,000 / 100 / 100,
    seed 0), fitted and predicting the 1-step test set with 0 + 0 launches
    (eager autodiff: ~16 s for its 11,800 rows; the n-step set would take
    ~25 s more); then the same fitted model on 'auto' (the kernels): the
    predictions within `XLA_RTOL` of the largest prediction. Returns the
    'xla' launches."""
    import torch
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.ops import rollout
    cfg = RunConfig(model_overrides={'insite': {'rollout_backend': 'xla'}})
    coll = runner._collection_for('EQ_4_D', 'insite', 0, 2.0, cfg,
                                  device=device)
    model = runner._build_model('insite', 'EQ_4_D', coll, cfg, device=device)
    ds = coll.test_cf_one_step
    torch.cuda.synchronize(device)
    rollout.reset_launch_counts()
    t0 = perf_counter()
    model.fit(coll.train_f)
    t1 = perf_counter()
    xla = model.get_predictions(ds)
    wall = perf_counter() - t1
    launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                'sens': rollout.SENS_LAUNCHES}
    log(f'  xla route: fit {t1 - t0:.4f} s, 1-step set ({len(xla)} rows) '
        f'{wall:.4f} s; launches {launches}')
    if launches != {'rollout': 0, 'sens': 0}:
        raise AssertionError(f"the 'xla' route launched {launches}")
    model.cfg.rollout_backend = 'auto'
    t1 = perf_counter()
    auto = model.get_predictions(ds)
    gap = float(np.abs(xla - auto).max())
    scale = float(np.abs(auto).max())
    log(f'  auto route, the same model and set: {perf_counter() - t1:.4f} '
        f's; xla against auto: largest gap {gap:.3e} of the largest '
        f'prediction {scale:.3f} (scaled outputs), {gap / scale:.3e}')
    if not gap <= XLA_RTOL * scale:
        raise AssertionError(f"'xla' and 'auto' predictions differ by "
                             f'{gap:.3e}')
    return launches


def run_legacy(device):
    """(e) `load_dataset` of eq_1..eq_8 at 1,000 / 100 / 100 on the card
    (f32): shapes and finite values; then each equation's training split
    in f64 on the card against f64 on the host from the same draws, rtol
    `LEGACY_RTOL`."""
    import torch
    from insite_tpu_torch.sim import legacy
    for name, (family, variant) in legacy.EQUATIONS.items():
        train, val, test, meta = legacy.load_dataset(name, 0, device=device,
                                                     **LEGACY_SIZES)
        D, A = legacy.DIMS[family]
        for split, n in ((train, 1000), (val, 100), (test, 100)):
            if split['x'].shape != (n, 60, D) or \
                    split['a'].shape != (n, 60, A) or \
                    not np.isfinite(split['x']).all():
                raise AssertionError(f'{name}: x {split["x"].shape}, a '
                                     f'{split["a"].shape}')
        gen = torch.Generator().manual_seed(11)
        draws = legacy.draw(family, 1000, 60, gen, device='cpu',
                            dtype=torch.float64)
        host = legacy.simulate(family, draws, 1.0, **variant)
        card = legacy.simulate(family, {k: v.to(device)
                                        for k, v in draws.items()}, 1.0,
                               **variant)
        x_h, x_k = host[0].numpy(), card[0].cpu().numpy()
        gap = float((np.abs(x_k - x_h) / np.maximum(np.abs(x_h),
                                                     1e-300)).max())
        log(f'  {name}: train {train["x"].shape}, a share '
            f'{train["a"].mean():.3f}; f64 card vs host largest relative '
            f'gap {gap:.3e}, actions equal '
            f'{np.array_equal(card[1].cpu().numpy(), host[1].numpy())}')
        np.testing.assert_array_equal(card[1].cpu().numpy(), host[1].numpy())
        np.testing.assert_allclose(x_k, x_h, rtol=LEGACY_RTOL, atol=0)


def check_sr3(device):
    """(f) `sr3_l1` on the weak system of one EQ_4_D arm (1,000 training
    patients, the estimator's windows): the card against the host in
    f64, rtol `SR3_RTOL`, the same support."""
    import torch
    from insite_tpu_torch.data.collection import make_collection
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    from insite_tpu_torch.discovery.wsindy import sr3_l1, weak_system
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    coll = make_collection('EQ_4_D', {'train': 1000, 'val': 10, 'test': 10},
                           seed=0, coeff=2.0, device=device)
    m = SINDyRegressor(SINDyConfig(dataset_name='EQ_4_D', wsindy=True), coll,
                       device=device)
    prev, statics, arms, lengths = m._unscaled_arrays(coll.train_f)
    unscaled = np.squeeze(coll.train_f.data['unscaled_outputs'], -1)
    volumes = np.concatenate([prev[:, :1], unscaled], axis=1)
    t = functools.partial(torch.as_tensor, device=device)
    A, b, w = weak_system(t(volumes, dtype=torch.float64),
                          t(statics, dtype=torch.float64),
                          t(np.maximum(lengths - 1, 2)),
                          PolynomialLibrary(n_inputs=1 + statics.shape[-1]),
                          m.dt, trajectory_mask=t(arms[:, 0] == 1))
    t0 = perf_counter()
    card = sr3_l1(A, b, w, SR3_THRESHOLD).cpu().numpy()
    t_card = perf_counter() - t0
    t0 = perf_counter()
    host = sr3_l1(A.cpu(), b.cpu(), w.cpu(), SR3_THRESHOLD).numpy()
    t_host = perf_counter() - t0
    gap = float((np.abs(card - host) / np.maximum(np.abs(host),
                                                   1e-300)).max())
    log(f'  sr3_l1, arm 1 weak system {tuple(A.shape)}, threshold '
        f'{SR3_THRESHOLD}: card {t_card:.4f} s, host {t_host:.4f} s; '
        f'coefficients {card}; largest relative gap {gap:.3e}')
    np.testing.assert_array_equal(card != 0, host != 0)
    if not (card != 0).any():
        raise AssertionError('sr3_l1 kept no coefficient')
    np.testing.assert_allclose(card, host, rtol=SR3_RTOL, atol=0)


TRACE_CODE = '''
import json, sys
from pathlib import Path
from insite_tpu_torch.harness.northstar import fused_northstar
from insite_tpu_torch.utils import profiling
kw = dict(seed=0, equation_name='EQ_4_D', projection_horizon=1,
          gn_iters={gn_iters}, device='cuda')
fused_northstar({n}, **kw)
with profiling.trace(sys.argv[1]):
    fused_northstar({n}, **kw)
events = json.loads((Path(sys.argv[1]) / profiling.TRACE_FILE).read_text())
names = [e['name'] for e in events['traceEvents']
         if e.get('cat') == 'kernel']
print(json.dumps({{'sens': sum('rollout_sens_kernel<' in s for s in names),
                  'rollout': sum('rollout_kernel<' in s for s in names),
                  'kernels': len(names)}}))
'''


def start_trace(tmp):
    """(g), started: `utils.profiling.trace` around one warm 10,000-patient
    north star, in a process of its own (a later profiler session in this
    one would see no kernel events), writing into ``tmp``. It runs beside
    the host-bound checks that follow it; `finish_trace` waits for it."""
    from pathlib import Path
    code = TRACE_CODE.format(n=N_PATIENTS, gn_iters=GN_ITERS)
    return subprocess.Popen([sys.executable, '-c', code, tmp],
                            cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_trace(child, tmp, t0):
    """(g), checked: the child ended cleanly and its Chrome trace names
    the sensitivity kernel `GN_ITERS` + 1 times and the rollout kernel
    once."""
    from pathlib import Path
    out, err = child.communicate(timeout=600)
    if child.returncode != 0:
        raise AssertionError(f'the trace child failed:\n{err[-4000:]}')
    counts = json.loads(out.strip().splitlines()[-1])
    size = (Path(tmp) / 'trace.json').stat().st_size
    log(f'  trace of a warm north star: {counts}, {size} bytes, '
        f'{perf_counter() - t0:.4f} s from the child\'s start (beside '
        f'(b), (c), (e) and (f))')
    if (counts['sens'], counts['rollout']) != (GN_ITERS + 1, 1):
        raise AssertionError(f'the trace names {counts}')


def run_slice8(device, table_rows):
    """Phase 15. Returns (the BFGS launches: the runs' and the lam tunes',
    the 'xla' route's launches, the wall of each step)."""
    import torch
    walls = {}

    def step(name, t0):
        torch.cuda.synchronize(device)
        walls[name] = perf_counter() - t0
        log(f'[slice8] {name}: {walls[name]:.4f} s')

    t0 = perf_counter()
    log('[slice8] (a) EQ_4_D insite with the BFGS fine-tune, 1000/100/100')
    bfgs = {'run': run_bfgs_run(device, table_rows)}
    step('(a) BFGS insite run', t0)
    with tempfile.TemporaryDirectory() as tmp:
        t_trace = perf_counter()
        log('[slice8] (g) started: profiling.trace around a warm north '
            'star, in a child process')
        child = start_trace(tmp)
        try:
            t0 = perf_counter()
            log('[slice8] (b) BFGS card f64 vs host f64, 200 / 10 / 10')
            check_bfgs_card_against_host(device)
            step('(b) BFGS card vs host', t0)
            t0 = perf_counter()
            log('[slice8] (c) the lam tune under BFGS, card f64 vs host '
                'f64, card f32')
            bfgs['tune'] = check_bfgs_tune_card_against_host(device)
            step('(c) BFGS lam tune', t0)
            t0 = perf_counter()
            log('[slice8] (e) legacy eq_1..eq_8, 1000/100/100')
            run_legacy(device)
            step('(e) legacy simulators', t0)
            t0 = perf_counter()
            log('[slice8] (f) sr3_l1 card vs host')
            check_sr3(device)
            step('(f) sr3_l1', t0)
            t0 = perf_counter()
            finish_trace(child, tmp, t_trace)
            step('(g) trace, waiting for the child', t0)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    t0 = perf_counter()
    log("[slice8] (d) the 'xla' route, EQ_4_D insite, 1000/100/100")
    xla = run_xla_route(device)
    step("(d) 'xla' route", t0)
    return bfgs, xla, walls


# ---------------------------------------------------------------------------
# phase 16: the repository's own entry points

def bench_in_process(device, mode):
    """(a): `insite_tpu_torch.bench.main` in ``mode`` at the bench's size
    (`N_PATIENTS`, `BENCH_REPEATS` device-time repeats), its JSON line
    sent to stderr with its stage lines. Checks the line's keys and
    metric name and the north-star gate; asserts the launches of the
    timed part exactly: fused (1 + `BENCH_REPEATS`) x (1 rollout +
    `GN_ITERS` + 1 sensitivity), standard one fine-tune's 1 + (`GN_ITERS`
    + 1) (the fit launches nothing); the untimed warm-up's (a small
    cohort: one fine-tune, no sensitivity launch where its fit keeps no
    coefficient) are counted apart. Returns (the record, the timed
    launches, the warm-up's, the wall)."""
    import torch
    from insite_tpu_torch import bench
    from insite_tpu_torch.ops import rollout
    env = {'BENCH_MODE': mode, 'BENCH_PATIENTS': str(N_PATIENTS),
           'BENCH_DEVICE_REPEATS': str(BENCH_REPEATS)}
    warm = {}

    def wrap(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            warm.update(rollout=rollout.ROLLOUT_LAUNCHES,
                        sens=rollout.SENS_LAUNCHES)
            return out
        return call

    torch.cuda.synchronize(device)
    rollout.reset_launch_counts()
    t0 = perf_counter()
    with patched(bench, '_warmup', wrap), \
            contextlib.redirect_stdout(sys.stderr):
        rec = bench.main(env)
    torch.cuda.synchronize(device)
    wall = perf_counter() - t0
    timed = {'rollout': rollout.ROLLOUT_LAUNCHES - warm['rollout'],
             'sens': rollout.SENS_LAUNCHES - warm['sens']}
    runs = 1 + BENCH_REPEATS if mode == 'fused' else 1
    want = {'rollout': runs, 'sens': runs * (GN_ITERS + 1)}
    line = rec['line']
    log(f'[entry] bench {mode}: {json.dumps(line)}; stages '
        f'{json.dumps(rec["stages"])}; rmse_orig {rec["rmse_orig"]:.6f} %, '
        f'rmse_all {rec["rmse_all"]:.6f} %; launches timed {timed}, '
        f'warm-up {warm}; wall with the warm-up {wall:.4f} s')
    log(f'  {rec["global_equation_string"]}')
    keys = BENCH_LINE_KEYS | ({'device_time_s'} if mode == 'fused'
                              else set())
    if set(line) != keys or line['metric'] != BENCH_METRIC:
        raise AssertionError(f'bench {mode} line {line}')
    if timed != want:
        raise AssertionError(f'bench {mode}: expected {want} launches in '
                             f'the timed part, got {timed}')
    if warm['rollout'] != 1 or warm['sens'] not in (0, GN_ITERS + 1):
        raise AssertionError(f'bench {mode} warm-up launched {warm}')
    if not rec['rmse_orig'] < 0.1:
        raise AssertionError(f'bench {mode}: rmse_orig {rec["rmse_orig"]}'
                             ' % >= 0.1 %')
    return rec, timed, warm, wall


def start_bench_child():
    """(b), started: ``python -m insite_tpu_torch.bench`` as a user runs
    it (fused, 10,000 patients, 2 repeats: no BENCH_ setting passed on)."""
    import os
    from pathlib import Path
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    return subprocess.Popen([sys.executable, '-m', 'insite_tpu_torch.bench'],
                            cwd=Path(__file__).resolve().parent, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_bench_child(child, t0):
    """(b), checked: the child ended cleanly and its last line of stdout
    parses with `bench.py`'s keys. Returns its wall from its start."""
    out, err = child.communicate(timeout=BENCH_CHILD_TIMEOUT_S)
    if child.returncode != 0:
        raise AssertionError(f'the bench child failed:\n{err[-4000:]}')
    wall = perf_counter() - t0
    line = json.loads(out.strip().splitlines()[-1])
    log(f'  python -m insite_tpu_torch.bench: {json.dumps(line)}; '
        f'{wall:.4f} s from its start')
    for msg in err.strip().splitlines():
        log(f'    {msg}')
    if set(line) != BENCH_LINE_KEYS | {'device_time_s'} or \
            line['metric'] != BENCH_METRIC:
        raise AssertionError(f'the bench child printed {line}')
    return wall


def check_results_cli(logs, tmp):
    """(c): the results CLI (``python -m
    insite_tpu_torch.process_result_file``, in this process) on ``logs``,
    phases 5, 6 and 11's: its tables equal `generate_main_results_table`
    of the rows built here (each cell's row from the last log that holds
    it) and its CSV has one line a row."""
    import io
    from insite_tpu_torch import process_result_file
    from insite_tpu_torch.harness.results import (generate_main_results_table,
                                                  rows_from_log)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        process_result_file.main(logs + ['--csv', f'{tmp}/rows.csv'])
    text = out.getvalue()
    cells = {}
    for path in logs:
        for r in rows_from_log(path):
            cells[tuple(r.get(k) for k in
                        process_result_file.KEY_COLUMNS)] = r
    rows = list(cells.values())
    tables = dict(block.rstrip('\n').split('\n', 1) for block in
                  text.split('\nLatex Table:: ')[1:])
    if tables != generate_main_results_table(rows):
        raise AssertionError(f'the results CLI printed other tables:\n'
                             f'{text}')
    with open(f'{tmp}/rows.csv') as f:
        n_lines = sum(1 for _ in f)
    log(f'  results CLI on {len(logs)} logs: {text.splitlines()[0]}; '
        f'{len(tables)} tables equal the in-process ones; CSV '
        f'{n_lines - 1} rows')
    if f'parsed {len(rows)} completed runs' not in text or \
            n_lines != 1 + len(rows):
        raise AssertionError(f'{len(rows)} rows, CSV of {n_lines} lines')
    return tables


def check_figure_rows(logs, less_samples_log):
    """(d): the figure CLI's row functions on phases 5, 6 and 11's logs and
    phase 8's INSIGHT_LESS_SAMPLES log, and on the tracked result JSONs:
    rows made and their per-group means finite. The figures themselves
    need matplotlib, which this machine may lack: the CPU tests render
    them."""
    import importlib.util
    from pathlib import Path
    from insite_tpu_torch import make_figures
    from insite_tpu_torch.harness.plots import _agg
    repo_logs = Path(__file__).resolve().parent / 'logs'
    built = {
        'n-step': (make_figures.nstep_rows(logs),
                   ['dataset_name', 'method_name']),
        'sample efficiency': (
            make_figures.less_samples_rows([less_samples_log]),
            ['method_name', 'train_samples']),
        'confounding': (
            make_figures.confounding_rows(repo_logs / 'conf10.json')[0],
            ['method_name', 'domain_conf'])}
    for name, (rows, group_cols) in built.items():
        means, _, _ = _agg(rows, group_cols)
        one_step = [m['encoder_test_rmse_orig'] for m in means.values()]
        log(f'  {name} rows: {len(rows)}, {len(means)} groups, 1-step means '
            f'{min(one_step):.6f}..{max(one_step):.6f} %')
        if not rows or not np.isfinite(one_step).all():
            raise AssertionError(f'{name} rows: {len(rows)}, means {means}')
    recover = make_figures.recover_data(repo_logs / 'recover_dist.json')
    log(f'  recovered-distribution arms: {sorted(recover)}')
    has_mpl = importlib.util.find_spec('matplotlib') is not None
    log(f'  matplotlib {"present" if has_mpl else "absent"} here: the '
        'figures are drawn by the CPU tests '
        '(tests/test_torch_make_figures.py), not here')


def check_entry(device):
    """(e): `insite_tpu_torch.entry.entry()` on the card: one rollout
    launch, against the kernel's plain version on the same tensors within
    `TOL`'s f32 rollout tolerance. Returns its launches."""
    import torch
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    from insite_tpu_torch.entry import DT, entry
    from insite_tpu_torch.ops import rollout
    fn, args = entry()
    torch.cuda.synchronize(device)
    rollout.reset_launch_counts()
    y = fn(*args)
    torch.cuda.synchronize(device)
    launches = {'rollout': rollout.ROLLOUT_LAUNCHES,
                'sens': rollout.SENS_LAUNCHES}
    coefs, y0, statics, arms = args
    plain = rollout.batched_rollout_plain(PolynomialLibrary(n_inputs=3),
                                          coefs[None], y0, statics, arms, DT)
    err = check_close('entry() vs plain', y, plain, *TOL['f32']['y'])
    log(f'  entry(): {tuple(y.shape)} on {y.device}, launches {launches}, '
        f'max abs err vs plain {err:.3e}')
    if launches != {'rollout': 1, 'sens': 0}:
        raise AssertionError(f'entry() launched {launches}')
    return launches


def run_entry_points(device, logs, less_samples_log):
    """Phase 16. Returns (the launches of the bench's timed parts by mode,
    entry()'s launches, the wall of each step)."""
    import torch
    walls = {}

    def step(name, t0):
        torch.cuda.synchronize(device)
        walls[name] = perf_counter() - t0
        log(f'[entry] {name}: {walls[name]:.4f} s')

    bench_launches = {}
    for mode in ('fused', 'standard'):
        t0 = perf_counter()
        log(f'[entry] (a) the bench in this process, {mode}, {N_PATIENTS} '
            'patients')
        _, bench_launches[mode], _, _ = bench_in_process(device, mode)
        step(f'(a) bench {mode}', t0)
    with tempfile.TemporaryDirectory() as tmp:
        t_child = perf_counter()
        log('[entry] (b) started: python -m insite_tpu_torch.bench')
        child = start_bench_child()
        try:
            t0 = perf_counter()
            log('[entry] (c) the results CLI on the logs of phases 5, 6, 11')
            check_results_cli(logs, tmp)
            step('(c) results CLI', t0)
            t0 = perf_counter()
            log('[entry] (d) the figure CLI\'s row functions')
            check_figure_rows(logs, less_samples_log)
            step('(d) figure rows', t0)
            t0 = perf_counter()
            log('[entry] (e) entry()')
            entry_launches = check_entry(device)
            step('(e) entry()', t0)
            t0 = perf_counter()
            walls['(b) bench child from its start'] = finish_bench_child(
                child, t_child)
            step('(b) bench child, waiting for it', t0)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    return bench_launches, entry_launches, walls


# ---------------------------------------------------------------------------
# phase 17: the batch mesh

def mesh_of(n_shards):
    """The visible cards repeated in turn up to ``n_shards`` shards."""
    import torch
    from insite_tpu_torch.parallel import batch_mesh
    count = torch.cuda.device_count()
    return batch_mesh([torch.device('cuda', i % count)
                       for i in range(n_shards)])


def counted(device, fn):
    """(fn(), its kernel launches, its wall time to a synchronisation)."""
    import torch
    from insite_tpu_torch.ops import rollout
    torch.cuda.synchronize()
    rollout.reset_launch_counts()
    t0 = perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = perf_counter() - t0
    return out, {'rollout': rollout.ROLLOUT_LAUNCHES,
                 'sens': rollout.SENS_LAUNCHES}, wall


def check_sharded_launches(what, unsharded, sharded, shards):
    """Raise unless the sharded run launched each kernel exactly shards x
    the unsharded run's count; prints the launches a shard."""
    per_shard = {k: n / shards for k, n in sharded.items()}
    log(f'  {what}: unsharded {unsharded}, sharded {sharded} over {shards} '
        f'shards, {per_shard} a shard')
    if sharded != {k: shards * n for k, n in unsharded.items()}:
        raise AssertionError(f'{what}: {sharded} launches over {shards} '
                             f'shards, expected {shards} x {unsharded}')


def check_kernel_on_last_card(device):
    """Both kernels on tensors on the last visible card while cuda:0 is
    current, against their plain versions there within `TOL` (f32): on one
    card the same card, through the wrappers' device guard."""
    import torch
    from insite_tpu_torch.ops import rollout
    last = torch.device('cuda', torch.cuda.device_count() - 1)
    case = eq4_case(2048, 60, True, 2)
    args = tensors(case, torch.float32, last)
    act = case['active_idx']
    with torch.cuda.device(0):
        rollout.reset_launch_counts()
        y = rollout.batched_rollout(*args)
        ys, s = rollout.rollout_with_sens(*args, act)
        current = torch.cuda.current_device()
    torch.cuda.synchronize()
    launches = (rollout.ROLLOUT_LAUNCHES, rollout.SENS_LAUNCHES)
    if launches != (1, 1) or current != 0 or y.device != last:
        raise AssertionError(f'{last}: launches {launches}, current device '
                             f'{current}, output on {y.device}')
    err = max(check_close('last card rollout', y,
                          rollout.batched_rollout_plain(*args),
                          *TOL['f32']['y']),
              check_close('last card sens', s,
                          rollout.rollout_with_sens_plain(*args, act)[1],
                          *TOL['f32']['sens']))
    log(f'  kernels on {last} with cuda:0 current: 1 + 1 launches, max abs '
        f'err vs plain {err:.3e}')


def run_mesh_insite(device, mesh):
    """(b) insite EQ_4_D at 1,000 / 100 / 100 (seq 60, horizon 5, gamma
    2), fitted once, its 1-step (B = 11,800) and n-step (B = 59,000)
    predictions unsharded and over ``mesh``: launches = shards x
    unsharded, predictions and fine-tuned coefficients within
    `MESH_RTOL` / `MESH_ATOL`. Returns ({tag: launches}, {tag: wall})."""
    import torch
    from insite_tpu_torch.models.sindy import SINDyRegressor
    coll, model = fitted_model('EQ_4_D', device)
    sharded = SINDyRegressor(model.cfg, coll, device=device, mesh=mesh)
    sharded.fit(coll.train_f)
    if not np.array_equal(sharded.coefs, model.coefs):
        raise AssertionError('the two fits of one collection differ')
    one, nst = coll.test_cf_one_step, coll.test_cf_treatment_seq
    runs, launches, walls = {}, {}, {}
    for tag, m in (('unsharded', model), ('sharded', sharded)):
        runs[tag], launches[tag], walls[tag] = counted(device, lambda m=m: (
            m.get_predictions(one), m.get_autoregressive_predictions(nst)))
    n_one, n_nst = len(one.data['prev_outputs']), \
        len(nst.data['prev_outputs'])
    log(f'  insite EQ_4_D 1-step B={n_one}, n-step B={n_nst}: unsharded '
        f'{walls["unsharded"]:.4f} s, {len(mesh)} shards '
        f'{walls["sharded"]:.4f} s (shards run one after another on a '
        'card)')
    check_sharded_launches('insite EQ_4_D predictions',
                           launches['unsharded'], launches['sharded'],
                           len(mesh))
    err = 0.0
    for i, what in enumerate(('1-step', 'n-step')):
        err = max(err, check_close(
            f'sharded insite {what}', torch.as_tensor(runs['sharded'][i]),
            torch.as_tensor(runs['unsharded'][i]), MESH_RTOL, MESH_ATOL))
    coefs = [m.get_fine_tuned_coefficients(one) for m in (model, sharded)]
    err_c = check_close('sharded insite coefficients',
                        torch.as_tensor(coefs[1]), torch.as_tensor(coefs[0]),
                        MESH_RTOL, MESH_ATOL)
    log(f'  sharded vs unsharded: predictions max abs err {err:.3e}, '
        f'fine-tuned coefficients {err_c:.3e}')
    return ({f'insite_{t}': n for t, n in launches.items()},
            {f'insite_{t}': w for t, w in walls.items()})


def run_mesh_columns(device, mesh):
    """(c) 10-seed sindy and insite columns of `vectorized_eq4_sweep`
    (EQ_4_D, 1,000 / 100 patients) unsharded and with their seeds over
    ``mesh``: launches = shards x unsharded, every per-seed metric and
    coefficient within `MESH_RTOL` / `MESH_ATOL`."""
    import torch
    from insite_tpu_torch.harness.vectorized import vectorized_eq4_sweep
    launches, walls = {}, {}
    for method in ('sindy', 'insite'):
        res = {}
        for tag, kw in (('unsharded', dict(device=device)),
                        ('sharded', dict(mesh=mesh))):
            res[tag], launches[f'{method}_column_{tag}'], \
                walls[f'{method}_column_{tag}'] = counted(
                    device, lambda kw=kw: vectorized_eq4_sweep(
                        'EQ_4_D', n_seeds=MESH_SEEDS, method=method, **kw))
        check_sharded_launches(f'{MESH_SEEDS}-seed {method} column',
                               launches[f'{method}_column_unsharded'],
                               launches[f'{method}_column_sharded'],
                               len(mesh))
        err = max(check_close(f'sharded {method} column {k}',
                              torch.as_tensor(res['sharded'][k]),
                              torch.as_tensor(res['unsharded'][k]),
                              MESH_RTOL, MESH_ATOL)
                  for k in res['unsharded'])
        log(f'  {method} column: unsharded '
            f'{walls[f"{method}_column_unsharded"]:.4f} s, sharded '
            f'{walls[f"{method}_column_sharded"]:.4f} s; max abs err '
            f'{err:.3e}; 1-step mean {res["sharded"]["mean"]:.6f} %')
    return launches, walls


def run_mesh_neural(device, mesh):
    """(d) each neural method's column (EQ_4_D, 200 / 10 / 10, one seed a
    shard, 2 epochs, dropout 0, one batch an epoch: `NEURAL_ONE_BATCH`)
    unsharded and sharded: no launch, every per-seed RMSE within
    `MESH_RTOL` / `MESH_ATOL`; then ct with dropout on, whose sharded
    column (masks from one generator a block) is held to the unsharded
    column's means by phase 12's ct band (`VECTORIZED_NEURAL_BANDS`)."""
    import torch
    from insite_tpu_torch.harness import vectorized_neural as vn
    walls = {}
    kw = dict(n_seeds=len(mesh), num_patients={'train': 200, 'val': 10,
                                               'test': 10}, epochs=2)

    def column(method, **extra):
        if method in ('crn', 'edct'):
            return vn.vectorized_enc_dec_sweep(method, 'EQ_4_D', **kw,
                                               **extra)
        fn = {'ct': vn.vectorized_ct_sweep, 'rmsn': vn.vectorized_rmsn_sweep,
              'gnet': vn.vectorized_gnet_sweep}[method]
        if method == 'gnet':
            extra['mc_samples'] = 2
        return fn('EQ_4_D', **kw, **extra)

    for method in ('ct', 'crn', 'edct', 'rmsn', 'gnet'):
        ov = NEURAL_ONE_BATCH[method]
        res, launches = {}, {}
        for tag, where in (('unsharded', dict(device=device)),
                           ('sharded', dict(mesh=mesh))):
            res[tag], launches[tag], walls[f'{method}_{tag}'] = counted(
                device, lambda where=where: column(
                    method, model_overrides=ov, **where))
        if launches != {t: {'rollout': 0, 'sens': 0} for t in launches}:
            raise AssertionError(f'{method} columns launched {launches}')
        err = max(check_close(f'sharded {method} column {k}',
                              torch.as_tensor(res['sharded'][k]),
                              torch.as_tensor(res['unsharded'][k]),
                              MESH_RTOL, MESH_ATOL)
                  for k in res['unsharded'])
        log(f'  {method} {len(mesh)}-seed column, dropout 0: unsharded '
            f'{walls[f"{method}_unsharded"]:.4f} s, sharded '
            f'{walls[f"{method}_sharded"]:.4f} s; max abs err {err:.3e}')
    res = {tag: column('ct', **where) for tag, where in (
        ('unsharded', dict(device=device)), ('sharded', dict(mesh=mesh)))}
    for i, keys in enumerate((['encoder_test_rmse_orig'],
                              [f'decoder_test_rmse_{k}-step'
                               for k in range(2, 7)])):
        lo, hi = VECTORIZED_NEURAL_BANDS['EQ_4_D ct'][i]
        for k in keys:
            ratio = float(np.mean(res['sharded'][k]) /
                          np.mean(res['unsharded'][k]))
            if not (np.isfinite(res['sharded'][k]).all()
                    and lo <= ratio <= hi):
                raise AssertionError(f'ct with dropout, sharded {k}: mean '
                                     f'x{ratio:.3f} of the unsharded')
    log('  ct with dropout on: sharded column means inside the ct band '
        'of the unsharded ones')
    return walls


def run_mesh(device):
    """Phase 17. Returns (launches by run, the wall of each step)."""
    import torch
    from insite_tpu_torch.entry import dryrun_multichip
    count = torch.cuda.device_count()
    mesh = mesh_of(max(2, count))
    column_mesh = mesh if MESH_SEEDS % len(mesh) == 0 else mesh_of(2)
    log(f'[mesh] {len(mesh)} shards on {len(set(mesh))} distinct card(s) '
        f'of {count}: {[str(d) for d in mesh]}; columns over '
        f'{len(column_mesh)} shards')
    walls, launches = {}, {}

    def step(name, t0):
        torch.cuda.synchronize()
        walls[name] = perf_counter() - t0
        log(f'[mesh] {name}: {walls[name]:.4f} s')

    t0 = perf_counter()
    check_kernel_on_last_card(device)
    step('(a) kernels on the last card', t0)
    t0 = perf_counter()
    got, w = run_mesh_insite(device, mesh)
    launches.update(got)
    walls.update(w)
    step('(b) insite EQ_4_D, full width', t0)
    t0 = perf_counter()
    got, w = run_mesh_columns(device, column_mesh)
    launches.update(got)
    walls.update(w)
    step(f'(c) {MESH_SEEDS}-seed columns', t0)
    t0 = perf_counter()
    walls.update(run_mesh_neural(device, mesh))
    step('(d) neural columns', t0)
    for n in sorted({2, max(2, count)}):
        t0 = perf_counter()
        rec, launches[f'dryrun_{n}'], _ = counted(
            device, lambda n=n: dryrun_multichip(n))
        log(f'  dryrun_multichip({n}) steps: '
            f'{json.dumps({k: round(v, 4) for k, v in rec["walls"].items()})}'
            f'; launches {launches[f"dryrun_{n}"]}')
        step(f'(e) dryrun_multichip({n})', t0)
    return launches, walls


# ---------------------------------------------------------------------------
# phase 18: the public surface

SUBPACKAGES = ('core', 'data', 'discovery', 'eval', 'models', 'models.nn',
               'ops', 'parallel', 'sim', 'utils', 'harness')
SURFACE_CODE = '''
import importlib, json, sys
from time import perf_counter
t0 = perf_counter()
import insite_tpu_torch
names = 1
for sub in %r:
    pkg = importlib.import_module('insite_tpu_torch.' + sub)
    if sub == 'harness':
        runner_before = 'insite_tpu_torch.harness.runner' in sys.modules
    for n in pkg.__all__:
        getattr(pkg, n)
    names += len(pkg.__all__)
from insite_tpu_torch.ops import build, rollout
print(json.dumps({
    'imports_s': perf_counter() - t0, 'names': names,
    'version': insite_tpu_torch.__version__,
    'runner_before_harness_names': runner_before,
    'runner_after': 'insite_tpu_torch.harness.runner' in sys.modules,
    'kernel_library_loaded': build.load_library.cache_info().currsize
    + rollout._kernels.cache_info().currsize > 0,
    'loaded_of_jax_pandas_yaml': sorted(
        {'jax', 'pandas', 'yaml'} & set(sys.modules))}))
''' % (SUBPACKAGES,)


def start_child(args, cwd):
    """A child interpreter of the repository's code in ``cwd``, output
    captured."""
    import os
    from pathlib import Path
    root = str(Path(__file__).resolve().parent)
    path = os.environ.get('PYTHONPATH')
    env = {**os.environ,
           'PYTHONPATH': root if not path else f'{root}{os.pathsep}{path}'}
    return subprocess.Popen([sys.executable, *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_child(what, child, t0):
    """(stdout, wall from ``t0``) of a child that must exit 0."""
    out, err = child.communicate(timeout=SURFACE_CHILD_TIMEOUT_S)
    wall = perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f'{what} exited {child.returncode}:\n'
                             f'{err[-4000:]}')
    return out, wall


def check_surface_child(out, wall):
    """(a), checked: every exported name imported; no kernel library, no
    runner before the harness's names, no JAX, pandas or PyYAML."""
    rec = json.loads(out.strip().splitlines()[-1])
    log(f'[surface] (a) {rec["names"]} exported names imported in '
        f'{rec["imports_s"]:.4f} s, the child {wall:.4f} s from its start; '
        f'runner loaded before the harness names '
        f'{rec["runner_before_harness_names"]}, after '
        f'{rec["runner_after"]}; kernel library loaded '
        f'{rec["kernel_library_loaded"]}; of jax, pandas, yaml loaded '
        f'{rec["loaded_of_jax_pandas_yaml"]}')
    if rec['runner_before_harness_names'] or not rec['runner_after'] or \
            rec['kernel_library_loaded'] or \
            rec['loaded_of_jax_pandas_yaml'] or rec['version'] != '0.1.0':
        raise AssertionError(f'the surface child reported {rec}')


def check_masked_ridge(device):
    """(b): `masked_ridge` on the card against the host's float64 solve of
    the same values, at the EQ_4 design's size (1,000 patients x 59 steps,
    F = 10), with 3 columns masked and a fifth of the rows weighing 0."""
    import torch
    from insite_tpu_torch.discovery import masked_ridge
    gen = torch.Generator().manual_seed(18)
    N, F = 59_000, 10
    theta = torch.randn(N, F, generator=gen, dtype=torch.float64)
    y = theta @ torch.randn(F, generator=gen, dtype=torch.float64) + \
        0.1 * torch.randn(N, generator=gen, dtype=torch.float64)
    weight = (torch.rand(N, generator=gen) > 0.2).double()
    mask = torch.ones(F, dtype=torch.bool)
    mask[[1, 4, 8]] = False
    for dtype in (torch.float64, torch.float32):
        args = [a.to(dtype) for a in (theta, y, weight)]
        host = masked_ridge(args[0].double(), args[1].double(), 0.05, mask,
                            args[2].double())
        torch.cuda.synchronize(device)
        t0 = perf_counter()
        card = masked_ridge(*[a.to(device) for a in args[:2]], 0.05,
                            mask.to(device), args[2].to(device))
        torch.cuda.synchronize(device)
        wall = perf_counter() - t0
        if card.device != device or card.dtype != dtype:
            raise AssertionError(f'masked_ridge returned {card.dtype} on '
                                 f'{card.device}')
        card = card.cpu().double()
        err = float((card - host).abs().max())
        rtol = SURFACE_RIDGE_RTOL[str(dtype).split('.')[-1]]
        log(f'[surface] (b) masked_ridge {dtype} on the card vs host f64: '
            f'max abs err {err:.3e} (rtol {rtol:g}); {wall:.4f} s')
        if not torch.allclose(card, host, rtol=rtol, atol=0) or \
                (card[~mask] != 0).any():
            raise AssertionError(f'masked_ridge {dtype}: {card} vs {host}')


def check_gap_table(what, out, target=10):
    """(c): the default table's header, rows and total line; returns the
    counts by (method, dataset)."""
    from insite_tpu_torch import seed_gaps
    lines = out.rstrip('\n').split('\n')
    w = max(len(ds) for ds in seed_gaps.DATASETS) + 2
    header = 'method'.ljust(8) + ''.join(ds.ljust(w)
                                         for ds in seed_gaps.DATASETS)
    if lines[0] != header or len(lines) != len(seed_gaps.METHODS) + 2:
        raise AssertionError(f'{what}: the table reads\n{out}')
    counts = {}
    for m, line in zip(seed_gaps.METHODS, lines[1:-1]):
        cells = line.split()
        if cells[0] != m or len(cells) != len(seed_gaps.DATASETS) + 1:
            raise AssertionError(f'{what}: row {line!r}')
        counts.update({(m, ds): int(v)
                       for ds, v in zip(seed_gaps.DATASETS, cells[1:])})
    total = sum(max(0, target - v) for v in counts.values())
    if lines[-1] != f'missing seed-runs to n={target}: {total}':
        raise AssertionError(f'{what}: total line {lines[-1]!r}, the cells '
                             f'give {total}')
    for line in lines:
        log(f'    {line}')
    return counts


def run_surface(device, phase_logs, bench_child_s):
    """Phase 18. ``phase_logs``: the logs of phases 5, 6 and 11;
    ``bench_child_s``: phase 16's bench-child wall. Returns the wall of
    each step."""
    from pathlib import Path
    walls = {}
    logs = Path(__file__).resolve().parent / 'logs' / 'run-*.txt'
    with tempfile.TemporaryDirectory() as tmp:
        # the phases' logs under the names a sweep gives its logs
        for i, path in enumerate(phase_logs):
            Path(tmp, f'run-phase{i}.txt').symlink_to(path)
        phase_glob = str(Path(tmp, 'run-*.txt'))
        work = Path(tmp, 'work')            # no marker files here
        work.mkdir()
        # every child started at once; each one's wall is the time from
        # then to when it is seen to have ended, the quick ones first
        t0 = perf_counter()
        children = {}
        for tag, glob_ in (('tracked', str(logs)), ('phases', phase_glob)):
            for flags in ((), ('--next-cell',)):
                children[f'(c) seed_gaps {tag} {" ".join(flags)}'.strip()] = \
                    start_child(['-m', 'insite_tpu_torch.seed_gaps',
                                 '--logs', glob_, *flags], work)
        children['(a) surface child'] = start_child(['-c', SURFACE_CODE],
                                                    work)
        try:
            t1 = perf_counter()
            check_masked_ridge(device)
            walls['(b) masked_ridge'] = perf_counter() - t1
            outs = {}
            for what, child in children.items():
                outs[what], walls[what] = finish_child(what, child, t0)
        finally:
            for child in children.values():
                if child.poll() is None:
                    child.kill()
                    child.wait()
    check_surface_child(outs['(a) surface child'],
                        walls['(a) surface child'])
    for tag in ('tracked', 'phases'):
        log(f'[surface] (c) python -m insite_tpu_torch.seed_gaps on the '
            f'{tag} logs, {walls[f"(c) seed_gaps {tag}"]:.4f} s:')
        counts = check_gap_table(tag, outs[f'(c) seed_gaps {tag}'])
        cell = outs[f'(c) seed_gaps {tag} --next-cell'].strip()
        log(f'[surface] (c) --next-cell on the {tag} logs: {cell!r}, '
            f'{walls[f"(c) seed_gaps {tag} --next-cell"]:.4f} s')
        if cell and len(cell.split()) != 6:
            raise AssertionError(f'--next-cell printed {cell!r}')
        if tag == 'phases':
            short = [k for k in ((m, ds) for m in ('sindy', 'insite')
                                 for ds in DATASETS) if counts[k] < 1]
            if short:
                raise AssertionError(f'phase 5\'s cells {short} counted 0')
    log(f'[surface] (d) phase 16\'s bench child {bench_child_s:.4f} s from '
        f'its start; before the exports {BENCH_CHILD_BEFORE_S:.4f} s')
    return walls


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
    sindy_family_cases = family_cases(device)
    # the noise sweep's dataset: its fits keep a smaller support than
    # EQ_4_D's, so its launches have a Kr of their own
    n_case, one_case = table_cases('EQ_4_B', device, (14, 15))
    assert len(n_case['active_idx']) < len(n_step_case['active_idx'])
    insight_cases = {'insight_eq4b_nstep': n_case,
                     'insight_eq4b_1step_shared': one_case}
    # phase 11's seed-stacked batches: per-row models of 10 supports
    stacked = stacked_cases(device)
    # phase 17's half of the n-step set: one of two shards
    half_shard = {'nstep_half_shard_b29500_t64': dict(
        n_step_case, **{k: n_step_case[k][:29_500]
                        for k in ('coefs', 'y0', 'statics', 'arms')})}
    # phase 13's lam tune: the validation cohort once per grid value
    tune_cases = {'tuning_b700': tuning_case(device)}
    log('[kernels] device time per call, f32, before any plain version '
        'runs')
    dev_times = kernel_times({'northstar': northstar_case,
                              'nstep_b59000_t64': n_step_case,
                              '1step_shared_b11800_t59': one_step_case,
                              'degree4_f35_kr16_b10000_t59': degree4_case,
                              **tumor_cases, **sindy_family_cases,
                              **insight_cases, **stacked, **tune_cases,
                              **half_shard},
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
    shaped = {tag: run_kernel_case(
        f'{tag} B={case["arms"].shape[0]} T={case["arms"].shape[1]} '
        f'Kr={len(case["active_idx"])}', case, device, timed=True)
        for tag, case in {**tumor_cases, **sindy_family_cases,
                          **insight_cases, **stacked, **tune_cases,
                          **half_shard}.items()}
    fold_res = {tag: run_fold_case(
        f'{tag} vs plain joint B={len(case["y0"])} '
        f'T={case["arms"].shape[1]}', case['joint'], device)
        for tag, case in sindy_family_cases.items()
        if 'joint' in case and 'nstep' in tag}
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

    # the logs of phases 5, 6, 8 and 11, read by phase 16's CLIs
    kept = tempfile.TemporaryDirectory()
    kept_logs = {name: f'{kept.name}/{name}.txt'
                 for name in ('table', 'tumor', 'vectorized')}

    # 5. main table
    log('[table] sweep: sindy, insite x EQ_4_A..D, 1 seed, 1000/100/100')
    table_launches, table_rows = run_main_table(device, kept_logs['table'])
    log('[table] card f32 against host f64, one EQ_4_D collection')
    check_card_against_host(device)

    # 6. tumor main table
    log('[tumor] sweep: sindy, insite x cancer_sim, EQ_5_A..D, seed 0, '
        '1000/100/100')
    tumor_launches = run_tumor_table(device, kept_logs['tumor'])
    log('[tumor] card f32 against host f64, one cancer_sim collection')
    check_card_against_host(device, 'cancer_sim')

    # 7. the rest of the SINDy family
    family_launches = run_sindy_family(device)

    # 8. msm on both families, the three INSIGHT sweeps
    msm_launches = run_msm_table(device)
    insight_launches = run_insight_sweeps(device, kept.name)
    log('[insight] card f32 against host f64, one EQ_4_D collection of 50 '
        'training patients')
    check_card_against_host(device, 'EQ_4_D', n_train=50)

    # 9. ct and crn on both families
    insite_one_step = next(
        r['encoder_test_rmse_orig'] for r in table_rows
        if (r['dataset_name'], r['method_name']) == ('EQ_4_D', 'insite'))
    neural_launches = run_neural(device, insite_one_step, NEURAL_METHODS,
                                 'neural')
    log('[neural] card f32 against host f32, one EQ_4_D collection '
        '(200 / 10 / 10), 3 epochs')
    check_neural_card_against_host(device, NEURAL_METHODS)
    log(f'[neural] crn fit, device idle {neural_idle_share()} %')

    # 10. rmsn, gnet and edct on both families
    neural_launches.update(run_neural(device, insite_one_step,
                                      NEURAL_6B_METHODS, 'neural-6b'))
    log('[neural-6b] card f32 against host f32, one EQ_4_D collection '
        '(200 / 10 / 10), 3 epochs')
    check_neural_card_against_host(device, NEURAL_6B_METHODS)

    # 11. the vectorized seed columns
    log(f'[vectorized] vectorized_sweep: {VECTORIZED_SEEDS} seeds a column, '
        '1000/100/100')
    vec_launches, vec_by_column, vec_means = run_vectorized(
        device, table_rows, kept_logs['vectorized'])
    log('[vectorized] card f32 against host f64, one EQ_4_D insite column')
    check_vectorized_card_against_host(device)

    # 12. the neural methods' vectorized seed columns
    t12 = perf_counter()
    log(f'[vectorized-neural] vectorized_sweep: {VECTORIZED_SEEDS} seeds a '
        'column, 1000/100/100')
    vec_neural_launches = run_vectorized_neural(device,
                                                vec_means['EQ_4_D insite'])
    log('[vectorized-neural] card f32 against host f32, 2-seed columns '
        '(EQ_4_D, 200 / 10 / 10), 3 epochs')
    check_vectorized_neural_card_against_host(device)
    log(f'[vectorized-neural] stacked crn encoder fit of a 10-seed column, '
        f'device idle {neural_idle_share("column-fit", "vectorized-neural")}'
        ' %')
    log(f'[vectorized-neural] phase 12 wall {perf_counter() - t12:.4f} s')

    # 13. the sweep harness: tuning, cache, resume, isolation, the sink
    t13 = perf_counter()
    tuned_launches, tune_call, harness_walls = run_harness(device)
    log(f'[harness] phase 13 wall {perf_counter() - t13:.4f} s; by step '
        f'{json.dumps(harness_walls)}')

    # 14. the real-data path: vitals, attention maps, checkpoints
    t14 = perf_counter()
    real_launches, reload_launches, real_walls = run_real_data(device)
    log(f'[real] phase 14 wall {perf_counter() - t14:.4f} s; by step '
        f'{json.dumps(real_walls)}')

    # 15. the BFGS and 'xla' fine-tunes, the legacy simulators, SR3, a trace
    t15 = perf_counter()
    bfgs_launches, xla_launches, slice8_walls = run_slice8(device,
                                                           table_rows)
    log(f'[slice8] phase 15 wall {perf_counter() - t15:.4f} s; by step '
        f'{json.dumps(slice8_walls)}')

    # 16. the repository's own entry points: the bench, the results and
    # figure CLIs, entry()
    t16 = perf_counter()
    bench_launches, entry_launches, entry_walls = run_entry_points(
        device, list(kept_logs.values()),
        f'{kept.name}/INSIGHT_LESS_SAMPLES.txt')
    log(f'[entry] phase 16 wall {perf_counter() - t16:.4f} s; by step '
        f'{json.dumps(entry_walls)}')

    # 17. the batch mesh: sharded runs against unsharded ones, dry runs
    t17 = perf_counter()
    mesh_launches, mesh_walls = run_mesh(device)
    log(f'[mesh] phase 17 wall {perf_counter() - t17:.4f} s; by step '
        f'{json.dumps({k: round(v, 4) for k, v in mesh_walls.items()})}')

    # 18. the public surface: the exports, masked_ridge, seed_gaps
    t18 = perf_counter()
    surface_walls = run_surface(
        device, [kept_logs[k] for k in ('table', 'tumor', 'vectorized')],
        entry_walls['(b) bench child from its start'])
    kept.cleanup()
    log(f'[surface] phase 18 wall {perf_counter() - t18:.4f} s; by step '
        f'{json.dumps({k: round(v, 4) for k, v in surface_walls.items()})}')

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
        for tag, res in shaped.items():
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
            'launches_sindy_family': family_launches[key],
            'launches_msm': msm_launches[key],
            'launches_insight': insight_launches[key],
            'launches_neural': {m: n[key]
                                for m, n in neural_launches.items()},
            'launches_vectorized': vec_launches[key],
            'launches_vectorized_by_column': {
                tag: n[key] for tag, n in vec_by_column.items()},
            'launches_vectorized_neural': {
                m: n[key] for m, n in vec_neural_launches.items()},
            # an insite run with --tune (its 1- and n-step fine-tunes and
            # the lam tune), and one tuning call alone
            'launches_tuning': tuned_launches[key],
            'launches_tuning_call': tune_call[key],
            # the five neural fits on a vitals collection, and a reloaded
            # insite checkpoint's predict call on the EQ_4_D 1-step set
            'launches_real_data': real_launches[key],
            'launches_checkpoint_insite_predict': reload_launches[key],
            # the BFGS insite runs in f32 and f64 (one sensitivity launch
            # a BFGS evaluation) and the lam tunes under BFGS; the 'xla'
            # route
            'launches_bfgs': {f'{part} {tag}': n[key]
                              for part, by_tag in bfgs_launches.items()
                              for tag, n in by_tag.items()},
            'launches_xla': xla_launches[key],
            # the bench's timed parts (fused: the timed pass and
            # `BENCH_REPEATS` device-time repeats), and entry()
            'launches_bench_fused': bench_launches['fused'][key],
            'launches_bench_standard': bench_launches['standard'][key],
            'launches_entry': entry_launches[key],
            # phase 17: each run unsharded and over the mesh (sharded =
            # shards x unsharded, asserted), and the dry runs
            'launches_mesh': {tag: n[key]
                              for tag, n in mesh_launches.items()},
            'max_abs_err': main_case['f32'][err],
            'ms': main_case['times'][f'{key}_ms'],
            'plain_ms': main_case['times'][f'{key}_plain_ms'],
            'bound_ms': dev_times['northstar'][f'{key}_bound_ms'],
            'bound_by': dev_times['northstar'][f'{key}_bound_by'],
            # no single PyTorch call computes the recurrence
            'library_ms': None,
            'ms_b2048_t60': profile['times'][f'{key}_ms'],
            'plain_ms_b2048_t60': profile['times'][f'{key}_plain_ms'],
            **{f'max_abs_err_{tag}_vs_plain_joint': res['f32'][err]
               for tag, res in fold_res.items()},
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
