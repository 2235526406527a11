"""Drives `insite_tpu_torch.harness.northstar.fused_northstar`: one task is
one cohort of ``patients_per_task`` patients simulated from the task's
seed, its ODE discovered and fine-tuned per patient, and scored.

Layers (spans around the port's functions): collection =
`northstar.simulate_cohort`; fit = `northstar.design_qr` and
`northstar.stlsq_from_qr`; prediction = the Levenberg-Marquardt fine-tune
`northstar.insite_gn_finetune_predict` (both kernels). The metric stage is
in no layer.

Judged for each checked task, against `reference/<config reference>.py`
in float64: the cohort (trajectories, arms and lengths) from the task's
seed; the global coefficients and their support fitted on the program's
cohort; the fine-tuned predictions from the program's cohort and
coefficients; the RMSEs of the program's predictions.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchmark.tracing import Hooks
from benchmark.yardstick import finetune_work


class Entry:
    def __init__(self, config: dict, traffic: dict, device, patients=None):
        import torch
        from insite_tpu_torch.harness import northstar
        self.northstar = northstar
        self.cfg, self.traffic, self.device = config, traffic, device
        self.n = int(patients or traffic['patients_per_task'])
        self.ph = int(traffic['projection_horizon'])
        self.dtype = getattr(torch, config['dtype'])
        self.ref = importlib.import_module(
            f'benchmark.reference.{config["reference"]}')
        self.hooks = Hooks([
            (northstar, 'simulate_cohort', 'collection', 'cohort'),
            (northstar, 'design_qr', 'fit', None),
            (northstar, 'stlsq_from_qr', 'fit', None),
            (northstar, 'insite_gn_finetune_predict', 'predict', None),
        ], device)

    def task(self, seed: int):
        """(patients, outputs, work) of one cohort."""
        c = self.cfg
        r = self.northstar.fused_northstar(
            self.n, seed=seed, equation_name=c['dataset'],
            conf_coeff=c['gamma'], seq_length=c['seq_length'],
            threshold=c['threshold'], alpha=c['alpha'], lam=c['lam'],
            gn_iters=c['gn_iters'], projection_horizon=self.ph,
            max_stlsq_iter=c['max_stlsq_iter'], dtype=self.dtype,
            device=self.device)
        out = {'seed': seed, 'cohort': self.hooks.kept.pop('cohort'),
               'coefs': np.asarray(r['coefs']), 'preds': r['preds'],
               'rmse': (r['rmse_orig'], r['rmse_all'])}
        return self.n, out, self.work(out['coefs'])

    def work(self, coefs):
        """The ODE passes of a cohort's fine-tune (`finetune_work`)."""
        return finetune_work(self.cfg, self.ref, coefs,
                             [(self.n, self.cfg['seq_length'] - 1)])

    # ------------------------------------------------------------------
    # correctness

    def _dt(self):
        return self.ref.MAX_TIME_HORIZON / self.cfg['seq_length']

    @staticmethod
    def _rows(vol, treat):
        """The fine-tune's rows: the observed states before each step and
        each step's arm."""
        T = vol.shape[1] - 1
        return vol[:, :T], treat[:, :T]

    def judge(self, out: dict) -> dict:
        """The numbers compared for one task's outputs (the program's, or
        the control's in their place)."""
        import torch
        ref, c, f64 = self.ref, self.cfg, torch.float64
        vol, statics, treat, lengths = out['cohort']
        dev = vol.device
        r_vol, r_stat, r_treat, r_len, edge = ref.simulate(
            self.n, out['seed'], c['dataset'], c['gamma'], c['seq_length'],
            device=dev, dtype=f64, with_edges=True)
        same = (treat[:, 0].to(f64) == r_treat[:, 0]) & (lengths == r_len)
        gap = torch.cat([(vol.to(f64) - r_vol).abs()[same].reshape(-1),
                         (statics.to(f64) - r_stat).abs()[same].reshape(-1)])
        readings = {
            'collection_mismatch': int((~same & ~edge).sum()),
            'collection_gap': float(gap.max()) / ref.MAX_VALUE if len(gap)
            else 0.0,
        }
        coefs = torch.as_tensor(out['coefs'], device=dev).to(f64)
        r_coefs = ref.fit(vol, statics, treat, lengths, c['threshold'],
                          c['alpha'], c['seq_length'],
                          max_iter=c['max_stlsq_iter'])
        readings['support_mismatch'] = int(((coefs != 0) != (r_coefs != 0))
                                           .sum())
        readings['coef_gap'] = float((coefs - r_coefs).abs().max()
                                     / r_coefs.abs().max().clamp(min=1e-30))
        prev, arms = self._rows(vol, treat)
        r_preds = ref.finetune(prev, statics, arms, lengths, out['coefs'],
                               c['lam'], c['gn_iters'], self.ph, self._dt())
        T = r_preds.shape[1]
        on = torch.arange(T, device=dev)[None] < lengths[:, None]
        diff = torch.where(on, (out['preds'].to(f64) - r_preds).abs(), 0.0)
        readings['predict_gap'] = float(diff.max()) / ref.MAX_VALUE
        r_rmse = ref.factual_rmse(out['preds'], vol, lengths)
        readings['rmse_gap'] = max(abs(a - b) / b for a, b in
                                   zip(out['rmse'], r_rmse))
        return readings

    def control(self, seed: int, dtype) -> dict:
        """The reference in the program's place, computed in ``dtype``:
        outputs in the program's form."""
        import torch
        ref, c = self.ref, self.cfg
        vol, statics, treat, lengths = ref.simulate(
            self.n, seed, c['dataset'], c['gamma'], c['seq_length'],
            device=self.device, dtype=dtype)
        cohort = (vol.to(self.dtype), statics.to(self.dtype),
                  treat.to(self.dtype), lengths)
        coefs = ref.fit(*cohort, c['threshold'], c['alpha'],
                        c['seq_length'], dtype=dtype,
                        max_iter=c['max_stlsq_iter'])
        coefs = coefs.to(torch.float32).cpu().numpy()
        vol, statics, treat, lengths = cohort
        prev, arms = self._rows(vol, treat)
        preds = ref.finetune(prev, statics, arms, lengths, coefs, c['lam'],
                             c['gn_iters'], self.ph, self._dt(), dtype=dtype)
        rmse = ref.factual_rmse(preds, cohort[0], lengths, dtype=dtype)
        return {'seed': seed, 'cohort': cohort, 'coefs': coefs,
                'preds': preds.to(self.dtype), 'rmse': rmse}
