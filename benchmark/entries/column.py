"""Drives the tumour family's vectorized seed column
(`insite_tpu_torch.harness.vectorized`): one task is ``seeds_per_task``
seeds, each a fresh seed derived from the task's, turned into cohorts by
`tumor_draws` and `tumor_cohort` and run as one column by `column` (the
global models of all seeds by the masked-ridge STLSQ, then every seed's
1-step rows in one fine-tune and its n-step rows in another, each row
with its own seed's model). The calls of `vectorized_tumor_sweep`, which
always runs seeds 0..9.

Layers (spans around the port's functions): collection = `tumor_draws`
and `tumor_cohort`; fit = `discover_column`; prediction =
`evaluate_column` (the fine-tunes, both kernels, and the per-seed
RMSEs).

Judged for each checked task against `reference/<config reference>.py`,
layer by layer, each from the program's output of the layer before: every
seed's cohorts from its seed; each seed's global coefficients and support
fitted on the program's training cohort; the 1-step and n-step predictions
of the valid rows; the per-seed RMSEs of the program's predictions.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchmark.run import task_seed
from benchmark.tracing import Hooks
from benchmark.yardstick import finetune_work

SETS = ('one_step', 'n_step')


class Entry:
    def __init__(self, config: dict, traffic: dict, device, patients=None):
        import torch
        from insite_tpu_torch.harness import vectorized
        self.vec = vectorized
        self.cfg, self.traffic, self.device = config, traffic, device
        sizes = patients or {'train': config['train_samples'],
                             'test': config['test_samples'],
                             'seeds': traffic['seeds_per_task']}
        self.n_train, self.n_test = sizes['train'], sizes['test']
        self.S = int(sizes['seeds'])
        self.dtype = getattr(torch, config['dtype'])
        self.ph = int(config['projection_horizon'])
        self.ref = importlib.import_module(
            f'benchmark.reference.{config["reference"]}')
        self.hooks = Hooks([
            (vectorized, 'tumor_draws', 'collection', None),
            (vectorized, 'tumor_cohort', 'collection', '+cohorts'),
            (vectorized, 'discover_column', 'fit', None),
            (vectorized, 'evaluate_column', 'predict', None),
            (vectorized, '_predict', 'predict', '+preds'),
        ], device)

    def task(self, seed: int):
        """(patients, outputs, work) of one column."""
        c, T, ph = self.cfg, self.cfg['seq_length'], self.ph
        seeds = [task_seed(seed, j) for j in range(self.S)]
        cohorts = [self.vec.tumor_cohort(
            self.vec.tumor_draws(s, c['dataset'], self.n_train, self.n_test,
                                 T, c['gamma'], ph, device=self.device,
                                 dtype=self.dtype), T, ph) for s in seeds]
        res = self.vec.column(cohorts, family='tumor', method=c['method'],
                              threshold=c['threshold'], alpha=c['alpha'],
                              lam=c['lam'], projection_horizon=ph,
                              gn_iters=c['gn_iters'])
        kept = self.hooks.kept
        kept.pop('cohorts', None)
        preds_1, preds_n = kept.pop('preds')
        out = {'seeds': seeds, 'cohorts': cohorts,
               'coefs': np.asarray(res['global_coefs']),
               'preds_1': preds_1, 'preds_n': preds_n, 'result': res}
        return self.S * (self.n_train + self.n_test), out, self.work(out)

    def work(self, out):
        """The ODE passes of the column (`finetune_work` over the seeds'
        union of supports): the fine-tune of every 1-step row and of the
        first n-step row of each (patient, prefix), then one rollout of
        every n-step row."""
        B1 = sum(len(c['one_step'][0]) for c in out['cohorts'])
        B2 = sum(len(c['n_step'][0]) for c in out['cohorts'])
        T1 = self.cfg['seq_length'] - 1
        T2 = T1 + self.ph
        return finetune_work(self.cfg, self.ref, out['coefs'],
                             [(B1, T1), (B2 // (2 * self.ph), T2)],
                             rollouts=[(B2, T2)])

    # ------------------------------------------------------------------
    # correctness

    def _dt(self):
        return self.ref.MAX_TIME_HORIZON / self.cfg['seq_length']

    def _expected(self, seed, dtype=None):
        import torch
        return self.ref.column_cohort(
            seed, self.n_train, self.n_test, self.cfg['seq_length'],
            self.cfg['gamma'], self.ph, device=self.device,
            dtype=dtype or torch.float64)

    def judge(self, out: dict) -> dict:
        """The numbers compared for one task's outputs (the program's, or
        the control's in their place)."""
        import torch
        ref, c, f64 = self.ref, self.cfg, torch.float64
        norm = ref.NORM
        r = {'collection_mismatch': 0, 'collection_gap': 0.0,
             'support_mismatch': 0, 'coef_gap': 0.0}
        for s, seed in enumerate(out['seeds']):
            got, want = out['cohorts'][s], self._expected(seed)
            # train: (vol, arms, lengths, statics); sets: (rows, arms,
            # lengths, statics, valid)
            vol, arms, n, st = got['train']
            wv, wa, wn, ws, edge = want['train']
            same = (arms == wa).all(1) & (n == wn) & (st == ws).all(1)
            r['collection_mismatch'] += int((~same & ~edge).sum())
            same &= ~edge
            if same.any():
                r['collection_gap'] = max(r['collection_gap'], float(
                    (vol.to(f64) - wv)[same].abs().max()) / norm)
            for name in SETS:
                rows, arms, n, st, valid = got[name]
                wr, wa, wn, ws, wvalid, edge = want[name]
                same = ((arms == wa).all(1) & (n == wn) & (st == ws).all(1)
                        & (valid.bool() == wvalid))
                r['collection_mismatch'] += int((~same & ~edge).sum())
                same &= ~edge & wvalid
                if same.any():
                    r['collection_gap'] = max(r['collection_gap'], float(
                        (rows.to(f64) - wr)[same].abs().max()) / norm)
            # fit, from the program's training cohort
            vol, arms, n, st = got['train']
            w = ref.fit_ridge(vol, st, arms, n, c['threshold'], c['alpha'],
                              c['ridge_floor'], c['seq_length'])
            coefs = torch.as_tensor(out['coefs'][s], device=w.device).to(f64)
            r['support_mismatch'] += int(((coefs != 0) != (w != 0)).sum())
            r['coef_gap'] = max(r['coef_gap'], float(
                (coefs - w).abs().max() / w.abs().max().clamp(min=1e-30)))

        # predictions, from the program's rows and every seed's model
        gaps, want_rmse = [], {}
        for name, (pred, rows, n, valid, ph) in self._predict(
                out['cohorts'], out['coefs'], f64).items():
            got = out['preds_1' if ph == 1 else 'preds_n'].to(f64)
            ok = valid.bool()
            if ph == 1:
                on = (torch.arange(pred.shape[1], device=pred.device)[None]
                      < n[:, None]) & ok[:, None]
                gaps.append(float(torch.where(on, (got - pred).abs(), 0.0)
                                  .max()) / norm)
            else:
                win = (n - ph)[:, None] + torch.arange(ph, device=n.device)
                diff = (got.gather(1, win) - pred.gather(1, win)).abs()
                gaps.append(float(torch.where(ok[:, None], diff, 0.0).max())
                            / norm)
            want_rmse[name] = self._rmses(got, rows, n, valid, ph)
        r['predict_gap'] = max(gaps)
        res = out['result']
        got = [res[f'encoder_test_rmse_{k}'] for k in ('orig', 'all', 'last')]
        got += [res[f'decoder_test_rmse_{k + 2}-step'] for k in range(self.ph)]
        want = list(want_rmse['one_step']) + list(want_rmse['n_step'])
        r['rmse_gap'] = max(float(np.max(np.abs(np.asarray(a) - b) / b))
                            for a, b in zip(got, want))
        return r

    def _predict(self, cohorts, coefs, dtype) -> dict:
        """The reference's predictions of the stacked 1-step and n-step
        rows, each seed's rows with its global model ``coefs`` [S, A, F]
        (the fine-tune over the seeds' union of supports; the n-step rows
        of a (patient, prefix) all roll out the model fine-tuned on its
        first plan), computed in ``dtype``: {set: (preds, rows, lengths,
        valid, horizon)}."""
        import torch
        ref, c = self.ref, self.cfg
        g_all = torch.as_tensor(coefs, device=self.device).to(dtype)
        out = {}
        for name, ph in (('one_step', 1), ('n_step', self.ph)):
            rows, arms, n, st, valid = (
                torch.cat(p) for p in zip(*(co[name] for co in cohorts)))
            g = g_all.repeat_interleave(rows.shape[0] // self.S, 0)
            prev = rows[:, :-1].to(dtype)
            group = 1 if ph == 1 else 2 * ph
            pred, tuned = ref.finetune(
                prev[::group], st[::group], arms[::group], n[::group],
                g[::group], c['lam'], c['gn_iters'], ph, self._dt(),
                dtype=dtype, y_clip=ref.Y_CLIP, with_coefs=True)
            if group > 1:
                pred = ref.rollout(tuned.repeat_interleave(group, 0),
                                   prev[:, 0], st.to(dtype), arms,
                                   self._dt(),
                                   ref.exponents(1 + st.shape[1]),
                                   ref.Y_CLIP)
            out[name] = (pred, rows, n, valid, ph)
        return out

    def _rmses(self, preds, rows, n, valid, ph, dtype=None):
        """Per seed: (orig, all, last) of the 1-step rows (ph 1) or each
        horizon's RMSE of the n-step rows, over the valid rows, in % of the
        normalising constant, computed in ``dtype`` (float64); numpy [S]
        each."""
        import torch
        dtype = dtype or torch.float64
        S, norm = self.S, self.ref.NORM
        target = rows[:, 1:].to(dtype)
        preds = preds.to(dtype)
        ok = valid.to(dtype)
        if ph == 1:
            on = ((torch.arange(target.shape[1], device=n.device)[None]
                   < n[:, None]).to(dtype) * ok[:, None]).reshape(
                       S, -1, target.shape[1])
            err2 = torch.where(on > 0, ((preds - target) ** 2).reshape(
                on.shape), 0.0)
            orig = torch.sqrt((err2.sum(1) / on.sum(1).clamp(min=1.0))
                              .mean(-1))
            pooled = torch.sqrt(err2.sum((1, 2)) / on.sum((1, 2)))
            nxt = torch.cat([on[..., 1:], torch.zeros_like(on[..., :1])], -1)
            last = (on - nxt).clamp(min=0.0)
            final = torch.sqrt((err2 * last).sum((1, 2))
                               / last.sum((1, 2)).clamp(min=1.0))
            return [(x.double() / norm * 100.0).cpu().numpy()
                    for x in (orig, pooled, final)]
        win = (n - ph)[:, None] + torch.arange(ph, device=n.device)
        err2 = torch.where(ok[:, None] > 0, (preds.gather(1, win)
                                             - target.gather(1, win)) ** 2,
                           0.0).reshape(S, -1, ph)
        per = torch.sqrt(err2.sum(1) / ok.reshape(S, -1).sum(1).clamp(
            min=1.0)[:, None])
        return [(per[:, k].double() / norm * 100.0).cpu().numpy()
                for k in range(ph)]

    def control(self, seed: int, dtype) -> dict:
        """The reference in the program's place, computed in ``dtype``:
        outputs in the program's form."""
        ref, c = self.ref, self.cfg
        seeds = [task_seed(seed, j) for j in range(self.S)]
        cohorts, coefs = [], []
        for s in seeds:
            co = self._expected(s, dtype)
            cohorts.append({'train': tuple(x.to(self.dtype) if
                                           x.is_floating_point() else x
                                           for x in co['train'][:4]),
                            **{k: tuple(x.to(self.dtype) if
                                        x.is_floating_point() else x
                                        for x in co[k][:5]) for k in SETS}})
            vol, arms, n, st = cohorts[-1]['train']
            coefs.append(ref.fit_ridge(vol.to(dtype), st.to(dtype), arms, n,
                                       c['threshold'], c['alpha'],
                                       c['ridge_floor'], c['seq_length'],
                                       dtype=dtype).float().cpu().numpy())
        coefs = np.stack(coefs)
        out = {'seeds': seeds, 'cohorts': cohorts, 'coefs': coefs}
        result = {}
        for name, (pred, rows, n, valid, ph) in self._predict(
                cohorts, coefs, dtype).items():
            out['preds_1' if ph == 1 else 'preds_n'] = pred.to(self.dtype)
            vals = self._rmses(pred, rows, n, valid, ph, dtype)
            if ph == 1:
                for k, v in zip(('orig', 'all', 'last'), vals):
                    result[f'encoder_test_rmse_{k}'] = v
            else:
                for k, v in enumerate(vals):
                    result[f'decoder_test_rmse_{k + 2}-step'] = v
        out['result'] = result
        return out
