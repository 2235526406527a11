"""Drives `insite_tpu_torch.harness.runner.run_experiment(dataset, 'insite',
seed, gamma, RunConfig(metrics_jsonl=''))`: one task is one main-table
run, the paper's sizes (train / val / test patients from the
configuration) simulated from the task's seed, processed, fitted,
fine-tuned and scored at 1 and 2..ph+1 steps.

Layers (spans around the port's functions): collection =
`runner._collection_for`; processing = `runner._build_model` (the
collection's processing and the estimator); fit = `SINDyRegressor.fit`;
prediction = `SINDyRegressor.get_predictions` and
`get_autoregressive_predictions` (the fine-tunes, both kernels). The
metrics are in no layer.

Judged for each checked task against `reference/<config reference>.py`,
layer by layer, each from the program's output of the layer before: the
four raw subsets from the task's seed; their processing and the training
scaling; the global coefficients and support; the 1-step and n-step
predictions; the RMSEs of the program's predictions.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchmark.reference import rmse as protocol
from benchmark.tracing import Hooks
from benchmark.yardstick import finetune_work

SUBSETS = ('train_f', 'val_f', 'test_cf_one_step', 'test_cf_treatment_seq')
PROCESSED = ('prev_outputs', 'static_features', 'current_treatments',
             'outputs', 'active_entries')


class Entry:
    def __init__(self, config: dict, traffic: dict, device, patients=None):
        import torch
        from insite_tpu_torch.harness import runner
        from insite_tpu_torch.harness.config import RunConfig
        from insite_tpu_torch.models.sindy import SINDyRegressor
        self.runner = runner
        self.cfg, self.traffic, self.device = config, traffic, device
        self.sizes = dict(patients or {'train': config['train_samples'],
                                       'val': config['val_samples'],
                                       'test': config['test_samples']})
        self.run_cfg = RunConfig(metrics_jsonl='',
                                 train_samples=self.sizes['train'],
                                 val_samples=self.sizes['val'],
                                 test_samples=self.sizes['test'])
        self.dtype = getattr(torch, config['dtype'])
        self.ph = int(config['projection_horizon'])
        self.ref = importlib.import_module(
            f'benchmark.reference.{config["reference"]}')
        self.hooks = Hooks([
            (runner, '_collection_for', 'collection', 'coll'),
            (runner, '_build_model', 'processing', None),
            (SINDyRegressor, 'fit', 'fit', 'model'),
            (SINDyRegressor, 'get_predictions', 'predict', 'preds_1'),
            (SINDyRegressor, 'get_autoregressive_predictions', 'predict',
             'preds_n'),
        ], device)

    def task(self, seed: int):
        """(patients, outputs, work) of one main-table run."""
        result = self.runner.run_experiment(
            self.cfg['dataset'], self.cfg['method'], seed,
            self.cfg['gamma'], self.run_cfg, device=self.device,
            dtype=self.dtype)
        kept = self.hooks.kept
        coll, model = kept.pop('coll'), kept.pop('model')
        out = {'seed': seed,
               'subsets': {k: view(getattr(coll, k)) for k in SUBSETS},
               'scaling': coll.train_scaling_params,
               'coefs': np.asarray(model.coefs),
               'preds_1': kept.pop('preds_1'), 'preds_n': kept.pop('preds_n'),
               'result': result}
        return sum(self.sizes.values()), out, self.work(out)

    def work(self, out):
        """The ODE passes of the two test sets' fine-tunes
        (`finetune_work`)."""
        return finetune_work(self.cfg, self.ref, out['coefs'], [
            out['subsets'][name]['prev_outputs'].shape[:2]
            for name in ('test_cf_one_step', 'test_cf_treatment_seq')])

    # ------------------------------------------------------------------
    # correctness

    def _dt(self):
        return self.ref.MAX_TIME_HORIZON / self.cfg['seq_length']

    def judge(self, out: dict) -> dict:
        """The numbers compared for one task's outputs (the program's, or
        the control's in their place), layer by layer."""
        readings = {}
        for stage in (self._collection, self._processing, self._fit,
                      self._predictions, self._metrics):
            readings.update(stage(out))
        return readings

    def _collection(self, out: dict) -> dict:
        """The four raw subsets against the reference's, from the
        task's seed."""
        import torch
        ref, c, f64 = self.ref, self.cfg, torch.float64
        norm = ref.NORM
        readings = {'collection_mismatch': 0, 'collection_gap': 0.0}
        expected = ref.subsets(self.sizes, out['seed'], c['dataset'],
                               c['gamma'], c['seq_length'], self.ph,
                               device=self.device)
        for name in SUBSETS:
            raw = out['subsets'][name]['raw']
            rows, edge, pid = (x.cpu() if hasattr(x, 'cpu') else x
                               for x in expected[name])
            n = self.sizes['train' if name == 'train_f' else
                           'val' if name == 'val_f' else 'test']
            # a patient whose rows differ in number (a stop on another
            # day) is a mismatch; the others' rows align one to one
            p_pid = ref.patient_of(name, raw, n)
            counts = (torch.bincount(p_pid, minlength=n)[:n] ==
                      torch.bincount(pid, minlength=n))
            edge_p = torch.zeros(n, dtype=torch.bool)
            edge_p[pid[edge]] = True
            readings['collection_mismatch'] += int((~counts & ~edge_p).sum())
            keep_p, keep_r = counts[p_pid.clamp(max=n - 1)], counts[pid]
            if len(p_pid) and int(p_pid.max()) >= n:
                readings['collection_mismatch'] += 1
                continue
            got = {k: torch.as_tensor(np.asarray(raw[k])).to(f64)[keep_p]
                   for k in ref.RAW_KEYS}
            want = {k: v.cpu()[keep_r].to(f64) for k, v in rows.items()}
            edge = edge[keep_r]
            same = torch.ones(len(edge), dtype=torch.bool)
            for k in ref.EXACT_KEYS:
                eq = got[k] == want[k]
                same &= eq.all(1) if eq.ndim == 2 else eq
            readings['collection_mismatch'] += int((~same & ~edge).sum())
            same &= ~edge
            for k in ref.RAW_KEYS:
                if k not in ref.EXACT_KEYS and same.any():
                    gap = float((got[k] - want[k]).abs()[same].max()) / norm
                    readings['collection_gap'] = max(
                        readings['collection_gap'], gap)
        return readings

    def _processing(self, out: dict) -> dict:
        """The scaling and the processed arrays, from the program's raw
        subsets."""
        import torch
        ref, f64 = self.ref, torch.float64
        sc = ref.scaling(out['subsets']['train_f']['raw'])
        p_sc = out['subsets']['train_f']['scaling']
        gap = max(float(((torch.as_tensor(p_sc[k]).to(f64) - sc[k]).abs()
                         / sc[k].abs()).max()) for k in ('means', 'stds'))
        for name in SUBSETS:
            v = out['subsets'][name]
            ph = self.ph if name == 'test_cf_treatment_seq' else None
            want = ref.process(v['raw'], sc, ph)
            for ours, theirs in (('prev_outputs', 'prev_outputs'),
                                 ('statics', 'static_features'),
                                 ('treatments', 'current_treatments'),
                                 ('outputs', 'outputs'),
                                 ('active', 'active_entries'),
                                 ('window_outputs', 'window_outputs')):
                if ours in want:
                    got = torch.as_tensor(v[theirs]).to(f64).reshape(
                        want[ours].shape)
                    gap = max(gap, float((got - want[ours]).abs().max()))
        return {'processing_gap': gap}

    def _fit(self, out: dict) -> dict:
        """The global coefficients and support, from the program's
        processed training set."""
        import torch
        ref, c, f64 = self.ref, self.cfg, torch.float64
        readings = {}
        train = out['subsets']['train_f']
        sc = {k: torch.as_tensor(v).to(f64)
              for k, v in train['scaling'].items()}
        prev, statics = ref.unscaled(_squeeze(train['prev_outputs']),
                                     train['static_features'], sc)
        outputs = _squeeze(train['outputs']) * sc['stds'][0] + \
            sc['means'][0]
        vol = torch.cat([prev[:, :1], outputs], 1).to(self.device)
        arms = torch.as_tensor(
            np.argmax(train['current_treatments'], -1)).to(self.device)
        lengths = torch.as_tensor(train['sequence_lengths']).to(
            torch.int64).to(self.device)
        r_coefs = ref.fit(vol, statics.to(self.device), arms, lengths,
                          c['threshold'], c['alpha'], c['seq_length'],
                          n_arms=ref.N_ARMS, max_iter=c['max_stlsq_iter'])
        coefs = torch.as_tensor(out['coefs']).to(self.device, f64)
        readings['support_mismatch'] = int(((coefs != 0) != (r_coefs != 0))
                                           .sum())
        readings['coef_gap'] = float((coefs - r_coefs).abs().max()
                                     / r_coefs.abs().max().clamp(min=1e-30))
        return readings

    def _predict(self, v: dict, sc: dict, coefs, ph: int, dtype):
        """The reference's predictions of a processed test set ``v``
        (unscaled with ``sc``) by the fine-tune of global model ``coefs``
        in ``dtype``: the 1-step set's [N, T-1] (0 from each row's
        length on), or the n-step set's last ``ph`` steps [N, ph]; and
        the rows' lengths."""
        import torch
        ref, c = self.ref, self.cfg
        prev, statics = ref.unscaled(_squeeze(v['prev_outputs']),
                                     v['static_features'], sc)
        arms = torch.as_tensor(np.argmax(v['current_treatments'], -1))
        n = torch.as_tensor(np.asarray(v['sequence_lengths'])).to(
            torch.int64)
        r = ref.finetune(prev.to(self.device, dtype),
                         statics.to(self.device, dtype),
                         arms.to(self.device), n.to(self.device), coefs,
                         c['lam'], c['gn_iters'], ph, self._dt(),
                         dtype=dtype, y_clip=ref.Y_CLIP).cpu()
        if ph > 1:
            win = torch.clamp(n - ph, min=1)[:, None] + torch.arange(ph)[None]
            return torch.gather(r, 1, win), n
        return torch.where(torch.arange(r.shape[1])[None] < n[:, None], r,
                           0.0), n

    def _predictions(self, out: dict) -> dict:
        """The 1-step and n-step predictions, from the program's test
        sets and coefficients."""
        import torch
        ref, f64 = self.ref, torch.float64
        gaps = []
        for name, ph, key in (('test_cf_one_step', 1, 'preds_1'),
                              ('test_cf_treatment_seq', self.ph,
                               'preds_n')):
            v = out['subsets'][name]
            vsc = {k: torch.as_tensor(x).to(f64)
                   for k, x in v['scaling'].items()}
            r, n = self._predict(v, vsc, out['coefs'], ph, f64)
            got = _squeeze(out[key]) * vsc['stds'][0] + vsc['means'][0]
            on = (torch.ones_like(r, dtype=torch.bool) if ph > 1 else
                  torch.arange(r.shape[1])[None] < n[:, None])
            gaps.append(float(torch.where(on, (got - r).abs(), 0.0).max()))
        return {'predict_gap': max(gaps) / ref.NORM}

    def _metrics(self, out: dict) -> dict:
        """The RMSEs, from the program's predictions and test sets."""
        import torch
        f64, norm = torch.float64, self.ref.NORM
        res = out['result']
        v = out['subsets']['test_cf_one_step']
        vsc = {k: torch.as_tensor(x).to(f64) for k, x in v['scaling'].items()}
        pred = _squeeze(out['preds_1']) * vsc['stds'][0] + vsc['means'][0]
        target = _squeeze(v['outputs']) * vsc['stds'][0] + vsc['means'][0]
        want = protocol.one_step(pred, target, _squeeze(v['active_entries']),
                                 norm)
        got = [res[f'encoder_test_rmse_{k}'] for k in ('orig', 'all', 'last')]
        v = out['subsets']['test_cf_treatment_seq']
        pred = _squeeze(out['preds_n']) * vsc['stds'][0] + vsc['means'][0]
        target = _squeeze(v['window_outputs']) * vsc['stds'][0] + \
            vsc['means'][0]
        want += tuple(protocol.n_step(pred, target, torch.ones_like(target),
                                      norm))
        got += [res[f'decoder_test_rmse_{k + 2}-step']
                for k in range(self.ph)]
        return {'rmse_gap': max(abs(a - b) / b for a, b in zip(got, want))}

    def control(self, seed: int, dtype) -> dict:
        """The reference in the program's place, computed in ``dtype``:
        outputs in the program's form."""
        import torch
        ref, c = self.ref, self.cfg
        subsets = ref.subsets(self.sizes, seed, c['dataset'], c['gamma'],
                              c['seq_length'], self.ph, device=self.device,
                              dtype=dtype)
        raws = {k: {n: x.to(self.dtype).cpu().numpy()
                    for n, x in rows.items()}
                for k, (rows, _, _) in subsets.items()}
        sc = ref.scaling(raws['train_f'], dtype=dtype)
        views = {}
        for name in SUBSETS:
            ph = self.ph if name == 'test_cf_treatment_seq' else None
            p = ref.process(raws[name], sc, ph, dtype=dtype)
            views[name] = {
                'raw': raws[name],
                'scaling': {k: v.float().numpy() for k, v in sc.items()},
                'prev_outputs': p['prev_outputs'][..., None].float().numpy(),
                'static_features': p['statics'].float().numpy(),
                'current_treatments': p['treatments'].float().numpy(),
                'outputs': p['outputs'][..., None].float().numpy(),
                'active_entries': p['active'][..., None].float().numpy(),
                'sequence_lengths': raws[name]['sequence_lengths']}
            if ph:
                views[name]['window_outputs'] = \
                    p['window_outputs'][..., None].float().numpy()
        train = views['train_f']
        prev, statics = ref.unscaled(_squeeze(train['prev_outputs']),
                                     train['static_features'], sc)
        outputs = _squeeze(train['outputs']) * sc['stds'][0] + sc['means'][0]
        vol = torch.cat([prev[:, :1], outputs.to(prev.dtype)], 1)
        coefs = ref.fit(vol.to(self.device, dtype),
                        statics.to(self.device, dtype),
                        torch.as_tensor(np.argmax(
                            train['current_treatments'], -1)).to(self.device),
                        torch.as_tensor(train['sequence_lengths']).to(
                            self.device, torch.int64),
                        c['threshold'], c['alpha'], c['seq_length'],
                        dtype=dtype, n_arms=ref.N_ARMS,
                        max_iter=c['max_stlsq_iter'])
        coefs = coefs.float().cpu().numpy()
        preds = {}
        result = {}
        for name, ph, key in (('test_cf_one_step', 1, 'preds_1'),
                              ('test_cf_treatment_seq', self.ph,
                               'preds_n')):
            v = views[name]
            r, _ = self._predict(v, sc, coefs, ph, dtype)
            z = (r.to(dtype) - sc['means'][0].to(dtype)) / \
                sc['stds'][0].to(dtype)
            preds[key] = z[..., None].float().numpy()
            target = _squeeze(v['window_outputs' if ph > 1 else 'outputs'])
            u = z.double() * sc['stds'][0].double() + sc['means'][0].double()
            t = target * sc['stds'][0].double() + sc['means'][0].double()
            if ph == 1:
                orig, pooled, last = protocol.one_step(
                    u.to(dtype).double(), t,
                    _squeeze(v['active_entries']), ref.NORM)
                result.update(encoder_test_rmse_orig=orig,
                              encoder_test_rmse_all=pooled,
                              encoder_test_rmse_last=last)
            else:
                for k, x in enumerate(protocol.n_step(
                        u.to(dtype).double(), t, torch.ones_like(t),
                        ref.NORM)):
                    result[f'decoder_test_rmse_{k + 2}-step'] = x
        return {'seed': seed, 'subsets': views, 'coefs': coefs,
                'preds_1': preds['preds_1'], 'preds_n': preds['preds_n'],
                'result': result}


def _squeeze(x):
    """[N, T, 1] or [N, T] arrays as a float64 tensor [N, T]."""
    import torch
    x = torch.as_tensor(np.asarray(x)).double()
    return x[..., 0] if x.ndim == 3 else x


def view(ds) -> dict:
    """What the judge reads of one of the program's processed subsets: its
    raw simulated arrays, the arrays the model and the metrics read, and
    the scaling it was processed with (references, no copies)."""
    d = ds.data
    sp = ds.scaling_params
    S = d['static_features'].shape[-1]
    out = {'raw': d, 'sequence_lengths': d['sequence_lengths'],
           'scaling': {'means': np.asarray(sp['input_means'])[:1 + S],
                       'stds': np.asarray(sp['inputs_stds'])[:1 + S]},
           **{k: d[k] for k in PROCESSED}}
    seq = getattr(ds, 'data_processed_seq', None)
    if seq is not None:
        out['window_outputs'] = seq['outputs']
    return out
