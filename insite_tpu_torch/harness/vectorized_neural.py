"""Vectorized neural seed columns: each stage of a neural baseline trained
for a whole column of seeds as ONE seed-stacked fit, in the meaning of
`insite_tpu.harness.vectorized_neural`.

The standard path trains each (dataset, seed) run on its own. Here the S
seeds' networks of one stage are one set of parameters with a leading seed
axis (`training.stack_nets`), and every batch of the fit is one
`torch.func.vmap` forward over them and one gradient of the sum of the S
per-seed losses (`training.fit_br_column`, `training.fit_simple_column`).
Each seed's cohort is its standard collection, and its initial weights
are its standard run's (`seeded_net` of the seed, and of seed + 1 .. + 3
for the later stages, as the standard models build them). Everything on
the host between the fits (decoder processing, RMSN's stabilized weights)
and the evaluation protocol stay per seed.

The seeds' data lives on the device, stacked ``[S, N_max, ...]``: rows
are zero-padded to the column's largest seed for training (padded rows
are inactive and so inert under the masked losses, but every seed takes
``N_max // batch_size`` batches) and, for crn's and edct's predictions,
padded with the seed's last real row; padded outputs are dropped through
the per-seed row counts. Prediction runs in chunks of rows.

One generator per column, on the device, draws every batch order and
dropout mask of all its stages: a column repeats bit for bit in one
process, but a seed's row depends on the seeds that share its column
(the JAX package gives each seed a key of its own).

With a ``mesh`` (`parallel.batch_mesh`), the seed axis is split into one
block of consecutive seeds a device (n_seeds a multiple of the mesh size,
as in the JAX package): the collections and stacked data stay on the
mesh's first device, each stage trains one stacked fit a block on the
block's device, and predictions run each block's seeds on its device and
gather them on the first. The column's generator draws the batch orders
of all seeds, each block taking its slice, so a sharded column takes the
unsharded column's batches; the dropout masks come from one generator a
block. With dropout 0 a sharded column is the unsharded one; with dropout
on it differs in its masks (and so in every later draw).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.data.collection import make_collection
from insite_tpu_torch.eval.metrics import (normalised_masked_rmse,
                                           normalised_n_step_rmses)
from insite_tpu_torch.models import crn, ct, edct, gnet, rmsn
from insite_tpu_torch.models.nn.training import (
    bases_on, encoder_decoder_train_configs, fit_br_column, fit_simple_column,
    merge_by_mask, seeded_net, stack_nets, stacked_call, treatment_head_mask)
from insite_tpu_torch.parallel import seed_blocks

DEFAULT_PATIENTS = {'train': 1000, 'val': 100, 'test': 100}


def _stack_padded(dicts, keys, device, dtype, repeat_pad=False):
    """Stack per-seed data dicts (numpy arrays or tensors) to tensors
    ``[S, N_max, ...]`` of ``dtype`` on ``device``, padding rows with
    zeros, or with ``repeat_pad`` with the seed's last real row (so that no
    padded row is masked everywhere). Returns (stacked, per-seed row
    counts)."""
    n_rows = [len(d[keys[0]]) for d in dicts]
    n_max = max(n_rows)
    out = {}
    for k in keys:
        leaves = []
        for d in dicts:
            v = torch.as_tensor(d[k], dtype=dtype, device=device)
            pad = n_max - len(v)
            if pad:
                filler = v[-1:].expand(pad, *v.shape[1:]) if repeat_pad \
                    else v.new_zeros((pad,) + v.shape[1:])
                v = torch.cat([v, filler])
            leaves.append(v)
        out[k] = torch.stack(leaves)
    return out, n_rows


def _predict_chunked(predict, data: dict, chunk: int):
    """``predict`` over row chunks of ``[S, N, ...]`` tensors, without
    gradients: ``predict`` takes ``[S, chunk, ...]`` tensors and returns a
    tensor or a tuple of tensors ``[S, rows, ...]``, concatenated over the
    chunks."""
    n = next(iter(data.values())).shape[1]
    outs = []
    with torch.no_grad():
        for start in range(0, n, chunk):
            out = predict({k: v[:, start:start + chunk]
                           for k, v in data.items()})
            outs.append(out if isinstance(out, tuple) else (out,))
    cat = tuple(torch.cat(parts, dim=1) for parts in zip(*outs))
    return cat if isinstance(out, tuple) else cat[0]


def _numpy(t):
    return t.cpu().numpy()


def _initial_stack(build, seeds, device) -> tuple:
    """`stack_nets` of one network a seed, ``build()`` with PyTorch's init
    drawn from the seed (`seeded_net`): each seed's initial weights are
    its standard run's. Returns ``(base, params)``."""
    return stack_nets([seeded_net(s, build, device) for s in seeds])


class _ArrayEncoder:
    """Stand-in encoder for `process_data_decoder`: representations and
    predictions computed by the column, keyed by dataset object."""

    def __init__(self):
        self._r, self._p = {}, {}

    def put(self, ds, representations, predictions):
        self._r[id(ds)] = representations
        self._p[id(ds)] = predictions

    def get_representations(self, ds):
        return self._r[id(ds)]

    def get_predictions(self, ds):
        return self._p[id(ds)]


def _collections(dataset_name, seeds, num_patients, coeff, cf_seq_mode,
                 noise_scale, max_seq_length, device, dtype):
    """Each seed's standard collection (multilabel), unprocessed."""
    return [make_collection(dataset_name, dict(num_patients), seed,
                            coeff=float(coeff), treatment_mode='multilabel',
                            cf_seq_mode=cf_seq_mode, noise_scale=noise_scale,
                            max_seq_length=max_seq_length, device=device,
                            dtype=dtype)
            for seed in seeds]


def _config(config_cls, colls, epochs, model_overrides, **fields):
    """The model config of a column: ``epochs``, ``fields`` and the
    dimensions of the processed collections, then ``model_overrides``
    (which win, as in the standard path)."""
    d = colls[0].train_f.data
    return config_cls(**{
        'epochs': epochs, **fields,
        'dim_outcome': d['outputs'].shape[-1],
        'dim_treatments': d['current_treatments'].shape[-1],
        'dim_static_features': d['static_features'].shape[-1],
        **(model_overrides or {})})


class _Column:
    """Where a column's seeds live: ``device`` holds its collections and
    stacked data; ``blocks`` are (device, seed slice) pairs, one a mesh
    device, or the whole column on ``device``; ``gen`` (on ``device``)
    draws the batch orders, and ``block_gens`` the blocks' dropout masks
    (None: ``gen`` draws them too)."""

    def __init__(self, n_seeds: int, seed_start: int, device, mesh):
        if device is None and mesh is None:
            raise TypeError('a column needs device= or mesh=')
        if mesh is None:
            self.device = torch.device(device)
            self.blocks = [(self.device, slice(0, n_seeds))]
        else:
            self.device = mesh[0]
            self.blocks = seed_blocks(n_seeds, mesh)
        self.gen = torch.Generator(device=self.device).manual_seed(
            seed_start)
        self.block_gens = None if mesh is None else [
            torch.Generator(device=d).manual_seed(seed_start + 1 + i)
            for i, (d, _) in enumerate(self.blocks)]

    def split(self, stacked: dict, leaves: bool = False) -> list:
        """``stacked`` ``[S, ...]`` tensors as one dict a block, on its
        device; with ``leaves``, as new leaf tensors that require
        gradients (stacked parameters)."""
        out = []
        for d, sl in self.blocks:
            block = {k: v[sl].detach().to(d) if leaves else v[sl].to(d)
                     for k, v in stacked.items()}
            if leaves:
                block = {k: v.requires_grad_() for k, v in block.items()}
            out.append(block)
        return out

    def seed(self, s: int):
        """(block index, index within the block, device) of seed s."""
        for i, (d, sl) in enumerate(self.blocks):
            if sl.start <= s < sl.stop:
                return i, s - sl.start, d
        raise IndexError(s)


class _Stage:
    """One trained network of a column: its base module and stacked
    parameters a seed block, each on the block's device."""

    def __init__(self, col: _Column, base, params: list):
        self.col = col
        self.bases = bases_on(base, [d for d, _ in col.blocks])
        self.params = params

    def predict(self, make):
        """``make(base, params)`` gives one block's ``predict(batch)``;
        returns the column's: ``batch`` ``[S, rows, ...]`` on the column's
        device, each block's seeds predicted on its device, the outputs
        (a tensor or a tuple) gathered on the column's device."""
        fns = [make(b, p) for b, p in zip(self.bases, self.params)]
        if len(fns) == 1:
            return fns[0]
        lead = self.col.device

        def predict(batch):
            outs = [fn({k: v[sl].to(d) for k, v in batch.items()})
                    for fn, (d, sl) in zip(fns, self.col.blocks)]
            if isinstance(outs[0], tuple):
                return tuple(torch.cat([o[i].to(lead) for o in outs])
                             for i in range(len(outs[0])))
            return torch.cat([o.to(lead) for o in outs])

        return predict

    def seed(self, s: int):
        """(base, parameters, device) of seed s alone."""
        i, j, d = self.col.seed(s)
        return self.bases[i], {k: p[j] for k, p in self.params[i].items()}, d


def _fit_br_stage(build, seeds, train: dict, tc, col: _Column):
    """Build, stack and train one balanced-representation stage for the
    column on ``train`` (`fit_br_column`, one stacked fit a seed block).
    Returns ``predict(batch) -> (outcome, representation)``, seed-vmapped,
    with the classifier's trained parameters and, with ``weights_ema``,
    the EMA of the rest."""
    base, params = _initial_stack(build, seeds, col.device)
    params = col.split(params, leaves=True)
    emas = fit_br_column(base, params, col.split(train), tc, col.gen,
                         col.block_gens)
    params = [{k: p.detach() for k, p in b.items()} for b in params]
    if tc.weights_ema:
        mask = treatment_head_mask(base)
        params = [merge_by_mask(p, e, mask) for p, e in zip(params, emas)]

    def make(b, p):
        return lambda batch: stacked_call(b, p, (batch,))[1:3]

    return _Stage(col, base, params).predict(make)


def _fit_simple_stage(build, seeds, train: dict, loss_fn, tc,
                      col: _Column) -> _Stage:
    """Build, stack and train one single-optimizer network for the column
    on ``train`` (`fit_simple_column`, one stacked fit a seed block)."""
    base, params = _initial_stack(build, seeds, col.device)
    params = col.split(params, leaves=True)
    fit_simple_column(base, params, loss_fn, col.split(train), tc, col.gen,
                      col.block_gens)
    return _Stage(col, base,
                  [{k: p.detach() for k, p in b.items()} for b in params])


def _one_step_metrics(res, colls, preds, n_rows):
    for s, c in enumerate(colls):
        o, a, l = normalised_masked_rmse(c.test_cf_one_step,
                                         preds[s, :n_rows[s]],
                                         one_step_counterfactual=True)
        res['encoder_test_rmse_orig'].append(o)
        res['encoder_test_rmse_all'].append(a)
        res['encoder_test_rmse_last'].append(l)


def _n_step_metrics(res, colls, predicted, n_rows):
    for s, c in enumerate(colls):
        rmses = normalised_n_step_rmses(c.test_cf_treatment_seq,
                                        predicted[s][:n_rows[s]])
        for k, v in enumerate(np.asarray(rmses)):
            res.setdefault(f'decoder_test_rmse_{k + 2}-step',
                           []).append(float(v))


def _new_result() -> dict:
    return {'encoder_test_rmse_orig': [], 'encoder_test_rmse_all': [],
            'encoder_test_rmse_last': []}


def vectorized_ct_sweep(dataset_name: str, n_seeds: int = 10,
                        num_patients: dict = None, coeff: float = 2.0,
                        epochs: int = 100, seed_start: int = 0,
                        eval_chunk: int = 4096,
                        cf_seq_mode: str = 'sliding_treatment',
                        noise_scale: float = 1.0,
                        model_overrides: dict = None,
                        max_seq_length: int = 60, *, device=None,
                        dtype=None, mesh=None) -> dict:
    """A CT column, seeds ``seed_start`` .. + n_seeds - 1, on ``device``
    in ``dtype`` (float32 unless named): one stacked fit, then the 1-step
    and the rolling-origin n-step evaluation of every seed (predictions
    written into ``prev_outputs`` at each seed's own ``future_past_split``).
    Returns the run row's metric keys, one value a seed."""
    dtype = resolve_float(dtype)
    seeds = list(range(seed_start, seed_start + n_seeds))
    col = _Column(n_seeds, seed_start, device, mesh)
    device = col.device
    colls = _collections(dataset_name, seeds,
                         num_patients or DEFAULT_PATIENTS, coeff,
                         cf_seq_mode, noise_scale, max_seq_length, device,
                         dtype)
    for c in colls:
        c.process_data_multi()
    cfg = _config(ct.CTConfig, colls, epochs, model_overrides,
                  treatment_mode='multilabel')
    train, _ = _stack_padded([c.train_f.data for c in colls], ct.BATCH_KEYS,
                             device, dtype)
    predict_br = _fit_br_stage(lambda: ct.CTNetwork(cfg, dtype=dtype), seeds,
                               train, ct.ct_train_config(cfg), col)

    def predict(batch):
        return predict_br(batch)[0]

    res = _new_result()
    one_step, n_rows = _stack_padded(
        [c.test_cf_one_step.data for c in colls], ct.INPUT_KEYS, device,
        dtype)
    _one_step_metrics(res, colls, _numpy(_predict_chunked(
        predict, one_step, eval_chunk)), n_rows)

    ph = cfg.projection_horizon
    seq, seq_rows = _stack_padded([c.test_cf_treatment_seq.data
                                   for c in colls], ct.INPUT_KEYS, device,
                                  dtype)
    S, N = seq['prev_outputs'].shape[:2]
    split = torch.ones((S, N), dtype=torch.int64, device=device)
    for s, c in enumerate(colls):
        split[s, :seq_rows[s]] = torch.as_tensor(
            c.test_cf_treatment_seq.data['future_past_split'].astype(
                np.int64))
    s_idx = torch.arange(S, device=device)[:, None]
    n_idx = torch.arange(N, device=device)[None, :]
    predicted = []
    for t in range(ph + 1):
        out = _predict_chunked(predict, seq, eval_chunk)
        step = out[s_idx, n_idx, split - 1 + t]
        if t < ph:
            seq['prev_outputs'][s_idx, n_idx, split + t] = step
        if t > 0:
            predicted.append(step)
    _n_step_metrics(res, colls, _numpy(torch.stack(predicted, dim=2)),
                    seq_rows)
    return {k: np.asarray(v) for k, v in res.items()}


def vectorized_enc_dec_sweep(method: str, dataset_name: str,
                             n_seeds: int = 10, num_patients: dict = None,
                             coeff: float = 2.0, epochs: int = 100,
                             seed_start: int = 0, eval_chunk: int = 4096,
                             cf_seq_mode: str = 'sliding_treatment',
                             noise_scale: float = 1.0,
                             model_overrides: dict = None,
                             max_seq_length: int = 60, *, device=None,
                             dtype=None, mesh=None) -> dict:
    """A CRN or EDCT column (``method``) on ``device`` in ``dtype``: the
    encoder as one stacked fit; its representations start each seed's
    decoder processing on the host (EDCT keeps every row's
    representations); the decoder as one stacked fit (seeds + 1); then the
    1-step (encoder) and the step-by-step n-step (decoder) evaluation.
    Returns the run row's metric keys, one value a seed."""
    assert method in ('crn', 'edct')
    dtype = resolve_float(dtype)
    seeds = list(range(seed_start, seed_start + n_seeds))
    col = _Column(n_seeds, seed_start, device, mesh)
    device = col.device
    colls = _collections(dataset_name, seeds,
                         num_patients or DEFAULT_PATIENTS, coeff,
                         cf_seq_mode, noise_scale, max_seq_length, device,
                         dtype)
    for c in colls:
        c.process_data_encoder()
    fam = crn if method == 'crn' else edct
    config = crn.CRNConfig if method == 'crn' else edct.EDCTConfig
    cfg = _config(config, colls, epochs, model_overrides,
                  treatment_mode='multilabel')
    build_enc = functools.partial(fam.encoder_network, cfg, dtype)
    build_dec = functools.partial(fam.decoder_network, cfg, dtype)
    enc_tc, dec_tc = encoder_decoder_train_configs(cfg)
    ph = cfg.projection_horizon

    # the encoder column
    enc_train, _ = _stack_padded([c.train_f.data for c in colls],
                                 fam.ENC_KEYS, device, dtype)
    enc_predict = _fit_br_stage(build_enc, seeds, enc_train, enc_tc, col)

    # the encoder's outputs feed each seed's decoder processing
    save_r = method == 'edct'
    shims = [_ArrayEncoder() for _ in seeds]
    for subset in ('train_f', 'val_f', 'test_cf_treatment_seq'):
        ds_list = [getattr(c, subset) for c in colls]
        # the decoder processing's order: the subset processed first
        for c, ds in zip(colls, ds_list):
            c._process(ds)
        stacked, rows = _stack_padded([ds.data for ds in ds_list],
                                      fam.ENC_IN, device, dtype,
                                      repeat_pad=True)
        op, br = map(_numpy, _predict_chunked(enc_predict, stacked,
                                              eval_chunk))
        for s, ds in enumerate(ds_list):
            shims[s].put(ds, br[s, :rows[s]], op[s, :rows[s]])
    for c, shim in zip(colls, shims):
        c.process_data_decoder(shim, save_encoder_r=save_r)

    # the decoder column; EDCT's rows attend over their patient's encoder
    # representations, gathered on the device
    dec_list = []
    for c in colls:
        td = {k: c.train_f.data[k] for k in fam.DEC_KEYS if k != 'encoder_r'}
        if method == 'edct':
            orig = torch.as_tensor(
                c.train_f.data['original_index'].astype(np.int64),
                device=device)
            td['encoder_r'] = torch.as_tensor(
                c.train_f.encoder_r, dtype=dtype, device=device)[orig]
        dec_list.append(td)
    dec_train, _ = _stack_padded(dec_list, list(dec_list[0]), device, dtype)
    dec_predict = _fit_br_stage(build_dec, [s + 1 for s in seeds], dec_train,
                                dec_tc, col)
    del dec_list, dec_train

    res = _new_result()
    one_step, n_rows = _stack_padded(
        [c.test_cf_one_step.data for c in colls], fam.ENC_IN, device, dtype,
        repeat_pad=True)
    op, _ = _predict_chunked(enc_predict, one_step, eval_chunk)
    _one_step_metrics(res, colls, _numpy(op), n_rows)

    ar_list = []
    for c in colls:
        ds = c.test_cf_treatment_seq
        ad = {k: ds.data[k] for k in fam.DEC_IN if k != 'encoder_r'}
        if method == 'edct':
            ad['encoder_r'] = ds.encoder_r
        ar_list.append(ad)
    ar, ar_rows = _stack_padded(ar_list, list(ar_list[0]), device, dtype,
                                repeat_pad=True)
    predicted = []
    for t in range(ph):
        out, _ = _predict_chunked(dec_predict, ar, eval_chunk)
        predicted.append(out[:, :, t])
        if t < ph - 1:
            ar['prev_outputs'][:, :, t + 1] = out[:, :, t]
    _n_step_metrics(res, colls, _numpy(torch.stack(predicted, dim=2)),
                    ar_rows)
    return {k: np.asarray(v) for k, v in res.items()}


def _lstm_output_predict(base, params, with_init_state=False):
    """``predict(batch) -> (output, LSTM output)`` of a stacked RMSN
    network on ``batch['x']`` (and ``batch['init_state']``)."""
    def predict(batch):
        args = (batch['x'], batch['init_state']) if with_init_state \
            else (batch['x'],)
        return stacked_call(base, params, args)
    return predict


def _lstm_output_loss(loss):
    """`fit_simple_column`'s ``loss_fn`` for an RMSN network: ``loss`` of
    its output on ``batch['x']`` (and ``batch['init_state']``)."""
    def loss_fn(net, b, gen):
        out, _ = net(b['x'], b.get('init_state'), gen)
        return loss(out, b)
    return loss_fn


def vectorized_rmsn_sweep(dataset_name: str, n_seeds: int = 10,
                          num_patients: dict = None, coeff: float = 2.0,
                          epochs: int = 100, seed_start: int = 0,
                          eval_chunk: int = 8192,
                          cf_seq_mode: str = 'sliding_treatment',
                          noise_scale: float = 1.0,
                          model_overrides: dict = None,
                          max_seq_length: int = 60, *, device=None,
                          dtype=None, mesh=None) -> dict:
    """An RMSN column on ``device`` in ``dtype``: the four networks
    (propensity-treatment, propensity-history, the SW-weighted encoder and
    decoder; seeds + 0 .. + 3) each one stacked fit; the stabilized
    weights and the decoder processing per seed on the host, as the
    standard path computes them; then the 1-step (encoder) and the
    step-by-step n-step (decoder) evaluation. Returns the run row's metric
    keys, one value a seed."""
    dtype = resolve_float(dtype)
    seeds = list(range(seed_start, seed_start + n_seeds))
    col = _Column(n_seeds, seed_start, device, mesh)
    device = col.device
    colls = _collections(dataset_name, seeds,
                         num_patients or DEFAULT_PATIENTS, coeff,
                         cf_seq_mode, noise_scale, max_seq_length, device,
                         dtype)
    for c in colls:
        c.process_data_encoder()
    cfg = _config(rmsn.RMSNConfig, colls, epochs, model_overrides,
                  treatment_mode='multilabel')
    factories = rmsn.network_factories(cfg, dtype)
    tcs = rmsn.train_configs(cfg)
    ph_steps = cfg.projection_horizon

    def fit(i, data_list, loss):
        stacked, _ = _stack_padded(data_list, list(data_list[0]), device,
                                   dtype)
        return _fit_simple_stage(factories[i], [s + i for s in seeds],
                                 stacked, _lstm_output_loss(loss), tcs[i],
                                 col)

    def extras(data, *keys):
        return {k: data[k] for k in keys}

    # the propensity columns
    train_datas = [c.train_f.data for c in colls]
    bce_loss = rmsn.propensity_loss(cfg.treatment_mode)
    scores = []
    for i, inputs in enumerate((rmsn._propensity_inputs_treat,
                                rmsn._propensity_inputs_hist)):
        stage = fit(i, [{'x': inputs(td),
                         **extras(td, 'current_treatments',
                                  'active_entries')}
                        for td in train_datas], bce_loss)
        stacked, _ = _stack_padded([{'x': inputs(td)} for td in train_datas],
                                   ['x'], device, dtype)
        out, _ = _predict_chunked(stage.predict(_lstm_output_predict),
                                  stacked, eval_chunk)
        scores.append(_numpy(torch.sigmoid(out)))

    # the stabilized weights, per seed on the host
    for s, td in enumerate(train_datas):
        n = len(td['current_treatments'])
        td['stabilized_weights'] = rmsn.stabilized_weights(
            np.asarray(td['current_treatments']), scores[0][s, :n],
            scores[1][s, :n], cfg.sw_mode)
        td['sw_tilde_enc'] = rmsn.clip_normalize_stabilized_weights(
            td['stabilized_weights'], td['active_entries'])

    # the SW-weighted encoder column
    enc_stage = fit(2, [{'x': rmsn._encoder_inputs(td),
                                    **extras(td, 'outputs', 'active_entries'),
                                    'sw': td['sw_tilde_enc']}
                                   for td in train_datas], rmsn.weighted_mse)
    enc_predict = enc_stage.predict(_lstm_output_predict)

    # the decoder rows, per seed on the host
    shims = [_ArrayEncoder() for _ in seeds]
    for subset in ('train_f', 'val_f', 'test_cf_treatment_seq'):
        ds_list = [getattr(c, subset) for c in colls]
        for c, ds in zip(colls, ds_list):
            c._process(ds)
        stacked, rows = _stack_padded(
            [{'x': rmsn._encoder_inputs(ds.data)} for ds in ds_list], ['x'],
            device, dtype)
        out, hidden = map(_numpy, _predict_chunked(enc_predict, stacked,
                                                   eval_chunk))
        for s, ds in enumerate(ds_list):
            shims[s].put(ds, hidden[s, :rows[s]], out[s, :rows[s]])
    for c, shim in zip(colls, shims):
        c.process_data_decoder(shim)

    dec_list = []
    for c in colls:
        dd = c.train_f.data
        sw = np.cumprod(dd['stabilized_weights'], axis=-1)[:, 1:]
        dd['sw_tilde_dec'] = rmsn.clip_normalize_stabilized_weights(
            sw, dd['active_entries'], multiple_horizons=True)
        dec_list.append({'x': rmsn._decoder_inputs(dd),
                         **extras(dd, 'outputs', 'active_entries',
                                  'init_state'),
                         'sw': dd['sw_tilde_dec']})
    dec_predict = fit(3, dec_list, rmsn.weighted_mse).predict(
        functools.partial(_lstm_output_predict, with_init_state=True))

    res = _new_result()
    one_step, n_rows = _stack_padded(
        [{'x': rmsn._encoder_inputs(c.test_cf_one_step.data)}
         for c in colls], ['x'], device, dtype)
    op, _ = _predict_chunked(enc_predict, one_step, eval_chunk)
    _one_step_metrics(res, colls, _numpy(op), n_rows)

    ar_keys = ('prev_outputs', 'static_features', 'current_treatments',
               'init_state')
    ar, ar_rows = _stack_padded(
        [c.test_cf_treatment_seq.data for c in colls], ar_keys, device,
        dtype)
    statics = ar['static_features'][:, :, None, :].expand(
        -1, -1, ar['prev_outputs'].shape[2], -1)
    predicted = []
    for t in range(ph_steps):
        x = torch.cat([ar['current_treatments'], ar['prev_outputs'],
                       statics], dim=-1)
        out, _ = _predict_chunked(dec_predict,
                                  {'x': x, 'init_state': ar['init_state']},
                                  eval_chunk)
        predicted.append(out[:, :, t])
        if t < ph_steps - 1:
            ar['prev_outputs'][:, :, t + 1] = out[:, :, t]
    _n_step_metrics(res, colls, _numpy(torch.stack(predicted, dim=2)),
                    ar_rows)
    return {k: np.asarray(v) for k, v in res.items()}


def vectorized_gnet_sweep(dataset_name: str, n_seeds: int = 10,
                          num_patients: dict = None, coeff: float = 2.0,
                          epochs: int = 100, seed_start: int = 0,
                          eval_chunk: int = 8192, mc_samples: int = 25,
                          cf_seq_mode: str = 'sliding_treatment',
                          noise_scale: float = 1.0,
                          model_overrides: dict = None,
                          max_seq_length: int = 60, *, device=None,
                          dtype=None, mesh=None) -> dict:
    """A G-Net column on ``device`` in ``dtype``: the network as one
    stacked fit on each seed's training rows less its holdout split; the
    holdout residuals, the 1-step evaluation and the ``mc_samples``
    Monte-Carlo rollouts of each seed's n-step rows (the residual rows
    drawn from ``RandomState(seed)`` in the JAX package's order; one seed
    at a time, in chunks of `gnet.CHUNK_ROWS` rows). Returns the run row's
    metric keys, one value a seed."""
    dtype = resolve_float(dtype)
    seeds = list(range(seed_start, seed_start + n_seeds))
    col = _Column(n_seeds, seed_start, device, mesh)
    device = col.device
    colls = _collections(dataset_name, seeds,
                         num_patients or DEFAULT_PATIENTS, coeff,
                         cf_seq_mode, noise_scale, max_seq_length, device,
                         dtype)
    for c in colls:
        c.process_data_multi()
    cfg = _config(gnet.GNetConfig, colls, epochs, model_overrides,
                  mc_samples=mc_samples)
    ph, do = cfg.projection_horizon, cfg.dim_outcome
    for c in colls:
        c.split_train_f_holdout(cfg.holdout_ratio)
    train, _ = _stack_padded(
        [{'x': gnet._inputs(c.train_f.data),
          'outputs': c.train_f.data['outputs'],
          'active_entries': c.train_f.data['active_entries']}
         for c in colls], ['x', 'outputs', 'active_entries'], device, dtype)
    stage = _fit_simple_stage(
        lambda: gnet.GNetNetwork(cfg, dtype=dtype), seeds, train,
        gnet.outcome_loss(do), gnet.train_config(cfg), col)
    del train
    predict = stage.predict(lambda b, p: lambda batch: stacked_call(
        b, p, (batch['x'],))[..., :do])

    def predict_outputs(datas):
        stacked, rows = _stack_padded([{'x': gnet._inputs(d)}
                                       for d in datas], ['x'], device, dtype)
        return _predict_chunked(predict, stacked, eval_chunk), rows

    # the holdout residuals: the rollouts' noise
    hold = [c.train_f_holdout.data for c in colls]
    hold_pred, hold_rows = predict_outputs(hold)

    res = _new_result()
    op, n_rows = predict_outputs([c.test_cf_one_step.data for c in colls])
    _one_step_metrics(res, colls, _numpy(op), n_rows)

    M = cfg.mc_samples
    predicted = []
    for s, c in enumerate(colls):
        # the seed's rollouts on its block's device
        base, params_s, dev = stage.seed(s)
        h = hold[s]
        resid_bank = torch.as_tensor(h['outputs'], dtype=dtype,
                                     device=dev) - \
            hold_pred[s, :hold_rows[s]].to(dev)
        resid_len = torch.as_tensor(h['sequence_lengths'].astype(np.int64),
                                    device=dev)
        dd = c.test_cf_treatment_seq.data
        n = len(dd['prev_outputs'])
        rng = np.random.RandomState(seeds[s])
        ridx = torch.as_tensor(np.stack([
            np.concatenate([rng.randint(hold_rows[s], size=n)
                            for _ in range(M)])
            for _ in range(ph + 1)]), dtype=torch.int64, device=dev)
        x = torch.as_tensor(gnet._inputs(dd), dtype=dtype,
                            device=dev).repeat(M, 1, 1)
        split = torch.as_tensor(dd['future_past_split'].astype(np.int64),
                                device=dev).repeat(M)

        def net(xb, base=base, params_s=params_s):
            return torch.func.functional_call(base, params_s, (xb,))

        rows = gnet.CHUNK_ROWS
        outs = [gnet.mc_rollout(net, cfg, x[r:r + rows], split[r:r + rows],
                                ridx[:, r:r + rows], resid_bank, resid_len)
                for r in range(0, len(x), rows)]
        pred = _numpy(torch.cat(outs, dim=1))                # [ph, M n, do]
        predicted.append(pred.transpose(1, 0, 2).reshape(M, n, ph, do)
                         .mean(0))
    _n_step_metrics(res, colls, predicted, [len(p) for p in predicted])
    return {k: np.asarray(v) for k, v in res.items()}
