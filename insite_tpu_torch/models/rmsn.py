"""RMSN, Recurrent Marginal Structural Networks, in the meaning of
`insite_tpu.models.rmsn`: four networks, each a variational LSTM with a
linear output, trained one after the other by `fit_simple`.

1. The propensity-treatment network (on the previous treatments) and the
   propensity-history network (on the previous treatments, the vitals
   where the collection has them, the previous outputs and the statics),
   on the masked BCE of the current treatments.
2. The stabilized weights of the training rows from their scores
   (``sw_mode``), clipped at their 1 % / 99 % quantiles and normalised, on
   the host in float64.
3. The encoder (its inputs led by the vitals where there are any), on the
   SW-weighted one-step MSE, for ``epochs * enc_epoch_mult`` epochs.
4. The decoder, on the rolling-origin rows that the collection's decoder
   processing starts from the encoder's representation, through a memory
   adapter, weighted by the cumulative product of the weights over the
   window. It never takes vitals.

The vitals width comes from the collection, as the JAX package infers it
from the data.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.models.base import (CausalEstimator,
                                         collection_vitals_width)
from insite_tpu_torch.models.nn.blocks import VariationalLSTM, bce
from insite_tpu_torch.models.nn.training import (TrainConfig, fit_simple,
                                                 masked_mean, seeded_net)


@dataclass
class RMSNConfig:
    """The JAX package's `RMSNConfig`: the reference's tuned
    hyperparameters."""

    dim_treatments: int = 1
    dim_static_features: int = 2
    dim_outcome: int = 1
    prop_treat_hidden: int = 8
    prop_treat_dropout: float = 0.1
    prop_treat_lr: float = 0.001
    prop_treat_bs: int = 64
    prop_treat_clip: float = 2.0
    prop_hist_hidden: int = 16
    prop_hist_dropout: float = 0.3
    prop_hist_lr: float = 0.01
    prop_hist_bs: int = 256
    prop_hist_clip: float = 1.0
    enc_hidden: int = 12
    enc_dropout: float = 0.1
    enc_lr: float = 0.001
    enc_bs: int = 64
    enc_clip: float = 2.0
    dec_hidden: int = 64
    dec_dropout: float = 0.2
    dec_lr: float = 0.001
    dec_bs: int = 256
    dec_clip: float = 1.0
    num_layer: int = 1
    epochs: int = 100
    treatment_mode: str = 'multilabel'
    projection_horizon: int = 5
    seed: int = 0
    # 'likelihood': the weights from the probability of the observed
    # treatment, prod_a [a p + (1 - a)(1 - p)]_treat / [...]_hist;
    # 'score_ratio': the reference's prod_a p_treat / p_hist
    sw_mode: str = 'likelihood'
    # the encoder trains for epochs * enc_epoch_mult epochs
    enc_epoch_mult: int = 3


class LSTMOutputNet(nn.Module):
    """A variational LSTM and a linear output layer; ``forward`` returns
    (output, LSTM output). With ``memory_size``, a warm start
    ``init_state`` passes through the linear ``memory_adapter``
    (memory_size -> hidden) before it seeds h and c."""

    def __init__(self, input_size, hidden, out_dim, dropout_rate,
                 num_layer=1, memory_size=None, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.memory_adapter = (None if memory_size is None else
                               nn.Linear(memory_size, hidden, **kw))
        self.lstm = VariationalLSTM(input_size, hidden, num_layer,
                                    dropout_rate, **kw)
        self.output_layer = nn.Linear(hidden, out_dim, **kw)

    def forward(self, x, init_state=None, gen=None):
        if self.memory_adapter is not None and init_state is not None:
            init_state = self.memory_adapter(init_state)
        h = self.lstm(x, init_state, gen)
        return self.output_layer(h), h


def clip_normalize_stabilized_weights(sw, active_entries,
                                      multiple_horizons=False):
    """The weights in float64, inactive entries left out: clipped to their
    1 % and 99 % quantiles, divided by their mean (per horizon with
    ``multiple_horizons``), and 0 where inactive."""
    active = np.squeeze(active_entries, -1).astype(bool)
    sw = np.array(sw, dtype=np.float64)
    sw[~active] = np.nan
    sw_tilde = np.clip(sw, np.nanquantile(sw, 0.01),
                       np.nanquantile(sw, 0.99))
    if multiple_horizons:
        sw_tilde = sw_tilde / np.nanmean(sw_tilde, axis=0, keepdims=True)
    else:
        sw_tilde = sw_tilde / np.nanmean(sw_tilde)
    sw_tilde[~active] = 0.0
    return sw_tilde


def _statics_expanded(data, T):
    return np.repeat(np.asarray(data['static_features'])[:, None, :], T,
                     axis=1)


def _propensity_inputs_treat(data):
    return np.asarray(data['prev_treatments'])


def _propensity_inputs_hist(data):
    T = data['prev_treatments'].shape[1]
    parts = [data['prev_treatments']]
    if 'vitals' in data:
        parts.append(data['vitals'])
    return np.concatenate(parts + [data['prev_outputs'],
                                   _statics_expanded(data, T)], axis=-1)


def _encoder_inputs(data):
    T = data['prev_outputs'].shape[1]
    parts = [data['vitals']] if 'vitals' in data else []
    return np.concatenate(parts + [data['prev_outputs'],
                                   data['current_treatments'],
                                   _statics_expanded(data, T)], axis=-1)


def _decoder_inputs(data):
    T = data['prev_outputs'].shape[1]
    return np.concatenate([data['current_treatments'], data['prev_outputs'],
                           _statics_expanded(data, T)], axis=-1)


def network_factories(cfg: RMSNConfig, dtype=None, dim_vitals=0) -> list:
    """Zero-argument factories of the four networks, on the host, in the
    order they train: propensity-treatment, propensity-history and encoder
    (both also over ``dim_vitals`` vitals), decoder (with the memory
    adapter from the encoder's width)."""
    c = cfg
    n_in = c.dim_treatments + c.dim_outcome + c.dim_static_features

    def factory(*args, **kwargs):
        return lambda: LSTMOutputNet(*args, num_layer=c.num_layer,
                                     dtype=dtype, **kwargs)

    return [factory(c.dim_treatments, c.prop_treat_hidden, c.dim_treatments,
                    c.prop_treat_dropout),
            factory(n_in + dim_vitals, c.prop_hist_hidden, c.dim_treatments,
                    c.prop_hist_dropout),
            factory(n_in + dim_vitals, c.enc_hidden, c.dim_outcome,
                    c.enc_dropout),
            factory(n_in, c.dec_hidden, c.dim_outcome, c.dec_dropout,
                    memory_size=c.enc_hidden)]


def train_configs(cfg: RMSNConfig) -> list:
    """The four networks' `TrainConfig`s, in training order; the encoder
    trains ``epochs * enc_epoch_mult`` epochs."""
    c = cfg
    return [TrainConfig(c.epochs, c.prop_treat_bs, c.prop_treat_lr,
                        max_grad_norm=c.prop_treat_clip),
            TrainConfig(c.epochs, c.prop_hist_bs, c.prop_hist_lr,
                        max_grad_norm=c.prop_hist_clip),
            TrainConfig(c.epochs * c.enc_epoch_mult, c.enc_bs, c.enc_lr,
                        max_grad_norm=c.enc_clip),
            TrainConfig(c.epochs, c.dec_bs, c.dec_lr,
                        max_grad_norm=c.dec_clip)]


def propensity_loss(mode: str):
    """The propensity networks' loss: the masked treatment BCE."""
    def loss(out, batch):
        elem = bce(out, batch['current_treatments'], mode)
        return masked_mean(elem, batch['active_entries'][..., 0])
    return loss


def weighted_mse(out, batch):
    """The encoder's and the decoder's loss: the masked MSE, each entry
    weighted by its stabilized weight ``sw``."""
    mse = (out - batch['outputs']) ** 2 * batch['sw'][..., None]
    return masked_mean(mse, batch['active_entries'])


def stabilized_weights(a, pt, ph, sw_mode: str):
    """The stabilized weights ``[N, T]`` from the current treatments ``a``
    and both networks' scores ``pt``, ``ph`` ``[N, T, A]``: 'likelihood',
    the ratio of the observed treatment's probabilities, or 'score_ratio',
    the reference's ratio of the scores, each a product over the
    treatments."""
    if sw_mode == 'likelihood':
        eps = 1e-6
        lik_t = np.clip(a * pt + (1 - a) * (1 - pt), eps, None)
        lik_h = np.clip(a * ph + (1 - a) * (1 - ph), eps, None)
        return np.prod(lik_t / lik_h, axis=2)
    if sw_mode == 'score_ratio':
        return np.prod(pt / ph, axis=2)
    raise ValueError(f'unknown sw_mode {sw_mode!r}: expected '
                     f"'likelihood' or 'score_ratio'")


class _Net:
    """One of RMSN's networks with its training: the network, its inputs
    from a dataset's data and its seed."""

    def __init__(self, net, inputs, seed):
        self.net, self.inputs, self.seed = net, inputs, seed


class RMSN(CausalEstimator):
    """The four-network RMSN on ``device`` in ``dtype`` (float32 unless
    named). The networks are built when the estimator is, with PyTorch's
    init drawn from ``cfg.seed`` .. ``cfg.seed + 3`` (propensity-treatment,
    propensity-history, encoder, decoder; `seeded_net`), and each trains
    with a generator seeded like its init. The propensity-history network
    and the encoder take the collection's vitals stream where it has
    one."""

    def __init__(self, cfg: RMSNConfig, dataset_collection, *, device,
                 dtype=None):
        self.cfg = c = cfg
        self.collection = dataset_collection
        self.device = device = torch.device(device)
        self.dtype = dtype = resolve_float(dtype)
        factories = network_factories(
            c, dtype, collection_vitals_width(dataset_collection))
        nets = [seeded_net(c.seed + i, build, device)
                for i, build in enumerate(factories)]
        self.prop_treat = _Net(nets[0], _propensity_inputs_treat, c.seed)
        self.prop_hist = _Net(nets[1], _propensity_inputs_hist, c.seed + 1)
        self.encoder = _Net(nets[2], _encoder_inputs, c.seed + 2)
        self.decoder = _Net(nets[3], _decoder_inputs, c.seed + 3)
        if not dataset_collection.processed_data_encoder:
            dataset_collection.process_data_encoder()

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _fit_net(self, stage: _Net, data, targets: dict, loss, tc,
                 init_state=None):
        batch = {'x': self._tensor(stage.inputs(data))}
        batch.update({k: self._tensor(v) for k, v in targets.items()})
        if init_state is not None:
            batch['init_state'] = self._tensor(init_state)

        def loss_fn(net, b, gen):
            out, _ = net(b['x'], b.get('init_state'), gen)
            return loss(out, b)

        gen = torch.Generator(device=self.device).manual_seed(stage.seed)
        fit_simple(stage.net, loss_fn, batch, tc, gen)

    @torch.no_grad()
    def _apply(self, stage: _Net, data, init_state=None):
        """(output, LSTM output) of ``stage``'s network on ``data``."""
        return stage.net(self._tensor(stage.inputs(data)),
                         None if init_state is None else
                         self._tensor(init_state))

    def fit(self, train_f=None, val_f=None):
        cfg = self.cfg
        coll = self.collection
        data = coll.train_f.data
        tcs = train_configs(cfg)
        bce_loss = propensity_loss(cfg.treatment_mode)
        extra = {k: data[k] for k in ('current_treatments',
                                      'active_entries')}
        self._fit_net(self.prop_treat, data, extra, bce_loss, tcs[0])
        self._fit_net(self.prop_hist, data, extra, bce_loss, tcs[1])

        data['stabilized_weights'] = stabilized_weights(
            np.asarray(data['current_treatments']),
            self._treat_scores(coll.train_f),
            self._hist_scores(coll.train_f), cfg.sw_mode)
        data['sw_tilde_enc'] = clip_normalize_stabilized_weights(
            data['stabilized_weights'], data['active_entries'])
        self._fit_net(self.encoder, data,
                      {'outputs': data['outputs'],
                       'active_entries': data['active_entries'],
                       'sw': data['sw_tilde_enc']}, weighted_mse, tcs[2])

        if not coll.processed_data_decoder:
            coll.process_data_decoder(self)
        ddata = coll.train_f.data
        sw = np.cumprod(ddata['stabilized_weights'], axis=-1)[:, 1:]
        ddata['sw_tilde_dec'] = clip_normalize_stabilized_weights(
            sw, ddata['active_entries'], multiple_horizons=True)
        self._fit_net(self.decoder, ddata,
                      {'outputs': ddata['outputs'],
                       'active_entries': ddata['active_entries'],
                       'sw': ddata['sw_tilde_dec']}, weighted_mse, tcs[3],
                      init_state=ddata['init_state'])
        return self

    def _treat_scores(self, dataset) -> np.ndarray:
        out, _ = self._apply(self.prop_treat, dataset.data)
        return torch.sigmoid(out).cpu().numpy()

    def _hist_scores(self, dataset) -> np.ndarray:
        out, _ = self._apply(self.prop_hist, dataset.data)
        return torch.sigmoid(out).cpu().numpy()

    def get_representations(self, dataset) -> np.ndarray:
        return self._apply(self.encoder, dataset.data)[1].cpu().numpy()

    def get_predictions(self, dataset) -> np.ndarray:
        """The decoder's predictions on rows that carry a warm start
        (``init_state``), the encoder's on the others."""
        d = dataset.data
        if 'init_state' in d:
            out, _ = self._apply(self.decoder, d, d['init_state'])
        else:
            out, _ = self._apply(self.encoder, d)
        return out.cpu().numpy()

    @torch.no_grad()
    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        """Step-by-step decoding of the autoregressive test rows: step t's
        prediction becomes ``prev_outputs`` of step t + 1 (float64, as the
        JAX package returns them)."""
        ph = self.cfg.projection_horizon
        d = dataset.data
        # written into: a tensor of its own, never the dataset's array
        x = self._tensor(_decoder_inputs(d))
        init_state = self._tensor(d['init_state'])
        po = self.cfg.dim_treatments
        do = self.cfg.dim_outcome
        predicted = []
        for t in range(ph):
            outputs = self.decoder.net(x, init_state)[0][:, t]
            predicted.append(outputs)
            if t < ph - 1:
                x[:, t + 1, po:po + do] = outputs
        return torch.stack(predicted, dim=1).cpu().numpy().astype(np.float64)
