"""G-Net: g-computation with an LSTM and sequentially conditioned heads, in
the meaning of `insite_tpu.models.gnet`.

The network trains on the training rows less a holdout split; the holdout
rows' residuals are the noise of the n-step prediction, which averages
``mc_samples`` noisy autoregressive rollouts. A rollout makes
``projection_horizon + 1`` full forward passes; pass t reads the prediction
at ``split - 1 + t``, adds the residual of a drawn holdout row at that step
(clipped to the row's length) and, for t < ph, writes it into
``prev_outputs`` at ``split + t`` (clipped to the sequence). The clean
predictions of passes 1..ph are averaged over the samples. The residual
rows are drawn from ``np.random.RandomState(seed)`` in the JAX package's
order, so both packages draw the same rows.

With ``dim_vitals`` > 0 (a real-data collection's vitals stream) the
features take the vitals after the treatments, the heads predict the
outcome and then the next vitals, the loss adds the vitals' masked MSE
against ``next_vitals`` (one step shorter) with ``fit_vitals``, the
residual bank holds (outcome, next vitals) residuals over lengths - 1, and
each rollout pass writes its noisy next vitals beside the outcome.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.models.base import CausalEstimator
from insite_tpu_torch.models.nn.blocks import (ROutcomeVitalsHead,
                                               VariationalLSTM)
from insite_tpu_torch.models.nn.training import (TrainConfig, fit_simple,
                                                 masked_mean, seeded_net)

# rows of one rollout or prediction pass: the 25 Monte-Carlo views of an
# n-step test set are ~1.5 million rows; a chunk of 2**18 rows of 64 steps
# keeps the LSTM's outputs and the heads' activations to a few GB
CHUNK_ROWS = 1 << 18


@dataclass
class GNetConfig:
    """The JAX package's `GNetConfig`: the reference's tuned
    hyperparameters."""

    dim_treatments: int = 1
    dim_static_features: int = 2
    dim_outcome: int = 1
    # the vitals stream of real-EHR collections: the heads also predict the
    # next vitals, and rollouts feed their samples back
    dim_vitals: int = 0
    fit_vitals: bool = True
    comp_sizes: tuple = None         # default (dim_outcome[, dim_vitals])
    seq_hidden_units: int = 24
    r_size: int = 3
    fc_hidden_units: int = 48
    dropout_rate: float = 0.1
    num_layer: int = 1
    learning_rate: float = 0.01
    batch_size: int = 128
    epochs: int = 100
    mc_samples: int = 25
    holdout_ratio: float = 0.1
    projection_horizon: int = 5
    seed: int = 0


def _comp_sizes(cfg: GNetConfig):
    if cfg.comp_sizes is not None:
        assert sum(cfg.comp_sizes) == cfg.dim_outcome + cfg.dim_vitals
        return tuple(cfg.comp_sizes)
    return ((cfg.dim_outcome, cfg.dim_vitals) if cfg.dim_vitals > 0
            else (cfg.dim_outcome,))


class GNetNetwork(nn.Module):
    """``repr_net``, a variational LSTM over [treatments, vitals,
    prev_outputs, statics], and the sequential heads
    ``r_outcome_vitals_head``."""

    def __init__(self, cfg: GNetConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        n_in = (cfg.dim_treatments + cfg.dim_vitals + cfg.dim_outcome +
                cfg.dim_static_features)
        self.repr_net = VariationalLSTM(n_in, cfg.seq_hidden_units,
                                        cfg.num_layer, cfg.dropout_rate, **kw)
        self.r_outcome_vitals_head = ROutcomeVitalsHead(
            cfg.seq_hidden_units, cfg.r_size, cfg.fc_hidden_units,
            _comp_sizes(cfg), **kw)

    def forward(self, x, gen=None):
        return self.r_outcome_vitals_head(self.repr_net(x, None, gen))


def _inputs(data):
    """The features [current_treatments, vitals (where ``data`` has them),
    prev_outputs, statics], the statics repeated along time."""
    T = data['prev_outputs'].shape[1]
    statics = np.repeat(np.asarray(data['static_features'])[:, None, :], T,
                        axis=1)
    parts = [data['current_treatments']]
    if 'vitals' in data:
        parts.append(data['vitals'])
    return np.concatenate(parts + [data['prev_outputs'], statics], axis=-1)


def train_config(cfg: GNetConfig) -> TrainConfig:
    return TrainConfig(cfg.epochs, cfg.batch_size, cfg.learning_rate)


def outcome_loss(dim_outcome: int, dim_vitals: int = 0):
    """The fit's loss, ``loss(net, batch, gen)``: the masked MSE of the
    outcome head on ``batch['x']``; with ``dim_vitals``, plus the masked
    MSE of the vitals head's first T - 1 steps against
    ``batch['next_vitals']``."""
    def loss(net, b, gen):
        pred = net(b['x'], gen)
        total = masked_mean((pred[..., :dim_outcome] - b['outputs']) ** 2,
                            b['active_entries'])
        if dim_vitals:
            vp = pred[:, :-1, dim_outcome:dim_outcome + dim_vitals]
            total = total + masked_mean((vp - b['next_vitals']) ** 2,
                                        b['active_entries'][:, 1:])
        return total
    return loss


@torch.no_grad()
def mc_rollout(net, cfg: GNetConfig, x, split, ridx, resid_bank,
               resid_len):
    """The noisy rollout of one chunk of rows, in place on ``x`` (a tensor
    of its own), by ``net(x)``: ``[ph, rows, dim_outcome]``, the clean
    predictions of passes 1..ph. ``ridx [ph + 1, rows]`` picks each
    pass's residual row of ``resid_bank [H, T, dim_outcome +
    dim_vitals]``, read at the predicted step clipped to the row's length
    ``resid_len [H]``. The noisy outcome goes into ``prev_outputs`` and,
    with vitals, the noisy next vitals into the vitals features."""
    ph = cfg.projection_horizon
    dv = cfg.dim_vitals
    vo = cfg.dim_treatments                # vitals feature offset
    po = cfg.dim_treatments + dv           # prev_outputs feature offset
    do = cfg.dim_outcome
    rows = torch.arange(len(x), device=x.device)
    T = x.shape[1]
    wt = (split + torch.arange(ph, device=x.device)[:, None]).clamp(
        max=T - 1)                                        # [ph, rows]
    outs = []
    for t in range(ph + 1):
        idx = split - 1 + t
        out_t = net(x)[rows, idx, :do + dv]
        if t < ph:
            r = ridx[t]
            noisy = out_t + resid_bank[r, torch.minimum(idx,
                                                        resid_len[r] - 1)]
            x[rows, wt[t], po:po + do] = noisy[:, :do]
            if dv:
                x[rows, wt[t], vo:vo + dv] = noisy[:, do:]
        if t > 0:
            outs.append(out_t[:, :do])
    return torch.stack(outs)


class GNet(CausalEstimator):
    """G-Net on ``device`` in ``dtype`` (float32 unless named). The network
    is built when the estimator is, with PyTorch's init drawn from
    ``cfg.seed`` (`seeded_net`), and trains with a generator seeded
    alike. Building it splits the collection's holdout rows and makes the
    Monte-Carlo views of the n-step test set."""

    def __init__(self, cfg: GNetConfig, dataset_collection, *, device,
                 dtype=None):
        self.cfg = cfg
        self.collection = dataset_collection
        self.device = device = torch.device(device)
        self.dtype = dtype = resolve_float(dtype)
        self.net = seeded_net(cfg.seed,
                              lambda: GNetNetwork(cfg, dtype=dtype), device)
        self.holdout_resid = self.holdout_resid_len = None
        if not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi()
        dataset_collection.split_train_f_holdout(cfg.holdout_ratio)
        dataset_collection.explode_cf_treatment_seq(cfg.mc_samples)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def fit(self, train_f=None, val_f=None):
        cfg = self.cfg
        data = self.collection.train_f.data
        has_vitals = cfg.dim_vitals > 0 and 'next_vitals' in data
        batch = {'x': self._tensor(_inputs(data)),
                 'outputs': self._tensor(data['outputs']),
                 'active_entries': self._tensor(data['active_entries'])}
        if has_vitals:
            batch['next_vitals'] = self._tensor(data['next_vitals'])

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        loss = outcome_loss(cfg.dim_outcome, cfg.dim_vitals
                            if has_vitals and cfg.fit_vitals else 0)
        fit_simple(self.net, loss, batch, train_config(cfg), gen)

        # the holdout rows' residuals: the rollouts' noise (none without a
        # holdout split); with vitals, of (outcome, next vitals) over the
        # first T - 1 steps
        holdout = getattr(self.collection, 'train_f_holdout', None)
        if holdout is not None and len(holdout.data['outputs']):
            hd = holdout.data
            preds = self._predict_data(hd, vitals=has_vitals)
            lengths = hd['sequence_lengths'].astype(int)
            if has_vitals:
                target = np.concatenate([np.asarray(hd['outputs'])[:, :-1],
                                         np.asarray(hd['next_vitals'])],
                                        axis=-1)
                self.holdout_resid = target - preds[:, :-1]
                self.holdout_resid_len = lengths - 1
            else:
                self.holdout_resid = np.asarray(hd['outputs']) - preds
                self.holdout_resid_len = lengths
        return self

    @torch.no_grad()
    def _predict_data(self, data, vitals=False) -> np.ndarray:
        """The outcome head's predictions, and with ``vitals`` the vitals
        head's after them."""
        width = self.cfg.dim_outcome + (self.cfg.dim_vitals if vitals else 0)
        x = self._tensor(_inputs(data))
        return torch.cat([self.net(x[s:s + CHUNK_ROWS])[..., :width]
                          for s in range(0, len(x), CHUNK_ROWS)]
                         ).cpu().numpy()

    def get_predictions(self, dataset) -> np.ndarray:
        return self._predict_data(dataset.data)

    def get_autoregressive_predictions(self, datasets) -> np.ndarray:
        """The mean over the ``mc_samples`` views of their noisy rollouts
        (float32 numpy, as the JAX package returns it). The views are
        stacked into one batch of ``mc_samples * rows`` sequences and
        rolled out on the device in chunks of `CHUNK_ROWS`."""
        cfg = self.cfg
        ph = cfg.projection_horizon
        M = cfg.mc_samples
        assert isinstance(datasets, list) and len(datasets) == M
        rng = np.random.RandomState(cfg.seed)
        n = len(datasets[0].data['prev_outputs'])
        # the views are usually one dataset, M times: its features once
        feats = {id(d): d for d in datasets}
        feats = {k: self._tensor(_inputs(d.data)) for k, d in feats.items()}
        x = torch.cat([feats[id(d)] for d in datasets])
        split = torch.as_tensor(np.concatenate(
            [d.data['future_past_split'] for d in datasets]).astype(np.int64),
            device=self.device)
        if self.holdout_resid is not None:
            ridx = np.stack([
                np.concatenate([rng.randint(len(self.holdout_resid), size=n)
                                for _ in range(M)])
                for _ in range(ph + 1)])                  # [ph + 1, M n]
            resid_bank = self._tensor(self.holdout_resid)
            resid_len = torch.as_tensor(self.holdout_resid_len,
                                        device=self.device)
        else:
            ridx = np.zeros((ph + 1, M * n), np.int64)
            resid_bank = torch.zeros(
                (1, x.shape[1], cfg.dim_outcome + cfg.dim_vitals),
                dtype=self.dtype, device=self.device)
            resid_len = torch.ones(1, dtype=torch.int64, device=self.device)
        ridx = torch.as_tensor(ridx, dtype=torch.int64, device=self.device)
        outs = [mc_rollout(self.net, cfg, x[s:s + CHUNK_ROWS],
                           split[s:s + CHUNK_ROWS], ridx[:, s:s + CHUNK_ROWS],
                           resid_bank, resid_len).cpu()
                for s in range(0, len(x), CHUNK_ROWS)]
        predicted = torch.cat(outs, dim=1).numpy()        # [ph, M n, do]
        return predicted.transpose(1, 0, 2).reshape(
            M, n, ph, cfg.dim_outcome).mean(0)

    def get_normalised_n_step_rmses(self, dataset, datasets_mc=None):
        datasets_mc = datasets_mc or self.collection.test_cf_treatment_seq_mc
        return super().get_normalised_n_step_rmses(dataset, datasets_mc)
