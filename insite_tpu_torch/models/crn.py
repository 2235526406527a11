"""CRN, the Counterfactual Recurrent Network: an encoder and a decoder,
each a variational LSTM with a balanced-representation head, in the meaning
of `insite_tpu.models.crn`.

The encoder fits one-step-ahead on the factual training rows, and takes a
collection's vitals stream, where it has one, between the previous
treatments and outputs (the width from the collection, as the JAX package
infers it from the data). The
collection's decoder processing then starts every rolling-origin row from
the encoder's representation, and the decoder fits on those rows (seed + 1).
n-step predictions decode step by step, each prediction becoming the next
step's ``prev_outputs``.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.models.base import (CausalEstimator,
                                         collection_vitals_width)
from insite_tpu_torch.models.nn.blocks import (BRTreatmentOutcomeHead,
                                               VariationalLSTM)
from insite_tpu_torch.models.nn.training import (
    BRStage, device_batch, encoder_decoder_train_configs, seeded_net)


@dataclass
class CRNConfig:
    """The JAX package's `CRNConfig`: the reference's tuned
    hyperparameters."""

    dim_treatments: int = 2
    dim_static_features: int = 2
    dim_outcome: int = 1
    # encoder
    enc_seq_hidden_units: int = 24
    enc_br_size: int = 6
    enc_fc_hidden_units: int = 18
    enc_dropout_rate: float = 0.2
    enc_learning_rate: float = 0.01
    enc_batch_size: int = 64
    # decoder (its LSTM width is the encoder's br_size)
    dec_br_size: int = 3
    dec_fc_hidden_units: int = 9
    dec_dropout_rate: float = 0.2
    dec_learning_rate: float = 0.001
    dec_batch_size: int = 512
    num_layer: int = 1
    epochs: int = 100
    balancing: str = 'domain_confusion'
    alpha: float = 0.01
    update_alpha: bool = True
    weights_ema: bool = True
    beta: float = 0.99
    treatment_mode: str = 'multiclass'
    projection_horizon: int = 5
    seed: int = 0


class CRNSubNetwork(nn.Module):
    """One CRN stage: the LSTM over [prev_treatments, vitals (with
    ``dim_vitals``), prev_outputs, static_features] (the statics repeated
    along time), started from ``batch['init_state']`` with
    ``use_init_state``, and the balanced-representation head."""

    def __init__(self, seq_hidden_units, br_size, fc_hidden_units,
                 dim_treatments, dim_outcome, dim_static_features,
                 dropout_rate, num_layer, balancing, use_init_state=False,
                 dim_vitals=0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_init_state = use_init_state
        self.has_vitals = dim_vitals > 0
        self.lstm = VariationalLSTM(
            dim_treatments + dim_vitals + dim_outcome + dim_static_features,
            seq_hidden_units, num_layer, dropout_rate, **kw)
        self.br_treatment_outcome_head = BRTreatmentOutcomeHead(
            seq_hidden_units, br_size, fc_hidden_units, dim_treatments,
            dim_outcome, balancing, **kw)

    def forward(self, batch, alpha=0.0, gen=None, detach_treatment=False):
        # with the representation detached, only the treatment classifier
        # takes gradients: the LSTM needs no graph
        with torch.no_grad() if detach_treatment else nullcontext():
            parts = [batch['prev_treatments']]
            if self.has_vitals:
                parts.append(batch['vitals'])
            x = torch.cat(parts + [batch['prev_outputs']], dim=-1)
            statics = batch['static_features'][:, None, :].expand(
                -1, x.shape[1], -1)
            x = torch.cat([x, statics], dim=-1)
            init_states = batch['init_state'] if self.use_init_state \
                else None
            h = self.lstm(x, init_states, gen)
        return self.br_treatment_outcome_head(
            h, batch['current_treatments'], alpha, detach_treatment)


def encoder_network(cfg: CRNConfig, dtype=None,
                    dim_vitals=0) -> CRNSubNetwork:
    """The encoder stage's network (over a vitals stream of
    ``dim_vitals``), on the host."""
    return CRNSubNetwork(cfg.enc_seq_hidden_units, cfg.enc_br_size,
                         cfg.enc_fc_hidden_units, cfg.dim_treatments,
                         cfg.dim_outcome, cfg.dim_static_features,
                         cfg.enc_dropout_rate, cfg.num_layer, cfg.balancing,
                         False, dim_vitals, dtype=dtype)


def decoder_network(cfg: CRNConfig, dtype=None) -> CRNSubNetwork:
    """The decoder stage's network (its LSTM as wide as the encoder's
    representation, started from ``init_state``), on the host."""
    return CRNSubNetwork(cfg.enc_br_size, cfg.dec_br_size,
                         cfg.dec_fc_hidden_units, cfg.dim_treatments,
                         cfg.dim_outcome, cfg.dim_static_features,
                         cfg.dec_dropout_rate, cfg.num_layer, cfg.balancing,
                         True, dtype=dtype)


ENC_KEYS = ('prev_treatments', 'prev_outputs', 'static_features',
            'current_treatments', 'outputs', 'active_entries')
DEC_KEYS = ENC_KEYS + ('init_state',)
ENC_IN = ('prev_treatments', 'prev_outputs', 'static_features',
          'current_treatments')
DEC_IN = ENC_IN + ('init_state',)


class CRN(CausalEstimator):
    """The two-stage CRN on ``device`` in ``dtype`` (float32 unless named).
    Both networks are built when the estimator is, with PyTorch's init
    drawn from ``cfg.seed`` (the encoder) and ``cfg.seed + 1`` (the
    decoder), as their training is (`seeded_net`); `fit` trains whatever
    parameters they hold then. The encoder takes the collection's vitals
    stream where it has one; the decoder never does."""

    def __init__(self, cfg: CRNConfig, dataset_collection, *, device,
                 dtype=None):
        self.cfg = cfg
        self.collection = dataset_collection
        self.device = device = torch.device(device)
        self.dtype = dtype = resolve_float(dtype)
        kw = dict(device=device, dtype=dtype)
        dim_vitals = collection_vitals_width(dataset_collection)
        vit = ('vitals',) if dim_vitals else ()
        enc_net = seeded_net(cfg.seed, lambda: encoder_network(
            cfg, dtype, dim_vitals), device)
        dec_net = seeded_net(cfg.seed + 1,
                             lambda: decoder_network(cfg, dtype), device)
        enc_tc, dec_tc = encoder_decoder_train_configs(cfg)
        self.encoder = BRStage(enc_net, enc_tc, cfg.seed, ENC_KEYS + vit,
                               ENC_IN + vit, **kw)
        self.decoder = BRStage(dec_net, dec_tc, cfg.seed + 1, DEC_KEYS,
                               DEC_IN, **kw)
        if not dataset_collection.processed_data_encoder:
            dataset_collection.process_data_encoder()

    def fit(self, train_f=None, val_f=None):
        coll = self.collection
        self.encoder.fit_stage(coll.train_f.data)
        if not coll.processed_data_decoder:
            coll.process_data_decoder(self.encoder)
        self.decoder.fit_stage(coll.train_f.data)
        return self

    def get_predictions(self, dataset) -> np.ndarray:
        """One-step predictions: the encoder's."""
        return self.encoder.get_predictions(dataset)

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        """Step-by-step decoding of the autoregressive test rows: step t's
        prediction becomes ``prev_outputs`` of step t + 1 (float64, as the
        JAX package returns them)."""
        ph = self.cfg.projection_horizon
        batch = device_batch(dataset.data, DEC_IN, self.device, self.dtype)
        # written into: never the dataset's own array
        batch['prev_outputs'] = batch['prev_outputs'].clone()
        predicted = []
        for t in range(ph):
            outputs = self.decoder.forward(batch)[1][:, t]
            predicted.append(outputs)
            if t < ph - 1:
                batch['prev_outputs'][:, t + 1] = outputs
        return torch.stack(predicted, dim=1).cpu().numpy().astype(np.float64)
