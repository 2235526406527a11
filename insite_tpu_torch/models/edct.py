"""EDCT, the Encoder-Decoder Causal Transformer, in the meaning of
`insite_tpu.models.edct`: a transformer encoder over the factual history
and a transformer decoder with causal self-attention and attention, not
causal, over the encoder's balanced representations, each with a
balanced-representation head and trained by `fit_br_model`.

The encoder takes a collection's vitals stream, where it has one, between
the previous treatments and outputs; the decoder never does. The pipeline
is CRN's: the encoder fits one-step-ahead (seed), the
collection's decoder processing keeps the encoder's representations of
every row (``save_encoder_r``), each rolling-origin row takes those of its
patient (``original_index``), the decoder fits (seed + 1), and n-step
predictions decode step by step.
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
                                               RelativePositionalEncoding,
                                               TransformerDecoderBlock,
                                               TransformerEncoderBlock,
                                               dropout)
from insite_tpu_torch.models.nn.training import (
    BRStage, device_batch, encoder_decoder_train_configs, seeded_net)


@dataclass
class EDCTConfig:
    """The JAX package's `EDCTConfig`: the reference's tuned
    hyperparameters; the decoder's width is the encoder's ``br_size``."""

    dim_treatments: int = 2
    dim_static_features: int = 2
    dim_outcome: int = 1
    enc_seq_hidden_units: int = 18
    enc_br_size: int = 18
    enc_fc_hidden_units: int = 18
    enc_dropout_rate: float = 0.1
    enc_learning_rate: float = 0.01
    enc_batch_size: int = 128
    dec_br_size: int = 3
    dec_fc_hidden_units: int = 12
    dec_dropout_rate: float = 0.2
    dec_learning_rate: float = 0.001
    dec_batch_size: int = 512
    num_layer: int = 2
    num_heads: int = 2
    max_relative_position: int = 15
    epochs: int = 100
    balancing: str = 'domain_confusion'
    alpha: float = 0.01
    update_alpha: bool = True
    weights_ema: bool = True
    beta: float = 0.99
    treatment_mode: str = 'multiclass'
    projection_horizon: int = 5
    seed: int = 0


def _input_features(batch, has_vitals=False):
    """[prev_treatments, vitals (with ``has_vitals``), prev_outputs,
    statics], the statics repeated along time."""
    parts = [batch['prev_treatments']]
    if has_vitals:
        parts.append(batch['vitals'])
    x = torch.cat(parts + [batch['prev_outputs']], dim=-1)
    statics = batch['static_features'][:, None, :].expand(-1, x.shape[1], -1)
    return torch.cat([x, statics], dim=-1)


class _EDCTNetwork(nn.Module):
    """The parts both networks share: the ``input`` projection (of the
    features and ``dim_vitals`` vitals) to ``d_model``, one
    relative-position k and one v table for the
    self-attention of every block (``self_pe_k``, ``self_pe_v``),
    ``num_layer`` blocks (``block_{i}``) and the balanced-representation
    head of width ``br_size``."""

    def __init__(self, cfg: EDCTConfig, d_model, br_size, fc_hidden_units,
                 dropout_rate, block_cls, dim_vitals=0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        head_size = d_model // cfg.num_heads
        self.dropout_rate = dropout_rate
        self.has_vitals = dim_vitals > 0
        self.input = nn.Linear(cfg.dim_treatments + dim_vitals +
                               cfg.dim_outcome + cfg.dim_static_features,
                               d_model, **kw)
        self.self_pe_k = RelativePositionalEncoding(
            cfg.max_relative_position, head_size, **kw)
        self.self_pe_v = RelativePositionalEncoding(
            cfg.max_relative_position, head_size, **kw)
        self.head_size = head_size
        self.blocks = []
        for i in range(cfg.num_layer):
            block = block_cls(d_model, cfg.num_heads, head_size, d_model * 4,
                              dropout_rate, dropout_rate, **kw)
            self.add_module(f'block_{i}', block)
            self.blocks.append(block)
        self.br_treatment_outcome_head = BRTreatmentOutcomeHead(
            d_model, br_size, fc_hidden_units, cfg.dim_treatments,
            cfg.dim_outcome, cfg.balancing, **kw)

    def _blocks(self, x, batch, gen):
        raise NotImplementedError

    def forward(self, batch, alpha=0.0, gen=None, detach_treatment=False):
        # with the representation detached, only the treatment classifier
        # takes gradients: the blocks need no graph
        with torch.no_grad() if detach_treatment else nullcontext():
            x = self._blocks(self.input(_input_features(
                batch, self.has_vitals)), batch, gen)
            x = dropout(x, self.dropout_rate, gen)
        return self.br_treatment_outcome_head(
            x, batch['current_treatments'], alpha, detach_treatment)


class EDCTEncoderNetwork(_EDCTNetwork):
    """The encoder: causal self-attention blocks over the factual
    history (and a vitals stream of ``dim_vitals``)."""

    def __init__(self, cfg: EDCTConfig, dim_vitals=0, *, device=None,
                 dtype=None):
        super().__init__(cfg, cfg.enc_seq_hidden_units, cfg.enc_br_size,
                         cfg.enc_fc_hidden_units, cfg.enc_dropout_rate,
                         TransformerEncoderBlock, dim_vitals, device=device,
                         dtype=dtype)

    def _blocks(self, x, batch, gen):
        T = x.shape[1]
        rel_k, rel_v = self.self_pe_k(T, T), self.self_pe_v(T, T)
        for block in self.blocks:
            x = block(x, batch['active_entries'], gen, rel_k, rel_v)
        return x


class EDCTDecoderNetwork(_EDCTNetwork):
    """The decoder, ``d_model`` the encoder's ``br_size``: causal
    self-attention over the window, then attention over the encoder's
    representations ``encoder_r``, whose relative positions count from the
    end of the encoder's sequence (``cross_pe_k``, ``cross_pe_v``)."""

    def __init__(self, cfg: EDCTConfig, *, device=None, dtype=None):
        super().__init__(cfg, cfg.enc_br_size, cfg.dec_br_size,
                         cfg.dec_fc_hidden_units, cfg.dec_dropout_rate,
                         TransformerDecoderBlock, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.cross_pe_k = RelativePositionalEncoding(
            cfg.max_relative_position, self.head_size, cross_attn=True, **kw)
        self.cross_pe_v = RelativePositionalEncoding(
            cfg.max_relative_position, self.head_size, cross_attn=True, **kw)

    def _blocks(self, x, batch, gen):
        encoder_r = batch['encoder_r']
        Tq, Tk = x.shape[1], encoder_r.shape[1]
        rel = (self.self_pe_k(Tq, Tq), self.self_pe_v(Tq, Tq),
               self.cross_pe_k(Tq, Tk), self.cross_pe_v(Tq, Tk))
        for block in self.blocks:
            x = block(x, encoder_r, batch['active_entries'],
                      batch['active_encoder_r'], gen, *rel)
        return x


def encoder_network(cfg: EDCTConfig, dtype=None,
                    dim_vitals=0) -> EDCTEncoderNetwork:
    return EDCTEncoderNetwork(cfg, dim_vitals, dtype=dtype)


def decoder_network(cfg: EDCTConfig, dtype=None) -> EDCTDecoderNetwork:
    return EDCTDecoderNetwork(cfg, dtype=dtype)


ENC_KEYS = ('prev_treatments', 'prev_outputs', 'static_features',
            'current_treatments', 'outputs', 'active_entries')
ENC_IN = ('prev_treatments', 'prev_outputs', 'static_features',
          'current_treatments', 'active_entries')
DEC_KEYS = ENC_KEYS + ('encoder_r', 'active_encoder_r')
DEC_IN = ENC_IN + ('encoder_r', 'active_encoder_r')


class EDCT(CausalEstimator):
    """The two-stage EDCT on ``device`` in ``dtype`` (float32 unless
    named). Both networks are built when the estimator is, with PyTorch's
    init drawn from ``cfg.seed`` (the encoder) and ``cfg.seed + 1`` (the
    decoder), as their training is (`seeded_net`). The encoder takes the
    collection's vitals stream where it has one."""

    def __init__(self, cfg: EDCTConfig, dataset_collection, *, device,
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
            coll.process_data_decoder(self.encoder, save_encoder_r=True)
        # each rolling-origin row attends over its patient's
        # representations
        train_data = dict(coll.train_f.data)
        orig_idx = train_data['original_index'].astype(int)
        train_data['encoder_r'] = coll.train_f.encoder_r[orig_idx]
        self.decoder.fit_stage(train_data)
        return self

    def get_predictions(self, dataset) -> np.ndarray:
        """One-step predictions: the encoder's."""
        return self.encoder.get_predictions(dataset)

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        """Step-by-step decoding of the autoregressive test rows: step t's
        prediction becomes ``prev_outputs`` of step t + 1 (float64, as the
        JAX package returns them)."""
        ph = self.cfg.projection_horizon
        data = dict(dataset.data, encoder_r=dataset.encoder_r)
        batch = device_batch(data, DEC_IN, self.device, self.dtype)
        # written into: never the dataset's own array
        batch['prev_outputs'] = batch['prev_outputs'].clone()
        predicted = []
        for t in range(ph):
            outputs = self.decoder.forward(batch)[1][:, t]
            predicted.append(outputs)
            if t < ph - 1:
                batch['prev_outputs'][:, t + 1] = outputs
        return torch.stack(predicted, dim=1).cpu().numpy().astype(np.float64)
