"""Causal Transformer (CT): a multi-input transformer over the treatment
and outcome streams with a balanced representation trained by domain
confusion, in the meaning of `insite_tpu.models.ct`.

ONE relative-position k table and ONE v table (`CTNetwork.self_pe_k`,
``self_pe_v``) serve every attention module of every block. Multi-step
prediction runs ``projection_horizon + 1`` forward passes over the n-step
test rows, each writing its predictions into ``prev_outputs`` after the
rolling origin.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.models.base import VITALS_NOT_PORTED
from insite_tpu_torch.models.nn.blocks import (BRTreatmentOutcomeHead,
                                               RelativePositionalEncoding,
                                               TransformerMultiInputBlock,
                                               dropout)
from insite_tpu_torch.models.nn.training import (BRStage, TrainConfig,
                                                 device_batch, seeded_net)


@dataclass
class CTConfig:
    """The JAX package's `CTConfig`: the reference's tuned hyperparameters."""

    dim_treatments: int = 2
    dim_static_features: int = 2
    dim_outcome: int = 1
    # the vitals stream of real-EHR collections (every synthetic benchmark
    # has none); not ported yet: more than 0 raises
    dim_vitals: int = 0
    seq_hidden_units: int = 16
    br_size: int = 16
    fc_hidden_units: int = 32
    dropout_rate: float = 0.1
    num_layer: int = 1
    num_heads: int = 2
    max_relative_position: int = 15
    learning_rate: float = 0.01
    batch_size: int = 256
    epochs: int = 100
    balancing: str = 'domain_confusion'
    alpha: float = 0.01
    update_alpha: bool = True
    weights_ema: bool = True
    beta: float = 0.99
    treatment_mode: str = 'multiclass'
    projection_horizon: int = 5
    max_grad_norm: Optional[float] = None
    seed: int = 0


class CTNetwork(nn.Module):
    """Input projections, the shared relative-position tables,
    ``num_layer`` two-stream blocks (``block_{i}``), the mean of the two
    streams and the balanced-representation head."""

    def __init__(self, cfg: CTConfig, *, device=None, dtype=None):
        super().__init__()
        if cfg.dim_vitals > 0:
            raise NotImplementedError(VITALS_NOT_PORTED)
        kw = dict(device=device, dtype=dtype)
        H = cfg.seq_hidden_units
        head_size = H // cfg.num_heads
        self.dropout_rate = cfg.dropout_rate
        self.treatments_input = nn.Linear(cfg.dim_treatments, H, **kw)
        self.outputs_input = nn.Linear(cfg.dim_outcome, H, **kw)
        self.static_input = nn.Linear(cfg.dim_static_features, H, **kw)
        self.self_pe_k = RelativePositionalEncoding(
            cfg.max_relative_position, head_size, **kw)
        self.self_pe_v = RelativePositionalEncoding(
            cfg.max_relative_position, head_size, **kw)
        self.blocks = []
        for i in range(cfg.num_layer):
            block = TransformerMultiInputBlock(
                H, cfg.num_heads, head_size, H * 4, cfg.dropout_rate,
                cfg.dropout_rate, **kw)
            self.add_module(f'block_{i}', block)
            self.blocks.append(block)
        self.br_treatment_outcome_head = BRTreatmentOutcomeHead(
            H, cfg.br_size, cfg.fc_hidden_units, cfg.dim_treatments,
            cfg.dim_outcome, cfg.balancing, **kw)

    def forward(self, batch, alpha=0.0, gen=None, detach_treatment=False):
        # with the representation detached, only the treatment classifier
        # takes gradients: the streams need no graph
        with torch.no_grad() if detach_treatment else nullcontext():
            x_t = self.treatments_input(batch['prev_treatments'])
            x_o = self.outputs_input(batch['prev_outputs'])
            x_s = self.static_input(batch['static_features'][:, None, :])
            T = x_t.shape[1]
            rel_k = self.self_pe_k(T, T)
            rel_v = self.self_pe_v(T, T)
            for block in self.blocks:
                x_t, x_o = block(x_t, x_o, x_s, batch['active_entries'], gen,
                                 rel_k, rel_v)
            x = dropout((x_o + x_t) / 2, self.dropout_rate, gen)
        return self.br_treatment_outcome_head(
            x, batch['current_treatments'], alpha, detach_treatment)


BATCH_KEYS = ('prev_treatments', 'prev_outputs', 'static_features',
              'current_treatments', 'outputs', 'active_entries')
INPUT_KEYS = ('prev_treatments', 'prev_outputs', 'static_features',
              'current_treatments', 'active_entries')


def ct_train_config(cfg: CTConfig) -> TrainConfig:
    return TrainConfig(epochs=cfg.epochs, batch_size=cfg.batch_size,
                       learning_rate=cfg.learning_rate,
                       balancing=cfg.balancing, alpha=cfg.alpha,
                       update_alpha=cfg.update_alpha,
                       weights_ema=cfg.weights_ema, beta=cfg.beta,
                       treatment_mode=cfg.treatment_mode,
                       max_grad_norm=cfg.max_grad_norm)


class CausalTransformer(BRStage):
    """CT on ``device`` in ``dtype`` (float32 unless named). The network is
    built when the estimator is, with PyTorch's init drawn from
    ``cfg.seed`` (`seeded_net`); `fit` trains whatever parameters it holds
    then."""

    def __init__(self, cfg: CTConfig, dataset_collection=None, *, device,
                 dtype=None):
        if getattr(dataset_collection, 'has_vitals', False):
            raise NotImplementedError(VITALS_NOT_PORTED)
        device, dtype = torch.device(device), resolve_float(dtype)
        net = seeded_net(cfg.seed, lambda: CTNetwork(cfg, dtype=dtype),
                         device)
        super().__init__(net, ct_train_config(cfg), cfg.seed, BATCH_KEYS,
                         INPUT_KEYS, device=device, dtype=dtype)
        self.cfg = cfg
        self.collection = dataset_collection
        if dataset_collection is not None and \
                not dataset_collection.processed_data_multi:
            dataset_collection.process_data_multi()

    def fit(self, train_f=None, val_f=None):
        return self.fit_stage((train_f or self.collection.train_f).data)

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        """``projection_horizon + 1`` passes over the rows: pass t writes
        its prediction at ``split - 1 + t`` into ``prev_outputs`` at
        ``split + t``; passes 1..ph give the predictions (float64, as the
        JAX package returns them)."""
        ph = self.cfg.projection_horizon
        batch = device_batch(dataset.data, INPUT_KEYS, self.device,
                             self.dtype)
        # written into: never the dataset's own array
        batch['prev_outputs'] = batch['prev_outputs'].clone()
        split = torch.as_tensor(
            dataset.data['future_past_split'].astype(np.int64),
            device=self.device)
        rows = torch.arange(len(split), device=self.device)
        predicted = []
        for t in range(ph + 1):
            outputs = self.forward(batch)[1][rows, split - 1 + t]
            if t < ph:
                batch['prev_outputs'][rows, split + t] = outputs
            if t > 0:
                predicted.append(outputs)
        return torch.stack(predicted, dim=1).cpu().numpy().astype(np.float64)
