"""Causal Transformer (CT): a multi-input transformer over the treatment
and outcome streams with a balanced representation trained by domain
confusion, in the meaning of `insite_tpu.models.ct`.

ONE relative-position k table and ONE v table (`CTNetwork.self_pe_k`,
``self_pe_v``) serve every attention module of every block. Multi-step
prediction runs ``projection_horizon + 1`` forward passes over the n-step
test rows, each writing its predictions into ``prev_outputs`` after the
rolling origin.

With ``dim_vitals`` > 0 (a real-data collection's vitals stream) every
block carries a third stream. A row with a split (``fixed_split`` of the
masked-vitals augmentation, or the n-step rows' ``future_past_split``)
sees its vitals only before the split, and its representation averages
the three streams there and the other two after it.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.models.nn.blocks import (BRTreatmentOutcomeHead,
                                               RelativePositionalEncoding,
                                               TransformerMultiInputBlock,
                                               dropout)
from insite_tpu_torch.models.nn.training import (BRStage, TrainConfig,
                                                 seeded_net)


@dataclass
class CTConfig:
    """The JAX package's `CTConfig`: the reference's tuned hyperparameters."""

    dim_treatments: int = 2
    dim_static_features: int = 2
    dim_outcome: int = 1
    # the vitals stream of real-EHR collections (every synthetic benchmark
    # has none)
    dim_vitals: int = 0
    # with vitals: each training batch doubled with a copy whose vitals are
    # masked from a random split on (`ct_augment_fn`)
    augment_with_masked_vitals: bool = True
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
    ``num_layer`` blocks (``block_{i}``) over two streams, or three with
    ``dim_vitals`` (``vitals_input``), their mean and the
    balanced-representation head."""

    def __init__(self, cfg: CTConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        H = cfg.seq_hidden_units
        head_size = H // cfg.num_heads
        self.dropout_rate = cfg.dropout_rate
        self.treatments_input = nn.Linear(cfg.dim_treatments, H, **kw)
        self.outputs_input = nn.Linear(cfg.dim_outcome, H, **kw)
        self.static_input = nn.Linear(cfg.dim_static_features, H, **kw)
        self.vitals_input = (nn.Linear(cfg.dim_vitals, H, **kw)
                             if cfg.dim_vitals > 0 else None)
        self.self_pe_k = RelativePositionalEncoding(
            cfg.max_relative_position, head_size, **kw)
        self.self_pe_v = RelativePositionalEncoding(
            cfg.max_relative_position, head_size, **kw)
        self.blocks = []
        for i in range(cfg.num_layer):
            block = TransformerMultiInputBlock(
                H, cfg.num_heads, head_size, H * 4, cfg.dropout_rate,
                cfg.dropout_rate, has_vitals=cfg.dim_vitals > 0, **kw)
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
            active = batch['active_entries']
            T = x_t.shape[1]
            x_v = active_vitals = pre = None
            if self.vitals_input is not None:
                vitals, active_vitals = batch['vitals'], active
                split = batch.get('fixed_split',
                                  batch.get('future_past_split'))
                if split is not None:
                    pre = (torch.arange(T, device=split.device)[None, :] <
                           split[:, None])[..., None]      # [B, T, 1]
                    vitals = vitals * pre
                    active_vitals = active * pre
                x_v = self.vitals_input(vitals)
            rel_k = self.self_pe_k(T, T)
            rel_v = self.self_pe_v(T, T)
            for block in self.blocks:
                streams = block(x_t, x_o, x_s, active, gen, rel_k, rel_v,
                                x_v, active_vitals)
                if x_v is None:
                    x_t, x_o = streams
                else:
                    x_t, x_o, x_v = streams
            if x_v is None:
                x = (x_o + x_t) / 2
            elif pre is None:
                x = (x_o + x_t + x_v) / 3
            else:
                # past the split only the t and o streams carry signal
                x = torch.where(pre, (x_o + x_t + x_v) / 3, (x_o + x_t) / 2)
            x = dropout(x, self.dropout_rate, gen)
        return self.br_treatment_outcome_head(
            x, batch['current_treatments'], alpha, detach_treatment)


BATCH_KEYS = ('prev_treatments', 'prev_outputs', 'static_features',
              'current_treatments', 'outputs', 'active_entries')
INPUT_KEYS = ('prev_treatments', 'prev_outputs', 'static_features',
              'current_treatments', 'active_entries')
# with vitals, the keys a batch takes where the dataset carries them: the
# stream and the n-step rows' split
VITALS_KEYS = ('vitals', 'future_past_split')


def masked_vitals_split(batch: dict, gen) -> torch.Tensor:
    """Per row of ``batch`` a split drawn uniformly from 0..sequence length
    (``floor(u * (length + 1))``, u from ``gen``), float like the
    batch."""
    seq_len = batch['active_entries'][..., 0].sum(dim=1)
    u = torch.rand(seq_len.shape, generator=gen, device=seq_len.device,
                   dtype=seq_len.dtype)
    return torch.floor(u * (seq_len + 1.0))


def double_with_split(batch: dict, rand_split) -> dict:
    """The batch twice over: the originals keep their whole vitals (split
    = their length), the copies take ``rand_split`` (``fixed_split``)."""
    seq_len = batch['active_entries'][..., 0].sum(dim=1)
    doubled = {k: torch.cat([v, v]) for k, v in batch.items()}
    doubled['fixed_split'] = torch.cat([seq_len, rand_split])
    return doubled


def ct_augment_fn(batch: dict, gen) -> dict:
    """The masked-vitals training augmentation: each batch doubled, the
    copies' vitals masked from a random split on (`masked_vitals_split`,
    `double_with_split`)."""
    return double_with_split(batch, masked_vitals_split(batch, gen))


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
    then. With vitals, training batches are augmented by `ct_augment_fn`
    unless ``cfg.augment_with_masked_vitals`` is off; its splits come from
    the fit's generator on ``device``."""

    def __init__(self, cfg: CTConfig, dataset_collection=None, *, device,
                 dtype=None):
        device, dtype = torch.device(device), resolve_float(dtype)
        net = seeded_net(cfg.seed, lambda: CTNetwork(cfg, dtype=dtype),
                         device)
        vitals = cfg.dim_vitals > 0
        super().__init__(
            net, ct_train_config(cfg), cfg.seed, BATCH_KEYS, INPUT_KEYS,
            device=device, dtype=dtype,
            optional_keys=VITALS_KEYS if vitals else (),
            augment_fn=(ct_augment_fn if vitals and
                        cfg.augment_with_masked_vitals else None))
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
        batch = self.batch(dataset.data, INPUT_KEYS)
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
