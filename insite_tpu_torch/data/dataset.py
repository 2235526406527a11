"""Dataset container and the sequence processing the main table needs.

Pure numpy, as in `insite_tpu.data.dataset`: the unified data dict of one
subset (train_f / val_f / test_cf_*) with keys

    prev_treatments, current_treatments, prev_outputs, outputs,
    static_features, active_entries, sequence_lengths, unscaled_outputs,
    current_covariates

- ``process_sequential_test``: the last ``projection_horizon`` steps of every
  test row (the n-step evaluation targets),
- ``process_sequential_multi``: restore the original rows for the
  multi-input (ODE) models and mark the rolling origin.

The processing steps replace ``self.data`` with new dicts and never write
into an array in place, so the kept originals are references, not copies.
"""

from __future__ import annotations

import numpy as np


class SeqDataset:
    """A processed subset of one benchmark.

    ``data`` is a dict of numpy arrays with a leading row dimension.
    ``norm_const`` is the normalisation constant of the RMSE protocol
    (MAX_VALUE for EQ_4, the tumour death threshold for cancer_sim and
    EQ_5).
    """

    def __init__(self, data: dict, subset_name: str, norm_const: float):
        self.data = data
        self.subset_name = subset_name
        self.norm_const = norm_const
        self.processed = False
        self.processed_sequential = False
        self.processed_autoregressive = False
        self.scaling_params = None
        self.sim_params = None

    def __len__(self):
        return self.data['current_covariates'].shape[0]

    def process_sequential_test(self, projection_horizon: int):
        """Take the last ``projection_horizon`` steps of every test row."""
        assert self.processed
        if self.processed_sequential:
            return self.data
        d = self.data
        ph = projection_horizon
        lengths = d['sequence_lengths'].astype(np.int64)
        num_rows, max_seq_length, _ = d['outputs'].shape
        prev_treatments = d['prev_treatments'][:, 1:, :]

        fact_length = lengths - ph
        win = fact_length[:, None] + np.arange(ph)[None, :]
        rows = np.arange(num_rows)[:, None]

        seq2seq = {
            'active_encoder_r':
                (np.arange(max_seq_length - ph)[None, :] <
                 fact_length[:, None]).astype(np.float64),
            'prev_treatments': prev_treatments[rows, win - 1],
            'current_treatments': d['current_treatments'][rows, win],
            'outputs': d['outputs'][rows, win],
            'active_entries': np.ones((num_rows, ph, 1)),
            'sequence_lengths': np.full(num_rows, ph, dtype=np.float64),
            # teacher forcing disabled: repeat the last factual covariates
            'current_covariates': np.repeat(
                d['current_covariates'][np.arange(num_rows),
                                        fact_length - 1][:, None, :],
                ph, axis=1),
        }
        seq2seq['prev_outputs'] = seq2seq['current_covariates'][:, :, :1]
        seq2seq['static_features'] = seq2seq['current_covariates'][:, 0, 1:]
        seq2seq['unscaled_outputs'] = (
            seq2seq['outputs'] * self.scaling_params['output_stds'] +
            self.scaling_params['output_means'])
        for k in ('observed_static_c_0', 'observed_static_c_1',
                  'patient_types'):
            if k in d:
                seq2seq[k] = d[k]

        self.data_original = d
        self.data = seq2seq
        self.processed_sequential = True
        return self.data

    def process_sequential_multi(self, projection_horizon: int):
        """Multi-input n-step evaluation: restore the original rows and
        mark the rolling origin."""
        assert self.processed_sequential
        if self.processed_autoregressive:
            return self.data
        self.data_processed_seq = self.data
        self.data = dict(self.data_original)
        self.data['future_past_split'] = \
            self.data['sequence_lengths'] - projection_horizon
        self.processed_autoregressive = True
        return self.data


def one_hot_pairs(app_a: np.ndarray, app_b: np.ndarray) -> np.ndarray:
    """4-class one-hot of two binary applications (chemo, radio):
    (0,0)->e0, (1,0)->e1, (0,1)->e2, (1,1)->e3."""
    return np.eye(4)[(app_a + 2 * app_b).astype(np.int64)]


def one_hot_binary(app: np.ndarray) -> np.ndarray:
    """2-class one-hot of a single binary application."""
    return np.eye(2)[app.astype(np.int64)]


def active_entries_from_lengths(lengths, horizon_len: int) -> np.ndarray:
    mask = (np.arange(horizon_len)[None, :] <
            lengths.astype(np.int64)[:, None])
    return mask[..., None].astype(np.float64)
