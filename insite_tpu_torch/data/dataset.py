"""Dataset container and the shared sequence-processing pipeline.

Pure numpy, as in `insite_tpu.data.dataset`: the unified data dict of one
subset (train_f / val_f / test_cf_*) with keys

    prev_treatments, current_treatments, prev_outputs, outputs,
    static_features, active_entries, sequence_lengths, unscaled_outputs,
    current_covariates

- ``explode_trajectories``: every patient becomes all its prefixes longer
  than the projection horizon,
- ``process_sequential``: the rolling-origin rows a decoder trains on,
- ``process_sequential_test``: the last ``projection_horizon`` steps of every
  test row (the n-step evaluation targets),
- ``process_autoregressive_test``: the placeholder rows of step-by-step
  autoregressive decoding,
- ``process_sequential_multi``: restore the original rows for the
  multi-input models (the ODE family, MSM) and mark the rolling origin.

Each step replaces ``self.data`` with a new dict and writes into no array
of the old one. ``process_sequential_test`` and ``process_sequential_multi``
therefore keep the original rows by reference (the n-step test set is the
largest subset, and every run of the sweep passes through both); a model
that writes into a dataset's arrays works on its own deep copy, as
`models/msm.py::MSM._exploded` does. The decoder path's steps
(``process_sequential``, ``process_autoregressive_test``) set their dicts
aside as deep copies, as the JAX package does.
"""

from __future__ import annotations

from copy import deepcopy

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
        self.exploded = False
        self.scaling_params = None
        self.sim_params = None

    def __len__(self):
        return self.data['current_covariates'].shape[0]

    def explode_trajectories(self, projection_horizon: int):
        """Each patient row becomes one row per prefix length in
        [projection_horizon + 1, sequence_length]."""
        assert self.processed
        d = self.data
        lengths = d['sequence_lengths'].astype(np.int64)
        num_patients, max_seq_length, _ = d['outputs'].shape

        counts = np.maximum(lengths - projection_horizon, 0)
        row_patient = np.repeat(np.arange(num_patients), counts)
        # per-row prefix end t in [projection_horizon, L)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        row_t = (np.arange(counts.sum()) - np.repeat(starts, counts)
                 + projection_horizon)

        keep = np.arange(max_seq_length)[None, :] <= row_t[:, None]  # [R, T]

        def prefix(x):
            return x[row_patient] * keep[..., None]

        new = {
            'prev_treatments': prefix(d['prev_treatments']),
            'current_treatments': prefix(d['current_treatments']),
            'static_features': d['static_features'][row_patient],
            'prev_outputs': prefix(d['prev_outputs']),
            'outputs': prefix(d['outputs']),
            'active_entries': prefix(d['active_entries']),
            'sequence_lengths': (row_t + 1).astype(np.float64),
        }
        if 'current_covariates' in d:
            new['current_covariates'] = prefix(d['current_covariates'])
        if 'vitals' in d:
            # a vitals stream: next_vitals[t] = vitals[t + 1], one step
            # shorter
            new['vitals'] = prefix(d['vitals'])
            new['next_vitals'] = new['vitals'][:, 1:]
        new['unscaled_outputs'] = (new['outputs'] *
                                   self.scaling_params['output_stds'] +
                                   self.scaling_params['output_means'])
        if 'stabilized_weights' in d:
            new['stabilized_weights'] = \
                d['stabilized_weights'][row_patient] * keep
        self.data = new
        self.exploded = True
        return self.data

    def process_sequential(self, encoder_r, projection_horizon: int,
                           save_encoder_r: bool = False):
        """Rolling-origin explosion for decoder training: one row per
        (patient, origin t) with t in [1, L - projection_horizon), starting
        from the encoder's representation ``encoder_r[patient, t - 1]``."""
        assert self.processed
        if self.processed_sequential:
            return self.data
        d = self.data
        ph = projection_horizon
        lengths = d['sequence_lengths'].astype(np.int64)
        num_patients, seq_length, _ = d['outputs'].shape
        prev_treatments = d['prev_treatments'][:, 1:, :]  # drop zero-init row

        counts = np.maximum(lengths - ph - 1, 0)
        row_patient = np.repeat(np.arange(num_patients), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        row_t = np.arange(counts.sum()) - np.repeat(starts, counts) + 1

        win = row_t[:, None] + np.arange(ph)[None, :]       # [R, ph]

        def slice_win(x, offset=0):
            return x[row_patient[:, None], win + offset]

        seq2seq = {
            'init_state': encoder_r[row_patient, row_t - 1],
            'original_index': row_patient.astype(np.float64),
            'active_encoder_r':
                (np.arange(seq_length)[None, :] <
                 row_t[:, None]).astype(np.float64),
            'prev_treatments': slice_win(prev_treatments, offset=-1),
            'current_treatments': slice_win(d['current_treatments']),
            'current_covariates': slice_win(d['current_covariates']),
            'outputs': slice_win(d['outputs']),
            'active_entries': slice_win(d['active_entries']),
            'sequence_lengths': np.full(counts.sum(), ph, dtype=np.float64),
        }
        seq2seq['prev_outputs'] = seq2seq['current_covariates'][:, :, :1]
        seq2seq['static_features'] = seq2seq['current_covariates'][:, 0, 1:]
        seq2seq['unscaled_outputs'] = (
            seq2seq['outputs'] * self.scaling_params['output_stds'] +
            self.scaling_params['output_means'])
        if 'stabilized_weights' in d:
            sw_win = row_t[:, None] + np.arange(ph + 1)[None, :] - 1
            seq2seq['stabilized_weights'] = \
                d['stabilized_weights'][row_patient[:, None], sw_win]

        self.data_original = deepcopy(self.data)
        self.data = seq2seq
        if save_encoder_r:
            self.encoder_r = encoder_r[:, :seq_length, :]
        self.processed_sequential = True
        self.exploded = True
        return self.data

    def process_sequential_test(self, projection_horizon: int, encoder_r=None,
                                save_encoder_r: bool = False):
        """Take the last ``projection_horizon`` steps of every test row;
        with ``encoder_r``, each row starts from the encoder's
        representation of its last factual step."""
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
        if 'vitals' in d:
            # the observed (factual) vitals over the evaluation window
            seq2seq['vitals'] = d['vitals'][rows, win]
        if encoder_r is not None:
            seq2seq['init_state'] = encoder_r[np.arange(num_rows),
                                              fact_length - 1]
        for k in ('observed_static_c_0', 'observed_static_c_1',
                  'patient_types'):
            if k in d:
                seq2seq[k] = d[k]

        self.data_original = d
        self.data = seq2seq
        if save_encoder_r and encoder_r is not None:
            self.encoder_r = encoder_r[:, :max_seq_length - ph, :]
        self.processed_sequential = True
        return self.data

    def process_autoregressive_test(self, encoder_r, encoder_outputs,
                                    projection_horizon: int,
                                    save_encoder_r: bool = False):
        """Placeholder rows for step-by-step autoregressive decoding: the
        planned treatments of the evaluation window, and covariates that are
        zero but for the encoder's prediction at the last factual step."""
        assert self.processed_sequential
        if self.processed_autoregressive:
            return self.data
        od = self.data_original
        ph = projection_horizon
        lengths = od['sequence_lengths'].astype(np.int64)
        num_rows, max_seq_length = od['current_treatments'].shape[:2]
        prev_treatments = od['prev_treatments'][:, 1:, :]
        fact_length = lengths - ph
        rows = np.arange(num_rows)
        win = fact_length[:, None] + np.arange(ph)[None, :]

        cur = {
            'current_covariates': np.zeros(
                (num_rows, ph, od['current_covariates'].shape[-1])),
            'prev_treatments': prev_treatments[rows[:, None], win - 1],
            'current_treatments': od['current_treatments'][rows[:, None], win],
            'init_state': encoder_r[rows, fact_length - 1],
            'active_encoder_r':
                (np.arange(max_seq_length - ph)[None, :] <
                 fact_length[:, None]).astype(np.float64),
            'active_entries': np.ones((num_rows, ph, 1)),
        }
        cur['current_covariates'][:, 0, 0] = \
            encoder_outputs[rows, fact_length - 1, 0] \
            if encoder_outputs.ndim == 3 else \
            encoder_outputs[rows, fact_length - 1]
        cur['prev_outputs'] = cur['current_covariates'][:, :, :1]
        cur['static_features'] = od['static_features']
        if 'vitals' in od:
            cur['vitals'] = od['vitals'][rows[:, None], win]

        self.data_processed_seq = deepcopy(self.data)
        self.data = cur
        if save_encoder_r:
            self.encoder_r = encoder_r[:, :max_seq_length - ph, :]
        self.processed_autoregressive = True
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
