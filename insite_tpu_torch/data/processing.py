"""Raw PKPD simulation -> the unified data dict: scaling, one-hot treatment
encodings and active-entry masks (numpy, as `insite_tpu.data.processing`).
"""

from __future__ import annotations

import numpy as np

from insite_tpu_torch.data.dataset import (SeqDataset,
                                           active_entries_from_lengths,
                                           one_hot_binary)


def process_data_pkpd(ds: SeqDataset, scaling_params, treatment_mode: str,
                      equation_name: str = 'EQ_4_A',
                      include_continuous_treatment: bool = False) -> dict:
    if ds.processed:
        return ds.data
    mean, std = scaling_params
    d = ds.data

    input_means = np.array([mean['cancer_volume'],
                            mean['observed_static_c_0'],
                            mean['observed_static_c_1'], 0.0])
    input_stds = np.array([std['cancer_volume'],
                           std['observed_static_c_0'],
                           std['observed_static_c_1'], 1.0])

    vol = (d['cancer_volume'] - mean['cancer_volume']) / std['cancer_volume']
    c0 = ((d['observed_static_c_0'] - mean['observed_static_c_0']) /
          std['observed_static_c_0'])
    c1 = ((d['observed_static_c_1'] - mean['observed_static_c_1']) /
          std['observed_static_c_1'])
    T = vol.shape[1]
    c0_rep = np.repeat(c0[:, None], T, axis=1)
    c1_rep = np.repeat(c1[:, None], T, axis=1)

    app = d['treatment_application']
    lengths = d['sequence_lengths']
    treatments = app[:, :-1, None]

    if treatment_mode == 'multiclass':
        one_hot = one_hot_binary(app[:, :-1])
        d['prev_treatments'] = one_hot[:, :-1, :]
        d['current_treatments'] = one_hot
    else:  # multilabel: keep the raw binary column
        d['prev_treatments'] = treatments[:, :-1, :]
        d['current_treatments'] = treatments

    current_covariates = np.stack(
        [vol[:, :-1], c0_rep[:, :-1], c1_rep[:, :-1]], axis=-1)
    outputs = vol[:, 1:, None]

    d['current_covariates'] = current_covariates
    d['outputs'] = outputs
    d['active_entries'] = active_entries_from_lengths(lengths,
                                                      outputs.shape[1])
    d['unscaled_outputs'] = (outputs * std['cancer_volume'] +
                             mean['cancer_volume'])
    ds.scaling_params = {
        'input_means': input_means,
        'inputs_stds': input_stds,
        'output_means': mean['cancer_volume'],
        'output_stds': std['cancer_volume'],
    }
    d['prev_outputs'] = current_covariates[:, :, :1]
    d['static_features'] = current_covariates[:, 0, 1:]
    zero_init = np.zeros((len(ds), 1, d['prev_treatments'].shape[-1]))
    d['prev_treatments'] = np.concatenate(
        [zero_init, d['prev_treatments']], axis=1)
    ds.processed = True
    return d
