"""Raw simulation -> the unified data dict: scaling, one-hot treatment
encodings and active-entry masks (numpy, as `insite_tpu.data.processing`),
for the PKPD EQ_4 family and the tumor family (cancer_sim and EQ_5, which
can add the scaled chemo dosage as a covariate).
"""

from __future__ import annotations

import numpy as np

from insite_tpu_torch.data.dataset import (SeqDataset,
                                           active_entries_from_lengths,
                                           one_hot_binary, one_hot_pairs)


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


def process_data_tumor(ds: SeqDataset, scaling_params, treatment_mode: str,
                       equation_name: str = 'CANCER_SIM',
                       include_continuous_treatment: bool = False) -> dict:
    """Shared by cancer_sim and EQ_5: the covariates are [volume, patient
    type] and, with ``include_continuous_treatment``, the chemo dosage, so
    the statics are [patient type, dosage at t = 0]."""
    if ds.processed:
        return ds.data
    mean, std = scaling_params
    d = ds.data

    pt_std = std['patient_types']
    if equation_name in ('EQ_5_A', 'EQ_5_B'):
        pt_std = 1.0   # a single patient type: its std is 0

    input_means = [mean['cancer_volume'], mean['patient_types']]
    input_stds = [std['cancer_volume'], pt_std]
    if include_continuous_treatment:
        input_means.append(mean['chemo_dosage'])
        input_stds.append(std['chemo_dosage'])
    input_means = np.array(input_means + [0.0, 0.0])
    input_stds = np.array(input_stds + [1.0, 1.0])

    vol = (d['cancer_volume'] - mean['cancer_volume']) / std['cancer_volume']
    patient_types = (d['patient_types'] - mean['patient_types']) / pt_std
    T = vol.shape[1]
    pt_rep = np.repeat(np.asarray(patient_types)[:, None], T, axis=1)

    chemo = d['chemo_application']
    radio = d['radio_application']
    lengths = d['sequence_lengths']

    if treatment_mode == 'multiclass':
        one_hot = one_hot_pairs(chemo[:, :-1], radio[:, :-1])
        d['prev_treatments'] = one_hot[:, :-1, :]
        d['current_treatments'] = one_hot
    else:  # multilabel: the raw (chemo, radio) columns
        treatments = np.stack([chemo[:, :-1], radio[:, :-1]], axis=-1)
        d['prev_treatments'] = treatments[:, :-1, :]
        d['current_treatments'] = treatments

    cov = [vol[:, :-1], pt_rep[:, :-1]]
    if include_continuous_treatment:
        dose = ((d['chemo_dosage'] - mean['chemo_dosage']) /
                std['chemo_dosage'])
        cov.append(dose[:, :-1])
    current_covariates = np.stack(cov, axis=-1)
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
