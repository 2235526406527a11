"""Dataset collections: the four benchmark subsets (train_f, val_f,
test_cf_one_step, test_cf_treatment_seq) and the processing entry point of
the ODE-discovery methods, for the EQ_4 family and the tumor family
(cancer_sim and EQ_5)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from insite_tpu_torch.core.constants import MAX_VALUE
from insite_tpu_torch.data.dataset import SeqDataset
from insite_tpu_torch.data.processing import (process_data_pkpd,
                                              process_data_tumor)
from insite_tpu_torch.sim import cancer, continuous, pkpd
from insite_tpu_torch.sim.tumor import TUMOUR_DEATH_THRESHOLD

SUBSETS = ('train_f', 'val_f', 'test_cf_one_step', 'test_cf_treatment_seq')
SUBSET_NAMES = {'train_f': 'train', 'val_f': 'val',
                'test_cf_one_step': 'test', 'test_cf_treatment_seq': 'test'}


class DatasetCollection:
    """train_f / val_f / test_cf_one_step / test_cf_treatment_seq."""

    def __init__(self):
        self.processed_data_multi = False
        self.train_f = None
        self.val_f = None
        self.test_cf_one_step = None
        self.test_cf_treatment_seq = None
        self.train_scaling_params = None
        self.projection_horizon = None
        self.treatment_mode = 'multiclass'

    def _process(self, ds: SeqDataset, include_continuous_treatment=False):
        raise NotImplementedError

    def _adopt_subsets(self, raw_subsets: dict, scaling_params,
                       projection_horizon: int, treatment_mode: str):
        """Take already simulated, unprocessed subsets (numpy dicts keyed
        like `SUBSETS`) and the train scaling parameters ``(means,
        stds)``."""
        self.seed = None
        self.device = None
        self.projection_horizon = projection_horizon
        self.treatment_mode = treatment_mode
        for attr in SUBSETS:
            setattr(self, attr, SeqDataset(dict(raw_subsets[attr]),
                                           SUBSET_NAMES[attr],
                                           norm_const=self.norm_const))
        self.train_scaling_params = scaling_params

    def process_data_multi(self, include_continuous_treatment=False):
        """The processing of CT and the SINDy family: every subset, then the
        n-step test set's evaluation windows."""
        for name in SUBSETS:
            ds = getattr(self, name)
            if ds is not None:
                self._process(ds, include_continuous_treatment)
        self.test_cf_treatment_seq.process_sequential_test(
            self.projection_horizon)
        self.test_cf_treatment_seq.process_sequential_multi(
            self.projection_horizon)
        self.processed_data_multi = True


class PkpdDatasetCollection(DatasetCollection):
    """EQ_4 family collection, simulated on ``device``.

    Each subset draws its parameters from a fresh generator seeded with
    ``seed``, so test_cf_one_step and test_cf_treatment_seq describe the
    same test patients (same count, same parameters, same arms)."""

    def __init__(self, conf_coeff, num_patients: dict, equation_str: str,
                 seed: int, window_size=15, max_seq_length=60,
                 projection_horizon=5, lag=0,
                 cf_seq_mode='sliding_treatment',
                 treatment_mode='multiclass', dtype=None, noise_scale=1.0,
                 *, device, **kwargs):
        super().__init__()
        self.seed = seed
        self.device = torch.device(device)
        self.equation = pkpd.Equation[equation_str]
        self.equation_name = equation_str
        self.projection_horizon = projection_horizon
        self.treatment_mode = treatment_mode
        self.norm_const = MAX_VALUE

        def subset(n, mode, name):
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = pkpd.generate_params(
                n, conf_coeff=conf_coeff, window_size=window_size, lag=lag,
                generator=gen, equation=self.equation, device=self.device,
                dtype=dtype)
            # the noise sweep scales the observation-noise std of B/C/D
            params['observation_noise'] = \
                params['observation_noise'] * noise_scale
            if mode == 'factual':
                data = pkpd.simulate_factual(params, max_seq_length, gen,
                                             self.equation, dtype=dtype)
            elif mode == 'counterfactual_one_step':
                data = pkpd.simulate_counterfactual_1_step(
                    params, max_seq_length, gen, self.equation, dtype=dtype)
            else:
                data = pkpd.simulate_counterfactuals_treatment_seq(
                    params, max_seq_length, projection_horizon, gen,
                    self.equation, cf_seq_mode=cf_seq_mode, dtype=dtype)
            ds = SeqDataset(data, name, norm_const=MAX_VALUE)
            ds.sim_params = {k: (v.cpu().numpy() if torch.is_tensor(v)
                                 else v) for k, v in params.items()}
            return ds

        self.train_f = subset(num_patients['train'], 'factual', 'train')
        self.val_f = subset(num_patients['val'], 'factual', 'val')
        self.test_cf_one_step = subset(num_patients['test'],
                                       'counterfactual_one_step', 'test')
        self.test_cf_treatment_seq = subset(
            num_patients['test'], 'counterfactual_treatment_seq', 'test')
        self.train_scaling_params = pkpd.get_scaling_params(
            self.train_f.data)

    @classmethod
    def from_subsets(cls, raw_subsets: dict, scaling_params,
                     equation_name: str, *, projection_horizon: int,
                     treatment_mode: str) -> 'PkpdDatasetCollection':
        """A collection over already simulated, unprocessed subsets (numpy
        dicts keyed like `SUBSETS`), with the given train scaling
        parameters ``(means, stds)``."""
        self = cls.__new__(cls)
        DatasetCollection.__init__(self)
        self.equation = pkpd.Equation[equation_name]
        self.equation_name = equation_name
        self.norm_const = MAX_VALUE
        self._adopt_subsets(raw_subsets, scaling_params, projection_horizon,
                            treatment_mode)
        return self

    def _process(self, ds: SeqDataset, include_continuous_treatment=False):
        process_data_pkpd(ds, self.train_scaling_params, self.treatment_mode,
                          self.equation_name, include_continuous_treatment)


class CancerDatasetCollection(DatasetCollection):
    """cancer_sim collection, simulated on ``device``.

    Unlike the EQ_4 collection, the four subsets draw, in order, from one
    ``np.random.RandomState(seed)``: train, val, test_cf_one_step,
    test_cf_treatment_seq. So the two test sets hold different patients.
    At equal seed the cohorts are the JAX package's (which seeds the global
    ``np.random`` once and draws in the same order)."""

    equation_name = 'CANCER_SIM'

    def __init__(self, chemo_coeff, radio_coeff, num_patients: dict,
                 seed: int, window_size=15, max_seq_length=60,
                 projection_horizon=5, lag=0,
                 cf_seq_mode='sliding_treatment',
                 treatment_mode='multiclass', dtype=None, *, device,
                 **kwargs):
        super().__init__()
        self.seed = seed
        self.device = torch.device(device)
        self.projection_horizon = projection_horizon
        self.treatment_mode = treatment_mode
        self.norm_const = TUMOUR_DEATH_THRESHOLD
        rs = np.random.RandomState(seed)
        kw = dict(device=self.device, dtype=dtype)

        def subset(n, mode, name):
            params = self._sim('generate_params')(
                n, chemo_coeff=chemo_coeff, radio_coeff=radio_coeff,
                window_size=window_size, lag=lag, rs=rs)
            if mode == 'factual':
                data = self._sim('simulate_factual')(
                    params, max_seq_length, rs, **kw)
            elif mode == 'counterfactual_one_step':
                data = self._sim('simulate_counterfactual_1_step')(
                    params, max_seq_length, rs, **kw)
            else:
                data = self._sim('simulate_counterfactuals_treatment_seq')(
                    params, max_seq_length, projection_horizon, rs,
                    cf_seq_mode=cf_seq_mode, **kw)
            ds = SeqDataset(data, name, norm_const=TUMOUR_DEATH_THRESHOLD)
            ds.sim_params = params
            return ds

        self.train_f = subset(num_patients['train'], 'factual', 'train')
        self.val_f = subset(num_patients['val'], 'factual', 'val')
        self.test_cf_one_step = subset(num_patients['test'],
                                       'counterfactual_one_step', 'test')
        self.test_cf_treatment_seq = subset(
            num_patients['test'], 'counterfactual_treatment_seq', 'test')
        self.train_scaling_params = cancer.get_scaling_params(
            self.train_f.data)

    def _sim(self, name: str):
        """The simulator function ``name`` of this family."""
        return getattr(cancer, name)

    @classmethod
    def from_subsets(cls, raw_subsets: dict, scaling_params,
                     equation_name: str, *, projection_horizon: int,
                     treatment_mode: str) -> 'CancerDatasetCollection':
        """A collection over already simulated, unprocessed subsets (numpy
        dicts keyed like `SUBSETS`), with the given train scaling
        parameters ``(means, stds)``."""
        self = cls.__new__(cls)
        DatasetCollection.__init__(self)
        self.equation_name = equation_name
        self.norm_const = TUMOUR_DEATH_THRESHOLD
        self._adopt_subsets(raw_subsets, scaling_params, projection_horizon,
                            treatment_mode)
        return self

    def _process(self, ds: SeqDataset, include_continuous_treatment=False):
        process_data_tumor(ds, self.train_scaling_params, self.treatment_mode,
                           self.equation_name, include_continuous_treatment)


class ContinuousDatasetCollection(CancerDatasetCollection):
    """EQ_5 A-D collection: the cancer model with the variant's
    heterogeneity and observation noise, and the chemo dosage rows in the
    counterfactual sets."""

    def __init__(self, chemo_coeff, radio_coeff, num_patients: dict,
                 equation_str: str, seed: int, **kwargs):
        self.equation_name = equation_str
        super().__init__(chemo_coeff, radio_coeff, num_patients, seed,
                         **kwargs)

    def _sim(self, name: str):
        return functools.partial(getattr(continuous, name),
                                 equation=pkpd.Equation[self.equation_name])


def make_collection(dataset_name: str, num_patients: dict, seed: int,
                    coeff: float, *, device, **kwargs) -> DatasetCollection:
    """Factory keyed like run.py's dataset names."""
    if 'EQ_4' in dataset_name:
        return PkpdDatasetCollection(conf_coeff=coeff,
                                     num_patients=num_patients,
                                     equation_str=dataset_name, seed=seed,
                                     device=device, **kwargs)
    if dataset_name == 'cancer_sim':
        return CancerDatasetCollection(chemo_coeff=coeff, radio_coeff=coeff,
                                       num_patients=num_patients, seed=seed,
                                       device=device, **kwargs)
    if 'EQ_5' in dataset_name:
        return ContinuousDatasetCollection(chemo_coeff=coeff,
                                           radio_coeff=coeff,
                                           num_patients=num_patients,
                                           equation_str=dataset_name,
                                           seed=seed, device=device,
                                           **kwargs)
    raise ValueError(f'unknown dataset {dataset_name}')
