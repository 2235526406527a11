"""Dataset collections: the four benchmark subsets (train_f, val_f,
test_cf_one_step, test_cf_treatment_seq) and the processing entry point of
the ODE-discovery methods, for the EQ_4 family."""

from __future__ import annotations

import torch

from insite_tpu_torch.core.constants import MAX_VALUE
from insite_tpu_torch.data.dataset import SeqDataset
from insite_tpu_torch.data.processing import process_data_pkpd
from insite_tpu_torch.sim import pkpd

SUBSETS = ('train_f', 'val_f', 'test_cf_one_step', 'test_cf_treatment_seq')


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
        self.seed = None
        self.device = None
        self.equation = pkpd.Equation[equation_name]
        self.equation_name = equation_name
        self.projection_horizon = projection_horizon
        self.treatment_mode = treatment_mode
        self.norm_const = MAX_VALUE
        names = {'train_f': 'train', 'val_f': 'val',
                 'test_cf_one_step': 'test', 'test_cf_treatment_seq': 'test'}
        for attr in SUBSETS:
            setattr(self, attr, SeqDataset(dict(raw_subsets[attr]),
                                           names[attr], norm_const=MAX_VALUE))
        self.train_scaling_params = scaling_params
        return self

    def _process(self, ds: SeqDataset, include_continuous_treatment=False):
        process_data_pkpd(ds, self.train_scaling_params, self.treatment_mode,
                          self.equation_name, include_continuous_treatment)


def make_collection(dataset_name: str, num_patients: dict, seed: int,
                    coeff: float, *, device, **kwargs) -> DatasetCollection:
    """Factory keyed like run.py's dataset names."""
    if 'EQ_4' in dataset_name:
        return PkpdDatasetCollection(conf_coeff=coeff,
                                     num_patients=num_patients,
                                     equation_str=dataset_name, seed=seed,
                                     device=device, **kwargs)
    if dataset_name == 'cancer_sim' or 'EQ_5' in dataset_name:
        raise NotImplementedError(
            f'{dataset_name}: the tumor family (cancer_sim, EQ_5_*) is '
            'Slice 3 of the port (ROADMAP.md)')
    raise ValueError(f'unknown dataset {dataset_name}')
