"""Experiment configuration: the outer sweep config as a plain dataclass,
with the fields and defaults of `insite_tpu.harness.config.RunConfig`,
loaded from YAML (`RunConfig.from_yaml`, which needs PyYAML) or from a
plain mapping (`RunConfig.from_dict`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# per-dataset SINDy hyperparameters
SINDY_THRESHOLD = {'cancer_sim': 0.001, 'EQ_5': 0.001, 'EQ_4': 0.1}
SINDY_LAM = {'cancer_sim': 10.0, 'EQ_5': 10.0, 'EQ_4': 10.0}
SINDY_ALPHA = 0.5


def sindy_params_for(dataset_name: str):
    thr = [v for k, v in SINDY_THRESHOLD.items() if k in dataset_name]
    lam = [v for k, v in SINDY_LAM.items() if k in dataset_name]
    assert len(thr) == 1 and len(lam) == 1
    return thr[0], lam[0]


def model_dataset_name(dataset_name: str) -> str:
    """The name a model config and a collection give a run's dataset: the
    run name 'cancer_sim' is 'CANCER_SIM' there, as in the JAX package;
    every other name is the same."""
    return 'CANCER_SIM' if dataset_name == 'cancer_sim' else dataset_name


@dataclass
class RunConfig:
    """Outer sweep config."""

    epochs: int = 100
    train_samples: int = 1000
    val_samples: int = 100
    test_samples: int = 100
    domain_conf: float = 2.0
    seed_start: int = 0
    seed_runs: int = 10
    methods: tuple = ('insite', 'sindy', 'wsindy', 'crn', 'msm', 'gnet',
                      'ct', 'rmsn', 'edct')
    datasets: tuple = ('cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D',
                       'EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D')
    domain_confs: tuple = (0, 1, 2, 3, 4)
    noise_scales: tuple = (0.0, 0.5, 1.0, 2.0, 5.0)
    train_sample_grid: tuple = (50, 100, 250, 500, 1000)
    noise_scale: float = 1.0
    experiment: str = 'MAIN_TABLE'
    gnet_mc_samples: int = 25
    cf_seq_mode: str = 'sliding_treatment'
    # the dataset-collection disk cache (harness/cache.py)
    load_from_cache: bool = False
    force_recache: bool = False
    # insite: the lam grid scored on the validation cohort in one stacked
    # fine-tune; neural: a search over tuning.NEURAL_HPARAM_GRIDS
    tune_hparams: bool = False
    tune_trials: int = 10        # neural trials subsampled from the grid
    # 'grid': the seeded subsampled grid; 'sha': successive halving
    tune_algo: str = 'grid'
    # tuned model-hparam overlays: maps '<method>', '<method>@<dataset>' or
    # '<method>@<dataset>/<coeff>' (later wins) to model-config fields
    model_overrides: dict = field(default_factory=dict)
    flush_mode: bool = False
    debug_mode: bool = True
    log_dir: str = 'logs'
    # JSONL metrics sink (mirrored to MLflow or wandb where configured;
    # '' disables it)
    metrics_jsonl: str = 'logs/metrics.jsonl'
    # a previous sweep's log: its completed runs are reused, not re-run
    resume_log: str = ''
    # each run (or --vectorized column) in a fresh interpreter
    isolate_runs: bool = False

    def flush(self):
        """CI fast path."""
        self.epochs = 1
        self.seed_start, self.seed_runs = 0, 1
        self.gnet_mc_samples = 2
        self.train_samples, self.val_samples, self.test_samples = 1000, 10, 10
        return self

    @classmethod
    def from_yaml(cls, path: str, **overrides) -> 'RunConfig':
        """Load a sweep config from a YAML mapping of RunConfig fields;
        keyword overrides win over file values. Lists become tuples so
        fields stay hashable. Needs PyYAML, which raises ImportError where
        it is not installed."""
        try:
            import yaml
        except ImportError as e:
            raise ImportError('RunConfig.from_yaml needs PyYAML (the yaml '
                              'module), which is not installed') from e
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        if not isinstance(raw, dict):
            raise ValueError(f'{path} must contain a YAML mapping of '
                             f'RunConfig fields, got {type(raw).__name__}')
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - valid
        if unknown:
            raise ValueError(f'unknown RunConfig fields in {path}: '
                             f'{sorted(unknown)}')
        bad_kw = set(overrides) - valid
        if bad_kw:
            raise ValueError(f'unknown RunConfig override kwargs: '
                             f'{sorted(bad_kw)}')
        raw.update(overrides)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> 'RunConfig':
        """Rebuild from a plain (e.g. JSON round-tripped) mapping; lists
        become tuples so fields stay hashable."""
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in raw.items()})
