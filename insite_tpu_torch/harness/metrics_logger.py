"""Experiment metrics logging, local first:

- metrics and params always land in a JSONL file (greppable and readable
  without a server), one JSON object a line with the record's time, run
  name, kind ('params' or 'metrics') and step;
- if the `mlflow` package is importable AND a tracking URI is configured,
  every call is mirrored to it (a submodel's run drops the other
  submodels' nested params);
- if the `wandb` package is importable AND WANDB_PROJECT is set, runs are
  mirrored there too.

The records are those of `insite_tpu.harness.metrics_logger.MetricsLogger`.
"""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger('insite_tpu_torch')


def _mlflow_or_none(tracking_uri):
    if not tracking_uri:
        return None
    try:
        import mlflow
    except ImportError:
        logger.info('mlflow not installed — metrics stay local-only')
        return None
    mlflow.set_tracking_uri(tracking_uri)
    return mlflow


def _wandb_or_none(project):
    if not project:
        return None
    try:
        import wandb
    except ImportError:
        logger.info('wandb not installed — skipping wandb mirror')
        return None
    return wandb


class MetricsLogger:
    """Per-run metrics sink.

    >>> ml = MetricsLogger('logs/metrics.jsonl', run_name='insite-EQ_4_D-0')
    >>> ml.log_params({'lam': 10.0, 'sindy_threshold': 0.1})
    >>> ml.log_metrics({'val_rmse_all': 0.12}, step=0)
    >>> ml.finish()
    """

    def __init__(self, path: str, run_name: str = '', tracking_uri=None,
                 experiment_name: str = 'insite_tpu'):
        self.path = path
        self.run_name = run_name
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        self._mlflow = _mlflow_or_none(
            tracking_uri or os.environ.get('MLFLOW_TRACKING_URI'))
        self._run = None
        if self._mlflow is not None:
            self._mlflow.set_experiment(experiment_name)
            self._run = self._mlflow.start_run(run_name=run_name)
        self._wandb = _wandb_or_none(os.environ.get('WANDB_PROJECT'))
        self._wandb_run = None
        if self._wandb is not None:
            try:
                self._wandb_run = self._wandb.init(
                    project=os.environ['WANDB_PROJECT'], name=run_name,
                    group=experiment_name, reinit=True,
                    settings=self._wandb.Settings(mode='offline')
                    if not os.environ.get('WANDB_API_KEY') else None)
            except Exception as e:   # best-effort mirror, never fatal
                logger.warning(f'wandb.init failed ({e}) — '
                               f'metrics stay local-only')
                self._wandb_run = None

    def _write(self, kind: str, payload: dict, step=None):
        rec = {'ts': time.time(), 'run': self.run_name, 'kind': kind,
               'step': step, **payload}
        with open(self.path, 'a') as f:
            f.write(json.dumps(rec, default=float) + '\n')

    def log_params(self, params: dict, submodel: str = None):
        """With ``submodel``, nested (dict) params of other submodels are
        dropped; the remaining dicts are written as JSON strings."""
        if submodel is not None:
            params = {k: v for k, v in params.items()
                      if not isinstance(v, dict) or k == submodel}
        flat = {k: (json.dumps(v, default=str) if isinstance(v, dict) else v)
                for k, v in params.items()}
        self._write('params', flat)
        if self._mlflow is not None:
            self._mlflow.log_params(flat)
        if self._wandb_run is not None:
            self._wandb_run.config.update(flat, allow_val_change=True)

    def log_metrics(self, metrics: dict, step=None):
        """Only int and float values are metrics; the rest is dropped."""
        metrics = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        self._write('metrics', metrics, step=step)
        if self._mlflow is not None:
            self._mlflow.log_metrics(metrics, step=step)
        if self._wandb_run is not None:
            self._wandb_run.log(metrics, step=step)

    def finish(self):
        if self._mlflow is not None and self._run is not None:
            self._mlflow.end_run()
            self._run = None
        if self._wandb_run is not None:
            self._wandb_run.finish()
            self._wandb_run = None
