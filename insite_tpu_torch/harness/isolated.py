"""Per-run process isolation for sweeps (``run.py --isolate``).

By default a sweep runs every experiment in its own process, so a
device-level failure (a CUDA error that poisons the context, an
out-of-memory that fragments it) can fail every later run. With
``--isolate`` each run, or each ``--vectorized`` column, executes in a
fresh interpreter, ``python -m insite_tpu_torch.harness.isolated``: the
parent sends the run's spec as JSON on stdin (the device type and dtype
included) and gets the metrics back on stdout. A child failure raises
`RuntimeError('isolated run ...')` in the parent, which the sweep's fault
wall turns into an errored row; the run is never retried in the parent.
On the card the child loads the kernel library that the parent's checkout
has built already (`ops/build.py` builds only a missing one).
``ISOLATED_TIMEOUT_S`` (seconds, unset or 0: none) bounds each child.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import torch

_MARKER = 'ISOLATED_RESULT:'


def _die_with_parent():
    """preexec hook: deliver SIGTERM to the child when its parent dies, so
    a child of a sweep that is killed does not live on holding the card."""
    import ctypes
    import signal
    PR_SET_PDEATHSIG = 1
    ctypes.CDLL('libc.so.6', use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                   signal.SIGTERM)


def _dtype_name(dtype):
    return None if dtype is None else str(dtype).removeprefix('torch.')


def _run_child(payload: dict, what: str, forward_stderr=False):
    """Run the child on ``payload``; returns its result object, or raises
    RuntimeError naming ``what``."""
    import insite_tpu_torch
    # the child finds the package through PYTHONPATH: it need not be
    # installed, and the parent may have been started from anywhere
    pkg_parent = os.path.dirname(os.path.dirname(insite_tpu_torch.__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = pkg_parent + os.pathsep + env.get('PYTHONPATH', '')
    timeout_s = float(os.environ.get('ISOLATED_TIMEOUT_S', 0)) or None
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'insite_tpu_torch.harness.isolated'],
            input=json.dumps(payload), capture_output=True, text=True,
            env=env, preexec_fn=_die_with_parent, timeout=timeout_s)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(
            f'isolated run timed out after {timeout_s:.0f}s '
            f'(ISOLATED_TIMEOUT_S); child killed') from e
    if forward_stderr and proc.stderr:
        # the child's log lines keep the sweep's progress trail
        sys.stderr.write(proc.stderr)
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith(_MARKER):
            return json.loads(line[len(_MARKER):])
    raise RuntimeError(
        f'{what} failed with exit code {proc.returncode}; stderr tail:\n'
        f'{proc.stderr[-2000:]}')


def run_isolated(dataset_name: str, method_name: str, seed: int,
                 domain_conf: float, cfg, experiment, *, device,
                 dtype=None) -> dict:
    """Execute one `run_experiment` on ``device`` in a fresh interpreter
    and return its metrics dict. Raises RuntimeError on any child
    failure."""
    return _run_child({
        'dataset_name': dataset_name, 'method_name': method_name,
        'seed': seed, 'domain_conf': domain_conf,
        'cfg': dataclasses.asdict(cfg), 'experiment': experiment.name,
        'device': torch.device(device).type, 'dtype': _dtype_name(dtype)},
        f'isolated run ({dataset_name}, {method_name}, seed {seed})')


def run_isolated_column(dataset_name: str, method_name: str, cfg, *,
                        device, dtype=None):
    """Execute one vectorized (dataset, method) seed column on ``device``
    in a fresh interpreter; returns ``(r, seeds)`` with ``r`` mapping
    metric name -> np.ndarray [S], as `runner._vectorized_column` does.
    Raises the parent's `runner.ColumnSkipped` where the child reports the
    column has no path, and RuntimeError on any other child failure."""
    import numpy as np
    out = _run_child({
        'mode': 'column', 'dataset_name': dataset_name,
        'method_name': method_name, 'cfg': dataclasses.asdict(cfg),
        'device': torch.device(device).type, 'dtype': _dtype_name(dtype)},
        f'isolated column ({dataset_name}, {method_name})',
        forward_stderr=True)
    if out.get('skipped'):
        from insite_tpu_torch.harness.runner import ColumnSkipped
        raise ColumnSkipped(out['skipped'])
    return ({k: np.asarray(v, np.float64) for k, v in out['metrics'].items()},
            out['seeds'])


def _main():
    spec = json.loads(sys.stdin.read())
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.harness.config import RunConfig
    device = torch.device(spec['device'])
    dtype = None if spec['dtype'] is None else getattr(torch, spec['dtype'])
    cfg = RunConfig.from_dict(spec['cfg'])
    if spec.get('mode') == 'column':
        import numpy as np
        try:
            r, seeds = runner._vectorized_column(
                cfg, spec['dataset_name'], spec['method_name'],
                device=device, dtype=dtype)
        except runner.ColumnSkipped as e:
            print(_MARKER + json.dumps({'skipped': str(e)}), flush=True)
            return
        out = {'metrics': {k: np.asarray(v, np.float64).tolist()
                           for k, v in r.items()
                           if isinstance(v, np.ndarray) and v.ndim == 1},
               'seeds': list(seeds)}
        print(_MARKER + json.dumps(out), flush=True)
        return
    result = runner.run_experiment(
        spec['dataset_name'], spec['method_name'], spec['seed'],
        spec['domain_conf'], cfg, runner.Experiment[spec['experiment']],
        device=device, dtype=dtype)
    print(_MARKER + json.dumps(result, default=float), flush=True)


if __name__ == '__main__':
    _main()
