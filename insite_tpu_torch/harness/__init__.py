"""The north-star pipeline, the sweep harness and its results tools.

Exports the JAX package's names, with `rows_from_log` (the log's rows as
dicts) in place of the pandas `df_from_log`. They are imported at first
use (PEP 562): the runner imports every model, and the north star, the
bench and the configuration are imported without it.
"""

import importlib

# exported name -> the submodule that defines it
_EXPORTS = {'Experiment': 'runner', 'run_experiment': 'runner',
            'sweep': 'runner', 'METHODS': 'runner', 'ci': 'results',
            'generate_main_results_table': 'results',
            'rows_from_log': 'results'}

__all__ = list(_EXPORTS)


def __getattr__(name):
    # any other name (a submodule not imported yet) is not ours, so that
    # ``from insite_tpu_torch.harness import runner`` imports the submodule
    if name not in _EXPORTS:
        raise AttributeError(f'module {__name__!r} has no attribute '
                             f'{name!r}')
    value = getattr(importlib.import_module(f'{__name__}.{_EXPORTS[name]}'),
                    name)
    globals()[name] = value
    return value
