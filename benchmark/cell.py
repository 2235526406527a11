"""The benchmark's definition, read from `BENCHMARK.json` and the files it
names by name: a configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json` (whose ``entry`` names the module of `entries/`
that drives it), the limits of a cell's comparison `limits/<cell>.json`,
and a per-layer metric the module `metrics/<metric>.py`. Adding a cell,
a configuration, a mix or a metric adds files and edits none."""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # this cell's end-to-end metric entries
    per_layer: list           # this cell's per-layer metric entries

    def entry(self):
        """The module of `entries/` that drives this cell's traffic."""
        return importlib.import_module(
            f'benchmark.entries.{self.traffic["entry"]}')


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; a name it does not
    hold raises `KeyError`."""
    bench = _read(root / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json; it has '
                       f'{sorted(cells)}')
    w = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    config = _read(root / configs[w['config']]['file'])
    traffic = _read(HERE / 'traffic' / f'{w["traffic"]}.json')
    limits = _read(HERE / 'limits' / f'{workload}.json')
    e2e = [m for m in bench['end_to_end'] if _applies(m, workload)]
    layer = [m for m in bench['per_layer'] if _applies(m, workload)]
    return Cell(workload, int(w['chips']), config, traffic, limits, e2e,
                layer)


def metric_reader(name: str):
    """The ``read`` function of `metrics/<name>.py`."""
    return importlib.import_module(f'benchmark.metrics.{name}').read
