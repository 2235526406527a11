"""In a fresh interpreter, after a cell's imports and a tiny run of it,
and after the reference's imports alone, no module whose top-level name
(the part before the first dot) is JAX's or the JAX package's is loaded;
the reference loads nothing of the port either."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import cell as cell_files
from benchmark.tests.conftest import ROOT, cells
from benchmark.tests.test_bench_cells_cpu import TINY

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'insite_tpu')

CELL = '''
import json, sys, torch
torch.set_num_threads(1)
from pathlib import Path
from benchmark import cell, run
c = cell.load(Path.cwd(), {workload!r})
s = run.CellRun(c, 5, torch.device('cpu'), patients={tiny!r})
s.window(0.0, trace=False)
s.judge()
print(json.dumps(sorted(sys.modules)))
'''

REFERENCE = '''
import importlib, json, sys
importlib.import_module('benchmark.reference.' + {name!r})
print(json.dumps(sorted(sys.modules)))
'''


def loaded(code):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True).stdout
    return {m.split('.')[0] for m in json.loads(out.splitlines()[-1])}


@pytest.mark.parametrize('workload', cells())
def test_a_cell_loads_no_jax(workload):
    tiny = TINY[cell_files.load(ROOT, workload).traffic['entry']]
    tops = loaded(CELL.format(workload=workload, tiny=tiny))
    assert not tops & set(FORBIDDEN)
    assert 'insite_tpu_torch' in tops


def references():
    names = set()
    for w in cells():
        with open(ROOT / 'BENCHMARK.json') as f:
            b = json.load(f)
        conf = {c['name']: c['file'] for c in b['configs']}
        cfg_name = next(x['config'] for x in b['workloads']
                        if x['name'] == w)
        with open(ROOT / conf[cfg_name]) as f:
            names.add(json.load(f)['reference'])
    return sorted(names)


@pytest.mark.parametrize('name', references())
def test_the_reference_loads_neither_jax_nor_the_port(name):
    tops = loaded(REFERENCE.format(name=name))
    assert not tops & set(FORBIDDEN + ('insite_tpu_torch',))
