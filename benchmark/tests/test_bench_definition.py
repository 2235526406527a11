"""The benchmark's definition: every configuration, cell, traffic mix,
limit file and per-layer metric is found by its name, and the file keeps
to the shapes and characters the benchmark format allows."""

import json
import re

import pytest

from benchmark import cell as cells
from benchmark.tests.conftest import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\n\r\t]{1,200}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


def bench():
    with open(ROOT / 'BENCHMARK.json') as f:
        return json.load(f)


def test_top_level_keys_and_command():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert b['paths'] == ['benchmark']
    assert b['command'][:3] == ['python3', '-m', 'benchmark.run']
    assert 1 <= b['run_seconds'] <= 51
    assert (ROOT / 'BENCHMARK.json').stat().st_size <= 64 * 1024


def test_names_units_and_bounds():
    b = bench()
    names = [x['name'] for k in ('configs', 'workloads', 'end_to_end',
                                 'per_layer') for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m['name']: m for m in b['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in b['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in b['per_layer']:
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert '\n' not in m['layer'] and len(m['layer']) <= 200


def test_entries_keep_to_their_keys():
    b = bench()
    assert 1 <= len(b['command']) <= 32
    assert all(LINE.match(w) for w in b['command'])
    assert 1 <= len(b['paths']) <= 16
    assert all(PATH.match(p) and '..' not in p.split('/') for p in b['paths'])
    assert 1 <= len(b['configs']) <= 24 and 1 <= len(b['workloads']) <= 24
    assert 1 <= len(b['end_to_end']) <= 16
    assert 1 <= len(b['per_layer']) <= 128
    cells_ = {w['name']: w for w in b['workloads']}
    pairs = [(w['config'], w['traffic']) for w in b['workloads']]
    assert len(set(pairs)) == len(pairs)
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and LINE.match(w['why'])
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
    e2e = {}
    for m in b['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        e2e[m['name']] = set(m.get('workloads', cells_))
    for m in b['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}
        assert LINE.match(m['layer'])
        # every listed cell reports the end-to-end metric this one moves
        assert set(m.get('workloads', cells_)) <= e2e[m['moves']]
    for name in cells_:
        reported = {k for k, ws in e2e.items() if name in ws}
        assert 'setup_s' in reported and len(reported) >= 2
        assert any(name in m.get('workloads', cells_)
                   for m in b['per_layer'])


def test_files_under_paths_named_by_the_name_characters():
    for p in (ROOT / 'benchmark').rglob('*'):
        rel = p.relative_to(ROOT).as_posix()
        if '__pycache__' in rel or not p.is_file():
            continue
        assert all(NAME.match(part) for part in rel.split('/')), rel


@pytest.mark.parametrize('workload', [w['name'] for w in
                                      json.load(open(ROOT / 'BENCHMARK.json'))
                                      ['workloads']])
def test_cell_files_found_by_name(workload):
    c = cells.load(ROOT, workload)
    assert c.chips == 1
    assert c.config['name'] == workload.split('.')[0]
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())
    entry = c.entry()
    assert hasattr(entry, 'Entry')
    names = {m['name'] for m in c.end_to_end}
    assert {'setup_s', 'patients_per_s', 'peak_device_gib'} <= names
    assert c.per_layer


def test_configs_files_and_sources():
    b = bench()
    used = {w['config'] for w in b['workloads']}
    assert used == {c['name'] for c in b['configs']}
    files = [c['file'] for c in b['configs']]
    assert len(set(files)) == len(files)
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        for text in (c['source'], c['why']):
            assert LINE.match(text)
        assert len(c['reduced']) <= 16
        assert all(NAME.match(k) for k in c['reduced'])
        assert c['file'].startswith('benchmark/configs/')
        with open(ROOT / c['file']) as f:
            assert json.load(f)['name'] == c['name']


@pytest.mark.parametrize('metric', [m['name'] for m in
                                    json.load(open(ROOT / 'BENCHMARK.json'))
                                    ['per_layer']])
def test_metric_readers_found_by_name(metric):
    assert callable(cells.metric_reader(metric))


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        cells.load(ROOT, 'no_such.cell')
