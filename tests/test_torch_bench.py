"""The north-star bench: `fused_northstar`'s device-time repeats and
backend choice against the JAX function on the JAX package's cohort, and
the port's `insite_tpu_torch.bench` in both modes on the host against the
library path and against the repository's `bench.py`."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.harness.northstar import _sim_design_qr
from insite_tpu.harness.northstar import fused_northstar as jax_northstar
from insite_tpu_torch import bench
from insite_tpu_torch.data.collection import PkpdDatasetCollection
from insite_tpu_torch.eval.metrics import normalised_masked_rmse
from insite_tpu_torch.harness.northstar import (discover_and_finetune,
                                                fused_northstar)
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor

ROOT = Path(__file__).resolve().parent.parent
N, SEED = 120, 0
BENCH_N = 200
BENCH_PY_TIMEOUT_S = 300
# bench.py's keys: every line, and in fused mode with repeats
LINE_KEYS = {'metric', 'value', 'unit', 'vs_baseline'}
DEVICE_TIME_KEYS = {'sim_design', 'finetune', 'total'}


@pytest.fixture(scope='module')
def jax_cohort():
    """The JAX package's f64 cohort as torch tensors on the CPU."""
    _, cohort = _sim_design_qr(jax.random.PRNGKey(SEED), N, 60, 'EQ_4_D',
                               JaxLibrary(n_inputs=3), 2.0, jnp.float64)
    return tuple(torch.from_numpy(np.array(a)) for a in cohort)


def test_repeats_match_jax_northstar(jax_cohort):
    ref = jax_northstar(N, seed=SEED, equation_name='EQ_4_D',
                        projection_horizon=1, use_pallas=False,
                        dtype=jnp.float64, device_time_repeats=1)
    r = discover_and_finetune(jax_cohort, projection_horizon=1,
                              device_time_repeats=1)
    assert set(ref) <= set(r)
    # f64, the same cohort; QR by LAPACK here and by XLA there, then the
    # same host STLSQ (measured: equal); the same LM updates (measured:
    # 7.9e-13)
    np.testing.assert_allclose(r['coefs'], ref['coefs'], rtol=1e-10,
                               atol=0)
    for k in ('rmse_orig', 'rmse_all'):
        np.testing.assert_allclose(r[k], ref[k], rtol=1e-8)
    for k in ('device_sim_design_s', 'device_finetune_s'):
        assert r[k] > 0.0


@pytest.mark.parametrize('backend', ['auto', 'xla'])
def test_repeats_change_no_result(backend):
    once = fused_northstar(N, seed=SEED, rollout_backend=backend,
                           device='cpu')
    again = fused_northstar(N, seed=SEED, rollout_backend=backend,
                            device_time_repeats=2, device='cpu')
    assert 'device_finetune_s' not in once
    assert again['device_sim_design_s'] > 0.0
    assert again['device_finetune_s'] > 0.0
    np.testing.assert_array_equal(again['coefs'], once['coefs'])
    assert torch.equal(again['preds'], once['preds'])
    assert (again['rmse_orig'], again['rmse_all']) == \
        (once['rmse_orig'], once['rmse_all'])


def test_xla_backend_equals_the_kernels_plain_versions():
    """'xla' (jvp through the plain rollout) and 'auto' on the CPU (the
    sensitivity kernel's plain version) give the same fine-tune (f32;
    measured: 9.1e-08 of the RMSE)."""
    auto = fused_northstar(N, seed=SEED, device='cpu')
    xla = fused_northstar(N, seed=SEED, rollout_backend='xla', device='cpu')
    np.testing.assert_array_equal(xla['coefs'], auto['coefs'])
    np.testing.assert_allclose(xla['rmse_orig'], auto['rmse_orig'],
                               rtol=1e-4)


@pytest.mark.parametrize('backend', ['pallas', 'bogus'])
def test_unserved_backends_raise(backend):
    with pytest.raises(ValueError, match='rollout_backend'):
        fused_northstar(8, seed=SEED, rollout_backend=backend, device='cpu')


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def _library_rmses(mode):
    """The factual RMSEs of the bench's workload through the library on
    the host, at the bench's seed."""
    if mode == 'fused':
        r = fused_northstar(BENCH_N, seed=0, device='cpu')
        return r['rmse_orig'], r['rmse_all']
    coll = PkpdDatasetCollection(
        conf_coeff=2.0, num_patients={'train': BENCH_N, 'val': 100,
                                      'test': 2},
        equation_str='EQ_4_D', seed=0, device='cpu')
    cfg = SINDyConfig(dataset_name='EQ_4_D', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0, insite=True)
    model = SINDyRegressor(cfg, coll, device='cpu').fit(coll.train_f)
    preds = model._fine_tuned_rollout(coll.train_f, projection_horizon=1)
    return tuple(float(v) for v in
                 normalised_masked_rmse(coll.train_f, preds))


@pytest.mark.parametrize('mode', ['fused', 'standard'])
def test_bench_on_the_host(mode, capsys):
    rec = bench.main({'BENCH_PLATFORM': 'cpu', 'BENCH_MODE': mode,
                      'BENCH_PATIENTS': str(BENCH_N)})
    out, err = capsys.readouterr()
    line = _last_json(out)
    assert line == rec['line']
    want = LINE_KEYS | ({'device_time_s'} if mode == 'fused' else set())
    assert set(line) == want
    assert line['metric'] == \
        'eq4_10k_simulate_discover_finetune_wall_s_cpu'
    assert line['unit'] == 's' and line['value'] > 0.0
    assert line['vs_baseline'] == round(60.0 / line['value'], 3)
    if mode == 'fused':
        d = line['device_time_s']
        assert set(d) == DEVICE_TIME_KEYS
        assert d['total'] == d['sim_design'] + d['finetune']
    assert '[bench] device: cpu' in err and 'factual normalised RMSE' in err
    # the same workload through the library: the same numbers
    assert (rec['rmse_orig'], rec['rmse_all']) == _library_rmses(mode)
    assert rec['rmse_orig'] < 0.1


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='BENCH_PLATFORM=cpu'):
        bench.main({'BENCH_PATIENTS': '8'})


def test_bench_py_prints_the_same_keys(tmp_path, capsys):
    """The repository's bench.py on the host (fused mode, 64 patients)
    and the port's print a last line with the same keys."""
    env = dict(os.environ, BENCH_PLATFORM='cpu', BENCH_PATIENTS='64',
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / 'jax_cache'))
    proc = subprocess.run([sys.executable, 'bench.py'], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=BENCH_PY_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = _last_json(proc.stdout)
    bench.main({'BENCH_PLATFORM': 'cpu', 'BENCH_PATIENTS': '64'})
    line = _last_json(capsys.readouterr().out)
    assert set(line) == set(ref) == LINE_KEYS | {'device_time_s'}
    assert set(line['device_time_s']) == set(ref['device_time_s'])
    assert line['metric'] == ref['metric']
