#!/usr/bin/env python3
"""How INSITE's BFGS fine-tune ends its rows in the JAX package and in the
PyTorch port, on the CPU: the evidence behind `chip_smoke.py` phase 15's
row-by-row comparison of the card with the host.

    JAX_PLATFORMS=cpu python3 tools/bfgs_reference.py --part f32
    JAX_PLATFORMS=cpu python3 tools/bfgs_reference.py --part f64
    python3 tools/bfgs_reference.py --part port-run

``f32``: one synthetic cohort of 64 decaying EQ_4 trajectories (T = 59,
bfgs_maxiter 20, lam 10) fine-tuned in float32 by JAX's vmapped BFGS and
by the port's batched BFGS: the rows ending with each status in each
package (in float32 most rows' line searches end with the zoom failed,
status 3) and the port's float64 run beside them. ``f64``: an EQ_4_D
collection of the JAX package (200 / 10 / 10, seed 7) handed to the port,
both fine-tuning its 1-step test set by BFGS in float64 (bfgs_maxiter 20):
the rows whose outcome differs between the packages (a row that one ends
with status 3 keeps the masked global model there) and the largest
coefficient gap on the others. ``port-run``: the port's EQ_4_D insite run
with the BFGS fine-tune in float32 on the CPU at 60 / 8 / 3 patients, the
status shares of its two fine-tunes. Prints one JSON object.
"""

import argparse
import copy
import json
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
# the repo root in place of tools/, whose queue.py shadows the stdlib's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

T, B, DT, LAM, MAXITER = 59, 64, 1 / 6, 10.0, 20
BASE = np.array([[0, 0, 0, 0, -1.0, 0, 0], [0, -0.2, 0, 0, 0, -1.0, 0]])


def _shares(status) -> dict:
    status = np.asarray(status)
    return {int(s): int((status == s).sum()) for s in np.unique(status)}


def _synthetic_cohort():
    """Two-arm decay trajectories with 0.1 % multiplicative noise."""
    rng = np.random.RandomState(0)
    statics = rng.rand(B, 2)
    arms = (rng.randint(0, 2, (B, 1)) * np.ones((B, T))).astype(np.int32)
    k = 1 + 0.2 * rng.randn(B)
    y = 5 + rng.rand(B)
    out = [y]
    for _ in range(T - 1):
        d = np.where(arms[:, 0] == 0, -k * y * statics[:, 0],
                     -0.2 * y - k * y * statics[:, 1])
        y = y + d * DT
        out.append(y)
    prev = np.stack(out, 1) * (1 + 0.001 * rng.randn(B, T))
    return prev, statics, arms, np.full(B, T, np.int32)


def part_f32() -> dict:
    import jax
    import jax.numpy as jnp
    from jax.scipy.optimize import minimize

    from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
    from insite_tpu.models.sindy import batched_rollout
    from insite_tpu_torch.discovery.library import PolynomialLibrary
    from insite_tpu_torch.models.sindy import insite_finetune_predict
    jax.config.update('jax_enable_x64', False)
    prev, statics, arms, lengths = _synthetic_cohort()
    base = BASE.astype(np.float32)
    A, F = base.shape
    sparse = (np.abs(base) > 1e-3).astype(np.float32)
    g_flat = base.reshape(-1)

    def row(prev_i, st_i, ar_i, len_i):
        # the JAX package's insite_finetune_predict, returning the status
        pm = (jnp.arange(T - 1) < (len_i - 1)).astype(jnp.float32)

        def pmse(c):
            c = (c.reshape(A, F) * sparse)[None]
            p = batched_rollout(JaxLibrary(3), c, prev_i[None, 0],
                                st_i[None], ar_i[None], DT,
                                shared_coefs=True)[0]
            err = jnp.where(pm > 0, prev_i[1:] - p[:-1], 0.0)
            return jnp.sum(err * err) / jnp.maximum(jnp.sum(pm), 1.0)

        nc = jnp.maximum(pmse(g_flat) * 2.5, 1e-30)
        res = minimize(lambda c: pmse(c) / nc
                       + LAM * jnp.mean((g_flat - c) ** 2), g_flat,
                       method='BFGS', options={'maxiter': MAXITER})
        return res.status

    status = jax.jit(jax.vmap(row))(*(jnp.asarray(x, jnp.float32)
                                      if x.dtype.kind == 'f' else
                                      jnp.asarray(x)
                                      for x in (prev, statics, arms,
                                                lengths)))
    out = {'rows': B, 'jax f32': _shares(status)}
    act = tuple(int(i) for i in np.flatnonzero(np.abs(BASE.reshape(-1))
                                               > 1e-3))
    for tag, dt in (('port f32', torch.float32), ('port f64', torch.float64)):
        _, _, res = insite_finetune_predict(
            PolynomialLibrary(3), torch.tensor(BASE, dtype=dt),
            torch.tensor(prev, dtype=dt), torch.tensor(statics, dtype=dt),
            torch.tensor(arms), torch.tensor(lengths), DT, LAM, 1,
            bfgs_maxiter=MAXITER, active_idx=act)
        out[tag] = _shares(res.status.numpy())
    return out


def part_f64() -> dict:
    import jax
    import jax.numpy as jnp

    from insite_tpu.data.collection import make_collection
    from insite_tpu.models.sindy import SINDyConfig as JaxConfig
    from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
    from insite_tpu_torch import convert
    from insite_tpu_torch.data.collection import SUBSETS
    from insite_tpu_torch.models import sindy
    from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
    jax.config.update('jax_enable_x64', True)
    ref = make_collection('EQ_4_D', {'train': 200, 'val': 10, 'test': 10}, 7,
                          2.0, dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_D', projection_horizon=5,
        treatment_mode='multiclass')
    cfg = dict(dataset_name='EQ_4_D', insite=True, insite_solver='bfgs',
               bfgs_maxiter=MAXITER)
    model = SINDyRegressor(SINDyConfig(**cfg), ours, device='cpu',
                           dtype=torch.float64).fit(ours.train_f)
    jax_model = JaxRegressor(JaxConfig(**cfg), ref).fit(ref.train_f)
    results = []
    fine_tune = sindy.insite_finetune_predict

    def record(*args, **kwargs):
        out = fine_tune(*args, **kwargs)
        results.append(out[2])
        return out

    sindy.insite_finetune_predict = record
    try:
        c = model.get_fine_tuned_coefficients(ours.test_cf_one_step)
    finally:
        sindy.insite_finetune_predict = fine_tune
    c_jax = np.asarray(jax_model.get_fine_tuned_coefficients(
        ref.test_cf_one_step))
    gap = np.abs(c - c_jax).reshape(len(c), -1).max(1) / \
        np.abs(c_jax).reshape(len(c), -1).max(1)
    differ = gap > 1e-6
    status = results[0].status.numpy()
    return {'rows': len(c), 'port f64': _shares(status),
            'rows differing from the JAX package': int(differ.sum()),
            'their port status': status[differ].tolist(),
            'largest relative gap on the others': float(gap[~differ].max())}


def part_port_run() -> dict:
    from insite_tpu_torch.harness import runner
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.models import sindy
    results = []
    fine_tune = sindy.insite_finetune_predict

    def record(*args, **kwargs):
        out = fine_tune(*args, **kwargs)
        results.append(out[2])
        return out

    sindy.insite_finetune_predict = record
    try:
        cfg = RunConfig(train_samples=60, val_samples=8, test_samples=3,
                        model_overrides={'insite': {
                            'insite_solver': 'bfgs', 'bfgs_maxiter': 100}})
        runner.run_experiment('EQ_4_D', 'insite', 0, 2.0, cfg, device='cpu')
    finally:
        sindy.insite_finetune_predict = fine_tune
    return {f'fine-tune {i} (B={len(r.status)})': _shares(r.status.numpy())
            for i, r in enumerate(results)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--part', choices=('f32', 'f64', 'port-run'),
                   required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    part = {'f32': part_f32, 'f64': part_f64,
            'port-run': part_port_run}[args.part]
    print(json.dumps(part()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
