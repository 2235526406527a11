"""Legacy eq_1-eq_8 PKPD generators, the port of `insite_tpu.sim.legacy`
(off the run.py main path, kept for older experiments).

Two ODE families, each in four noise variants:

- *single* (eq_1-eq_4): 1-D PKPD dx = x * (u (c0 - c1) / v - c0 / v) with
  c1 = 1, v = 1, c0 = -1 (exponential growth untreated, decay treated);
  x0 ~ U[0, 10].
- *double* (eq_5-eq_8): 2-D (volume, concentration) with
  dv = -0.05 log(v) v (clipped at 0) and dc = -c / 2 + chemo; the volume
  equation ignores the treatments, as the reference's does.

Variants: eq_1 / eq_5 clean; eq_2 / eq_6 observation noise; eq_3 / eq_7
additive between-subject parameter noise; eq_4 / eq_8 fractional-weight
parameter noise (the double family's parameters are drawn by the JAX
package but unused, so none is drawn here).

Treatment policy: a binary action per dimension with probability
sigmoid(gamma * (window_mean(x_0) / max_cov - 1/2)), redrawn every
``step_actions`` steps and held in between; the window holds the last
``window`` states. One loop over time on the device of the tensors, the
cohort at once, fixed-step Euler with 10 sub-steps.

`simulate` takes its draws as arguments (uniforms for x0 and for the
Bernoulli actions, normals for the parameters and the observation noise;
a Bernoulli draw is ``uniform < p``, as `jax.random.bernoulli`), so the
JAX package's own draws reproduce its trajectories; `load_dataset` draws
them from a `torch.Generator` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from insite_tpu_torch.core.dtypes import resolve_float
from insite_tpu_torch.sim.tumor import calc_volume

SUBSTEPS = 10
WINDOW = 15

EQUATIONS = {
    'eq_1': ('single', dict(obs_noise=0.0, bsv_noise=0.0,
                            fractional_weight=False)),
    'eq_2': ('single', dict(obs_noise=0.01, bsv_noise=0.0,
                            fractional_weight=False)),
    'eq_3': ('single', dict(obs_noise=0.0, bsv_noise=0.1,
                            fractional_weight=False)),
    'eq_4': ('single', dict(obs_noise=0.0, bsv_noise=0.1,
                            fractional_weight=True)),
    'eq_5': ('double', dict(obs_noise=0.0, bsv_noise=0.0,
                            fractional_weight=False)),
    'eq_6': ('double', dict(obs_noise=0.01, bsv_noise=0.0,
                            fractional_weight=False)),
    'eq_7': ('double', dict(obs_noise=0.0, bsv_noise=0.1,
                            fractional_weight=False)),
    'eq_8': ('double', dict(obs_noise=0.0, bsv_noise=0.1,
                            fractional_weight=True)),
}
# the single family's parameters, in the order their normals are drawn
SINGLE_PARAMS = (('c_0', -1.0), ('c_1', 1.0), ('v', 1.0))
DIMS = {'single': (1, 1), 'double': (2, 2)}     # (state, action) widths


def _rollout(f, x0, act_uniforms, T: int, dt: float, gamma, max_cov,
             step_actions: int, window: int):
    """Batched Euler rollout with held, confounded binary actions.

    x0 [B, D]; act_uniforms [T-1, B, action_dim]. Returns (states
    [B, T, D], actions [B, T, action_dim])."""
    B = x0.shape[0]
    buf = x0.new_zeros(B, window)
    buf[:, -1] = x0[:, 0]
    count = torch.ones(B, dtype=torch.int64, device=x0.device)
    hold = torch.zeros(B, dtype=torch.int64, device=x0.device)
    u = x0.new_zeros(B, act_uniforms.shape[-1])
    x = x0
    h = dt / SUBSTEPS
    xs, us = [], []
    for t in range(T - 1):
        redraw = hold <= 0
        mean = buf.sum(1) / torch.clamp(count, min=1)
        p = torch.sigmoid(gamma * (mean / max_cov - 0.5))
        u = torch.where(redraw[:, None],
                        (act_uniforms[t] < p[:, None]).to(x.dtype), u)
        hold = torch.where(redraw, step_actions - 1, hold - 1)
        for _ in range(SUBSTEPS):
            x = x + h * f(x, u)
        buf = torch.cat([buf[:, 1:], x[:, :1]], dim=1)
        count = torch.clamp(count + 1, max=window)
        xs.append(x)
        us.append(u)
    states = torch.cat([x0[:, None], torch.stack(xs, 1)], dim=1)
    # the action at step t applies over [t, t+1); the first drawn action
    # is recorded at t = 0 as well
    actions = torch.stack(us, 1)
    actions = torch.cat([actions[:, :1], actions], dim=1)[:, :T]
    return states, actions


def simulate(family: str, draws: dict, gamma: float, obs_noise: float,
             bsv_noise: float, fractional_weight: bool,
             step_actions: int = 30, window: int = WINDOW):
    """One split of a legacy dataset from its draws, on their device and in
    their dtype:

    - ``x0_uniform`` [B, 1], uniforms in [0, 1) for the initial state;
    - ``param_normals`` [3, B] (single family), standard normals for
      c_0, c_1 and v in that order;
    - ``act_uniforms`` [T-1, B, action_dim], uniforms of the Bernoulli
      actions, one set a step;
    - ``obs_normals`` [B, T, D], the observation noise's standard normals.

    Returns (states [B, T, D], actions [B, T, action_dim])."""
    u0 = draws['x0_uniform']
    T = draws['obs_normals'].shape[1]
    dt = 10.0 / T
    if family == 'single':
        x0 = torch.clamp(u0 * (10.0 - 0.0) + 0.0, min=0.0)
        p = {}
        for eps, (name, mean) in zip(draws['param_normals'], SINGLE_PARAMS):
            if bsv_noise > 0.0 and not fractional_weight:
                p[name] = mean + eps * bsv_noise
            elif bsv_noise > 0.0:
                p[name] = mean * (1.0 + eps * bsv_noise)
            else:
                p[name] = torch.full_like(eps, mean)
        c0v = (p['c_0'] / p['v'])[:, None]
        c1v = (p['c_1'] / p['v'])[:, None]

        def f(x, u):
            return x * (u * (c0v - c1v) - c0v)

        max_cov = 15.0
    else:
        v13 = calc_volume(13.0)
        lo, hi = 0.80 * v13, 0.99 * v13
        v0 = torch.clamp(u0 * (hi - lo) + lo, min=lo)
        x0 = torch.cat([v0, torch.zeros_like(v0)], dim=1)

        def f(x, u):
            v = torch.clamp(x[:, 0], min=0.0)
            c = x[:, 1]
            ca = torch.clamp(u[:, 0], 0.0, 5.0)
            dv = torch.where(v > 0.0,
                             -torch.log(torch.clamp(v, min=1e-30)) * 0.05 * v,
                             0.0)
            dc = -c / 2.0 + ca
            return torch.stack([dv, dc], dim=1)

        max_cov = v13
    states, actions = _rollout(f, x0, draws['act_uniforms'], T, dt, gamma,
                               max_cov, step_actions, window)
    return states + obs_noise * draws['obs_normals'], actions


def draw(family: str, n: int, T: int, generator: torch.Generator, *,
         device, dtype=None) -> dict:
    """The draws `simulate` takes for ``n`` patients over ``T`` steps,
    from ``generator`` (on ``device``)."""
    dtype = resolve_float(dtype)
    D, A = DIMS[family]
    kw = dict(generator=generator, device=device, dtype=dtype)
    out = {'x0_uniform': torch.rand(n, 1, **kw),
           'act_uniforms': torch.rand(T - 1, n, A, **kw),
           'obs_normals': torch.randn(n, T, D, **kw)}
    if family == 'single':
        out['param_normals'] = torch.randn(len(SINGLE_PARAMS), n, **kw)
    return out


def load_dataset(dataset_name: str, seed: int, train_samples=100,
                 val_samples=100, test_samples=100, gamma=1.0,
                 step_actions=30, total_time_steps=60, obs_noise=None,
                 bsv_noise=None, *, device, dtype=None):
    """Train, val and test dicts ``{'x', 'a', 'y'}`` of numpy arrays and
    the metadata, as `insite_tpu.sim.legacy.load_dataset` returns them,
    simulated on ``device`` in ``dtype`` (float32 unless given) from one
    `torch.Generator` there seeded with ``seed``. Validation and test are
    simulated without confounding (gamma = 0), as the reference does.
    ``obs_noise`` / ``bsv_noise`` replace the variant's noise where it has
    any."""
    if dataset_name not in EQUATIONS:
        raise NotImplementedError(dataset_name)
    family, variant = EQUATIONS[dataset_name]
    variant = dict(variant)
    if obs_noise is not None and variant['obs_noise'] > 0:
        variant['obs_noise'] = obs_noise
    if bsv_noise is not None and variant['bsv_noise'] > 0:
        variant['bsv_noise'] = bsv_noise
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    splits = {}
    for name, n, g in (('train', train_samples, gamma),
                       ('val', val_samples, 0.0),
                       ('test', test_samples, 0.0)):
        draws = draw(family, n, total_time_steps, gen, device=device,
                     dtype=dtype)
        states, actions = simulate(family, draws, g, step_actions=int(
            step_actions), **variant)
        states, actions = states.cpu().numpy(), actions.cpu().numpy()
        y = states if family == 'single' else states[:, :, :1]
        splits[name] = {'x': states, 'a': actions, 'y': y}
    metadata = {'x_dim': splits['train']['x'].shape[2],
                'action_dim': splits['train']['a'].shape[2],
                'action_type': 'binary',
                't': np.linspace(0, 10, total_time_steps),
                'total_timesteps': total_time_steps}
    return splits['train'], splits['val'], splits['test'], metadata
