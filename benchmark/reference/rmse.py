"""The paper's evaluation protocol, in float64: normalised masked RMSEs of
the one-step counterfactual predictions and of each horizon of the n-step
ones, in % of the family's normalising constant."""

from __future__ import annotations

import torch


def one_step(pred, target, active, norm: float):
    """(orig, all, last) from unscaled predictions and targets [N, T] and
    the active mask [N, T]: orig the root of the mean over steps of each
    step's mean squared error; all the pooled root mean square; last that
    of each row's last active step (the counterfactual one)."""
    pred, target, active = (torch.as_tensor(x, dtype=torch.float64)
                            for x in (pred, target, active))
    err2 = (pred - target) ** 2 * active
    orig = torch.sqrt((err2.sum(0) / active.sum(0)).mean())
    pooled = torch.sqrt(err2.sum() / active.sum())
    after = torch.cat([active[:, 1:], torch.zeros_like(active[:, :1])], 1)
    last = active - after
    final = torch.sqrt((err2 * last).sum() / last.sum())
    return tuple(float(x) / norm * 100.0 for x in (orig, pooled, final))


def n_step(pred, target, active, norm: float):
    """Per horizon the root mean squared error over the rows whose targets
    are all finite: unscaled predictions and targets [N, ph]."""
    pred, target, active = (torch.as_tensor(x, dtype=torch.float64)
                            for x in (pred, target, active))
    ok = torch.isfinite(target).all(1)
    err2 = ((pred - target) ** 2 * active)[ok]
    return [float(x) / norm * 100.0
            for x in torch.sqrt(err2.sum(0) / active[ok].sum(0))]
