"""The benchmark's fixed arithmetic: the card's published peaks, the least
time a rollout kernel launch needs at its shapes, and the union of device
intervals.

`kernel_bound_s` is a frozen copy of the bound that the port's chip
script prints beside each kernel's device time (every input read once,
every output written once; Horner's rule for the collapsed polynomial), so
that a later change to that script cannot move the benchmark's
rooflines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# NVIDIA H100 SXM (data sheet, dense rates), at its 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}          # float32, float64 outside MMA
SUBSTEPS = 5                               # Euler sub-steps a step


@dataclass(frozen=True)
class Launch:
    """One launch of a rollout kernel, at its logical shapes.

    kind 'rollout' or 'sens'; B rows, T steps, A arms, F features, S
    statics; coef_rows 1 (a shared model) or B (a model a row); y_exps the
    exponent of y in each of the F features; active the flat (arm x F +
    feature) coordinates whose sensitivities a 'sens' launch writes;
    itemsize 4 or 8."""

    kind: str
    B: int
    T: int
    A: int
    F: int
    S: int
    coef_rows: int
    y_exps: tuple
    active: tuple = ()
    itemsize: int = 4
    substeps: int = SUBSTEPS


def kernel_bound_s(launch: Launch):
    """(least seconds, 'bytes' or 'operations'): the larger of the bytes
    the launch must move over the memory rate and its floating-point
    operations over the vector rate of its type.

    Bytes: coefficients, y0, statics and the int32 arms read once; y [B, T]
    and, for the sensitivities, [B, T, Kr] written once. Operations per
    sub-step of a row: Horner's rule for the collapsed polynomial in y
    (2 D, D the largest exponent of y) and the update (2); the
    sensitivities add Horner for its derivative (2 (D - 1)) and per
    coordinate j y^e_j for its drive (e_j) and s + h (p' s + drive) (4).
    Per row, 2 A F for collapsing the library."""
    L = launch
    D = max(L.y_exps)
    n_float = L.coef_rows * L.A * L.F + L.B + L.B * L.S
    n_out = 1
    per_substep = 2 * D + 2
    if L.kind == 'sens':
        n_out += len(L.active)
        per_substep += (2 * max(D - 1, 0) + 4 * len(L.active)
                        + sum(L.y_exps[i % L.F] for i in L.active))
    n_bytes = L.itemsize * (n_float + L.B * L.T * n_out) + 4 * L.B * L.T
    flops = L.B * L.T * L.substeps * per_substep + 2 * L.B * L.A * L.F
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[L.itemsize]
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def finetune_work(config: dict, reference, coefs, batches,
                  rollouts=()) -> list:
    """The ODE passes of INSITE fine-tunes over ``batches`` [(rows B,
    steps T)], each row with a model of its own: ``gn_iters`` + 1
    rollouts with sensitivities over the support of ``coefs`` ([A, F],
    or [S, A, F] whose union is fine-tuned) and one rollout (the rollout
    alone where the support is empty); then one rollout over each of
    ``rollouts``. Counted from the rows, the configuration's library
    (through the plain ``reference``'s exponents) and the fitted support,
    whatever implements them."""
    coefs = np.asarray(coefs)
    A, F = coefs.shape[-2:]
    S = config['library']['n_inputs'] - 1
    y_exps = tuple(int(e) for e in reference.exponents(S + 1)[:, 0])
    itemsize = np.dtype(config['dtype']).itemsize
    active = tuple(int(i) for i in np.flatnonzero(
        (np.abs(coefs) > 1e-3).reshape(-1, A * F).any(0)))
    passes = []
    for B, T in batches:
        if active:
            passes += [Launch('sens', B, T, A, F, S, B, y_exps, active,
                              itemsize)] * (config['gn_iters'] + 1)
        passes.append(Launch('rollout', B, T, A, F, S, B, y_exps,
                             itemsize=itemsize))
    return passes + [Launch('rollout', B, T, A, F, S, B, y_exps,
                            itemsize=itemsize) for B, T in rollouts]


def union_length(intervals) -> float:
    """Length of the union of [start, end] intervals."""
    total, end = 0.0, float('-inf')
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, start: float, stop: float):
    """The idle stretches of [start, stop] outside the union of
    ``intervals``: [(gap start, gap end)]."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, stop)))
        at = max(at, e)
        if at >= stop:
            break
    if at < stop:
        out.append((at, stop))
    return [(s, e) for s, e in out if e > s]
