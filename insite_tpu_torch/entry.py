"""The flagship forward step: one rollout of the discovered EQ_4 model,
shared by every patient, through the rollout kernel. The port of the
repository's `__graft_entry__.py::entry` (its multi-device dry run is not
ported: one card has no mesh).

    from insite_tpu_torch.entry import entry
    fn, args = entry()              # on cuda:0; entry('cpu') on the host
    preds = fn(*args)               # [64, 59]
"""

from __future__ import annotations

import numpy as np
import torch

from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.ops.rollout import batched_rollout

DT = 1.0 / 6.0


def entry(device=None):
    """(fn, example_args): ``fn(coefs [A, F], y0 [B], statics [B, 2], arms
    [B, T])`` rolls every patient out under the one shared model, [B, T]
    predictions, in float32 on ``device`` (``cuda:0`` unless the caller
    asks for another). The model and batch are the JAX package's (seed 0,
    B = 64 patients, T = 59 steps, A = 2 arms, F = 7 features). On a CUDA
    device a call launches the rollout kernel once; on the CPU it runs the
    kernel's plain version."""
    device = torch.device('cuda', 0) if device is None else \
        torch.device(device)
    lib = PolynomialLibrary(n_inputs=3)        # [y, c0, c1], the EQ_4 family
    rng = np.random.RandomState(0)
    B, T = 64, 59
    coefs = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                      [0, -0.2, 0, 0, 0, -1.0, 0]])
    prev = np.abs(rng.randn(B, T)) * 10 + 1
    statics = rng.rand(B, 2) * 0.4 + 0.3
    arms = rng.randint(0, 2, (B, 1)) * np.ones((B, T), np.int32)

    def on(a, dtype=torch.float32):
        return torch.as_tensor(a, device=device).to(dtype)

    def fn(coefs, y0, statics, arms):
        return batched_rollout(lib, coefs[None], y0, statics, arms, DT)

    return fn, (on(coefs), on(prev[:, 0]), on(statics),
                on(arms, torch.int32))
