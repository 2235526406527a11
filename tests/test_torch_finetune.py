"""INSITE Levenberg-Marquardt fine-tune: the port (batched, Jacobian from
the rollout-with-sensitivities plain version) against the JAX XLA fine-tune
(jvp through the rollout scan) on the fixture of
tests/test_pallas_rollout.py::test_pallas_gn_finetune_matches_xla_gn."""

import jax.numpy as jnp
import numpy as np
import torch

from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.models.sindy import \
    insite_gn_finetune_predict as jax_finetune
from insite_tpu_torch import convert
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.models.sindy import insite_gn_finetune_predict


def test_finetune_matches_jax_xla_gn_f64():
    rng = np.random.RandomState(0)
    B, T = 8, 14
    base = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                     [0, -0.2, 0, 0, 0, -1.0, 0]])
    # a retained SUB-threshold global coefficient (|c| <= 1e-3): skip rows
    # (seq_len <= projection_horizon) roll out the FULL unmasked global model
    base[0, 0] = 8e-4
    active_idx = tuple(int(i) for i in
                       np.flatnonzero(np.abs(base.reshape(-1)) > 1e-3))
    prev = np.abs(rng.randn(B, T)) * 5 + 1
    statics = rng.rand(B, 2)
    arms = (rng.randint(0, 2, (B, 1)) * np.ones((B, T))).astype(np.int32)
    lengths = np.array([T, T, T, T, T, 3, T, 9], np.int32)
    kw = dict(projection_horizon=5, gn_iters=6, active_idx=active_idx)

    p_ref, c_ref = (np.asarray(a) for a in jax_finetune(
        JaxLibrary(n_inputs=3), jnp.asarray(base), jnp.asarray(prev),
        jnp.asarray(statics), jnp.asarray(arms), jnp.asarray(lengths),
        1 / 6, 10.0, **kw))
    f64 = dict(device='cpu', dtype=torch.float64)
    p, c = insite_gn_finetune_predict(
        PolynomialLibrary(n_inputs=3), convert.coefs_from_numpy(base, **f64),
        torch.from_numpy(prev), torch.from_numpy(statics),
        torch.from_numpy(arms), torch.from_numpy(lengths), 1 / 6, 10.0, **kw)
    p, c = p.numpy(), c.numpy()

    assert c[5, 0, 0] == 8e-4                     # the skip row's global model
    assert not np.allclose(c[0], base)            # the others moved
    # f64, the same LM update sequence; the Jacobian comes from the forward
    # sensitivity recurrence here and from jvp through the scan there.
    # Measured on the CPU: coefs and preds agree to 3e-15 relative.
    np.testing.assert_allclose(c, c_ref, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(p, p_ref, rtol=1e-8, atol=1e-12)
