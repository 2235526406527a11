"""INSITE's BFGS fine-tune and its 'xla' route: the port's batched BFGS
(`ops/bfgs.py`) against `jax.scipy.optimize.minimize`, the BFGS fine-tune
(`insite_finetune_predict`, gradients from the sensitivity recurrence's
plain version) against the JAX package's (reverse mode through the
rollout scan), the lam tune under BFGS, and the Levenberg-Marquardt
fine-tune with its Jacobian from jvp through the plain rollout
(`insite_gn_finetune_predict_jvp`) against the JAX package's, all in
float64 on the CPU. Each JAX fine-tune runs once per module (its
vmapped BFGS is costly to compile), at a small size."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.optimize import minimize

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.harness import tuning as jax_tuning
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu.models.sindy import insite_finetune_predict as jax_bfgs
from insite_tpu.models.sindy import insite_gn_finetune_predict as jax_gn_jvp
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS, make_collection
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.harness import tuning
from insite_tpu_torch.models.sindy import (SINDyConfig, SINDyRegressor,
                                           insite_finetune_predict,
                                           insite_gn_finetune_predict,
                                           insite_gn_finetune_predict_jvp)
from insite_tpu_torch.ops.bfgs import minimize_bfgs
from insite_tpu_torch.ops.joint_fold import JointFold, combination_index

F64 = dict(device='cpu', dtype=torch.float64)
torch.set_num_threads(1)


def _close(got, want, rtol, atol, what):
    """assert_allclose, printing the largest relative deviation."""
    got, want = np.asarray(got), np.asarray(want)
    dev = np.abs(got - want) / np.maximum(np.abs(want),
                                          max(atol / rtol, 1e-300))
    print(f'{what}: largest relative deviation {dev.max():.3e}')
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# minimize_bfgs on smooth test functions

# row r: s (a - x0)^2 + s b (x1 - x0^2)^2 + 0.5 (x2 - c)^2 + l x1
TEST_PARAMS = np.array([
    [1.0, 1.0, 100.0, 0.3, 0.0],      # Rosenbrock: the zoom fails (3)
    [1e12, 1.0, 100.0, 0.1, 0.0],     # scaled past f64: the zoom fails
    [1.0, 2.0, 5.0, -1.0, 0.0],
    [1.0, 1.0, 100.0, 0.0, 0.0],      # starts at the minimum (0 at once)
    [3.0, -1.0, 10.0, 2.0, 0.0],      # 16 iterations: maxiter (1)
    [0.0, 0.0, 0.0, 0.5, -1.0],       # unbounded along x1: the line
                                      # search reaches its maxiter (5)
])
TEST_X0 = np.array([[-1.2, 1.0, 0.0], [-1.2, 1.0, 0.0], [0.5, 0.2, 1.0],
                    [1.0, 1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.5]])
TEST_MAXITER = 12


def _test_function(x, p):
    """x [..., 3], p [..., 5] -> f [...]; numpy-style ops shared by both
    packages."""
    s, a, b, c, lin = (p[..., i] for i in range(5))
    x0, x1, x2 = (x[..., i] for i in range(3))
    return s * ((a - x0) ** 2 + b * (x1 - x0 ** 2) ** 2) + \
        0.5 * (x2 - c) ** 2 + lin * x1


@pytest.fixture(scope='module')
def jax_minimize_rows():
    """jax.vmap of `minimize(method='BFGS')`, one row a problem."""
    def one(x0, p):
        r = minimize(lambda x: _test_function(x, p), x0, method='BFGS',
                     options={'maxiter': TEST_MAXITER})
        return r.x, r.status, r.nit
    x, status, nit = jax.jit(jax.vmap(one))(jnp.asarray(TEST_X0),
                                            jnp.asarray(TEST_PARAMS))
    return np.asarray(x), np.asarray(status), np.asarray(nit)


def test_minimize_bfgs_matches_jax_per_row(jax_minimize_rows):
    """Every row's status and iteration count equal JAX's, and its x
    within rtol 1e-10 (measured 2.1e-14 relative at most). The batch holds
    a row of each ending: converged, converged at once, maxiter, zoom
    failed, line search at its maxiter."""
    x_ref, status_ref, nit_ref = jax_minimize_rows
    p = torch.tensor(TEST_PARAMS)

    def fun_and_grad(x):
        x = x.detach().requires_grad_(True)
        f = _test_function(x, p)
        g, = torch.autograd.grad(f.sum(), x)
        return f.detach(), g

    res = minimize_bfgs(fun_and_grad, torch.tensor(TEST_X0),
                        maxiter=TEST_MAXITER)
    assert res.status.tolist() == status_ref.tolist()
    assert res.k.tolist() == nit_ref.tolist()
    assert set(status_ref.tolist()) == {0, 1, 3, 5}
    assert nit_ref[3] == 0
    # the line search's last point on the unbounded row is far out
    finite = np.isfinite(x_ref).all(1)
    assert finite.sum() >= 5
    _close(res.x_k.numpy()[finite], x_ref[finite], 1e-10, 1e-12, 'x')
    assert res.n_evals > 1


# ---------------------------------------------------------------------------
# the BFGS fine-tune

B, T, PH, DT = 32, 16, 5, 1 / 6
BASE = np.stack([[8e-4, 0.3, 0, 0, -1.0, 0, 0],
                 [0, -0.2, 0, 0, 0, -1.0, 0]])
ACTIVE = tuple(int(i) for i in np.flatnonzero(np.abs(BASE.reshape(-1))
                                              > 1e-3))


def _cohort(seed=2):
    """Noisy trajectories over the EQ_4 library, every 7th row too short
    to fine-tune (lengths <= PH)."""
    rng = np.random.RandomState(seed)
    statics = rng.rand(B, 2)
    arms = (rng.randint(0, 2, (B, 1)) * np.ones((B, T))).astype(np.int32)
    prev = np.abs(rng.randn(B, T)) * 5 + 1
    lengths = np.full(B, T, np.int32)
    lengths[::7] = 3
    return prev, statics, arms, lengths


def _port_args(prev, statics, arms, lengths, coefs=BASE):
    return (PolynomialLibrary(n_inputs=3), torch.tensor(coefs),
            torch.from_numpy(prev), torch.from_numpy(statics),
            torch.from_numpy(arms), torch.from_numpy(lengths), DT)


@pytest.fixture(scope='module')
def jax_bfgs_finetune():
    """The JAX package's BFGS fine-tune of `_cohort()` at lam 10, with
    two ``bfgs_tol``."""
    prev, statics, arms, lengths = _cohort()
    out = {}
    for tol in (1e-12, 1e-2):
        out[tol] = tuple(np.asarray(a) for a in jax_bfgs(
            JaxLibrary(n_inputs=3), jnp.asarray(BASE), jnp.asarray(prev),
            jnp.asarray(statics), jnp.asarray(arms), jnp.asarray(lengths),
            DT, 10.0, projection_horizon=PH, bfgs_tol=tol, bfgs_maxiter=20))
    return out


def test_bfgs_finetune_matches_jax(jax_bfgs_finetune):
    """Predictions and coefficients within rtol 1e-8 of the JAX package's
    (measured: 2.2e-14 relative), status-3 rows on the masked global model
    and skip rows on the full one, in both."""
    p_ref, c_ref = jax_bfgs_finetune[1e-12]
    prev, statics, arms, lengths = _cohort()
    p, c, res = insite_finetune_predict(
        *_port_args(prev, statics, arms, lengths), 10.0,
        projection_horizon=PH, bfgs_maxiter=20, active_idx=ACTIVE)
    status = res.status.numpy()
    skip = lengths <= PH
    assert (status == 3).sum() >= 2 and (status[~skip] == 0).sum() >= 20
    masked = BASE * (np.abs(BASE) > 1e-3)
    np.testing.assert_array_equal(c.numpy()[status == 3][:, None],
                                  np.broadcast_to(masked, c[status == 3]
                                                  .shape)[:, None])
    assert (c.numpy()[skip] == BASE).all() and c[0, 0, 0] == 8e-4
    assert (res.k.numpy()[~skip & (status == 0)] > 0).all()
    _close(c.numpy(), c_ref, 1e-8, 1e-12, 'BFGS fine-tune coefs')
    _close(p.numpy(), p_ref, 1e-8, 1e-12, 'BFGS fine-tune preds')


def test_bfgs_tol_changes_nothing(jax_bfgs_finetune):
    """The JAX package hands ``bfgs_tol`` to `minimize` as ``tol``, which
    its BFGS ignores; the port takes no tolerance, and the estimator's
    field changes nothing either."""
    for a, b in zip(jax_bfgs_finetune[1e-12], jax_bfgs_finetune[1e-2]):
        np.testing.assert_array_equal(a, b)
    coll = make_collection('EQ_4_D', {'train': 40, 'val': 2, 'test': 1},
                           seed=0, coeff=2.0, **F64)
    coefs = []
    for tol in (1e-12, 1e-2):
        cfg = SINDyConfig(dataset_name='EQ_4_D', insite=True,
                          insite_solver='bfgs', bfgs_maxiter=10,
                          bfgs_tol=tol)
        model = SINDyRegressor(cfg, coll, **F64).fit(coll.train_f)
        coefs.append(model.get_fine_tuned_coefficients(coll.val_f))
    np.testing.assert_array_equal(*coefs)


def test_per_row_lam_equals_separate_calls():
    """A [2B] penalty (the rows stacked twice, lam 0 and 100) gives each
    block the result of a call with its lam (measured: bit for bit)."""
    prev, statics, arms, lengths = _cohort(seed=0)
    stacked = [np.concatenate([x, x]) for x in (prev, statics, arms,
                                                lengths)]
    lam = torch.tensor([0.0] * B + [100.0] * B, dtype=torch.float64)
    p, c, _ = insite_finetune_predict(
        *_port_args(*stacked), lam, projection_horizon=PH, bfgs_maxiter=20,
        active_idx=ACTIVE)
    for blk, lam_g in enumerate((0.0, 100.0)):
        p_g, c_g, _ = insite_finetune_predict(
            *_port_args(prev, statics, arms, lengths), lam_g,
            projection_horizon=PH, bfgs_maxiter=20, active_idx=ACTIVE)
        rows = slice(blk * B, (blk + 1) * B)
        _close(c[rows].numpy(), c_g.numpy(), 1e-12, 0, 'per-row lam coefs')
        _close(p[rows].numpy(), p_g.numpy(), 1e-12, 0, 'per-row lam preds')
    assert not torch.allclose(c[:B], c[B:])


def test_per_row_globals_move_only_their_own_support():
    """Global models per row (the vectorized columns): a row whose own
    support leaves out one coordinate of the union keeps it at its global
    value, 0 after the mask, and its other coordinates equal a call with
    that row's model alone (rtol 1e-12; measured: bit for bit)."""
    prev, statics, arms, lengths = _cohort(seed=1)
    per_row = np.repeat(BASE[None], B, axis=0)
    per_row[1::2, 1, 1] = 0.0           # odd rows: without (arm 1, y)
    p, c, _ = insite_finetune_predict(
        *_port_args(prev, statics, arms, lengths, per_row), 10.0,
        projection_horizon=PH, bfgs_maxiter=20, active_idx=ACTIVE)
    assert (c[1::2, 1, 1] == 0).all()
    odd = slice(1, None, 2)
    own = tuple(i for i in ACTIVE if i != 8)
    p_o, c_o, _ = insite_finetune_predict(
        *_port_args(prev[odd], statics[odd], arms[odd], lengths[odd],
                    per_row[1]), 10.0, projection_horizon=PH,
        bfgs_maxiter=20, active_idx=own)
    _close(c[odd].numpy(), c_o.numpy(), 1e-12, 1e-15, 'per-row globals coefs')
    _close(p[odd].numpy(), p_o.numpy(), 1e-12, 1e-15, 'per-row globals preds')


def test_one_ode_fold_matches_jax_joint_bfgs():
    """The one-ODE model: the fold's joint-coordinate sensitivities drive
    the BFGS; coefficients and predictions within rtol 1e-8 of the JAX
    package's ``joint=True`` BFGS (measured: 2.1e-15 relative)."""
    rng = np.random.RandomState(3)
    E, S, n = 1, 2, 12
    lib = PolynomialLibrary(n_inputs=1 + E + S)
    F = lib.n_features
    g = np.zeros((1, F))
    g[0, 1], g[0, 4], g[0, 7] = -0.8, 0.3, -0.2     # y, y*u, y*c0
    g[0, 0] = 5e-4                                   # retained, inactive
    active = tuple(int(i) for i in np.flatnonzero(np.abs(g[0]) > 1e-3))
    u = rng.randint(0, 2, (n, 1)) * np.ones((n, T))
    prev = np.abs(rng.randn(n, T)) * 3 + 1
    statics = rng.rand(n, S)
    lengths = np.full(n, T, np.int32)
    lengths[4] = 2
    p_ref, c_ref = (np.asarray(a) for a in jax_bfgs(
        JaxLibrary(n_inputs=1 + E + S), jnp.asarray(g), jnp.asarray(prev),
        jnp.asarray(statics), jnp.asarray(u), jnp.asarray(lengths), DT, 10.0,
        projection_horizon=PH, joint=True, bfgs_maxiter=20))
    p, c, res = insite_finetune_predict(
        lib, torch.tensor(g), torch.from_numpy(prev),
        torch.from_numpy(statics),
        torch.as_tensor(combination_index(u)), torch.from_numpy(lengths), DT,
        10.0, projection_horizon=PH, bfgs_maxiter=20, active_idx=active,
        fold=JointFold(lib, E))
    assert (res.k.numpy() > 0).sum() >= n - 2
    _close(c.numpy(), c_ref, 1e-8, 1e-12, 'fold coefs')
    _close(p.numpy(), p_ref, 1e-8, 1e-12, 'fold preds')


def test_tune_insite_lam_under_bfgs_matches_jax():
    """`tune_insite_lam` with ``insite_solver='bfgs'``: the seven scores
    within rtol 1e-6 of the JAX tuner's vmapped BFGS (measured 1.4e-10),
    the same best lam."""
    ref = jax_make_collection('EQ_4_D', {'train': 60, 'val': 3, 'test': 1},
                              0, 2.0, dtype=jnp.float64)
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_D', projection_horizon=5,
        treatment_mode='multiclass')
    ref.process_data_multi(include_continuous_treatment=False)
    ours.process_data_multi(include_continuous_treatment=False)
    cfg = dict(dataset_name='EQ_4_D', insite=True, insite_solver='bfgs',
               bfgs_maxiter=15)
    model = SINDyRegressor(SINDyConfig(**cfg), ours, **F64).fit(ours.train_f)
    jax_model = JaxRegressor(JaxConfig(**cfg), ref).fit(ref.train_f)
    best, scores = tuning.tune_insite_lam(model, ours.val_f)
    jax_best, jax_scores = jax_tuning.tune_insite_lam(jax_model, ref.val_f)
    assert list(scores) == list(jax_scores) == list(tuning.INSITE_LAM_GRID)
    _close([scores[k] for k in scores], [jax_scores[k] for k in scores],
           1e-6, 0, 'lam scores')
    assert best == jax_best == model.cfg.lam
    assert len(set(scores.values())) > 1


# ---------------------------------------------------------------------------
# the 'xla' route: Levenberg-Marquardt with the Jacobian from jvp

def test_jvp_route_matches_jax_and_the_kernel_route():
    """`insite_gn_finetune_predict_jvp` against the JAX package's
    `insite_gn_finetune_predict` (jvp through the scan; rtol 1e-8,
    measured 3e-15 on this cohort, that of tests/test_torch_finetune.py;
    on the noisy `_cohort` it reaches 7e-09, where an ill-conditioned
    row's LM steps amplify the rounding of the JAX penalty's
    sqrt(lam / K)^2) and against the port's kernel-route LM on the CPU,
    whose Jacobian comes from the sensitivity recurrence's plain version
    (rtol 1e-10, measured 6.6e-16)."""
    rng = np.random.RandomState(0)
    n, t = 8, 14
    prev = np.abs(rng.randn(n, t)) * 5 + 1
    statics = rng.rand(n, 2)
    arms = (rng.randint(0, 2, (n, 1)) * np.ones((n, t))).astype(np.int32)
    lengths = np.array([t, t, t, t, t, 3, t, 9], np.int32)
    kw = dict(projection_horizon=PH, gn_iters=6, active_idx=ACTIVE)
    p_ref, c_ref = (np.asarray(a) for a in jax_gn_jvp(
        JaxLibrary(n_inputs=3), jnp.asarray(BASE), jnp.asarray(prev),
        jnp.asarray(statics), jnp.asarray(arms), jnp.asarray(lengths), DT,
        10.0, **kw))
    args = _port_args(prev, statics, arms, lengths)
    p, c = insite_gn_finetune_predict_jvp(*args, 10.0, **kw)
    p_k, c_k = insite_gn_finetune_predict(*args, 10.0, **kw)
    assert not np.allclose(c.numpy()[1], BASE)
    _close(c.numpy(), c_ref, 1e-8, 1e-12, 'jvp vs JAX coefs')
    _close(p.numpy(), p_ref, 1e-8, 1e-12, 'jvp vs JAX preds')
    _close(c.numpy(), c_k.numpy(), 1e-10, 1e-14, 'jvp vs kernel route coefs')
    _close(p.numpy(), p_k.numpy(), 1e-10, 1e-14, 'jvp vs kernel route preds')


def test_jvp_route_of_the_fold_and_per_row_lam():
    """The one-ODE fold through its plain differentiable rollout, with a
    penalty per row, equals the kernel route's plain versions (rtol
    1e-10, measured 1.2e-12)."""
    rng = np.random.RandomState(5)
    E, S, n = 1, 2, 10
    lib = PolynomialLibrary(n_inputs=1 + E + S)
    g = np.zeros((1, lib.n_features))
    g[0, 1], g[0, 4], g[0, 7] = -0.8, 0.3, -0.2
    active = (1, 4, 7)
    u = rng.randint(0, 2, (n, 1)) * np.ones((n, T))
    args = (lib, torch.tensor(g),
            torch.from_numpy(np.abs(rng.randn(n, T)) * 3 + 1),
            torch.from_numpy(rng.rand(n, S)),
            torch.as_tensor(combination_index(u)),
            torch.full((n,), T, dtype=torch.int64), DT,
            torch.linspace(0.0, 100.0, n, dtype=torch.float64))
    kw = dict(projection_horizon=PH, gn_iters=5, active_idx=active,
              fold=JointFold(lib, E))
    p, c = insite_gn_finetune_predict_jvp(*args, **kw)
    p_k, c_k = insite_gn_finetune_predict(*args, **kw)
    _close(c.numpy(), c_k.numpy(), 1e-10, 1e-14, 'fold jvp coefs')
    _close(p.numpy(), p_k.numpy(), 1e-10, 1e-14, 'fold jvp preds')


@pytest.mark.parametrize('field, value, match', [
    ('rollout_backend', 'pallas', 'need CUDA tensors'),
    ('rollout_backend', 'triton', 'expected one of'),
    ('insite_solver', 'newton', 'expected one of')])
def test_unserved_backends_and_solvers_raise(field, value, match):
    """'pallas' asks for the kernels, which take CUDA tensors only: on
    the CPU it raises (the JAX package would fall back to XLA, which the
    port does not copy); unknown names raise."""
    with pytest.raises(ValueError, match=match):
        SINDyRegressor(SINDyConfig(**{field: value}), None, **F64)
