"""The QR reduction's TSQR kernels (`ops/qr_reduce.py`,
`csrc/qr_reduce.cu`): the wrapper's checks and the host path here, the
kernels against numpy's float64 QR of the same weighted problem on a card.

This file imports no JAX, so the card-side tests run where JAX is absent:

    python -m pytest tests/test_torch_qr_kernel.py --noconftest -m cuda -q
"""

import importlib

import numpy as np
import pytest
import torch

from insite_tpu_torch import ops
from insite_tpu_torch.harness import northstar
from insite_tpu_torch.ops import qr_reduce as qr

# the module: the subpackage exports the function `stlsq` under its name
stlsq = importlib.import_module('insite_tpu_torch.discovery.stlsq')


def design(N, F, K, seed=0, arm_dtype=np.int64, weighted=False):
    """Rows of a polynomial-library-like design: a constant column, one
    spread over [1, 41] and columns near 0.5 (the EQ_4 statics), the rest
    products of them; a response; ragged validity; K arms."""
    rng = np.random.RandomState(seed)
    x = rng.rand(N) * 40 + 1
    u = 0.5 + 0.05 * rng.randn(N, 2)
    cols = [np.ones(N), x, u[:, 0], u[:, 1], x * u[:, 0], x * u[:, 1],
            u[:, 0] * u[:, 1]]
    while len(cols) < F:
        cols.append(cols[len(cols) % 7] * x ** (len(cols) // 7) / 40.0)
    theta = np.stack(cols[:F], axis=1)
    y = -1.05 * x * u[:, 0] - 0.14 * x + 0.01 * rng.randn(N)
    return dict(theta=theta, y=y, ok=rng.rand(N) > 0.2,
                arm=rng.randint(0, K, N).astype(arm_dtype),
                weight=rng.rand(N) if weighted else None)


def tensors(case, device, dtype):
    """The case's arrays as the kernels take them."""
    out = {}
    for name, x in case.items():
        if x is None:
            out[name] = None
            continue
        x = np.asarray(x)
        t = (dtype if x.dtype == np.float64 else
             torch.bool if x.dtype == bool else torch.int64)
        out[name] = torch.as_tensor(x, dtype=t, device=device)
    return out


def augmented_gram(T):
    """[K, C, C] triangles -> T_k^T T_k, the Gram of [theta | y] (R^T R,
    R^T Q^T y and y^T y): sign-invariant."""
    T = np.asarray(T, np.float64)
    return np.einsum('kij,kil->kjl', T, T)


def assert_same_problem(got, want, rtol):
    """The Grams of two sets of triangles agree, each entry to rtol of
    sqrt(G_ii G_jj): a reduction's error scales with the norms of the two
    columns it combines."""
    g, w = augmented_gram(got), augmented_gram(want)
    d = np.sqrt(np.einsum('kii->ki', w))
    scale = d[:, :, None] * d[:, None, :]
    err = np.abs(g - w)
    assert (err <= rtol * scale).all(), (err / np.maximum(scale, 1e-300)).max()


# ---------------------------------------------------------------------------
# the wrapper's checks and the host path (run everywhere)

def test_wrapper_refuses_cpu_tensors():
    t = tensors(design(50, 7, 2), 'cpu', torch.float32)
    with pytest.raises(ValueError, match='CUDA tensors'):
        qr.qr_reduce(t['theta'], t['y'], 2, ok=t['ok'], arm=t['arm'])


@pytest.mark.parametrize('F,K', [(36, 1), (7, 9), (7, 0)])
def test_wrapper_refuses_widths_beyond_its_bound(F, K):
    t = tensors(design(50, F, max(K, 1)), 'cpu', torch.float32)
    with pytest.raises(ValueError, match='the QR kernels take F in'):
        qr.qr_reduce(t['theta'], t['y'], K)


def test_inputs_on_two_devices_raise():
    """Tensors on two devices raise before anything runs (a CPU tensor
    beside a 'meta' one)."""
    t = tensors(design(50, 7, 2), 'cpu', torch.float32)
    with pytest.raises(ValueError, match='more than one device'):
        qr.qr_reduce(t['theta'], t['y'].to('meta'), 2, arm=t['arm'])


def test_reset_launch_counts_zeroes_the_qr_counter(monkeypatch):
    monkeypatch.setattr(qr, 'QR_LAUNCHES', 5)
    ops.reset_launch_counts()
    assert qr.QR_LAUNCHES == 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,F,K,arm_dtype', [
    (400, 7, 2, np.float64),        # the north star's float arms
    (333, 4, 4, np.int64),          # the tumour family's
    (5, 7, 2, np.int64),            # fewer rows than F + 1
    (120, 7, 1, None)])             # the joint model: no arm
def test_qr_reduce_arms_on_cpu_is_per_arm_qr_reduce(dtype, N, F, K,
                                                    arm_dtype):
    """On the host each arm's triangle is `_qr_reduce`'s LAPACK QR with
    the arm's 0/1 weight, bit for bit."""
    c = design(N, F, K, arm_dtype=arm_dtype or np.int64)
    t = tensors(c, 'cpu', dtype)
    arm = None if arm_dtype is None else t['arm']
    tri = stlsq._qr_reduce_arms(t['theta'], t['y'], t['ok'], arm, K)
    assert tri.shape == (K, F + 1, F + 1) and tri.dtype == dtype
    for a in range(K):
        w = t['ok'] if arm is None else t['ok'] & (arm == a)
        R, qty = stlsq._qr_reduce(t['theta'], t['y'], w.to(dtype))
        torch.testing.assert_close(tri[a, :F, :F], R, rtol=0, atol=0)
        torch.testing.assert_close(tri[a, :F, F], qty, rtol=0, atol=0)


def test_north_star_design_qr_on_cpu_is_per_arm_qr_reduce():
    """`design_qr` on a host cohort: one [2, F + 1, F + 1] tensor whose
    arms are the per-arm `_qr_reduce` of the design, bit for bit."""
    cohort = northstar.simulate_cohort(40, 3, device='cpu',
                                       dtype=torch.float64)
    tri = northstar.design_qr(cohort)
    vol, statics, treat, lengths = cohort
    theta, y, ok, arm = northstar._eq4_design(
        vol, statics, treat, torch.clamp(lengths - 1, min=2),
        northstar.STANDARD_DT, library=northstar.LIBRARY, smooth=True,
        fd_order=4)
    F = theta.shape[1]
    for a in range(2):
        R, qty = stlsq._qr_reduce(theta, y,
                                  (ok & (arm == a)).to(theta.dtype))
        torch.testing.assert_close(tri[a, :F, :F], R, rtol=0, atol=0)
        torch.testing.assert_close(tri[a, :F, F], qty, rtol=0, atol=0)


@pytest.mark.parametrize('N,F,K,weighted', [
    (300, 7, 2, False), (301, 4, 4, True), (4, 7, 2, False), (0, 3, 1, False)])
def test_plain_version_reduces_the_weighted_problem(N, F, K, weighted):
    """`qr_reduce_plain`, the kernels' reference: upper triangular with a
    non-negative diagonal, and its Gram is each arm's weighted normal
    equations of [theta | y]."""
    c = design(N, F, K, weighted=weighted)
    t = tensors(c, 'cpu', torch.float64)
    T = qr.qr_reduce_plain(t['theta'], t['y'], K, t['weight'], t['ok'],
                           t['arm'])
    assert T.shape == (K, F + 1, F + 1)
    assert (np.tril(T, -1) == 0).all()
    assert (np.einsum('kii->ki', T) >= 0).all()
    A = np.concatenate([c['theta'], c['y'][:, None]], axis=1)
    w = np.ones(N) if c['weight'] is None else c['weight']
    for a in range(K):
        m = (w * c['ok'] * (c['arm'] == a))[:, None]
        np.testing.assert_allclose(augmented_gram(T[a:a + 1])[0],
                                   A.T @ (m * A), rtol=1e-10, atol=1e-9)


# ---------------------------------------------------------------------------
# on a CUDA card (skipped without one: a CUDA kernel has no CPU mode)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels run only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# the Gram's tolerance against numpy's float64 QR: the kernels work in
# float64 and round the triangle to the input's type once
GRAM_RTOL = {torch.float32: 1e-5, torch.float64: 1e-10}

# (N, F, arms, design keywords)
CARD_CASES = {
    # the north star: 10,000 patients x 60 steps, float arms
    'northstar': (600_000, 7, 2, dict(arm_dtype=np.float64)),
    # the EQ_4 main run's fit: 1,000 patients x 60 steps
    'eq4_main_run': (60_000, 7, 2, dict(seed=1)),
    # the tumour family: 4 arms switching per step, F = 4
    'cancer': (59_000, 4, 4, dict(seed=2)),
    # the degree-4 library
    'degree4': (60_000, 35, 2, dict(seed=3)),
    # rows not a multiple of the kernels' blocks
    'ragged': (1_013, 7, 2, dict(seed=4)),
    # fewer rows than F + 1
    'short': (5, 7, 2, dict(seed=5)),
    # a sample weight, one arm given by none
    'weighted': (20_001, 7, 1, dict(seed=6, weighted=True)),
}


def run_card(case, device, dtype, K):
    t = tensors(case, device, dtype)
    out = qr.qr_reduce(t['theta'], t['y'], K, weight=t['weight'],
                       ok=t['ok'], arm=t['arm'])
    torch.cuda.synchronize()
    ref = qr.qr_reduce_plain(t['theta'], t['y'], K, t['weight'], t['ok'],
                             t['arm'])
    return out, ref


def check_triangles(out, dtype, C):
    assert out.dtype == dtype and out.shape[1:] == (C, C)
    T = out.cpu().numpy()
    assert np.isfinite(T).all()
    assert (np.tril(T, -1) == 0).all()
    assert (np.einsum('kii->ki', T) >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('name', list(CARD_CASES))
def test_kernel_matches_float64_qr_on_cuda(cuda, dtype, name):
    N, F, K, kw = CARD_CASES[name]
    case = design(N, F, K, **kw)
    if K == 1:
        case['arm'] = None
    out, ref = run_card(case, cuda, dtype, K)
    check_triangles(out, dtype, F + 1)
    assert_same_problem(out.cpu().numpy(), ref, GRAM_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_duplicated_columns_leave_a_zero_pivot_on_cuda(cuda, dtype):
    """The EQ_5 A/B design: 'u0' a copy of '1' and 'x0 u0' of 'x0'. The
    reduction still matches, without NaN, and the dependent columns'
    pivots are below `stlsq_from_qr`'s rank threshold, F times the
    epsilon of R's type times the largest."""
    case = design(30_000, 7, 2, seed=7)
    case['theta'][:, 2] = 1.0
    case['theta'][:, 4] = case['theta'][:, 1]
    out, ref = run_card(case, cuda, dtype, 2)
    check_triangles(out, dtype, 8)
    assert_same_problem(out.cpu().numpy(), ref, GRAM_RTOL[dtype])
    diag = np.abs(np.einsum('kii->ki', out.cpu().numpy().astype(np.float64)))
    eps = torch.finfo(dtype).eps
    assert (diag[:, [2, 4]] <= 7 * eps * diag.max(1, keepdims=True)).all()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_arm_with_no_rows_is_zero_on_cuda(cuda, dtype):
    case = design(10_000, 4, 4, seed=8)
    case['arm'][case['arm'] == 2] = 1
    out, ref = run_card(case, cuda, dtype, 4)
    check_triangles(out, dtype, 5)
    assert (out[2] == 0).all()
    assert_same_problem(out.cpu().numpy(), ref, GRAM_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_two_runs_are_bit_identical_on_cuda(cuda, dtype):
    t = tensors(design(600_000, 7, 2, arm_dtype=np.float64), cuda, dtype)
    a, b = (qr.qr_reduce(t['theta'], t['y'], 2, ok=t['ok'], arm=t['arm'])
            for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_launch_per_design_qr_and_no_cusolver_on_cuda(cuda, monkeypatch):
    cohort = northstar.simulate_cohort(2_000, 0, device=cuda)

    def refuse(*args, **kwargs):
        raise AssertionError('torch.linalg.qr called on the card path')

    monkeypatch.setattr(torch.linalg, 'qr', refuse)
    ops.reset_launch_counts()
    tri = northstar.design_qr(cohort)
    torch.cuda.synchronize()
    assert qr.QR_LAUNCHES == 1 and tri.shape == (2, 8, 8)


def cusolver_triangles(cohort):
    """The reduction as the port made it before the kernels: each arm's
    weighted copy of the design through cuSOLVER's QR."""
    vol, statics, treat, lengths = cohort
    theta, y, ok, arm = northstar._eq4_design(
        vol, statics, treat, torch.clamp(lengths - 1, min=2),
        northstar.STANDARD_DT, library=northstar.LIBRARY, smooth=True,
        fd_order=4)
    out = []
    for a in range(2):
        w = torch.sqrt((ok & (arm == a)).to(theta.dtype))
        A = torch.cat([theta * w[:, None], (y * w)[:, None]], dim=1)
        out.append(torch.linalg.qr(A, mode='r').R)
    return torch.stack(out).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [0, 1, 2])
def test_north_star_stlsq_matches_the_cusolver_path_on_cuda(cuda, seed):
    """The north star's STLSQ (threshold 0.1, alpha 0.5) from the kernels'
    triangles against cuSOLVER's: the same support, coefficients within
    1e-5 relative."""
    cohort = northstar.simulate_cohort(10_000, seed, device=cuda)
    got = northstar.design_qr(cohort).cpu().numpy()
    want = cusolver_triangles(cohort)
    F = got.shape[-1] - 1
    for a in range(2):
        c, m = stlsq.stlsq_from_qr(got[a, :F, :F], got[a, :F, F], 0.1, 0.5)
        c_ref, m_ref = stlsq.stlsq_from_qr(want[a, :F, :F], want[a, :F, F],
                                           0.1, 0.5)
        np.testing.assert_array_equal(m, m_ref)
        np.testing.assert_allclose(c, c_ref, rtol=1e-5, atol=0)
