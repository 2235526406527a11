"""The Levenberg-Marquardt fine-tune's chain (`models/sindy.py`): the same
arithmetic as the loop it replaced, bit for bit, on every path; its
counters; the sensitivity launcher's output buffers; the reader of
`lm_graph_hit_pct`; the support rule and the fine-tunes of an empty
support, which run no chain; and, on a card, the chain replayed from CUDA
graphs against the eager loop on the same tensors.

This file imports no JAX, so the card-side tests run where JAX is absent:

    python -m pytest tests/test_torch_lm_graph.py --noconftest -m cuda -q
"""

import numpy as np
import pytest
import torch

from benchmark import cell as cells
from benchmark.metrics import _program
from insite_tpu_torch import ops
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.models import sindy
from insite_tpu_torch.models.sindy import (insite_finetune_predict,
                                           insite_gn_finetune_predict,
                                           insite_gn_finetune_predict_jvp,
                                           support)
from insite_tpu_torch.ops import rollout
from insite_tpu_torch.utils import profiling

LIBRARY = PolynomialLibrary(n_inputs=3)
BASE = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                 [0, -0.2, 0, 0, 0, -1.0, 0]])
GN_ITERS = 6


def old_levenberg_marquardt(pb, resid_jac, lam, gn_iters):
    """The loop as it was before its chain was written as links over a
    state that keeps J^T J and J^T r in place of the Jacobian: the
    reference the links are held to, bit for bit."""
    dtype, dev, B, Kr = pb.prev.dtype, pb.prev.device, pb.B, pb.Kr
    g_red = pb.g_red
    eye = torch.eye(Kr, dtype=dtype, device=dev)
    if torch.is_tensor(lam):
        reg2 = (lam.to(torch.float64) / pb.K).to(dtype)
        reg2_vec, reg2_mat = reg2[:, None], reg2[:, None, None]
    else:
        reg2 = reg2_vec = reg2_mat = lam / pb.K

    r0, J0 = resid_jac(g_red.expand(B, Kr))
    mse0 = (r0 ** 2).sum(1) / pb.n_mask
    ds = 1.0 / torch.sqrt(2.5 * torch.clamp(mse0, min=1e-30) * pb.n_mask)

    def full_obj(r, c):
        return ((r * ds[:, None]) ** 2).sum(1) + \
            reg2 * ((c - g_red) ** 2).sum(1)

    def solve_step(r, J, c, mu):
        Js = J * ds[:, None, None]
        JtJ = torch.einsum('btj,btk->bjk', Js, Js) + reg2_mat * eye[None]
        rhs = -torch.einsum('btj,bt->bj', Js, r * ds[:, None]) \
            - reg2_vec * (c - g_red)
        delta = torch.linalg.solve_ex(JtJ + mu[:, None, None] * eye[None],
                                      rhs[..., None])[0][..., 0]
        return c + delta

    c_best = g_red.expand(B, Kr)
    r_best, J_best = r0, J0
    obj_best = full_obj(r0, c_best)
    mu = torch.full((B,), 1e-3, dtype=dtype, device=dev)
    cand = solve_step(r_best, J_best, c_best, mu)
    for _ in range(gn_iters):
        r_c, J_c = resid_jac(cand)
        obj_c = full_obj(r_c, cand)
        better = torch.isfinite(obj_c) & (obj_c < obj_best)
        c_best = torch.where(better[:, None], cand, c_best)
        obj_best = torch.where(better, obj_c, obj_best)
        r_best = torch.where(better[:, None], r_c, r_best)
        J_best = torch.where(better[:, None, None], J_c, J_best)
        mu = torch.clamp(torch.where(better, mu * 0.3, mu * 10.0), 1e-8, 1e8)
        cand = solve_step(r_best, J_best, c_best, mu)
    return c_best


def old_jvp_resid_jac(pb, args):
    """The jvp path's evaluation as it was before it joined the other
    paths' masking step: forward-mode autodiff through the residuals, the
    coordinates outside a row's own support zeroed, (r, J) at c [B, Kr]."""
    library, _, prev, statics, arms, _, dt, _ = args
    tangents = torch.eye(pb.Kr, dtype=prev.dtype)[:, None, :].expand(
        pb.Kr, pb.B, pb.Kr)

    def residuals(c):
        return pb.residuals(rollout.batched_rollout_plain(
            library, pb.to_full(c), prev[:, 0], statics, arms, dt))

    def resid_jac(c):
        r, Jt = torch.func.vmap(lambda v: torch.func.jvp(
            residuals, (c,), (v,)))(tangents)
        J = Jt.permute(1, 2, 0)
        if pb.per_row:
            J = torch.where(pb.own[:, None, :], J, 0.0)
        return r[0], J
    return resid_jac


def small_problem(per_row: bool, dtype, B=8, T=14, seed=0):
    """A small EQ_4 problem on the host: (args, keywords) of the
    fine-tune. ``per_row``: a global model per row, some rows with a
    smaller support, and a [B] penalty; else one model and a float."""
    rng = np.random.RandomState(seed)
    base = BASE.copy()
    base[0, 0] = 8e-4                   # retained below the threshold
    if per_row:
        g = base[None] * (1 + 0.1 * rng.randn(B, 1, 1))
        g[::3, 1, 1] = 0.0
        act = support(g)
        lam = torch.as_tensor(np.resize([0.1, 1.0, 10.0], B), dtype=dtype)
    else:
        g, act, lam = base, support(base), 10.0
    prev = np.abs(rng.randn(B, T)) * 5 + 1
    lengths = np.full(B, T)
    lengths[5], lengths[-1] = 3, 9
    f = dict(dtype=dtype)
    args = (LIBRARY, torch.as_tensor(g, **f), torch.as_tensor(prev, **f),
            torch.as_tensor(rng.rand(B, 2), **f),
            torch.as_tensor((rng.randint(0, 2, (B, 1)) * np.ones((B, T)))
                            .astype(np.int32)),
            torch.as_tensor(lengths), 1 / 6, lam)
    return args, dict(projection_horizon=5, gn_iters=GN_ITERS,
                      active_idx=act)


# ---------------------------------------------------------------------------
# on the host

@pytest.mark.parametrize('fine_tune', [insite_gn_finetune_predict,
                                       insite_gn_finetune_predict_jvp])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('per_row', [False, True])
def test_eager_chain_equals_the_old_loop_bit_for_bit(monkeypatch, fine_tune,
                                                     dtype, per_row):
    args, kw = small_problem(per_row, dtype)
    preds, coefs = fine_tune(*args, **kw)

    def resid_jac(pb, evaluate):
        if fine_tune is insite_gn_finetune_predict_jvp:
            return old_jvp_resid_jac(pb, args)
        return lambda c: pb.masked(*evaluate(pb.to_full(c)))

    monkeypatch.setattr(sindy, '_levenberg_marquardt',
                        lambda pb, evaluate, lam, gn_iters, **_:
                        old_levenberg_marquardt(pb, resid_jac(pb, evaluate),
                                                lam, gn_iters))
    ref_preds, ref_coefs = fine_tune(*args, **kw)
    assert not torch.equal(coefs[0], args[1][0] if per_row else args[1])
    assert torch.equal(preds, ref_preds) and torch.equal(coefs, ref_coefs)


def test_chains_are_counted_and_none_replayed_on_the_host(tmp_path):
    args, kw = small_problem(False, torch.float64)
    sindy._LM_GRAPHS.clear()
    with profiling.trace(tmp_path):
        for _ in range(3):
            insite_gn_finetune_predict(*args, **kw)
        insite_gn_finetune_predict_jvp(*args, **kw)
    totals = profiling.totals()
    assert totals['lm.chains'] == 4 * (1 + GN_ITERS)
    assert 'lm.graph_hits' not in totals
    assert 'lm.graph_captures' not in totals
    assert sindy._LM_GRAPHS == {} and sindy._LM_ARENAS == {}


def test_graph_key_is_none_off_the_card():
    args, kw = small_problem(True, torch.float32)
    pb = sindy._Reduced(args[1], args[2], args[5], kw['projection_horizon'],
                        kw['active_idx'])
    assert sindy._lm_graph_key(pb, args[7]) is None


def test_arena_lays_tensors_out_on_the_allocator_alignment():
    f32, f64 = torch.empty(3), torch.empty(5, dtype=torch.float64)
    sizes = sindy._LMArena.sizes([f32, torch.empty(2, 2), f64,
                                  torch.empty(7, dtype=torch.bool)])
    assert sizes == {torch.float32: 128 + 4, torch.float64: 5,
                     torch.bool: 7}


@pytest.fixture
def tracer_totals(monkeypatch):
    def use(totals):
        monkeypatch.setattr(_program, 'totals', lambda: totals)
    return use


@pytest.mark.parametrize('totals,pct', [
    ({'lm.chains': 52, 'lm.graph_hits': 52}, 100.0),
    ({'lm.chains': 52, 'lm.graph_hits': 13}, 25.0),
    ({'lm.chains': 52}, 0.0),
    ({'lm.graph_hits': 13}, None),
    ({}, None)])
def test_graph_hit_pct_reads_hits_over_chains(tracer_totals, totals, pct):
    tracer_totals(totals)
    got = cells.metric_reader('lm_graph_hit_pct')(
        {'tasks': 9, 'layer_s': {}, 'slice': {'tasks': 4}})
    assert got == (None if pct is None else pytest.approx(pct))


@pytest.mark.parametrize('bad', ['shape', 'dtype', 'strided'])
def test_sensitivity_buffers_are_checked(bad):
    B, T, Kr = 5, 9, 3
    y = torch.empty(B, T)
    s = {'shape': torch.empty(B, T, Kr + 1),
         'dtype': torch.empty(B, T, Kr, dtype=torch.float64),
         'strided': torch.empty(B, Kr, T).transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match='sens buffer'):
        rollout._sens_outputs((y, s), B, T, Kr, torch.float32,
                              torch.device('cpu'))
    good = (y, torch.empty(B, T, Kr))
    out = rollout._sens_outputs(good, B, T, Kr, torch.float32,
                                torch.device('cpu'))
    assert out[0] is good[0] and out[1] is good[1]


def test_buffers_reach_the_launcher_positionally_and_only_where_given():
    """A wrap shaped like the benchmark's launch recorder (trailing
    arguments taken as ``*rest``) receives the buffers as the last
    positional argument; without buffers the call is as it always was.
    More coordinates than one launch takes refuse buffers, and the plain
    version takes none."""
    seen = []

    def recorder(library, coefs, y0, statics, arms, dt, active_idx, *rest):
        seen.append(rest)
        return 'launched'

    args = (LIBRARY, None, None, None, None, 1 / 6)
    buffers = (torch.empty(1), torch.empty(1))
    assert rollout._sens_in_groups(recorder, 4, *args, (1, 4, 8), 5, None,
                                   buffers) == 'launched'
    assert rollout._sens_in_groups(recorder, 4, *args, (1, 4, 8), 5,
                                   None) == 'launched'
    assert seen[0] == (5, None, buffers) and seen[1] == (5, None)
    with pytest.raises(ValueError, match='one launch'):
        rollout._sens_in_groups(recorder, 2, *args, (1, 4, 8), 5, None,
                                buffers)
    args, kw = small_problem(False, torch.float32)
    with pytest.raises(ValueError, match='CUDA tensors only'):
        rollout.rollout_with_sens(args[0], args[1][None], args[2][:, 0],
                                  args[3], args[4], args[6], (1, 4),
                                  out=buffers)


# ---------------------------------------------------------------------------
# the support rule and the empty support

def test_support_is_the_union_of_the_coordinates_above_the_threshold():
    g = np.zeros((3, 2, 7))
    g[0, 0, 4], g[1, 1, 2] = -1.0, 2e-3
    g[2, 1, 5], g[2, 0, 0] = sindy.SUPPORT_THRESHOLD, -1.1e-3
    assert support(g[0]) == (4,)
    assert support(g[2]) == (0,)            # at the threshold is out
    assert support(g) == (0, 4, 9)          # arm * F + feature
    assert support(np.zeros((2, 7))) == ()
    assert all(type(i) is int for i in support(g))


EMPTY_SUPPORT = [
    pytest.param(insite_gn_finetune_predict, 'cpu', id='lm-cpu'),
    pytest.param(insite_gn_finetune_predict_jvp, 'cpu', id='lm-jvp-cpu'),
    pytest.param(insite_finetune_predict, 'cpu', id='bfgs-cpu'),
    pytest.param(insite_gn_finetune_predict, 'cuda', id='lm-kernels-cuda',
                 marks=pytest.mark.cuda)]


@pytest.mark.parametrize('fine_tune, device', EMPTY_SUPPORT)
@pytest.mark.parametrize('per_row', [False, True])
def test_an_empty_support_rolls_out_the_global_model_and_runs_no_chain(
        request, monkeypatch, tmp_path, fine_tune, device, per_row):
    """Every coefficient at or below the threshold: the skip rows roll out
    the global model and the others the masked one, all zeros, in one
    rollout; no sensitivity is evaluated, no link counted, and the span
    'predict.lm' never opens. BFGS returns None for its result."""
    if device == 'cuda':
        device = request.getfixturevalue('cuda')
    args, kw = small_problem(per_row, torch.float64)
    args = [x.to(device) if torch.is_tensor(x) else x for x in args]
    args[1] = args[1] * 5e-4
    g = args[1]
    assert support(g.cpu().numpy()) == ()
    kw = dict(projection_horizon=kw['projection_horizon'], active_idx=())

    def no_sensitivities(*a, **k):
        raise AssertionError('a sensitivity evaluation')

    monkeypatch.setattr(sindy, 'rollout_with_sens', no_sensitivities)
    monkeypatch.setattr(sindy, 'rollout_with_sens_plain', no_sensitivities)
    ops.reset_launch_counts()
    with profiling.trace(tmp_path):
        out = fine_tune(*args, **kw)
    totals = profiling.totals()
    assert totals['predict']['calls'] == 1 and 'predict.lm' not in totals
    assert not [k for k in totals if k.startswith('lm.')]
    if fine_tune is insite_finetune_predict:
        assert len(out) == 3 and out[2] is None
    preds, coefs = out[:2]
    skip = (args[5] <= kw['projection_horizon'])[:, None, None]
    want = torch.where(skip, g if per_row else g[None], 0.0)
    ref = rollout.batched_rollout_plain(LIBRARY, want, args[2][:, 0],
                                        args[3], args[4], args[6])
    assert torch.equal(coefs, want)
    if device == 'cpu':
        assert torch.equal(preds, ref)
    else:
        assert rollout.SENS_LAUNCHES == 0 and rollout.ROLLOUT_LAUNCHES == 1
        torch.testing.assert_close(preds, ref, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# on a CUDA card (skipped without one: the chain is captured only there)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the chain is captured only there')
    torch.backends.cuda.matmul.allow_tf32 = False
    for cache in (sindy._LM_GRAPHS, sindy._LM_ARENAS):
        cache.clear()
    yield torch.device('cuda', torch.cuda.current_device())
    for cache in (sindy._LM_GRAPHS, sindy._LM_ARENAS):
        cache.clear()


def cohort(device, dtype, B, seed):
    """The north star's EQ_4_D cohort of B patients, as its fine-tune
    takes it: (prev [B, 59], statics, arms, lengths)."""
    from insite_tpu_torch.harness import northstar
    vol, statics, treat, lengths = northstar.simulate_cohort(
        B, seed, device=device, dtype=dtype)
    return (vol[:, :-1], statics, treat[:, :-1].to(torch.int32), lengths)


def northstar_call(device, dtype, seed, act=(1, 4, 12), B=10_000):
    """(args, keywords) of the north star's fine-tune at its shapes (B
    10,000, T 59, Kr 3 by default) on ``device``."""
    prev, statics, arms, lengths = cohort(device, dtype, B, seed)
    g = torch.as_tensor(BASE, dtype=dtype, device=device)
    return ((LIBRARY, g, prev, statics, arms, lengths, 1 / 6, 10.0),
            dict(projection_horizon=1, gn_iters=12, active_idx=act))


def per_row_call(device, dtype, seed, B=700):
    """A λ tune's shape: B rows, a global model per row (some with a
    smaller support) and a [B] penalty."""
    prev, statics, arms, lengths = cohort(device, dtype, B, seed)
    rng = np.random.RandomState(seed)
    g = BASE[None] * (1 + 0.1 * rng.randn(B, 1, 1))
    g[::4, 1, 1] = 0.0
    lam = torch.as_tensor(np.resize([0.1, 1.0, 10.0, 100.0], B),
                          dtype=torch.float64, device=device)
    return ((LIBRARY, torch.as_tensor(g, dtype=dtype, device=device), prev,
             statics, arms, lengths, 1 / 6, lam),
            dict(projection_horizon=1, gn_iters=12,
                 active_idx=support(g)))


def eager(monkeypatch, call):
    """The fine-tune with no graph: every chain run eagerly."""
    with monkeypatch.context() as m:
        m.setattr(sindy, 'LM_GRAPH_MAX_JACOBIAN', 0)
        return insite_gn_finetune_predict(*call[0], **call[1])


def graphs(device):
    return dict(sindy._LM_GRAPHS.get(device, {}))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', ['northstar', 'per_row'])
def test_replayed_chain_equals_the_eager_loop(cuda, monkeypatch, tmp_path,
                                              dtype, shape):
    """A shape's first call runs eagerly and captures, its later calls
    replay: on a third cohort, preds and coefficients bit-equal to the
    eager loop's on the same tensors, with 1 + gn_iters sensitivity
    launches a call on either path."""
    make = northstar_call if shape == 'northstar' else per_row_call
    calls = [make(cuda, dtype, seed) for seed in (11, 12, 13)]
    ref = eager(monkeypatch, calls[2])
    for call in calls[:2]:
        ops.reset_launch_counts()
        insite_gn_finetune_predict(*call[0], **call[1])
        assert rollout.SENS_LAUNCHES == 13
        assert len(graphs(cuda)) == 1
    ops.reset_launch_counts()
    with profiling.trace(tmp_path):
        preds, coefs = insite_gn_finetune_predict(*calls[2][0], **calls[2][1])
    totals = profiling.totals()
    assert rollout.SENS_LAUNCHES == 13
    assert totals['lm.chains'] == totals['lm.graph_hits'] == 13
    assert 'lm.graph_captures' not in totals
    assert torch.equal(preds, ref[0]) and torch.equal(coefs, ref[1])


@pytest.mark.cuda
def test_a_launch_recorder_sees_every_launch_of_a_replayed_call(cuda,
                                                                monkeypatch):
    """A wrap of `_sens_cuda` shaped like the benchmark's recorder
    (trailing arguments as ``*rest``, no keywords) sees each of the 13
    launches of a replayed call, with the graph's buffers."""
    call = northstar_call(cuda, torch.float32, 21)
    insite_gn_finetune_predict(*call[0], **call[1])
    (graph,) = graphs(cuda).values()
    launch, seen = rollout._sens_cuda, []

    def sens_rec(library, coefs, y0, statics, arms, dt, active_idx, *rest):
        seen.append(rest)
        return launch(library, coefs, y0, statics, arms, dt, active_idx,
                      *rest)

    monkeypatch.setattr(rollout, '_sens_cuda', sens_rec)
    ops.reset_launch_counts()
    insite_gn_finetune_predict(*call[0], **call[1])
    assert rollout.SENS_LAUNCHES == len(seen) == 13
    assert all(rest[-1][0] is graph.y and rest[-1][1] is graph.s
               for rest in seen)


@pytest.mark.cuda
def test_a_new_support_reuses_the_graph_and_a_new_kr_captures_once(
        cuda, monkeypatch):
    """Another support of the same size replays the graph captured for
    the first (its values reach the chain as inputs); a smaller Kr is
    another shape, captured once into the same arena; a larger Kr grows
    the arena, and the chains laid out in the old one are captured again
    on their next call. Every replay bit-equal to the eager loop."""
    def check(call):
        ref = eager(monkeypatch, call)
        got = insite_gn_finetune_predict(*call[0], **call[1])
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])

    call = northstar_call(cuda, torch.float32, 31, act=(1, 4, 8, 12))
    insite_gn_finetune_predict(*call[0], **call[1])
    (first,) = graphs(cuda).values()
    arena = sindy._LM_ARENAS[(cuda, torch.float32)]
    check(northstar_call(cuda, torch.float32, 32, act=(1, 4, 8, 11)))
    assert list(graphs(cuda).values()) == [first]
    narrower = northstar_call(cuda, torch.float32, 33, act=(1, 4, 12))
    insite_gn_finetune_predict(*narrower[0], **narrower[1])
    assert len(graphs(cuda)) == 2
    check(narrower)
    assert sindy._LM_ARENAS[(cuda, torch.float32)] is arena
    assert sorted(key[5] for key in graphs(cuda)) == [3, 4]
    # the first chain again, over what the second left in the arena
    check(northstar_call(cuda, torch.float32, 34, act=(1, 4, 8, 12)))

    sindy._LM_GRAPHS.clear()
    sindy._LM_ARENAS.clear()
    insite_gn_finetune_predict(*narrower[0], **narrower[1])
    insite_gn_finetune_predict(*call[0], **call[1])
    assert [key[5] for key in graphs(cuda)] == [4]
    check(call)
    insite_gn_finetune_predict(*narrower[0], **narrower[1])
    assert sorted(key[5] for key in graphs(cuda)) == [3, 4]
    check(narrower)


@pytest.mark.cuda
def test_a_jacobian_over_the_bound_runs_eagerly(cuda, monkeypatch, tmp_path):
    """A Jacobian of more than `LM_GRAPH_MAX_JACOBIAN` elements is never
    captured: every chain eager, no hit, as many launches."""
    call = northstar_call(cuda, torch.float32, 41)
    monkeypatch.setattr(sindy, 'LM_GRAPH_MAX_JACOBIAN',
                        10_000 * 58 * 3 - 1)
    ops.reset_launch_counts()
    with profiling.trace(tmp_path):
        for _ in range(3):
            insite_gn_finetune_predict(*call[0], **call[1])
    totals = profiling.totals()
    assert rollout.SENS_LAUNCHES == 3 * 13
    assert totals['lm.chains'] == 3 * 13
    assert 'lm.graph_hits' not in totals and 'lm.graph_captures' not in totals
    assert not graphs(cuda)
