"""The port's two-optimizer trainer against the JAX package's, in float64 on
the CPU: the same CRN encoder network (flax's initial parameters carried
over with `convert.state_dict_from_flax`), the same batch, dropout off and
``batch_size >= n`` (one batch per epoch, so the shuffle changes only the
order of a sum), 3 epochs, with and without the weights' EMA, both balancing
schemes and global-norm clipping; every parameter and every EMA parameter
after the run to rtol 1e-8. The single-optimizer trainer `fit_simple` the
same way, on RMSN's warm-started network, with and without clipping. Then
the pieces: `alpha_at_epoch`,
`_ema_update`, `br_losses`, `masked_mean`, `make_batches`,
`treatment_head_mask`, `_base_optimizer`.

Largest deviation measured after 3 epochs: ~1e-13 (each case prints its
own); the tolerance leaves room for Adam's rounding (PyTorch divides by
sqrt(v) / sqrt(1 - b2^t), optax by sqrt(v / (1 - b2^t)))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.models.crn import CRNSubNetwork as JaxCRNSubNetwork
from insite_tpu.models.nn import training as jt
from insite_tpu.models.rmsn import LSTMOutputNet as JaxLSTMOutputNet
from insite_tpu_torch.convert import state_dict_from_flax
from insite_tpu_torch.models.crn import CRNSubNetwork
from insite_tpu_torch.models.nn import training as tt
from insite_tpu_torch.models.rmsn import LSTMOutputNet

F64 = torch.float64
N, T = 12, 6


def _data(seed=0):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, T + 1, N)
    lengths[0] = 0                   # one all-padding row
    active = (np.arange(T)[None, :] < lengths[:, None])[..., None] * 1.0
    treat = (rng.rand(N, T, 2) < 0.5) * 1.0
    return {'prev_treatments': treat * active,
            'prev_outputs': rng.randn(N, T, 1) * active,
            'static_features': rng.randn(N, 2),
            'current_treatments': treat,
            'outputs': rng.randn(N, T, 1) * active,
            'active_entries': active}


def _jax_net(balancing):
    return JaxCRNSubNetwork(8, 4, 6, 2, 1, 0.0, 1, balancing)


def _port_net(balancing):
    return CRNSubNetwork(8, 4, 6, 2, 1, 2, 0.0, 1, balancing, dtype=F64)


CASES = {'ema, domain confusion': dict(weights_ema=True,
                                       balancing='domain_confusion'),
         'no ema, grad reverse': dict(weights_ema=False,
                                      balancing='grad_reverse'),
         'ema, grad reverse, clipped': dict(weights_ema=True,
                                            balancing='grad_reverse',
                                            max_grad_norm=0.05)}


@pytest.mark.parametrize('case', list(CASES))
def test_trainer_matches_jax(case):
    kw = dict(epochs=3, batch_size=64, learning_rate=0.01, alpha=0.5,
              treatment_mode='multilabel', **CASES[case])
    data = _data()
    net_ref = _jax_net(kw['balancing'])
    params0 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64),
        net_ref.init(jax.random.PRNGKey(0), data)['params'])

    def apply_fn(p, batch, alpha, train, rngs, detach):
        return net_ref.apply({'params': p}, batch, alpha, train, detach,
                             rngs=rngs)

    run = jt.make_br_train_fn(apply_fn, jt.TrainConfig(**kw),
                              jt.treatment_head_mask(params0))
    ref_p, ref_ema = jax.jit(run)(
        params0, {k: jnp.asarray(v) for k, v in data.items()},
        jax.random.PRNGKey(1))

    net = _port_net(kw['balancing'])
    net.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params0), net))
    ema = tt.fit_br_model(
        net, {k: torch.as_tensor(v, dtype=F64) for k, v in data.items()},
        tt.TrainConfig(**kw), torch.Generator().manual_seed(1))

    worst = 0.0
    for what, ours, ref in (
            ('params', dict(net.named_parameters()), ref_p),
            ('ema', ema, ref_ema)):
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref),
                                    net)
        assert set(ours) == set(want)
        for k in want:
            o, w = ours[k].detach().numpy(), want[k].numpy()
            worst = max(worst, float(np.max(np.abs(o - w) /
                                            np.maximum(np.abs(w), 1e-12))))
            np.testing.assert_allclose(o, w, rtol=1e-8, atol=1e-12,
                                       err_msg=f'{what} {k}')
    print(f'{case}: largest relative deviation {worst:.3e}')
    # the run moved every partition
    init = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params0),
                                net)
    for k in ('lstm.weight_ih_l0', 'br_treatment_outcome_head.linear3.bias'):
        assert not torch.allclose(dict(net.named_parameters())[k], init[k])


@pytest.mark.parametrize('rate,update', [('exp', True), ('lin', True),
                                         ('exp', False)])
def test_alpha_at_epoch(rate, update):
    epochs = np.arange(100, dtype=np.float32)
    ours = tt.alpha_at_epoch(torch.as_tensor(epochs), 100, 0.01, rate,
                             update)
    ref = np.asarray(jt.alpha_at_epoch(jnp.asarray(epochs), 100, 0.01, rate,
                                       update))
    assert ours.dtype == torch.float32
    # float32 both: XLA's and PyTorch's exp may part by one rounding
    np.testing.assert_allclose(np.broadcast_to(ours.numpy(), ref.shape),
                               ref, rtol=2 ** -23, atol=0)
    if update:
        assert float(ours[0]) == 0.0


def test_ema_update():
    rng = np.random.RandomState(2)
    ema = [rng.randn(3, 4), rng.randn(5)]
    params = [rng.randn(3, 4), rng.randn(5)]
    ref, count = ({'a': jnp.asarray(ema[0]), 'b': jnp.asarray(ema[1])},
                  jnp.asarray(0.0))
    ours = [torch.as_tensor(e.copy()) for e in ema]
    n = 0
    for _ in range(4):
        ref, count = jt._ema_update(ref, {'a': jnp.asarray(params[0]),
                                          'b': jnp.asarray(params[1])},
                                    count, 0.99)
        n = tt._ema_update(ours, [torch.as_tensor(p) for p in params], n,
                           0.99)
    assert n == int(count) == 4
    for o, r in zip(ours, (ref['a'], ref['b'])):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-15)


@pytest.mark.parametrize('balancing', ['grad_reverse', 'domain_confusion'])
@pytest.mark.parametrize('mode', ['multiclass', 'multilabel'])
def test_br_losses(balancing, mode):
    rng = np.random.RandomState(3)
    data = _data(3)
    tp, op = rng.randn(N, T, 2), rng.randn(N, T, 1)
    ref = jt.br_losses(jnp.asarray(tp), jnp.asarray(op),
                       {k: jnp.asarray(v) for k, v in data.items()}, 0.3,
                       balancing, mode)
    ours = tt.br_losses(torch.as_tensor(tp), torch.as_tensor(op),
                        {k: torch.as_tensor(v) for k, v in data.items()},
                        0.3, balancing, mode)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-13)


def test_masked_mean_of_padding_is_zero():
    x = torch.randn(4, 3, 1, dtype=F64)
    assert float(tt.masked_mean(x, torch.zeros_like(x))) == 0.0
    active = torch.zeros_like(x)
    active[1, :2] = 1
    assert float(tt.masked_mean(x, active)) == pytest.approx(
        float(x[1, :2].mean()))


def test_make_batches_drops_the_last():
    idx = tt.make_batches(torch.Generator().manual_seed(0), 10, 4)
    assert idx.shape == (2, 4)
    assert len(set(idx.flatten().tolist())) == 8
    assert set(idx.flatten().tolist()) <= set(range(10))


def test_treatment_head_mask():
    net = _port_net('domain_confusion')
    mask = tt.treatment_head_mask(net)
    assert sorted(k for k, m in mask.items() if m) == [
        f'br_treatment_outcome_head.linear{i}.{p}' for i in (2, 3)
        for p in ('bias', 'weight')]
    assert len(mask) == len(list(net.parameters()))


@pytest.mark.parametrize('name', ['adam', 'adamw', 'sgd'])
def test_base_optimizer(name):
    """One step of each optimizer against optax's on the same gradient."""
    rng = np.random.RandomState(4)
    p0, g = rng.randn(5), rng.randn(5)
    cfg = dict(learning_rate=0.1, optimizer=name, weight_decay=0.01)
    opt = jt._base_optimizer(jt.TrainConfig(**cfg))
    upd, _ = opt.update(jnp.asarray(g), opt.init(jnp.asarray(p0)),
                        jnp.asarray(p0))
    p = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    tt._step(tt._base_optimizer([p], tt.TrainConfig(**cfg)), [p],
             [torch.as_tensor(g)])
    np.testing.assert_allclose(p.detach().numpy(), p0 + np.asarray(upd),
                               rtol=1e-12)


@pytest.mark.parametrize('clip', [None, 0.05])
def test_fit_simple_matches_jax(clip):
    """The single-optimizer trainer: RMSN's warm-started network (the
    memory adapter in the graph) on a masked MSE, 3 epochs of one batch,
    dropout off, with and without global-norm clipping; every parameter to
    rtol 1e-8."""
    data = _data(5)
    x = np.concatenate([data['prev_treatments'], data['prev_outputs']], -1)
    init = np.random.RandomState(6).randn(N, 4)
    kw = dict(epochs=3, batch_size=64, learning_rate=0.01,
              max_grad_norm=clip)
    ref_net = JaxLSTMOutputNet(5, 1, 0.0, 1, use_memory_adapter=True)
    params0 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64),
        ref_net.init(jax.random.PRNGKey(0), x, init)['params'])

    def ref_loss(p, batch, rngs):
        out, _ = ref_net.apply({'params': p}, batch['x'], batch['init'],
                               True, rngs=rngs)
        return jt.masked_mean((out - batch['outputs']) ** 2,
                              batch['active_entries'])

    arrays = {'x': x, 'init': init, 'outputs': data['outputs'],
              'active_entries': data['active_entries']}
    ref = jt.fit_simple(ref_loss, params0,
                        {k: jnp.asarray(v) for k, v in arrays.items()},
                        jt.TrainConfig(**kw), jax.random.PRNGKey(1))

    net = LSTMOutputNet(3, 5, 1, 0.0, 1, memory_size=4, dtype=F64)
    net.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params0), net))

    def loss(n, batch, gen):
        out, _ = n(batch['x'], batch['init'], gen)
        return tt.masked_mean((out - batch['outputs']) ** 2,
                              batch['active_entries'])

    assert tt.fit_simple(
        net, loss, {k: torch.as_tensor(v, dtype=F64)
                    for k, v in arrays.items()},
        tt.TrainConfig(**kw), torch.Generator().manual_seed(1)) is net
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, ref),
                                net)
    init_sd = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params0), net)
    worst = 0.0
    for k, p in net.named_parameters():
        o, w = p.detach().numpy(), want[k].numpy()
        worst = max(worst, float(np.max(np.abs(o - w) /
                                        np.maximum(np.abs(w), 1e-12))))
        np.testing.assert_allclose(o, w, rtol=1e-8, atol=1e-12, err_msg=k)
        assert not torch.equal(p.detach(), init_sd[k]), f'{k} did not move'
        assert p.grad is None
    print(f'fit_simple clip={clip}: largest relative deviation {worst:.3e}')
