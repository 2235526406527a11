"""The port's neural blocks against the JAX package's, in float64 on the CPU,
dropout off: each block is initialised by flax, its parameters are carried
into the port's module with `convert.state_dict_from_flax`, and both
forward passes see the same numpy inputs: the blocks of CT and CRN, then
G-Net's heads and network, attention with a final layer and not causal,
EDCT's encoder and decoder blocks and networks, and RMSN's LSTM with an
output layer and the memory adapter. Then `bce`, `grad_reverse` and the
variational LSTM's dropout masks.

Tolerance: rtol 1e-10 (atol 1e-12 for entries near zero) on every output.
The two packages order some sums differently, and flax's LayerNorm takes the
variance as E[x^2] - E[x]^2 where PyTorch takes two passes: deviations are
~1e-13 (each test prints its largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insite_tpu.models.edct as jax_edct
import insite_tpu.models.gnet as jax_gnet
import insite_tpu.models.rmsn as jax_rmsn
from insite_tpu.models.crn import CRNSubNetwork as JaxCRNSubNetwork
from insite_tpu.models.ct import CTConfig as JaxCTConfig
from insite_tpu.models.ct import CTNetwork as JaxCTNetwork
from insite_tpu.models.nn import blocks as jb
from insite_tpu_torch.convert import state_dict_from_flax
from insite_tpu_torch.models.crn import CRNSubNetwork
from insite_tpu_torch.models.ct import CTConfig, CTNetwork
from insite_tpu_torch.models.edct import (EDCTConfig, EDCTDecoderNetwork,
                                          EDCTEncoderNetwork)
from insite_tpu_torch.models.gnet import GNetConfig, GNetNetwork
from insite_tpu_torch.models.nn import blocks as tb
from insite_tpu_torch.models.rmsn import LSTMOutputNet

F64 = torch.float64
RTOL, ATOL = 1e-10, 1e-12
B, T = 5, 7


def _close(ours, ref, what):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else \
        np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, what
    dev = float(np.max(np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-12)))
    print(f'{what}: largest relative deviation {dev:.3e}')
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL, err_msg=what)


def _f64_params(variables):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  variables['params'])


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(params, module))
    return module


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _active(rng, lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]
            )[..., None].astype(np.float64)


@pytest.mark.parametrize('balancing', ['grad_reverse', 'domain_confusion'])
def test_br_head(balancing):
    rng = np.random.RandomState(0)
    seq = rng.randn(B, T, 6)
    treat = rng.rand(B, T, 3)
    ref_mod = jb.BRTreatmentOutcomeHead(4, 8, 3, 2, balancing)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(0), seq, treat))
    ref = ref_mod.apply({'params': params}, seq, treat, 0.3)
    ours = _port(tb.BRTreatmentOutcomeHead(6, 4, 8, 3, 2, balancing,
                                           dtype=F64), params)(
        _t(seq), _t(treat), 0.3)
    for name, o, r in zip(('treatment', 'outcome', 'br'), ours, ref):
        _close(o, r, f'head {balancing} {name}')


@pytest.mark.parametrize('with_init', [False, True])
def test_variational_lstm(with_init):
    """Two layers, dropout off; ``init_states`` seeds h and c of every
    layer."""
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, 4)
    init = rng.randn(B, 6) if with_init else None
    ref_mod = jb.VariationalLSTM(6, num_layer=2, dropout_rate=0.3)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(1), x, init))
    ref = ref_mod.apply({'params': params}, x, init)
    ours = _port(tb.VariationalLSTM(4, 6, 2, 0.3, dtype=F64), params)(
        _t(x), None if init is None else _t(init))
    _close(ours, ref, f'lstm init={with_init}')


def test_fixed_sin_cos():
    _close(tb.fixed_sin_cos(8, 31, dtype=F64), jb.fixed_sin_cos(8, 31),
           'fixed_sin_cos')


@pytest.mark.parametrize('trainable,cross_attn', [(True, False),
                                                  (True, True),
                                                  (False, False)])
def test_relative_positional_encoding(trainable, cross_attn):
    """Both distance schemes; Tq != Tk and lengths past the clip."""
    ref_mod = jb.RelativePositionalEncoding(3, 4, trainable, cross_attn)
    variables = ref_mod.init(jax.random.PRNGKey(2), 6, 9)
    ours = tb.RelativePositionalEncoding(3, 4, trainable, cross_attn,
                                         dtype=F64)
    if trainable:
        params = _f64_params(variables)
        _port(ours, params)
    else:
        params = {}
    ref = ref_mod.apply({'params': params}, 6, 9)
    _close(ours(6, 9), ref, f'rel PE trainable={trainable} '
                            f'cross={cross_attn}')


@pytest.mark.parametrize('relative', [False, True])
def test_multi_headed_attention(relative):
    """Causal, masked by the keys' active entries (one row masked
    everywhere softmaxes to uniform), with and without shared relative
    tables."""
    rng = np.random.RandomState(3)
    q, kv = rng.randn(B, T, 8), rng.randn(B, T, 8)
    active = _active(rng, [T, 3, 1, 0, 5])
    mask = active[:, None, None, :, 0] * np.ones((1, 1, T, 1))
    rel = [rng.randn(T, T, 4) for _ in range(2)] if relative else [None] * 2
    ref_mod = jb.MultiHeadedAttention(2, 8, 4)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(3), q, kv, kv,
                                      mask))
    ref = ref_mod.apply({'params': params}, q, kv, kv, mask, True, False,
                        *rel)
    ours = _port(tb.MultiHeadedAttention(2, 8, 4, dtype=F64), params)(
        _t(q), _t(kv), _t(kv), _t(active[:, None, None, :, 0]),
        rel_k=None if rel[0] is None else _t(rel[0]),
        rel_v=None if rel[1] is None else _t(rel[1]))
    assert np.isfinite(ours.detach().numpy()).all()
    _close(ours, ref, f'attention relative={relative}')


def test_positionwise_feed_forward():
    x = np.random.RandomState(4).randn(B, T, 8)
    ref_mod = jb.PositionwiseFeedForward(8, 32, 0.1)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(4), x))
    ref = ref_mod.apply({'params': params}, x)
    ours = _port(tb.PositionwiseFeedForward(8, 32, 0.1, dtype=F64),
                 params)(_t(x))
    _close(ours, ref, 'feed forward')


def test_transformer_multi_input_block():
    rng = np.random.RandomState(5)
    x_t, x_o, x_s = rng.randn(B, T, 8), rng.randn(B, T, 8), \
        rng.randn(B, 1, 8)
    active = _active(rng, [T, 4, 2, 6, 1])
    rel_k, rel_v = rng.randn(T, T, 4), rng.randn(T, T, 4)
    ref_mod = jb.TransformerMultiInputBlock(8, 2, 4, 32, 0.1, 0.1, 15)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(5), x_t, x_o, x_s,
                                      active, False, rel_k, rel_v))
    ref = ref_mod.apply({'params': params}, x_t, x_o, x_s, active, False,
                        rel_k, rel_v)
    ours = _port(tb.TransformerMultiInputBlock(8, 2, 4, 32, 0.1, 0.1,
                                               dtype=F64), params)(
        _t(x_t), _t(x_o), _t(x_s), _t(active), None, _t(rel_k), _t(rel_v))
    for name, o, r in zip(('t', 'o'), ours, ref):
        _close(o, r, f'multi-input block stream {name}')


def _batch(rng, n_treat=2, n_static=2, init=None):
    batch = {'prev_treatments': rng.rand(B, T, n_treat),
             'prev_outputs': rng.randn(B, T, 1),
             'static_features': rng.randn(B, n_static),
             'current_treatments': rng.rand(B, T, n_treat),
             'active_entries': _active(rng, [T, 5, 3, 1, 6])}
    if init is not None:
        batch['init_state'] = rng.randn(B, init)
    return batch


def _outputs_close(ours, ref, what):
    for name, o, r in zip(('treatment', 'outcome', 'br'), ours, ref):
        _close(o, r, f'{what} {name}')


@pytest.mark.parametrize('num_layer', [1, 2])
def test_ct_network(num_layer):
    """The CT network, dropout off: one shared k and v table, the blocks
    and the head (gradient of the representation detached or not)."""
    kw = dict(seq_hidden_units=8, br_size=4, fc_hidden_units=6,
              num_layer=num_layer, max_relative_position=3,
              treatment_mode='multilabel')
    batch = _batch(np.random.RandomState(6))
    ref_net = JaxCTNetwork(JaxCTConfig(**kw))
    params = _f64_params(ref_net.init(jax.random.PRNGKey(6), batch))
    ref = ref_net.apply({'params': params}, batch, 0.4)
    net = _port(CTNetwork(CTConfig(**kw), dtype=F64), params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    _outputs_close(net(tbatch, 0.4), ref, f'CT network L={num_layer}')
    _outputs_close(net(tbatch, 0.4, detach_treatment=True), ref,
                   f'CT network L={num_layer} detached')


@pytest.mark.parametrize('stage', ['encoder', 'decoder'])
def test_crn_sub_network(stage):
    """Both CRN sub-networks, dropout off: the encoder from zero states,
    the decoder from ``init_state``."""
    decoder = stage == 'decoder'
    hidden = 6 if decoder else 10
    batch = _batch(np.random.RandomState(7), n_static=1,
                   init=hidden if decoder else None)
    ref_net = JaxCRNSubNetwork(hidden, 3, 5, 2, 1, 0.2, 1,
                               'domain_confusion', decoder)
    params = _f64_params(ref_net.init(jax.random.PRNGKey(7), batch))
    ref = ref_net.apply({'params': params}, batch, 0.2)
    net = _port(CRNSubNetwork(hidden, 3, 5, 2, 1, 1, 0.2, 1,
                              'domain_confusion', decoder, dtype=F64),
                params)
    _outputs_close(net({k: _t(v) for k, v in batch.items()}, 0.2), ref,
                   f'CRN {stage}')


def test_state_dict_from_flax_names_what_is_missing():
    ref_net = jb.PositionwiseFeedForward(8, 32)
    params = _f64_params(ref_net.init(jax.random.PRNGKey(8),
                                      np.zeros((1, 2, 8))))
    del params['LayerNorm_0']
    with pytest.raises(ValueError, match='layer_norm.weight'):
        state_dict_from_flax(params, tb.PositionwiseFeedForward(8, 32))


@pytest.mark.parametrize('mode', ['multiclass', 'multilabel'])
def test_bce(mode):
    rng = np.random.RandomState(9)
    logits, target = rng.randn(B, T, 3) * 3, rng.rand(B, T, 3)
    _close(tb.bce(_t(logits), _t(target), mode),
           jb.bce(jnp.asarray(logits), jnp.asarray(target), mode),
           f'bce {mode}')


def test_grad_reverse():
    """Identity forward; the gradient is -scale * g."""
    rng = np.random.RandomState(10)
    x = _t(rng.randn(B, 3)).requires_grad_()
    g = _t(rng.randn(B, 3))
    y = tb.grad_reverse(x, 0.37)
    assert torch.equal(y, x)
    (y * g).sum().backward()
    assert torch.equal(x.grad, -0.37 * g)


def test_lstm_dropout_masks():
    """With a generator the output of every step is zero on the same units
    (one mask per batch), and the first step's kept units are the
    mask-free output scaled by 1/keep (the carried-state masks enter from
    the second step)."""
    torch.manual_seed(0)
    lstm = tb.VariationalLSTM(3, 16, 1, 0.5, dtype=F64)
    x = _t(np.random.RandomState(11).randn(8, 6, 3))
    plain = lstm(x)
    out = lstm(x, gen=torch.Generator().manual_seed(1))
    zero = out == 0
    assert zero.any() and not zero.all()
    assert torch.equal(zero, zero[:, :1].expand_as(zero))
    assert not (plain == 0).any()
    kept = ~zero[:, 0]
    torch.testing.assert_close(out[:, 0][kept], plain[:, 0][kept] / 0.5,
                               rtol=1e-15, atol=0)
    # the carried masks change the later steps
    assert not torch.allclose(out[:, 1:][~zero[:, 1:]],
                              plain[:, 1:][~zero[:, 1:]] / 0.5)


@pytest.mark.parametrize('comp_sizes', [(1,), (2, 3)])
def test_r_outcome_vitals_head(comp_sizes):
    """G-Net's sequential heads with one and with two components."""
    seq = np.random.RandomState(12).randn(B, T, 6)
    ref_mod = jb.ROutcomeVitalsHead(3, 8, comp_sizes)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(12), seq))
    ref = ref_mod.apply({'params': params}, seq)
    ours = _port(tb.ROutcomeVitalsHead(6, 3, 8, comp_sizes, dtype=F64),
                 params)(_t(seq))
    _close(ours, ref, f'r outcome vitals head {comp_sizes}')


@pytest.mark.parametrize('final_layer,causal', [(True, True),
                                                (False, False),
                                                (True, False)])
def test_attention_final_layer_and_direction(final_layer, causal):
    """A final layer before the residual, and attention that is not causal
    over keys of another length, masked per query and key (one query row
    masked everywhere softmaxes to uniform), with relative tables."""
    rng = np.random.RandomState(13)
    Tk = 9
    q, kv = rng.randn(B, T, 8), rng.randn(B, Tk, 8)
    mask = ((np.arange(Tk)[None, :] < np.array([Tk, 4, 1, 0, 6])[:, None])
            [:, None, :] * _active(rng, [T, 2, 5, 7, 0])[:, :, :1])[:, None]
    rel = [rng.randn(T, Tk, 4) for _ in range(2)]
    ref_mod = jb.MultiHeadedAttention(2, 8, 4, final_layer=final_layer)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(13), q, kv, kv,
                                      mask, causal))
    ref = ref_mod.apply({'params': params}, q, kv, kv, mask, causal, False,
                        *rel)
    ours = _port(tb.MultiHeadedAttention(2, 8, 4, final_layer=final_layer,
                                         causal=causal, dtype=F64), params)(
        _t(q), _t(kv), _t(kv), _t(mask), rel_k=_t(rel[0]),
        rel_v=_t(rel[1]))
    assert np.isfinite(ours.detach().numpy()).all()
    _close(ours, ref, f'attention final={final_layer} causal={causal}')


def test_transformer_encoder_block():
    rng = np.random.RandomState(14)
    x = rng.randn(B, T, 8)
    active = _active(rng, [T, 4, 2, 6, 1])
    rel_k, rel_v = rng.randn(T, T, 4), rng.randn(T, T, 4)
    ref_mod = jb.TransformerEncoderBlock(8, 2, 4, 32, 0.1, 0.1, 15)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(14), x, active,
                                      False, rel_k, rel_v))
    ref = ref_mod.apply({'params': params}, x, active, False, rel_k, rel_v)
    ours = _port(tb.TransformerEncoderBlock(8, 2, 4, 32, 0.1, 0.1,
                                            dtype=F64), params)(
        _t(x), _t(active), None, _t(rel_k), _t(rel_v))
    _close(ours, ref, 'transformer encoder block')


def test_transformer_decoder_block():
    """Causal self-attention, then attention over encoder states of
    another length, not causal, with the cross-distance tables."""
    rng = np.random.RandomState(15)
    Tk = 11
    x, enc = rng.randn(B, T, 8), rng.randn(B, Tk, 8)
    active = _active(rng, [T, 4, 2, 6, 0])
    active_enc = (np.arange(Tk)[None, :] <
                  np.array([3, Tk, 1, 7, 5])[:, None]).astype(np.float64)
    rel = [rng.randn(T, T, 4), rng.randn(T, T, 4), rng.randn(T, Tk, 4),
           rng.randn(T, Tk, 4)]
    ref_mod = jb.TransformerDecoderBlock(8, 2, 4, 32, 0.1, 0.1, 15)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(15), x, enc,
                                      active, active_enc, False, *rel))
    ref = ref_mod.apply({'params': params}, x, enc, active, active_enc,
                        False, *rel)
    ours = _port(tb.TransformerDecoderBlock(8, 2, 4, 32, 0.1, 0.1,
                                            dtype=F64), params)(
        _t(x), _t(enc), _t(active), _t(active_enc), None,
        *[_t(r) for r in rel])
    _close(ours, ref, 'transformer decoder block')


@pytest.mark.parametrize('warm_start', [False, True])
def test_lstm_output_net(warm_start):
    """RMSN's network; the warm start goes through the memory adapter."""
    rng = np.random.RandomState(16)
    x = rng.randn(B, T, 4)
    init = rng.randn(B, 5) if warm_start else None
    ref_mod = jax_rmsn.LSTMOutputNet(6, 2, 0.2, 1,
                                     use_memory_adapter=warm_start)
    params = _f64_params(ref_mod.init(jax.random.PRNGKey(16), x, init))
    ref = ref_mod.apply({'params': params}, x, init)
    ours = _port(LSTMOutputNet(4, 6, 2, 0.2, 1,
                               memory_size=5 if warm_start else None,
                               dtype=F64), params)(
        _t(x), None if init is None else _t(init))
    for name, o, r in zip(('output', 'lstm'), ours, ref):
        _close(o, r, f'lstm output net warm={warm_start} {name}')


@pytest.mark.parametrize('comp_sizes', [None, (1,)])
def test_gnet_network(comp_sizes):
    x = np.random.RandomState(17).randn(B, T, 5)
    kw = dict(dim_treatments=2, dim_static_features=2, dim_outcome=1,
              seq_hidden_units=6, r_size=3, fc_hidden_units=7,
              comp_sizes=comp_sizes)
    ref_net = jax_gnet.GNetNetwork(jax_gnet.GNetConfig(**kw))
    params = _f64_params(ref_net.init(jax.random.PRNGKey(17), x))
    ref = ref_net.apply({'params': params}, x)
    ours = _port(GNetNetwork(GNetConfig(**kw), dtype=F64), params)(_t(x))
    _close(ours, ref, f'G-Net network {comp_sizes}')


def _edct_batch(rng, Tk=None):
    batch = _batch(rng)
    if Tk is not None:
        batch['encoder_r'] = rng.randn(B, Tk, 6)
        batch['active_encoder_r'] = (
            np.arange(Tk)[None, :] <
            np.array([Tk, 3, 1, 0, 8])[:, None]).astype(np.float64)
    return batch


@pytest.mark.parametrize('stage', ['encoder', 'decoder'])
@pytest.mark.parametrize('num_layer', [1, 2])
def test_edct_network(stage, num_layer):
    """Both EDCT networks, dropout off: the decoder's width is the
    encoder's br_size; it attends over ``encoder_r`` of another length
    (gradient of the representation detached or not)."""
    kw = dict(enc_seq_hidden_units=8, enc_br_size=6, enc_fc_hidden_units=5,
              dec_br_size=3, dec_fc_hidden_units=4, num_layer=num_layer,
              num_heads=2, max_relative_position=3,
              treatment_mode='multilabel')
    decoder = stage == 'decoder'
    batch = _edct_batch(np.random.RandomState(18 + num_layer),
                        Tk=10 if decoder else None)
    ref_cls = jax_edct.EDCTDecoderNetwork if decoder else \
        jax_edct.EDCTEncoderNetwork
    ref_net = ref_cls(jax_edct.EDCTConfig(**kw))
    params = _f64_params(ref_net.init(jax.random.PRNGKey(18), batch))
    ref = ref_net.apply({'params': params}, batch, 0.4)
    net_cls = EDCTDecoderNetwork if decoder else EDCTEncoderNetwork
    net = _port(net_cls(EDCTConfig(**kw), dtype=F64), params)
    tbatch = {k: _t(v) for k, v in batch.items()}
    _outputs_close(net(tbatch, 0.4), ref, f'EDCT {stage} L={num_layer}')
    _outputs_close(net(tbatch, 0.4, detach_treatment=True), ref,
                   f'EDCT {stage} L={num_layer} detached')
