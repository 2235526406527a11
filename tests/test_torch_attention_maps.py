"""Attention maps of CT and of the encoder stage of crn and EDCT, the
port's against the JAX package's on the CPU (`tests/test_baselines.py::
test_edct_attention_maps`, `::test_ct_attention_maps` there).

The networks take flax's parameters in float64
(`convert.state_dict_from_flax`); both packages' `get_attention_maps` run
in float64 (the JAX package's batch helpers are made to build float64
batches). Every map ``[B, heads, Tq, Tk]`` equals the JAX package's within
rtol 1e-10, under the same module path; crn's LSTM encoder has none (the
JAX package's call raises a KeyError there). With vitals, a CT module called
more than once keeps its first call's map, as the JAX package keeps ``[0]``
of what flax sows: the test tells the first call from the later ones. No
map is kept outside the call.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insite_tpu.models.crn as jax_crn
import insite_tpu.models.ct as jax_ct
import insite_tpu.models.edct as jax_edct
from insite_tpu.models.nn.training import TrainConfig as JaxTrainConfig
from insite_tpu_torch.convert import state_dict_from_flax
from insite_tpu_torch.models import crn, ct, edct
from insite_tpu_torch.models.nn.blocks import MultiHeadedAttention

F64 = torch.float64
B, T = 6, 9


@pytest.fixture
def jax_f64_batches(monkeypatch):
    """The JAX package's batch helpers of CT and of the stages, in
    float64."""
    for module in (jax_ct, jax_crn):
        make = module._device_batch

        def f64(data, keys=jax_ct._BATCH_KEYS, dtype=None, make=make):
            return make(data, keys, jnp.float64)

        monkeypatch.setattr(module, '_device_batch', f64)


def _dataset(seed, vitals=False, split=False):
    rng = np.random.RandomState(seed)
    lengths = np.array([T, 7, 4, 1, 8, 6])
    data = {'prev_treatments': rng.rand(B, T, 1).round(),
            'prev_outputs': rng.randn(B, T, 1),
            'static_features': rng.randn(B, 2),
            'current_treatments': rng.rand(B, T, 1).round(),
            'outputs': rng.randn(B, T, 1),
            'active_entries': (np.arange(T)[None, :] < lengths[:, None]
                               )[..., None].astype(np.float64)}
    if vitals:
        data['vitals'] = rng.randn(B, T, 2)
    if split:
        data['future_past_split'] = np.array([5.0, 3.0, 2.0, 1.0, 8.0, 0.0])
    return SimpleNamespace(data=data)


def _f64(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                  params)


def _same_maps(ours, ref, what):
    assert sorted(ours) == sorted(ref), what
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        dev = float(np.max(np.abs(ours[k] - ref[k]) /
                           np.maximum(np.abs(ref[k]), 1e-12)))
        print(f'{what} {k}: largest relative deviation {dev:.3e}')
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-10, atol=1e-12,
                                   err_msg=k)
        np.testing.assert_allclose(ours[k].sum(-1), 1.0, rtol=1e-10)


def _ct_pair(vitals, ds):
    kw = dict(dim_treatments=1, dim_vitals=2 if vitals else 0,
              seq_hidden_units=8, br_size=4, fc_hidden_units=6, num_layer=2,
              max_relative_position=3, treatment_mode='multilabel')
    ref = jax_ct.CausalTransformer(jax_ct.CTConfig(**kw))
    batch = jax_ct._device_batch(ds.data)
    ref.params = _f64(ref.net.init(jax.random.PRNGKey(4), batch)['params'])
    ours = ct.CausalTransformer(ct.CTConfig(**kw), None, device='cpu',
                                dtype=F64)
    ours.net.load_state_dict(state_dict_from_flax(ref.params, ours.net))
    return ref, ours


@pytest.mark.parametrize('vitals', [False, True])
def test_ct_attention_maps_match_jax(jax_f64_batches, vitals):
    ds = _dataset(1, vitals=vitals, split=vitals)
    ref, ours = _ct_pair(vitals, ds)
    maps = ours.get_attention_maps(ds)
    _same_maps(maps, ref.get_attention_maps(ds), f'ct vitals={vitals}')
    for i in range(2):
        for name in ('self_attention_t', 'self_attention_o',
                     'cross_attention_to', 'cross_attention_ot'):
            assert maps[f'block_{i}/{name}'].shape == (B, 2, T, T)
    assert all(m.recorded is None for m in ours.net.modules()
               if isinstance(m, MultiHeadedAttention))


def test_ct_vitals_maps_keep_the_first_call(jax_f64_batches):
    """With vitals, ``self_attention_o``, ``cross_attention_to`` and
    ``cross_attention_ot`` run more than once a block: the map kept is
    the first call's (the outcome stream's own), which differs from the
    vitals stream's later calls."""
    from flax.traverse_util import flatten_dict
    ds = _dataset(2, vitals=True, split=True)
    ref, ours = _ct_pair(True, ds)
    _, state = ref.net.apply({'params': ref.params},
                             jax_ct._device_batch(ds.data), 0.0, False,
                             False, mutable=['intermediates'])
    calls = {'/'.join(p[:-1]): v for p, v in
             flatten_dict(state['intermediates']).items()}
    maps = ours.get_attention_maps(ds)
    for name, n_calls in (('self_attention_o', 2), ('cross_attention_to', 3),
                          ('cross_attention_ot', 3)):
        key = f'block_0/{name}'
        assert len(calls[key]) == n_calls, key
        np.testing.assert_allclose(maps[key], np.asarray(calls[key][0]),
                                   rtol=1e-10, atol=1e-12)
        for later in calls[key][1:]:
            assert not np.allclose(maps[key], np.asarray(later)), key


@pytest.fixture
def stage_dataset():
    return _dataset(3)


@pytest.mark.parametrize('family', ['edct', 'crn'])
def test_encoder_stage_attention_maps_match_jax(jax_f64_batches,
                                                stage_dataset, family):
    """The encoder stage's maps: one a block for EDCT, none for crn (an
    LSTM)."""
    ds = stage_dataset
    if family == 'edct':
        kw = dict(dim_treatments=1, enc_seq_hidden_units=8, enc_br_size=6,
                  enc_fc_hidden_units=5, num_layer=2, num_heads=2,
                  max_relative_position=3, treatment_mode='multilabel')
        ref_net = jax_edct.EDCTEncoderNetwork(jax_edct.EDCTConfig(**kw))
        keys = jax_edct._ENC_IN
        ours = edct.EDCT(edct.EDCTConfig(**kw),
                         SimpleNamespace(processed_data_encoder=True),
                         device='cpu', dtype=F64)
    else:
        kw = dict(dim_treatments=1, enc_seq_hidden_units=8, enc_br_size=6,
                  enc_fc_hidden_units=5, treatment_mode='multilabel')
        ref_net = jax_crn.CRNSubNetwork(8, 6, 5, 1, 1, 0.2, 1,
                                        'domain_confusion', False)
        keys = jax_crn._ENC_IN
        ours = crn.CRN(crn.CRNConfig(**kw),
                       SimpleNamespace(processed_data_encoder=True),
                       device='cpu', dtype=F64)
    ref = jax_crn._Stage(ref_net, keys, JaxTrainConfig(), 0,
                         input_keys=keys)
    batch = jax_crn._device_batch(ds.data, keys)
    ref.params = _f64(ref_net.init(jax.random.PRNGKey(5), batch)['params'])
    net = ours.encoder.net
    net.load_state_dict(state_dict_from_flax(ref.params, net))
    maps = ours.encoder.get_attention_maps(ds)
    if family == 'edct':
        _same_maps(maps, ref.get_attention_maps(ds), family)
        assert sorted(maps) == ['block_0/self_attention',
                                'block_1/self_attention']
    else:
        # flax makes no 'intermediates' where nothing is sown: the JAX
        # package's call raises where the port's finds no map
        with pytest.raises(KeyError, match='intermediates'):
            ref.get_attention_maps(ds)
        assert maps == {}
