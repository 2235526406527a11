"""Shared by the whole-row and whole-column parity tests of the neural
baselines: the port's runner (or its vectorized columns) takes its cohorts
from the JAX package, and a JAX fit's initial parameters are recorded to
be loaded into the port's networks. Also the vitals collections of the
real-data tests: a JAX `RealDatasetCollection` with a fabricated vitals
stream and the port's copy of it."""

import copy

import jax
import jax.numpy as jnp
import numpy as np

import insite_tpu.harness.vectorized_neural as jax_vn
import insite_tpu.models.ct as jax_ct
from insite_tpu.data import PkpdDatasetCollection as JaxPkpdCollection
from insite_tpu.data.collection import RealDatasetCollection as JaxReal
from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS, RealDatasetCollection
from insite_tpu_torch.data.dataset import SeqDataset
from insite_tpu_torch.harness import runner
from insite_tpu_torch.harness import vectorized_neural as port_vn

SIZES = dict(train_samples=16, val_samples=2, test_samples=2)
RMSE_KEYS = ['encoder_test_rmse_all', 'encoder_test_rmse_orig',
             'encoder_test_rmse_last'] + [f'decoder_test_rmse_{k}-step'
                                          for k in range(2, 7)]


def hand_over_jax_cohorts(monkeypatch, module=runner):
    """Let ``module`` (the port's runner unless given, or its vectorized
    columns' module) take every cohort from the JAX package (a copy of its
    unprocessed subsets, made in float64)."""
    def make_collection(dataset_name, num_patients, seed, coeff, *, device,
                        dtype=None, **kwargs):
        ref = jax_make_collection(dataset_name, num_patients, seed, coeff,
                                  dtype=jnp.float64, **kwargs)
        raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
        return convert.collection_from_numpy(
            raw, ref.train_scaling_params, dataset_name,
            projection_horizon=ref.projection_horizon,
            treatment_mode=kwargs['treatment_mode'], seed=seed)
    monkeypatch.setattr(module, 'make_collection', make_collection)


def record_initial_params(monkeypatch, module, fit_name, initial,
                          params_arg=1):
    """Wrap ``module.fit_name`` so that each call appends its initial
    parameters (positional argument ``params_arg``, as numpy) to
    ``initial``."""
    fit = getattr(module, fit_name)

    def record(*args, **kwargs):
        initial.append(jax.tree_util.tree_map(np.asarray, args[params_arg]))
        return fit(*args, **kwargs)

    monkeypatch.setattr(module, fit_name, record)


def build_with_initial(monkeypatch, nets_of, initial):
    """Let the port's runner load ``initial`` into the networks
    ``nets_of(model)`` of every model it builds."""
    build = runner._build_model

    def build_from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        nets = nets_of(model)
        assert len(nets) == len(initial)
        for net, params in zip(nets, initial):
            net.load_state_dict(convert.state_dict_from_flax(params, net))
        return model

    monkeypatch.setattr(runner, '_build_model', build_from_jax_init)


def assert_rows_close(ours, ref, keys, what, rtol=1e-4):
    """The port's row has the JAX row's keys in its order, and its RMSEs
    agree to ``rtol``; prints the largest relative deviation."""
    assert list(ours) == list(ref) == keys
    worst = max(abs(ours[k] / ref[k] - 1) for k in RMSE_KEYS)
    print(f'{what}: largest relative RMSE deviation {worst:.3e}')
    for k in RMSE_KEYS:
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, err_msg=k)
    assert runner._plain(ours) == ours


# ---------------------------------------------------------------------------
# vectorized columns


def _per_seed(params, n_seeds):
    return [jax.tree_util.tree_map(lambda a: np.asarray(a[s]), params)
            for s in range(n_seeds)]


def _column_init(init_one, seeds):
    """The stage's initial parameters as the JAX column makes them:
    `_stage_rngs` of the stage's seeds, ``init_one`` vmapped over them;
    one numpy tree a seed."""
    init_rngs, carry_rngs = jax_vn._stage_rngs(list(seeds))
    return _per_seed(jax.vmap(init_one)(init_rngs, carry_rngs), len(seeds))


def record_jax_column_inits(monkeypatch, inits):
    """Wrap the JAX column's stage fits so that each appends its stage's
    initial parameters (one tree a seed) to ``inits``, rebuilt from the
    stage's own network, stacked sample and seeds as the column builds
    them (`_fit_br_stage`: crn and edct; `_fit_simple_column`: rmsn and
    gnet)."""
    fit_br_stage = jax_vn._fit_br_stage
    fit_simple_column = jax_vn._fit_simple_column

    def br_stage(net, stacked_train, tc, seeds, *args, **kwargs):
        sample = jax.tree_util.tree_map(lambda a: a[0, :2], stacked_train)
        inits.append(_column_init(lambda ir, dr: net.init(
            {'params': ir, 'dropout': dr}, sample, 0.0, False,
            False)['params'], seeds))
        return fit_br_stage(net, stacked_train, tc, seeds, *args, **kwargs)

    def simple_column(net, data_list, loss, tc, stage_seeds,
                      mesh=None, has_init_state=False, lstm_style=True):
        stacked, _ = jax_vn._stack_padded(data_list, list(data_list[0]))
        x = stacked['x'][0, :2]
        init = stacked['init_state'][0, :2] if has_init_state else None

        def init_one(ir, dr):
            rngs = {'params': ir, 'dropout': dr}
            if lstm_style:
                return net.init(rngs, x, init, False)['params']
            return net.init(rngs, x, False)['params']

        inits.append(_column_init(init_one, stage_seeds))
        return fit_simple_column(net, data_list, loss, tc,
                                 stage_seeds, mesh, has_init_state,
                                 lstm_style)

    monkeypatch.setattr(jax_vn, '_fit_br_stage', br_stage)
    monkeypatch.setattr(jax_vn, '_fit_simple_column', simple_column)


def jax_ct_column_with_init(monkeypatch, seeds, **kwargs):
    """`vectorized_ct_sweep` of the JAX package and its initial parameters
    (one tree a seed), rebuilt from the column's network and stacked
    training sample with `_stage_rngs` of its seeds, as the column builds
    them."""
    nets, stacks = [], []
    network, stack_padded = jax_ct.CTNetwork, jax_vn._stack_padded

    def ct_network(cfg):
        nets.append(network(cfg))
        return nets[-1]

    def stack(*args, **kw):
        out = stack_padded(*args, **kw)
        stacks.append(out[0])
        return out

    monkeypatch.setattr(jax_ct, 'CTNetwork', ct_network)
    monkeypatch.setattr(jax_vn, '_stack_padded', stack)
    ref = jax_vn.vectorized_ct_sweep(n_seeds=len(seeds),
                                     seed_start=seeds[0], **kwargs)
    sample = jax.tree_util.tree_map(lambda a: a[0, :2], stacks[0])
    init = _column_init(lambda ir, dr: nets[0].init(
        {'params': ir, 'dropout': dr}, sample, 0.0, False, False)['params'],
        seeds)
    return ref, [init]


def port_columns_from_jax_inits(monkeypatch, inits):
    """Let the port's columns start each stage, in order, from the next
    entry of ``inits`` (one flax tree a seed), carried into the stacked
    parameters with `convert.stacked_params_from_flax`."""
    initial_stack = port_vn._initial_stack

    def from_jax(build, seeds, device):
        base, _ = initial_stack(build, seeds, device)
        trees = inits.pop(0)
        assert len(trees) == len(seeds)
        return base, convert.stacked_params_from_flax(trees, base)

    monkeypatch.setattr(port_vn, '_initial_stack', from_jax)


def assert_columns_close(ours, ref, what, rtol=1e-4):
    """The port's column has the JAX column's keys in its order, and every
    seed's RMSEs agree to ``rtol``; prints the largest relative
    deviation."""
    assert list(ours) == list(ref)
    worst = max(float(np.max(np.abs(ours[k] / ref[k] - 1))) for k in ref)
    print(f'{what}: largest relative RMSE deviation {worst:.3e}')
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, err_msg=k)
    return worst


# ---------------------------------------------------------------------------
# vitals collections

DIM_VITALS = 2


def add_vitals(ds, seed):
    """A plausible scaled vitals stream for a processed dataset, as the JAX
    package's tests fabricate it (`tests/test_vitals.py::_add_vitals`): a
    lagged function of the outcome plus noise from ``RandomState(seed)``,
    masked by activity; ``next_vitals`` one step shorter."""
    rng = np.random.RandomState(seed)
    po = ds.data['prev_outputs']                       # [n, T, 1]
    n, T, _ = po.shape
    base = np.concatenate([0.5 * po, -0.25 * po + 0.1], axis=-1)
    vit = (base + 0.05 * rng.randn(n, T, DIM_VITALS)) * \
        ds.data['active_entries']
    ds.data['vitals'] = vit
    ds.data['next_vitals'] = vit[:, 1:]
    return ds


def jax_vitals_collection(num_patients, max_seq_length, seed=0):
    """The JAX package's `RealDatasetCollection` over an EQ_4_D cohort
    (multilabel, gamma 2): its processed train and val sets with vitals,
    and a copy of the val set with other vitals as test_f."""
    coll = JaxPkpdCollection(conf_coeff=2.0, num_patients=num_patients,
                             equation_str='EQ_4_D', seed=seed,
                             max_seq_length=max_seq_length,
                             treatment_mode='multilabel')
    coll.process_data_encoder()
    train_f = add_vitals(coll.train_f, 0)
    val_f = add_vitals(coll.val_f, 1)
    test_f = add_vitals(copy.deepcopy(coll.val_f), 2)
    return JaxReal(train_f, val_f, test_f, projection_horizon=5,
                   treatment_mode='multilabel', seed=seed)


def port_dataset(ds) -> SeqDataset:
    """The port's copy of a processed JAX `SeqDataset`."""
    out = SeqDataset({k: np.array(v) for k, v in ds.data.items()},
                     ds.subset_name, ds.norm_const)
    out.processed = ds.processed
    out.scaling_params = copy.deepcopy(ds.scaling_params)
    return out


def port_real_collection(ref) -> RealDatasetCollection:
    """The port's `RealDatasetCollection` over copies of the unprocessed-
    by-method datasets of the JAX collection ``ref``."""
    return RealDatasetCollection(
        port_dataset(ref.train_f), port_dataset(ref.val_f),
        port_dataset(ref.test_f),
        projection_horizon=ref.projection_horizon,
        treatment_mode=ref.treatment_mode, seed=ref.seed)
