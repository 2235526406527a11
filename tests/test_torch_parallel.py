"""The batch mesh (`insite_tpu_torch/parallel`) against the JAX package's
(`insite_tpu/parallel`), on meshes of k CPU devices (k = 2 and 8; the JAX
side runs on the 8 virtual CPU devices of `tests/conftest.py`). Every test
of `tests/test_parallel.py` has its counterpart here, with its tolerance:

- padding, sharding and the row mask: exact;
- the sharded rollout against JAX's sharded rollout, f64: rtol 1e-10;
- the sharded INSITE BFGS fine-tune against JAX's: rtol 1e-8;
- STLSQ by TSQR over the shards against JAX's sharded gram STLSQ: the
  same support, coefficients rtol 1e-6, atol 1e-8;
- the row-chunked fine-tune under a mesh against the unmeshed, unchunked
  one on the degree-4 library: rtol 1e-7, atol 1e-9.

And the seed-sharded neural columns (ct, crn, edct, rmsn, gnet) against
the unsharded ones with dropout 0, f64: rtol 1e-6, atol 1e-9; with dropout
on, a sharded column repeats bit for bit and differs from the unsharded
one only in its draws (its masks come from one generator a block). Each
test prints its largest deviation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insite_tpu.discovery.library import PolynomialLibrary as JaxLibrary
from insite_tpu.discovery.stlsq import stlsq as jax_stlsq
from insite_tpu.models.sindy import batched_rollout as jax_rollout
from insite_tpu.models.sindy import insite_finetune_predict as jax_finetune
from insite_tpu.parallel import batch_mesh as jax_mesh
from insite_tpu.parallel import pad_rows as jax_pad_rows
from insite_tpu.parallel import row_mask as jax_row_mask
from insite_tpu.parallel import shard_rows as jax_shard_rows
from insite_tpu_torch.data.collection import make_collection
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.discovery.stlsq import stlsq_hostsolve
from insite_tpu_torch.harness import vectorized_neural as vn
from insite_tpu_torch.models.sindy import (SINDyConfig, SINDyRegressor,
                                           insite_finetune_predict)
from insite_tpu_torch.ops.rollout import batched_rollout
from insite_tpu_torch.parallel import (batch_mesh, gather_rows, pad_rows,
                                       row_mask, seed_blocks, shard_rows,
                                       unpad_rows)

torch.set_num_threads(1)

F64 = torch.float64
KS = [2, 8]
COEFS = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                  [0, -0.2, 0, 0, 0, -1.0, 0]])
DT = 1.0 / 6.0


@pytest.fixture(scope='module')
def jmesh():
    assert len(jax.devices()) == 8, 'conftest must force 8 CPU devices'
    return jax_mesh()


def cpu_mesh(k):
    return batch_mesh([torch.device('cpu')] * k)


def t64(x, dtype=F64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def test_batch_mesh_needs_a_card_or_devices():
    mesh = cpu_mesh(3)
    assert mesh == (torch.device('cpu'),) * 3
    if torch.cuda.is_available():
        assert batch_mesh() == tuple(torch.device('cuda', i) for i in
                                     range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError, match='needs a CUDA device'):
            batch_mesh()


def test_pad_unpad_roundtrip():
    x = np.arange(10.0).reshape(5, 2)
    padded = pad_rows(t64(x), 8)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jax_pad_rows(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(padded[5].numpy(), x[-1])
    np.testing.assert_array_equal(unpad_rows(padded, 5).numpy(), x)
    same = t64(x)
    assert pad_rows(same, 5) is same


@pytest.mark.parametrize('k', KS)
def test_shard_rows_and_row_mask_match_jax(jmesh, k):
    rng = np.random.RandomState(0)
    tree = (rng.randn(13, 4), rng.randn(13))
    shards, n = shard_rows(tree, cpu_mesh(k))
    assert n == 13 and len(shards) == k
    per = -(-13 // k)
    assert all(a.shape == (per, 4) and b.shape == (per,) for a, b in shards)
    (ja, jb), jn = jax_shard_rows(tuple(map(jnp.asarray, tree)),
                                  jax_mesh(jax.devices()[:k]))
    assert jn == n
    np.testing.assert_array_equal(
        torch.cat([a for a, _ in shards]).numpy(), np.asarray(ja))
    np.testing.assert_array_equal(
        torch.cat([b for _, b in shards]).numpy(), np.asarray(jb))
    masks = row_mask(n, cpu_mesh(k))
    np.testing.assert_array_equal(
        torch.cat(masks).numpy(),
        np.asarray(jax_row_mask(n, jax_mesh(jax.devices()[:k]))))
    gathered = gather_rows(shards, n)
    np.testing.assert_array_equal(gathered[0].numpy(), tree[0])
    np.testing.assert_array_equal(gathered[1].numpy(), tree[1])


def test_seed_blocks_split_evenly():
    assert seed_blocks(4, cpu_mesh(2)) == [(torch.device('cpu'), slice(0, 2)),
                                           (torch.device('cpu'), slice(2, 4))]
    with pytest.raises(ValueError, match='multiple of the mesh size'):
        seed_blocks(5, cpu_mesh(2))


def _max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-300)))


@pytest.mark.parametrize('k', KS)
def test_sharded_rollout_matches_jax(jmesh, k):
    rng = np.random.RandomState(0)
    B, T = 11, 15
    y0 = np.abs(rng.randn(B)) * 10 + 1
    statics = rng.rand(B, 2)
    arms = rng.randint(0, 2, (B, 1)) * np.ones((B, T), np.int32)
    (y0_j, st_j, ar_j), n = jax_shard_rows(
        (jnp.asarray(y0), jnp.asarray(statics), jnp.asarray(arms)), jmesh)
    ref = np.asarray(jax_rollout(JaxLibrary(n_inputs=3),
                                 jnp.asarray(COEFS)[None], y0_j, st_j, ar_j,
                                 DT, joint=False, shared_coefs=True))[:n]
    lib = PolynomialLibrary(n_inputs=3)
    shards, n = shard_rows((t64(y0), t64(statics),
                            torch.as_tensor(arms, dtype=torch.int32)),
                           cpu_mesh(k))
    got = gather_rows([batched_rollout(lib, t64(COEFS)[None], y, s, a, DT)
                       for y, s, a in shards], n)
    print(f'k={k}: sharded rollout, largest relative deviation '
          f'{_max_rel(got, ref):.3e}')
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)


def _finetune_case():
    rng = np.random.RandomState(1)
    B, T = 9, 12
    prev = np.abs(rng.randn(B, T)) * 10 + 1
    statics = rng.rand(B, 2)
    arms = rng.randint(0, 2, (B, 1)) * np.ones((B, T), np.int32)
    return prev, statics, arms, np.full(B, T, np.int32)


@pytest.fixture(scope='module')
def jax_sharded_finetune(jmesh):
    tree, n = jax_shard_rows(tuple(map(jnp.asarray, _finetune_case())),
                             jmesh)
    preds, coefs = jax_finetune(JaxLibrary(n_inputs=3), jnp.asarray(COEFS),
                                *tree, DT, 10.0, projection_horizon=1,
                                bfgs_maxiter=10)
    return np.asarray(preds)[:n], np.asarray(coefs)[:n]


@pytest.mark.parametrize('k', KS)
def test_sharded_insite_finetune_matches_jax(jax_sharded_finetune, k):
    ref_p, ref_c = jax_sharded_finetune
    prev, statics, arms, lengths = _finetune_case()
    lib = PolynomialLibrary(n_inputs=3)
    active = tuple(int(i) for i in np.flatnonzero(np.abs(COEFS) > 1e-3))
    shards, n = shard_rows((t64(prev), t64(statics),
                            torch.as_tensor(arms, dtype=torch.int32),
                            torch.as_tensor(lengths, dtype=torch.int64)),
                           cpu_mesh(k))
    preds, coefs = gather_rows(
        [insite_finetune_predict(lib, t64(COEFS), *shard, DT, 10.0,
                                 projection_horizon=1, bfgs_maxiter=10,
                                 active_idx=active)[:2]
         for shard in shards], n)
    print(f'k={k}: sharded BFGS fine-tune, largest relative deviation '
          f'preds {_max_rel(preds, ref_p):.3e}, coefs '
          f'{_max_rel(coefs[ref_c != 0], ref_c[ref_c != 0]):.3e}')
    np.testing.assert_allclose(coefs.numpy(), ref_c, rtol=1e-8)
    np.testing.assert_allclose(preds.numpy(), ref_p, rtol=1e-8)


@pytest.mark.parametrize('k', KS)
def test_sharded_stlsq_by_tsqr_matches_jax(jmesh, k):
    """Padded rows weigh 0 through the row mask on both sides, so the
    coefficients do not depend on the number of devices even on noisy
    data, where repeated padding rows would bias an unmasked fit."""
    rng = np.random.RandomState(2)
    n_rows = 157          # not a multiple of 2 or 8: padding on both meshes
    X = rng.randn(n_rows, 5)
    c_true = np.array([0.0, 2.0, 0.0, -1.5, 0.0])
    y = X @ c_true + 0.05 * rng.randn(n_rows)
    (X_j, y_j), n = jax_shard_rows((jnp.asarray(X), jnp.asarray(y)), jmesh)
    c_ref, m_ref = jax_stlsq(X_j, y_j, 0.1, 0.01,
                             sample_weight=jax_row_mask(n, jmesh))
    mesh = cpu_mesh(k)
    shards, n = shard_rows((t64(X), t64(y)), mesh)
    c, m = stlsq_hostsolve([a for a, _ in shards], [b for _, b in shards],
                           0.1, 0.01, sample_weight=row_mask(n, mesh, F64))
    nz = np.asarray(c_ref) != 0
    print(f'k={k}: TSQR STLSQ, largest relative deviation '
          f'{_max_rel(c[nz], np.asarray(c_ref)[nz]):.3e}')
    np.testing.assert_array_equal(m, np.asarray(m_ref))
    np.testing.assert_allclose(c, np.asarray(c_ref), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(c, c_true, rtol=0.05, atol=0.02)


@pytest.fixture(scope='module')
def degree4_collection():
    coll = make_collection('EQ_4_A', {'train': 24, 'val': 2, 'test': 2}, 0,
                           coeff=2.0, treatment_mode='multilabel',
                           device='cpu', dtype=F64)
    coll.process_data_multi()
    return coll


def _degree4_rollout(coll, mesh, chunk):
    cfg = SINDyConfig(dataset_name='EQ_4_A', sindy_threshold=0.1,
                      sindy_alpha=0.5, lam=10.0, insite=True,
                      ablation_more_complex_basis_functions=True,
                      finetune_chunk=chunk, gn_iters=4,
                      treatment_mode='multilabel')
    model = SINDyRegressor(cfg, coll, device='cpu', dtype=F64, mesh=mesh)
    model.fit(coll.train_f)
    return model._fine_tuned_rollout(coll.test_cf_one_step, 1)


@pytest.fixture(scope='module')
def degree4_unmeshed(degree4_collection):
    return _degree4_rollout(degree4_collection, None, None)


@pytest.mark.parametrize('k', KS)
def test_mesh_chunked_finetune_matches_unmeshed(degree4_collection,
                                                degree4_unmeshed, k):
    """The chunk rounds up to a multiple of the mesh size, each chunk is
    sharded, and the rows' results are the unmeshed, unchunked ones."""
    got = _degree4_rollout(degree4_collection, cpu_mesh(k), 60)
    ref = degree4_unmeshed
    print(f'k={k}: chunked degree-4 fine-tune under a mesh, largest '
          f'absolute deviation {np.max(np.abs(got - ref)):.3e}')
    assert got.shape == ref.shape and ref.shape[0] > 60
    np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-9)


def test_mesh_global_rollout_and_pallas_on_cpu_shards(degree4_collection):
    """sindy's global rollout sharded equals the unsharded one exactly,
    and 'pallas' on a mesh of CPU devices raises."""
    coll = degree4_collection
    out = []
    for mesh in (None, cpu_mesh(3)):
        cfg = SINDyConfig(dataset_name='EQ_4_A', treatment_mode='multilabel')
        model = SINDyRegressor(cfg, coll, device='cpu', dtype=F64,
                               mesh=mesh).fit(coll.train_f)
        out.append(model.get_predictions(coll.test_cf_one_step))
    np.testing.assert_array_equal(out[1], out[0])
    with pytest.raises(ValueError, match="'pallas'"):
        SINDyRegressor(SINDyConfig(dataset_name='EQ_4_A',
                                   rollout_backend='pallas'),
                       device='cpu', mesh=cpu_mesh(2))


# ---------------------------------------------------------------------------
# seed-sharded neural columns

NO_DROPOUT = {
    'ct': {'dropout_rate': 0.0},
    'crn': {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0},
    'edct': {'enc_dropout_rate': 0.0, 'dec_dropout_rate': 0.0},
    'rmsn': {'prop_treat_dropout': 0.0, 'prop_hist_dropout': 0.0,
             'enc_dropout': 0.0, 'dec_dropout': 0.0},
    'gnet': {'dropout_rate': 0.0},
}
TINY = dict(num_patients={'train': 12, 'val': 2, 'test': 2}, epochs=2,
            max_seq_length=20, dtype=F64)


def _column(method, n_seeds, **kw):
    if method in ('crn', 'edct'):
        return vn.vectorized_enc_dec_sweep(method, 'EQ_4_D', n_seeds=n_seeds,
                                           **TINY, **kw)
    fn = {'ct': vn.vectorized_ct_sweep, 'rmsn': vn.vectorized_rmsn_sweep,
          'gnet': vn.vectorized_gnet_sweep}[method]
    if method == 'gnet':
        kw['mc_samples'] = 2
    return fn('EQ_4_D', n_seeds=n_seeds, **TINY, **kw)


@pytest.mark.parametrize('k', KS)
@pytest.mark.parametrize('method', sorted(NO_DROPOUT))
def test_sharded_neural_column_matches_unsharded(method, k):
    """Each seed block trains its own stacked fit on its device, with the
    column's batch orders: with dropout 0, the unsharded column's rows."""
    ov = NO_DROPOUT[method]
    ref = _column(method, k, device='cpu', model_overrides=ov)
    got = _column(method, k, mesh=cpu_mesh(k), model_overrides=ov)
    assert list(got) == list(ref)
    worst = max(_max_rel(got[key], ref[key]) for key in ref)
    print(f'{method} k={k}: sharded column, largest relative deviation '
          f'{worst:.3e}')
    for key in ref:
        assert got[key].shape == (k,)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-9,
                                   err_msg=key)


def test_sharded_column_with_dropout_repeats():
    """With dropout on, a block draws its masks from its own generator: a
    sharded column repeats bit for bit and differs from the unsharded
    one (a deviation kept on purpose)."""
    first = _column('ct', 2, mesh=cpu_mesh(2))
    again = _column('ct', 2, mesh=cpu_mesh(2))
    ref = _column('ct', 2, device='cpu')
    for key in first:
        assert np.array_equal(first[key], again[key]), key
        assert np.isfinite(first[key]).all()
    assert not np.array_equal(first['encoder_test_rmse_orig'],
                              ref['encoder_test_rmse_orig'])
