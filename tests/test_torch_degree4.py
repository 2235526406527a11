"""The degree-4 ablation: the grouped sensitivity call that serves more
active coordinates than the kernel takes at once, the fine-tune's default
chunking, and the degree-4 A-SINDy / INSITE estimator against the JAX
package in float64 on the CPU.

Tolerances: a grouped call runs the same recurrence per coordinate, so it
equals the ungrouped one exactly; the estimator's supports and equation
strings (at 6 significant digits) are equal, its coefficients agree to
rtol 1e-6 (measured on this cohort: 7.8e-10 relative at most, 9 active
coordinates; the degree-4 design is ill-conditioned, and the two packages
group its monomials' products differently), A-SINDy RMSEs to rtol 1e-8 and
INSITE RMSEs to rtol 1e-6 (measured: 9.8e-11 at 1 step)."""

import copy
import functools
import re

import numpy as np
import pytest
import torch

from insite_tpu.data.collection import make_collection as jax_make_collection
from insite_tpu.models.sindy import SINDyConfig as JaxConfig
from insite_tpu.models.sindy import SINDyRegressor as JaxRegressor
from insite_tpu_torch import convert
from insite_tpu_torch.data.collection import SUBSETS
from insite_tpu_torch.data.dataset import SeqDataset
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.models import sindy
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor
from insite_tpu_torch.ops import rollout
from test_torch_kernels import (TUMOR_CLIP, active, run_port, tumor_case,
                                wide_support_case)

F64 = dict(device='cpu', dtype=torch.float64)
SIZES = {'train': 60, 'val': 4, 'test': 2}
torch.set_num_threads(1)


@pytest.mark.parametrize('group', [1, 3, 5, 16, 40])
@pytest.mark.parametrize('name', ['degree4', 'tumor_clip'])
def test_grouped_sensitivities_equal_the_ungrouped_call(name, group):
    case, clip = ((wide_support_case(), None) if name == 'degree4'
                  else (tumor_case(B=11, T=9), TUMOR_CLIP))
    act = active(case[1])
    assert len(act) == 16
    calls = []

    def counted(library, coefs, y0, statics, arms, dt, active_idx, substeps,
                y_clip):
        calls.append(len(active_idx))
        return rollout.rollout_with_sens_plain(
            library, coefs, y0, statics, arms, dt, active_idx, substeps,
            y_clip)

    def grouped(library, *args):
        return rollout._sens_in_groups(counted, group, library, *args, act,
                                       rollout.STEPS_FOR_DT, clip)

    y, s = run_port(grouped, case, dtype=torch.float64)
    y_ref, s_ref = run_port(rollout.rollout_with_sens_plain, case, act,
                            dtype=torch.float64, y_clip=clip)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0)
    n_groups = -(-16 // group)
    assert len(calls) == n_groups and sum(calls) == 16
    assert max(calls) <= group


def _rows(ds, n):
    """``ds`` with its rows tiled to n."""
    idx = np.arange(n) % len(ds)
    out = SeqDataset({k: v[idx] for k, v in ds.data.items()},
                     ds.subset_name, ds.norm_const)
    out.scaling_params = ds.scaling_params
    return out


@pytest.mark.parametrize('degree4, chunk, want', [
    (True, None, [2048, 2048, 2048]), (False, None, [4100]),
    (True, 3000, [3000, 3000]), (False, 1025, [1025] * 4)])
def test_fine_tune_chunks(monkeypatch, degree4, chunk, want):
    """The degree-4 library chunks the fine-tune by 2048 rows unless
    ``finetune_chunk`` says otherwise; the last chunk is padded."""
    coll = convert.collection_from_numpy(
        {k: copy.deepcopy(getattr(_jax_collection(), k).data)
         for k in SUBSETS}, _jax_collection().train_scaling_params, 'EQ_4_D',
        projection_horizon=5, treatment_mode='multiclass')
    cfg = SINDyConfig(dataset_name='EQ_4_D', insite=True,
                      ablation_more_complex_basis_functions=degree4,
                      finetune_chunk=chunk)
    model = SINDyRegressor(cfg, coll, **F64).fit(coll.train_f)
    sizes = []

    def fake(library, coefs, prev, statics, arms, lengths, dt, **kw):
        sizes.append(prev.shape[0])
        A, F = coefs.shape
        return prev.clone(), coefs[None].expand(prev.shape[0], A, F)

    monkeypatch.setattr(sindy, 'insite_gn_finetune_predict', fake)
    preds, coefs = model._fine_tune(_rows(coll.test_cf_one_step, 4100), 1)
    assert sizes == want
    assert preds.shape[0] == coefs.shape[0] == 4100


@functools.cache
def _jax_collection():
    return jax_make_collection('EQ_4_D', SIZES, 0, 2.0)


@pytest.mark.parametrize('insite', [False, True], ids=['sindy', 'insite'])
def test_degree4_regressor_matches_jax_f64(insite):
    ref = copy.deepcopy(_jax_collection())
    raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
    ours = convert.collection_from_numpy(
        raw, ref.train_scaling_params, 'EQ_4_D', projection_horizon=5,
        treatment_mode='multiclass')
    cfg = dict(dataset_name='EQ_4_D', insite=insite,
               ablation_more_complex_basis_functions=True)
    out = []
    for model, coll in ((SINDyRegressor(SINDyConfig(**cfg), ours, **F64),
                         ours),
                        (JaxRegressor(JaxConfig(**cfg), ref), ref)):
        model.fit(coll.train_f)
        out.append((np.asarray(model.coefs), model.global_equation_string,
                    model.get_normalised_masked_rmse(
                        coll.test_cf_one_step, one_step_counterfactual=True),
                    np.asarray(model.get_normalised_n_step_rmses(
                        coll.test_cf_treatment_seq)), model))
    (c, eq, one, n_step, model), (c_r, eq_r, one_r, n_step_r, _) = out
    assert model.library == PolynomialLibrary(3, degree=4,
                                              interaction_only=False)
    assert c.shape == (2, 35)
    np.testing.assert_array_equal(c != 0, c_r != 0)
    np.testing.assert_allclose(c, c_r, rtol=1e-6, atol=1e-12)

    def rounded(equation):
        return re.sub(r'\d+\.\d+(e-?\d+)?',
                      lambda m: f'{float(m.group()):.6g}', equation)

    assert rounded(eq) == rounded(eq_r) and '^' in eq
    rtol = 1e-6 if insite else 1e-8
    np.testing.assert_allclose(one, one_r, rtol=rtol)
    np.testing.assert_allclose(n_step, n_step_r, rtol=rtol)

