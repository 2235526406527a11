"""The port's public surface against the JAX package's.

(a) Every name a JAX ``__init__.py`` exports imports from the port's
counterpart, under the port's name where it has another. (b) Every public
name a JAX module defines is defined by the port's counterpart module, or
is in `RENAMED` (the port's name must resolve) or in `NOT_PORTED` (with
the reason, as ROADMAP.md's "Do not port" list gives it). (c) and (d): the
names ported for this surface against the JAX package's on the same
inputs. (e) Importing the port stays cheap and free of cycles, in a fresh
interpreter. The JAX side of (a) and (b) is read with `ast`, not imported.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import insite_tpu.harness.runner as jax_runner
import insite_tpu.sim.pkpd as jax_pkpd
from insite_tpu.discovery.stlsq import masked_ridge as jax_masked_ridge
from insite_tpu.models.nn import blocks as jb
from insite_tpu_torch.convert import state_dict_from_flax
from insite_tpu_torch.discovery.stlsq import masked_ridge
from insite_tpu_torch.harness.runner import VECTORIZED_METHODS
from insite_tpu_torch.models.nn.blocks import AbsolutePositionalEncoding
from insite_tpu_torch.sim.pkpd import CfSeqMode, true_dy_dt

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = ROOT / 'insite_tpu'
F64 = torch.float64

# the port's names for exports that the port names otherwise
EXPORT_RENAMES = {'pallas_batched_rollout': 'batched_rollout',
                  'pallas_rollout_with_sens': 'rollout_with_sens',
                  'df_from_log': 'rows_from_log'}

# JAX module -> {JAX name: the port's fully qualified names for it}
RENAMED = {
    'ops/pallas_rollout.py': {
        'pallas_batched_rollout': ('insite_tpu_torch.ops.rollout.'
                                   'batched_rollout',),
        'pallas_rollout_with_sens': ('insite_tpu_torch.ops.rollout.'
                                     'rollout_with_sens',)},
    'models/sindy.py': {
        'insite_gn_finetune_predict_pallas': (
            'insite_tpu_torch.models.sindy.insite_gn_finetune_predict',)},
    # pandas is not on the card machine: the rows come back as dicts
    'harness/results.py': {
        'df_from_log': ('insite_tpu_torch.harness.results.rows_from_log',)},
    'core/dtypes.py': {
        'default_float': ('insite_tpu_torch.core.dtypes.resolve_float',)},
    'models/gnet.py': {
        'make_rollout_fn': ('insite_tpu_torch.models.gnet.mc_rollout',)},
    # the jitted training-loop factories are the port's eager fits, per
    # model and seed-stacked
    'models/nn/training.py': {
        'make_br_train_fn': ('insite_tpu_torch.models.nn.training.'
                             'fit_br_model',
                             'insite_tpu_torch.models.nn.training.'
                             'fit_br_column'),
        'make_simple_train_fn': ('insite_tpu_torch.models.nn.training.'
                                 'fit_simple',
                                 'insite_tpu_torch.models.nn.training.'
                                 'fit_simple_column')},
    # flax's dense layer with torch's default init is torch's own layer
    'models/nn/blocks.py': {'TorchDense': ('torch.nn.Linear',)},
}

_TILING = 'the TPU kernel\'s [8, 128] tiling; the CUDA kernels lay out ' \
          'their own launch'
_DEBUG = 'utils/debug.py swaps traced vmap and scan for eager loops; ' \
         'PyTorch already runs eagerly'
_TRACED = 'the traced twin of the weak selection, which the port runs on ' \
          'the host in float64 (weak_sindy_fit_select)'
# JAX module -> {JAX name: why the port has no counterpart}
NOT_PORTED = {
    'ops/pallas_rollout.py': {'BLOCK_B': _TILING, 'LANES': _TILING,
                              'SUBLANES': _TILING},
    'utils/debug.py': {'debug_scan': _DEBUG, 'debug_vmap': _DEBUG,
                       'find_nonfinite': _DEBUG},
    'discovery/wsindy.py': {'weak_stlsq': _TRACED,
                            'weak_select_traced': _TRACED},
}

# the port's counterpart of a JAX module that has another name
PORT_MODULES = {'ops/pallas_rollout.py': 'ops/rollout.py'}


def _tree(rel):
    return ast.parse((JAX_PACKAGE / rel).read_text())


def _exports(rel):
    """The public names a JAX ``__init__.py`` imports, and its
    ``__version__`` if it sets one."""
    names = []
    for node in _tree(rel).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and t.id == '__version__']
    return [n for n in names if not n.startswith('_') or n == '__version__']


def _defined(rel):
    """The public names a JAX module defines at its top level (not the
    ones it imports)."""
    names = []
    for node in _tree(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names += [n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)]
    return [n for n in dict.fromkeys(names) if not n.startswith('_')]


def _module_name(rel):
    """'insite_tpu_torch.a.b' of the file 'a/b.py' or 'a/b/__init__.py'."""
    parts = rel[:-len('.py')].split('/')
    if parts[-1] == '__init__':
        parts = parts[:-1]
    return '.'.join(['insite_tpu_torch'] + parts)


def _resolve(dotted):
    """The object at a fully qualified name: the longest importable module
    prefix, then attributes."""
    parts = dotted.split('.')
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module('.'.join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


INITS = sorted(str(p.relative_to(JAX_PACKAGE))
               for p in JAX_PACKAGE.rglob('__init__.py'))
MODULES = sorted(str(p.relative_to(JAX_PACKAGE))
                 for p in JAX_PACKAGE.rglob('*.py')
                 if p.name != '__init__.py')


# ---------------------------------------------------------------------------
# (a) the exports

@pytest.mark.parametrize('rel', INITS)
def test_jax_exports_import_from_the_port(rel):
    names = _exports(rel)
    port = importlib.import_module(_module_name(rel))
    missing = [n for n in names
               if not hasattr(port, EXPORT_RENAMES.get(n, n))]
    assert not missing, f'{_module_name(rel)} lacks {missing}'
    public = [EXPORT_RENAMES.get(n, n) for n in names if n != '__version__']
    assert set(public) <= set(getattr(port, '__all__', ())), \
        f'{_module_name(rel)}.__all__ lacks ' \
        f'{sorted(set(public) - set(getattr(port, "__all__", ())))}'
    for n in public:
        exec(f'from {_module_name(rel)} import {n}', {})


def test_version_is_the_jax_packages():
    version = [ast.literal_eval(node.value)
               for node in _tree('__init__.py').body
               if isinstance(node, ast.Assign)
               and any(getattr(t, 'id', None) == '__version__'
                       for t in node.targets)]
    import insite_tpu_torch
    assert version == [insite_tpu_torch.__version__] == ['0.1.0']


def test_every_subpackage_is_checked():
    assert len(INITS) == 12 and len(MODULES) == 46


# ---------------------------------------------------------------------------
# (b) the completeness audit

@pytest.mark.parametrize('rel', MODULES)
def test_every_public_name_has_a_counterpart(rel):
    renamed = RENAMED.get(rel, {})
    not_ported = NOT_PORTED.get(rel, {})
    port_rel = PORT_MODULES.get(rel, rel)
    port = (importlib.import_module(_module_name(port_rel))
            if (ROOT / 'insite_tpu_torch' / port_rel).exists() else None)
    for name in _defined(rel):
        if name in not_ported:
            assert port is None or not hasattr(port, name), \
                f'{rel}: {name} is ported; take it out of NOT_PORTED'
        elif name in renamed:
            for dotted in renamed[name]:
                assert _resolve(dotted) is not None, dotted
        else:
            assert port is not None, f'{rel} has no counterpart module'
            assert hasattr(port, name), \
                f'{_module_name(port_rel)} lacks {name} ({rel})'


def test_audit_tables_name_jax_definitions():
    """Each entry of the two tables names a public definition of its JAX
    module, so that neither table goes stale; only the TPU tiling, the
    eager-debug helpers and the traced weak selection stay unported."""
    for table in (RENAMED, NOT_PORTED):
        for rel, names in table.items():
            assert set(names) <= set(_defined(rel)), rel
    assert sorted(n for names in NOT_PORTED.values() for n in names) == [
        'BLOCK_B', 'LANES', 'SUBLANES', 'debug_scan', 'debug_vmap',
        'find_nonfinite', 'weak_select_traced', 'weak_stlsq']


# ---------------------------------------------------------------------------
# (c) masked_ridge against the JAX package's

def _ridge_case(seed, N=40, F=6):
    rng = np.random.RandomState(seed)
    theta = rng.randn(N, F)
    y = theta @ rng.randn(F) + 0.1 * rng.randn(N)
    mask = np.array([True, False, True, True, False, True])
    weight = (rng.rand(N) > 0.25).astype(np.float64)      # padded rows: 0
    return theta, y, mask, weight


@pytest.mark.parametrize('with_mask', [False, True])
@pytest.mark.parametrize('with_weight', [False, True])
def test_masked_ridge_matches_jax_f64(with_mask, with_weight):
    theta, y, mask, weight = _ridge_case(0)
    mask = mask if with_mask else None
    weight = weight if with_weight else None
    alpha = 0.05
    ref = np.asarray(jax_masked_ridge(
        jnp.asarray(theta), jnp.asarray(y), alpha,
        None if mask is None else jnp.asarray(mask),
        None if weight is None else jnp.asarray(weight)))
    ours = masked_ridge(torch.as_tensor(theta), torch.as_tensor(y), alpha,
                        None if mask is None else torch.as_tensor(mask),
                        None if weight is None else torch.as_tensor(weight))
    assert ours.dtype == F64 and ours.shape == (6,)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-10, atol=0)
    if mask is not None:
        assert (ours.numpy()[~mask] == 0).all()


def test_masked_ridge_matches_jax_f32():
    """float32 inputs: the JAX package forms and solves in float32, the
    port in float64, so they agree to float32's precision over the
    gram's conditioning (rtol 1e-4)."""
    theta, y, mask, weight = _ridge_case(1)
    theta, y = theta.astype(np.float32), y.astype(np.float32)
    weight = weight.astype(np.float32)
    ref = np.asarray(jax_masked_ridge(
        jnp.asarray(theta), jnp.asarray(y), 0.05, jnp.asarray(mask),
        jnp.asarray(weight)))
    ours = masked_ridge(torch.as_tensor(theta), torch.as_tensor(y), 0.05,
                        mask, torch.as_tensor(weight))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# (d) the other names ported for the surface

def test_true_dy_dt_matches_jax():
    rng = np.random.RandomState(2)
    y = rng.rand(5, 7)
    treatment = rng.randint(0, 2, (5, 7)).astype(np.float64)
    c0, c1 = rng.rand(5, 1), rng.rand(5, 1)
    ref = np.asarray(jax_pkpd.true_dy_dt(
        jnp.asarray(y), 0.0, jnp.asarray(treatment), jnp.asarray(c0),
        jnp.asarray(c1)))
    ours = true_dy_dt(torch.as_tensor(y), 0.0, torch.as_tensor(treatment),
                      torch.as_tensor(c0), torch.as_tensor(c1))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_cf_seq_mode_and_vectorized_methods_match_jax():
    assert [(m.name, m.value) for m in CfSeqMode] == \
        [(m.name, m.value) for m in jax_pkpd.CfSeqMode]
    assert VECTORIZED_METHODS == jax_runner.VECTORIZED_METHODS


def test_absolute_positional_encoding_fixed_matches_jax():
    """The sinusoid of torch's sin and cos against XLA's: equal but for
    the last bit of some entries (atol 2.3e-16, one float64 ulp at 1)."""
    x = np.zeros((3, 5, 2))
    ref_mod = jb.AbsolutePositionalEncoding(9, 6)
    ref = np.asarray(ref_mod.apply({}, jnp.asarray(x)))
    ours = AbsolutePositionalEncoding(9, 6, dtype=F64)
    state_dict_from_flax({}, ours)          # flax keeps no parameter
    np.testing.assert_allclose(ours(torch.as_tensor(x)).numpy(), ref,
                               rtol=0, atol=2.3e-16)


def test_absolute_positional_encoding_trainable_matches_jax():
    """The flax parameter ``pe`` carried over by `state_dict_from_flax`."""
    x = np.zeros((3, 5, 2))
    ref_mod = jb.AbsolutePositionalEncoding(9, 6, trainable=True)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        ref_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    ref = np.asarray(ref_mod.apply({'params': params}, jnp.asarray(x)))
    ours = AbsolutePositionalEncoding(9, 6, trainable=True, dtype=F64)
    ours.load_state_dict(state_dict_from_flax(params, ours))
    out = ours(torch.as_tensor(x))
    assert out.shape == (3, 5, 6) and out.requires_grad
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-12,
                               atol=0)


# ---------------------------------------------------------------------------
# (e) import cost and cycles, in one fresh interpreter

IMPORTS = '''
import sys
import insite_tpu_torch.convert
import insite_tpu_torch.harness.northstar
assert 'insite_tpu_torch.harness.runner' not in sys.modules
import insite_tpu_torch.ops
from insite_tpu_torch.ops import rollout
assert rollout._kernels.cache_info().currsize == 0
from insite_tpu_torch.models import crn
import insite_tpu_torch.harness as harness
assert 'insite_tpu_torch.harness.runner' not in sys.modules
assert harness.sweep.__module__ == 'insite_tpu_torch.harness.runner'
assert rollout._kernels.cache_info().currsize == 0
assert not {'jax', 'pandas'} & set(sys.modules)
print('imports ok')
'''


def test_imports_are_lazy_and_acyclic():
    """convert (which imports harness.config and the neural blocks) first,
    so a cycle through a subpackage's exports would show; the north star
    and the bench import no runner; importing the kernels' module builds
    and loads no kernel; the exported runner names load it at first
    use."""
    out = subprocess.run([sys.executable, '-c', IMPORTS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == 'imports ok'
