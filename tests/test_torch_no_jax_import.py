"""The port stands alone: no module of insite_tpu_torch imports jax, flax,
optax or the JAX package (importing any insite_tpu module imports jax),
nor pandas, msgpack, PyYAML or matplotlib, which the card machine does not
have. Two exceptions: `yaml`, imported inside the body of
`RunConfig.from_yaml` alone, so only loading a YAML config needs PyYAML,
and `matplotlib`, imported inside the functions of `harness/plots.py`
alone, so only drawing a figure needs it."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent / 'insite_tpu_torch'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'insite_tpu', 'pandas',
             'msgpack', 'yaml', 'matplotlib'}
FILES = sorted(PACKAGE.rglob('*.py'))


# (module, class, function) whose body alone may import yaml
YAML_IMPORTER = ('harness/config.py', 'RunConfig', 'from_yaml')
# the module whose function bodies alone may import matplotlib
MATPLOTLIB_IMPORTER = 'harness/plots.py'


def _roots(node):
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield alias.name.split('.')[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.module.split('.')[0]


def _imported_roots(tree):
    """The top-level package of every import in ``tree``, at any depth."""
    for node in ast.walk(tree):
        yield from _roots(node)


def _yaml_importer(tree):
    """The `RunConfig.from_yaml` function node of config.py."""
    _, cls_name, fn_name = YAML_IMPORTER
    for cls in tree.body:
        if isinstance(cls, ast.ClassDef) and cls.name == cls_name:
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef) and fn.name == fn_name:
                    return fn
    raise AssertionError(f'{cls_name}.{fn_name} not found')


def _function_bodies(tree):
    """Every node inside a function body of ``tree``."""
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            inside |= set(ast.walk(node)) - {node}
    return inside


def _roots_allowed(path, tree):
    """Every imported root of ``path``, with the yaml import of
    `RunConfig.from_yaml` and the matplotlib imports inside the functions
    of `harness/plots.py` left out."""
    rel = str(path.relative_to(PACKAGE))
    if rel == MATPLOTLIB_IMPORTER:
        inside = _function_bodies(tree)
        roots = set()
        for node in ast.walk(tree):
            roots |= {r for r in _roots(node)
                      if not (r == 'matplotlib' and node in inside)}
        return roots
    if rel != YAML_IMPORTER[0]:
        return set(_imported_roots(tree))
    fn = _yaml_importer(tree)
    inner = set(_imported_roots(fn))
    # inside from_yaml: yaml, and nothing else that is forbidden
    assert inner & FORBIDDEN == {'yaml'}, inner
    inside = set(ast.walk(fn))
    outer = set()
    for node in ast.walk(tree):
        if node not in inside:
            outer |= set(_roots(node))
    return outer | (inner - {'yaml'})


def test_package_has_modules():
    assert len(FILES) >= 10


@pytest.mark.parametrize('path', FILES,
                         ids=[str(p.relative_to(PACKAGE)) for p in FILES])
def test_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(_roots_allowed(path, tree) & FORBIDDEN)
    assert not bad, f'{path.relative_to(PACKAGE)} imports {bad}'


@pytest.mark.parametrize('path', FILES,
                         ids=[str(p.relative_to(PACKAGE)) for p in FILES])
def test_no_module_level_yaml_import(path):
    """No module imports yaml or matplotlib where importing the module
    would run it: at module level, or in a class body."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def outside_functions(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            yield child
            yield from outside_functions(child)

    roots = set()
    for node in outside_functions(tree):
        roots |= set(_roots(node))
    assert not roots & {'yaml', 'matplotlib'}


def test_plots_import_matplotlib_inside_functions():
    """The figures need matplotlib, imported where a function draws."""
    tree = ast.parse((PACKAGE / MATPLOTLIB_IMPORTER).read_text())
    inside = _function_bodies(tree)
    found = [node for node in ast.walk(tree)
             if 'matplotlib' in set(_roots(node))]
    assert found and all(node in inside for node in found)


def test_chip_smoke_imports_no_jax():
    path = PACKAGE.parent / 'chip_smoke.py'
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not set(_imported_roots(tree)) & FORBIDDEN


def test_every_neural_model_is_checked():
    """The neural models' modules and the checkpoints' are among the files
    checked above."""
    names = {str(p.relative_to(PACKAGE)) for p in FILES}
    assert {f'models/{m}.py' for m in ('ct', 'crn', 'rmsn', 'gnet',
                                        'edct')} <= names
    assert 'harness/checkpoint.py' in names


def test_vitals_refusal_is_gone():
    """The vitals stream is ported: no module names its old refusal."""
    for path in FILES + [PACKAGE.parent / 'chip_smoke.py']:
        assert 'VITALS_NOT_PORTED' not in path.read_text(), path
