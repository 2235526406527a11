"""The port stands alone: no module of insite_tpu_torch imports jax, flax,
optax or the JAX package (importing any insite_tpu module imports jax),
nor pandas or PyYAML, which the card machine does not have. The one
exception is `yaml`, imported inside the body of `RunConfig.from_yaml`
alone, so only loading a YAML config needs PyYAML."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent / 'insite_tpu_torch'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'insite_tpu', 'pandas', 'yaml'}
FILES = sorted(PACKAGE.rglob('*.py'))


# (module, class, function) whose body alone may import yaml
YAML_IMPORTER = ('harness/config.py', 'RunConfig', 'from_yaml')


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


def _roots_allowed(path, tree):
    """Every imported root of ``path``, with the yaml import of
    `RunConfig.from_yaml` left out."""
    if str(path.relative_to(PACKAGE)) != YAML_IMPORTER[0]:
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
    """No module imports yaml where importing the module would run it: at
    module level, or in a class body."""
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
    assert 'yaml' not in roots


def test_chip_smoke_imports_no_jax():
    path = PACKAGE.parent / 'chip_smoke.py'
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not set(_imported_roots(tree)) & FORBIDDEN


def test_every_neural_model_is_checked():
    """The neural models' modules are among the files checked above."""
    names = {str(p.relative_to(PACKAGE)) for p in FILES}
    assert {f'models/{m}.py' for m in ('ct', 'crn', 'rmsn', 'gnet',
                                        'edct')} <= names
