"""The port stands alone: no module of insite_tpu_torch imports jax, flax,
optax or the JAX package (importing any insite_tpu module imports jax),
nor pandas or PyYAML, which the card machine does not have."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent / 'insite_tpu_torch'
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'insite_tpu', 'pandas', 'yaml'}
FILES = sorted(PACKAGE.rglob('*.py'))


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_package_has_modules():
    assert len(FILES) >= 10


@pytest.mark.parametrize('path', FILES,
                         ids=[str(p.relative_to(PACKAGE)) for p in FILES])
def test_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & FORBIDDEN)
    assert not bad, f'{path.relative_to(PACKAGE)} imports {bad}'


def test_chip_smoke_imports_no_jax():
    path = PACKAGE.parent / 'chip_smoke.py'
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not set(_imported_roots(tree)) & FORBIDDEN


def test_every_neural_model_is_checked():
    """The neural models' modules are among the files checked above."""
    names = {str(p.relative_to(PACKAGE)) for p in FILES}
    assert {f'models/{m}.py' for m in ('ct', 'crn', 'rmsn', 'gnet',
                                        'edct')} <= names
