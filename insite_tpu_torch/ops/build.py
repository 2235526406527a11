"""Build the CUDA kernels of this package at first use.

`nvcc` compiles `csrc/*.cu` for sm_90a into one shared library with a plain
C interface, which `ops.rollout`, `ops.qr_reduce` and `ops.tumor_sim` load
with ctypes. The library goes into `insite_tpu_torch/.kernel_build/<hash>/`,
keyed by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is built once per checkout. A missing `nvcc`
or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
SOURCES = (PACKAGE / 'csrc' / 'rollout.cu',
           PACKAGE / 'csrc' / 'qr_reduce.cu',
           PACKAGE / 'csrc' / 'tumor_sim.cu')
BUILD_ROOT = PACKAGE / '.kernel_build'
DEFAULT_NVCC = Path('/usr/local/cuda/bin/nvcc')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError('nvcc not found in $CUDA_HOME/bin, on PATH or in '
                       '/usr/local/cuda/bin: the CUDA kernels cannot be built')


def build_dir() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernels unless this source hash is built already; returns
    the library's path. nvcc's output (with -Xptxas -v: registers, shared
    memory and spills per kernel) is kept beside it in nvcc.log."""
    out_dir = build_dir()
    lib = out_dir / 'libinsite_kernels.so'
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cmd_nvcc = find_nvcc()
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=out_dir)
    os.close(fd)
    proc = subprocess.run([cmd_nvcc, *NVCC_FLAGS, '-o', tmp,
                           *map(str, SOURCES)], capture_output=True,
                          text=True)
    (out_dir / 'nvcc.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed with exit code {proc.returncode}:\n'
                           f'{proc.stderr}')
    # atomic: concurrent builders each write their own temp file
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library()))
