"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one source ``csrc/<name>.cu`` that exports plain C functions
(no PyTorch headers, so a build takes seconds).  It is compiled for
``sm_90a`` into ``build/lib<name>-<hash>.so`` at the root of the checkout at
first use; the hash covers the source and the flags, so an edited source is
rebuilt.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD = os.path.join(os.path.dirname(_PKG), 'build')
KERNELS = ('nei_sum',)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise FileNotFoundError(
            f'nvcc not found on PATH or at {path}; set CUDA_HOME')
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f'{name}.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, f'lib{name}-{digest.hexdigest()[:12]}.so')


def build(names: Sequence[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns, per name built,
    its wall seconds and what ``ptxas -v`` reported (registers, spills,
    shared memory).  Raises if any compile fails."""
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [nvcc(), *NVCC_FLAGS, '-o', tmp, os.path.join(CSRC, f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f'{name}:\n{log}')
            continue
        os.replace(tmp, out)
        report[name] = {'seconds': time.perf_counter() - t0, 'ptxas': log}
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(library_path(name))
        return lib
