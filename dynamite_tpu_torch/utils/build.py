"""
Builds of the port's native sources (``csrc/``) at first use: one compiler
call per source into ``_build/<hash>/`` (git-ignored), the hash over the
source and the flags.
"""

import hashlib
import os
import shutil
import socket
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')


def find_nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for candidate in (shutil.which('nvcc'),
                      os.path.join(cuda_home, 'bin', 'nvcc')):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       f'the kernels are built from {CSRC}')


def build_shared_library(compiler, flags, source, name):
    """Compile ``source`` with ``compiler *flags -o <lib> source`` into
    ``_build/<hash>/<name>`` unless that file exists already. Returns
    ``{'path', 'seconds', 'log'}``; seconds is 0 when the library was
    already built. A failed build raises with the compiler's output."""
    key = hashlib.sha256(source.read_bytes()
                         + ' '.join(flags).encode()).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    lib = out_dir / name
    log = out_dir / f'{name}.log'
    if lib.exists():
        return {'path': lib, 'seconds': 0.0,
                'log': log.read_text() if log.exists() else ''}
    out_dir.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent process never
    # loads a half-written library; the name carries the host as well as
    # the pid, since processes of two hosts can share a pid and the build
    # directory (a shared filesystem)
    tmp = lib.with_name(f'{lib.stem}.{socket.gethostname()}.{os.getpid()}'
                        f'{lib.suffix}')
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, '-o', str(tmp), str(source)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot run {compiler} to build {source.name}: '
                           f'{e}') from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f'{compiler} failed with exit code '
                           f'{proc.returncode} building {source.name}:\n'
                           f'{proc.stdout}\n{proc.stderr}')
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return {'path': lib, 'seconds': seconds, 'log': proc.stdout + proc.stderr}
