"""
The tutorial notebooks 1-6 (``examples/tutorial``), unchanged, on the port
on the CPU (``python -m dynamite_tpu_torch.switch --device cpu --notebook
NB``) against the same notebooks on the JAX package
(``tests/torch_tutorial_reference.py``, every cell as written), each in a
subprocess at one thread, compared cell by cell as
``tests/torch_tutorial_reference.py::compare`` states (text equal, numbers
to 1e-10 relative + 1e-9, its tables of what is left out and why). The
JAX package runs on one CPU device: its setup cell only sets a default
device count, and the suite keeps the reference off its 8-device mesh
(ROADMAP.md queue 3).
"""

import os
import subprocess
import sys

import pytest

from dynamite_tpu_torch.switch import SUBSTITUTES

from tests.torch_tutorial_reference import (NOTEBOOKS, REPO, TUTORIAL, cells,
                                            compare)

ENV = dict(os.environ, JAX_PLATFORMS='cpu', XLA_FLAGS='', PYTHONPATH=REPO,
           OMP_NUM_THREADS='1', MKL_NUM_THREADS='1', OPENBLAS_NUM_THREADS='1')


def _start(args):
    return subprocess.Popen([sys.executable] + args, cwd=REPO, env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, timeout=900):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.mark.parametrize('notebook', NOTEBOOKS)
def test_notebook_vs_jax(notebook):
    path = os.path.join(TUTORIAL, notebook)
    port = _start(['-m', 'dynamite_tpu_torch.switch', '--device', 'cpu',
                   '--notebook', path])
    ref = _start([os.path.join(REPO, 'tests', 'torch_tutorial_reference.py'),
                  path])
    got, want = _finish(port), _finish(ref)
    assert compare(got, want, notebook, against_jax=True) == []
    substituted = [i for nb, i in SUBSTITUTES if nb == notebook]
    for i in cells(got):
        marked = f'# cell {i}: substituted' in got
        assert marked is (i in substituted), i


def test_notebook_cell_importing_jax_fails(tmp_path):
    """A cell that imports jax, other than the substituted one, fails the
    run: the switch refuses the import."""
    nb = tmp_path / 'nb.ipynb'
    nb.write_text('{"cells": ['
                  '{"cell_type": "code", "source": ["import jax"]},'
                  '{"cell_type": "code", "source": ["print(1)"]},'
                  '{"cell_type": "code", "source": ["import jax"]}]}')
    proc = _start(['-m', 'dynamite_tpu_torch.switch', '--device', 'cpu',
                   '--notebook', str(nb)])
    out, err = proc.communicate(timeout=300)
    assert proc.returncode != 0 and 'imports jax' in err
    assert cells(out) == {0: [], 1: ['1'], 2: []}
