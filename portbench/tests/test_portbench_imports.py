"""No module a run loads is JAX or the JAX package (top-level names
compared whole), and the plain reference loads nothing of the port."""

import json
import subprocess
import sys

from portbench.core import guard

from .conftest import ROOT, tiny_root


def test_guard_compares_whole_top_level_names():
    assert guard.loaded_refused(['dynamite_tpu_torch', 'dynamite_tpu_torch.x',
                                 'jaxtyping', 'numpy']) == []
    assert guard.loaded_refused(['dynamite_tpu.ops', 'jax.numpy', 'flax',
                                 'jaxlib.xla']) == ['dynamite_tpu', 'flax',
                                                    'jax', 'jaxlib']


def _modules_after(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    root = tiny_root(tmp_path)
    tops = _modules_after(
        'import sys, json, io; sys.path.insert(0, "."); '
        'from portbench import run; '
        f'rc = run.main(["--workload", "mbl_L24.extremal", "--seed", "3", '
        f'"--seconds", "0.5", "--trace", "1", "--device", "cpu", '
        f'"--root", "{root}"]); assert rc == 0; '
        'print(json.dumps(sorted({m.partition(".")[0] '
        'for m in sys.modules})))')
    assert 'dynamite_tpu_torch' in tops
    assert not set(tops) & set(guard.REFUSED)


def test_the_reference_loads_nothing_of_the_port():
    tops = _modules_after(
        'import sys, json; sys.path.insert(0, "."); '
        'import portbench.reference.full, portbench.reference.sector, '
        'portbench.reference.expm, portbench.reference.lanczos, '
        'portbench.reference.pauli, portbench.hamiltonians.floquet, '
        'portbench.hamiltonians.mbl, portbench.core.roofline; '
        'print(json.dumps(sorted({m.partition(".")[0] '
        'for m in sys.modules})))')
    assert 'dynamite_tpu_torch' not in tops
    assert not set(tops) & set(guard.REFUSED)
