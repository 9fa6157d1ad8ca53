"""
The port's interactive session over every card (``dynamite_tpu_torch/
interactive.py``), on the CPU: gloo ranks stand in for the cards
(``--device cpu --cards 2``), one CPU thread a rank.

* The kernelspec that ``install --prefix`` writes.
* The Jupyter kernel driven through ``jupyter_client``
  (``tests/torch_session_client.py``): tutorial notebook 6 equal, cell by
  cell, to the switch's one-process run (``compare(worlds_differ=True)``);
  rank 0's stream, ``display()`` and result seen once and rank 1's prints
  not at all; completion from rank 0's namespace; a cell that raises on
  rank 1 alone (the reply names rank 1, the namespace is kept: the counts
  of collectives are equal); a cell where rank 1 raises before a
  collective that rank 0 enters (the group is restarted, and the reply
  says so, within GRACE_S + KILL_S and the new group's start); an
  interrupted ``H.dot`` loop followed by a right ``norm()``, and an
  interrupted loop that prints (no half message on the channel), and an
  interrupt inside a step of two collectives (raised once the step is
  through on every rank, or the group restarted); ``!cmd``,
  ``%%bash``, ``%%writefile`` and ``%sx`` run once, every rank getting
  rank 0's outcome; ``input()`` raising; a notebook's JAX setup cell
  raising the switch's ``ImportError``.
* Jupyter's restart and shutdown (the session fixture's teardown) leave
  no engine, and a SIGKILL of the kernel process ends its engines within
  10 s.
* ``switch --console`` with piped standard input: the output, an error
  line that does not end the session, exit code 0 at the end of the input
  and no engine left.
* Each of the port's collectives adds one to ``multihost.collective.posted``
  on every rank (four gloo ranks, each running this file as a script).
* Importing the package and the module imports neither ``ipykernel`` nor
  torch (the front end's rule).

A rank of the last part imports neither JAX nor ``tests/conftest.py``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUTORIAL = os.path.join(REPO, 'examples', 'tutorial')
sys.path.insert(0, REPO)

from tests import torch_session_client as sc  # noqa: E402

CARDS = 2
#: seconds any one wait of a test may take (a kernel message, a console
#: cell), so that a session that stops answering fails its test soon
WAIT_S = 120
#: a random state of Parity(14, 'even') under heisenberg(14), normalized
SETUP = '''\
from dynamite_tpu import config
from dynamite_tpu.models import heisenberg
from dynamite_tpu.subspaces import Parity
from dynamite_tpu.states import State
config.L = 14
H = heisenberg()
sub = Parity('even')
H.add_subspace(sub)
psi = State(state='random', subspace=sub, seed=0)
psi.normalize()
'''


def _switch():
    from dynamite_tpu_torch import switch
    return switch


@pytest.fixture(scope='module')
def session(tmp_path_factory):
    """One kernel over CARDS gloo ranks for this module's cells, started in
    the tutorial's directory."""
    tmp = tmp_path_factory.mktemp('session')
    env = sc.session_env(str(tmp))
    sc.install_spec(tmp / 'prefix', '--cards', CARDS, '--device', 'cpu',
                    env=env)
    client = sc.Client(tmp / 'prefix', TUTORIAL, env, timeout=WAIT_S)
    yield client
    engines = client.engines()
    client.shutdown()
    assert not [p for p in engines if sc.alive(p)]


def test_kernelspec(tmp_path):
    env = sc.session_env(str(tmp_path))
    where = sc.install_spec(tmp_path / 'p', '--cards', 2, '--device', 'cpu',
                            '--name', 'two', env=env)
    assert where == str(tmp_path / 'p' / 'share' / 'jupyter' / 'kernels'
                        / 'two')
    with open(os.path.join(where, 'kernel.json')) as f:
        spec = json.load(f)
    assert spec['argv'] == [sys.executable, '-m',
                            'dynamite_tpu_torch.interactive', 'kernel', '-f',
                            '{connection_file}', '--cards', '2', '--device',
                            'cpu']
    assert spec['interrupt_mode'] == 'signal'
    assert spec['display_name'] == 'dynamite_tpu_torch (2 cards, cpu)'
    assert spec['language'] == 'python'
    assert spec['env']['PYTHONPATH'] == REPO
    where = sc.install_spec(tmp_path / 'p', env=env)
    with open(os.path.join(where, 'kernel.json')) as f:
        spec = json.load(f)
    assert spec['display_name'] == 'dynamite_tpu_torch (every card)'
    assert spec['argv'][-2:] == ['-f', '{connection_file}']


def test_notebook6_through_the_kernel(session, tmp_path):
    from tests.torch_tutorial_reference import compare
    nb = '6-MatrixFree.ipynb'
    path = os.path.join(TUTORIAL, nb)
    got, _ = sc.run_notebook(session, path)
    one = subprocess.run(
        [sys.executable, '-m', 'dynamite_tpu_torch.switch', '--device', 'cpu',
         '--notebook', path], capture_output=True, text=True, timeout=300,
        env=sc.session_env(str(tmp_path)))
    assert one.returncode == 0, one.stderr[-3000:]
    assert 'devices: 2 x cpu' in got  # the substituted cell, over 2 ranks
    assert compare(got, one.stdout, nb, against_jax=False,
                   worlds_differ=True) == []


def test_notebook2_through_the_console(tmp_path):
    """The console client of chip_smoke.py's phase interactive: notebook 2
    (seeded random states) over 2 ranks, equal to one process's run."""
    from tests.torch_tutorial_reference import compare
    nb = '2-States.ipynb'
    path = os.path.join(TUTORIAL, nb)
    env = sc.session_env(str(tmp_path))
    console = sc.Console(['--device', 'cpu', '--cards', str(CARDS)],
                         TUTORIAL, env, timeout=WAIT_S)
    got, _ = sc.run_notebook(console, path)
    engines = console.engines()
    assert console.close() == 0
    assert len(engines) == CARDS and not [p for p in engines
                                          if sc.alive(p)]
    one = subprocess.run(
        [sys.executable, '-m', 'dynamite_tpu_torch.switch', '--device', 'cpu',
         '--notebook', path], capture_output=True, text=True, timeout=300,
        env=env)
    assert one.returncode == 0, one.stderr[-3000:]
    assert compare(got, one.stdout, nb, against_jax=False,
                   worlds_differ=True) == []


def test_rank0_output_seen_once(session):
    out = session.execute(
        'from dynamite_tpu.parallel import multihost\n'
        'import os\n'
        'print("printed by rank", os.environ["RANK"])\n'
        'display({"shown by rank": int(os.environ["RANK"])})\n'
        'x_result = 40 + int(os.environ["RANK"])\n'
        'x_result + 2')
    assert out['reply']['status'] == 'ok'
    kinds = [k for k, _ in out['outputs']]
    assert kinds.count('display_data') == 1
    assert kinds.count('execute_result') == 1
    assert sc.text(out['outputs']) == (
        "printed by rank 0\n{'shown by rank': 0}\n42\n")
    done = session.client.complete('x_resu', reply=True)['content']
    assert done['matches'] == ['x_result']
    seen = session.client.inspect('x_result', reply=True)['content']
    assert seen['found'] and '40' in seen['data']['text/plain']


def test_error_on_rank1_keeps_the_namespace(session):
    out = session.execute('import os\nkept = 7\n'
                          'if os.environ["RANK"] == "1":\n'
                          '    1 / 0\n'
                          'print("rank 0 went on")')
    reply = out['reply']
    assert reply['status'] == 'error'
    assert reply['ename'] == 'ZeroDivisionError'
    tb = sc.traceback_text(reply)
    assert 'rank 1 of 2 raised' in tb
    assert 'restarted' not in tb
    assert sc.text(out['outputs']) == 'rank 0 went on\n'
    assert session.run('print(kept)') == '7\n'


def test_restart_when_rank1_skips_a_collective(session):
    switch = _switch()
    engines = session.engines()
    out = session.execute(
        'from dynamite_tpu.parallel import multihost\n'
        'if multihost.rank() == 1:\n'
        '    raise ValueError("rank 1 leaves early")\n'
        'multihost.barrier("rank 0 waits")\n')
    reply = out['reply']
    assert reply['status'] == 'error' and reply['ename'] == 'ValueError'
    tb = sc.traceback_text(reply)
    assert 'rank 1 of 2 raised' in tb
    assert 'rank 0 did not answer' in tb
    last = tb.splitlines()[-1]
    assert last.startswith('dynamite_tpu_torch session: the 2 ranks were '
                           'restarted')
    assert 'namespace is lost' in last
    start = float(last.split('took ')[1].split(' s')[0])
    assert out['seconds'] - start <= switch.GRACE_S + switch.KILL_S
    assert not [p for p in engines if sc.alive(p)]
    assert session.run('from dynamite_tpu.parallel import multihost\n'
                       'multihost.barrier()\n'
                       'print(multihost.world_size())') == '2\n'


def test_interrupt_an_hdot_loop(session):
    switch = _switch()
    session.run(SETUP)

    def interrupt():
        time.sleep(2)
        interrupt.at = time.perf_counter()
        session.interrupt()
    out = session.execute('while True:\n    phi = H.dot(psi)\n',
                          during=interrupt)
    waited = time.perf_counter() - interrupt.at
    reply = out['reply']
    assert reply['status'] == 'error'
    tb = sc.traceback_text(reply)
    if 'restarted' in tb:
        start = float(tb.splitlines()[-1].split('took ')[1].split(' s')[0])
        assert waited - start <= switch.GRACE_S + switch.KILL_S
        session.run(SETUP)
    else:
        assert reply['ename'] == 'KeyboardInterrupt'
        assert waited <= switch.GRACE_S + switch.KILL_S
    norm = float(session.run('print(psi.norm())'))
    assert abs(norm - 1) < 1e-12
    norm = float(session.run('print(H.dot(psi).norm() > 0, psi.norm())')
                 .split()[1])
    assert abs(norm - 1) < 1e-12


def test_interrupt_a_printing_loop(session):
    """Rank 0's prints travel on the channel: an interrupt in the middle of
    one must not leave half a message there."""
    switch = _switch()

    def interrupt():
        time.sleep(0.5)
        interrupt.at = time.perf_counter()
        session.interrupt()
    out = session.execute('import itertools\n'
                          'for i in itertools.count():\n'
                          '    print(i)\n', during=interrupt)
    assert time.perf_counter() - interrupt.at <= switch.GRACE_S
    reply = out['reply']
    assert reply['status'] == 'error'
    assert reply['ename'] == 'KeyboardInterrupt'
    printed = sc.text(out['outputs']).split()
    assert printed[:3] == ['0', '1', '2'] and len(printed) > 100
    assert session.run('print("alive")') == 'alive\n'


def test_interrupt_inside_a_step_of_two_posts(session):
    """An interrupt that lands inside one counted step, between its two
    posts, is raised only once the step is through: every rank posts both
    (so equal counts mean what the keep rule takes them to), or the group
    is restarted."""
    switch = _switch()
    session.run('import time\n'
                'import torch\n'
                'import torch.distributed as dist\n'
                'from dynamite_tpu.parallel import multihost\n'
                'multihost.barrier()\n'
                'def two_posts():\n'
                '    global posts\n'
                '    t = torch.ones(1)\n'
                '    dist.all_reduce(t)\n'
                '    posts = 1\n'
                '    time.sleep(3)\n'
                '    dist.all_reduce(t)\n'
                '    posts = 2\n'
                'posts = 0\n')

    def interrupt():
        time.sleep(1)
        interrupt.at = time.perf_counter()
        session.interrupt()
    out = session.execute('multihost.collective(two_posts)\n'
                          'print("not reached")', during=interrupt)
    waited = time.perf_counter() - interrupt.at
    reply = out['reply']
    assert reply['status'] == 'error'
    assert 'not reached' not in sc.text(out['outputs'])
    tb = sc.traceback_text(reply)
    if 'restarted' in tb:
        start = float(tb.splitlines()[-1].split('took ')[1].split(' s')[0])
        assert waited - start <= switch.GRACE_S + switch.KILL_S
    else:
        assert reply['ename'] == 'KeyboardInterrupt'
        assert 'raised' not in tb  # on every rank
        done = session.execute('assert posts == 2, posts')
        assert done['reply']['status'] == 'ok', \
            sc.traceback_text(done['reply'])
        assert session.run('multihost.barrier()\nprint("met")') == 'met\n'


def test_shell_commands_run_once(session, tmp_path):
    f = tmp_path / 'f.txt'
    assert session.run(f'!echo x >> {f}\nprint("exit", _exit_code)') == \
        'exit 0\n'
    assert f.read_text() == 'x\n'
    w = tmp_path / 'w.txt'
    session.run(f'%%writefile -a {w}\nwritten\n')
    assert w.read_text() == 'written\n'
    out = session.run(f'%%bash\necho once >> {f}\necho said')
    assert out == 'said\n'
    assert f.read_text() == 'x\nonce\n'
    # every rank gets rank 0's output: a rank that does not raises
    out = session.execute(f'lines = !cat {f}\n'
                          'assert list(lines) == ["x", "once"], lines\n'
                          'got = %sx cat ' + str(f) + '\n'
                          'assert list(got) == ["x", "once"], got\n'
                          'print(len(lines))')
    assert out['reply']['status'] == 'ok', sc.traceback_text(out['reply'])
    assert sc.text(out['outputs']) == '2\n'


def test_input_raises(session):
    out = session.execute('input("name? ")')
    assert out['reply']['status'] == 'error'
    assert 'dynamite_tpu_torch session' in out['reply']['evalue']
    assert 'no standard input' in out['reply']['evalue']


def test_jax_setup_cell_raises(session):
    """The kernel does not rewrite user code: a notebook's JAX setup cell
    raises the switch's ImportError, and the session goes on."""
    from dynamite_tpu_torch import switch
    cell0 = switch.notebook_cells(os.path.join(TUTORIAL,
                                               '6-MatrixFree.ipynb'))[0]
    out = session.execute(cell0)
    reply = out['reply']
    assert reply['status'] == 'error' and reply['ename'] == 'ImportError'
    assert 'imports jax' in reply['evalue']
    assert 'raised' not in sc.traceback_text(reply)  # on every rank
    assert session.run('import dynamite_tpu\nprint(dynamite_tpu.__name__)') \
        == 'dynamite_tpu_torch\n'


def test_restart_and_kill_leave_no_engine(tmp_path):
    """Jupyter's restart ends the old engines, and a SIGKILL of the kernel
    process its engines within 10 s (the session fixture's teardown holds
    Jupyter's shutdown to the same)."""
    env = sc.session_env(str(tmp_path))
    sc.install_spec(tmp_path / 'prefix', '--cards', CARDS, '--device', 'cpu',
                    env=env)
    client = sc.Client(tmp_path / 'prefix', tmp_path, env,
                       timeout=WAIT_S)
    first = client.engines()
    assert len(first) == CARDS
    client.restart()
    engines = client.engines()
    assert len(engines) == CARDS
    assert not [p for p in first if sc.alive(p)]
    try:
        os.kill(client.pid, signal.SIGKILL)
        end = time.monotonic() + 10
        while [p for p in engines if sc.alive(p)] and time.monotonic() < end:
            time.sleep(0.1)
        assert not [p for p in engines if sc.alive(p)]
    finally:
        client.client.stop_channels()
        client.manager.cleanup_resources()


def test_console_with_piped_input(tmp_path):
    env = sc.session_env(str(tmp_path))
    script = '\n'.join([
        'import os',
        f'_ = open(os.path.join({str(tmp_path)!r}, "pid" + os.environ["RANK"]'
        '), "w").write(str(os.getpid()))',
        'x = 6 * 7',
        'x',
        'print("rank", os.environ["RANK"])',
        '1 / 0',
        'for i in range(2):',
        '    print("line", i)',
        '',
        'from dynamite_tpu.parallel import multihost',
        'print("world", multihost.world_size())',
        ''])
    proc = subprocess.run(
        [sys.executable, '-m', 'dynamite_tpu_torch.switch', '--device', 'cpu',
         '--cards', str(CARDS), '--console'], input=script,
        capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == '42\nrank 0\nline 0\nline 1\nworld 2\n'
    assert 'ZeroDivisionError: division by zero' in proc.stderr
    pids = [int((tmp_path / f'pid{r}').read_text()) for r in range(CARDS)]
    assert not [p for p in pids if sc.alive(p)]


def test_imports_of_the_front_end():
    code = ('import sys, dynamite_tpu_torch, dynamite_tpu_torch.interactive; '
            'print(sorted(m for m in ("torch", "ipykernel", "jax") '
            'if m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, env=sc.session_env(REPO),
                         check=True)
    assert out.stdout.strip() == '[]'


# -- each collective adds one to the count on every rank ---------------------

COUNT_WORLD = 4


def _count_rank(out_dir):
    """One rank of the count test: every collective of the port once (the
    state-file walk over pieces), with the count before and after."""
    import numpy as np
    import torch
    from types import SimpleNamespace
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.ops import apply
    from dynamite_tpu_torch.parallel import multihost
    config.device = 'cpu'
    assert 'jax' not in sys.modules
    me, world = multihost.rank(), multihost.world_size()
    count = multihost.collective
    x = torch.full((2, 4), float(me))
    steps = {
        'broadcast_object': lambda: multihost.broadcast_object(me),
        'broadcast_from_host0': lambda: multihost.broadcast_from_host0(
            np.array([me])),
        'allgather_host_values': lambda: multihost.allgather_host_values(
            np.array([me])),
        'barrier': lambda: multihost.barrier('count'),
        'gather_rows': lambda: multihost.gather_rows(x),
        'gather_rows_to_rank0': lambda: multihost.gather_rows(
            x, to_all=False),
        'allreduce_sum_': lambda: multihost.allreduce_sum_(x.clone()),
        'allreduce_max_': lambda: multihost.allreduce_max_(x.clone()),
        'exchange': lambda: apply.exchange(
            x, SimpleNamespace(hi_list=[0, 1]), [torch.empty_like(x)]),
        'all_gather_rows': lambda: apply.all_gather_rows(x),
        'ring_pass': lambda: apply.ring_pass(x),
        # 4 valid rows a rank (dim 16 over 4), pieces of at most 3 rows:
        # 2 pieces a rank, 8 steps on every rank
        'rows_to_rank0': lambda: list(multihost.rows_to_rank0(x, 16, 3)),
    }
    deltas = {}
    for name, step in steps.items():
        before = count.posted
        step()
        deltas[name] = count.posted - before
    with open(os.path.join(out_dir, f'count{me}.json'), 'w') as f:
        json.dump({'world': world, 'deltas': deltas}, f)
    multihost.shutdown()


def test_each_collective_counts_one_on_every_rank(tmp_path):
    port = _switch()._free_port()
    procs = []
    for r in range(COUNT_WORLD):
        env = sc.session_env(str(tmp_path))
        env.update(RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(COUNT_WORLD), MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r}:\n{out[-4000:]}'
    recs = [json.loads((tmp_path / f'count{r}.json').read_text())
            for r in range(COUNT_WORLD)]
    want = {name: 1 for name in recs[0]['deltas']}
    want['rows_to_rank0'] = 8
    for r, rec in enumerate(recs):
        assert rec['world'] == COUNT_WORLD
        assert rec['deltas'] == want, f'rank {r}'


if __name__ == '__main__':
    _count_rank(sys.argv[1])
