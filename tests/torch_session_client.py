"""
Clients of the port's interactive session (``dynamite_tpu_torch/
interactive.py``): :class:`Client` drives its Jupyter kernel through
``jupyter_client``, as a notebook front end does, and :class:`Console` its
console (``switch --console``) through a pipe, as a user's terminal does.
Used by ``tests/test_torch_interactive.py`` on the CPU and by
``chip_smoke.py``'s phase ``interactive`` on the card (the kernel where
``ipykernel`` and ``jupyter_client`` import, else the console). Not a test (pytest does not collect it);
importing it imports neither JAX, nor torch, nor the JAX package.

:func:`run_notebook` feeds a tutorial notebook's cells to the kernel as
``switch.run_notebook`` runs them (cell 0's lines that are not JAX's, the
cells of ``switch.SUBSTITUTES`` in place of the notebook's), and returns
rank 0's output in the ``--notebook`` mode's form (a ``# cell N`` line
before each cell's output), which ``tests/torch_tutorial_reference.py::
compare`` holds against another run.
"""

import glob
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = 'dynamite_tpu_torch'
ANSI = re.compile(r'\x1b\[[0-9;]*m')


def session_env(tmp, threads='1'):
    """The environment of a kernel under test: the repository on
    ``PYTHONPATH``, Jupyter's and IPython's directories under ``tmp``, no
    launcher's variables, ``threads`` CPU threads a rank."""
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                        'MASTER_PORT', 'LOCAL_WORLD_SIZE', 'GROUP_RANK',
                        'XLA_FLAGS')}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS=threads,
               MKL_NUM_THREADS=threads, OPENBLAS_NUM_THREADS=threads,
               GLOO_SOCKET_IFNAME='lo',
               IPYTHONDIR=os.path.join(tmp, 'ipython'),
               JUPYTER_RUNTIME_DIR=os.path.join(tmp, 'runtime'),
               JUPYTER_DATA_DIR=os.path.join(tmp, 'data'),
               JUPYTER_CONFIG_DIR=os.path.join(tmp, 'config'))
    return env


def install_spec(prefix, *args, env=None):
    """``python -m dynamite_tpu_torch.interactive install --prefix PREFIX
    ARGS``; returns the kernelspec's directory."""
    out = subprocess.run(
        [sys.executable, '-m', f'{NAME}.interactive', 'install', '--prefix',
         str(prefix), *map(str, args)], capture_output=True, text=True,
        env=env, check=True, timeout=120)
    return out.stdout.strip().splitlines()[-1]


def children(pid):
    """The pids of a process's children, from ``/proc``."""
    out = []
    for path in glob.glob(f'/proc/{pid}/task/*/children'):
        try:
            with open(path) as f:
                out += [int(x) for x in f.read().split()]
        except OSError:
            pass
    return out


def alive(pid):
    """Whether a process exists and is not a zombie."""
    try:
        with open(f'/proc/{pid}/stat') as f:
            return f.read().rsplit(')', 1)[1].split()[0] != 'Z'
    except OSError:
        return False


class Client:
    """One kernel of the kernelspec ``name`` installed under ``prefix``,
    started in ``cwd`` with ``env`` (:func:`session_env`), and its
    client."""

    def __init__(self, prefix, cwd, env, name=NAME, timeout=300):
        from jupyter_client import KernelManager
        from jupyter_client.kernelspec import KernelSpecManager
        self.timeout = timeout
        specs = KernelSpecManager(kernel_dirs=[
            os.path.join(str(prefix), 'share', 'jupyter', 'kernels')])
        self.manager = KernelManager(kernel_name=name,
                                     kernel_spec_manager=specs)
        self.cwd, self.env = str(cwd), env
        self.start_s = self._start()

    def _start(self, restart=False):
        t0 = time.perf_counter()
        if restart:
            self.client.stop_channels()
            self.manager.restart_kernel(now=False)
        else:
            self.manager.start_kernel(cwd=self.cwd, env=self.env)
        self.client = self.manager.client()
        self.client.start_channels()
        self.client.wait_for_ready(timeout=self.timeout)
        return time.perf_counter() - t0

    @property
    def pid(self):
        return self.manager.provisioner.process.pid

    def engines(self):
        return children(self.pid)

    def restart(self):
        """Jupyter's restart; returns its seconds."""
        return self._start(restart=True)

    def interrupt(self):
        self.manager.interrupt_kernel()

    def shutdown(self):
        self.client.stop_channels()
        self.manager.shutdown_kernel()

    def close(self):
        """Jupyter's shutdown; returns the kernel process's exit code: 0,
        or -SIGTERM where the kernel had not exited 2.5 s after its reply
        (``jupyter_client`` then ends it; ``ipykernel`` 7.3's base
        ``Kernel`` can block at its exit, its control thread's last flush
        racing the closing of its IOPub thread, a subclass that does
        nothing too). The engines are ended before the reply."""
        proc = self.manager.provisioner.process
        self.shutdown()
        return proc.wait(timeout=self.timeout)

    def execute(self, code, during=None):
        """Run one cell; ``during()`` is called once the request is sent.
        Returns {'outputs': [(msg_type, content), ...], 'reply': the
        execute_reply's content, 'seconds': until the reply}."""
        t0 = time.perf_counter()
        msg_id = self.client.execute(code)
        if during is not None:
            during()
        outputs = []
        while True:
            msg = self.client.get_iopub_msg(timeout=self.timeout)
            if msg['parent_header'].get('msg_id') != msg_id:
                continue
            kind, content = msg['msg_type'], msg['content']
            if kind == 'status':
                if content['execution_state'] == 'idle':
                    break
            elif kind != 'execute_input':
                outputs.append((kind, content))
        while True:
            reply = self.client.get_shell_msg(timeout=self.timeout)
            if reply['parent_header'].get('msg_id') == msg_id:
                break
        return {'outputs': outputs, 'reply': reply['content'],
                'seconds': time.perf_counter() - t0}

    def run(self, code):
        """:meth:`execute`, raising on an error; returns rank 0's text."""
        out = self.execute(code)
        if out['reply']['status'] != 'ok':
            raise RuntimeError(f'cell failed: {code[:200]!r}: '
                               + traceback_text(out['reply']))
        return text(out['outputs'])


class Console:
    """One ``python -m dynamite_tpu_torch.switch ARGS --console`` in
    ``cwd`` with ``env``, fed one cell at a time: each cell goes as one
    statement, ``switch.run_cell`` of its source (so that it runs as the
    ``--notebook`` mode runs a cell, the repr of its last expression
    printed), followed by a marker that rank 0 prints on both streams; what
    the console printed before the marker is the cell's."""

    def __init__(self, args, cwd, env, timeout=900):
        t0 = time.perf_counter()
        self.timeout, self.n = timeout, 0
        self.proc = subprocess.Popen(
            [sys.executable, '-m', 'dynamite_tpu_torch.switch', *args,
             '--console'], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, bufsize=1, cwd=str(cwd),
            env=env)
        self.lines = {'out': queue.Queue(), 'err': queue.Queue()}
        self.stderr = []
        for name, stream in (('out', self.proc.stdout),
                             ('err', self.proc.stderr)):
            threading.Thread(target=self._read, args=(stream, name),
                             daemon=True).start()
        self.execute('', raw=True)
        self.start_s = time.perf_counter() - t0

    def _read(self, stream, name):
        for line in stream:
            self.lines[name].put(line)
        self.lines[name].put(None)

    @property
    def pid(self):
        return self.proc.pid

    def engines(self):
        return children(self.pid)

    def interrupt(self):
        """SIGINT to the console, which sends it to every engine."""
        self.proc.send_signal(signal.SIGINT)

    def _until(self, name, marker, end):
        got = []
        while True:
            line = self.lines[name].get(
                timeout=max(0.01, end - time.monotonic()))
            if line is None:
                raise RuntimeError(f'the console ended (exit code '
                                   f'{self.proc.wait()}): '
                                   + ''.join(self.stderr[-40:]))
            if line == marker + '\n':
                return got
            got.append(line)

    def execute(self, source, during=None, raw=False):
        """Run one cell (``raw``: its lines as typed, one statement each);
        ``during()`` is called once it is sent. Returns {'stdout': rank 0's
        output, 'stderr': the console's error lines (tracebacks, the
        session's notes), 'seconds': until the marker}."""
        self.n += 1
        marker = f'#--- {self.n}'
        # names of their own: a restart of the group empties the namespace
        cell = (source if raw else
                f'__import__("dynamite_tpu_torch.switch").switch.run_cell('
                f'{source!r}, globals(), "<cell {self.n}>")')
        t0 = time.perf_counter()
        self.proc.stdin.write(cell + f'\nprint({marker!r}); print('
                              f'{marker!r}, file=__import__("sys").stderr)\n')
        self.proc.stdin.flush()
        if during is not None:
            during()
        end = time.monotonic() + self.timeout
        out = self._until('out', marker, end)
        seconds = time.perf_counter() - t0
        err = self._until('err', marker, end)
        self.stderr += err
        return {'stdout': ''.join(out), 'stderr': ''.join(err),
                'seconds': seconds}

    def run(self, source):
        """:meth:`execute`, raising on an error; returns rank 0's text."""
        out = self.execute(source)
        if 'Traceback' in out['stderr'] or \
                'dynamite_tpu_torch session:' in out['stderr']:
            raise RuntimeError(f'cell failed: {source[:200]!r}: '
                               + out['stderr'][-4000:])
        return out['stdout']

    def close(self):
        """End of input: the console ends its engines and exits; returns
        its exit code."""
        self.proc.stdin.close()
        return self.proc.wait(timeout=self.timeout)


def text(outputs):
    """Rank 0's text of a cell's outputs: its streams, and the plain text of
    its results and displays, as ``switch.run_cell`` prints them."""
    out = []
    for kind, content in outputs:
        if kind == 'stream':
            out.append(content['text'])
        elif kind in ('execute_result', 'display_data'):
            out.append(content['data'].get('text/plain', '') + '\n')
    return ''.join(out)


def traceback_text(reply):
    return '\n'.join(ANSI.sub('', line) for line in reply.get('traceback', []))


def error_text(out):
    """The error lines of a cell that :meth:`Client.execute` or
    :meth:`Console.execute` ran: the reply's traceback and error name, or
    the console's standard error."""
    if 'reply' in out:
        return traceback_text(out['reply']) + '\n' + out['reply'].get(
            'ename', '')
    return out['stderr']


def run_notebook(client, path):
    """A tutorial notebook through the kernel (see the module docstring);
    returns (rank 0's output text, seconds of each cell). Raises on a
    cell's error."""
    from dynamite_tpu_torch import switch
    cells = switch.notebook_cells(path)
    setup = [line for line in cells[0].splitlines()
             if line.strip() in switch.SETUP_LINES]
    out = ['# cell 0: the JAX setup cell, not run; run instead:\n']
    out += [f'#   {line}\n' for line in setup]
    t0 = time.perf_counter()
    client.run('\n'.join(setup))
    seconds = [time.perf_counter() - t0]
    for i, source in enumerate(cells[1:], 1):
        sub = switch.SUBSTITUTES.get((os.path.basename(path), i))
        out.append(f'# cell {i}\n')
        t0 = time.perf_counter()
        out.append(client.run(sub if sub is not None else source))
        seconds.append(time.perf_counter() - t0)
    return ''.join(out), seconds

