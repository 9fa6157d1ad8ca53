"""
An interactive session of the port over every card of the host: a Jupyter
kernel, and a console, whose cells run on one process per card. The JAX
package's notebook or ``python`` REPL spans every chip of its host in one
process (its default mesh); here each card is a process of its own, and
the session is one process to its user.

    python -m dynamite_tpu_torch.interactive install [--cards N] [--device D] [--name NAME] [--user | --prefix P]
    python -m dynamite_tpu_torch.interactive kernel -f CONNECTION_FILE [--cards N] [--device D]
    python -m dynamite_tpu_torch.switch [--device D] [--cards N] --console

``install`` writes the kernel's kernelspec (``interrupt_mode: signal``);
Jupyter then starts ``kernel`` itself. ``--console`` is a REPL on the
standard library's :mod:`code` module over the same group: it reads a
terminal or piped standard input, one cell per complete statement, and
exits 0 at the end of its input.

The ranks ("engines"). The front end (the kernel process, or the console)
starts N engines, one per card (``--cards``: default every visible card,
1 with ``--device cpu``; ``--device cpu --cards N`` runs N gloo ranks),
each with the environment ``switch.launch`` gives a rank
(``switch.rank_env``, ``switch.start_rank``). Every engine installs the
switch's finder, so ``import dynamite_tpu`` reaches the port, runs its
cells inside ``switch.host_files()`` and joins the process group at the
port's first use (``multihost.join_launch``), as under ``switch --cards``.
Rank 0 is an engine too: no user code runs in the front end, which imports
no torch and holds no CUDA context or process group, so it can always end
or restart the engines. Cells and replies travel on a control channel of
their own (:mod:`multiprocessing.connection`, with an authentication key),
which a wedged NCCL group or a cell that calls ``multihost.shutdown()``
does not touch.

One cell. Every engine runs it in its own namespace: in the kernel through
an IPython ``InteractiveShell`` (magics, ``get_ipython()``), in the
console through ``switch.run_cell``. Rank 0's output is the session's: its
streams as they come, its ``display()`` and its result once. The other
ranks' output goes to log files, whose ends the reply shows when such a
rank fails. ``!cmd``, ``%sx``, ``%%bash``, ``%%sh`` and ``%%writefile`` run
on rank 0 alone, followed by a barrier on the control channel (a notebook
written for one process writes each file once); every rank gets rank 0's
outcome. ``input()`` raises: the session has no standard input.

Outcomes, as ``switch --pytest`` holds its ranks to one run: a cell that
raises on every rank is the ordinary error; one that raises on some ranks
is an error whose reply names those ranks and shows the traceback of the
first to raise.

Agreement after an error or an interrupt. Each engine reports, with every
reply, how many collective steps of the port it has posted
(``multihost.collective.posted``). The ranks and their namespaces are kept
only if every rank answered within ``switch.GRACE_S`` seconds of the first
error (or of the interrupt) and the counts are equal: then no collective
is left posted that a later one would match. (Counts that differ after a
cell that raised nowhere restart the group too: a rank posted a collective
that the others never will.) Otherwise the front end ends
every engine (SIGTERM, SIGKILL after ``switch.KILL_S``) and starts a fresh
group on a new port; the reply says so in one line. The kernel's interrupt
sends SIGINT to every engine. An engine raises it between the port's
collective steps, never inside one, so that the counts are those of the
steps posted whole. A rank blocked in a collective that another rank
never enters is not interrupted; the restart ends it. Collectives
that user code posts itself through ``torch.distributed`` are not counted.
"""

import argparse
import io
import json
import os
import pickle
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener, wait

from . import __version__, switch

PORT = switch.PORT
#: the engines' environment: the front end's channel address and its key
ADDRESS_ENV = 'DYNAMITE_TPU_TORCH_SESSION'
KEY_ENV = 'DYNAMITE_TPU_TORCH_SESSION_KEY'
#: seconds the engines of a new group get to connect to the front end
START_TIMEOUT_S = 300
#: seconds rank 0 gets to answer a completion or inspection request
REQUEST_TIMEOUT_S = 10
#: the cell magics that run on rank 0 alone (``!cmd`` and ``%sx`` too)
RANK0_CELL_MAGICS = ('bash', 'sh', 'writefile')


def count_cards(device=None):
    """The ranks of a session without ``--cards``: 1 on the CPU, else every
    CUDA device this host shows, counted in a short child process, so that
    the front end imports no torch."""
    if switch._on_cpu(device):
        return 1
    out = subprocess.run(
        [sys.executable, '-c',
         'import torch; print(torch.cuda.device_count())'],
        capture_output=True, text=True, timeout=300, check=True)
    return max(1, int(out.stdout.split()[-1]))


def _ranks(ranks):
    ranks = sorted(ranks)
    return ('rank ' if len(ranks) == 1 else 'ranks ') + ', '.join(map(
        str, ranks))


class Group:
    """The front end's side of a session: ``cards`` engines of ``kind``
    'ipython' (the kernel's) or 'plain' (the console's) on ``device``,
    their control channel, and the rules of the module docstring. Imports
    no torch."""

    def __init__(self, cards, device=None, kind='ipython'):
        self.cards, self.device, self.kind = cards, device, kind
        self.procs, self.conns = [], []
        self.logs = tempfile.mkdtemp(prefix='dynamite_session_')
        self.generation = -1
        self.cell = 0
        self.closing = False
        self._interrupted = None
        self._request = 0
        self.start_s = None

    # -- the engines ---------------------------------------------------

    def _log(self, rank, stream):
        return os.path.join(self.logs, f'group{self.generation}',
                            f'rank{rank}.{stream}')

    def start(self):
        """Start a group of engines on a new port and wait until every one
        has connected; raises, with the ends of their logs, if one exits
        first."""
        if self.closing:
            raise RuntimeError('the session is closed')
        t0 = time.monotonic()
        self.generation += 1
        os.makedirs(os.path.dirname(self._log(0, 'out')))
        key = os.urandom(32)
        listener = Listener(('127.0.0.1', 0), authkey=key)
        host, port = listener.address
        env = switch.rank_env(self.cards)
        env.update({ADDRESS_ENV: f'{host}:{port}', KEY_ENV: key.hex()})
        argv = [f'{PORT}.interactive', 'engine', self.kind,
                self.device or '']
        files, self.procs = [], []
        for r in range(self.cards):
            out = err = None
            if r > 0:  # rank 0's streams go on the channel
                out = open(self._log(r, 'out'), 'w')
                err = open(self._log(r, 'err'), 'w')
                files += [out, err]
            self.procs.append(switch.start_rank(
                argv, env, r, out, err, stdin=subprocess.DEVNULL))
        for f in files:
            f.close()
        accepted = queue.Queue()

        def accept():
            for _ in range(self.cards):
                try:
                    accepted.put(listener.accept())
                except (OSError, EOFError):
                    return  # the listener closed, or an engine died
                except Exception:  # noqa: BLE001 - a failed handshake
                    continue
        threading.Thread(target=accept, daemon=True).start()
        conns, pending = [None] * self.cards, []
        try:
            while None in conns:
                while not accepted.empty():
                    pending.append(accepted.get())
                for conn in wait(pending, timeout=0.2):
                    pending.remove(conn)
                    try:
                        _, rank, _pid = conn.recv()  # the engine is ready
                        conns[rank] = conn
                    except (EOFError, OSError):
                        pass  # its process exits: seen below
                dead = [r for r, p in enumerate(self.procs)
                        if p.poll() is not None]
                late = time.monotonic() - t0 > START_TIMEOUT_S
                if dead or late:
                    why = (f'{_ranks(dead)} exited at start' if dead
                           else f'the engines were not ready within '
                                f'{START_TIMEOUT_S} s')
                    raise RuntimeError(f'dynamite_tpu_torch session: {why}'
                                       + self._tails(range(self.cards)))
        except BaseException:
            listener.close()
            self._end()
            raise
        listener.close()
        self.conns = conns
        self.start_s = time.monotonic() - t0

    def _end(self):
        for conn in self.conns:
            conn.close()
        self.conns = []
        switch._end(self.procs)

    def _tails(self, ranks):
        out = ''
        for r in ranks:
            for stream in ('out', 'err'):
                tail = switch._tail(self._log(r, stream), 3000)
                if r > 0 and tail.strip():
                    out += (f'\n--- the end of rank {r}\'s std{stream} '
                            f'({self._log(r, stream)}):\n{tail}')
        return out

    def restart(self):
        """End every engine and start a fresh group."""
        self._end()
        self.start()

    def close(self):
        """End every engine and remove the logs; the session is over."""
        self.closing = True
        for conn in self.conns:
            try:
                conn.send(('close',))
            except OSError:
                pass
        end = time.monotonic() + 2
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass  # _end kills what is left
        self._end()
        shutil.rmtree(self.logs, ignore_errors=True)

    def interrupt(self):
        """SIGINT to every engine (the kernel's interrupt); the running
        cell's outcome then follows the module docstring's rules."""
        self._interrupted = time.monotonic()
        for p in self.procs:
            try:
                os.kill(p.pid, signal.SIGINT)
            except ProcessLookupError:
                pass

    # -- one cell --------------------------------------------------------

    def execute(self, source, on_output, silent=False, store_history=True,
                count=None, user_expressions=None):
        """Run ``source`` on every engine; rank 0's output goes to
        ``on_output(kind, *payload)`` as it comes ('stream' name text,
        'display' data metadata transient update, 'clear' wait, 'result'
        data metadata). Returns the cell's outcome over the group:
        ``status`` ('ok' or 'error'), for an error ``ename``, ``evalue``
        and ``traceback`` (a list of lines), and rank 0's
        ``user_expressions``. SIGINT to this process while it waits
        interrupts the cell (:meth:`interrupt`)."""
        if self.closing:
            return _closed()
        self.cell += 1
        cell = self.cell
        self._interrupted = None
        main = threading.current_thread() is threading.main_thread()
        if main:
            saved = signal.signal(signal.SIGINT,
                                  lambda *_: self.interrupt())
        try:
            for conn in self.conns:
                conn.send(('cell', cell, source, silent, store_history,
                           count, user_expressions or {}))
            replies, dead, order = self._collect(cell, on_output, silent)
        finally:
            if main:
                signal.signal(signal.SIGINT, saved)
        return self._decide(replies, dead, order)

    def _collect(self, cell, on_output, silent):
        """Read the engines' messages of ``cell`` until every rank has
        replied, one has died, or GRACE_S has passed since the first error
        or the interrupt (or since a rank was left waiting at a barrier
        that another rank has left)."""
        n = self.cards
        replies, dead, order, synced = {}, [], [], {}
        deadline = None
        while len(replies) + len(dead) < n and not self.closing:
            now = time.monotonic()
            if self._interrupted is not None and deadline is None:
                deadline = self._interrupted + switch.GRACE_S
            if synced and replies and deadline is None:
                deadline = now + switch.GRACE_S
            if deadline is not None and now >= deadline:
                break
            waiting = [self.conns[r] for r in range(n)
                       if r not in replies and r not in dead]
            try:
                ready = wait(waiting, timeout=0.2)
            except (OSError, ValueError):  # closed by close()
                break
            for conn in ready:
                r = self.conns.index(conn)
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    dead.append(r)
                    deadline = time.monotonic()
                    continue
                kind = msg[0]
                if kind == 'done' and msg[1] == cell:
                    replies[r] = msg[2]
                    if msg[2]['status'] == 'error':
                        order.append(r)
                        if deadline is None:
                            deadline = time.monotonic() + switch.GRACE_S
                elif kind == 'sync' and msg[1] == cell:
                    synced[r] = msg[2]
                    if len(synced) == n:
                        value = synced[0]
                        synced.clear()
                        for c in self.conns:
                            c.send(('sync', cell, value))
                elif r == 0 and not silent and kind in (
                        'stream', 'display', 'clear', 'result'):
                    on_output(kind, *msg[1:])
        return replies, dead, order

    def _decide(self, replies, dead, order):
        n = self.cards
        if self.closing:
            return _closed()
        silent = [r for r in range(n) if r not in replies and r not in dead]
        counts = {r: rep['posted'] for r, rep in replies.items()}
        keep = not dead and not silent and len(set(counts.values())) <= 1
        reply = {'status': 'ok', 'user_expressions': replies.get(0, {}).get(
            'user_expressions', {})}
        notes = []
        if order:
            first = replies[order[0]]
            reply.update(status='error', ename=first['ename'],
                         evalue=first['evalue'],
                         traceback=list(first['traceback']))
            if len(order) < n:
                notes.append(f'dynamite_tpu_torch session: {_ranks(order)} '
                             f'of {n} raised; the traceback is rank '
                             f'{order[0]}\'s')
        if dead:
            notes.append(f'dynamite_tpu_torch session: {_ranks(dead)} '
                         f'exited' + self._tails(dead))
        if silent:
            notes.append(f'dynamite_tpu_torch session: {_ranks(silent)} did '
                         f'not answer within {switch.GRACE_S} s'
                         + self._tails(silent))
        if not dead and not silent and not keep:
            notes.append('dynamite_tpu_torch session: the ranks posted '
                         'different numbers of collectives: ' + ', '.join(
                             f'rank {r} {c}' for r, c in sorted(
                                 counts.items())))
        if keep:
            reply['traceback'] = notes + reply.get('traceback', [])
            return reply
        self.restart()
        restarted = (f'dynamite_tpu_torch session: the {n} ranks were '
                     f'restarted (the new group took {self.start_s:.1f} s '
                     f'to start); their namespace is lost')
        if reply['status'] == 'ok':
            reply.update(status='error', ename='SessionRestarted',
                         evalue=restarted, traceback=[])
        reply['traceback'] = notes + reply['traceback'] + [restarted]
        return reply

    def request(self, what, *args):
        """Ask rank 0 alone (completion, inspection); None when it does not
        answer within REQUEST_TIMEOUT_S."""
        self._request += 1
        rid = self._request
        conn = self.conns[0]
        conn.send(('request', rid, what, args))
        end = time.monotonic() + REQUEST_TIMEOUT_S
        while conn.poll(max(0.0, end - time.monotonic())):
            msg = conn.recv()
            if msg[0] == 'reply' and msg[1] == rid:
                return msg[2]
        return None


def _closed():
    return {'status': 'error', 'ename': 'RuntimeError',
            'evalue': 'the session is closed', 'traceback': []}


# -- the engines -----------------------------------------------------------


class _Channel(io.TextIOBase):
    """Rank 0's ``sys.stdout`` or ``sys.stderr``: what is written goes on
    the control channel, a line (or 8 KiB) at a time."""

    def __init__(self, engine, name):
        self.engine, self.name, self.parts = engine, name, []

    def writable(self):
        return True

    @property
    def encoding(self):
        return 'utf-8'

    def write(self, text):
        self.parts.append(text)
        if '\n' in text or sum(map(len, self.parts)) > 8192:
            self.flush()
        return len(text)

    def flush(self):
        text, self.parts = ''.join(self.parts), []
        if text:
            self.engine.send(('stream', self.name, text))


def _no_input(prompt=''):
    raise RuntimeError(
        'input(): a dynamite_tpu_torch session (one process per card, '
        'python -m dynamite_tpu_torch.interactive) has no standard input')


class Engine:
    """One rank of a session: reads cells from the channel ``conn`` and
    runs them (see the module docstring)."""

    def __init__(self, conn, rank, kind, device):
        self.conn, self.rank, self.kind = conn, rank, kind
        self.lock = threading.Lock()
        self.cell = None
        self.running = self.in_sync = self.sending = self.pending = False
        self.error = None
        switch.install(device or None)
        import builtins
        builtins.input = _no_input
        if rank == 0:
            sys.stdout = _Channel(self, 'stdout')
            sys.stderr = _Channel(self, 'stderr')
        if kind == 'ipython':
            self.shell = _ipython_shell(self)
        else:
            self.namespace = {'__name__': '__main__'}
        signal.signal(signal.SIGINT, self._on_sigint)

    def _on_sigint(self, signum, frame):
        """SIGINT while a cell runs: KeyboardInterrupt, but not in the
        middle of a message on the channel (half a message would leave the
        front end waiting for the rest), of a barrier (the ranks would
        part there) or of a collective step of the port (a step half
        posted would be counted whole): those raise it once they are
        through."""
        if self.running:
            mh = self._multihost()
            if self.in_sync or self.sending:
                self.pending = True
            elif mh is not None and mh.collective.depth:
                mh.collective.held = True
            else:
                raise KeyboardInterrupt

    def _raise_pending(self):
        if self.pending and self.running:
            self.pending = False
            raise KeyboardInterrupt

    def send(self, msg):
        main = threading.current_thread() is threading.main_thread()
        with self.lock:
            self.sending = main  # the handler runs in the main thread
            try:
                self.conn.send(msg)
            finally:
                self.sending = False
        if main and not self.in_sync:
            self._raise_pending()

    def flush(self):
        for stream in (sys.stdout, sys.stderr):
            stream.flush()

    def sync(self, value=None):
        """A barrier on the control channel; returns rank 0's ``value`` on
        every rank. An interrupt that comes meanwhile is raised once every
        rank is through, so the ranks stay at one step."""
        self.flush()
        self.in_sync = True
        try:
            self.send(('sync', self.cell, value))
            while True:
                msg = self.conn.recv()
                if msg[0] == 'sync' and msg[1] == self.cell:
                    value = msg[2]
                    break
        finally:
            self.in_sync = False
        self._raise_pending()
        return value

    def rank0_only(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` on rank 0, then :meth:`sync`: every rank
        returns (or raises) rank 0's outcome."""
        outcome = None
        if self.rank == 0:
            try:
                outcome = ('ok', fn(*args, **kwargs))
            except Exception as e:  # noqa: BLE001 - raised on every rank
                outcome = ('error', e)
            try:
                pickle.dumps(outcome)
            except Exception:  # noqa: BLE001 - what cannot travel
                outcome = ('error', RuntimeError(repr(outcome[1])))
        kind, value = self.sync(outcome)
        if kind == 'error':
            raise value
        return value

    def serve(self):
        while True:
            try:
                msg = self.conn.recv()
            except EOFError:
                return
            if msg[0] == 'close':
                return
            if msg[0] == 'cell':
                self.send(('done', msg[1], self.run(*msg[1:])))
            elif msg[0] == 'request':
                self.send(('reply', msg[1], self.answer(msg[2], *msg[3])))

    @staticmethod
    def _multihost():
        return sys.modules.get(f'{PORT}.parallel.multihost')

    def _posted(self):
        mh = self._multihost()
        return mh.collective.posted if mh is not None else 0

    def run(self, cell, source, silent, store_history, count, expressions):
        """One cell; returns its outcome (status, the error's name, value
        and traceback lines, the collectives posted so far)."""
        self.cell, self.error, self.pending = cell, None, False
        mh = self._multihost()
        if mh is not None:
            mh.collective.held = False
        out = {'status': 'ok'}
        self.running = True
        try:
            if self.kind == 'ipython':
                if count is not None:
                    self.shell.execution_count = count
                self.shell.run_cell(source, store_history=store_history,
                                    silent=silent)
            else:
                self._run_plain(source)
        except KeyboardInterrupt:  # between the cell's end and here
            self.error = ('KeyboardInterrupt', '', ['KeyboardInterrupt'])
        finally:
            self.running = False
        self.flush()
        if self.error is not None:
            ename, evalue, tb = self.error
            out = {'status': 'error', 'ename': ename, 'evalue': evalue,
                   'traceback': tb}
        if self.rank == 0 and expressions and self.kind == 'ipython':
            out['user_expressions'] = self.shell.user_expressions(
                expressions)
        out['posted'] = self._posted()
        return out

    def _run_plain(self, source):
        try:
            switch.run_cell(source, self.namespace, '<console>')
        except BaseException as e:  # noqa: BLE001 - reported, as a REPL
            tb = e.__traceback__
            ours = (os.path.abspath(__file__),
                    os.path.abspath(switch.__file__))
            while tb is not None and os.path.abspath(
                    tb.tb_frame.f_code.co_filename) in ours:
                tb = tb.tb_next
            self.error = (type(e).__name__, str(e),
                          traceback.format_exception(type(e), e, tb))

    def answer(self, what, *args):
        """Rank 0's answer to a completion or inspection request (the
        kernel's)."""
        if what == 'complete':
            from IPython.core.completer import (provisionalcompleter,
                                                rectify_completions)
            code, pos = args
            with provisionalcompleter():
                found = list(rectify_completions(
                    code, self.shell.Completer.completions(code, pos)))
            start, end = (found[0].start, found[0].end) if found else (pos,
                                                                       pos)
            return {'matches': [c.text for c in found], 'cursor_start': start,
                    'cursor_end': end, 'metadata': {}, 'status': 'ok'}
        if what == 'inspect':
            from IPython.utils.tokenutil import token_at_cursor
            code, pos, detail = args
            name = token_at_cursor(code, pos)
            try:
                data = self.shell.object_inspect_mime(name,
                                                      detail_level=detail)
            except KeyError:
                return {'status': 'ok', 'data': {}, 'metadata': {},
                        'found': False}
            return {'status': 'ok', 'data': data, 'metadata': {},
                    'found': True}
        return None


def _ipython_shell(engine):
    """The kernel engines' IPython shell: display data and results on the
    channel (rank 0's) or as text in the rank's log, tracebacks kept for
    the reply, shell commands and file-writing magics on rank 0 alone."""
    from IPython.core.displayhook import DisplayHook
    from IPython.core.displaypub import DisplayPublisher
    from IPython.core.interactiveshell import InteractiveShell
    from IPython.utils.process import system
    from traitlets.config import Config

    class Publisher(DisplayPublisher):
        def publish(self, data, metadata=None, source=None, *,
                    transient=None, update=False, **kwargs):
            if engine.rank == 0:
                engine.flush()
                engine.send(('display', data, metadata or {},
                             transient or {}, update))
            else:
                print(data.get('text/plain', ''))

        def clear_output(self, wait=False):
            if engine.rank == 0:
                engine.send(('clear', wait))

    class Hook(DisplayHook):
        def write_output_prompt(self):
            pass

        def write_format_data(self, format_dict, md_dict=None):
            if engine.rank == 0:
                engine.flush()
                engine.send(('result', format_dict, md_dict or {}))
            else:
                print(format_dict.get('text/plain', ''))

        def finish_displayhook(self):
            self._is_active = False

    class Shell(InteractiveShell):
        def _showtraceback(self, etype, evalue, stb):
            engine.error = (etype.__name__, str(evalue), stb)

        def system(self, cmd):
            cmd = self.var_expand(cmd, depth=1)
            code = engine.rank0_only(system, cmd)
            self.user_ns['_exit_code'] = code
            if self.system_raise_on_error and code != 0:
                from subprocess import CalledProcessError
                raise CalledProcessError(code, cmd)

        def getoutput(self, cmd, split=True, depth=0):
            return engine.rank0_only(super().getoutput, cmd, split,
                                     depth + 2)

    config = Config()
    # one in-memory history a rank: the ranks share no database
    config.HistoryManager.hist_file = ':memory:'
    shell = Shell.instance(config=config, displayhook_class=Hook,
                           display_pub_class=Publisher)
    for name in RANK0_CELL_MAGICS:
        magic = shell.find_cell_magic(name)
        if magic is not None:
            def once(line, cell, magic=magic):
                return engine.rank0_only(magic, line, cell)
            shell.register_magic_function(once, 'cell', name)
    return shell


def engine_main(kind, device):
    """``python -m dynamite_tpu_torch.interactive engine KIND DEVICE``: one
    rank of a session (the front end starts it)."""
    host, port = os.environ[ADDRESS_ENV].rsplit(':', 1)
    conn = Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ.pop(KEY_ENV)))
    rank = int(os.environ['RANK'])
    engine = Engine(conn, rank, kind, device)
    with switch.host_files():
        conn.send(('hello', rank, os.getpid()))
        engine.serve()
    switch._leave_group()


# -- the front ends ----------------------------------------------------------


def kernel_class():
    """The Jupyter kernel (an ``ipykernel`` kernel class, built here so that
    ``ipykernel`` is imported by the kernel's entry point alone). Set its
    ``cards`` and ``device`` before the kernel app instantiates it."""
    from IPython.core.inputtransformer2 import TransformerManager
    from ipykernel.kernelbase import Kernel

    class SessionKernel(Kernel):
        implementation = f'{PORT}.interactive'
        implementation_version = __version__
        language_info = {
            'name': 'python', 'version': sys.version.split()[0],
            'mimetype': 'text/x-python', 'file_extension': '.py',
            'codemirror_mode': {'name': 'ipython', 'version': 3},
            'pygments_lexer': 'ipython3', 'nbconvert_exporter': 'python'}
        banner = (f'{PORT}: one engine per card; cells run on every rank, '
                  f'output is rank 0\'s')
        cards = None
        device = None

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.group = Group(self.cards or count_cards(self.device),
                               self.device, 'ipython')
            self.group.start()

        def _publish(self, kind, *payload):
            if kind == 'stream':
                self.send_response(self.iopub_socket, 'stream', {
                    'name': payload[0], 'text': payload[1]})
            elif kind == 'display':
                data, metadata, transient, update = payload
                self.send_response(
                    self.iopub_socket,
                    'update_display_data' if update else 'display_data',
                    {'data': data, 'metadata': metadata,
                     'transient': transient})
            elif kind == 'clear':
                self.send_response(self.iopub_socket, 'clear_output',
                                   {'wait': payload[0]})
            elif kind == 'result':
                self.send_response(self.iopub_socket, 'execute_result', {
                    'execution_count': self.execution_count,
                    'data': payload[0], 'metadata': payload[1]})

        async def do_execute(self, code, silent, store_history=True,
                             user_expressions=None, allow_stdin=False,
                             **kwargs):
            reply = self.group.execute(
                code, self._publish, silent=silent,
                store_history=store_history, count=self.execution_count,
                user_expressions=user_expressions)
            content = {'status': reply['status'],
                       'execution_count': self.execution_count}
            if reply['status'] == 'error':
                error = {k: reply[k] for k in ('ename', 'evalue',
                                               'traceback')}
                if not silent:
                    self.send_response(self.iopub_socket, 'error', error)
                content.update(error)
            else:
                content.update(payload=[], user_expressions=reply[
                    'user_expressions'])
            return content

        async def do_complete(self, code, cursor_pos):
            cursor_pos = len(code) if cursor_pos is None else cursor_pos
            return self.group.request('complete', code, cursor_pos) or {
                'status': 'ok', 'matches': [], 'cursor_start': cursor_pos,
                'cursor_end': cursor_pos, 'metadata': {}}

        async def do_inspect(self, code, cursor_pos, detail_level=0,
                             omit_sections=()):
            cursor_pos = len(code) if cursor_pos is None else cursor_pos
            return self.group.request('inspect', code, cursor_pos,
                                      detail_level) or {
                'status': 'ok', 'data': {}, 'metadata': {}, 'found': False}

        async def do_is_complete(self, code):
            status, indent = TransformerManager().check_complete(code)
            out = {'status': status}
            if status == 'incomplete':
                out['indent'] = ' ' * (indent or 0)
            return out

        async def do_shutdown(self, restart):
            self.group.close()
            return {'status': 'ok', 'restart': restart}

    return SessionKernel


def kernel_main(connection_file, cards=None, device=None):
    """``python -m dynamite_tpu_torch.interactive kernel -f FILE``: the
    Jupyter kernel over ``cards`` engines."""
    from ipykernel.kernelapp import IPKernelApp
    cls = kernel_class()
    cls.cards, cls.device = cards, device
    IPKernelApp.launch_instance(argv=['-f', connection_file],
                                kernel_class=cls)


def display_name(cards=None, device=None):
    where = 'every card' if cards is None else (
        '1 card' if cards == 1 else f'{cards} cards')
    if device is not None:
        where += f', {device}'
    return f'{PORT} ({where})'


def install(cards=None, device=None, name=PORT, user=False, prefix=None):
    """Install the kernel's kernelspec (``kernel.json``: the kernel's argv
    with ``--cards``/``--device``, ``interrupt_mode: signal``, the
    repository on ``PYTHONPATH``) as ``name``; returns its directory."""
    from jupyter_client.kernelspec import KernelSpecManager
    argv = [sys.executable, '-m', f'{PORT}.interactive', 'kernel', '-f',
            '{connection_file}']
    if cards is not None:
        argv += ['--cards', str(cards)]
    if device is not None:
        argv += ['--device', device]
    spec = {'argv': argv, 'display_name': display_name(cards, device),
            'language': 'python', 'interrupt_mode': 'signal',
            'env': {'PYTHONPATH': switch.REPO},
            'metadata': {'debugger': False}}
    with tempfile.TemporaryDirectory() as src:
        with open(os.path.join(src, 'kernel.json'), 'w') as f:
            json.dump(spec, f, indent=1)
        return KernelSpecManager().install_kernel_spec(
            src, name, user=user, prefix=prefix)


def console(cards=None, device=None):
    """The console (``switch --console``): a REPL over ``cards`` engines,
    on the standard library's :mod:`code` module. Returns 0 at the end of
    its input."""
    import code
    group = Group(cards or count_cards(device), device, 'plain')
    tty = sys.stdin.isatty()

    def show(kind, *payload):
        if kind == 'stream':
            stream = sys.stderr if payload[0] == 'stderr' else sys.stdout
            stream.write(payload[1])
            stream.flush()

    class Console(code.InteractiveConsole):
        def runsource(self, source, filename='<input>', symbol='single'):
            try:
                if self.compile(source, filename, symbol) is None:
                    return True  # more lines to come
            except (OverflowError, SyntaxError, ValueError):
                self.showsyntaxerror(filename)
                return False
            reply = group.execute(source, show)
            if reply['status'] == 'error' and reply['ename'] == 'SystemExit':
                raise SystemExit(reply['evalue'] or None)
            if reply['status'] == 'error':
                self.write(''.join(line if line.endswith('\n')
                                   else line + '\n'
                                   for line in reply['traceback']))
            return False

        def raw_input(self, prompt=''):
            return input(prompt if tty else '')

    try:
        group.start()
        sys.stderr.write(f'{display_name(group.cards, device)}: one engine '
                         f'per card; the output is rank 0\'s\n')
        Console().interact(banner='', exitmsg='')
    finally:
        group.close()
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(
        prog=f'python -m {PORT}.interactive',
        description='A Jupyter kernel whose cells run on every card of the '
                    'host, one process per card.')
    sub = p.add_subparsers(dest='command', required=True)
    for name in ('install', 'kernel'):
        s = sub.add_parser(name)
        s.add_argument('--cards', type=int, default=None,
                       help='engines, one per card; default every visible '
                            'card, 1 with --device cpu')
        s.add_argument('--device', default=None,
                       help="config.device of the engines (e.g. 'cpu')")
    sub.choices['kernel'].add_argument('-f', dest='connection_file',
                                       required=True)
    inst = sub.choices['install']
    inst.add_argument('--name', default=PORT)
    where = inst.add_mutually_exclusive_group()
    where.add_argument('--user', action='store_true')
    where.add_argument('--prefix', default=None)
    eng = sub.add_parser('engine')
    eng.add_argument('kind', choices=('ipython', 'plain'))
    eng.add_argument('device')
    args = p.parse_args(argv)
    if getattr(args, 'cards', None) is not None and args.cards < 1:
        p.error('--cards takes a positive number')
    if args.command == 'install':
        print(install(args.cards, args.device, args.name, args.user,
                      args.prefix))
    elif args.command == 'kernel':
        kernel_main(args.connection_file, args.cards, args.device)
    else:
        engine_main(args.kind, args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
