"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line (see ``run.py``)."""

import contextlib
import gc
import json
import math
import os
import sys
import time

import numpy as np

from . import guard, trace
from .manifest import Manifest

EXIT_NO_CARD = 2
EXIT_REFUSED_MODULE = 3
EXIT_RANK_FAILED = 4
# the module each rank runs (``python -m``); the benchmark's tests put a
# module there that plants a fault first
RANK_MODULE = 'portbench.run'


class Run:
    """What one run knows; the cell's loop and the metric readers get it.

    ``steps`` holds one record a step of the window (the loop fills its
    counters), ``window_s`` the window's seconds, ``summary`` the traced
    window's reduction (``trace.reduce``) on this rank, ``study`` the
    loop's object."""

    def __init__(self, man, cell, seed, seconds, traced, device, precision):
        import torch
        self.cell = man.cell(cell)
        self.config = man.config(self.cell['config'])
        self.traffic = man.traffic(self.cell['traffic'])
        self.hamiltonian = man.module('hamiltonians',
                                      self.config['hamiltonian'])
        self.loop = man.module('loops', self.traffic['loop'])
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.precision = precision or self.config['precision']
        self.device = torch.device(device) if device else None
        self.steps = []
        self.window_s = None
        self.setup_s = None
        self.peak_bytes = None
        self.summary = None
        self.study = None

    # -- what the loops use ------------------------------------------------
    def rng(self, stream):
        """A numpy Generator for one use of the seed (0: the inputs, 1: the
        choice of what is checked)."""
        return np.random.default_rng([self.seed % 2 ** 64, stream])

    def span(self, name):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    @property
    def rank(self):
        import torch.distributed as dist
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def world(self):
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1

    def sync(self):
        import torch
        if self.on_card():
            torch.cuda.synchronize()

    def on_card(self):
        from dynamite_tpu_torch import config
        return config.device.type == 'cuda'

    def agree(self, flag):
        """Rank 0's ``flag`` on every rank (one small broadcast)."""
        if self.world == 1:
            return flag
        import torch
        import torch.distributed as dist
        from dynamite_tpu_torch import config
        t = torch.tensor([int(flag)], device=config.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def gather_objects(self, obj):
        """Every rank's ``obj``, in rank order, on every rank."""
        if self.world == 1:
            return [obj]
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def gather_vector(self, planes):
        """The whole complex128 vector from every rank's (2, rows) planes,
        on this rank's device."""
        import torch
        import torch.distributed as dist
        v = torch.complex(planes[0].to(torch.float64),
                          planes[1].to(torch.float64))
        if self.world == 1:
            return v
        parts = [torch.empty_like(v) for _ in range(self.world)]
        dist.all_gather(parts, v)
        return torch.cat(parts)


def _limit_lines(checks, limits):
    out = {}
    for name, value in checks.items():
        out[name] = {'value': value, 'limit': limits[name]}
    return out


def _passes(checks):
    return all(isinstance(c['value'], (int, float))
               and math.isfinite(c['value']) and c['value'] <= c['limit']
               for c in checks.values())


def _device_memory(run):
    import torch
    if not run.on_card():
        return 0
    return torch.cuda.max_memory_allocated()


def run_cell(cell, seed, seconds, traced, *, t0, root=None, device=None,
             precision=None, out=None):
    """Run one cell once in this process (one rank of it, over several
    cards). Returns the exit code; rank 0 prints the result line."""
    import torch
    out = out or sys.stdout
    man = Manifest(root)
    run = Run(man, cell, seed, seconds, traced, device, precision)
    if traced:
        from . import port
        if not port.wrap_matvecs():
            sys.stderr.write('the port has no ops.apply.OperatorKernel.apply '
                             'to wrap: no matvec ranges\n')
    run.study = study = run.loop.Study(run)
    study.warm_up()
    run.sync()
    run.setup_s = time.time() - t0

    profiler = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if run.on_card():
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)
    limit_steps = run.traffic.get('trace_steps') if traced else None
    if run.on_card():
        torch.cuda.reset_peak_memory_stats()
    with profiler as prof:
        with run.span(trace.WINDOW):
            t_start = time.perf_counter()
            while True:
                record = {}
                t_step = time.perf_counter()
                with run.span(trace.STEP):
                    study.step(len(run.steps), record)
                record['host_s'] = time.perf_counter() - t_step
                record['end_s'] = time.time() - t0
                run.steps.append(record)
                stop = time.perf_counter() - t_start >= seconds or (
                    limit_steps is not None
                    and len(run.steps) >= limit_steps)
                t_agree = time.perf_counter()
                with run.span(trace.AGREE):
                    stop = run.agree(stop)
                record['agree_s'] = time.perf_counter() - t_agree
                if stop:
                    break
            run.sync()
            run.window_s = time.perf_counter() - t_start
    run.peak_bytes = max(run.gather_objects(_device_memory(run)))
    if traced:
        run.summary = trace.reduce(prof)
        del prof
    busy = run.gather_objects(
        (run.summary['busy_s'], run.summary['window_s'])
        if traced else None)

    study.release()
    gc.collect()
    if run.on_card():
        torch.cuda.empty_cache()
    if run.rank == 0:
        sys.stderr.write('steps (host seconds, without a sync; ending at '
                         's after the start): ' + ', '.join(
                             f'{s["host_s"]:.3f} ({s["end_s"]:.1f})'
                             for s in run.steps) + '\n')
        agree_ms = sum(s['agree_s'] for s in run.steps) * 1e3
        sys.stderr.write(f'the ranks\' agreement on the window\'s end '
                         f'(host ms a step, with the wait for the step\'s '
                         f'queued work): {agree_ms / len(run.steps):.4f}\n')
        if traced:
            agree_ms = run.summary['device_s']['agree'] * 1e3
            sys.stderr.write(f'the same, device ms a step: '
                             f'{agree_ms / max(1, run.summary["steps"]):.4f}\n')
            sys.stderr.write(f'traced device operations anchored: '
                             f'{run.summary["linked"]:.4f}, '
                             f'{run.summary["placed"]} of them placed '
                             f'between recorded calls\n')
        counts = [s.get('matvecs') for s in run.steps]
        sys.stderr.write(f'matvecs a step: {counts}\n')
    t_check = time.perf_counter()
    checks = study.check()
    if run.rank == 0:
        sys.stderr.write(f'reference check took '
                         f'{time.perf_counter() - t_check:.1f} s\n')

    refused = guard.loaded_refused()
    if refused:
        sys.stderr.write(f'refused modules loaded: {", ".join(refused)}\n')
        return EXIT_REFUSED_MODULE
    if run.rank != 0:
        return 0
    kind = 'per_layer' if traced else 'end_to_end'
    metrics = {}
    for m in man.metrics(kind, cell):
        value = man.module('metrics', m['name']).read(run)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    checks = _limit_lines(checks, run.config['limits'])
    correct = _passes(checks)
    device = {'platform': 'gpu' if run.on_card() else 'cpu',
              'kind': (torch.cuda.get_device_name() if run.on_card()
                       else 'cpu'),
              'count': run.world,
              'memory_peak_bytes': int(run.peak_bytes)}
    if traced:
        device['busy_s'] = float(np.mean([b[0] for b in busy]))
        device['window_s'] = float(np.mean([b[1] for b in busy]))
    result = {'correct': correct, 'attempted': len(run.steps), 'failed': 0,
              'metrics': metrics, 'device': device}
    if traced:
        result['breakdown'] = {'device_ops': run.summary['device_ops'],
                               'idle_gaps': run.summary['idle_gaps']}
    result['checks'] = checks
    for name, c in checks.items():
        ok = 'ok' if _passes({name: c}) else 'FAIL'
        sys.stderr.write(f'check {name} = {c["value"]!r} limit '
                         f'{c["limit"]!r} {ok}\n')
    sys.stderr.flush()
    out.write(json.dumps(result) + '\n')
    out.flush()
    return 0


def launch_ranks(argv, chips, t0=None):
    """Run this cell as ``chips`` processes, one a card, through the
    port's own launch (``dynamite_tpu_torch.switch.rank_env`` and
    ``start_rank``: torchrun's variables; each rank joins the group at its
    first use of the port). Rank 0 writes to this process's output; the
    others' output goes to files that are shown when a rank fails.
    Returns the exit code: 0 when every rank exits 0."""
    import signal
    import subprocess
    import tempfile
    from dynamite_tpu_torch import switch
    env = switch.rank_env(chips)
    env['PORTBENCH_T0'] = repr(t0 if t0 is not None else time.time())
    args = [RANK_MODULE, *argv, '--as-rank']
    logs = tempfile.mkdtemp(prefix='portbench_ranks_')
    procs, files = [], []
    try:
        for r in range(chips):
            o = e = None
            if r > 0:
                o = open(os.path.join(logs, f'rank{r}.out'), 'w')
                e = open(os.path.join(logs, f'rank{r}.err'), 'w')
                files += [o, e]
            procs.append(switch.start_rank(args, env, r, o, e))
        failed_at = None
        while any(p.poll() is None for p in procs):
            if failed_at is None and any(p.poll() not in (None, 0)
                                         for p in procs):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > 15:
                break
            time.sleep(0.1)
    finally:
        for sig in (signal.SIGTERM, signal.SIGKILL):
            alive = [p for p in procs if p.poll() is None]
            for p in alive:
                try:
                    os.killpg(p.pid, sig)
                except ProcessLookupError:
                    pass
            for p in alive:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    pass
        for f in files:
            f.close()
    codes = [p.returncode for p in procs]
    if all(c == 0 for c in codes):
        _rmtree(logs)
        return 0
    for r in range(1, chips):
        if codes[r] != 0:
            for stream in ('out', 'err'):
                with open(os.path.join(logs, f'rank{r}.{stream}'),
                          errors='replace') as f:
                    tail = f.read()[-4000:]
                sys.stderr.write(f'rank {r} exit code {codes[r]}, the end of '
                                 f'its std{stream}:\n{tail}\n')
    _rmtree(logs)
    sys.stderr.write(f'rank exit codes {codes}\n')
    return EXIT_RANK_FAILED


def _rmtree(path):
    import shutil
    shutil.rmtree(path, ignore_errors=True)
