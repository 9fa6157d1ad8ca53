"""The benchmark of ``dynamite_tpu_torch``, the PyTorch and CUDA port: one
cell, one run.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout on a machine with as many CUDA cards as
the cell asks for (``chips`` in ``BENCHMARK.json``). Without them it exits
2 and prints no result. A cell on several cards starts one process a card
through the port's own launch (``dynamite_tpu_torch.switch.rank_env`` /
``start_rank``); rank 0's output is the run's.

A run: set-up (the port's configuration, the cell's operators and states
built from the seed, one warm-up step of the cell's own shapes through the
window's own call), then the window, steps of the cell's traffic in a
closed loop until ``--seconds`` have passed, ended by a device sync. Then
the device peak is read, the program's state freed, and what the window
produced is compared with the plain reference (``portbench/reference``,
plain PyTorch, which imports nothing of the port). The last lines of
standard error give each compared number beside its limit; the last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. A run that finds ``jax``, ``jaxlib``, ``flax`` or
``dynamite_tpu`` loaded (top-level names compared whole) exits 3 and prints
no result.

Adding to the benchmark is adding files and manifest entries; no file
that is there needs an edit (``portbench/core/manifest.py`` says where each
is found):

* a configuration: ``portbench/configs/<name>.json`` (``source``,
  ``reduced``, ``assumed``, ``L``, ``space``, ``precision``, ``chips``,
  ``hamiltonian``, ``params``, and ``limits``: each compared number's
  limit), its term-list module ``portbench/hamiltonians/<hamiltonian>.py``
  if it is a new one, and an entry under ``configs``;
* a traffic mix: ``portbench/traffic/<name>.json`` naming its step loop
  (``loop``) and the loop's parameters, the loop
  ``portbench/loops/<loop>.py`` if it is a new one (a ``Study`` with
  ``warm_up``, ``step``, ``release``, ``check``), and a cell under
  ``workloads``;
* a metric: ``portbench/metrics/<name>.py`` whose ``read(run)`` returns the
  number or None (then the metric is left out of the line), and an entry
  under ``end_to_end`` or ``per_layer``; a metric of a family that has a
  reader (``krylov.ms_per_step.<suffix>`` read by
  ``krylov.ms_per_step.py``) needs the entry alone.

The traced run (``--trace 1``) runs torch.profiler (CPU and CUDA) over the
window (over its first ``trace_steps`` steps where the traffic file sets
it) and opens ``record_function`` ranges from the harness's own files:
the window, each step, each solve (the harness's calls of ``evolve`` and
``eigsolve``), each operator build (``build_mat``), every matvec, by
wrapping the port's ``ops.apply.OperatorKernel.apply``, and the ranks'
agreement on the window's end after each step (one broadcast over several
cards; its device time is kept out of ``nccl.*`` and printed on standard
error). If the port
renames that method, nothing is wrapped and the metrics that need matvec
ranges (``krylov.*``, ``matvec*``) read None and are left out. The events
stay in memory and only the summary is printed.

The port's kernels build at first use into ``dynamite_tpu_torch/_build``
inside the checkout; the caches of torch and CUDA go under
``.portbench_cache`` inside the checkout.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, '.portbench_cache')
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton'),
                   ('CUDA_CACHE_PATH', 'cuda')):
    os.environ[_var] = os.path.join(CACHE, _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    # for the benchmark's own tests and controls; runs never pass them
    p.add_argument('--as-rank', action='store_true', help=argparse.SUPPRESS)
    p.add_argument('--device', help=argparse.SUPPRESS)
    p.add_argument('--precision', help=argparse.SUPPRESS)
    p.add_argument('--root', help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    from portbench.core import harness
    from portbench.core.manifest import Manifest
    chips = Manifest(args.root).cell(args.workload)['chips']
    if args.device is None:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < chips:
            sys.stderr.write(f'{args.workload} needs {chips} CUDA card(s); '
                             f'this machine has {have}\n')
            return harness.EXIT_NO_CARD
    if chips > 1 and not args.as_rank:
        return harness.launch_ranks(argv, chips, t0=T0)
    t0 = float(os.environ['PORTBENCH_T0']) if args.as_rank else T0
    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), t0=t0, root=args.root,
                            device=args.device, precision=args.precision)


if __name__ == '__main__':
    sys.exit(main())
