"""The benchmark's parts, found by the names in ``BENCHMARK.json``.

Under a root (the checkout, or a copy of it) the files are:

    BENCHMARK.json                      the manifest
    portbench/configs/<config>.json     a configuration (its ``file`` entry)
    portbench/hamiltonians/<name>.py    its term-list module (``hamiltonian``)
    portbench/traffic/<traffic>.json    a traffic mix's parameters
    portbench/loops/<loop>.py           its step loop (``loop``)
    portbench/metrics/<metric>.py       a metric's reader

A metric with no file of its own is read by its family's: the file named
by the metric's name without its last ``.``-part (``krylov.ms_per_step.x4``
by ``krylov.ms_per_step.py``). So a cell, a configuration, a traffic mix or
a metric is added as new files and manifest entries alone, and a family's
metric for a new end-to-end metric as a manifest entry alone.
"""

import importlib.util
import json
import os
import re
import sys

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = 'portbench'


def default_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class Manifest:
    def __init__(self, root=None):
        self.root = root or default_root()
        with open(os.path.join(self.root, 'BENCHMARK.json')) as f:
            self.data = json.load(f)

    def cell(self, name):
        for w in self.data['workloads']:
            if w['name'] == name:
                return w
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')

    def config(self, name):
        for c in self.data['configs']:
            if c['name'] == name:
                return self._json(c['file'])
        raise KeyError(f'no config {name!r} in BENCHMARK.json')

    def traffic(self, name):
        return self._json(os.path.join(BENCH, 'traffic', f'{name}.json'))

    def metrics(self, kind, cell):
        """The ``kind`` ('end_to_end' or 'per_layer') metrics that ``cell``
        reports, in manifest order."""
        out = []
        for m in self.data[kind]:
            if cell in m.get('workloads', [cell]):
                out.append(m)
        return out

    def module(self, kind, name):
        """portbench/<kind>/<name>.py as a module of its own; for a metric
        with no file of its own, its family's (the module docstring)."""
        path = os.path.join(self.root, BENCH, kind, f'{name}.py')
        family = name.rpartition('.')[0]
        if kind == 'metrics' and not os.path.exists(path) and family:
            name = family
            path = os.path.join(self.root, BENCH, kind, f'{name}.py')
        key = f'_portbench_{kind}_{name}'.replace('.', '_').replace('-', '_')
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod

    def _json(self, rel):
        with open(os.path.join(self.root, rel)) as f:
            return json.load(f)
