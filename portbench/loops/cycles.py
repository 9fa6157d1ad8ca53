"""Floquet cycles: one client in a closed loop, each step one cycle of the
configuration's Floquet study, the trajectory carried on across steps:

    H.evolve(state, result=tmp, t=period); pulse.dot(tmp, result=next)

as ``run_floquet.py`` runs it, with the state and the next state taking
turns, so that the last cycle's input is still there to check. The
initial state is a product state whose spins are drawn from the seed.

The check (after the window): the plain reference takes the warm-up
cycle from the initial state it makes itself, and the window's last cycle
from the program's state at its start, each by a Taylor series of
exp(-i H period) and the pulse, on the whole vector (gathered to rank 0
over several cards). ``state_gap`` is the larger of the two distances
||psi - psi_ref|| / ||psi_ref||; ``norm_gap`` is | ||psi_last|| - 1 | of
the state the whole trajectory reached. The cycles between them are the
same computation on the program's own state and are not followed.
"""

import torch

from portbench.core import port, roofline, trace
from portbench.reference import expm, full, pauli


class Study:
    def __init__(self, run):
        self.run = run
        cfg = run.config
        self.L = L = cfg['L']
        params = cfg['params']
        port.start(run.precision, L, run.device)
        self.terms = run.hamiltonian.terms(params, L)
        self.pulse_terms = run.hamiltonian.pulse(params, L)
        self.period = params['period']
        spins = run.rng(0).integers(0, 2, L)
        self.initial = ''.join('UD'[s] for s in spins)
        self.H = port.operator(self.terms)
        self.pulse = port.operator(self.pulse_terms)
        self.cur = port.state(state=self.initial)
        self.nxt = port.state(L=L)
        self.tmp = port.state(L=L)
        self.first_out = None
        self.work = None

    def _cycle(self, record):
        with self.run.span(trace.SOLVE):
            self.H.evolve(self.cur, result=self.tmp, t=self.period)
        port.add_solve_counts(record)
        self.pulse.dot(self.tmp, result=self.nxt)
        self.cur, self.nxt = self.nxt, self.cur

    def warm_up(self):
        self._cycle({})
        self.first_out = self.cur.data.to('cpu', copy=True)

    def step(self, k, record):
        self._cycle(record)

    def release(self):
        self.last_in = self.nxt.data
        self.last_out = self.cur.data
        del self.H, self.pulse, self.cur, self.nxt, self.tmp

    def check(self):
        run = self.run
        device = self.last_out.device
        last_in = run.gather_vector(self.last_in)
        last_out = run.gather_vector(self.last_out)
        first_out = run.gather_vector(self.first_out.to(device))
        del self.last_in, self.last_out, self.first_out
        rows = last_out.numel() // run.world
        real = 'float64' if run.precision == 'double' else 'float32'
        if run.rank != 0:
            return None
        H = full.FullOperator(self.terms, self.L, device)
        X = full.FullOperator(self.pulse_terms, self.L, device)
        self.work = (rows, 8 if real == 'float64' else 4,
                     roofline.full_flops(H) / run.world, real)
        bound = pauli.one_norm_bound(self.terms)

        def cycle(psi):
            return X.apply(expm.expm_apply(H.apply, psi, -1j * self.period,
                                           bound))

        psi0 = torch.zeros_like(last_out)
        psi0[sum(1 << i for i, c in enumerate(self.initial) if c == 'D')] = 1
        gaps = [_gap(first_out, cycle(psi0))]
        del psi0, first_out
        gaps.append(_gap(last_out, cycle(last_in)))
        norm = float(torch.linalg.vector_norm(last_out))
        return {'state_gap': max(gaps), 'norm_gap': abs(norm - 1.0)}


def _gap(psi, ref):
    return float(torch.linalg.vector_norm(psi - ref)
                 / torch.linalg.vector_norm(ref))
