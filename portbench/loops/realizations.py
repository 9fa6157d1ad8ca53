"""Disorder realizations: one client in a closed loop, each step one
realization of the configuration's random Hamiltonian, as ``run_mbl.py``
takes it: the fields drawn, the operator built (``build_mat``, on the host
clock ending at a device sync), then the traffic's solves in order
(``solves``: ``which`` and ``nev`` each), every one with its eigenvectors.

A realization's work (its solves' matvecs) depends on its fields, so the
traffic's ``pool`` realizations are drawn from its ``pool_seed``, and
every run takes them in the same order, cycling through them: a window
does the same work whatever the seed. The warm-up takes one more
realization drawn after them, which the window never takes.
The seed chooses only which realization is checked. Nothing is collected
by force between steps: the previous realization is freed as Python
frees it in a user's loop.

The check (after the window): the window's last realization and one drawn
from the seed among the window's steps (its eigenvalues only, as its
vectors are not kept) are taken again by the plain reference from their
fields: its own operator on the sector, its own Lanczos for the lowest
and highest eigenvalues. ``eig_gap`` is the largest
|lambda - lambda_ref| / max(1, |lambda_ref|) over the compared
eigenvalues, ``ritz_residual`` the largest
||H_ref v - lambda v|| / (||v|| max(1, |lambda|)) over the last
realization's returned pairs, and ``missing`` the eigenvalues a solve
returned fewer than it was asked for. A solve may return more converged
pairs than it asked for, as the port does: the first ``nev`` in its
order are compared with the reference's, and every returned pair's
residual is.
"""

import time

import numpy as np
import torch

from portbench.core import port, roofline, trace
from portbench.reference import lanczos, sector


class Study:
    def __init__(self, run):
        self.run = run
        cfg = run.config
        self.L = L = cfg['L']
        self.params = cfg['params']
        self.k = cfg['space']['k']
        port.start(run.precision, L, run.device)
        self.space = port.space(cfg['space'], L)
        rng = np.random.default_rng(run.traffic['pool_seed'])
        self.pool = [run.hamiltonian.draw_fields(self.params, L, rng)
                     for _ in range(run.traffic['pool'])]
        self.spare = run.hamiltonian.draw_fields(self.params, L, rng)
        self.evals = []
        self.last = None
        self.work = None

    def _realization(self, fields, record):
        run = self.run
        terms = run.hamiltonian.terms(self.params, self.L, fields)
        H = port.operator(terms)
        H.subspace = self.space
        t = time.perf_counter()
        with run.span(trace.BUILD):
            H.build_mat()
            run.sync()
        record['build_s'] = time.perf_counter() - t
        solves = []
        for solve in run.traffic['solves']:
            with run.span(trace.SOLVE):
                evals, evecs = H.eigsolve(nev=solve['nev'],
                                          which=solve['which'], getvecs=True)
            port.add_solve_counts(record)
            solves.append((solve, np.asarray(evals, dtype=np.float64),
                           [v.data for v in evecs]))
        return {'fields': fields, 'solves': solves}

    def warm_up(self):
        self._realization(self.spare, {})

    def step(self, k, record):
        out = self._realization(self.pool[k % len(self.pool)], record)
        self.evals.append({'fields': out['fields'],
                           'solves': [(solve, evals, [])
                                      for solve, evals, _ in out['solves']]})
        self.last = out

    def release(self):
        pass

    def check(self):
        run = self.run
        device = self.last['solves'][0][2][0].device
        nev = max(s['nev'] for s in run.traffic['solves'])
        eig_gap = resid = 0.0
        missing = 0
        kept = self.evals[run.rng(1).integers(len(self.evals))]
        # one reference a realization: the kept step may have the last's
        chosen = [(self.last['fields'], [self.last])]
        if kept['fields'] is self.last['fields']:
            chosen[0][1].append(kept)
        else:
            chosen.append((kept['fields'], [kept]))
        self.evals = self.last = None
        for fields, outs in chosen:
            terms = run.hamiltonian.terms(self.params, self.L, fields)
            H = sector.SectorOperator(terms, self.L, self.k, device)
            dtype = torch.float64 if H.real else torch.complex128
            low, high = lanczos.extremal_eigenvalues(H.apply, H.dim, nev,
                                                     dtype, device)
            for solve, evals, vecs in (s for o in outs for s in o['solves']):
                # the port may return more converged pairs than asked for:
                # its first nev in the solve's order are compared
                ref = {'lowest': low, 'highest': high}[solve['which']]
                got = np.sort(evals)
                if solve['which'] == 'highest':
                    got = got[::-1]
                n = min(solve['nev'], len(got))
                missing += solve['nev'] - n
                if n:
                    eig_gap = max(eig_gap, float(np.max(
                        np.abs(got[:n] - ref[:n])
                        / np.maximum(1.0, np.abs(ref[:n])))))
                for lam, planes in zip(evals, vecs):
                    v = torch.complex(planes[0].to(torch.float64),
                                      planes[1].to(torch.float64))
                    r = torch.linalg.vector_norm(H.apply(v) - lam * v)
                    resid = max(resid, float(
                        r / torch.linalg.vector_norm(v)
                        / max(1.0, abs(lam))))
            real = 'float64' if run.precision == 'double' else 'float32'
            self.work = (H.dim, 8 if real == 'float64' else 4,
                         roofline.sector_flops(H), real)
            del H
        return {'eig_gap': eig_gap, 'ritz_residual': resid,
                'missing': missing}
