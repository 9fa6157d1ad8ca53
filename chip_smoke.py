#!/usr/bin/env python3
"""
Smoke test of dynamite_tpu_torch on one CUDA GPU (an H100; the kernel is
built for sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, builds the XOR matvec kernel from
``dynamite_tpu_torch/csrc/xor_apply.cu`` at first use, and drives the port's
main path at L=24 (dim 2**24) with the random-field Heisenberg chain:

1. environment: torch/CUDA versions, the card, its power limit, build time;
2. the kernel against its plain PyTorch version on the card, Full and both
   Parity sectors, float32 and float64, with times and nnz/s;
3. ``evolve``: L=14 against scipy's expm_multiply, then L=24;
4. ``eigsolve``: float64 at L=16 in a child process (precision is fixed at
   initialization) against scipy's eigsh, then float32 at L=24.

Each phase prints one JSON line; any failure raises (non-zero exit). The
last lines are the card's ``nvidia-smi`` name and power limit, the kernel
record, and ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is available or the package is missing.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHILD_FLAG = '--child-eigsolve-double'

# error bounds of the kernel against its plain version: max|dy| / max|y|.
# Both sum the same terms in float arithmetic of the working type but in
# different orders, so they differ by a few ulps of the largest partial sum.
KERNEL_TOL = {'float32': 1e-5, 'float64': 1e-12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def require_card_and_port():
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available')
    if not os.path.isfile(os.path.join(REPO, 'dynamite_tpu_torch',
                                       'csrc', 'xor_apply.cu')):
        sys.exit('chip_smoke: dynamite_tpu_torch is not next to this script')
    sys.path.insert(0, REPO)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call between CUDA events, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_planes(dim, dtype, seed):
    import torch
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn((2, dim), generator=gen, dtype=dtype, device='cuda')
    return x / torch.linalg.vector_norm(x)


def phase_env():
    import torch
    from dynamite_tpu_torch.ops.xor_apply import build_library
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    build = build_library()
    ptxas = [line.strip() for line in build['log'].splitlines()
             if 'registers' in line or 'spill' in line]
    emit({'phase': 'env', 'python': sys.version.split()[0],
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'device': torch.cuda.get_device_name(0),
          'capability': list(torch.cuda.get_device_capability(0)),
          'nvidia_smi': card, 'kernel_build_s': build['seconds'],
          'ptxas': ptxas})
    return card


def kernel_cases(L):
    from dynamite_tpu_torch.models import localized, heisenberg, ising
    from dynamite_tpu_torch.subspaces import Full, Parity
    cases = []
    for name, H, sub in (
            ('localized_full', localized(L), Full(L=L)),
            ('heisenberg_parity_even', heisenberg(L), Parity('even', L=L)),
            # ising's X field leaves the sector: with projection allowed the
            # odd sector keeps the ZZ terms, whose sign masks hit bit 0 and
            # exercise the Parity sign folding of _effective_sign_mask
            ('ising_parity_odd', ising(L), Parity('odd', L=L))):
        H.allow_projection = True
        H.add_subspace(sub)
        cases.append((name, H, H.get_mat(subspaces=(sub, sub))))
    return cases


def phase_kernel(L=24):
    """The kernel against its plain PyTorch version, on the card."""
    import torch
    from dynamite_tpu_torch.ops.xor_apply import (xor_apply,
                                                  xor_apply_reference)
    rows = []
    for name, H, kernel in kernel_cases(L):
        tables = kernel.tables
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace('torch.', '')
            x = random_planes(tables.dim, dtype, seed=7)
            y = xor_apply(x, tables)
            y_plain = xor_apply_reference(x, tables)
            torch.cuda.synchronize()
            if not torch.isfinite(y).all():
                raise RuntimeError(f'{name} {dt}: non-finite kernel output')
            abs_err = float((y - y_plain).abs().max())
            rel_err = abs_err / float(y_plain.abs().max())
            ms = cuda_ms(lambda: xor_apply(x, tables))
            plain_ms = cuda_ms(lambda: xor_apply_reference(x, tables))
            nnz = tables.dim * H.nnz
            rows.append({'case': name, 'dtype': dt, 'dim': tables.dim,
                         'groups': tables.n_groups, 'terms': tables.n_terms,
                         'nnz_per_row': H.nnz, 'max_abs_err': abs_err,
                         'rel_err': rel_err, 'tol': KERNEL_TOL[dt],
                         'ms': ms, 'plain_ms': plain_ms,
                         'nnz_per_s': nnz / (ms * 1e-3),
                         'plain_nnz_per_s': nnz / (plain_ms * 1e-3)})
            if not rel_err <= KERNEL_TOL[dt]:
                emit({'phase': 'kernel', 'cases': rows})
                raise RuntimeError(f'{name} {dt}: kernel disagrees with its '
                                   f'plain version ({rel_err:.3e})')
            del x, y, y_plain
    emit({'phase': 'kernel', 'cases': rows})
    return rows


def counted(fn, what):
    """Run the main-path call ``fn`` with the kernel's launch count set to 0
    just before it and read just after, so no check's own launch is counted.
    Raises unless the kernel ran at least once per matvec the solver counted.
    Returns (fn's result, launches, solver stats, wall seconds)."""
    import torch
    from dynamite_tpu_torch import computations
    from dynamite_tpu_torch.ops.xor_apply import xor_apply
    torch.cuda.synchronize()
    xor_apply.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = xor_apply.launches
    stats = dict(computations.last_solve_stats)
    if not launches >= stats['matvecs'] > 0:
        raise RuntimeError(f'{what}: {launches} kernel launches for '
                           f'{stats["matvecs"]} matvecs')
    return out, launches, stats, seconds


def phase_evolve():
    """Returns the kernel launches of the L=24 evolve."""
    import numpy as np
    import scipy.sparse.linalg
    from dynamite_tpu_torch.computations import evolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full

    # small: against scipy on the host (float32 on the card)
    L = 14
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=3)
    got = evolve(H, psi, t=1.0).to_numpy()
    want = scipy.sparse.linalg.expm_multiply(-1j * H.to_numpy(),
                                             psi.to_numpy())
    err_14 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    if not err_14 <= 1e-5:
        raise RuntimeError(f'evolve L=14 disagrees with expm_multiply '
                           f'({err_14:.3e})')

    # full size: L=24, t=1, norm preserved (bench.py's check)
    L = 24
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=42)
    r, launches, stats, evolve_s = counted(lambda: evolve(H, psi, t=1.0),
                                           'evolve L=24')
    nrm = r.norm()
    if not (np.isfinite(nrm) and abs(nrm - 1.0) <= 1e-3):
        raise RuntimeError(f'evolve L=24 norm {nrm}')
    emit({'phase': 'evolve', 'L14_rel_err_vs_expm_multiply': err_14,
          'L': L, 'dim': 1 << L, 'evolve_s': evolve_s, 'norm': nrm,
          'launches': launches, 'last_solve_stats': stats})
    return launches


def child_eigsolve_double():
    """Child process: eigsolve in float64 at L=16 against scipy's eigsh."""
    require_card_and_port()
    import numpy as np
    import scipy.sparse.linalg
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.subspaces import Full

    config.precision = 'double'
    L = 16
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    (evals, evecs), launches, stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, tol=1e-12, getvecs=True),
        'eigsolve L=16 float64')
    lam = float(evals[0])
    v = evecs[0]
    resid = np.linalg.norm((H.dot(v).to_numpy() - lam * v.to_numpy()))
    resid = float(resid / abs(lam))
    want = float(scipy.sparse.linalg.eigsh(H.to_numpy(), k=1, which='SA',
                                           return_eigenvectors=False)[0])
    rel = abs(lam - want) / abs(want)
    emit({'phase': 'eigsolve_double', 'L': L, 'dim': 1 << L, 'eval0': lam,
          'eigsh_eval0': want, 'rel_err_vs_eigsh': rel,
          'relative_residual': resid, 'eigsolve_s': eigsolve_s,
          'matvecs': stats['matvecs'], 'restarts': stats['restarts'],
          'launches': launches})
    if not (rel <= 1e-10 and resid <= 1e-10):
        raise RuntimeError('float64 eigsolve misses its 1e-10 bounds')


def phase_eigsolve():
    """float64 at L=16 in a child process, then float32 at L=24 here.
    Returns the kernel launches of the two eigsolve calls."""
    import numpy as np
    import torch
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.subspaces import Full

    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            CHILD_FLAG], capture_output=True, text=True,
                           timeout=600)
    sys.stderr.write(child.stderr)
    lines = child.stdout.strip().splitlines()
    for line in lines:
        print(line, flush=True)
    if child.returncode != 0 or not lines:
        raise RuntimeError(f'the float64 eigsolve child failed '
                           f'(exit code {child.returncode})')
    child_launches = json.loads(lines[-1])['launches']

    L = 24
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    (evals, evecs), launches, stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True), 'eigsolve L=24 float32')
    lam = float(evals[0])
    v = evecs[0]
    resid = float(torch.linalg.vector_norm(H.dot(v).data - lam * v.data))
    resid /= abs(lam)
    emit({'phase': 'eigsolve', 'L': L, 'dim': 1 << L, 'precision': 'single',
          'eval0': lam, 'relative_residual': resid,
          'eigsolve_s': eigsolve_s, 'matvecs': stats['matvecs'],
          'restarts': stats['restarts'],
          'verify_cycles': stats['verify_cycles'], 'launches': launches})
    # the solver's own float32 tolerance is 1e-6 relative to the eigenvalue;
    # the recomputed residual adds float32 rounding of H v
    if not (np.isfinite(lam) and resid <= 1e-4):
        raise RuntimeError(f'float32 eigsolve residual {resid:.3e}')
    return child_launches + launches


def main():
    require_card_and_port()
    import torch
    from dynamite_tpu_torch import config

    config.precision = 'single'
    config._initialize()

    card = phase_env()
    rows = phase_kernel()
    # each main-path call counts its own launches (see counted)
    launches = phase_evolve() + phase_eigsolve()

    if 'jax' in sys.modules:
        raise RuntimeError('the port imported jax')

    main_case = next(r for r in rows if r['case'] == 'localized_full'
                     and r['dtype'] == 'float32')
    print(card, flush=True)
    emit({'kernels': [{
        'name': 'xor_apply',
        'route': 'cuda',
        'source': 'dynamite_tpu_torch/csrc/xor_apply.cu',
        'replaces': 'dynamite_tpu/ops/pallas_apply.py:309',
        'launches': launches,
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': main_case['ms'],
        'plain_ms': main_case['plain_ms'],
    }]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    if sys.argv[1:] == [CHILD_FLAG]:
        child_eigsolve_double()
    else:
        main()
