"""
Reference values for the example scripts on ``dynamite_tpu_torch``
(``chip_smoke.py``'s phase ``examples`` and ``tests/test_torch_examples.py``),
and the numpy oracle of the MBL example's mid-spectrum line. Not a test
(pytest does not collect it), and importing it imports neither JAX nor the
JAX package: the card machine has no JAX.

``FLOQUET_L16`` is the standard output of the JAX package's float64 run
(JAX-CPU, its default precision) of

    JAX_PLATFORMS=cpu python examples/scripts/floquet/run_floquet.py \\
        -L 16 --n-cycles 3

and ``KAGOME_24_E0`` the ground-state energy (the script's ``E0 = `` line,
12 decimals) of

    cd examples/scripts/kagome && JAX_PLATFORMS=cpu python run_kagome.py 24

(XParity(SpinConserve(24, 12), +1), dim 1,352,078; 580 s of solve on a
CPU host). Both were recorded by running

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_examples_reference.py

which runs the two commands above and prints the values to paste here.
``python tests/torch_examples_reference.py --inner-its L ...`` prints the
MINRES iterations of one mid-spectrum inner solve of the MBL example
(:func:`mbl_inner_iterations`), the measurement behind
``computations.default_inner_its``.
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLOQUET_L16 = """\
t,Deff_energy,entropy,Sz0,Sz1,Sz2,Sz3,Sz4,Sz5,Sz6,Sz7,Sz8,Sz9,Sz10,Sz11,Sz12,Sz13,Sz14,Sz15
0,4.281791379875172,-0.0,0.5,0.5,0.5,0.5,0.5,0.5,0.5,0.5,-0.5,-0.5,-0.5,-0.5,-0.5,-0.5,-0.5,-0.5
0.12,4.280253696594711,0.0003690587476101133,-0.4997036163893318,-0.49967012898924723,-0.4996703186255975,-0.49967034186809334,-0.4996702398384444,-0.4996700140786565,-0.4996696830398225,-0.49967225739943005,0.49967226501760803,0.49967537840421766,0.4996755768164688,0.49967574155651884,0.49967581910271386,0.49967580209711304,0.4996756655316774,0.4997063582699039
0.24,4.281774179190643,0.0012998955539466595,0.4992849861358184,0.4991781275212336,0.4991869843112298,0.4991879729551124,0.4991831927432253,0.49917173268672776,0.49914932321424943,0.49910263273727706,-0.49910722477659475,-0.4990635687173742,-0.49904445999967173,-0.49903621440621304,-0.4990329599239378,-0.49903357893148503,-0.49903964092139075,-0.49918723723320235
0.36,4.2802912491863685,0.0027013051602500057,-0.4981754889937141,-0.4978924635516643,-0.49790302531967146,-0.4979043648275732,-0.49789861259290796,-0.4978862104934129,-0.49787080400514294,-0.49788330579616147,0.49788262337625416,0.4979224087081761,0.49793680810011925,0.49794847663939124,0.49795390954208285,0.4979526790534924,0.49794286421721223,0.49820043279558945
"""

KAGOME_24_E0 = -10.589965547015


def mbl_hamiltonian(L, seed, h=1.0):
    """``examples/scripts/mbl/run_mbl.py``'s Hamiltonian at ``-L L --seed
    seed`` for field strength h, on SpinConserve(L, L/2), built by the
    port's operators (``config.L`` is left as it was)."""
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.operators import (index_sum, sigmax, sigmay,
                                              sigmaz)
    from dynamite_tpu_torch.subspaces import SpinConserve

    saved = config._L
    config.L = L
    try:
        rng = np.random.RandomState(seed % 2**32)
        H = index_sum(0.25 * sum(s(0) * s(1)
                                 for s in (sigmax, sigmay, sigmaz)))
        H += sum(0.5 * rng.uniform(-h, h) * sigmaz(i) for i in range(L))
        H.add_subspace(SpinConserve(L, L // 2))
    finally:
        config._L = saved
    return H


def mbl_line(L, seed, nev, h=1.0):
    """(entropy, ratio) of ``examples/scripts/mbl/run_mbl.py``'s energy
    point 0.5 line at ``-L L --seed seed --nev nev`` for field strength h,
    from ``numpy.linalg.eigh`` of the same matrix (:func:`mbl_hamiltonian`,
    materialized by ``to_numpy``): the mean half-chain entanglement entropy
    of the nev eigenvectors nearest the middle of the spectrum, and their
    mean adjacent-gap ratio."""
    H = mbl_hamiltonian(L, seed, h)
    sub = H.subspace
    w, U = np.linalg.eigh(H.to_numpy().toarray())
    target = w[0] + 0.5 * (w[-1] - w[0])
    pick = np.argsort(np.abs(w - target))[:nev]
    states = sub.idx_to_state(np.arange(len(w)))
    keep = L // 2

    def entropy(v):
        full = np.zeros(1 << L, dtype=v.dtype)
        full[states] = v
        s = np.linalg.svd(full.reshape(1 << (L - keep), 1 << keep),
                          compute_uv=False)
        p = s[s > 0] ** 2
        return float(-np.sum(p * np.log(p)))

    gaps = np.diff(np.sort(w[pick]))
    ratio = np.mean(np.minimum(gaps[:-1], gaps[1:])
                    / np.maximum(gaps[:-1], gaps[1:]))
    return float(np.mean([entropy(U[:, i]) for i in pick])), float(ratio)


def mbl_inner_iterations(L, seed=7, rhs_seed=0):
    """MINRES iterations of one inner solve of the MBL example's target
    solve, on the CPU in float64: (H - target) x = b for
    :func:`mbl_hamiltonian` at the middle of its spectrum (the script's
    energy point 0.5, between the extremal levels), b real and random from
    ``rhs_seed``, to the default inner_tol 1e-10 with no cap that binds
    (100 dim). Returns (dim, iterations, the relative residual)."""
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.solvers.minres import minres_solver

    config.device = 'cpu'
    config.precision = 'double'
    H = mbl_hamiltonian(L, seed)
    lo = float(H.eigsolve(nev=1, which='lowest')[0])
    hi = float(H.eigsolve(nev=1, which='highest')[0])
    dim = H.subspace.get_dimension()
    stats = {}
    solve = minres_solver(H.get_mat(subspaces=(H.subspace, H.subspace)).apply,
                          shift=lo + 0.5 * (hi - lo), maxiter=100 * dim,
                          rtol=1e-10, stats=stats)
    b = torch.zeros((2, dim), dtype=torch.float64)
    b[0] = torch.from_numpy(np.random.default_rng(rhs_seed)
                            .standard_normal(dim))
    solve(b)
    return dim, stats['iterations'], stats['max_rel_residual']


if __name__ == '__main__' and sys.argv[1:2] == ['--inner-its']:
    # python tests/torch_examples_reference.py --inner-its 10 12 14 16
    for L in map(int, sys.argv[2:]):
        dim, its, res = mbl_inner_iterations(L)
        print(f'L={L} dim={dim} iterations={its} ({its / dim:.3f} dim) '
              f'relative residual {res:.3g}', flush=True)
elif __name__ == '__main__':
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    scripts = os.path.join(REPO, 'examples', 'scripts')
    floquet = subprocess.run(
        [sys.executable, os.path.join(scripts, 'floquet', 'run_floquet.py'),
         '-L', '16', '--n-cycles', '3'],
        env=env, capture_output=True, text=True, check=True)
    print('FLOQUET_L16 = """\\')
    print(floquet.stdout, end='')
    print('"""')
    kagome = subprocess.run(
        [sys.executable, 'run_kagome.py', '24'],
        cwd=os.path.join(scripts, 'kagome'), env=env, capture_output=True,
        text=True, check=True)
    e0 = next(line for line in kagome.stdout.splitlines()
              if line.startswith('E0 = '))
    print('KAGOME_24_E0 =', float(e0.split()[2]))
