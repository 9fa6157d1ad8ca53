#!/usr/bin/env python3
"""
Smoke test of dynamite_tpu_torch on one CUDA GPU (an H100; the kernel is
built for sm_90a).

    python3 chip_smoke.py

Runs from the root of a checkout, builds the XOR matvec kernel from
``dynamite_tpu_torch/csrc/xor_apply.cu`` and the ELL kernel from
``dynamite_tpu_torch/csrc/ell_apply.cu`` (one nvcc each, started together),
and drives the port's main paths at L=24 with the random-field Heisenberg
chain: on Full(24) (dim 2**24) through the XOR kernel, in the half-filling
sector SpinConserve(24, 12) (dim 2,704,156) through the sector engine, and
on the same sector discovered by Auto through the ELL kernel:

1. environment: torch/CUDA versions, the card, its power limit, build times,
   ptxas registers and spills of each kernel; then ``draw``: the random
   state's draw (``ops/draw.py``) at 2^24 rows on the card against the
   CPU (see phase_draw);
2. ``kernel``: the one-device route against its plain PyTorch version on the
   card, Full and both Parity sectors, long_range(24), and localized(24) on
   XParity(Full(24)) in both sectors, float32 and float64, with times,
   nnz/s, the bound, cuSPARSE's CSR SpMV of the same matrix, and the
   diagonal stream's build (its own kernel, a Walsh-Hadamard transform per
   tile) against its plain version, with its time per call and alone,
   bytes and bound (see diagonal_record);
3. ``kernel_sharded``: the sharded route on P = 1, 2, 4, 8 virtual shards
   of one vector, each from its row offset and partner blocks, on the same
   cases: put together equal to the one-device route, each shard and its
   diagonal stream against its plain version;
4. ``sector``: the sector engine (dense matmuls, torch ops) against its
   plain version (the on-the-fly row sweep) on the card: heisenberg(24) on
   SpinConserve(24, 12), localized(24) on XParity(SpinConserve(24, 12)),
   heisenberg(26) on SpinConserve(26, 13), float32 (float64 in the child
   process of phase 6), with times, build time, channels, matmuls, table
   bytes, dense GFLOP/s, bounds, launches per apply and the device idle
   share from torch.profiler, and cuSPARSE's CSR SpMV of the same matrix;
5. ``evolve``: L=14 against scipy's expm_multiply, then L=24;
6. ``eigsolve``: a child process in float64 (precision is fixed at
   initialization): L=16 against scipy's eigsh (and its interior pair by
   both target methods), the sector engine's float64 record, and
   eigsolve(localized(22)) on SpinConserve(22, 11) to 1e-10;
   then float32 at L=24 on Full(24), with the half-chain RDM and entropy
   of its ground state on the card against the host route, and on
   XParity(Full(24), '+'), one device and over 4 virtual ranks through
   the kernel's sharded route (see xparity_sharded);
7. ``sector_solves``: evolve and eigsolve of localized(24) on
   SpinConserve(24, 12), the half-chain entanglement entropy of its ground
   state (the JAX bench's eigsolve_L24 entropy field) and an uneven cut,
   each on the card against the host route, and the eigsolve on
   XParity(SpinConserve(24, 12), '+'), float32, with a profile of where the
   eigsolve's device time goes;
8. ``syk``: the XOR-dense engine (torch ops, cuBLAS products) against its
   plain version on syk(16) on Parity(16, 'even') and syk(20) on
   Parity(20, 'even') (N = 32 and 40 Majoranas), float32, with times,
   nnz/s, the split, channels, tables, bounds, launches and idle share per
   apply, and cuSPARSE's SpMV of the same matrix; then eigsolve(syk(16))
   against the JAX package's eigenvalue; then ``syk_sharded``: the
   engine's per-rank apply over 2 and 4 virtual ranks on syk(20) against
   the one-device engine, and eigsolve(syk(16)) over 4 (see
   phase_syk_sharded);
9. ``target``: interior eigenvalues (``eigsolve(target=)``) of
   localized(24) on Full(24), float32, through the XOR kernel: the two
   levels nearest 0.7 lambda_3 + 0.3 lambda_4 by MINRES shift-invert, with
   a profile of 20 MINRES iterations; BASELINE config 3's mid-spectrum
   solve (target 0, capped, recorded converged or not) and the half-chain
   entropy of the evolved Neel state, card against host; the child of
   phase 6 runs both methods in float64 at L=16 against scipy's eigsh;
   then ``diagonal``: the diagonal stream of the folded operator
   (localized(24) - target)^2 that eigsolve(target_method='fold') builds
   (1,016 diagonal terms), float32 and float64, against its plain version
   (see phase_diagonal);
10. ``general``: Auto(localized(24), 'U'*12 + 'D'*12) (the host BFS and
   the canonical order timed; dim 2,704,156, the state list
   SpinConserve(24, 12)'s), the ELL kernel (``csrc/ell_apply.cu``) on its
   packed (SELL-32) tables in float32 and float64 against its plain
   versions and cuSPARSE's SpMV, with its bound counted on nonzeros,
   the same vector through the sector engine on SpinConserve(24, 12), the
   on-the-fly sweep over the table budget, the rectangular pair
   SpinConserve(24, 11) -> SpinConserve(24, 12) (imaginary coefficients),
   eigsolve/entropy/evolve on Auto(24) against the JAX package's float64
   values and the SpinConserve evolve, and estimate_memory against the
   build's device bytes (see phase_general);
11. ``general_sharded``: the general routes over P virtual ranks of one
   card (ops/apply.py's VirtualTransport, the per-rank code a process
   group runs): localized(24) on Auto(24) through each rank's ELL tables at
   P = 2, 3, 4, 8 (each rank's ``ell_apply`` against its plain version,
   bitwise against the one-device kernel, per-rank and summed ms, bytes
   and bounds), evolve(t=1) through it at P = 4 (its launches counted),
   heisenberg(24) and localized(24) on SpinConserve(24, 12) through the
   sector engine's alpha ring at P = 2, 3, 4 against the one-device
   engine, and both sweeps at L=20 (see phase_general_sharded);
12. ``distributed``: one child process per GPU, on NCCL, runs evolve and
   eigsolve at L=24 on Full(24) through the sharded XOR route (one rank on
   a one-GPU machine: no exchange), with two GPUs or more holds the
   gathered ``H.dot`` against the one-device route and runs the XParity
   and syk(16) solves, a state file saved from the ranks and loaded on
   each, and a ``convert_state`` round trip (see distributed_xor_more),
   then eigsolve (with
   the entropy) and evolve of localized(24) on SpinConserve(24, 12)
   through the alpha ring and through each rank's ELL tables, and over
   two ranks or more SpinConserve(26, 13) through ELL; with three GPUs or
   more a second spawn at world 3 runs the general pairs on the padded
   layout (see distributed_general);
13. ``multinode``: with two cards or more, the world-2 or world-4 part of
   phase 12 again on two nodes emulated on this host (2 x 1 or 2 x 2
   cards): each node its own ``CUDA_VISIBLE_DEVICES`` block, local ranks,
   ``NCCL_HOSTID``, working directory and ``TMPDIR``, the state file in a
   directory both share, each rank started by ``multihost.initialize()``
   from SLURM's srun variables alone; NCCL's log must show two nodes,
   NET/Socket between them and P2P inside one, every rank must launch the
   XOR, diagonal and ELL kernels, and each λ must agree with phase 12's;
   the transports' ms and the solves' seconds over NET/Socket beside
   NVLink's (see phase_multinode). On one card it says it needs two;
14. ``examples``: the JAX package's example scripts (floquet at L=24 with
   a checkpoint and a resume, and at L=16; kagome '24'; mbl at L=12; syk
   at N=32) through the package switch, each in its own process, and the
   port of the sharded one (``run_sharded_torch.py``, SpinConserve(30, 15)
   over 4 virtual ranks), against each other, the JAX package's float64
   values and numpy oracles; and a ``config.profile_dir`` trace of a solve
   on the card (see phase_examples);
15. ``reference_suite``: the JAX package's own test files that run
   unchanged on the port (``tests/torch_reference_suite.py`` UNCHANGED)
   through ``python -m dynamite_tpu_torch.switch --pytest`` on the card
   in one child process: every test passes, one line per file, and the
   XOR, diagonal and ELL kernels each launched (see
   phase_reference_suite);
16. ``tutorial``: the tutorial notebooks 1-6 through the switch's
   ``--notebook`` mode on the card and on the CPU, each in its own
   process, their outputs equal cell by cell
   (``tests/torch_tutorial_reference.py``), with each run's seconds,
   device peak and launches (see phase_tutorial);
17. ``cards``: with two cards or more, every card of this host from
   unchanged code: the examples, the 15 reference files and notebooks 1-6
   through ``python -m dynamite_tpu_torch.switch`` at its default (one
   process per card, NCCL), held to phases 14-16's one-card runs, and on
   four cards floquet at L=27 in float64 with each card's peak (see
   phase_cards). It runs after phase 16, alone, so the one-card phases'
   records stay one card's. On one card it says it needs two;
18. ``interactive``: the port's interactive session at every card (one
   engine process per card, ``dynamite_tpu_torch/interactive.py``) through
   its Jupyter kernel where ``ipykernel`` and ``jupyter_client`` import,
   else its console (``switch --console``, which needs neither):
   notebooks 2, 4 and 6, each in a fresh group, equal to phase 16's card
   run, an interrupted ``H.dot`` loop on Parity(24) and the next cell's
   norm, on four cards floquet's Hamiltonian on Full(27) in float64 for one
   cycle, and no engine left behind (see phase_interactive).

Each phase prints one JSON line (the sector and XOR-dense engines'
records also one ``{"engines": [...]}`` line), with the device memory peak
of its solves (``tools.get_memory_usage``); any failure raises (non-zero
exit). The last
lines are the card's ``nvidia-smi`` name and power limit, the kernel records
(the matvec kernel on each route, the diagonal kernel and the ELL kernel
on one device and on each rank's tables), and
``{"ok": true, "device": {...}}``. Exits non-zero without a result when no
CUDA device is available or the package is missing.

    python3 chip_smoke.py --group-costs

times the matvec kernel on synthetic L=24 operators instead, to show what
one mask group costs by where its partner rows lie, and localized(24) with
and without the diagonal stream (see group_costs).

    python3 chip_smoke.py --sector-forms

times the sector engine's one product per column channel against the JAX
package's batching of the channels that share a matrix (see sector_forms).

    python3 chip_smoke.py --xor-dense-la

times the XOR-dense engine at every split La (see xor_dense_la_sweep).

    python3 chip_smoke.py --general

runs the environment, the general phase and the general routes over
virtual ranks alone (see phase_general, phase_general_sharded).

    python3 chip_smoke.py --multinode

runs the environment, phase distributed at the largest power-of-two world
of the cards and phase multinode alone (see multinode_only).

    python3 chip_smoke.py --examples

runs the environment and the examples phase alone (see phase_examples).

    python3 chip_smoke.py --reference-suite
    python3 chip_smoke.py --tutorial

run the environment and phase reference_suite, or phase tutorial, alone.

    python3 chip_smoke.py --interactive

runs the environment, the card runs of notebooks 2, 4 and 6 and phase
interactive alone (see interactive_only).

    python3 chip_smoke.py --diagonal [TREE ...]

times the diagonal kernel per call and alone on localized(24),
long_range(24) and the folded localized(24), float32 and float64, for each
checkout of the repository given (default this one), in turn; A B B A
compares two trees on one card (see diagonal_times).
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHILD_FLAG = '--child-eigsolve-double'
CHILD_DIST = '--child-distributed'
GROUP_COSTS = '--group-costs'
SECTOR_FORMS = '--sector-forms'
XOR_DENSE_LA = '--xor-dense-la'
GENERAL_ONLY = '--general'
MULTINODE_ONLY = '--multinode'
DIAGONAL = '--diagonal'
CHILD_DIAGONAL = '--child-diagonal'
CHILD_EXAMPLE = '--child-example'
EXAMPLES_ONLY = '--examples'
CHILD_REFERENCE = '--child-reference-suite'
REFERENCE_ONLY = '--reference-suite'
CHILD_NOTEBOOK = '--child-notebook'
TUTORIAL_ONLY = '--tutorial'
CHILD_CARDS = '--child-cards'
INTERACTIVE_ONLY = '--interactive'

# error bounds of the kernel against its plain version: max|dy| / max|y|.
# Both sum the same terms in float arithmetic of the working type but in
# different orders, so they differ by a few ulps of the largest partial sum.
KERNEL_TOL = {'float32': 1e-5, 'float64': 1e-12}

# an H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes/s;
# FLOP/s per type outside the tensor cores, for the hand kernels and the
# matrix-free bounds; and the dense products' peak, for the sector engine's
# cuBLAS GEMMs: SGEMM on the CUDA cores (TF32 off), DGEMM on the FP64 tensor
# cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'float64': 34e12}
GEMM_PEAK_FLOPS = {'float32': 67e12, 'float64': 67e12}
# the diagonal stream's bound counts a fast Walsh-Hadamard transform per
# tile of 2**12 rows (ops/xor_apply.py DIAG_TILE_BITS)
DIAG_BOUND_TILE_BITS = 12
# the folded operator's target in ``--diagonal``: (H - target)^2 has the
# same diagonal terms for every nonzero target
DIAG_FOLD_TARGET = 0.3

# the ground-state energies the JAX package printed for its eigsolve_L24
# (localized(24) on SpinConserve(24, 12)) and double_L22 stages
# (BENCH_r05.json, two decimals); an eigenvalue does not depend on the chip
EVAL0_SC24 = -43.38
EVAL0_SC22 = -39.65
EVAL0_TOL = 0.01
# the half-chain entanglement entropy of that SC(24, 12) ground state, as
# the JAX package computes it in float64 on JAX-CPU (eigsolve to tol 1e-12,
# residual 1.3e-13), printed by tests/entropy_L24_reference.py; the port's
# float32 ground state must come within ENTROPY_TOL of it (it came 5.8e-9
# off on an H100), its device and host routes must agree to
# ENTROPY_ROUTES_TOL, and tr rho be 1
ENTROPY_SC24 = 0.4963883122316129
ENTROPY_TOL = 1e-6
ENTROPY_ROUTES_TOL = 1e-5
# the lowest eigenvalue of syk(16) on Parity(16, 'even'), as the JAX
# package computes it: dynamite_tpu.computations.eigsolve(H, nev=1,
# tol=1e-10) in float64 on JAX-CPU, through its XOR-dense engine (at
# xor_dense_la = 5; the eigenvalue does not depend on the split), printed
# by tests/syk_eval0_reference.py
EVAL0_SYK16 = -254.11831878534292
EVAL0_SYK_RTOL = 1e-4
# bench.py's table budget for syk_N40 (its tables take ~9.7 GB)
SYK_N40_BUDGET = 11 << 30
# syk_N40 over virtual ranks against the one-device engine, relative to
# max|y| (float32; the ranks sum each row's channels in other batches)
SYK_SHARDED_RTOL = 1e-5
# the XParity(Full(24)) solve over virtual ranks against one device
XPARITY_SHARDED_TOL = 1e-4
# the target phase. Float64 (the child): the outer tolerance of each
# method; fold at its default (1e-6 on the folded operator's scale) comes
# out 4.1e-10 off eigsh with residuals of 1.7e-4 on this case (the port on
# the CPU), outside the phase's 1e-10 and 1e-8, so it folds to 1e-12.
TARGET_DOUBLE_TOL = {'shift_invert': None, 'fold': 1e-12}
# (b)'s residual bound, relative to the largest of the six lowest |lambda|:
# the H100 gave 1.4e-5 absolute, 3.2e-7 relative
TARGET_RESIDUAL_RTOL = 1e-5
# BASELINE config 3's interior solve: localized(24) on Full(24) at the
# centre of its spectrum, shift-invert at the JAX package's defaults but
# for these caps (one restart; MINRES at 1000 iterations instead of 2000),
# which keep it near 40 s on an H100 (at 2000, ~80 s); then the Neel state
# evolved to NEEL_T, whose half-chain entropy must have grown past
# NEEL_MIN_ENTROPY
TARGET_C_MAX_ITS = 1
TARGET_C_INNER_ITS = 1000
NEEL_T = 1.0
NEEL_MIN_ENTROPY = 1.0
# the general phase: the ground-state energy of localized(24) in the
# half-filling sector as the JAX package computes it in float64 on JAX-CPU
# (tests/entropy_L24_reference.py, residual 1.3e-13), which the float32
# eigsolve on Auto(24) must reach within EVAL0_AUTO_TOL; Auto(24)'s
# dimension, C(24, 12); the evolve on Auto(24) against the same evolve on
# SpinConserve(24, 12) (both float32, the same basis order); and
# estimate_memory against the ELL build's measured device bytes
EVAL0_SC24_F64 = -43.38101221201195
EVAL0_AUTO_TOL = 1e-4
AUTO_DIM_L24 = 2704156
AUTO_EVOLVE_TOL = 1e-4
ESTIMATE_RTOL = 0.10


def emit(obj):
    # one write a line: phases in threads emit beside each other
    sys.stdout.write(json.dumps(obj) + '\n')
    sys.stdout.flush()


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
    """The card, the software, and the kernels' builds: one nvcc per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from dynamite_tpu_torch.ops import ell, xor_apply
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        xor_build, ell_build = pool.map(lambda m: m.build_library(),
                                        (xor_apply, ell))
    emit({'phase': 'env', 'python': sys.version.split()[0],
          'torch': torch.__version__, 'cuda': torch.version.cuda,
          'device': torch.cuda.get_device_name(0),
          'capability': list(torch.cuda.get_device_capability(0)),
          'nvidia_smi': card, 'kernel_build_s': xor_build['seconds'],
          'ell_kernel_build_s': ell_build['seconds'],
          'builds_wall_s': time.perf_counter() - t0,
          'ptxas': ptxas_records(xor_build['log'] + ell_build['log'])})
    return card


# the random draw (ops/draw.py) on the card against the CPU, relative to
# the largest entry: one (seed, row) function, each device's own log,
# sqrt, cos and sin; float32 is the float64 value rounded once
DRAW_RTOL = {'float64': 1e-14, 'float32': 2.0 ** -23}


def phase_draw(L=24):
    """The random state's draw at L=24 (2^24 rows) on the card against the
    CPU, float64 and float32: the largest difference relative to the
    largest entry (held to DRAW_RTOL) and the share of entries that are
    bitwise equal."""
    import torch
    from dynamite_tpu_torch.ops.draw import normal_rows
    out = {'phase': 'draw', 'rows': 1 << L}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split('.')[-1]
        got = normal_rows(5, 1 << L, dtype, torch.device('cuda'), 0, 1).cpu()
        want = normal_rows(5, 1 << L, dtype, torch.device('cpu'), 0, 1)
        out[name] = {'max_rel_err': float((got - want).abs().max()
                                          / want.abs().max()),
                     'bitwise_equal_share': float((got == want).double()
                                                  .mean())}
    emit(out)
    bad = [k for k, tol in DRAW_RTOL.items() if out[k]['max_rel_err'] > tol]
    if bad:
        raise RuntimeError(f'phase draw: {bad} off the CPU: {out}')
    return out


def ptxas_records(log):
    """Registers and spill bytes per kernel instantiation, from the
    ``-Xptxas -v`` lines of the build log."""
    import re
    records, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r'(xor_(?:apply|diagonal)_kernel)I([fd])',
                             mangled)
            ell = re.search(r'ell_apply_kernelI([fd])([il])Lb([01])E',
                            mangled)
            label = mangled
            if name:
                args = ['float' if name.group(2) == 'f' else 'double',
                        *re.findall(r'Li(\d+)E', mangled)]
                label = f"{name.group(1)}<{','.join(args)}>"
            elif ell:
                label = ('ell_apply_kernel<{},{},{}>'.format(
                    'float' if ell.group(1) == 'f' else 'double',
                    'int32' if ell.group(2) == 'i' else 'int64',
                    'true' if ell.group(3) == '1' else 'false'))
            current = {'kernel': label}
            records.append(current)
        elif current is not None:
            spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                              r'loads', line)
            regs = re.search(r'Used (\d+) registers', line)
            if spill:
                current['spill_store_bytes'] = int(spill.group(1))
                current['spill_load_bytes'] = int(spill.group(2))
            if regs:
                current['registers'] = int(regs.group(1))
    return records


def kernel_cases(L):
    """The kernel's cases: (name, H, its kernel, the plain version's
    (reps, warm-up) for timing)."""
    from dynamite_tpu_torch.models import (localized, heisenberg, ising,
                                           long_range)
    from dynamite_tpu_torch.subspaces import Full, Parity, XParity
    cases = (
        ('localized_full', localized(L), Full(L=L), (20, 3)),
        ('heisenberg_parity_even', heisenberg(L), Parity('even', L=L),
         (20, 3)),
        # ising's X field leaves the sector: with projection allowed the
        # odd sector keeps the ZZ terms, whose sign masks hit bit 0 and
        # exercise the Parity sign folding of _effective_sign_mask
        ('ising_parity_odd', ising(L), Parity('odd', L=L), (20, 3)),
        # ~300 diagonal terms (all-pairs ZZ), and complex single-site
        # groups (X + Y fields); the plain version takes ~1 s a call
        ('long_range_full', long_range(L), Full(L=L), (3, 1)),
        # the random Z field leaves the X-parity sectors and is projected
        # away; the rewritten masks that touched spin L-1 fold onto
        # m ^ (2**L - 1), reaching nearly every bit
        ('localized_xparity_full_plus', localized(L),
         XParity(Full(L=L), '+'), (5, 1)),
        ('localized_xparity_full_minus', localized(L),
         XParity(Full(L=L), '-'), (5, 1)))
    out = []
    for name, H, sub, plain_reps in cases:
        H.allow_projection = True
        H.add_subspace(sub)
        out.append((name, H, H.get_mat(subspaces=(sub, sub)), plain_reps))
    return out


def phase_kernel(L=24):
    """The kernel against its plain PyTorch version, on the card."""
    import torch
    from dynamite_tpu_torch.ops.xor_apply import (xor_apply,
                                                  xor_apply_reference)
    rows = []
    for name, H, kernel, plain_reps in kernel_cases(L):
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
            plain_ms = cuda_ms(lambda: xor_apply_reference(x, tables),
                               *plain_reps)
            nnz = tables.dim * H.nnz
            bound_ms, bound_by = bound(tables, dt)
            rows.append({'case': name, 'dtype': dt, 'dim': tables.dim,
                         'groups': tables.n_groups, 'terms': tables.n_terms,
                         'kernel_groups': len(tables.kernel_groups),
                         'nnz_per_row': H.nnz,
                         'flops_per_row': flops_per_row(tables),
                         'max_abs_err': abs_err,
                         'rel_err': rel_err, 'tol': KERNEL_TOL[dt],
                         'ms': ms, 'plain_ms': plain_ms,
                         'bound_ms': bound_ms, 'bound_by': bound_by,
                         'bound_share': bound_ms / ms,
                         'nnz_per_s': nnz / (ms * 1e-3),
                         'plain_nnz_per_s': nnz / (plain_ms * 1e-3),
                         **diagonal_record(tables, dtype, plain_reps)})
            if not (rel_err <= KERNEL_TOL[dt]
                    and rows[-1]['diag_rel_err'] <= KERNEL_TOL[dt]):
                emit({'phase': 'kernel', 'cases': rows})
                raise RuntimeError(f'{name} {dt}: kernel disagrees with its '
                                   f'plain version ({rel_err:.3e})')
            if name == 'localized_full' and dtype == torch.float32:
                lib_ms, lib_err = library_spmv(tables, x, y)
                rows[-1].update(library_ms=lib_ms, library_rel_err=lib_err)
                # float32 values and sums in another order than the kernel
                if not lib_err <= 1e-4:
                    raise RuntimeError(f'the CSR yardstick disagrees with '
                                       f'the kernel ({lib_err:.3e})')
            del x, y, y_plain
    emit({'phase': 'kernel', 'cases': rows})
    return rows


def diagonal_bound(dim, planes, itemsize, adds):
    """(ms, 'bytes' or 'operations'): the least time an H100 could take to
    build a diagonal stream of ``dim`` rows -- the larger of its bytes
    written (planes x dim x itemsize; it reads nothing per row) over HBM
    bandwidth, and the operations of a fast Walsh-Hadamard transform per
    tile of 2**DIAG_BOUND_TILE_BITS rows: dim x tile bits adds per plane,
    plus ``adds`` (the diagonal's nonzero coefficient parts) per tile."""
    bits = min(DIAG_BOUND_TILE_BITS, dim.bit_length() - 1)
    dt = 'float32' if itemsize == 4 else 'float64'
    by_bytes = planes * dim * itemsize / HBM_BYTES_PER_S * 1e3
    ops = planes * dim * bits + max(1, dim >> bits) * adds
    by_ops = ops / PEAK_FLOPS[dt] * 1e3
    return max(by_bytes, by_ops), ('bytes' if by_bytes >= by_ops
                                   else 'operations')


def diagonal_record(tables, dtype, plain_reps, reps=10):
    """The diagonal stream of the whole space: its build (the diagonal
    kernel) against its plain version, its time per call (CUDA events
    around the wrapper's call) and of the kernel alone (torch.profiler's
    kernel duration over ``reps`` calls), bytes and bound
    (:func:`diagonal_bound`). ``plain_reps`` None skips the plain version's
    time (not its check). Zeros when the operator keeps mask 0 in the group
    loop."""
    import numpy as np
    import torch
    from dynamite_tpu_torch.ops.xor_apply import (xor_diagonal,
                                                  xor_diagonal_reference)
    if not tables.use_diag:
        return {'diag_terms': 0, 'diag_bytes': 0, 'diag_rel_err': 0.0}
    dt = str(dtype).replace('torch.', '')
    st = tables.for_layout(tables.nbits)
    d = xor_diagonal(st, 0, dtype, 'cuda')
    want = xor_diagonal_reference(st, 0, dtype, 'cuda')
    torch.cuda.synchronize()
    if not torch.isfinite(d).all():
        raise RuntimeError(f'{dt}: non-finite diagonal stream')
    abs_err = float((d - want).abs().max())
    rel_err = abs_err / float(want.abs().max())
    del want

    def call():
        return xor_diagonal(st, 0, dtype, 'cuda')

    ms = cuda_ms(call, reps=reps)
    # the kernel alone: per launch (one a call) over the launches the trace
    # holds. The profiler's trace of the card drops events at times (17 to
    # 19 of 20 launches traced, or none in a long run): three tries, then
    # "not measured" (None)
    kernel_ms, traced = None, 0
    for _ in range(3):
        prof = profile_window(call, n=reps, top=5)
        seen = [k for k in prof.get('top_kernels', [])
                if 'xor_diagonal' in k['name']]
        if seen:
            traced = round(sum(k['launches'] for k in seen) * reps)
            kernel_ms = (sum(k['ms'] for k in seen)
                         / sum(k['launches'] for k in seen))
            break
    plain_ms = None
    if plain_reps is not None:
        plain_ms = cuda_ms(
            lambda: xor_diagonal_reference(st, 0, dtype, 'cuda'),
            *plain_reps)
    adds = (np.count_nonzero(tables.diag_c.real)
            + np.count_nonzero(tables.diag_c.imag))
    bound_ms, bound_by = diagonal_bound(tables.dim, d.shape[0],
                                        d.element_size(), adds)
    return {'diag_terms': len(tables.diag_s), 'diag_planes': d.shape[0],
            'diag_bytes': d.numel() * d.element_size(),
            'diag_max_abs_err': abs_err,
            'diag_rel_err': rel_err,
            'diag_build_ms': ms, 'diag_kernel_ms': kernel_ms,
            'diag_kernel_launches_traced': traced,
            'diag_plain_ms': plain_ms,
            'diag_bound_ms': bound_ms, 'diag_bound_by': bound_by}


def diagonal_cases(L, target):
    """(name, XorTables) of the diagonal records: localized(L) and
    long_range(L) on Full(L), and the folded operator (H - target)^2 of
    localized(L) (``computations._folded_msc``, as
    eigsolve(target_method='fold') builds it) on Full(L)."""
    from dynamite_tpu_torch import computations
    from dynamite_tpu_torch.models import localized, long_range
    from dynamite_tpu_torch.operators import Operator
    from dynamite_tpu_torch.subspaces import Full
    out = []
    for name, make in (
            ('localized_full', lambda: localized(L)),
            ('long_range_full', lambda: long_range(L)),
            ('folded_localized_full', lambda: Operator.from_msc(
                computations._folded_msc(localized(L), target)))):
        H = make()
        H.add_subspace(Full(L=L))
        tables = H.get_mat().tables
        if tables is None or not tables.use_diag:
            raise RuntimeError(f'{name}: no XOR tables with a diagonal '
                               'stream')
        out.append((name, tables))
    return out


def phase_diagonal(target, L=24):
    """The diagonal stream of the folded localized(24) at the target
    phase's target (1,016 diagonal terms), float32 and float64, against
    its plain version (3 reps after 1 warm-up)."""
    import torch
    rows = []
    name, tables = diagonal_cases(L, target)[2]
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace('torch.', '')
        rec = {'case': name, 'dtype': dt, 'target': target,
               **diagonal_record(tables, dtype, (3, 1))}
        rows.append(rec)
        if not rec['diag_rel_err'] <= KERNEL_TOL[dt]:
            emit({'phase': 'diagonal', 'cases': rows})
            raise RuntimeError(f'{name} {dt}: the diagonal kernel disagrees '
                               f'with its plain version '
                               f'({rec["diag_rel_err"]:.3e})')
    emit({'phase': 'diagonal', 'cases': rows})
    return rows


def child_diagonal(tree):
    """One tree's diagonal records (``--diagonal``): the package imported
    from ``tree``, its kernel built there."""
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, os.path.abspath(tree))
    from dynamite_tpu_torch import config
    config.precision = 'single'
    config._initialize()
    for name, tables in diagonal_cases(24, DIAG_FOLD_TARGET):
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace('torch.', '')
            rec = {'tree': tree, 'case': name, 'dtype': dt,
                   **diagonal_record(tables, dtype, None, reps=20)}
            emit(rec)
            if not rec['diag_rel_err'] <= KERNEL_TOL[dt]:
                raise RuntimeError(f'{tree} {name} {dt}: the diagonal '
                                   'kernel disagrees with its plain version')


def diagonal_times(trees):
    """``python3 chip_smoke.py --diagonal [TREE ...]``: the diagonal
    kernel's time per call and alone, on localized(24), long_range(24) and
    the folded localized(24) (at DIAG_FOLD_TARGET), float32 and float64,
    for each tree in turn (a checkout of the repository; default this one),
    each in a child process that imports and builds that tree's package.
    Give two trees as A B B A to compare them on one card."""
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for tree in trees or [REPO]:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        CHILD_DIAGONAL, tree], check=True, timeout=600)


def flops_per_row(tables):
    """The float operations one row of y needs, counted from the operator's
    own tables: one add per term for each nonzero part of its coefficient
    (real, imaginary), and per group two FMAs (4 flops) for each nonzero
    part of f_g times the complex x -- 4 for a real or imaginary f_g, 8 for
    a complex one. With a diagonal stream (``use_diag``) the diagonal's
    terms are summed once per operator by the diagonal kernel, whose own
    bound counts them, so they add nothing per apply; d times x still
    counts as the mask-0 group's FMAs."""
    import numpy as np
    diag = np.zeros(tables.n_terms, dtype=bool)
    if tables.use_diag:
        for g in np.flatnonzero(tables.group_mask == 0):
            diag[tables.group_start[g]:tables.group_start[g + 1]] = True
    adds = (np.count_nonzero(tables.term_cr[~diag])
            + np.count_nonzero(tables.term_ci[~diag]))
    fmas = 0
    for g in range(tables.n_groups):
        terms = slice(tables.group_start[g], tables.group_start[g + 1])
        fmas += 2 * (bool(np.any(tables.term_cr[terms]))
                     + bool(np.any(tables.term_ci[terms])))
    return int(adds + 2 * fmas)


def bound(tables, dtype, src_blocks=1):
    """(ms, 'bytes' or 'operations'): the least time an H100 could take for
    one apply -- the larger of the bytes it must move (each input block read
    once, y written once) over HBM bandwidth, and its float operations
    (:func:`flops_per_row`) over the peak rate of the type. ``src_blocks``
    counts the source blocks the sharded route reads, in units of the whole
    vector. The diagonal stream's bytes are left out, as its adds are: so
    the bound holds for a kernel with the stream and for one without it."""
    itemsize = 4 if dtype == 'float32' else 8
    moved = 2 * itemsize * tables.dim * (src_blocks + 1)
    flops = tables.dim * flops_per_row(tables)
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if by_bytes >= by_ops:
        return by_bytes, 'bytes'
    return by_ops, 'operations'


def library_spmv(tables, x, y_kernel):
    """The yardstick: cuSPARSE's CSR SpMV (int32 indices, complex64) of the
    same matrix, built on the card from the tables, times the same vector.
    Returns (ms, max|dy|/max|y| against the kernel). The port never calls
    it; the matrix is freed before returning."""
    import torch
    from dynamite_tpu_torch.ops.index_maps import parity
    dim, G, dev = tables.dim, tables.n_groups, x.device
    k = torch.arange(dim, dtype=torch.int64, device=dev)
    cols = torch.empty((dim, G), dtype=torch.int32, device=dev)
    vals = torch.empty((dim, G), dtype=torch.complex64, device=dev)
    for g, m in enumerate(tables.group_mask):
        cols[:, g] = k ^ int(m)
        fr = torch.zeros(dim, dtype=torch.float64, device=dev)
        fi = torch.zeros(dim, dtype=torch.float64, device=dev)
        for t in range(tables.group_start[g], tables.group_start[g + 1]):
            w = (1 - 2 * parity(k & int(tables.term_s[t]))).double()
            fr += float(tables.term_cr[t]) * w
            fi += float(tables.term_ci[t]) * w
        vals[:, g] = torch.complex(fr.float(), fi.float())
    del k, fr, fi
    crow = torch.arange(0, dim * G + 1, G, dtype=torch.int32, device=dev)
    A = torch.sparse_csr_tensor(crow, cols.reshape(-1), vals.reshape(-1),
                                size=(dim, dim))
    xc = torch.complex(x[0], x[1])
    y = A @ xc
    yk = torch.complex(y_kernel[0], y_kernel[1])
    err = float((y - yk).abs().max() / yk.abs().max())
    ms = cuda_ms(lambda: A @ xc)
    del A, cols, vals, crow, xc, y, yk
    torch.cuda.empty_cache()
    return ms, err


def phase_kernel_sharded(single_rows, L=24):
    """The sharded route on P virtual shards of one vector on the card: each
    shard is launched with its row offset and its partner blocks. P = 1 is
    the one-rank layout the distributed phase runs on one card. Put
    together, the shards must equal the one-device route (max |dy| = 0:
    the same terms per row in the same order); each shard must agree with
    its plain version within KERNEL_TOL. So must each shard's diagonal
    stream (when the operator has one), and the shards' streams put
    together must equal the one-device stream bitwise (each block takes
    its rows of the same aligned tiles). Times are the sum of the P
    launches (plain: of the P plain calls, at P = 4 only)."""
    import torch
    from dynamite_tpu_torch.ops.xor_apply import (
        xor_apply, xor_apply_sharded, xor_apply_sharded_reference,
        xor_diagonal, xor_diagonal_reference)
    single_ms = {(r['case'], r['dtype']): r['ms'] for r in single_rows}
    rows = []
    for name, H, kernel, _plain_reps in kernel_cases(L):
        tables = kernel.tables
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace('torch.', '')
            x = random_planes(tables.dim, dtype, seed=11)
            y_one = xor_apply(x, tables)
            d_one = (xor_diagonal(tables.for_layout(tables.nbits), 0, dtype,
                                  'cuda') if tables.use_diag else None)
            for P in (1, 2, 4, 8):
                st = tables.for_layout(tables.nbits - (P.bit_length() - 1))
                n = st.local_dim
                blocks = [x[:, b * n:(b + 1) * n].contiguous()
                          for b in range(P)]
                srcs = [[blocks[me ^ h] for h in st.hi_list]
                        for me in range(P)]

                def run_all(fn):
                    return [fn(srcs[me], st, me * n) for me in range(P)]

                parts = run_all(xor_apply_sharded)
                plain = run_all(xor_apply_sharded_reference)
                torch.cuda.synchronize()
                diff_one = float((torch.cat(parts, dim=1) - y_one).abs()
                                 .max())
                abs_err = max(float((a - b).abs().max())
                              for a, b in zip(parts, plain))
                rel_err = max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(parts, plain))
                diag_rel_err, diag_diff_one = 0.0, 0.0
                if tables.use_diag:
                    ds = [xor_diagonal(st, me * n, dtype, 'cuda')
                          for me in range(P)]
                    for me, d in enumerate(ds):
                        want = xor_diagonal_reference(st, me * n, dtype,
                                                      'cuda')
                        diag_rel_err = max(diag_rel_err, float(
                            (d - want).abs().max() / want.abs().max()))
                    diag_diff_one = float((torch.cat(ds, dim=1) - d_one)
                                          .abs().max())
                    del ds, want
                row = {'case': name, 'dtype': dt, 'P': P,
                       'hi_list': st.hi_list,
                       'max_abs_diff_vs_one_device': diff_one,
                       'diag_rel_err': diag_rel_err,
                       'diag_max_abs_diff_vs_one_device': diag_diff_one,
                       'max_abs_err': abs_err, 'rel_err': rel_err,
                       'tol': KERNEL_TOL[dt],
                       'ms_sum_of_P': cuda_ms(lambda: run_all(
                           xor_apply_sharded)),
                       'one_device_ms': single_ms[name, dt]}
                if P == 4:
                    row['plain_ms_sum_of_P'] = cuda_ms(
                        lambda: run_all(xor_apply_sharded_reference),
                        reps=3, warmup=1)
                    row['bound_ms'], row['bound_by'] = bound(
                        tables, dt, src_blocks=len(st.hi_list))
                rows.append(row)
                if not (diff_one == 0 and rel_err <= KERNEL_TOL[dt]
                        and diag_diff_one == 0
                        and diag_rel_err <= KERNEL_TOL[dt]):
                    emit({'phase': 'kernel_sharded', 'cases': rows})
                    raise RuntimeError(f'{name} {dt} P={P}: the sharded '
                                       'route disagrees')
                del blocks, srcs, parts, plain
            del x, y_one, d_one
    emit({'phase': 'kernel_sharded', 'cases': rows})
    return rows


def profile_window(fn, n=10, top=0, warmup=True):
    """torch.profiler, tracing the device only (no host op events, which
    would slow the host and fill the trace), over n calls of fn (after one
    unprofiled call, with ``warmup``): the
    CUDA kernels launched per call, and the device's idle share over the
    window: 1 - (union of the busy intervals of kernels, copies and fills)
    / (first device op's start to the last one's end). With ``top``, also
    the ``top`` kernel names by device time. None where the profiler saw no
    device op."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not ops:
        return {'launches_per_call': None, 'busy_ms': None, 'span_ms': None,
                'idle_share': None}
    kernels = [o for o in ops if not o[2].startswith(('Memcpy', 'Memset'))]
    busy, reached = 0.0, ops[0][0]
    for start, end, _name in ops:
        if end > reached:
            busy += end - max(start, reached)
            reached = end
    span = reached - ops[0][0]
    out = {'launches_per_call': len(kernels) / n,
           'device_ops_per_call': len(ops) / n,
           'busy_ms': busy / 1e3 / n, 'span_ms': span / 1e3 / n,
           'idle_share': 1 - busy / span if span > 0 else None}
    if top:
        by_name = {}
        for start, end, name in kernels:
            ms, count = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + (end - start) / 1e3, count + 1)
        out['top_kernels'] = [
            {'name': name[:80], 'ms': ms / n, 'launches': count / n}
            for name, (ms, count) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][0])[:top]]
    return out


def matrix_free_flops(plan):
    """The float operations of a matrix-free apply of the operator's plan,
    counted as :func:`flops_per_row` counts them (per row and group: one add
    per nonzero part of each term's coefficient, 4 per nonzero part of f_g
    times the complex x), for every row and group, partners outside the
    subspace included."""
    import numpy as np
    per_row = 0
    for _m, _perm, _signs, coeffs in plan.groups:
        re, im = np.count_nonzero(coeffs.real), np.count_nonzero(coeffs.imag)
        per_row += re + im + 4 * (bool(re) + bool(im))
    return plan.dim_left * per_row


def sector_library_spmv(plan, x, y_engine):
    """The sector engine's yardstick: cuSPARSE's CSR SpMV (int32 indices,
    complex in x's precision) of the same matrix, its entries found by the
    plain version's row sweep on the card (the nonzero ones only), times
    the same vector. Returns (ms, max|dy|/max|y| against the engine, nnz).
    The port never calls it; the matrix is freed before returning."""
    import torch
    from dynamite_tpu_torch.ops.index_maps import parity
    from dynamite_tpu_torch.ops.sector_apply import CHUNK_BITS
    dev, dim = x.device, plan.dim_left
    cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
    rows_all, cols_all, vals_all = [], [], []
    for start in range(0, dim, 1 << CHUNK_BITS):
        rows = torch.arange(start, min(start + (1 << CHUNK_BITS), dim),
                            dtype=torch.int64, device=dev)
        kets = plan.row_states(rows)
        for m, _perm, signs, coeffs in plan.groups:
            bra = kets ^ m
            f = torch.zeros(rows.shape, dtype=torch.complex128, device=dev)
            for s, c in zip(signs, coeffs):
                f += complex(c) * (1 - 2 * parity(bra & int(s))).double()
            col, valid = plan.right_map.s2i(bra)
            keep = valid & (f != 0)
            rows_all.append(rows[keep])
            cols_all.append(col[keep])
            vals_all.append(f[keep].to(cdt))
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows_all), torch.cat(cols_all)]),
        torch.cat(vals_all), (dim, plan.dim_right)).coalesce()
    del rows_all, cols_all, vals_all
    nnz = A._nnz()
    A = A.to_sparse_csr()
    A = torch.sparse_csr_tensor(A.crow_indices().int(),
                                A.col_indices().int(), A.values(),
                                size=A.shape)
    xc = torch.complex(x[0], x[1])
    y = A @ xc
    ye = torch.complex(y_engine[0], y_engine[1])
    err = float((y - ye).abs().max() / ye.abs().max())
    ms = cuda_ms(lambda: A @ xc)
    del A, xc, y, ye
    torch.cuda.empty_cache()
    return ms, err, nnz


def sector_record(name, H, sub, dtype, plain_reps=(3, 1), plain_profiled=1):
    """Build the sector engine of H on sub (the host build, timed), hold its
    apply against the plain version on the card (max|dy| / max|y| within
    KERNEL_TOL), time both (CUDA events), profile 10 applies of the engine
    and ``plain_profiled`` of the plain version (none when 0: one call makes
    ~25k launches at L=24), and count the engine's
    channels, matmuls, table bytes and dense GFLOP per apply. The bytes
    bound reads x and writes y once and reads the tables once, at HBM rate;
    the dense bound is the products' operations at cuBLAS's GEMM peak of
    the type (``GEMM_PEAK_FLOPS``); the
    matrix-free bound takes x and y with :func:`matrix_free_flops`, which
    also gives both forms a rate of the same useful work. The yardstick is
    cuSPARSE's SpMV of the same matrix (:func:`sector_library_spmv`)."""
    import torch
    from dynamite_tpu_torch.ops.sector_apply import sector_apply_reference
    dt = str(dtype).replace('torch.', '')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel = H.get_mat(subspaces=(sub, sub))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sp, tables = kernel.sector_plan, kernel.sector_tables
    if sp is None:
        raise RuntimeError(f'{name}: the sector engine was not built')
    dim = sub.get_dimension()
    x = random_planes(dim, dtype, seed=13)
    y = kernel.apply(x)
    y_plain = sector_apply_reference(x, kernel.plan)
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise RuntimeError(f'{name} {dt}: non-finite sector engine output')
    abs_err = float((y - y_plain).abs().max())
    rel_err = abs_err / float(y_plain.abs().max())
    ms = cuda_ms(lambda: kernel.apply(x))
    plain_ms = cuda_ms(lambda: sector_apply_reference(x, kernel.plan),
                       *plain_reps)
    prof = profile_window(lambda: kernel.apply(x))
    plain_prof = profile_window(
        lambda: sector_apply_reference(x, kernel.plan), n=plain_profiled,
        warmup=False) if plain_profiled else {}
    lib_ms, lib_err, lib_nnz = sector_library_spmv(kernel.plan, x, y)
    itemsize = x.element_size()
    xy_bytes = 2 * 2 * dim * itemsize
    by_bytes = (xy_bytes + sp.table_bytes) / HBM_BYTES_PER_S * 1e3
    by_dense = tables.dense_flops / GEMM_PEAK_FLOPS[dt] * 1e3
    mf_flops = matrix_free_flops(kernel.plan)
    rec = {'case': name, 'dtype': dt, 'L': sub.L, 'dim': dim,
           'sectors': len(sp.secs), 'col_channels': len(sp.col_channels),
           'row_channels': len(sp.row_channels),
           'matmuls_per_apply': tables.n_matmuls,
           'table_mb': sp.table_bytes / 1e6, 'build_s': build_s,
           'conserved': sp.conserved,
           'max_abs_err': abs_err, 'rel_err': rel_err,
           'tol': KERNEL_TOL[dt], 'ms': ms, 'plain_ms': plain_ms,
           'dense_gflop_per_apply': tables.dense_flops / 1e9,
           'dense_gflop_per_s': tables.dense_flops / (ms * 1e-3) / 1e9,
           'bytes_bound_ms': by_bytes, 'dense_bound_ms': by_dense,
           'bound_ms': max(by_bytes, by_dense),
           'bound_by': 'bytes' if by_bytes >= by_dense else 'operations',
           'matrix_free_gflop_per_apply': mf_flops / 1e9,
           'matrix_free_bound_ms': max(
               xy_bytes / HBM_BYTES_PER_S,
               mf_flops / PEAK_FLOPS[dt]) * 1e3,
           'matrix_free_gflop_per_s': mf_flops / (ms * 1e-3) / 1e9,
           'plain_matrix_free_gflop_per_s': mf_flops / (plain_ms * 1e-3) / 1e9,
           'launches_per_apply': prof['launches_per_call'],
           'device_ops_per_apply': prof.get('device_ops_per_call'),
           'device_busy_ms_per_apply': prof['busy_ms'],
           'idle_share': prof['idle_share'],
           'plain_launches_per_apply': plain_prof.get('launches_per_call'),
           'plain_device_busy_ms_per_apply': plain_prof.get('busy_ms'),
           'plain_idle_share': plain_prof.get('idle_share'),
           'library_ms': lib_ms, 'library_rel_err': lib_err,
           'library_nnz': lib_nnz,
           'library_bytes_bound_ms': (
               xy_bytes + lib_nnz * (2 * itemsize + 4) + 4 * (dim + 1))
           / HBM_BYTES_PER_S * 1e3}
    if not rel_err <= KERNEL_TOL[dt]:
        emit({'phase': 'sector', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the sector engine disagrees with '
                           f'its plain version ({rel_err:.3e})')
    # the library's values and sums are in another order than the engine's
    if not lib_err <= 10 * KERNEL_TOL[dt]:
        emit({'phase': 'sector', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the CSR yardstick disagrees with '
                           f'the sector engine ({lib_err:.3e})')
    return rec


def phase_sector(L=24):
    """The sector engine at L and L + 2, float32 (see sector_record)."""
    import torch
    from dynamite_tpu_torch.models import heisenberg, localized
    from dynamite_tpu_torch.subspaces import SpinConserve, XParity
    recs = []
    for name, make_H, make_sub in (
            # the JAX bench's spinconserve_L24 operator
            (f'heisenberg_sc{L}', lambda: heisenberg(L),
             lambda: SpinConserve(L, L // 2)),
            # the Z field leaves the X-parity sectors: projected away
            (f'localized_xparity_sc{L}_plus', lambda: localized(L),
             lambda: XParity(SpinConserve(L, L // 2), '+')),
            (f'heisenberg_sc{L + 2}', lambda: heisenberg(L + 2),
             lambda: SpinConserve(L + 2, L // 2 + 1))):
        H, sub = make_H(), make_sub()
        H.allow_projection = True
        H.add_subspace(sub)
        # the plain version takes ~1.8 s a call at L=26; the XParity case
        # is timed, not profiled
        recs.append(sector_record(
            name, H, sub, torch.float32,
            plain_reps=(2, 1) if sub.L > L else (3, 1),
            plain_profiled=0 if 'xparity' in name else 1))
        del H
        torch.cuda.empty_cache()
    emit({'phase': 'sector', 'cases': recs})
    return recs


# the port's counters (dynamite_tpu_torch.tracing) that ``counted`` reads,
# by the names of its records
COUNTERS = {'xor_apply': 'xor.launches',
            'xor_diagonal': 'xor.diagonal_launches',
            'sector_apply': 'sector.applies',
            'sector_ring': 'sector.ring_applies',
            'xor_dense_apply': 'xor_dense.applies',
            'ell_apply': 'ell.launches',
            'general_sweep': 'sweep.applies',
            'minres_iterations': 'minres.iterations'}


def counted(fn, what, engine='xor'):
    """Run the main-path call ``fn`` with the kernels' launch counts read
    just before it and just after, so no check's own launch is counted
    (the port's counters, ``COUNTERS``): ``xor.launches`` (the one wrapper
    that launches the matvec kernel) and ``xor.diagonal_launches`` (the
    diagonal stream's builds, once per operator, dtype and layout), and
    beside them the engines' applies (``sector.applies``,
    ``xor_dense.applies``, ``sweep.applies``, the alpha ring's
    ``sector.ring_applies``; torch ops, no kernel of their own), the ELL
    kernel's launches (``ell.launches``), and the MINRES iterations of a
    target solve (``minres.iterations``, one H apply each). Raises unless the
    ``engine`` ('xor', 'sector', 'sector_ring', 'xor_dense', 'ell' or
    'sweep') ran at least once per matvec the solver counted, and, for any
    other engine, unless the XOR kernel did not run. Returns (fn's result,
    {name: count}, solver stats, wall seconds)."""
    import torch
    from dynamite_tpu_torch import computations, tracing
    torch.cuda.synchronize()
    before = tracing.counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {key: tracing.counter(name) - before.get(name, 0)
                for key, name in COUNTERS.items()}
    stats = dict(computations.last_solve_stats)
    ran = launches[{'xor': 'xor_apply', 'sector': 'sector_apply',
                    'sector_ring': 'sector_ring',
                    'xor_dense': 'xor_dense_apply', 'ell': 'ell_apply',
                    'sweep': 'general_sweep'}[engine]]
    if not ran >= stats['matvecs'] > 0:
        raise RuntimeError(f'{what}: {ran} {engine} applies for '
                           f'{stats["matvecs"]} matvecs')
    if engine != 'xor' and launches['xor_apply']:
        raise RuntimeError(f'{what}: the XOR kernel ran on the {engine} '
                           'path')
    return out, launches, stats, seconds


def exchanged(since=(0, 0)):
    """The pairwise exchange's (pairs, bytes sent) counters, less
    ``since``."""
    from dynamite_tpu_torch import tracing
    return (tracing.counter('transport.exchange.pairs') - since[0],
            tracing.counter('transport.exchange.bytes') - since[1])


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def timed(fn):
    """(fn's result, wall milliseconds), the device synchronized before and
    after the call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def peak_gb():
    """The device memory peak since the last ``tools.track_memory()``, in
    GB (``torch.cuda.max_memory_allocated``), then a new tracking window."""
    from dynamite_tpu_torch import tools
    gb = tools.get_memory_usage(group_by='rank', max_usage=True)
    tools.track_memory()
    return gb


def rdm_record(name, state, keep):
    """The RDM of ``state`` over ``keep`` on the card (``ops.rdm``) and its
    entanglement entropy, against the host route (``to_numpy``, the scatter
    into 2^L and ``rdm_from_full_vector`` of ``rdm_host``, numpy's
    eigvalsh), with their times: the RDM's device part alone (the blocks,
    no host copy) with the SpinConserve index tables cold (built in the
    call) and warm (3 calls), the host matrix, and the entropy on the card.
    Raises unless the two routes' entropies agree within
    ENTROPY_ROUTES_TOL and tr rho is within 1e-5 of 1."""
    import numpy as np
    from dynamite_tpu_torch.computations import (dm_entanglement_entropy,
                                                 entanglement_entropy,
                                                 reduced_density_matrix)
    from dynamite_tpu_torch.ops import rdm
    from dynamite_tpu_torch.subspaces import SpinConserve
    keep = tuple(keep)
    rdm.clear_index_cache()
    _b, cold_ms = timed(lambda: rdm.rdm_blocks(state, keep))
    warm_ms = [timed(lambda: rdm.rdm_blocks(state, keep))[1]
               for _ in range(3)]
    rho, rho_ms = timed(lambda: reduced_density_matrix(state, keep))
    S, entropy_ms = timed(lambda: entanglement_entropy(state, keep))
    t0 = time.perf_counter()
    rho_host = rdm.rdm_host(state, keep)
    S_host = float(dm_entanglement_entropy(rho_host))
    host_s = time.perf_counter() - t0
    if isinstance(state.subspace, SpinConserve):
        blocks, _index = rdm.spinconserve_index(state.subspace, keep,
                                                state.data.device)
        flops = sum(2 * (2 * n_k) ** 2 * n_t for _g, n_t, n_k, _o in blocks)
        n_blocks = len(blocks)
    else:
        n, t = 1 << len(keep), 1 << (state.L - len(keep))
        flops, n_blocks = 2 * 2 * n * n * 2 * t, 1
    trace = float(np.trace(rho).real)
    rec = {'case': name, 'L': state.L, 'dim': len(state), 'keep': list(keep),
           'blocks': n_blocks, 'gemm_gflop': flops / 1e9,
           'rdm_cold_ms': cold_ms, 'rdm_warm_ms': warm_ms,
           'rdm_host_matrix_ms': rho_ms, 'entropy_device_ms': entropy_ms,
           'entropy': float(S), 'entropy_host': S_host,
           'host_route_s': host_s, 'trace': trace,
           'index_cache_mb': rdm.index_cache_bytes() / 1e6,
           'rho_max_abs_err_vs_host': float(np.max(np.abs(rho - rho_host)))}
    if not (abs(S - S_host) <= ENTROPY_ROUTES_TOL and abs(trace - 1) <= 1e-5):
        emit({'phase': 'rdm', 'cases': [rec]})
        raise RuntimeError(f'{name}: entropy {S} on the card against '
                           f'{S_host} on the host, tr rho {trace}')
    return rec


def phase_evolve():
    """Returns the kernels' launches of the L=24 evolve."""
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
    peak_gb()
    r, launches, stats, evolve_s = counted(lambda: evolve(H, psi, t=1.0),
                                           'evolve L=24')
    nrm = r.norm()
    if not (np.isfinite(nrm) and abs(nrm - 1.0) <= 1e-3):
        raise RuntimeError(f'evolve L=24 norm {nrm}')
    emit({'phase': 'evolve', 'L14_rel_err_vs_expm_multiply': err_14,
          'L': L, 'dim': 1 << L, 'evolve_s': evolve_s, 'norm': nrm,
          'memory_peak_gb': peak_gb(), 'launches': launches['xor_apply'],
          'diag_builds': launches['xor_diagonal'],
          'last_solve_stats': stats})
    return launches


def child_eigsolve_double():
    """Child process, float64: eigsolve at L=16 on Full against scipy's
    eigsh; the sector engine's float64 record at L=24; eigsolve of
    localized(22) on SpinConserve(22, 11) to 1e-12 (the JAX bench's
    double_L22). The last line holds the main-path calls' launches."""
    require_card_and_port()
    import numpy as np
    import scipy.sparse.linalg
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import heisenberg, localized
    from dynamite_tpu_torch.ops.cvec import norm
    from dynamite_tpu_torch.subspaces import Full, SpinConserve

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
    target_launches = child_target_double(H)

    H = heisenberg(24)
    sub = SpinConserve(24, 12)
    H.add_subspace(sub)
    emit({'phase': 'sector_double',
          'cases': [sector_record('heisenberg_sc24', H, sub, torch.float64,
                                  plain_profiled=0)]})
    del H
    torch.cuda.empty_cache()

    L = 22
    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    t0 = time.perf_counter()
    H.get_mat()
    build_s = time.perf_counter() - t0
    (evals, evecs), sc_launches, stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, tol=1e-12, getvecs=True),
        'eigsolve SpinConserve(22, 11) float64', engine='sector')
    lam = float(evals[0])
    v = evecs[0]
    resid = float(norm(H.dot(v).data - lam * v.data)) / abs(lam)
    emit({'phase': 'sector_eigsolve_double', 'L': L,
          'dim': sub.get_dimension(), 'eval0': lam,
          'jax_bench_eval0': EVAL0_SC22, 'relative_residual': resid,
          'build_s': build_s, 'eigsolve_s': eigsolve_s,
          'matvecs': stats['matvecs'], 'restarts': stats['restarts'],
          'launches': sc_launches})
    if not (resid <= 1e-10 and abs(lam - EVAL0_SC22) <= EVAL0_TOL):
        raise RuntimeError(f'float64 SpinConserve(22, 11) eigsolve: '
                           f'eigenvalue {lam}, residual {resid:.3e}')
    emit({'phase': 'child_double', 'launches': add_counts(
        launches, sc_launches, *target_launches)})


def child_target_double(H):
    """The target phase's float64 part, in the child: eigsolve(target=)
    of H (localized(16) on Full(16)) near the spectrum's edge, target =
    0.7 lambda_3 + 0.3 lambda_4 of scipy's six lowest, nev=2, by both
    methods, through the XOR kernel. Raises unless each pair is within
    1e-10 (relative) of eigsh's two levels nearest the target and each
    ||Hv - lambda v|| <= 1e-8. Returns the solves' launch counts."""
    import numpy as np
    import scipy.sparse.linalg
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.ops.cvec import norm
    lowest = np.sort(scipy.sparse.linalg.eigsh(
        H.to_numpy(), k=6, which='SA', return_eigenvectors=False))
    target = float(0.7 * lowest[3] + 0.3 * lowest[4])
    nearest = np.sort(lowest[np.argsort(np.abs(lowest - target))[:2]])
    recs, launches = [], []
    for method, tol in TARGET_DOUBLE_TOL.items():
        (evals, evecs), counts, stats, seconds = counted(
            lambda: eigsolve(H, nev=2, target=target, target_method=method,
                             tol=tol, getvecs=True),
            f'eigsolve(target=, {method}) L={H.L} float64')
        order = np.argsort(evals)
        rel = float(np.max(np.abs(evals[order] - nearest) / np.abs(nearest)))
        resid = [float(norm(H.dot(evecs[i]).data
                            - float(evals[i]) * evecs[i].data))
                 for i in order]
        recs.append({'method': method, 'tol': tol,
                     'evals': evals[order].tolist(), 'rel_err_vs_eigsh': rel,
                     'residuals': resid, 'seconds': seconds,
                     'launches': counts, 'last_solve_stats': stats})
        launches.append(counts)
        if not (rel <= 1e-10 and max(resid) <= 1e-8):
            emit({'phase': 'target_double', 'cases': recs})
            raise RuntimeError(f'float64 eigsolve(target=, {method}): '
                               f'{rel:.3e} off eigsh, residuals {resid}')
    emit({'phase': 'target_double', 'L': H.L, 'target': target,
          'eigsh_lowest': lowest.tolist(), 'cases': recs})
    return launches


def phase_eigsolve():
    """The float64 child process, then float32 at L=24 on Full and on
    XParity(Full(24), '+') here. Returns the kernels' launches of the
    eigsolve calls, and the child's records by phase."""
    import numpy as np
    import torch
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.subspaces import Full, XParity

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
    child_recs = {}
    for line in lines:
        rec = json.loads(line)
        child_recs[rec['phase']] = rec
    child_launches = child_recs['child_double']['launches']

    L = 24
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    peak_gb()
    (evals, evecs), launches, stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True), 'eigsolve L=24 float32')
    memory = peak_gb()
    lam = float(evals[0])
    v = evecs[0]
    resid = float(torch.linalg.vector_norm(H.dot(v).data - lam * v.data))
    resid /= abs(lam)
    # the half-chain RDM of the Full(24) ground state, card against host
    rdm_full = rdm_record('full24_half', v, range(L // 2))
    emit({'phase': 'eigsolve', 'L': L, 'dim': 1 << L, 'precision': 'single',
          'eval0': lam, 'relative_residual': resid,
          'eigsolve_s': eigsolve_s, 'matvecs': stats['matvecs'],
          'restarts': stats['restarts'],
          'verify_cycles': stats['verify_cycles'],
          'launches': launches['xor_apply'],
          'diag_builds': launches['xor_diagonal'],
          'memory_peak_gb': memory, 'rdm': rdm_full})
    # the solver's own float32 tolerance is 1e-6 relative to the eigenvalue;
    # the recomputed residual adds float32 rounding of H v
    if not (np.isfinite(lam) and resid <= 1e-4):
        raise RuntimeError(f'float32 eigsolve residual {resid:.3e}')
    del H, evecs, v

    # XParity over Full through the same kernel: the Z field leaves the
    # X-parity sectors and is projected away
    H = localized(L)
    H.allow_projection = True
    sub = XParity(Full(L=L), '+')
    H.add_subspace(sub)
    (evals, evecs), xp_launches, stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True),
        'eigsolve XParity(Full(24)) float32')
    lam = float(evals[0])
    v = evecs[0]
    resid = float(torch.linalg.vector_norm(H.dot(v).data - lam * v.data))
    resid /= abs(lam)
    emit({'phase': 'eigsolve_xparity_full', 'L': L,
          'dim': sub.get_dimension(), 'precision': 'single', 'eval0': lam,
          'relative_residual': resid, 'eigsolve_s': eigsolve_s,
          'matvecs': stats['matvecs'], 'restarts': stats['restarts'],
          'launches': xp_launches['xor_apply'],
          'diag_builds': xp_launches['xor_diagonal']})
    if not (np.isfinite(lam) and resid <= 1e-4):
        raise RuntimeError(f'float32 XParity(Full) eigsolve residual '
                           f'{resid:.3e}')
    del evecs, v
    shard_launches, shard_builds = xparity_sharded(H, sub, lam)
    launches = add_counts(child_launches, launches, xp_launches)
    return launches, child_recs, shard_launches, shard_builds, lam


def xparity_sharded(H, sub, lam_one, P=4):
    """eigsolve of localized(24) on XParity(Full(24), '+') over P virtual
    ranks through the XOR route (``VirtualTransport``: the pairwise
    exchange and one ``xor_apply_sharded`` launch a rank, the sign on the
    global row), float32, by ``solvers.eigs`` from a numpy-seeded start,
    the launches counted just around it: λ within XPARITY_SHARDED_TOL of
    the one-device λ, the layout pad-free (the XOR route's), at least P
    launches per matvec. Returns the launches and the diagonal builds."""
    import numpy as np
    import torch
    from dynamite_tpu_torch import config, tracing
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    from dynamite_tpu_torch.parallel import mesh
    from dynamite_tpu_torch.solvers.eigs import eigsolve_trlanczos
    dim = sub.get_dimension()
    k = OperatorKernel(H._msc_on(sub), sub, sub,
                       transport=VirtualTransport(P))
    v0 = np.random.RandomState(37).standard_normal((2, dim))
    stats = {}
    torch.cuda.synchronize()
    before = (tracing.counter('xor.launches'),
              tracing.counter('xor.diagonal_launches'))
    t0 = time.perf_counter()
    evals, _S, _V = eigsolve_trlanczos(k.krylov_ops(20), dim, torch.float32,
                                       config.device, nev=1, v0=v0,
                                       stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tracing.counter('xor.launches') - before[0]
    builds = tracing.counter('xor.diagonal_launches') - before[1]
    lam = float(evals[0])
    rec = {'phase': 'xparity_sharded', 'L': sub.L, 'dim': dim, 'P': P,
           'engine': k.engine, 'eval0': lam, 'one_device_eval0': lam_one,
           'abs_err_vs_one_device': abs(lam - lam_one),
           'pad_free': mesh.storage_dim(dim, P) == dim,
           'eigsolve_s': seconds, 'matvecs': stats['matvecs'],
           'restarts': stats['restarts'], 'launches': launches,
           'diag_builds': builds}
    emit(rec)
    if not (k.engine == 'xor' and rec['pad_free']
            and rec['abs_err_vs_one_device'] <= XPARITY_SHARDED_TOL
            and launches >= P * stats['matvecs'] > 0):
        raise RuntimeError(f'XParity(Full(24)) over {P} virtual ranks: '
                           f'{lam} against {lam_one}, {launches} launches '
                           f'for {stats["matvecs"]} matvecs')
    del k
    torch.cuda.empty_cache()
    return launches, builds


def phase_target(L=24):
    """Interior eigenvalues of localized(24) on Full(24), float32, through
    the XOR kernel (the MINRES inner solves and the extract apply H by the
    kernel). (b) eigsolve(nev=6), then eigsolve(nev=2, target=0.7
    lambda_3 + 0.3 lambda_4) by shift-invert: the pair within 1e-4
    (relative) of the two of the six nearest the target, residuals
    ||Hv - lambda v|| <= TARGET_RESIDUAL_RTOL max|lambda|; with a
    torch.profiler window over 20 MINRES iterations (the kernel's device
    time, the vector ops', the idle share). (c) BASELINE config 3: target
    0.0, nev=1, at the reference's defaults but for TARGET_C_MAX_ITS and
    TARGET_C_INNER_ITS; recorded, converged or not (a solve that runs out
    of restarts raises MaxIterationsError, kept as the record's outcome),
    finite counters required; then the Neel state evolved to NEEL_T under
    the same H, its half-chain entropy on the card against the host route
    (rdm_record) and past NEEL_MIN_ENTROPY, ||psi(t)|| within 1e-3 of 1.
    Each solve counts its own launches (counted). Returns their sum and
    the target of (b)."""
    import numpy as np
    import torch
    from dynamite_tpu_torch.computations import eigsolve, evolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.solvers.expmv import MaxIterationsError
    from dynamite_tpu_torch.solvers.minres import minres_solver
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full

    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    lowest, low_launches, low_stats, low_s = counted(
        lambda: eigsolve(H, nev=6), 'eigsolve(nev=6) L=24 float32')
    lowest = np.sort(lowest)
    target = float(0.7 * lowest[3] + 0.3 * lowest[4])
    nearest = np.sort(lowest[np.argsort(np.abs(lowest - target))[:2]])
    peak_gb()
    (evals, evecs), b_launches, b_stats, b_s = counted(
        lambda: eigsolve(H, nev=2, target=target, getvecs=True),
        'eigsolve(target=) L=24 float32')
    b_memory = peak_gb()
    order = np.argsort(evals)
    rel = float(np.max(np.abs(evals[order] - nearest) / np.abs(nearest)))
    scale = float(np.max(np.abs(lowest)))
    resid = [float(torch.linalg.vector_norm(
        H.dot(evecs[i]).data - float(evals[i]) * evecs[i].data))
        for i in order]
    del evecs
    # 20 MINRES iterations at the same shift, under the profiler
    window = minres_solver(H.get_mat().apply, shift=target, maxiter=20,
                           rtol=0.0)
    b = random_planes(1 << L, torch.float32, seed=11)
    prof = profile_window(lambda: window(b), n=1, top=50)
    del b
    if prof['busy_ms'] is None:
        raise RuntimeError('the profiler saw no device op in the MINRES '
                           'window')
    kernel_ms = sum(k['ms'] for k in prof['top_kernels']
                    if 'xor_apply' in k['name'])
    rec = {'phase': 'target', 'L': L, 'dim': 1 << L, 'precision': 'single',
           'lowest6': lowest.tolist(), 'lowest6_s': low_s,
           'lowest6_matvecs': low_stats['matvecs'],
           'target': target, 'evals': evals[order].tolist(),
           'nearest': nearest.tolist(), 'rel_err_vs_nearest': rel,
           'residuals': resid,
           'residual_bound': TARGET_RESIDUAL_RTOL * scale,
           'eigsolve_s': b_s, 'memory_peak_gb': b_memory,
           'outer_applies': b_stats['outer_applies'],
           'restarts': b_stats['restarts'],
           'minres_iterations': b_stats['minres_iterations'],
           'minres_max_iterations': b_stats['minres_max_iterations'],
           'ms_per_minres_iteration':
               b_stats['candidates_s'] * 1e3 / b_stats['minres_iterations'],
           'host_syncs': b_stats['host_syncs'], 'launches': b_launches,
           'last_solve_stats': b_stats,
           'minres_window': {
               'iterations': 20, 'kernel_ms': kernel_ms,
               'vector_ops_ms': prof['busy_ms'] - kernel_ms,
               'idle_ms': prof['span_ms'] - prof['busy_ms'],
               'span_ms': prof['span_ms'], 'idle_share': prof['idle_share'],
               'launches': prof['launches_per_call'],
               'top_kernels': prof['top_kernels'][:8]}}
    if not (rel <= 1e-4 and max(resid) <= TARGET_RESIDUAL_RTOL * scale):
        emit(rec)
        raise RuntimeError(f'float32 eigsolve(target=) L=24: {rel:.3e} off '
                           f'the nearest pair, residuals {resid}')

    # (c) BASELINE config 3
    def config3():
        try:
            return eigsolve(H, nev=1, target=0.0, max_its=TARGET_C_MAX_ITS,
                            inner_its=TARGET_C_INNER_ITS, getvecs=True)
        except MaxIterationsError as err:
            return err

    peak_gb()
    out, c_launches, c_stats, c_s = counted(config3,
                                            'config 3 eigsolve(target=0)')
    c_rec = {'target': 0.0, 'nev': 1,
             'caps': {'max_its': TARGET_C_MAX_ITS,
                      'inner_its': TARGET_C_INNER_ITS},
             'converged': not isinstance(out, MaxIterationsError),
             'seconds': c_s, 'memory_peak_gb': peak_gb(),
             'launches': c_launches, 'last_solve_stats': c_stats}
    finite = [c_stats['minres_max_rel_residual'],
              c_stats['outer_residual_estimate']]
    if c_rec['converged']:
        evals, evecs = out
        lam = float(evals[0])
        c_rec['eval'] = lam
        c_rec['residual'] = float(torch.linalg.vector_norm(
            H.dot(evecs[0]).data - lam * evecs[0].data))
        finite += [lam, c_rec['residual']]
        del evecs
    else:
        c_rec['error'] = str(out)
    rec['config3'] = c_rec
    if not (c_stats['minres_iterations'] > 0
            and np.all(np.isfinite(np.array(finite, dtype=float)))):
        emit(rec)
        raise RuntimeError(f'config 3 interior solve: {finite}')

    # the rest of config 3: the Neel state evolved under the same H
    psi = State(state='UD' * (L // 2), subspace=sub)
    r, n_launches, n_stats, n_s = counted(
        lambda: evolve(H, psi, t=NEEL_T), 'evolve of the Neel state L=24')
    nrm = r.norm()
    neel = rdm_record('neel_evolved_half', r, range(L // 2))
    rec['config3'].update(neel_t=NEEL_T, neel_evolve_s=n_s, neel_norm=nrm,
                          neel_matvecs=n_stats['matvecs'],
                          neel_launches=n_launches, neel_rdm=neel)
    emit(rec)
    if not (abs(nrm - 1.0) <= 1e-3 and neel['entropy'] >= NEEL_MIN_ENTROPY):
        raise RuntimeError(f'Neel state at t={NEEL_T}: norm {nrm}, '
                           f'half-chain entropy {neel["entropy"]}')
    return add_counts(low_launches, b_launches, c_launches,
                      n_launches), target


def phase_sector_solves(L=24):
    """evolve and eigsolve of localized(24) on SpinConserve(24, 12), and the
    eigsolve on XParity(SpinConserve(24, 12), '+'), float32, through the
    sector engine; then one more eigsolve under torch.profiler for where
    its device time goes. The host build of each operator is timed apart
    (``build_s``). Returns the records."""
    import numpy as np
    import torch
    from dynamite_tpu_torch.computations import eigsolve, evolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import SpinConserve, XParity

    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    t0 = time.perf_counter()
    H.get_mat()
    build_s = time.perf_counter() - t0
    psi = State(state='random', subspace=sub, seed=42)
    peak_gb()
    r, ev_launches, ev_stats, evolve_s = counted(
        lambda: evolve(H, psi, t=1.0), 'evolve SpinConserve(24, 12)',
        engine='sector')
    evolve_memory = peak_gb()
    nrm = r.norm()
    if not (np.isfinite(nrm) and abs(nrm - 1.0) <= 1e-3):
        raise RuntimeError(f'evolve SpinConserve(24, 12): norm {nrm}')
    (evals, evecs), eig_launches, eig_stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True),
        'eigsolve SpinConserve(24, 12)', engine='sector')
    eigsolve_memory = peak_gb()
    lam = float(evals[0])
    v = evecs[0]
    resid = float(torch.linalg.vector_norm(H.dot(v).data - lam * v.data))
    resid /= abs(lam)
    # the JAX bench's entropy field of eigsolve_L24: the half chain of the
    # ground state, and an uneven cut
    peak_gb()
    half = rdm_record('sc24_half', v, range(L // 2))
    uneven = rdm_record('sc24_keep8', v, range(8))
    rdm_memory = peak_gb()  # the cached index tables included
    profile = profile_window(lambda: eigsolve(H, nev=1), n=1, top=8,
                             warmup=False)
    rec = {'phase': 'sector_solves', 'L': L, 'dim': sub.get_dimension(),
           'precision': 'single', 'build_s': build_s,
           'evolve_s': evolve_s, 'evolve_norm_s': ev_stats['norm_s'],
           'evolve_solve_s': ev_stats['solve_s'], 'norm': nrm,
           'evolve_matvecs': ev_stats['matvecs'],
           'evolve_launches': ev_launches,
           'eigsolve_s': eigsolve_s, 'eval0': lam,
           'jax_bench_eval0': EVAL0_SC24, 'relative_residual': resid,
           'eigsolve_matvecs': eig_stats['matvecs'],
           'eigsolve_restarts': eig_stats['restarts'],
           'eigsolve_launches': eig_launches,
           'eigsolve_profile': profile,
           'evolve_memory_peak_gb': evolve_memory,
           'eigsolve_memory_peak_gb': eigsolve_memory,
           'rdm_memory_peak_gb': rdm_memory,
           'entropy_half_chain': half['entropy'],
           'jax_entropy_half_chain': ENTROPY_SC24,
           'entropy_s': half['entropy_device_ms'] / 1e3,
           'rdm': [half, uneven]}
    if not (resid <= 1e-4 and abs(lam - EVAL0_SC24) <= EVAL0_TOL):
        emit(rec)
        raise RuntimeError(f'float32 SpinConserve(24, 12) eigsolve: '
                           f'eigenvalue {lam}, residual {resid:.3e}')
    if not abs(half['entropy'] - ENTROPY_SC24) <= ENTROPY_TOL:
        emit(rec)
        raise RuntimeError(f'SpinConserve(24, 12) half-chain entropy '
                           f'{half["entropy"]}, not {ENTROPY_SC24}')
    del H, psi, r, evecs, v
    torch.cuda.empty_cache()

    H = localized(L)
    H.allow_projection = True
    sub = XParity(SpinConserve(L, L // 2), '+')
    H.add_subspace(sub)
    t0 = time.perf_counter()
    H.get_mat()
    rec['xparity_build_s'] = time.perf_counter() - t0
    (evals, evecs), xp_launches, xp_stats, xp_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True),
        'eigsolve XParity(SpinConserve(24, 12))', engine='sector')
    lam = float(evals[0])
    v = evecs[0]
    resid = float(torch.linalg.vector_norm(H.dot(v).data - lam * v.data))
    resid /= abs(lam)
    rec.update(xparity_dim=sub.get_dimension(), xparity_eigsolve_s=xp_s,
               xparity_eval0=lam, xparity_relative_residual=resid,
               xparity_matvecs=xp_stats['matvecs'],
               xparity_launches=xp_launches)
    emit(rec)
    if not (np.isfinite(lam) and resid <= 1e-4):
        raise RuntimeError(f'float32 XParity(SpinConserve(24, 12)) eigsolve '
                           f'residual {resid:.3e}')
    return rec


def xor_library_spmv(plan, x, y_engine):
    """The XOR-dense engine's yardstick: cuSPARSE's CSR SpMV (complex in x's
    precision, int32 indices) of the same matrix, built on the card
    straight in CSR form: an XOR-mode row has one entry per mask group, in
    column row ^ m', so every row holds the groups' values in group order
    (zeros included, as bench.py's dim * H.nnz counts them). A matrix of
    2**31 entries or more is split into row blocks under that (cuSPARSE's
    SpMV through torch fails on one such matrix with int64 indices), and
    the time is that of all blocks' SpMVs. Returns ((ms, max|dy|/max|y|
    against the engine, entries, blocks), bytes), or (None, bytes) when
    the matrix would not fit 80% of the card's free memory; the port never
    calls it, and the matrix is freed before returning."""
    import torch
    from dynamite_tpu_torch.ops.index_maps import parity
    dev, dim, G = x.device, plan.dim_left, len(plan.groups)
    cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
    need = dim * G * (4 + torch.empty((), dtype=cdt).element_size())
    if need > 0.8 * torch.cuda.mem_get_info(dev)[0]:
        return None, need
    cols = torch.empty((dim, G), dtype=torch.int32, device=dev)
    vals = torch.empty((dim, G), dtype=cdt, device=dev)
    rows = torch.arange(dim, dtype=torch.int64, device=dev)
    kets = plan.row_states(rows)
    for g, (m, pm, signs, coeffs) in enumerate(plan.groups):
        S = torch.as_tensor(signs, device=dev)
        w = 1 - 2 * parity((kets ^ m)[:, None] & S[None, :])
        vals[:, g] = w.to(torch.complex128) @ torch.as_tensor(coeffs,
                                                               device=dev)
        cols[:, g] = rows ^ pm
    del rows, kets
    per = max(1, (2 ** 31 - 1) // G)
    blocks = []
    for r0 in range(0, dim, per):
        n = min(per, dim - r0)
        crow = torch.arange(0, n * G + 1, G, dtype=torch.int32, device=dev)
        blocks.append((r0, n, torch.sparse_csr_tensor(
            crow, cols[r0:r0 + n].reshape(-1), vals[r0:r0 + n].reshape(-1),
            size=(n, dim))))
    xc = torch.complex(x[0], x[1])
    y = torch.empty(dim, dtype=cdt, device=dev)

    def spmv():
        for r0, n, A in blocks:
            y[r0:r0 + n] = A @ xc

    spmv()
    ye = torch.complex(y_engine[0], y_engine[1])
    err = float((y - ye).abs().max() / ye.abs().max())
    ms = cuda_ms(spmv)
    del blocks, cols, vals, xc, y, ye
    torch.cuda.empty_cache()
    return (ms, err, dim * G, -(-dim // per)), need


def xor_dense_record(name, H, sub, dtype):
    """Build the XOR-dense engine of H on sub (the host build, table scatter
    on the card included, timed), hold its apply against the plain version
    (the XOR kernel's on-the-fly sweep, ``xor_apply_reference``, one call on
    the card, timed) within KERNEL_TOL, time the engine (CUDA events, 3
    warm-up, 20 reps), profile 10 applies, and count its split, channels,
    tables and dense GFLOP. Bounds as :func:`sector_record`'s: the table
    stream (x, y and the tables once at HBM rate), the products at
    ``GEMM_PEAK_FLOPS``, and the matrix-free work. nnz/s counts as
    bench.py's syk stage does (dim * H.nnz per apply). The yardstick is
    cuSPARSE's SpMV of the same matrix (``xor_library_spmv``), where it
    fits the card's free memory."""
    import torch
    from dynamite_tpu_torch.ops.xor_apply import XorTables, xor_apply_reference
    dt = str(dtype).replace('torch.', '')
    peak_gb()
    (kernel, build_ms) = timed(lambda: H.get_mat(subspaces=(sub, sub)))
    t = kernel.xor_dense
    if t is None:
        raise RuntimeError(f'{name}: the XOR-dense engine was not built')
    build_memory = peak_gb()
    dim = sub.get_dimension()
    x = random_planes(dim, dtype, seed=17)
    y = kernel.apply(x)
    plain_tables = XorTables(kernel.plan, sub)
    y_plain, plain_ms = timed(lambda: xor_apply_reference(x, plain_tables))
    if not torch.isfinite(y).all():
        raise RuntimeError(f'{name} {dt}: non-finite XOR-dense output')
    abs_err = float((y - y_plain).abs().max())
    rel_err = abs_err / float(y_plain.abs().max())
    ms = cuda_ms(lambda: kernel.apply(x))
    prof = profile_window(lambda: kernel.apply(x), top=4)
    nnz = dim * H.nnz
    got, need = xor_library_spmv(kernel.plan, x, y)
    lib = {'library_ms': None, 'library_rel_err': None, 'library_nnz': None,
           'library_gb': need / 1e9}
    if got is None:
        lib['library_skipped'] = (f'its CSR needs {need / 1e9:.1f} GB, more '
                                  'than 80% of the free memory')
    else:
        lib.update(library_ms=got[0], library_rel_err=got[1],
                   library_nnz=got[2], library_row_blocks=got[3])
    itemsize = x.element_size()
    xy_bytes = 2 * 2 * dim * itemsize
    by_bytes = (xy_bytes + t.table_bytes) / HBM_BYTES_PER_S * 1e3
    by_dense = t.dense_flops / GEMM_PEAK_FLOPS[dt] * 1e3
    mf_flops = matrix_free_flops(kernel.plan)
    rec = {'case': name, 'engine': 'xor_dense', 'dtype': dt, 'L': sub.L,
           'dim': dim, 'terms': kernel.plan.nterms,
           'groups': len(kernel.plan.groups), 'nnz_per_row': H.nnz,
           **kernel.xor_dense_info, 'table_mb': t.table_bytes / 1e6,
           'build_s': build_ms / 1e3, 'build_memory_peak_gb': build_memory,
           'max_abs_err': abs_err, 'rel_err': rel_err, 'tol': KERNEL_TOL[dt],
           'ms': ms, 'plain_ms': plain_ms,
           'nnz_per_s': nnz / (ms * 1e-3),
           'dense_gflop_per_apply': t.dense_flops / 1e9,
           'dense_gflop_per_s': t.dense_flops / (ms * 1e-3) / 1e9,
           'bytes_bound_ms': by_bytes, 'dense_bound_ms': by_dense,
           'bound_ms': max(by_bytes, by_dense),
           'bound_by': 'bytes' if by_bytes >= by_dense else 'operations',
           'matrix_free_gflop_per_apply': mf_flops / 1e9,
           'matrix_free_bound_ms': max(
               xy_bytes / HBM_BYTES_PER_S, mf_flops / PEAK_FLOPS[dt]) * 1e3,
           'torch_ops_per_apply': t.torch_ops_per_apply,
           'launches_per_apply': prof['launches_per_call'],
           'device_ops_per_apply': prof.get('device_ops_per_call'),
           'device_busy_ms_per_apply': prof['busy_ms'],
           'idle_share': prof['idle_share'],
           'top_kernels': prof.get('top_kernels'), **lib}
    if lib['library_nnz']:
        rec['library_bytes_bound_ms'] = (xy_bytes + need) \
            / HBM_BYTES_PER_S * 1e3
    if not rel_err <= KERNEL_TOL[dt]:
        emit({'phase': 'syk', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the XOR-dense engine disagrees '
                           f'with its plain version ({rel_err:.3e})')
    if lib['library_rel_err'] is not None and \
            not lib['library_rel_err'] <= 10 * KERNEL_TOL[dt]:
        emit({'phase': 'syk', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the CSR yardstick disagrees with '
                           f'the XOR-dense engine ({lib["library_rel_err"]})')
    return rec, kernel


def phase_syk():
    """SYK through the XOR-dense engine, float32: syk(16) on Parity(16,
    'even') (N = 32 Majoranas, dim 32,768) and syk(20) on Parity(20,
    'even') (N = 40, dim 524,288, its ~9.7 GB of tables under bench.py's
    11 GiB budget), each against its plain version and cuSPARSE (see
    xor_dense_record); then eigsolve(syk(16), nev=1), counted, against the
    JAX package's eigenvalue. Returns the records."""
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import syk
    from dynamite_tpu_torch.subspaces import Parity

    recs = []
    H, model_s = timed(lambda: syk(16))
    sub = Parity('even', L=16)
    H.add_subspace(sub)
    rec, kernel = xor_dense_record('syk_N32', H, sub, torch.float32)
    rec['model_build_s'] = model_s / 1e3
    recs.append(rec)
    peak_gb()
    evals, launches, stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1), 'eigsolve syk(16)', engine='xor_dense')
    lam = float(evals[0])
    rel = abs(lam - EVAL0_SYK16) / abs(EVAL0_SYK16)
    solve = {'eval0': lam, 'jax_eval0': EVAL0_SYK16, 'rel_err_vs_jax': rel,
             'eigsolve_s': eigsolve_s, 'matvecs': stats['matvecs'],
             'restarts': stats['restarts'], 'launches': launches,
             'memory_peak_gb': peak_gb()}
    emit({'phase': 'syk', 'cases': recs, 'eigsolve': solve})
    if not rel <= EVAL0_SYK_RTOL:
        raise RuntimeError(f'eigsolve syk(16): {lam} against the JAX '
                           f'package\'s {EVAL0_SYK16}')
    del kernel
    H.destroy_mat()
    models = {'syk16': (H, sub)}
    torch.cuda.empty_cache()

    saved = getattr(config, 'ell_budget', None)
    config.ell_budget = SYK_N40_BUDGET
    try:
        H, model_s = timed(lambda: syk(20))
        sub = Parity('even', L=20)
        H.add_subspace(sub)
        rec, kernel = xor_dense_record('syk_N40', H, sub, torch.float32)
        rec['model_build_s'] = model_s / 1e3
        recs.append(rec)
        # the one-device product the ranks' applies are held against
        x = numpy_planes(sub.get_dimension(), torch.float32, seed=29)
        models['syk20'] = (H, sub, x, kernel.apply(x), rec['ms'])
    finally:
        if saved is None:
            del config.ell_budget
        else:
            config.ell_budget = saved
    del kernel
    H.destroy_mat()
    torch.cuda.empty_cache()
    emit({'phase': 'syk', 'cases': recs[1:]})
    return recs, solve, models


def phase_syk_sharded(models, worlds=(2, 4)):
    """The XOR-dense engine over P virtual ranks of one card
    (``VirtualTransport``: each rank's apply on its exchanged source
    blocks, ``xor_dense_apply_sharded``), float32, at full width:
    syk(20) on Parity('even', L=20) (N = 40, dim 524,288) under
    SYK_N40_BUDGET at P = 2 and 4. Per P: the split La and its cap (a
    rank's bits), the ms of one apply of all ranks (CUDA events, 3
    warm-up, 20 reps) beside the one-device engine's, the exchanges and
    bytes per rank and apply, the table bytes (the channel matrices, which
    the ranks share, and each rank's gathers and signs), and the largest
    error against the one-device engine's y of phase ``syk`` on the same
    numpy-seeded x, which must stay within SYK_SHARDED_RTOL of max|y|.
    Then eigsolve(syk(16)) on Parity('even', L=16) over 4 virtual ranks
    through ``solvers.eigs`` (a numpy-seeded start), its engine calls
    counted just around it: λ within EVAL0_SYK_RTOL of the JAX package's,
    at least 4 calls per matvec. Returns the records and the solve."""
    import numpy as np
    import torch
    from dynamite_tpu_torch import config, tracing
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    from dynamite_tpu_torch.solvers.eigs import eigsolve_trlanczos

    H, sub, x, y_one, one_ms = models['syk20']
    dim = sub.get_dimension()
    nbits = dim.bit_length() - 1
    scale = float(y_one.abs().max())
    recs = []
    saved = getattr(config, 'ell_budget', None)
    config.ell_budget = SYK_N40_BUDGET
    try:
        for P in worlds:
            k, build_ms = timed(lambda: OperatorKernel(
                H._msc_on(sub), sub, sub, transport=VirtualTransport(P)))
            if k.engine != 'xor_dense':
                raise RuntimeError(f'syk(20) over {P} virtual ranks took '
                                   f'the {k.engine} route')
            t = k.xor_dense
            before = (tracing.counter('transport.exchange.pairs'),
                      tracing.counter('transport.exchange.bytes'))
            y = k.apply(x)
            torch.cuda.synchronize()
            swaps = tracing.counter('transport.exchange.pairs') - before[0]
            sent = tracing.counter('transport.exchange.bytes') - before[1]
            err = float((y - y_one).abs().max())
            ms = cuda_ms(lambda: k.apply(x))
            rec = {'case': 'syk_N40_virtual_ranks', 'P': P, 'dim': dim,
                   'La': t.La, 'La_cap': nbits - (P.bit_length() - 1),
                   'channels': t.channels,
                   'build_s': build_ms / 1e3,
                   'ms_all_ranks': ms, 'one_device_ms': one_ms,
                   'ratio_to_one_device': ms / one_ms,
                   'exchanges_per_rank_apply': swaps / P,
                   'exchange_mb_per_rank_apply': sent / P / 1e6,
                   'shared_table_mb': t.mat_bytes / 1e6,
                   'rank_own_table_mb': (t.rank_table_bytes(P)
                                         - t.mat_bytes) / 1e6,
                   'max_abs_err_vs_one_device': err,
                   'rel_err_vs_one_device': err / scale,
                   'finite': bool(torch.isfinite(y).all())}
            recs.append(rec)
            del k, t, y
            torch.cuda.empty_cache()
            if not (rec['finite']
                    and rec['rel_err_vs_one_device'] <= SYK_SHARDED_RTOL):
                emit({'phase': 'syk_sharded', 'cases': recs})
                raise RuntimeError(f'syk(20) over {P} virtual ranks: '
                                   f'{err:.3e} from one device')
    finally:
        if saved is None:
            del config.ell_budget
        else:
            config.ell_budget = saved
    del models['syk20'], H, x, y_one
    torch.cuda.empty_cache()

    H, sub = models.pop('syk16')
    P = 4
    k = OperatorKernel(H._msc_on(sub), sub, sub,
                       transport=VirtualTransport(P))
    dim = sub.get_dimension()
    v0 = np.random.RandomState(31).standard_normal((2, dim))
    stats = {}
    torch.cuda.synchronize()
    before = tracing.counter('xor_dense.applies')
    t0 = time.perf_counter()
    evals, _S, _V = eigsolve_trlanczos(k.krylov_ops(20), dim, torch.float32,
                                       config.device, nev=1, v0=v0,
                                       stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    calls = tracing.counter('xor_dense.applies') - before
    lam = float(evals[0])
    rel = abs(lam - EVAL0_SYK16) / abs(EVAL0_SYK16)
    solve = {'case': 'eigsolve_syk16_virtual_ranks', 'P': P,
             'engine': k.engine, 'La': k.xor_dense.La, 'eval0': lam,
             'jax_eval0': EVAL0_SYK16, 'rel_err_vs_jax': rel,
             'eigsolve_s': seconds, 'matvecs': stats['matvecs'],
             'restarts': stats['restarts'], 'xor_dense_calls': calls}
    emit({'phase': 'syk_sharded', 'cases': recs, 'eigsolve': solve})
    if not (rel <= EVAL0_SYK_RTOL and calls >= P * stats['matvecs'] > 0):
        raise RuntimeError(f'eigsolve syk(16) over {P} virtual ranks: '
                           f'{lam} against {EVAL0_SYK16}, {calls} engine '
                           f'calls for {stats["matvecs"]} matvecs')
    del k
    torch.cuda.empty_cache()
    return recs, solve


def xor_dense_la_sweep():
    """``python3 chip_smoke.py --xor-dense-la``: the XOR-dense engine's
    apply at every split La whose tables fit 4 GiB, syk(16) on Parity(16,
    'even'), float32 (and every La from 6 of syk(20) on Parity(20, 'even')
    under 11 GiB, the split the engine picks among them): ms (CUDA events),
    launches and device busy time per
    apply, channels, table bytes, the products' GFLOP, and the modeled time
    of ``xor_dense.pick_split`` beside each. The data that fits
    ``xor_dense.COST_MODEL``."""
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.models import syk
    from dynamite_tpu_torch.ops import xor_dense
    from dynamite_tpu_torch.ops.apply import _Plan
    from dynamite_tpu_torch.ops.xor_apply import _effective_sign_mask
    from dynamite_tpu_torch.subspaces import Parity
    config.precision = 'single'
    config._initialize()
    print(phase_env(), flush=True)
    for n, las, budget in ((16, range(4, 15), 4 << 30),
                           (20, range(6, 12), SYK_N40_BUDGET)):
        H = syk(n)
        sub = Parity('even', L=n)
        plan = _Plan(H.msc, sub, sub)
        nbits = sub.get_dimension().bit_length() - 1
        eff = [[_effective_sign_mask(int(s), int(m), sub, sub)
                for s in signs] for m, _pm, signs, _c in plan.groups]
        x = random_planes(sub.get_dimension(), torch.float32, seed=17)
        for La in las:
            keys = xor_dense._typed_channels_at(plan.groups, eff, La)
            if xor_dense.table_bytes(keys, La, nbits, 4) > budget:
                continue
            t = xor_dense.XorDenseTables(plan, eff, La, 4)
            _runs, build_ms = timed(lambda: t.on(torch.float32, x.device))
            ms = cuda_ms(lambda: xor_dense.xor_dense_apply(x, t))
            prof = profile_window(lambda: xor_dense.xor_dense_apply(x, t))
            emit({'sweep': 'xor_dense_la', 'N': 2 * n, 'La': La,
                  'channels': t.channels,
                  'padded_channels': t.padded_channels,
                  'table_mb': t.table_bytes / 1e6,
                  'device_build_s': build_ms / 1e3,
                  'dense_gflop': t.dense_flops / 1e9, 'ms': ms,
                  'modeled_ms': xor_dense.modeled_seconds(
                      t.channels, La, nbits, 4) * 1e3,
                  'torch_ops_per_apply': t.torch_ops_per_apply,
                  'launches_per_apply': prof['launches_per_call'],
                  'busy_ms': prof['busy_ms'],
                  'idle_share': prof['idle_share']})
            del t, _runs
            torch.cuda.empty_cache()
        pick = xor_dense.pick_split(plan.groups, eff, nbits, budget, 4)
        emit({'sweep': 'xor_dense_la', 'N': 2 * n, 'picked_La': pick[1],
              'modeled_ms': pick[0] * 1e3})
        del H, plan, x
        torch.cuda.empty_cache()


def distributed_full(rank, world, xp_eval0):
    """The Full(24) part of a distributed rank: the gathered evolve at L=14
    against scipy, evolve and eigsolve of localized(24) through the XOR
    route (pairwise exchange and the sharded kernel), their launches and
    exchanges, and with two ranks or more the gathered ``H.dot`` against
    the one-device kernel and the rest of the XOR route over ranks
    (:func:`distributed_xor_more`). Returns the record's fields."""
    import numpy as np
    import scipy.sparse.linalg
    import torch.distributed as dist
    from dynamite_tpu_torch.computations import eigsolve, evolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.ops.cvec import norm
    from dynamite_tpu_torch.ops.xor_apply import xor_apply
    from dynamite_tpu_torch.parallel import multihost
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full

    # small: the gathered result against scipy on the host (and the first
    # solve of this process, which warms up the libraries)
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
        raise RuntimeError(f'distributed evolve L=14 disagrees with '
                           f'expm_multiply ({err_14:.3e})')

    L = 24
    H = localized(L)
    sub = Full(L=L)
    H.add_subspace(sub)
    psi = State(state='random', subspace=sub, seed=42)
    before = exchanged()
    r, ev_launches, ev_stats, evolve_s = counted(
        lambda: evolve(H, psi, t=1.0), 'distributed evolve L=24')
    ev_exchange = exchanged(before)
    nrm = r.norm()
    if not (np.isfinite(nrm) and abs(nrm - 1.0) <= 1e-3):
        raise RuntimeError(f'distributed evolve L=24 norm {nrm}')

    before = exchanged()
    (evals, evecs), eig_launches, eig_stats, eigsolve_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True),
        'distributed eigsolve L=24')
    eig_exchange = exchanged(before)
    lam = float(evals[0])
    v = evecs[0]
    resid = float(norm(H.dot(v).data - lam * v.data)) / abs(lam)
    if not (np.isfinite(lam) and resid <= 1e-4):
        raise RuntimeError(f'distributed eigsolve residual {resid:.3e}')

    # every rank took the same host decisions
    counts = np.array([ev_stats['matvecs'], eig_stats['matvecs'],
                       eig_stats['restarts'], ev_launches['xor_apply'],
                       eig_launches['xor_apply'],
                       ev_launches['xor_diagonal']
                       + eig_launches['xor_diagonal']])
    every = multihost.allgather_host_values(counts)
    if not (every == every[0]).all():
        raise RuntimeError(f'ranks disagree on their solves: {every}')
    out = {'L14_rel_err_vs_expm_multiply': err_14,
           'L': L, 'precision': 'single',
           'evolve_s': evolve_s, 'evolve_norm_s': ev_stats['norm_s'],
           'evolve_solve_s': ev_stats['solve_s'], 'norm': nrm,
           'evolve_matvecs': ev_stats['matvecs'],
           'evolve_launches': ev_launches['xor_apply'],
           'evolve_exchanges': ev_exchange[0],
           'evolve_exchange_bytes': ev_exchange[1],
           'eigsolve_s': eigsolve_s, 'eval0': lam,
           'relative_residual': resid,
           'eigsolve_matvecs': eig_stats['matvecs'],
           'eigsolve_launches': eig_launches['xor_apply'],
           'eigsolve_exchanges': eig_exchange[0],
           'eigsolve_exchange_bytes': eig_exchange[1],
           'launches_all_ranks': int(every[:, 3:5].sum()),
           'launches_per_rank': every[:, 3:5].sum(1).tolist(),
           'diag_builds_all_ranks': int(every[:, 5].sum()),
           'diag_builds_per_rank': every[:, 5].tolist()}
    if world >= 2:
        # the pairwise exchange alone, as a matvec posts it (CUDA events)
        kernel = H.get_mat()
        layout = kernel.tables.for_layout(psi.data.shape[1].bit_length() - 1)
        bufs = kernel._recv_bufs_for(psi.data, layout)
        out['exchange_ms'] = cuda_ms(lambda: exchange(psi.data, layout,
                                                      bufs))
        out['exchange_partners'] = sum(1 for m in layout.hi_list if m)
        x_all = multihost.gather_rows(psi.data)
        y_all = multihost.gather_rows(H.dot(psi).data)
        if rank == 0:
            y_one = xor_apply(x_all, H.get_mat().tables)
            diff = float((y_all - y_one).abs().max())
            out['dot_max_abs_diff_vs_one_device'] = diff
            if not diff <= KERNEL_TOL['float32'] * float(y_one.abs().max()):
                raise RuntimeError(f'gathered H.dot differs from the '
                                   f'one-device route by {diff:.3e}')
        more = distributed_xor_more(rank, world, v, xp_eval0)
        out['launches_all_ranks'] += more.pop('xparity_launches_all_ranks')
        out['diag_builds_all_ranks'] += more.pop('xparity_diag_builds_'
                                                 'all_ranks')
        out['xor_more'] = more
    return out


def distributed_xor_more(rank, world, v, xp_eval0):
    """The rest of the XOR route over ranks on NCCL, float32: eigsolve of
    localized(24) on XParity(Full(24), '+') through the sharded kernel (λ
    within XPARITY_SHARDED_TOL of the one-device λ ``xp_eval0``, at least
    one launch a rank per matvec), eigsolve(syk(16)) on Parity('even',
    L=16) through the XOR-dense engine's per-rank apply (λ within
    EVAL0_SYK_RTOL of the JAX package's, at least one call a rank per
    matvec); ``State.save`` of the Full(24) ground state ``v`` from the
    ranks and ``from_file`` on every rank (each rank's rows equal to what
    it saved, bitwise; the file's size and CRC32 those of the gathered
    vector's bytes, which a save on one process writes), the file in a
    git-ignored directory of the checkout, removed after; and an
    XParity(Full(24)) ``convert_state`` round trip, each rank's rows
    bitwise those of the same arithmetic on the gathered vector. Every
    rank must agree on its counts. Returns the record's fields."""
    import zlib
    import numpy as np
    import torch
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import localized, syk
    from dynamite_tpu_torch.parallel import mesh, multihost
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full, Parity, XParity

    L = 24
    H = localized(L)
    H.allow_projection = True
    sub = XParity(Full(L=L), '+')
    H.add_subspace(sub)
    before = exchanged()
    evals, xp_counts, xp_stats, xp_s = counted(
        lambda: eigsolve(H, nev=1), 'distributed eigsolve XParity(Full(24))')
    xp_lam = float(evals[0])
    xp_exchange = exchanged(before)
    if not (H.get_mat().engine == 'xor'
            and abs(xp_lam - xp_eval0) <= XPARITY_SHARDED_TOL):
        raise RuntimeError(f'distributed XParity(Full(24)): {xp_lam} '
                           f'against one device\'s {xp_eval0}')
    del H

    H = syk(16)
    ssub = Parity('even', L=16)
    H.add_subspace(ssub)
    evals, syk_counts, syk_stats, syk_s = counted(
        lambda: eigsolve(H, nev=1), 'distributed eigsolve syk(16)',
        engine='xor_dense')
    syk_lam = float(evals[0])
    kernel = H.get_mat()
    syk_rel = abs(syk_lam - EVAL0_SYK16) / abs(EVAL0_SYK16)
    if not (kernel.engine == 'xor_dense' and syk_rel <= EVAL0_SYK_RTOL):
        raise RuntimeError(f'distributed syk(16): {syk_lam} against the '
                           f'JAX package\'s {EVAL0_SYK16}')
    syk_la = kernel.xor_dense.La
    del H, kernel

    # the ground state's file, from the ranks
    tmp = os.path.join(REPO, '.smoke_states')
    os.makedirs(tmp, exist_ok=True)
    fname = os.path.join(tmp, 'full24_ground')
    save_s = time.perf_counter()
    v.save(fname)
    save_s = time.perf_counter() - save_s
    load_s = time.perf_counter()
    back = State.from_file(fname)
    load_s = time.perf_counter() - load_s
    rows_equal = bool(torch.equal(back.data, v.data))
    gathered = multihost.gather_rows(v.data, to_all=False,
                                     dim=len(v))
    file_ok = True
    if rank == 0:
        want = gathered.to('cpu', torch.float64).numpy()
        crc_want = zlib.crc32(want[1].tobytes(),
                              zlib.crc32(want[0].tobytes()))
        with open(fname + '.vec', 'rb') as f:
            crc = 0
            for block in iter(lambda: f.read(1 << 24), b''):
                crc = zlib.crc32(block, crc)
        size = os.path.getsize(fname + '.vec')
        file_ok = crc == crc_want and size == 2 * len(v) * 8
    multihost.barrier()
    if rank == 0:
        for ext in ('.vec', '.metadata'):
            os.remove(fname + ext)
        os.rmdir(tmp)

    # XParity(Full(24)) convert_state: to the sector and back; the same
    # arithmetic on the gathered vector, row by row
    xsub = XParity(v.subspace, '+')
    child = xsub.convert_state(v)
    parent = xsub.convert_state(child)
    full = multihost.gather_rows(v.data)
    half = len(child)
    flip = (1 << L) - 1
    idx = torch.arange(len(v), device=full.device)
    invsq2 = 1.0 / np.sqrt(2)
    c_all = full[:, :half].clone()
    c_all.add_(full[:, flip ^ idx[:half]], alpha=1)
    c_all = c_all * invsq2
    p_all = torch.cat([c_all, c_all[:, flip ^ idx[half:]]], dim=1) * invsq2
    convert_ok = (torch.equal(child.data, mesh.local_rows(c_all, half))
                  and torch.equal(parent.data, mesh.local_rows(p_all,
                                                               len(v))))
    checks = np.array([rows_equal, file_ok, convert_ok,
                       xp_stats['matvecs'], xp_counts['xor_apply'],
                       xp_counts['xor_diagonal'], syk_stats['matvecs'],
                       syk_counts['xor_dense_apply']])
    every = multihost.allgather_host_values(checks)
    if not (every[:, :3].all() and (every[:, 3:] == every[0, 3:]).all()):
        raise RuntimeError(f'distributed files, conversion or solves: '
                           f'{every}')
    if not (every[0, 4] >= xp_stats['matvecs'] > 0
            and every[0, 7] >= syk_stats['matvecs'] > 0):
        raise RuntimeError('a distributed solve did not run its route')
    return {'xparity_full24': {
                'eval0': xp_lam, 'one_device_eval0': xp_eval0,
                'eigsolve_s': xp_s, 'matvecs': xp_stats['matvecs'],
                'launches': xp_counts['xor_apply'],
                'exchanges': xp_exchange[0],
                'exchange_bytes': xp_exchange[1]},
            'xparity_launches_all_ranks': int(every[:, 4].sum()),
            'xparity_diag_builds_all_ranks': int(every[:, 5].sum()),
            'syk16': {'eval0': syk_lam, 'jax_eval0': EVAL0_SYK16,
                      'rel_err_vs_jax': syk_rel, 'La': syk_la,
                      'eigsolve_s': syk_s, 'matvecs': syk_stats['matvecs'],
                      'xor_dense_calls_all_ranks': int(every[:, 7].sum())},
            'state_file': {'save_s': save_s, 'load_s': load_s,
                           'bytes': 2 * len(v) * 8, 'rows_equal': True,
                           'crc_and_size_equal': True},
            'convert_state_bitwise': True}


def distributed_general(rank, world, L=24):
    """The general pairs on a distributed rank: eigsolve (with the ground
    state's half-chain entropy) and evolve of localized(24) on
    SpinConserve(24, 12), float32, through the sector engine's alpha ring
    and, with ``use_sector = False``, through each rank's ELL tables (at
    world 1, the one-device sector and ELL routes). Per route: the build's
    seconds, this rank's table bytes and device peak, the solves' seconds
    and matvecs, every rank's ELL launches, the all-gather's and the ring
    pass's calls and bytes per apply, and the ms of one apply and of the
    transport alone (CUDA events); then, over two ranks or more, whether
    SpinConserve(26, 13) fits ``config.ell_budget`` and what its ELL route
    costs. Checks lambda within EVAL0_AUTO_TOL of the JAX package's
    float64 value, the entropy within ENTROPY_TOL of its float64 value,
    the norm of psi(t) within 1e-3 of 1, the pad rows 0, and on every rank
    the same route and the same counts. Returns rank 0's view, the
    per-rank values gathered."""
    import numpy as np
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.computations import (eigsolve,
                                                 entanglement_entropy,
                                                 evolve)
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch import tracing
    from dynamite_tpu_torch.ops.ell import table_bytes
    from dynamite_tpu_torch.parallel import mesh, multihost
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import SpinConserve

    def counters():
        return np.array([tracing.counter(f'transport.{c}')
                         for c in ('all_gather_rows.calls',
                                   'all_gather_rows.bytes',
                                   'ring_pass.calls', 'ring_pass.bytes')])

    def table_mb(kernel):
        dt, dev = torch.float32, config.device
        if kernel.sharded is not None:
            return kernel.sharded.table_bytes(multihost.rank(), dt,
                                              dev) / 1e6
        if kernel.sector_plan is not None:
            return kernel.sector_plan.table_bytes / 1e6
        return kernel.ell_tables.nbytes(dt, dev) / 1e6

    out = {'L': L, 'routes': {}}
    for route, use_sector in (('sector_ring', True), ('ell', False)):
        config.use_sector = use_sector
        H = localized(L)
        sub = SpinConserve(L, L // 2)
        H.add_subspace(sub)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        kernel = H.get_mat()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        want = route if world > 1 else {'sector_ring': 'sector',
                                         'ell': 'ell'}[route]
        if kernel.engine != want:
            raise RuntimeError(f'{route} over {world} ranks: the '
                               f'{kernel.engine} route')
        build_peak = torch.cuda.max_memory_allocated() - mem0
        c0 = counters()
        (evals, evecs), eig_launches, eig_stats, eig_s = counted(
            lambda: eigsolve(H, nev=1, getvecs=True),
            f'{route} eigsolve over {world} ranks', engine=want)
        c_eig = counters() - c0
        lam = float(evals[0])
        S = float(entanglement_entropy(evecs[0], keep=range(L // 2)))
        psi = State(state='random', subspace=sub, seed=42)
        c0 = counters()
        r, ev_launches, ev_stats, ev_s = counted(
            lambda: evolve(H, psi, t=1.0), f'{route} evolve over {world} '
            'ranks', engine=want)
        c_ev = counters() - c0
        nrm = r.norm()
        peak = torch.cuda.max_memory_allocated() - mem0
        pads = bool((r.data[:, mesh.valid_rows(sub.get_dimension()):] == 0)
                    .all())
        x = r.data.clone()
        apply_ms = cuda_ms(lambda: kernel.apply(x))
        transport_ms = None
        if world > 1:
            transport_ms = cuda_ms(lambda: all_gather_rows(x)) \
                if route == 'ell' else cuda_ms(lambda: ring_pass(x))
        mine = np.array([eig_stats['matvecs'], ev_stats['matvecs'],
                         eig_launches['ell_apply'], ev_launches['ell_apply'],
                         table_mb(kernel), peak / 1e6, build_peak / 1e6,
                         *c_eig, *c_ev, int(pads)], dtype=np.float64)
        every = multihost.allgather_host_values(mine)
        if not (every[:, :4] == every[0, :4]).all():
            raise RuntimeError(f'{route}: ranks disagree on their solves: '
                               f'{every[:, :4]}')
        rec = {'engine': kernel.engine, 'build_s': build_s,
               'eigsolve_s': eig_s, 'eval0': lam,
               'eval0_err': abs(lam - EVAL0_SC24_F64),
               'eigsolve_matvecs': eig_stats['matvecs'],
               'entropy_half_chain': S, 'entropy_err': abs(S - ENTROPY_SC24),
               'evolve_s': ev_s, 'evolve_matvecs': ev_stats['matvecs'],
               'norm': nrm, 'pads_zero_all_ranks': bool(every[:, -1].all()),
               'ell_launches_per_rank': every[:, 2:4].sum(1).tolist(),
               'ell_launches_all_ranks': int(every[:, 2:4].sum()),
               'table_mb_per_rank': every[:, 4].tolist(),
               'peak_mb_per_rank': every[:, 5].tolist(),
               'build_peak_mb_per_rank': every[:, 6].tolist(),
               'eigsolve_gathers_bytes_passes_bytes': every[0, 7:11].tolist(),
               'evolve_gathers_bytes_passes_bytes': every[0, 11:15].tolist(),
               'apply_ms': apply_ms, 'transport_ms': transport_ms}
        matvecs = eig_stats['matvecs'] + ev_stats['matvecs']
        if world > 1:
            rec['transport_bytes_per_apply'] = (
                (c_eig[1] + c_ev[1]) if route == 'ell'
                else (c_eig[3] + c_ev[3])) / matvecs
        out['routes'][route] = rec
        if not (rec['eval0_err'] <= EVAL0_AUTO_TOL
                and rec['entropy_err'] <= ENTROPY_TOL
                and abs(nrm - 1) <= 1e-3 and rec['pads_zero_all_ranks']):
            if rank == 0:
                emit({'phase': 'distributed_general', 'world_size': world,
                      'record': out})
            raise RuntimeError(f'{route} over {world} ranks: lambda {lam}, '
                               f'entropy {S}, norm {nrm}')
        del H, kernel, evals, evecs, psi, r, x
        torch.cuda.empty_cache()
    config.use_sector = True

    # SpinConserve(26, 13) through the ELL route
    H = localized(L + 2)
    sub = SpinConserve(L + 2, L // 2 + 1)
    H.add_subspace(sub)
    from dynamite_tpu_torch.ops.apply import _Plan
    plan = _Plan(H._msc_on(sub), sub, sub)
    need = table_bytes(plan, mesh.storage_dim(plan.dim_left))
    l26 = {'dim': plan.dim_left, 'ell_budget': config.ell_budget,
           'padded_table_bytes': need, 'fits': need <= config.ell_budget}
    if world > 1 and l26['fits']:
        config.use_sector = False
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        kernel = H.get_mat()
        torch.cuda.synchronize()
        l26['build_s'] = time.perf_counter() - t0
        (evals, _v), launches, stats, l26['eigsolve_s'] = counted(
            lambda: eigsolve(H, nev=1, getvecs=True),
            'SpinConserve(26, 13) over ranks', engine='ell')
        l26.update(engine=kernel.engine, eval0=float(evals[0]),
                   eigsolve_matvecs=stats['matvecs'])
        mine = np.array([table_mb(kernel),
                         (torch.cuda.max_memory_allocated() - mem0) / 1e6,
                         launches['ell_apply']])
        every = multihost.allgather_host_values(mine)
        l26.update(table_mb_per_rank=every[:, 0].tolist(),
                   peak_mb_per_rank=every[:, 1].tolist(),
                   ell_launches_all_ranks=int(every[:, 2].sum()))
        config.use_sector = True
        del kernel, evals, _v
    out['spinconserve_26'] = l26
    del H
    torch.cuda.empty_cache()
    return out


def child_distributed(rank, world, port, full=1, xp_eval0=None):
    """One rank of the distributed phase: NCCL, one GPU per rank, float32.
    With ``full``, evolve and eigsolve of localized(24) on Full(24) through
    the XOR route (:func:`distributed_full`); then the general pairs
    (:func:`distributed_general`). With ``port`` 0, a rank of an emulated
    node (phase ``multinode``): ``multihost.initialize()`` with no
    arguments, so the launcher's environment that :func:`spawn_distributed`
    set starts the group."""
    require_card_and_port()
    import faulthandler
    import torch
    import torch.distributed as dist
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.parallel import multihost

    faulthandler.enable()  # stacks on SIGABRT, when the parent times out
    config.precision = 'single'
    if port:
        multihost.initialize(rank=rank, world_size=world,
                             init_method=f'tcp://localhost:{port}')
    else:
        multihost.initialize()
    if (multihost.rank(), multihost.world_size()) != (rank, world):
        raise RuntimeError(f'rank {rank} of {world} started as '
                           f'{multihost.rank()} of {multihost.world_size()}')
    # NCCL itself, once: the ranks' ones summed
    one = torch.ones(1, device=config.device)
    dist.all_reduce(one)
    if float(one) != world:
        raise RuntimeError(f'NCCL all_reduce gave {float(one)}, not {world}')
    launch = multihost.detect_launch()
    me = {'rank': rank, 'host_id': os.environ.get('NCCL_HOSTID'),
          'launcher': None if launch is None else launch.launcher,
          'local_rank': config.device.index,
          'visible_devices': os.environ.get('CUDA_VISIBLE_DEVICES'),
          'cwd': os.getcwd()}
    ranks = [None] * world
    dist.all_gather_object(ranks, me)

    out = {'phase': 'distributed' if port else 'multinode',
           'backend': dist.get_backend(), 'world_size': world,
           'ranks': ranks}
    if full:
        out.update(distributed_full(rank, world, xp_eval0))
    out['general'] = distributed_general(rank, world)
    if rank == 0:
        emit(out)
    multihost.barrier('done')
    multihost.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _free_slurm_port():
    """A port free now in 61440-65535, where jax.distributed (and
    ``multihost.detect_launch``) put a SLURM job's coordinator, by its job
    id: the job id is chosen to map to it."""
    import random
    for port in random.sample(range(SLURM_PORT_BASE, 65536), 200):
        with socket.socket() as s:
            try:
                s.bind(('', port))
            except OSError:
                continue
            return port
    raise RuntimeError('no free port in 61440-65535')


def phase_distributed(xp_eval0):
    """One child process per GPU (the largest power of two of them), on
    NCCL (:func:`child_distributed`; ``xp_eval0`` the one-device λ of
    XParity(Full(24)) that its solve over ranks is held against), and with
    three GPUs or more a second spawn at world 3 (the padded layout;
    general pairs only); returns rank 0's records."""
    import torch
    n_gpus = torch.cuda.device_count()
    recs = [spawn_distributed(1 << (n_gpus.bit_length() - 1), full=1,
                              xp_eval0=xp_eval0)]
    if n_gpus >= 3:
        recs.append(spawn_distributed(3, full=0))
    return recs


def spawn_distributed(world, full, xp_eval0=0.0, nodes=1):
    """Run :func:`child_distributed` on ``world`` ranks; returns rank 0's
    record. With ``nodes`` = 2, the ranks are two emulated nodes of
    ``world // 2`` cards each (:func:`multinode_env`), and each rank's
    record gains the links NCCL logged (:func:`nccl_links`)."""
    import torch
    per_node = world // nodes
    port = _free_slurm_port() if nodes > 1 else _free_port()
    torch.cuda.empty_cache()
    procs, logs = [], []
    for rank in range(world):
        if nodes > 1:
            env, cwd, log = multinode_env(rank, world, per_node, port)
            logs.append(log)
        else:
            # the card: cuda:{rank % device_count}, rank's own here
            env, cwd = dict(os.environ), None
            env.setdefault('NCCL_SOCKET_IFNAME', 'lo')
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), CHILD_DIST,
             str(rank), str(world), str(port if nodes == 1 else 0),
             str(full), repr(xp_eval0)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=cwd))
    deadline = time.monotonic() + DIST_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        # every rank's Python stacks (faulthandler, on SIGABRT), then out
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)
        for rank, p in enumerate(procs):
            err = p.communicate()[1]
            sys.stderr.write(f'-- rank {rank} of {world}:\n{err[-20000:]}')
        raise RuntimeError(f'distributed ranks ({world}, {nodes} node(s)) '
                           f'did not end within {DIST_TIMEOUT_S} s')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        sys.stderr.write(err)
        if p.returncode != 0:
            raise RuntimeError(f'distributed rank {rank} of {world} failed '
                               f'(exit code {p.returncode})')
    lines = outs[0][0].strip().splitlines()
    rec = json.loads(lines[-1])
    if rec['phase'] != ('distributed' if nodes == 1 else 'multinode'):
        raise RuntimeError('the distributed phase printed no record')
    for r, log in enumerate(logs):
        with open(log) as f:
            rec['ranks'][r].update(nccl_links(f.read()))
    for line in lines[:-1]:
        print(line, flush=True)
    emit(rec)
    return rec


# how long the ranks of one distributed spawn may take together
DIST_TIMEOUT_S = 420
# phase multinode: where the emulated nodes keep their working directories
# (git-ignored, removed after the phase), and where NCCL's log of each rank
# goes (one file a rank, git-ignored, kept)
NODES_DIR = os.path.join(REPO, '.smoke_nodes')
NCCL_LOG_DIR = os.path.join(REPO, '.smoke_nccl')
SLURM_PORT_BASE = 61440


def multinode_env(rank, world, per_node, port):
    """The environment, working directory and NCCL log file of ``rank`` on
    two nodes emulated on this host: SLURM's srun variables (the job id
    the one that maps to ``port``, the node list this host by two names),
    the node's own ``CUDA_VISIBLE_DEVICES`` block with local ranks from 0,
    its own ``NCCL_HOSTID``, working directory and ``TMPDIR``. NCCL takes
    ranks of two host ids for two hosts and carries their traffic over its
    network transport: InfiniBand off, the socket transport asked for and
    its sockets on the loopback, so NET/Socket whatever NICs and network
    plugins the machine has; inside a node P2P stays on."""
    node, local = divmod(rank, per_node)
    home = os.path.join(NODES_DIR, f'node{node}')
    os.makedirs(os.path.join(home, 'tmp'), exist_ok=True)
    os.makedirs(NCCL_LOG_DIR, exist_ok=True)
    log = os.path.join(NCCL_LOG_DIR, f'rank{rank}.log')
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(('SLURM_', 'OMPI_', 'MASTER_'))
           and k not in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK')}
    env.update(SLURM_JOB_ID=str(port - SLURM_PORT_BASE),
               SLURM_STEP_NODELIST='localhost,127.0.0.1',
               SLURM_STEP_NUM_NODES='2', SLURM_NODEID=str(node),
               SLURM_NTASKS=str(world), SLURM_PROCID=str(rank),
               SLURM_LOCALID=str(local), TMPDIR=os.path.join(home, 'tmp'),
               CUDA_VISIBLE_DEVICES=','.join(
                   str(node * per_node + i) for i in range(per_node)),
               NCCL_HOSTID=f'node{node}', NCCL_IB_DISABLE='1',
               NCCL_NET='Socket', NCCL_SOCKET_IFNAME='lo', NCCL_DEBUG='INFO',
               NCCL_DEBUG_SUBSYS='INIT,P2P', NCCL_DEBUG_FILE=log)
    return env, home, log


_NCCL_LINK = re.compile(r' \d+\[[^\]]*\] -> \d+\[[^\]]*\]'
                        r'(?: \[(?:send|receive)\])? via (\S+)')
_NCCL_COMM = re.compile(r'nRanks (\d+) nNodes (\d+)')


def nccl_links(log):
    """What a rank's ``NCCL_DEBUG=INFO`` log says of its links: the
    transports NCCL connected it by (``NET/Socket``, ``P2P/CUMEM``, ...),
    and (ranks, nodes) of each communicator it joined (torch adds one of
    two ranks for the point-to-point pairs). A link line names ranks
    within its communicator, not globally, so it does not say which node
    a peer is on: with one card a node every link is between nodes."""
    kinds = {'/'.join(via.split('/')[:2]) for via in _NCCL_LINK.findall(log)}
    comms = {(int(n), int(k)) for n, k in _NCCL_COMM.findall(log)}
    return {'transports': sorted(kinds),
            'nccl_comms_ranks_nodes': sorted(comms)}


# phase multinode against phase distributed: the λ of each solve within the
# tolerance phase distributed holds its solves over ranks to against one
# device (XPARITY_SHARDED_TOL); NCCL sums in another order over its network
# transport, so not bitwise
MULTINODE_EVAL_TOL = XPARITY_SHARDED_TOL


def phase_multinode(dist_rec, xp_eval0, card):
    """Phase distributed's main path again (:func:`distributed_full` at
    L=24 with the XParity and syk(16) solves, the 268 MB state file and
    ``convert_state``, then :func:`distributed_general`'s SpinConserve(24,
    12) solves by the alpha ring and by ELL), on two nodes emulated on this
    host (:func:`multinode_env`: 2 nodes x 2 cards on four, 2 x 1 on two),
    each rank started by ``multihost.initialize()`` from SLURM's
    environment alone. Checks that NCCL saw two nodes and carried the
    traffic between them over NET/Socket (inside a node over P2P), that
    every rank launched the XOR, diagonal and ELL kernels, and that each λ
    agrees with ``dist_rec``'s (phase distributed at world 2 or 4, NVLink)
    within MULTINODE_EVAL_TOL (the child holds each to phase distributed's
    own checks, the file's CRC32 to the gathered vector's among them);
    records the transports' ms and the solves' seconds over NET/Socket
    beside NVLink's. Needs two cards: on one it says so and runs nothing.
    Returns rank 0's record, or None."""
    import shutil
    import torch
    n_gpus = torch.cuda.device_count()
    if n_gpus < 2:
        emit({'phase': 'multinode', 'ran': False,
              'why': f'needs two cards (two emulated nodes of one card '
                     f'each at least); this machine has {n_gpus}'})
        return None
    per_node = 2 if n_gpus >= 4 else 1
    try:
        rec = spawn_distributed(2 * per_node, full=1, xp_eval0=xp_eval0,
                                nodes=2)
    finally:
        shutil.rmtree(NODES_DIR, ignore_errors=True)
    faults = []
    for r in rec['ranks']:
        node = r['rank'] // per_node
        if (r['host_id'], r['launcher'], r['local_rank']) != \
                (f'node{node}', 'slurm', r['rank'] % per_node):
            faults.append(f'rank {r["rank"]}: {r}')
        # the world's communicator spans two nodes; the links are
        # NET/Socket (between the nodes) and, with two cards a node, P2P
        # (inside one); nothing else (SHM, or P2P between the nodes,
        # would mean NCCL took them for one host)
        world_nodes = {k for n, k in r['nccl_comms_ranks_nodes']
                       if n == len(rec['ranks'])}
        p2p = [t for t in r['transports'] if t.startswith('P2P/')]
        if world_nodes != {2} or 'NET/Socket' not in r['transports'] or \
                set(r['transports']) - {'NET/Socket', *p2p} or \
                bool(p2p) != (per_node > 1):
            faults.append(f'rank {r["rank"]} links: {r}')
    gen = rec['general']['routes']
    if not (min(rec['launches_per_rank']) > 0
            and min(rec['diag_builds_per_rank']) > 0
            and min(gen['ell']['ell_launches_per_rank']) > 0):
        faults.append('a rank launched no XOR, diagonal or ELL kernel')
    more, dmore = rec['xor_more'], dist_rec['xor_more']
    pairs = {'full24': (rec['eval0'], dist_rec['eval0']),
             'xparity_full24': (more['xparity_full24']['eval0'],
                                dmore['xparity_full24']['eval0']),
             'syk16': (more['syk16']['eval0'], dmore['syk16']['eval0'])}
    for route in ('sector_ring', 'ell'):
        pairs[f'sc24_{route}'] = (gen[route]['eval0'],
                                  dist_rec['general']['routes'][route]
                                  ['eval0'])
    diffs = {k: abs(a - b) for k, (a, b) in pairs.items()}
    if not max(diffs.values()) <= MULTINODE_EVAL_TOL:
        faults.append(f'eigenvalues off phase distributed\'s: {diffs}')

    def side(r):
        g = r['general']['routes']
        return {'world': r['world_size'],
                'exchange_ms': r['exchange_ms'],
                'all_gather_ms': g['ell']['transport_ms'],
                'ring_pass_ms': g['sector_ring']['transport_ms'],
                'full24_evolve_s': r['evolve_s'],
                'full24_eigsolve_s': r['eigsolve_s'],
                'xparity_full24_eigsolve_s':
                    r['xor_more']['xparity_full24']['eigsolve_s'],
                'syk16_eigsolve_s': r['xor_more']['syk16']['eigsolve_s'],
                'state_file_save_s': r['xor_more']['state_file']['save_s'],
                'state_file_load_s': r['xor_more']['state_file']['load_s'],
                **{f'sc24_{k}_{q}': g[k][q] for k in ('sector_ring', 'ell')
                   for q in ('eigsolve_s', 'evolve_s', 'apply_ms')}}
    out = {'phase': 'multinode_vs_distributed', 'nodes': 2,
           'ranks_per_node': per_node, 'nvidia_smi': card,
           'ranks': rec['ranks'], 'eval0_abs_diff_vs_distributed': diffs,
           'net_socket': side(rec), 'nvlink_distributed': side(dist_rec),
           'launches_per_rank': rec['launches_per_rank'],
           'diag_builds_per_rank': rec['diag_builds_per_rank'],
           'ell_launches_per_rank': gen['ell']['ell_launches_per_rank'],
           'state_file': rec['xor_more']['state_file']}
    emit(out)
    if faults:
        raise RuntimeError('phase multinode: ' + '; '.join(faults))
    return rec


def multinode_only():
    """``python3 chip_smoke.py --multinode``: the environment, the
    one-device λ of XParity(Full(24)) the ranks' solves are held to, phase
    distributed at the largest power-of-two world of the cards, and phase
    multinode beside it."""
    require_card_and_port()
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.computations import eigsolve
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.subspaces import Full, XParity
    config.precision = 'single'
    config._initialize()
    card = phase_env()
    H = localized(24)
    H.allow_projection = True
    H.add_subspace(XParity(Full(L=24), '+'))
    xp_eval0 = float(eigsolve(H, nev=1)[0])
    del H
    torch.cuda.empty_cache()
    n_gpus = torch.cuda.device_count()
    seconds = {}
    t0 = time.perf_counter()
    dist_rec = spawn_distributed(1 << (n_gpus.bit_length() - 1), full=1,
                                 xp_eval0=xp_eval0)
    seconds['phase_distributed'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_multinode(dist_rec, xp_eval0, card)
    seconds['phase_multinode'] = time.perf_counter() - t0
    emit({'phase_seconds': seconds})


EXAMPLE_SCRIPTS = {'floquet': 'floquet/run_floquet.py',
                   'kagome': 'kagome/run_kagome.py',
                   'mbl': 'mbl/run_mbl.py',
                   'syk': 'syk/run_syk.py',
                   'sharded': 'sharded_spinconserve/run_sharded_torch.py'}
# phase examples: the floquet runs against each other and against the JAX
# package's float64 lines (tests/torch_examples_reference.py), the mbl
# target line against numpy.linalg.eigh, kagome '24''s E0 against the JAX
# package's float64 value (printed to 12 decimals)
EXAMPLE_TOL = 1e-10
MBL_TOL = 1e-8
KAGOME_TOL = 1e-9


def _arg(args, flag, default=None):
    return args[args.index(flag) + 1] if flag in args else default


def child_example(name, args):
    """``chip_smoke.py --child-example NAME ARGS...``: one example script
    on the card in this fresh process (the scripts set the port's
    globals): the JAX package's script through the package switch
    (``dynamite_tpu_torch.switch.run_script``), or the port's own
    ``run_sharded_torch.py`` (its ``main``). Emits one JSON line: the
    script's output lines, the launch counters (0 at the start), the
    device peak, the RuntimeWarnings caught, whether ``jax`` was imported,
    and for mbl the last solve's stats (the target solve), the numpy
    oracle of its energy point 0.5 line and the ms of one apply of its
    Hamiltonian on both routes (:func:`_mbl_apply_ms`)."""
    require_card_and_port()
    import contextlib
    import importlib.util
    import io
    import warnings
    import torch
    from dynamite_tpu_torch import computations, switch

    path = os.path.join(REPO, 'examples', 'scripts', EXAMPLE_SCRIPTS[name])
    if name == 'mbl':
        # SpinConserve pairs through the ELL kernel, one launch an apply:
        # mid-spectrum MINRES takes ~500,000 applies at L=14, and the
        # sector engine (the script's default route) is launch-bound at
        # such sizes, ~70x the ELL kernel's time an apply at L=14
        # (recorded in apply_ms): the script would take ~15 min there
        from dynamite_tpu_torch import config
        config.use_sector = False
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    result = None
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            contextlib.redirect_stdout(buf):
        warnings.simplefilter('always')
        if name == 'sharded':
            spec = importlib.util.spec_from_file_location('run_sharded_torch',
                                                          path)
            script = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(script)
            result = script.main(args)
        else:
            switch.run_script(path, args)
    torch.cuda.synchronize()
    rec = {'example': name, 'args': args,
           'seconds': time.perf_counter() - t0,
           'lines': buf.getvalue().splitlines(),
           'launches': _launch_counts(),
           'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
           'runtime_warnings': [str(w.message) for w in caught
                                if issubclass(w.category, RuntimeWarning)],
           'jax_imported': 'jax' in sys.modules,
           'result': result}
    if name == 'mbl':
        stats = computations.last_solve_stats
        rec['target_solve'] = {
            k: stats.get(k) for k in (
                'minres_solves', 'minres_iterations', 'minres_max_iterations',
                'minres_max_rel_residual', 'minres_unconverged', 'matvecs',
                'candidates_s', 'extract_s')}
        from tests.torch_examples_reference import mbl_line
        L, seed = int(_arg(args, '-L')), int(_arg(args, '--seed'), 0)
        rec['eigh_line'] = mbl_line(L, seed, int(_arg(args, '--nev', 8)))
        rec['apply_ms'] = _mbl_apply_ms(L, seed)
    emit(rec)


def _mbl_apply_ms(L, seed, reps=200):
    """ms of one warm apply of the MBL example's Hamiltonian (``-L L --seed
    seed``, float64) on the card by the sector engine, the script's
    default route, and by the ELL kernel, the route phase ``examples``
    runs it through (CUDA events over ``reps`` applies after 3)."""
    import torch
    from dynamite_tpu_torch import config
    from tests.torch_examples_reference import mbl_hamiltonian
    out = {}
    for route, use_sector in (('sector', True), ('ell', False)):
        config.use_sector = use_sector
        H = mbl_hamiltonian(L, seed)
        kernel = H.get_mat(subspaces=(H.subspace, H.subspace))
        if kernel.engine != route:
            raise RuntimeError(f'mbl L={L}: the {kernel.engine} route, not '
                               f'{route}')
        x = torch.randn((2, H.subspace.get_dimension()),
                        dtype=config.real_dtype, device=config.device)
        for _ in range(3):
            kernel.apply(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernel.apply(x)
        end.record()
        torch.cuda.synchronize()
        out[route] = start.elapsed_time(end) / reps
    return out


def run_example(name, *args, timeout=900):
    """:func:`child_example` in a child process; returns its record."""
    import torch
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), CHILD_EXAMPLE, name,
         *map(str, args)],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)
    sys.stderr.write(proc.stderr[-3000:])
    if proc.returncode != 0:
        raise RuntimeError(f'example {name} {list(args)} failed (exit code '
                           f'{proc.returncode})')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _numbers(lines):
    """The numbers of an example's CSV rows (header lines left out)."""
    import numpy as np
    return np.array([line.split(',') for line in lines
                     if line and not line[0].isalpha()], dtype=float)


def _check(ok, what, recs):
    if not ok:
        emit({'phase': 'examples', 'runs': recs})
        raise RuntimeError(f'phase examples: {what}')


def phase_examples():
    """The JAX package's example scripts on the card through the package
    switch, and the port of the sharded one, each in its own process
    (:func:`child_example`), at the scripts' default sizes or more:

    * floquet at L=24 (Full(24), float64): 6 cycles with a checkpoint every
      3 into a temporary directory, resumed to 9, against an uninterrupted
      9-cycle run (1e-10), through the XOR kernel and the diagonal stream
      (launches > 0); and at L=16 against the JAX package's float64 lines
      (``tests/torch_examples_reference.py``, 1e-10);
    * kagome '24' (XParity(SpinConserve(24, 12)), dim 1,352,078): E0
      against the JAX package's float64 value (1e-9);
    * mbl at L=12 (dim 924), seed 7, through the ELL kernel: every inner
      MINRES solve of the target solve converged, no RuntimeWarning, the
      energy point 0.5 line against numpy.linalg.eigh (1e-8); with the ms
      of one apply by the sector engine, the script's default route;
    * syk at N=32: C finite, the Majoranas' Parity pairs through the XOR
      kernel (launches > 0);
    * run_sharded_torch.py at L=30 (SpinConserve(30, 15), dim 155,117,520)
      over 4 virtual ranks through the alpha ring: the exact Neel column
      and the product against the one-device sector engine's (its tables
      from the ring's sector plan);
    * the profiler: eigsolve(localized(20)) on Full(20) with
      ``config.profile_dir`` set leaves a trace naming ``xor_apply_kernel``.

    The runs go in four lanes at once (floquet; mbl and kagome; the
    sharded example; syk), each lane's runs one after another: each run
    is a process that takes ~11 s to start, mbl's solve is bound by the
    host's launches and syncs, the sharded example's and syk's by their
    host builds, so the lanes share the card and the host's cores. A run's
    seconds therefore include its share of both. No run is timed for a
    kernel. Returns the phase's record."""
    import glob
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from tests.torch_examples_reference import FLOQUET_L16, KAGOME_24_E0

    def lane_floquet():
        with tempfile.TemporaryDirectory() as tmp:
            runs = [run_example('floquet', '-L', 24, '--n-cycles', 9),
                    run_example('floquet', '-L', 24, '--n-cycles', 6,
                                '--checkpoint-every', 3,
                                '--checkpoint-path', tmp),
                    run_example('floquet', '-L', 24, '--n-cycles', 9,
                                '--checkpoint-every', 3,
                                '--checkpoint-path', tmp)]
        return runs + [run_example('floquet', '-L', 16, '--n-cycles', 3)]

    # L=12, not 14: L=14's mid-spectrum solve (167-173 s on one H100) was
    # the phase's long pole, and phase cards now follows it in the
    # script's time
    def lane_mbl_kagome():
        return [run_example('mbl', '-L', 12, '--iters', 1, '--h-points', 1,
                            '--energy-points', 3, '--seed', 7),
                run_example('kagome', '24')]

    def lane_sharded():
        # the script itself raises unless it took the alpha ring, its Neel
        # column is exact (1e-6), its product is the one-device engine's
        # (1e-5) and its Ritz values are finite
        return [run_example('sharded', '-L', 30, '--virtual', 4, '-m', 2,
                            '--vs-one-device')]

    def lane_syk():
        return [run_example('syk', '-N', 32, '-b', 0.5, '-t', 0.5,
                            '--seed', 5)]

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        lanes = [pool.submit(f) for f in (lane_floquet, lane_mbl_kagome,
                                          lane_sharded, lane_syk)]
    floquet, (mbl, kagome), (sharded,), (syk,) = [lane.result()
                                                  for lane in lanes]
    # the records' order: floquet x4, kagome, mbl, sharded, syk
    runs = floquet + [kagome, mbl, sharded, syk]
    lanes_s = time.perf_counter() - t0
    recs = [{k: v for k, v in rec.items() if k != 'lines'} for rec in runs]
    whole, part, resumed, fl16, kagome, mbl, _sharded, syk = runs
    for rec in runs:
        _check(not rec['jax_imported'], f"{rec['example']} imported jax",
               recs)

    want = _numbers(whole['lines'])
    got = np.concatenate([_numbers(part['lines']),
                          _numbers(resumed['lines'])])
    err = float(np.max(np.abs(got - want))) if got.shape == want.shape \
        else float('inf')
    recs[2]['resume_max_abs_err'] = err
    _check(err <= EXAMPLE_TOL and want.shape == (10, 27),
           f'floquet L=24 resumed {err:.3e} from the uninterrupted run',
           recs)
    for rec in (whole, part, resumed):
        _check(rec['launches']['xor_apply'] > 0
               and rec['launches']['xor_diagonal'] > 0,
               'floquet launched no XOR or diagonal kernel', recs)

    err = float(np.max(np.abs(_numbers(fl16['lines'])
                              - _numbers(FLOQUET_L16.splitlines()))))
    recs[3]['vs_jax_max_abs_err'] = err
    _check(err <= EXAMPLE_TOL, f'floquet L=16 {err:.3e} from the JAX '
           "package's lines", recs)

    e0 = next(float(line.split()[2]) for line in kagome['lines']
              if line.startswith('E0 = '))
    err = abs(e0 - KAGOME_24_E0)
    recs[4]['e0_vs_jax_abs_err'] = err
    _check(err <= KAGOME_TOL, f'kagome 24: E0 {e0!r} off by {err:.3e}', recs)

    line = next(line for line in mbl['lines'] if ', 0.5, ' in line)
    got = [float(x) for x in line.split(',')[2:]]
    err = float(np.max(np.abs(np.subtract(got, mbl['eigh_line']))))
    stats = mbl['target_solve']
    recs[5]['vs_eigh_max_abs_err'] = err
    _check(err <= MBL_TOL and stats['minres_unconverged'] == 0
           and not mbl['runtime_warnings']
           and mbl['launches']['ell_apply'] > 0,
           f'mbl L=12: {err:.3e} from eigh, {stats["minres_unconverged"]} '
           f'inner solves unconverged, warnings {mbl["runtime_warnings"]}',
           recs)

    c = _numbers(syk['lines'])[:, 2]
    _check(c.size == 1 and np.isfinite(c).all()
           and syk['launches']['xor_apply'] > 0,
           f'syk N=32: C {c}, launches {syk["launches"]}', recs)

    # the profiler: the trace of a solve on the card names the kernel
    from dynamite_tpu_torch import config, models
    from dynamite_tpu_torch.subspaces import Full
    H = models.localized(20)
    H.add_subspace(Full(20))
    with tempfile.TemporaryDirectory() as tmp:
        config.profile_dir = tmp
        try:
            H.eigsolve(nev=1)
        finally:
            config.profile_dir = None
        traces = glob.glob(os.path.join(tmp, 'eigsolve_rank0.*.json'))
        names = set()
        for path in traces:
            with open(path) as f:
                names.update(e.get('name', '')
                             for e in json.load(f)['traceEvents'])
    profile = {'traces': len(traces),
               'kernel_events': sorted(n for n in names if 'xor_' in n)}
    _check(len(traces) == 1
           and any('xor_apply_kernel' in n for n in names),
           f'the profiler trace: {profile}', recs)
    out = {'phase': 'examples', 'runs': recs, 'lanes_s': lanes_s,
           'profile': profile}
    emit(out)
    # the one-card output phase cards is held to
    return dict(out, lines={'floquet24': whole['lines'],
                            'kagome24': kagome['lines']})


def _launch_counts():
    """The hand kernels' launch counters (see the kernels line)."""
    from dynamite_tpu_torch import tracing
    return {key: tracing.counter(COUNTERS[key])
            for key in ('xor_apply', 'xor_diagonal', 'ell_apply')}


def child_reference_suite():
    """``chip_smoke.py --child-reference-suite``: the reference's UNCHANGED
    test files through the switch's ``--pytest`` mode on the card, in this
    fresh process (the tests set the port's globals); the (c) exclusions
    deselected. Prints pytest's output with the switch's line per file,
    then the launch counters (0 at the start) as the last line; exits with
    pytest's code."""
    require_card_and_port()
    from dynamite_tpu_torch import switch
    from tests.torch_reference_suite import EXCLUDED, UNCHANGED
    args = [os.path.join('tests', rel) for rel in UNCHANGED]
    for nodeid in EXCLUDED:
        args += ['--deselect', os.path.join('tests', nodeid)]
    rc = switch.main(['--cards', '1', '--pytest', *args, '-q', '-p',
                      'no:randomly'])
    emit({'launches': _launch_counts()})
    sys.exit(rc)


def phase_reference_suite():
    """The JAX package's own tests on the card: every UNCHANGED file of
    ``tests/torch_reference_suite.py``, unchanged, through the package
    switch in one child process (:func:`child_reference_suite`). Emits one
    line per file (collected, passed, skipped, failed, excluded, seconds)
    and one with the hand kernels' launches during the run; fails unless
    every test passed (passed = collected - skipped - excluded) and the
    XOR, diagonal and ELL kernels each launched, that is the reference's
    cases reached the kernels. Returns the phase's record."""
    from tests.torch_reference_suite import UNCHANGED
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           CHILD_REFERENCE], capture_output=True, text=True,
                          timeout=900, cwd=REPO)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    files = [json.loads(line) for line in lines
             if line.startswith('{"reference_file"')]
    for rec in files:
        emit({'phase': 'reference_suite', **rec})
    launches = json.loads(lines[-1])['launches'] if lines and \
        lines[-1].startswith('{"launches"') else None
    out = {'phase': 'reference_suite', 'files': len(files),
           'passed': sum(r['passed'] for r in files),
           'skipped': sum(r['skipped'] for r in files),
           'excluded': sum(r['excluded'] for r in files),
           'pytest_exit': proc.returncode, 'launches': launches,
           'seconds': seconds}
    emit(out)
    ok = (proc.returncode == 0 and len(files) == len(UNCHANGED)
          and all(r['failed'] == 0 and r['passed'] == r['collected']
                  - r['skipped'] - r['excluded'] for r in files)
          and launches is not None and all(launches.values()))
    if not ok:
        sys.stderr.write(proc.stdout[-12000:] + proc.stderr[-4000:])
        raise RuntimeError(f'phase reference_suite: {out}')
    return dict(out, file_records=files)


def child_notebook(name, device):
    """``chip_smoke.py --child-notebook NB [cpu]``: one tutorial notebook
    through the switch's ``--notebook`` mode, on the card or on the CPU, in
    this fresh process. Emits one JSON line: its output lines, the
    seconds, the device peak and the launch counters (0 at the start)."""
    require_card_and_port()
    import contextlib
    import io
    import torch
    from dynamite_tpu_torch import switch
    card = device is None
    if card:
        torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        switch.run_notebook(os.path.join(REPO, 'examples', 'tutorial', name),
                            device=device)
    if card:
        torch.cuda.synchronize()
    emit({'notebook': name, 'device': device or 'cuda',
          'seconds': time.perf_counter() - t0,
          'peak_gb': torch.cuda.max_memory_allocated() / 1e9 if card
          else None,
          'launches': _launch_counts(), 'jax_imported': 'jax' in sys.modules,
          'output': buf.getvalue()})


def run_notebook_child(name, device=None, timeout=900):
    """:func:`child_notebook` in a child process (one thread on the CPU);
    returns its record."""
    args = [sys.executable, os.path.abspath(__file__), CHILD_NOTEBOOK, name]
    env = dict(os.environ, OMP_NUM_THREADS='1') if device else None
    proc = subprocess.run(args + ([device] if device else []),
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, env=env)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise RuntimeError(f'notebook {name} on {device or "cuda"} failed '
                           f'(exit code {proc.returncode})')
    return json.loads(proc.stdout.strip().splitlines()[-1])


def start_tutorial_cpu(pool):
    """The tutorial notebooks' CPU runs of phase tutorial, started on
    ``pool`` (they use no card, so they run beside phase reference_suite),
    the slowest first; returns their futures by notebook."""
    from tests.torch_tutorial_reference import NOTEBOOKS
    order = sorted(NOTEBOOKS, key=lambda nb: not nb.startswith('3-'))
    return {nb: pool.submit(run_notebook_child, nb, 'cpu') for nb in order}


def phase_tutorial(cpu_runs=None):
    """The tutorial notebooks 1-6, unchanged, through the switch's
    ``--notebook`` mode on the card and on the CPU, each run in its own
    process (:func:`child_notebook`): the card's three at a time, the
    CPU's (one thread each) from ``cpu_runs`` (:func:`start_tutorial_cpu`,
    started here when None). Notebook 3's mid-spectrum solve (~115,000
    MINRES iterations) is the slowest of each. The card's output must
    equal the CPU's cell by cell as
    ``tests/torch_tutorial_reference.py::compare`` states (text equal,
    numbers to 1e-10 relative + 1e-9, random draws and wall times left
    out). Emits one line per notebook: seconds on each device, the card's
    peak and the hand kernels' launches on the card. Returns the phase's
    record."""
    from concurrent.futures import ThreadPoolExecutor
    from tests.torch_tutorial_reference import NOTEBOOKS, compare
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        if cpu_runs is None:
            cpu_runs = start_tutorial_cpu(pool)
        with ThreadPoolExecutor(3) as card_pool:
            card_runs = {nb: card_pool.submit(run_notebook_child, nb)
                         for nb in cpu_runs}
            card_runs = {nb: f.result() for nb, f in card_runs.items()}
        cpu_runs = {nb: f.result() for nb, f in cpu_runs.items()}
    recs = []
    for nb in NOTEBOOKS:
        card, cpu = card_runs[nb], cpu_runs[nb]
        bad = compare(card['output'], cpu['output'], nb, against_jax=False)
        rec = {'phase': 'tutorial', 'notebook': nb,
               'card_s': card['seconds'], 'cpu_s': cpu['seconds'],
               'card_peak_gb': card['peak_gb'],
               'card_launches': card['launches'],
               'mismatches': bad[:5]}
        emit(rec)
        recs.append(rec)
        if bad or card['jax_imported'] or cpu['jax_imported']:
            raise RuntimeError(f'phase tutorial: {nb}: card against CPU '
                               f'{bad[:5]}')
    out = {'phase': 'tutorial', 'notebooks': len(recs),
           'seconds': time.perf_counter() - t0,
           'card_launches': {k: sum(r['card_launches'][k] for r in recs)
                             for k in recs[0]['card_launches']}}
    emit(out)
    # the one-card output phase cards is held to
    return dict(out, card={nb: run['output']
                           for nb, run in card_runs.items()})


# phase cards: the physics numbers of a run over the cards against the
# one-card run's (relative, with an absolute floor for numbers that are 0
# on both); kagome's E0 to KAGOME_TOL, as in phase examples; the norm of
# the L=27 floquet state after each cycle
CARDS_RTOL = 1e-10
CARDS_ATOL = 1e-12
CARDS_NORM_TOL = 1e-10
# the ranks' CPU threads while the phase's runs share the host (and, in
# the whole script, the reference suite and tutorial phases)
CARDS_THREADS = '1'


class _StampedLines:
    """A text sink that keeps what is written and the host clock at each
    line's end."""

    def __init__(self):
        self.parts, self.stamps = [], []

    def write(self, text):
        self.parts.append(text)
        self.stamps += [time.perf_counter()] * text.count('\n')
        return len(text)

    def flush(self):
        pass

    def getvalue(self):
        return ''.join(self.parts)


def _cards_numbers(lines):
    """Every number of an example's output lines that are physics (the
    floquet and mbl tables, kagome's E0 and gap lines), in order."""
    out = []
    for line in lines:
        if line.startswith(('E0 = ', 'gap = ')):
            line = ' '.join(line.split('=')[1:])  # the values, not labels
        elif not line or line[0].isalpha():
            continue
        out += [float(x) for x in re.findall(
            r'[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|nan', line)]
    return out


def _cards_close(got, want, rtol=CARDS_RTOL):
    import numpy as np
    got, want = np.asarray(got, float), np.asarray(want, float)
    if got.shape != want.shape or got.size == 0:
        return False, float('inf')
    both_nan = np.isnan(got) & np.isnan(want)
    err = np.where(both_nan, 0.0, np.abs(got - want)
                   / (np.abs(want) + CARDS_ATOL / rtol))
    return bool(np.all(err <= rtol)), float(np.max(err))


def child_cards(kind, args):
    """``python -m dynamite_tpu_torch.switch [--cards N] chip_smoke.py
    --child-cards KIND ARGS...``: one rank of a run over the cards, the
    switch's own (every rank runs this; rank 0 prints). KIND is an example
    (its script through ``switch.run_script``, unchanged), ``notebook``
    (ARGS the notebook's name, through ``switch.run_notebook``) or
    ``pytest`` (ARGS pytest's, through ``switch.run_pytest``). The rank
    joins the switch's group at its first use of the port; its card is
    ``cuda:{LOCAL_RANK}``. For floquet the state's norm after each evolve is
    recorded (a collective on every rank; X is a permutation, so it is the
    norm after each cycle), and mbl runs through the ELL kernel, as in
    phase examples. Rank 0 emits one JSON line: the output lines and the
    seconds at which each was printed, and by rank its device peak, launch
    counts (0 at the start), seconds and whether jax was imported."""
    require_card_and_port()
    import contextlib
    import numpy as np
    import torch
    from dynamite_tpu_torch import config, operators, switch
    from dynamite_tpu_torch.parallel import multihost
    device = config.device  # joins the group: this rank's card
    torch.cuda.reset_peak_memory_stats(device)
    norms = []
    if kind == 'floquet':
        evolve = operators.Operator.evolve

        def evolve_and_norm(self, *a, **kw):
            out = evolve(self, *a, **kw)
            norms.append(out.norm())
            return out
        operators.Operator.evolve = evolve_and_norm
    if kind == 'mbl':
        config.use_sector = False
    buf, rc = _StampedLines(), 0
    t0 = time.perf_counter()
    if kind == 'pytest':
        rc = switch.run_pytest(list(args))
    else:
        with contextlib.redirect_stdout(buf):
            if kind == 'notebook':
                switch.run_notebook(os.path.join(REPO, 'examples',
                                                 'tutorial', args[0]))
            else:
                switch.run_script(os.path.join(REPO, 'examples', 'scripts',
                                               EXAMPLE_SCRIPTS[kind]), args)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    mine = _launch_counts()
    ranks = multihost.allgather_host_values(np.array([
        torch.cuda.max_memory_allocated(device), mine['xor_apply'],
        mine['xor_diagonal'], mine['ell_apply'], seconds,
        'jax' in sys.modules, rc], dtype=np.float64))
    if multihost.rank() == 0:
        emit({'kind': kind, 'args': list(args),
              'world': multihost.world_size(),
              'lines': buf.getvalue().splitlines(),
              'line_s': [t - t0 for t in buf.stamps], 'norms': norms,
              'peak_gb': (ranks[:, 0] / 1e9).tolist(),
              'launches': {k: ranks[:, i].astype(int).tolist() for i, k in
                           enumerate(('xor_apply', 'xor_diagonal',
                                      'ell_apply'), 1)},
              'seconds': ranks[:, 4].tolist(),
              'jax_imported': bool(ranks[:, 5].any()),
              'pytest_exit': int(ranks[:, 6].max())})
    if rc:
        sys.exit(rc)


def run_cards(kind, *args, cards=None, timeout=900):
    """:func:`child_cards` over ``cards`` ranks (the switch's default, every
    card, when None) in one run of ``python -m dynamite_tpu_torch.switch``;
    returns rank 0's record, with the run's seconds and, for pytest, its
    per-file lines."""
    import torch
    torch.cuda.empty_cache()
    cmd = [sys.executable, '-m', 'dynamite_tpu_torch.switch']
    if cards is not None:
        cmd += ['--cards', str(cards)]
    cmd += [os.path.abspath(__file__), CHILD_CARDS, kind, *map(str, args)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=CARDS_THREADS)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO, env=env)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith('{"kind"'):
        sys.stderr.write(proc.stdout[-6000:] + proc.stderr[-6000:])
        raise RuntimeError(f'phase cards: {kind} {list(args)} over '
                           f'{cards or "every"} card(s) failed (exit code '
                           f'{proc.returncode})')
    rec = json.loads(lines[-1])
    rec['run_s'] = time.perf_counter() - t0
    rec['files'] = [json.loads(line) for line in lines
                    if line.startswith('{"reference_file"')]
    return rec


def cards_runs():
    """The runs of phase cards: every card of this host from unchanged
    code, through the switch's default (``python -m
    dynamite_tpu_torch.switch`` with no ``--cards``: one process per card,
    NCCL between them), each run through :func:`child_cards`:

    * the examples, unchanged: floquet at L=24 (9 cycles; 6 with a
      checkpoint every 3, resumed to 9), kagome '24', syk at N=32, and mbl
      at L=12 (one h point, its lowest and highest eight levels, through
      the ELL kernel) with a ``--cards 1`` run of the same arguments;
    * floquet at L=27 in float64 (the script's default; a vector is 2.15
      GB), 2 cycles, on four cards or more;
    * the JAX package's 15 reference files (``--pytest``) and the tutorial
      notebooks 1-6.

    The runs go in six lanes at once, notebook 3 (~116,000 MINRES
    iterations, the longest over NCCL) in a lane of its own, each rank at
    CARDS_THREADS CPU threads, so their seconds include their share of the
    cards and the host; no other phase runs meanwhile. Returns {run:
    child_cards' record} with the lanes' seconds under 'lanes_s', or None
    on one card (it says it needs two)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from tests.torch_reference_suite import EXCLUDED, UNCHANGED
    from tests.torch_tutorial_reference import NOTEBOOKS
    n = torch.cuda.device_count()
    if n < 2:
        emit({'phase': 'cards', 'ran': False,
              'why': f'needs two cards (one process each); this machine '
                     f'has {n}'})
        return None
    t0 = time.perf_counter()

    def lane_floquet():
        with tempfile.TemporaryDirectory() as tmp:
            runs = {'floquet24_part': run_cards(
                        'floquet', '-L', 24, '--n-cycles', 6,
                        '--checkpoint-every', 3, '--checkpoint-path', tmp),
                    'floquet24_resumed': run_cards(
                        'floquet', '-L', 24, '--n-cycles', 9,
                        '--checkpoint-every', 3, '--checkpoint-path', tmp)}
        return runs

    def lane_full_width():
        runs = {'floquet24': run_cards('floquet', '-L', 24, '--n-cycles', 9)}
        if n >= 4:
            runs['floquet27'] = run_cards('floquet', '-L', 27,
                                          '--n-cycles', 2)
        return runs

    # mbl at its two extremal points: the mid-spectrum point's ~120,000
    # MINRES iterations at L=12 would be another run as long as notebook 3
    mbl_args = ('-L', 12, '--iters', 1, '--h-points', 1, '--energy-points',
                2, '--seed', 7)

    def lane_kagome_syk():
        return {'kagome24': run_cards('kagome', '24'),
                'syk32': run_cards('syk', '-N', 32, '-b', 0.5, '-t', 0.5,
                                   '--seed', 5)}

    reference_args = [os.path.join('tests', rel) for rel in UNCHANGED]
    for nodeid in EXCLUDED:
        reference_args += ['--deselect', os.path.join('tests', nodeid)]
    reference_args += ['-q', '-p', 'no:randomly']

    def lane_mbl_reference():
        return {'mbl12': run_cards('mbl', *mbl_args),
                'reference': run_cards('pytest', *reference_args)}

    def lane_notebook3():
        return {NOTEBOOKS[2]: run_cards('notebook', NOTEBOOKS[2])}

    def lane_mbl_one_notebooks():
        runs = {'mbl12_one_card': run_cards('mbl', *mbl_args, cards=1)}
        with ThreadPoolExecutor(2) as pool:
            nbs = {nb: pool.submit(run_cards, 'notebook', nb)
                   for nb in NOTEBOOKS if nb != NOTEBOOKS[2]}
        runs.update({nb: f.result() for nb, f in nbs.items()})
        return runs

    with ThreadPoolExecutor(6) as pool:
        lanes = [pool.submit(f) for f in (
            lane_notebook3, lane_full_width, lane_floquet, lane_kagome_syk,
            lane_mbl_reference, lane_mbl_one_notebooks)]
    runs = {}
    for lane in lanes:
        runs.update(lane.result())
    runs['lanes_s'] = time.perf_counter() - t0
    return runs


def phase_cards(examples, reference, tutorial, card):
    """Phase cards: the runs of :func:`cards_runs` (none on one card:
    nothing to do) held to the one-card phases:

    * floquet L=24 (whole, and the resumed 6 + 9) and kagome '24' against
      phase examples' one-card runs (``examples``; 1e-10 relative,
      kagome's E0 1e-9); syk's C finite (its state is drawn unseeded, so it
      is no yardstick); mbl against its ``--cards 1`` run (1e-10); the XOR
      and diagonal kernels launched on every card (floquet, syk) and the
      ELL kernel (mbl);
    * floquet at L=27: each card's peak, the norm after each cycle (within
      CARDS_NORM_TOL of 1), the seconds per cycle and each card's XOR and
      diagonal kernel launches;
    * the reference files: every test passes, with counts per file equal
      to phase reference_suite's (``reference``);
    * the notebooks: the output equal to phase tutorial's card run cell by
      cell (``tutorial``; ``compare(worlds_differ=True)``).

    Returns the phase's record, with the launches over ranks of each
    kernel summed over the ranks and runs, or None on one card."""
    runs = cards_runs()
    if runs is None:
        return None
    import numpy as np
    import torch
    from tests.torch_reference_suite import UNCHANGED
    from tests.torch_tutorial_reference import NOTEBOOKS, compare
    n = torch.cuda.device_count()
    lanes_s = runs.pop('lanes_s')

    faults, checks = [], {}
    over = {k: r for k, r in runs.items() if r['world'] > 1}
    for name, rec in runs.items():
        if rec['jax_imported']:
            faults.append(f'{name} imported jax')
    for name, rec in over.items():
        if rec['world'] != n:
            faults.append(f'{name} ran on {rec["world"]} ranks, not {n}')

    def hold(name, got, want, rtol=CARDS_RTOL):
        ok, err = _cards_close(got, want, rtol)
        checks[name] = err
        if not ok:
            faults.append(f'{name}: {err:.3e} from the one-card run')

    # the examples
    fl = [_cards_numbers(runs[k]['lines']) for k in
          ('floquet24', 'floquet24_part', 'floquet24_resumed')]
    if len(fl[0]) != 10 * 27:
        faults.append(f'floquet24 printed {len(fl[0])} numbers')
    hold('floquet24_resumed_vs_whole', fl[1] + fl[2], fl[0])
    for k in ('floquet24', 'floquet24_part', 'floquet24_resumed',
              'floquet27', 'syk32'):
        if k in runs and not min(runs[k]['launches']['xor_apply']) > 0:
            faults.append(f'{k}: a card launched no XOR kernel')
    for k in ('floquet24', 'floquet27'):
        if k in runs and not min(runs[k]['launches']['xor_diagonal']) > 0:
            faults.append(f'{k}: a card built no diagonal stream')
    c = _cards_numbers(runs['syk32']['lines'])
    if not (len(c) == 3 and np.isfinite(c).all()):
        faults.append(f'syk32: {c}')
    hold('mbl12_vs_one_card', _cards_numbers(runs['mbl12']['lines']),
         _cards_numbers(runs['mbl12_one_card']['lines']))
    if not min(runs['mbl12']['launches']['ell_apply']) > 0:
        faults.append('mbl12: a card launched no ELL kernel')
    hold('floquet24_vs_one_card', fl[0],
         _cards_numbers(examples['lines']['floquet24']))
    hold('kagome24_vs_one_card', _cards_numbers(runs['kagome24']['lines']),
         _cards_numbers(examples['lines']['kagome24']), KAGOME_TOL)

    # floquet at L=27 over four cards or more
    full = None
    if 'floquet27' in runs:
        r = runs['floquet27']
        rows = [i for i, line in enumerate(r['lines'])
                if line and not line[0].isalpha()]
        stamps = [r['line_s'][i] for i in rows]
        norm_err = [abs(x - 1) for x in r['norms']]
        full = {'L': 27, 'dtype': 'float64', 'cycles': len(r['norms']),
                'vector_gb': 2 * 8 * 2**27 / 1e9,
                'peak_gb_per_card': r['peak_gb'],
                'norm_minus_1': [x - 1 for x in r['norms']],
                'cycle_s': np.diff(stamps).tolist(),
                'first_row_s': stamps[0] if stamps else None,
                'xor_launches_per_card': r['launches']['xor_apply'],
                'diag_builds_per_card': r['launches']['xor_diagonal'],
                'seconds': r['run_s']}
        if not (len(norm_err) == 2 and max(norm_err) <= CARDS_NORM_TOL
                and len(rows) == 3):
            faults.append(f'floquet27: norms {r["norms"]}, {len(rows)} rows')
    else:
        full = {'ran': False, 'why': f'L=27 in float64 needs four cards; '
                                     f'this machine has {n}'}

    # the reference files
    files = runs['reference']['files']
    if len(files) != len(UNCHANGED) or runs['reference']['pytest_exit'] or \
            any(f['failed'] or f['passed'] != f['collected'] - f['skipped']
                - f['excluded'] for f in files):
        faults.append(f'reference files: {files}')
    keys = ('reference_file', 'collected', 'passed', 'skipped', 'excluded',
            'failed')
    one = [{k: f[k] for k in keys} for f in reference['file_records']]
    if [{k: f[k] for k in keys} for f in files] != one:
        faults.append('reference files: counts differ from one card\'s')
    if not all(min(v) > 0 for v in runs['reference']['launches'].values()):
        faults.append(f'reference files: launches '
                      f'{runs["reference"]["launches"]}')

    # the tutorial
    mismatches = {}
    for nb in NOTEBOOKS:
        bad = compare('\n'.join(runs[nb]['lines']), tutorial['card'][nb], nb,
                      against_jax=False, worlds_differ=True)
        if bad:
            mismatches[nb] = bad[:5]
            faults.append(f'{nb}: {bad[:3]}')

    launches = {k: int(sum(sum(r['launches'][k]) for r in over.values()))
                for k in ('xor_apply', 'xor_diagonal', 'ell_apply')}
    out = {'phase': 'cards', 'cards': n, 'nvidia_smi': card,
           'lanes_s': lanes_s, 'threads_per_rank': int(CARDS_THREADS),
           'rel_err': checks, 'full_width': full,
           'tutorial_mismatches': mismatches,
           'launches_all_ranks': launches,
           'runs': {k: {'world': r['world'], 'run_s': r['run_s'],
                        'seconds': r['seconds'], 'peak_gb': r['peak_gb'],
                        'launches': r['launches']}
                    for k, r in runs.items()},
           'kagome24_lines': runs['kagome24']['lines'],
           'mbl12_lines': runs['mbl12']['lines'],
           'syk32_lines': runs['syk32']['lines']}
    emit(out)
    if faults:
        raise RuntimeError('phase cards: ' + '; '.join(faults))
    return out


# phase interactive: the session's notebooks over every card; the counts a
# rank read after each of its runs (XOR launches, diagonal builds, ELL
# launches, device peak, pid), gathered to rank 0, one list a rank
SESSION_NOTEBOOKS = ('2-States.ipynb', '4-TimeEvolution.ipynb',
                     '6-MatrixFree.ipynb')
SESSION_COUNTS = '''\
import json as _json, os as _os, numpy as _np, torch as _torch
from dynamite_tpu_torch import tracing as _tr
from dynamite_tpu_torch.parallel import multihost as _mh
_ranks = _mh.allgather_host_values(_np.array([
    _tr.counter('xor.launches'), _tr.counter('xor.diagonal_launches'),
    _tr.counter('ell.launches'),
    _torch.cuda.max_memory_allocated(), _os.getpid()], dtype=_np.float64))
print(_json.dumps({'session_counts': _ranks.tolist()}))
'''
# an H.dot loop on Parity(24), interrupted after SESSION_INTERRUPT_S
SESSION_SETUP = '''\
from dynamite_tpu import config
from dynamite_tpu.models import heisenberg
from dynamite_tpu.subspaces import Parity
from dynamite_tpu.states import State
config.L = 24
H = heisenberg()
sub = Parity('even')
H.add_subspace(sub)
psi = State(state='random', subspace=sub, seed=0)
psi.normalize()
'''
SESSION_LOOP = 'while True:\n    phi = H.dot(psi)\n'
SESSION_INTERRUPT_S = 2.0
SESSION_NORM_TOL = 1e-12
# floquet's Hamiltonian (the example's defaults) on Full(27), float64, one
# cycle (evolve for T, the X pulse); the example's own module, imported
# through the switch's finder
SESSION_FULL_WIDTH = '''\
import os, sys, time
sys.path.insert(0, os.path.join({repo!r}, 'examples', 'scripts', 'floquet'))
from run_floquet import build_hamiltonian, domain_wall_state_str
from dynamite_tpu import config
from dynamite_tpu.operators import index_product, sigmax
from dynamite_tpu.states import State
config.L = 27
H = build_hamiltonian(1.25, 1, 0.19, [0.21, 0.17, 0.13])
X = index_product(sigmax())
state = State(state=domain_wall_state_str(1, 27))
tmp = state.copy()
t0 = time.perf_counter()
H.evolve(state, result=tmp, t=0.12)
X.dot(tmp, result=state)
norm = state.norm()
print('cycle_s', time.perf_counter() - t0, 'norm_minus_1', norm - 1)
'''
SESSION_FULL_TOL = 1e-12


def _session_counts(session):
    """Each rank's counts (SESSION_COUNTS) in a session."""
    out = session.run(SESSION_COUNTS)
    ranks = json.loads(out.strip().splitlines()[-1])['session_counts']
    keys = ('xor_apply', 'xor_diagonal', 'ell_apply')
    return {'launches': {k: [int(r[i]) for r in ranks]
                         for i, k in enumerate(keys)},
            'peak_gb': [r[3] / 1e9 for r in ranks],
            'pids': [int(r[4]) for r in ranks]}


def _session_close(session, rec, faults, name):
    """End a session (a console's end of input, or the kernel's Jupyter
    shutdown); every engine must be gone. The console exits 0; the kernel
    exits 0, or -SIGTERM from ``jupyter_client`` where ``ipykernel``'s own
    exit blocked after its reply (``torch_session_client.Client.close``)."""
    from tests.torch_session_client import Client, alive
    engines = session.engines()
    rec['exit_code'] = session.close()
    left = [p for p in engines + rec.get('pids', []) if alive(p)]
    rec['engines_left'] = left
    ok = (0, -signal.SIGTERM) if isinstance(session, Client) else (0,)
    if rec['exit_code'] not in ok or left:
        faults.append(f'{name}: exit code {rec["exit_code"]}, engines left '
                      f'{left}')


def phase_interactive(tutorial, card):
    """Phase interactive: the port's interactive session
    (``dynamite_tpu_torch/interactive.py``) at every card of this machine,
    one engine process per card. Where ``ipykernel`` and
    ``jupyter_client`` import, through its Jupyter kernel (its kernelspec
    installed under a temporary ``--prefix``, driven by
    ``tests/torch_session_client.py::Client``), with a kernel restart
    before each run after the first; else through its console (``python
    -m dynamite_tpu_torch.switch --console`` through a pipe:
    ``Console``), a new console a run, and the tests hold the kernel on
    the CPU. One line says which front end ran and why.

    * tutorial notebooks 2, 4 and 6 (cell 0 and ``switch.SUBSTITUTES`` fed
      as ``switch.run_notebook`` does), each in a fresh group, rank 0's
      output equal to phase tutorial's card run (``tutorial``) by
      ``compare(worlds_differ=True)`` over several cards; notebook 3 (~116,000
      MINRES iterations) is left out;
    * after notebook 6, in its group: an ``H.dot`` loop on Parity(24)
      interrupted after SESSION_INTERRUPT_S (SIGINT to the front end,
      which sends it to every engine), whether the ranks were kept or
      restarted, the seconds until the next cell answered, and that
      cell's ``psi.norm()`` within SESSION_NORM_TOL of 1;
    * on four cards or more, one cell of floquet's Hamiltonian on Full(27)
      in float64 evolved one cycle, each card's peak and ‖ψ‖ − 1 within
      SESSION_FULL_TOL;
    * each group ended: no engine left.

    Each rank's launches of the XOR kernel (its sharded route over several
    cards) and diagonal builds are read in the session after each run.
    Emits one line a run; returns the phase's record with the launches
    summed over ranks and runs."""
    import torch
    from tests.torch_session_client import (Client, Console, alive,
                                            error_text, install_spec,
                                            run_notebook, session_env)
    from tests.torch_tutorial_reference import compare
    n = torch.cuda.device_count()
    import shutil
    import tempfile
    try:
        import ipykernel  # noqa: F401
        import jupyter_client  # noqa: F401
        front, why = 'kernel', 'ipykernel and jupyter_client import here'
    except ImportError as e:
        front, why = 'console', (f'{e} here; the console needs neither, '
                                 f'and the CPU tests hold the kernel')
    emit({'phase': 'interactive', 'front_end': front, 'why': why})
    tmp = tempfile.mkdtemp(prefix='smoke_session_')
    env = session_env(tmp, threads=str(max(1, os.cpu_count() // n)))
    tut = os.path.join(REPO, 'examples', 'tutorial')
    faults, runs = [], {}
    kernel = None

    def fresh(first):
        """A fresh group of engines and the seconds it took: the first at
        the default, every card (counted in a child process), the others
        naming the count, which spares that child; a new console, or the
        kernel started, then restarted."""
        nonlocal kernel
        if front == 'console':
            console = Console([] if first else ['--cards', str(n)], tut, env)
            return console, {'start_s': console.start_s}
        if kernel is None:
            install_spec(os.path.join(tmp, 'prefix'), env=env)
            kernel = Client(os.path.join(tmp, 'prefix'), tut, env,
                            timeout=900)
            return kernel, {'start_s': kernel.start_s}
        old = kernel.engines()
        times = {'restart_s': kernel.restart()}
        left = [p for p in old if alive(p)]
        if left:
            faults.append(f'the kernel restart left engines {left}')
        return kernel, times

    t_phase = time.perf_counter()
    for nb in SESSION_NOTEBOOKS:
        session, times = fresh(nb == SESSION_NOTEBOOKS[0])
        out, cell_s = run_notebook(session, os.path.join(tut, nb))
        rec = {'phase': 'interactive', 'run': nb, 'cards': n,
               'front_end': front, **times, 'cell_s': cell_s,
               **_session_counts(session)}
        bad = compare(out, tutorial['card'][nb], nb, against_jax=False,
                      worlds_differ=n > 1)
        rec['mismatches'] = bad[:5]
        if bad:
            faults.append(f'{nb}: {bad[:3]}')
        if nb.startswith('6-'):
            t0 = time.perf_counter()
            session.run(SESSION_SETUP)
            rec['setup_s'] = time.perf_counter() - t0

            def interrupt():
                time.sleep(SESSION_INTERRUPT_S)
                interrupt.at = time.perf_counter()
                session.interrupt()
            looped = session.execute(SESSION_LOOP, during=interrupt)
            reply_s = time.perf_counter() - interrupt.at
            err = error_text(looped)
            restarted = re.search(r'were restarted \(the new group took '
                                  r'([0-9.]+) s', err)
            # the rule: kept, or the old group ended and a new one started,
            # within GRACE_S + KILL_S (the new group's start apart)
            start_s = float(restarted.group(1)) if restarted else 0.0
            rec['interrupt'] = {
                'outcome': 'restarted' if restarted else 'kept',
                'reply_s': reply_s, 'new_group_start_s': start_s,
                'keyboard_interrupt': 'KeyboardInterrupt' in err,
                'notes': [line for line in err.splitlines()
                          if line.startswith('dynamite_tpu_torch session')]}
            if restarted:
                session.run(SESSION_SETUP)
            norm = float(session.run('print(psi.norm())').split()[-1])
            rec['interrupt'].update(
                next_cell_s=time.perf_counter() - interrupt.at,
                norm_minus_1=norm - 1)
            if abs(norm - 1) > SESSION_NORM_TOL:
                faults.append(f'after the interrupt psi.norm() = {norm}')
            if not restarted and not rec['interrupt']['keyboard_interrupt']:
                faults.append('the interrupt raised no KeyboardInterrupt')
            from dynamite_tpu_torch.switch import GRACE_S, KILL_S
            if reply_s - start_s > GRACE_S + KILL_S:
                faults.append(f'the interrupted cell answered after '
                              f'{reply_s:.1f} s')
            # the loop's launches: the group's counts now, less the
            # notebook's where the group was kept (a restarted group counts
            # from 0, and its predecessor's loop is not known)
            after = _session_counts(session)
            rec['pids'] = after['pids']
            rec['interrupt']['peak_gb'] = after['peak_gb']
            rec['loop_launches'] = {
                k: [a - (0 if restarted else b) for a, b in
                    zip(v, rec['launches'][k])]
                for k, v in after['launches'].items()}
        if front == 'console' or (nb == SESSION_NOTEBOOKS[-1] and n < 4):
            _session_close(session, rec, faults, nb)
        emit(rec)
        runs[nb] = rec
    if n >= 4:
        session, times = fresh(False)
        out = session.run(SESSION_FULL_WIDTH.format(repo=REPO))
        words = out.split()
        rec = {'phase': 'interactive', 'run': 'floquet27', 'cards': n,
               'front_end': front, **times,
               'cycle_s': float(words[words.index('cycle_s') + 1]),
               'norm_minus_1': float(words[words.index('norm_minus_1') + 1]),
               'vector_gb': 2 * 8 * 2**27 / 1e9,
               **_session_counts(session)}
        if abs(rec['norm_minus_1']) > SESSION_FULL_TOL:
            faults.append(f'floquet27: norm - 1 = {rec["norm_minus_1"]}')
        _session_close(session, rec, faults, 'floquet27')
        emit(rec)
        runs['floquet27'] = rec
    else:
        emit({'phase': 'interactive', 'run': 'floquet27', 'ran': False,
              'why': f'L=27 in float64 needs four cards; this machine has '
                     f'{n}'})
    shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: int(sum(sum(r['launches'][k])
                           + sum(r.get('loop_launches', {}).get(k, []))
                           for r in runs.values()))
                for k in ('xor_apply', 'xor_diagonal', 'ell_apply')}
    for name in ('4-TimeEvolution.ipynb', '6-MatrixFree.ipynb'):
        if not min(runs[name]['launches']['xor_apply']) > 0:
            faults.append(f'{name}: a rank launched no XOR kernel')
    out = {'phase': 'interactive', 'front_end': front, 'cards': n,
           'nvidia_smi': card, 'seconds': time.perf_counter() - t_phase,
           'launches_all_ranks': launches,
           'interrupt': runs['6-MatrixFree.ipynb']['interrupt']}
    emit(out)
    if faults:
        raise RuntimeError('phase interactive: ' + '; '.join(faults))
    return out


def interactive_only():
    """``python3 chip_smoke.py --interactive``: the environment, the card
    runs of phase tutorial's notebooks 2, 4 and 6 (its yardstick) and
    phase interactive."""
    require_card_and_port()
    card = phase_env()
    tutorial = {'card': {nb: run_notebook_child(nb)['output']
                         for nb in SESSION_NOTEBOOKS}}
    t0 = time.perf_counter()
    phase_interactive(tutorial, card)
    emit({'phase_seconds': {'phase_interactive': time.perf_counter() - t0}})


def group_costs(L=24):
    """``python3 chip_smoke.py --group-costs``: what one mask group costs
    the matvec kernel, by where its partner rows lie. Each set is a Full(L)
    operator of unit terms, one group per mask: with no sign masks, or with
    the two terms of XX + YY (sign masks 0 and m: two slots when m lies in
    the tile; cancelling in half the tiles when it lies above it);
    ``diag_only`` is four Z terms (the diagonal stream alone). Then
    localized(L) with the diagonal stream and with the mask-0 group kept in
    the kernel's group loop. Prints one JSON line per set and dtype (CUDA
    events, 20 reps after 3 warm-up), with a copy of x as the bytes'
    yardstick, and the card's line."""
    require_card_and_port()
    import numpy as np
    import torch
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.operators import Operator
    from dynamite_tpu_torch.ops import xor_apply as xor_mod
    from dynamite_tpu_torch.subspaces import Full

    def tables(masks, signs=None):
        msc = np.zeros(len(masks), dtype=[('masks', np.int64),
                                          ('signs', np.int64),
                                          ('coeffs', np.complex128)])
        msc['masks'] = masks
        msc['signs'] = 0 if signs is None else signs
        msc['coeffs'] = 1.0
        H = Operator.from_msc(msc)
        H.add_subspace(Full(L=L))
        return H.get_mat().tables

    def xx_yy(masks):
        return [m for m in masks for _ in (0, 1)], [s for m in masks
                                                    for s in (0, m)]

    def localized_tables(min_diag_terms):
        keep = xor_mod.DIAG_PRECOMPUTE_MIN_TERMS
        xor_mod.DIAG_PRECOMPUTE_MIN_TERMS = min_diag_terms
        try:
            H = localized(L)
            H.add_subspace(Full(L=L))
            return H.get_mat().tables
        finally:
            xor_mod.DIAG_PRECOMPUTE_MIN_TERMS = keep

    in_tile = [3 << i for i in range(8)]
    mid = [3 << i for i in range(11, 19)]
    far = [3 << i for i in range(20, 23)]
    sets = {
        'diag_only': lambda: tables([0] * 4, [1, 2, 4, 8]),
        # partners among the rows of the same warp
        'near_1': lambda: tables([1]),
        'near_16': lambda: tables(list(range(1, 17))),
        # partners in the same tile (2**10 rows in float64, 2**11 float32)
        'in_tile_8': lambda: tables(in_tile),
        'in_tile_8_xx_yy': lambda: tables(*xx_yy(in_tile)),
        # partners in other tiles, 2**11 to 2**19 rows away
        'mid_8': lambda: tables(mid),
        'mid_8_xx_yy': lambda: tables(*xx_yy(mid)),
        # partners 2**20 rows away and more: beyond what L2 holds of x
        'far_1': lambda: tables([3 << 22]),
        'far_3': lambda: tables(far),
        'far_3_xx_yy': lambda: tables(*xx_yy(far)),
        'localized_diag_stream': lambda: localized_tables(
            xor_mod.DIAG_PRECOMPUTE_MIN_TERMS),
        'localized_diag_in_loop': lambda: localized_tables(1 << 30),
    }
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace('torch.', '')
        x = random_planes(1 << L, dtype, seed=1)
        y = torch.empty_like(x)
        emit({'set': 'copy', 'dtype': dt, 'groups': 0,
              'ms': cuda_ms(lambda: y.copy_(x))})
        ys = {}
        for name, make in sets.items():
            t = make()
            ys[name] = xor_mod.xor_apply(x, t)
            emit({'set': name, 'dtype': dt,
                  'groups': len(t.kernel_groups), 'use_diag': t.use_diag,
                  'tile_bits': xor_mod.tile_shape(L, x.element_size())[0],
                  'ms': cuda_ms(lambda: xor_mod.xor_apply(x, t))})
        a, b = ys['localized_diag_stream'], ys['localized_diag_in_loop']
        rel = float((a - b).abs().max() / b.abs().max())
        if not rel <= KERNEL_TOL[dt]:
            raise RuntimeError(f'localized {dt}: the diagonal stream and the '
                               f'group loop disagree ({rel:.3e})')
        del x, y, ys, a, b


def sector_forms(L=24):
    """``python3 chip_smoke.py --sector-forms``: the sector engine's column
    channels in the engine's form (one ``baddbmm_`` per channel) against
    the JAX package's batching on the same tables (the channels that share
    a matrix and gather as one ``matmul`` over their concatenated rows,
    then one add per channel), with a one-channel group in place
    (``batched``) or through the same concatenation (``always_cat``).
    heisenberg(L) and heisenberg(L + 2) on SpinConserve at half filling,
    float32; prints the card's line, then per case and form the ms (CUDA
    events, 20 reps after 3 warm-up) and the launches, busy ms and idle
    share over 10 calls (torch.profiler), in two rounds."""
    require_card_and_port()
    import copy
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.models import heisenberg
    from dynamite_tpu_torch.ops.sector_apply import sector_apply
    from dynamite_tpu_torch.subspaces import SpinConserve

    def batched(x, tables, rest, always_cat=False):
        y = sector_apply(x, rest)  # the diagonal and the row channels
        groups = {}
        for ch in tables.on(x.dtype, x.device)[0]:
            groups.setdefault((id(ch[2]), id(ch[4]), id(ch[5])),
                              []).append(ch)
        for chans in groups.values():
            Mr, Mi = chans[0][4:]
            srcs = []
            for si, so, b, W, _mr, _mi in chans:
                o, nb, na = tables.blocks[si]
                s = x[:, o:o + nb * na].view(2, nb, na)
                s = s if b is None else s.index_select(1, b)
                srcs.append(s if W is None else s * W[:, None])
            if len(chans) == 1 and not always_cat:
                o, nb, na = tables.blocks[chans[0][1]]
                ys = y[:, o:o + nb * na].view(2, nb, na)
                ys.baddbmm_(srcs[0], Mr.t().expand(2, -1, -1))
                if Mi is not None:
                    ys[0].addmm_(srcs[0][1], Mi.t(), alpha=-1)
                    ys[1].addmm_(srcs[0][0], Mi.t())
                continue
            src = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
            out = torch.matmul(src, Mr.t())
            if Mi is not None:
                oi = torch.matmul(src, Mi.t())
                out[0] -= oi[1]
                out[1] += oi[0]
            row0 = 0
            for (_si, so, *_), s in zip(chans, srcs):
                o, nb, na = tables.blocks[so]
                y[:, o:o + nb * na].view(2, nb, na).add_(
                    out[:, row0:row0 + s.shape[1]])
                row0 += s.shape[1]
        return y

    config.precision = 'single'
    config._initialize()
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for l in (L, L + 2):
        H, sub = heisenberg(l), SpinConserve(l, l // 2)
        H.add_subspace(sub)
        tables = H.get_mat().sector_tables
        rest = copy.copy(tables)
        rest.col_channels, rest._on = [], {}
        x = random_planes(sub.get_dimension(), torch.float32, seed=13)
        want = sector_apply(x, tables)
        forms = {'engine': lambda: sector_apply(x, tables),
                 'batched': lambda: batched(x, tables, rest),
                 'always_cat': lambda: batched(x, tables, rest, True)}
        for rnd in range(2):
            for name, fn in forms.items():
                rel = float((fn() - want).abs().max() / want.abs().max())
                if not rel <= KERNEL_TOL['float32']:
                    raise RuntimeError(f'{name} L={l}: disagrees ({rel:.3e})')
                prof = profile_window(fn)
                emit({'case': f'heisenberg_sc{l}', 'form': name,
                      'round': rnd, 'ms': cuda_ms(fn),
                      'launches': prof['launches_per_call'],
                      'busy_ms': prof['busy_ms'],
                      'idle_share': prof['idle_share'], 'rel_err': rel})
        del H, tables, rest, x, want
        torch.cuda.empty_cache()


def numpy_planes(dim, dtype, seed):
    """A unit (2, dim) state on the card, drawn with numpy from ``seed``
    (so two subspaces of one dimension get the same vector)."""
    import numpy as np
    import torch
    v = np.random.RandomState(seed).standard_normal((2, dim))
    x = torch.as_tensor(v / np.linalg.norm(v), dtype=dtype, device='cuda')
    return x.contiguous()


def ell_bound(t, x):
    """The least time of one ELL apply over the packed tables ``t`` on an
    H100, counted on nonzeros, so the same whatever format implements the
    matvec: the bytes it must move (an index and one coefficient, two with
    fi, per nonzero; the entries of x that its nonzeros reference read
    once, both planes; y written once) at HBM rate against its operations
    (2 FMAs per nonzero and plane pair, 4 with fi) at the type's CUDA-core
    peak. Over ranks ``t`` is one rank's tables and x the gathered input,
    of which a rank reads only its own columns. Returns (ms, 'bytes' or
    'operations')."""
    import torch
    dt = str(x.dtype).replace('torch.', '')
    coeffs = 1 if t.fi is None else 2
    per_nnz = t.cols.element_size() + coeffs * x.element_size()
    kept = t.fr != 0 if t.fi is None else (t.fr != 0) | (t.fi != 0)
    x_cols = torch.unique(t.cols[kept]).numel()
    nbytes = t.nnz * per_nnz + 2 * x_cols * x.element_size() \
        + 2 * t.rows * x.element_size()
    flops = t.nnz * 4 * coeffs
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dt] * 1e3
    return max(by_bytes, by_ops), ('bytes' if by_bytes >= by_ops
                                   else 'operations')


def ell_library_spmv(cols, fr, fi, x, y_kernel):
    """The ELL kernel's yardstick: cuSPARSE's CSR SpMV (int32 indices,
    complex in x's precision) of the same matrix, made on the card from the
    nonzero entries of the (G, rows) tables, times the same vector. Returns
    (ms, max|dy|/max|y| against the kernel, nnz). The port never calls it;
    the matrix is freed before returning."""
    import torch
    cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
    vals = fr.t() if fi is None else torch.complex(fr, fi).t()
    vals = vals.to(cdt)
    keep = vals != 0                       # (rows, G), row-major
    counts = keep.sum(1, dtype=torch.int32)
    crow = torch.zeros(len(counts) + 1, dtype=torch.int32, device=x.device)
    crow[1:] = torch.cumsum(counts, 0)
    A = torch.sparse_csr_tensor(crow, cols.t()[keep].int(), vals[keep],
                                size=(cols.shape[1], x.shape[1]))
    nnz = int(crow[-1])
    del vals, keep, counts
    xc = torch.complex(x[0], x[1])
    y = A @ xc
    ye = torch.complex(y_kernel[0], y_kernel[1])
    err = float((y - ye).abs().max() / ye.abs().max())
    ms = cuda_ms(lambda: A @ xc)
    del A, xc, y, ye, crow
    torch.cuda.empty_cache()
    return ms, err, nnz


def ell_record(name, kernel, dtype, seed):
    """The ELL kernel of an operator's kernel object on its packed tables
    in ``dtype``, built anew here (their seconds, the packing's, and the
    build's device memory peak over what it keeps), against the plain
    version over them and over the (G, rows) tables on the card
    (max|dy|/max|y| within KERNEL_TOL) and cuSPARSE's SpMV of the same
    matrix (within 10 KERNEL_TOL, and the same nonzero count), with times
    (CUDA events, 3 warm-up, 20 reps; the plain version 3 reps after 1),
    the bound on nonzeros and the tables' bytes. Returns (record, x, y)."""
    import torch
    from dynamite_tpu_torch import tracing
    from dynamite_tpu_torch.ops.ell import (build_tables, ell_apply,
                                            ell_apply_reference,
                                            sell_apply_reference)
    dt = str(dtype).replace('torch.', '')
    x = numpy_planes(kernel.plan.dim_right, dtype, seed)
    key = (dtype, x.device)
    kernel.ell_tables.drop(dtype, x.device)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = kernel.ell_tables.on(dtype, x.device)
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - mem0
    saved = tracing.counter('ell.launches')
    y = ell_apply(x, t)
    y_plain = sell_apply_reference(x, t)
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise RuntimeError(f'{name} {dt}: non-finite ELL kernel output')
    abs_err = float((y - y_plain).abs().max())
    rel_err = abs_err / float(y_plain.abs().max())
    padded = build_tables(kernel.plan, dtype, x.device)
    y_padded = ell_apply_reference(x, *padded)
    padded_rel_err = float((y - y_padded).abs().max()) \
        / float(y_padded.abs().max())
    del y_padded
    ms = cuda_ms(lambda: ell_apply(x, t))
    plain_ms = cuda_ms(lambda: sell_apply_reference(x, t), 3, 1)
    # a check's launches are not the main path's
    tracing.count('ell.launches', saved - tracing.counter('ell.launches'))
    bound_ms, bound_by = ell_bound(t, x)
    lib_ms, lib_err, lib_nnz = ell_library_spmv(*padded, x, y)
    padded_bytes = sum(v.numel() * v.element_size() for v in padded
                       if v is not None)
    del padded
    torch.cuda.empty_cache()
    rec = {'case': name, 'dtype': dt, 'rows': t.rows,
           'dim_right': t.dim_right, 'groups': kernel.ell_tables.n_groups,
           'has_fi': t.fi is not None,
           'index_dtype': str(t.cols.dtype).replace('torch.', ''),
           'nnz': t.nnz, 'stored_entries': t.stored,
           'stored_over_nnz': t.stored / t.nnz, 'n_slices': t.n_slices,
           'table_mb': t.nbytes / 1e6, 'padded_table_mb': padded_bytes / 1e6,
           'table_build_ms': kernel.ell_tables.build_s[key] * 1e3,
           'pack_ms': kernel.ell_tables.pack_s[key] * 1e3,
           'build_peak_mb': build_peak / 1e6,
           'max_abs_err': abs_err, 'rel_err': rel_err,
           'padded_rel_err': padded_rel_err,
           'tol': KERNEL_TOL[dt], 'ms': ms, 'plain_ms': plain_ms,
           'bound_ms': bound_ms, 'bound_by': bound_by,
           'bound_share': bound_ms / ms,
           'gb_per_s': (t.nbytes + 2 * (t.rows + t.dim_right)
                        * x.element_size()) / (ms * 1e-3) / 1e9,
           'library_ms': lib_ms, 'library_rel_err': lib_err,
           'library_nnz': lib_nnz,
           'library_bound_share': bound_ms / lib_ms}
    if not (rel_err <= KERNEL_TOL[dt] and padded_rel_err <= KERNEL_TOL[dt]):
        emit({'phase': 'general', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the ELL kernel disagrees with its '
                           f'plain versions ({rel_err:.3e}, '
                           f'{padded_rel_err:.3e})')
    # the library's values and sums are in another order than the kernel's
    if not lib_err <= 10 * KERNEL_TOL[dt]:
        emit({'phase': 'general', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the CSR yardstick disagrees with '
                           f'the ELL kernel ({lib_err:.3e})')
    if t.nnz != lib_nnz:
        emit({'phase': 'general', 'cases': [rec]})
        raise RuntimeError(f'{name} {dt}: the packed tables keep {t.nnz} '
                           f'entries, the CSR {lib_nnz}')
    return rec, x, y


def phase_general(L=24):
    """General pairs through the ELL engine, float32 unless marked:

    1. ``Auto(localized(24), 'U'*12 + 'D'*12)``: the host BFS and the
       canonical order timed apart, its dimension C(24, 12) and its state
       list equal to SpinConserve(24, 12)'s;
    2. the ELL kernel on its packed tables (float32 and float64) against
       its plain versions and cuSPARSE (:func:`ell_record`: the nonzero
       counts equal, the bound on nonzeros), and the same vector through
       the sector engine on SpinConserve(24, 12), with both engines' ms;
    3. over the budget: the on-the-fly sweep (``general_sweep``), its ms,
       its launches per apply (torch.profiler), against the kernel;
    4. the rectangular pair SpinConserve(24, 11) -> SpinConserve(24, 12) of
       index_sum(e^{i pi/7} sigma_plus + its adjoint) (imaginary
       coefficients: the kernel's fi path), float32 and float64;
    5. eigsolve(nev=1) on Auto(24) (lambda against the JAX package's
       float64 value, the residual, seconds, matvecs, memory peak), the
       half-chain entropy of its ground state on the card, and evolve(t=1)
       of a numpy-seeded state on Auto(24) against the same evolve on
       SpinConserve(24, 12);
    6. estimate_memory against the build's measured device bytes, and
       the estimate taken before the build not below them.

    Returns (the kernel records, the ELL launches of the main-path solves,
    the engine records, and (the operator, Auto(24)) for the sharded
    phase)."""
    import numpy as np
    import torch
    from dynamite_tpu_torch import config, subspaces
    from dynamite_tpu_torch.computations import (eigsolve,
                                                 entanglement_entropy,
                                                 evolve)
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.operators import (index_sum, sigma_minus,
                                              sigma_plus)
    from dynamite_tpu_torch.ops.ell import table_bytes
    from dynamite_tpu_torch.states import State

    seed_state = 'U' * (L // 2) + 'D' * (L // 2)
    rec = {'phase': 'general', 'L': L, 'precision': 'single'}

    # 1. discover the sector
    H = localized(L)
    H.reduce_msc()
    t0 = time.perf_counter()
    found = subspaces._bfs_sector(H.msc, State.str_to_state(seed_state, L))
    rec['bfs_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ordered = subspaces._canonical_order(found, L)
    rec['canonical_order_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = subspaces.Auto(H, seed_state)
    rec['auto_s'] = time.perf_counter() - t0
    sc = subspaces.SpinConserve(L, L // 2)
    dim = auto.get_dimension()
    rec['dim'] = dim
    same = np.array_equal(auto.state_map,
                          sc.idx_to_state(np.arange(sc.get_dimension())))
    if not (dim == AUTO_DIM_L24 and same
            and np.array_equal(ordered, auto.state_map)):
        emit(rec)
        raise RuntimeError(f'Auto({L}): dimension {dim}, state list equal '
                           f'to SpinConserve({L}, {L // 2})\'s: {same}')
    del found, ordered

    # 2. the ELL kernel on Auto(24), and the sector engine on SC(24, 12);
    # the memory estimate before the build counts the most the tables can
    # take, and the build's bytes include the index maps the estimate makes
    H.add_subspace(auto)
    # cuBLAS takes its workspace from the same allocator at its first call
    # (the build's float64 products, when this phase runs alone): not the
    # build's
    one = torch.ones((2, 2), dtype=torch.float64, device='cuda')
    torch.mm(one, one)
    del one
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    rec['estimate_before_build_bytes'] = H.estimate_memory() * 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kernel = H.get_mat()
    torch.cuda.synchronize()
    rec['build_s'] = time.perf_counter() - t0
    rec['build_device_bytes'] = torch.cuda.memory_allocated() - mem0
    rec['build_peak_bytes'] = torch.cuda.max_memory_allocated() - mem0
    if kernel.engine != 'ell':
        raise RuntimeError(f'Auto({L}): the {kernel.engine} route, not ELL')
    cases = []
    r32, x, y = ell_record(f'localized_auto{L}', kernel, torch.float32,
                           seed=21)
    cases.append(r32)
    cases.append(ell_record(f'localized_auto{L}', kernel, torch.float64,
                            seed=21)[0])
    kernel.ell_tables.drop(torch.float64, x.device)
    torch.cuda.empty_cache()
    H_sc = localized(L)
    H_sc.add_subspace(sc)
    k_sc = H_sc.get_mat()
    y_sc = k_sc.apply(x)
    sc_err = float((y_sc - y).abs().max()) / float(y.abs().max())
    rec.update(sector_ms=cuda_ms(lambda: k_sc.apply(x)), ell_ms=r32['ms'],
               sector_vs_ell_rel_err=sc_err)
    if not sc_err <= KERNEL_TOL['float32']:
        emit(rec)
        raise RuntimeError(f'the sector engine on SpinConserve({L}, '
                           f'{L // 2}) against the ELL kernel on Auto({L}): '
                           f'{sc_err:.3e}')
    del y_sc

    # 3. over the budget: the on-the-fly sweep
    saved_budget = config.ell_budget
    config.ell_budget = table_bytes(kernel.plan) - 1
    try:
        H_sw = localized(L)
        H_sw.add_subspace(auto)
        k_sw = H_sw.get_mat()
    finally:
        config.ell_budget = saved_budget
    if k_sw.engine != 'sweep':
        raise RuntimeError(f'over the budget: the {k_sw.engine} route')
    y_sw = k_sw.apply(x)
    sw_err = float((y_sw - y).abs().max()) / float(y.abs().max())
    sw_prof = profile_window(lambda: k_sw.apply(x), n=3)
    engines = [{'case': f'general_sweep_auto{L}', 'dtype': 'float32',
                'dim': dim, 'groups': len(k_sw.plan.groups),
                'ms': cuda_ms(lambda: k_sw.apply(x), 5, 1),
                'launches_per_apply': sw_prof['launches_per_call'],
                'idle_share': sw_prof['idle_share'],
                'rel_err_vs_ell': sw_err, 'ell_ms': r32['ms']}]
    if not sw_err <= KERNEL_TOL['float32']:
        emit({'engines': engines})
        raise RuntimeError(f'general_sweep against the ELL kernel: '
                           f'{sw_err:.3e}')
    del H_sw, k_sw, y_sw, x, y
    torch.cuda.empty_cache()

    # 4. the rectangular pair, imaginary coefficients
    phase = np.exp(1j * np.pi / 7)
    H_rect = index_sum(phase * sigma_plus() + np.conj(phase) * sigma_minus(),
                       size=L)
    H_rect.allow_projection = True
    left, right = subspaces.SpinConserve(L, L // 2), \
        subspaces.SpinConserve(L, L // 2 - 1)
    H_rect.add_subspace(left, right)
    k_rect = H_rect.get_mat(subspaces=(left, right))
    if k_rect.engine != 'ell' or not k_rect.ell_tables.has_fi:
        raise RuntimeError(f'the rectangular pair: the {k_rect.engine} route')
    for dtype in (torch.float32, torch.float64):
        cases.append(ell_record(f'sigma_plus_sc{L}_{L // 2 - 1}_to_'
                                f'{L // 2}', k_rect, dtype, seed=22)[0])
    del H_rect, k_rect
    torch.cuda.empty_cache()

    # 5. solves on Auto(24)
    peak_gb()
    (evals, evecs), eig_launches, eig_stats, eig_s = counted(
        lambda: eigsolve(H, nev=1, getvecs=True), f'eigsolve Auto({L})',
        engine='ell')
    eig_memory = peak_gb()
    lam = float(evals[0])
    v = evecs[0]
    resid = float(torch.linalg.vector_norm(H.dot(v).data - lam * v.data))
    resid /= abs(lam)
    S, entropy_ms = timed(lambda: float(entanglement_entropy(
        v, keep=range(L // 2))))
    psi = State(subspace=auto)
    psi.data = numpy_planes(dim, torch.float32, seed=23)
    psi.set_initialized()
    r, ev_launches, ev_stats, ev_s = counted(
        lambda: evolve(H, psi, t=1.0), f'evolve Auto({L})', engine='ell')
    ev_memory = peak_gb()
    psi_sc = State(subspace=sc)
    psi_sc.data = psi.data.clone()
    psi_sc.set_initialized()
    r_sc = evolve(H_sc, psi_sc, t=1.0)
    ev_err = float((r.data - r_sc.data).abs().max())
    nrm = r.norm()
    rec.update(eigsolve_s=eig_s, eval0=lam, jax_f64_eval0=EVAL0_SC24_F64,
               eval0_err=abs(lam - EVAL0_SC24_F64),
               relative_residual=resid,
               eigsolve_matvecs=eig_stats['matvecs'],
               eigsolve_restarts=eig_stats['restarts'],
               eigsolve_launches=eig_launches,
               eigsolve_memory_peak_gb=eig_memory,
               entropy_half_chain=S, jax_entropy_half_chain=ENTROPY_SC24,
               entropy_err=abs(S - ENTROPY_SC24), entropy_ms=entropy_ms,
               evolve_s=ev_s, evolve_matvecs=ev_stats['matvecs'],
               evolve_launches=ev_launches, evolve_memory_peak_gb=ev_memory,
               evolve_max_abs_err_vs_sc=ev_err, evolve_norm=nrm)

    # 6. the memory estimate against the build's device bytes
    est = H.estimate_memory() * 1e9
    rec.update(estimate_bytes=est,
               estimate_rel_err=abs(est - rec['build_device_bytes'])
               / rec['build_device_bytes'])
    emit(rec)
    emit({'phase': 'general', 'cases': cases})
    emit({'engines': engines})
    if not (abs(lam - EVAL0_SC24_F64) <= EVAL0_AUTO_TOL and resid <= 1e-4):
        raise RuntimeError(f'eigsolve Auto({L}): eigenvalue {lam}, '
                           f'residual {resid:.3e}')
    if not abs(S - ENTROPY_SC24) <= ENTROPY_TOL:
        raise RuntimeError(f'Auto({L}) half-chain entropy {S}, not '
                           f'{ENTROPY_SC24}')
    if not (ev_err <= AUTO_EVOLVE_TOL and abs(nrm - 1) <= 1e-3):
        raise RuntimeError(f'evolve Auto({L}): {ev_err:.3e} from '
                           f'SpinConserve({L}, {L // 2}), norm {nrm}')
    if not rec['estimate_rel_err'] <= ESTIMATE_RTOL:
        raise RuntimeError(f'estimate_memory {est:.4g} bytes against the '
                           f'measured {rec["build_device_bytes"]}')
    if not rec['estimate_before_build_bytes'] >= rec['build_device_bytes']:
        raise RuntimeError(f'estimate_memory before the build, '
                           f'{rec["estimate_before_build_bytes"]:.4g} bytes, '
                           f'is below the build\'s '
                           f'{rec["build_device_bytes"]}')
    del H_sc, k_sc, v, evecs, psi, psi_sc, r, r_sc
    torch.cuda.empty_cache()
    launches = eig_launches['ell_apply'] + ev_launches['ell_apply']
    return cases, launches, engines, (H, auto)


def sharded_ell_records(H, auto, one_tables, worlds=(2, 3, 4, 8)):
    """localized(24) on Auto(24) through the sharded ELL route on P virtual
    ranks of one card, float32: each rank's tables built on the card (its
    rows, nonzeros, bytes, build seconds), its ``ell_apply`` launched on
    them and timed (CUDA events, 3 warm-up, 20 reps), its output against
    its plain version (``sell_apply_reference``) and, put together, bitwise
    against the one-device kernel on ``one_tables``; the ranks' nonzeros
    must add up to the one-device count and their bytes to within 1% of
    its bytes. Returns the records, one per P."""
    import torch
    from dynamite_tpu_torch import tracing
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    from dynamite_tpu_torch.ops.ell import ell_apply, sell_apply_reference
    dim = auto.get_dimension()
    x1 = numpy_planes(dim, torch.float32, seed=31)
    saved = tracing.counter('ell.launches')
    y1 = ell_apply(x1, one_tables)
    recs = []
    for P in worlds:
        t0 = time.perf_counter()
        k = OperatorKernel(H._msc_on(auto), auto, auto,
                           transport=VirtualTransport(P))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if k.engine != 'ell':
            raise RuntimeError(f'Auto(24) over {P} virtual ranks: the '
                               f'{k.engine} route')
        n = k.sharded.local_right
        x = torch.zeros((2, n * P), dtype=torch.float32, device='cuda')
        x[:, :dim] = x1
        tabs = [k.sharded.tables[r].on(torch.float32, x.device)
                for r in range(P)]
        ys = [ell_apply(x, t) for t in tabs]
        y = torch.cat(ys, dim=1)
        bitwise = bool(torch.equal(y[:, :dim], y1))
        pads = bool((y[:, dim:] == 0).all())
        ranks = []
        for r, (t, yr) in enumerate(zip(tabs, ys)):
            plain = sell_apply_reference(x, t)
            err = float((yr - plain).abs().max())
            rel = err / max(float(plain.abs().max()), 1e-30)
            b_ms, b_by = ell_bound(t, x)
            ranks.append({
                'rank': r, 'rows': t.rows, 'nnz': t.nnz, 'stored': t.stored,
                'table_mb': t.nbytes / 1e6,
                'build_ms': k.sharded.tables[r].build_s[
                    (torch.float32, x.device)] * 1e3,
                'ms': cuda_ms(lambda: ell_apply(x, t)),
                'plain_ms': cuda_ms(lambda: sell_apply_reference(x, t), 3,
                                    1),
                'max_abs_err': err, 'rel_err': rel,
                'bound_ms': b_ms, 'bound_by': b_by})
            del plain
        # the checks' launches
        tracing.count('ell.launches', saved - tracing.counter('ell.launches'))
        nnz = sum(r['nnz'] for r in ranks)
        mb = sum(r['table_mb'] for r in ranks)
        rec = {'case': 'localized_auto24_ell_sharded', 'dtype': 'float32',
               'P': P, 'dim': dim, 'storage_dim': n * P,
               'build_s': build_s, 'ranks': ranks,
               'nnz_sum': nnz, 'one_device_nnz': one_tables.nnz,
               'table_mb_sum': mb,
               'one_device_table_mb': one_tables.nbytes / 1e6,
               'table_mb_sum_rel_diff': abs(mb * 1e6 - one_tables.nbytes)
               / one_tables.nbytes,
               'bitwise_equal_one_device': bitwise, 'pads_zero': pads,
               'max_abs_err': max(r['max_abs_err'] for r in ranks),
               'ms_sum': sum(r['ms'] for r in ranks),
               'ms_max_rank': max(r['ms'] for r in ranks),
               'plain_ms_sum': sum(r['plain_ms'] for r in ranks),
               'bound_ms_sum': sum(r['bound_ms'] for r in ranks),
               'bound_by': ranks[0]['bound_by'],
               'gathered_x_mb': x.numel() * x.element_size() / 1e6}
        recs.append(rec)
        ok = (bitwise and pads and nnz == one_tables.nnz
              and rec['table_mb_sum_rel_diff'] <= 0.01
              and all(r['rel_err'] <= KERNEL_TOL['float32'] for r in ranks))
        if not ok:
            emit({'phase': 'general_sharded', 'cases': recs})
            raise RuntimeError(f'Auto(24) over {P} virtual ranks: the '
                               'sharded ELL route disagrees')
        del k, tabs, ys, y, x
        torch.cuda.empty_cache()
    return recs


def sharded_evolve(H, auto, P=4):
    """The main path of the sharded ELL route on one card: evolve(t=1) of a
    numpy-seeded state on Auto(24) by the Krylov stepping of
    ``solvers.expmv`` through a kernel over P virtual ranks (its padded
    (2, storage_dim) vector, every apply one ``ell_apply`` launch per
    rank), the launches counted just around it; against the same evolve
    on one device (within AUTO_EVOLVE_TOL). Returns the record and the
    launches."""
    import torch
    from dynamite_tpu_torch import tracing
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    from dynamite_tpu_torch.solvers.expmv import expmv
    dim = auto.get_dimension()
    k = OperatorKernel(H._msc_on(auto), auto, auto,
                       transport=VirtualTransport(P))
    anorm = H.infinity_norm()
    x1 = numpy_planes(dim, torch.float32, seed=23)
    x = torch.zeros((2, k.sharded.local_right * P), dtype=torch.float32,
                    device='cuda')
    x[:, :dim] = x1
    one = H.get_mat()
    want = expmv(one.krylov_ops(30), x1, -1j, anorm, ncv=30, tol=1e-7)
    stats = {}
    torch.cuda.synchronize()
    before = tracing.counter('ell.launches')
    t0 = time.perf_counter()
    got = expmv(k.krylov_ops(30), x, -1j, anorm, ncv=30, tol=1e-7,
                stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tracing.counter('ell.launches') - before
    err = float((got[:, :dim] - want).abs().max())
    rec = {'case': 'evolve_auto24_virtual_ranks', 'P': P,
           'evolve_s': seconds, 'matvecs': stats['matvecs'],
           'launches': launches, 'max_abs_err_vs_one_device': err,
           'pads_zero': bool((got[:, dim:] == 0).all())}
    if not (launches >= P * stats['matvecs'] > 0 and rec['pads_zero']
            and err <= AUTO_EVOLVE_TOL):
        emit({'phase': 'general_sharded', 'evolve': rec})
        raise RuntimeError('evolve on Auto(24) over virtual ranks: '
                           f'{launches} launches for {stats["matvecs"]} '
                           f'matvecs, {err:.3e} from one device')
    return rec, launches


def sector_ring_records(L=24, worlds=(2, 3, 4)):
    """heisenberg(24) and localized(24) on SpinConserve(24, 12) through the
    sector engine's alpha ring on P virtual ranks, float32, against the
    one-device sector engine on the same vector (within 1e-5 relative),
    with each rank's table bytes (at most the estimate before the build,
    summed over the ranks) and the ms of an apply of all P ranks (CUDA
    events, 1 warm-up, 3 reps); ``build_s`` is the kernel's build
    over the P virtual ranks, its sector plan included. Returns the
    records."""
    import torch
    from dynamite_tpu_torch.models import heisenberg, localized
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    from dynamite_tpu_torch.subspaces import SpinConserve
    recs = []
    for name, model in (('heisenberg', heisenberg), ('localized',
                                                     localized)):
        H = model(L)
        sub = SpinConserve(L, L // 2)
        H.add_subspace(sub)
        one = H.get_mat()
        if one.engine != 'sector':
            raise RuntimeError(f'{name}({L}): the {one.engine} route')
        msc = H._msc_on(sub)
        dim = sub.get_dimension()
        x1 = numpy_planes(dim, torch.float32, seed=32)
        y1 = one.apply(x1)
        for P in worlds:
            est = H._engine_table_bytes(P)
            t0 = time.perf_counter()
            k = OperatorKernel(msc, sub, sub, transport=VirtualTransport(P))
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if k.engine != 'sector_ring':
                raise RuntimeError(f'{name}({L}) over {P} virtual ranks: '
                                   f'the {k.engine} route')
            route = k.sharded
            n = route.local_left
            blocks = [torch.zeros((2, n), dtype=torch.float32,
                                  device='cuda') for _ in range(P)]
            for r in range(P):
                lo, hi = r * n, min((r + 1) * n, dim)
                if hi > lo:
                    blocks[r][:, :hi - lo] = x1[:, lo:hi]
            y = torch.cat(route.apply(blocks), dim=1)
            rel = float((y[:, :dim] - y1).abs().max() / y1.abs().max())
            rec = {'case': f'{name}_sc{L}_sector_ring', 'dtype': 'float32',
                   'P': P, 'dim': dim, 'build_s': build_s,
                   'rel_err_vs_one_device': rel,
                   'pads_zero': bool((y[:, dim:] == 0).all()),
                   'rank_table_mb': [route.table_bytes(
                       r, torch.float32, y.device) / 1e6 for r in range(P)],
                   'table_mb_sum': route.total_bytes(torch.float32,
                                                     y.device) / 1e6,
                   'estimate_before_build_mb': est / 1e6,
                   'one_device_table_mb': one.sector_plan.table_bytes / 1e6,
                   'ms_all_ranks': cuda_ms(lambda: route.apply(blocks), 3,
                                           1),
                   'one_device_ms': cuda_ms(lambda: one.apply(x1), 3, 1)}
            recs.append(rec)
            if not (rel <= KERNEL_TOL['float32'] and rec['pads_zero']
                    and est >= route.total_bytes(torch.float32, y.device)):
                emit({'phase': 'general_sharded', 'cases': recs})
                raise RuntimeError(f'{name}({L}) over {P} virtual ranks: '
                                   f'the alpha ring is {rel:.3e} from one '
                                   'device, or its tables pass the '
                                   'estimate before the build')
            del k, route, blocks, y
            torch.cuda.empty_cache()
        del H, one, x1, y1
        torch.cuda.empty_cache()
    return recs


def sweep_records(L=20, P=3):
    """Both sweeps over P virtual ranks (the all-gather one and the ring),
    localized(20) on SpinConserve(20, 10) with the sector and ELL engines
    off, float32, against the one-device sweep, with ms per apply of all
    ranks (CUDA events, 1 warm-up, 3 reps)."""
    import torch
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.models import localized
    from dynamite_tpu_torch.ops.apply import OperatorKernel, VirtualTransport
    from dynamite_tpu_torch.subspaces import SpinConserve
    H = localized(L)
    sub = SpinConserve(L, L // 2)
    H.add_subspace(sub)
    msc = H._msc_on(sub)
    dim = sub.get_dimension()
    x1 = numpy_planes(dim, torch.float32, seed=33)
    recs = []
    saved = (config.use_sector, config.use_ell, config.sharded_ring_general)
    try:
        config.use_sector = config.use_ell = False
        one = OperatorKernel(msc, sub, sub)
        y1 = one.apply(x1)
        one_ms = cuda_ms(lambda: one.apply(x1), 3, 1)
        for ring in (False, True):
            config.sharded_ring_general = ring
            k = OperatorKernel(msc, sub, sub, transport=VirtualTransport(P))
            x = torch.zeros((2, k.sharded.local_right * P),
                            dtype=torch.float32, device='cuda')
            x[:, :dim] = x1
            y = k.apply(x)
            rel = float((y[:, :dim] - y1).abs().max() / y1.abs().max())
            recs.append({'case': f'localized_sc{L}_{k.engine}', 'P': P,
                         'dim': dim, 'rel_err_vs_one_device': rel,
                         'pads_zero': bool((y[:, dim:] == 0).all()),
                         'ms_all_ranks': cuda_ms(lambda: k.apply(x), 3, 1),
                         'one_device_ms': one_ms})
            if not (rel <= KERNEL_TOL['float32'] and recs[-1]['pads_zero']):
                emit({'phase': 'general_sharded', 'sweeps': recs})
                raise RuntimeError(f'the {k.engine} route over {P} virtual '
                                   f'ranks is {rel:.3e} from one device')
    finally:
        config.use_sector, config.use_ell, config.sharded_ring_general = \
            saved
    return recs


def phase_general_sharded(H, auto, one_tables):
    """The general routes over ranks on one card, with P virtual ranks in
    one process (``ops/apply.py``'s VirtualTransport: the same table
    builders and ring bodies as a process group runs), float32:

    1. localized(24) on Auto(24) through the sharded ELL route at P = 2,
       3, 4, 8 (3 and 8 pad: 2,704,156 rows divide neither), per rank and
       summed (:func:`sharded_ell_records`);
    2. its main path: evolve(t=1) through the route at P = 4, the ELL
       launches counted around it (:func:`sharded_evolve`);
    3. heisenberg(24) and localized(24) on SpinConserve(24, 12) through
       the alpha ring at P = 2, 3, 4 (:func:`sector_ring_records`);
    4. both sweeps at L = 20 (:func:`sweep_records`).

    Returns (the P = 4 ELL record, the main path's launches)."""
    ell_recs = sharded_ell_records(H, auto, one_tables)
    evolve_rec, launches = sharded_evolve(H, auto)
    ring_recs = sector_ring_records()
    sweeps = sweep_records()
    emit({'phase': 'general_sharded', 'cases': ell_recs,
          'evolve': evolve_rec, 'sector_ring': ring_recs,
          'sweeps': sweeps})
    return next(r for r in ell_recs if r['P'] == 4), launches


def general_only():
    """``python3 chip_smoke.py --general``: the environment, the general
    phase and the general routes over virtual ranks alone."""
    require_card_and_port()
    import torch
    from dynamite_tpu_torch import config
    config.precision = 'single'
    config._initialize()
    phase_env()
    t0 = time.perf_counter()
    H, auto = phase_general()[3]
    t1 = time.perf_counter()
    phase_general_sharded(H, auto, H.get_mat().ell_tables.on(
        torch.float32, torch.device('cuda', 0)))
    emit({'phase_seconds': {'phase_general': t1 - t0,
                            'phase_general_sharded':
                            time.perf_counter() - t1}})


def main():
    require_card_and_port()
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from dynamite_tpu_torch import config

    config.precision = 'single'
    config._initialize()
    t_start = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = time.perf_counter() - t0
        # a trail that a run cut short still leaves
        emit({'phase_done': phase.__name__,
              'seconds': seconds[phase.__name__],
              'since_start_s': time.perf_counter() - t_start})
        return out

    card = run(phase_env)
    run(phase_draw)
    rows = run(phase_kernel)
    sharded_rows = run(phase_kernel_sharded, rows)
    engines = run(phase_sector)
    # each main-path call counts its own launches (see counted); one
    # wrapper launches the kernel on both routes, and the phase tells the
    # layout: one block here, one block per rank in the distributed child
    ev_launches = run(phase_evolve)
    eig_launches, child_recs, xp_shard_launches, xp_shard_builds, \
        xp_eval0 = run(phase_eigsolve)
    target_launches, target = run(phase_target)
    diag_rows = run(phase_diagonal, target)
    launches = add_counts(ev_launches, eig_launches, target_launches)
    engines += child_recs['sector_double']['cases']
    run(phase_sector_solves)
    syk_recs, _syk_solve, syk_models = run(phase_syk)
    engines += syk_recs
    run(phase_syk_sharded, syk_models)
    del syk_models
    ell_cases, ell_launches, general_engines, (H_auto, auto) = run(
        phase_general)
    engines += general_engines
    one_tables = H_auto.get_mat().ell_tables.on(torch.float32,
                                                torch.device('cuda', 0))
    shard_ell, shard_launches = run(phase_general_sharded, H_auto, auto,
                                    one_tables)
    del H_auto, auto, one_tables
    torch.cuda.empty_cache()
    dist_recs = run(phase_distributed, xp_eval0)
    dist_rec = dist_recs[0]
    multinode = run(phase_multinode, dist_rec, xp_eval0, card)
    examples = run(phase_examples)
    # the tutorial's CPU runs need no card: they go beside the reference
    # suite, after the examples' host-timed sections
    with ThreadPoolExecutor(6) as tutorial_pool:
        tutorial_cpu = start_tutorial_cpu(tutorial_pool)
        reference = run(phase_reference_suite)
        tutorial = run(phase_tutorial, tutorial_cpu)
    cards = run(phase_cards, examples, reference, tutorial, card)
    interactive = run(phase_interactive, tutorial, card)
    emit({'phase_seconds': seconds,
          'total_s': time.perf_counter() - t_start})
    # the sharded ELL route's launches on the main path: the evolve over
    # virtual ranks, and the distributed solves over two ranks or more, on
    # one node and on two
    over_ranks = [r for r in dist_recs + [multinode]
                  if r is not None and r['world_size'] > 1]
    for rec in over_ranks:
        gen = rec['general']
        shard_launches += gen['routes']['ell']['ell_launches_all_ranks']
        shard_launches += gen['spinconserve_26'].get(
            'ell_launches_all_ranks', 0)
    xor_shard_launches = xp_shard_launches + dist_rec['launches_all_ranks']
    diag_builds = (launches['xor_diagonal'] + xp_shard_builds
                   + dist_rec['diag_builds_all_ranks'])
    if multinode is not None:
        xor_shard_launches += multinode['launches_all_ranks']
        diag_builds += multinode['diag_builds_all_ranks']
    if cards is not None:
        # the runs over every card (phase cards): each rank's launches
        xor_shard_launches += cards['launches_all_ranks']['xor_apply']
        diag_builds += cards['launches_all_ranks']['xor_diagonal']
        shard_launches += cards['launches_all_ranks']['ell_apply']
    # the interactive session's engines (phase interactive): one card runs
    # the one-device route, several the sharded one
    session = interactive['launches_all_ranks']
    if interactive['cards'] > 1:
        xor_shard_launches += session['xor_apply']
        shard_launches += session['ell_apply']
    else:
        launches['xor_apply'] += session['xor_apply']
        ell_launches += session['ell_apply']
    diag_builds += session['xor_diagonal']
    if not diag_builds > 0:
        raise RuntimeError('the main path built no diagonal stream')

    if 'jax' in sys.modules:
        raise RuntimeError('the port imported jax')

    main_case = next(r for r in rows if r['case'] == 'localized_full'
                     and r['dtype'] == 'float32')
    shard_case = next(r for r in sharded_rows
                      if r['case'] == 'localized_full'
                      and r['dtype'] == 'float32' and r['P'] == 4)
    ell_case = ell_cases[0]  # localized(24) on Auto(24), float32
    if not ell_launches > 0:
        raise RuntimeError('the main path launched no ELL kernel')
    if not shard_launches > 0:
        raise RuntimeError('the main path launched no sharded ELL kernel')
    # the sector and XOR-dense engines: torch ops and cuBLAS products, no
    # kernel of the port's own, so their records stand apart from the
    # kernels' line
    emit({'engines': engines})
    print(card, flush=True)
    emit({'kernels': [{
        'name': 'xor_apply',
        'route': 'cuda',
        'source': 'dynamite_tpu_torch/csrc/xor_apply.cu',
        'replaces': 'dynamite_tpu/ops/pallas_apply.py:309 via :468',
        'launches': launches['xor_apply'],
        'max_abs_err': max(r['max_abs_err'] for r in rows),
        'ms': main_case['ms'],
        'plain_ms': main_case['plain_ms'],
        'bound_ms': main_case['bound_ms'],
        'bound_by': main_case['bound_by'],
        'library_ms': main_case['library_ms'],
    }, {
        # localized(24), float32, P = 4 virtual shards: the sum of the four
        # launches; the yardstick is the same SpMV of the whole matrix;
        # launches those of the distributed solves (one node and, on two
        # cards or more, two emulated nodes) and of the XParity(Full(24))
        # solve over 4 virtual ranks
        'name': 'xor_apply_sharded',
        'route': 'cuda',
        'source': 'dynamite_tpu_torch/csrc/xor_apply.cu',
        'replaces': 'dynamite_tpu/ops/pallas_apply.py:309 via :497',
        'launches': xor_shard_launches,
        'max_abs_err': max(r['max_abs_err'] for r in sharded_rows),
        'ms': shard_case['ms_sum_of_P'],
        'plain_ms': shard_case['plain_ms_sum_of_P'],
        'bound_ms': shard_case['bound_ms'],
        'bound_by': shard_case['bound_by'],
        'library_ms': main_case['library_ms'],
    }, {
        # the diagonal stream of localized(24), float32, one device: built
        # once per operator, dtype and layout on both routes; ms is the
        # wrapper's call, kernel_ms the kernel alone (torch.profiler); the
        # error is the largest over the kernel cases and the folded
        # localized(24) (phase diagonal), each shard's over every layout
        # checked in kernel_sharded; no single PyTorch call computes it
        'name': 'xor_diagonal',
        'route': 'cuda',
        'source': 'dynamite_tpu_torch/csrc/xor_apply.cu',
        'replaces': 'dynamite_tpu/ops/pallas_apply.py:268 (compute_diagonal,'
                    ' the stream the kernel at :309 reads)',
        'launches': diag_builds,
        'max_abs_err': max(r.get('diag_max_abs_err', 0.0)
                           for r in rows + diag_rows),
        'ms': main_case['diag_build_ms'],
        'kernel_ms': main_case['diag_kernel_ms'],
        'plain_ms': main_case['diag_plain_ms'],
        'bound_ms': main_case['diag_bound_ms'],
        'bound_by': main_case['diag_bound_by'],
        'library_ms': None,
    }, {
        # localized(24) on Auto(24), float32; launches are those of the
        # general phase's eigsolve and evolve; the yardstick is cuSPARSE's
        # CSR SpMV of the same matrix
        'name': 'ell_apply',
        'route': 'cuda',
        'source': 'dynamite_tpu_torch/csrc/ell_apply.cu',
        'replaces': 'dynamite_tpu/ops/ell.py:252 (make_apply, XLA lax.scan; '
                    'no Pallas kernel)',
        'launches': ell_launches,
        'max_abs_err': max(r['max_abs_err'] for r in ell_cases),
        'ms': ell_case['ms'],
        'plain_ms': ell_case['plain_ms'],
        'bound_ms': ell_case['bound_ms'],
        'bound_by': ell_case['bound_by'],
        'library_ms': ell_case['library_ms'],
    }, {
        # the same kernel on each rank's own tables: localized(24) on
        # Auto(24), float32, over P = 4 virtual ranks, the sum of the four
        # launches (each with the gathered x); the yardstick is cuSPARSE's
        # SpMV of the whole matrix
        'name': 'ell_apply_sharded',
        'route': 'cuda',
        'source': 'dynamite_tpu_torch/csrc/ell_apply.cu',
        'replaces': 'dynamite_tpu/ops/ell.py:252 via ops/apply.py:984',
        'launches': shard_launches,
        'max_abs_err': shard_ell['max_abs_err'],
        'ms': shard_ell['ms_sum'],
        'plain_ms': shard_ell['plain_ms_sum'],
        'bound_ms': shard_ell['bound_ms_sum'],
        'bound_by': shard_ell['bound_by'],
        'library_ms': ell_case['library_ms'],
    }]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    if sys.argv[1:] == [CHILD_FLAG]:
        child_eigsolve_double()
    elif sys.argv[1:2] == [CHILD_DIST]:
        child_distributed(*map(int, sys.argv[2:6]), float(sys.argv[6]))
    elif sys.argv[1:] == [GROUP_COSTS]:
        group_costs()
    elif sys.argv[1:] == [SECTOR_FORMS]:
        sector_forms()
    elif sys.argv[1:] == [XOR_DENSE_LA]:
        require_card_and_port()
        xor_dense_la_sweep()
    elif sys.argv[1:] == [GENERAL_ONLY]:
        general_only()
    elif sys.argv[1:] == [MULTINODE_ONLY]:
        multinode_only()
    elif sys.argv[1:2] == [DIAGONAL]:
        diagonal_times(sys.argv[2:])
    elif sys.argv[1:2] == [CHILD_DIAGONAL]:
        child_diagonal(sys.argv[2])
    elif sys.argv[1:] == [EXAMPLES_ONLY]:
        require_card_and_port()
        phase_env()
        phase_examples()
    elif sys.argv[1:2] == [CHILD_EXAMPLE]:
        child_example(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:] == [REFERENCE_ONLY]:
        require_card_and_port()
        phase_env()
        phase_reference_suite()
    elif sys.argv[1:] == [CHILD_REFERENCE]:
        child_reference_suite()
    elif sys.argv[1:] == [TUTORIAL_ONLY]:
        require_card_and_port()
        phase_env()
        phase_tutorial()
    elif sys.argv[1:2] == [CHILD_NOTEBOOK]:
        child_notebook(sys.argv[2], (sys.argv[3:] or [None])[0])
    elif sys.argv[1:2] == [CHILD_CARDS]:
        child_cards(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:] == [INTERACTIVE_ONLY]:
        interactive_only()
    else:
        main()
