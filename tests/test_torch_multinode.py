"""
The port's ``parallel/multihost.py`` across nodes: the launchers'
environments (torchrun, SLURM's srun, Open MPI's mpirun) read as
``jax.distributed`` reads them, and the main path on two nodes emulated on
one host.

(a) The environment parsing, with no processes: SLURM's node list forms,
Open MPI's launcher URIs, the coordinator's host and port (equal to what
``jax._src.clusters`` derives on the same environment; the port never
imports it), the order of precedence, the refusals (a launcher's
environment missing a value, a local rank with no card, both spellings of
one argument), ``barrier(name)``, and the host in the build's scratch name.

(b) One run of 2 nodes x 2 ranks on gloo under SLURM's environment, each
node with its own working directory and ``TMPDIR``, its files in a
directory both share, ``multihost.initialize()`` with no arguments:
heisenberg(10) on Full(10) through the pairwise exchange (rank bit 1, the
node, is an exchange partner), its eigenvalues within 1e-10 of the JAX
package's on one device and evolve from the Neel state within 1e-8 of
``expm_multiply``; localized(10) on SpinConserve(10, 5) by ELL and by the
alpha ring, eigenvalues within 1e-10 of ``eigvalsh`` and the JAX
package's; an unseeded random state equal on every rank; ``Operator.save``
written by rank 0 alone and read on every node; ``State.save`` read back
on every node and by the JAX package; the consistency check refusing an
operator that differs on node 1; one profile trace a global rank;
``barrier('done')``.

(c) Light runs (rank, world, local rank, an all-reduce, a named barrier)
under Open MPI's environment, under torchrun's with ``--nnodes=2``'s
variables, and through the JAX package's explicit
``initialize('127.0.0.1:port', 4, k)``.

A rank runs this file as a script (see the bottom): it imports torch and
the port, neither JAX nor ``tests/conftest.py``, at one thread. The
coordinator's port is bound free first, in 61440-65535, and the job id
chosen that maps to it, so concurrent runs do not collide.
"""

import json
import os
import random
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BASE = 61440
L = 10
NODES, PER_NODE = 2, 2
# what a launcher sets that another run's environment must not leak in
LAUNCH_VARS = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE',
               'GROUP_RANK', 'MASTER_ADDR', 'MASTER_PORT', 'SLURM_PROCID',
               'SLURM_NTASKS', 'SLURM_LOCALID', 'SLURM_JOB_ID',
               'SLURM_STEP_NODELIST', 'SLURM_NODEID', 'OMPI_MCA_orte_hnp_uri',
               'OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_SIZE',
               'OMPI_COMM_WORLD_LOCAL_RANK', 'CUDA_VISIBLE_DEVICES',
               'NCCL_HOSTID')


@pytest.fixture(autouse=True)
def cpu_device():
    """The port's operators built here run on the CPU, which the port uses
    only when asked (the rank processes ask for their own device)."""
    from dynamite_tpu_torch import config
    saved = config._device
    config.device = 'cpu'
    yield
    config._device = saved


@pytest.fixture
def clean_env(monkeypatch):
    """No launcher's variables in this process's environment."""
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# -- (a) the environment, no processes --------------------------------------


def slurm_env(node_list='node001', job_id=1234, procid=1, ntasks=4, local=1):
    return {'SLURM_JOB_ID': str(job_id), 'SLURM_STEP_NODELIST': node_list,
            'SLURM_NTASKS': str(ntasks), 'SLURM_PROCID': str(procid),
            'SLURM_LOCALID': str(local)}


def ompi_env(uri, rank=3, size=4, local=1):
    return {'OMPI_MCA_orte_hnp_uri': uri, 'OMPI_COMM_WORLD_RANK': str(rank),
            'OMPI_COMM_WORLD_SIZE': str(size),
            'OMPI_COMM_WORLD_LOCAL_RANK': str(local)}


def torchrun_env(rank=2, world=4, local=0):
    return {'RANK': str(rank), 'WORLD_SIZE': str(world),
            'LOCAL_RANK': str(local), 'MASTER_ADDR': 'head',
            'MASTER_PORT': '29500'}


def _jax_coordinator(cluster, env, monkeypatch):
    """``jax._src.clusters``' coordinator address on ``env``, as (host,
    port)."""
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    host, port = cluster.get_coordinator_address(None, None).rsplit(':', 1)
    return host, int(port)


@pytest.mark.parametrize('node_list,host', [
    ('node001', 'node001'), ('node001,host2', 'node001'),
    ('node[001-015],host2', 'node001'), ('node[001,007-015]', 'node001'),
    ('gpu-a7', 'gpu-a7'), ('gpu[7-9]', 'gpu7')])
@pytest.mark.parametrize('job_id', [0, 1234, 4095, 4096, 987654321])
def test_slurm_coordinator_as_jax_derives_it(node_list, host, job_id,
                                            monkeypatch):
    from jax._src.clusters.slurm_cluster import SlurmCluster
    from dynamite_tpu_torch.parallel import multihost
    env = slurm_env(node_list, job_id)
    launch = multihost.detect_launch(env)
    assert launch == multihost.Launch('slurm', 1, 4, 1, host,
                                      job_id % 4096 + PORT_BASE)
    assert (launch.host, launch.port) == _jax_coordinator(SlurmCluster, env,
                                                          monkeypatch)
    assert PORT_BASE <= launch.port <= 65535


OMPI_URIS = {
    'tcp': ('1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911',
            '10.96.0.1'),
    'tcp_one': ('4096.0;tcp://192.168.1.7:50000', '192.168.1.7'),
    'tcp6': ('1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,'
             '2620:10d:c083:150e::3000:2]:43370', 'fe80::b9b:ac5d:9cf0:b858'),
    'tcp6_one': ('8192.0;tcp6://[::1]:43370', '::1'),
}


@pytest.mark.parametrize('name', sorted(OMPI_URIS))
def test_ompi_coordinator_as_jax_derives_it(name, monkeypatch):
    from jax._src.clusters.ompi_cluster import OmpiCluster
    from dynamite_tpu_torch.parallel import multihost
    uri, host = OMPI_URIS[name]
    env = ompi_env(uri)
    launch = multihost.detect_launch(env)
    jobid = int(uri.split('.')[0])
    assert launch == multihost.Launch('ompi', 3, 4, 1, host,
                                      (jobid // 4096) % 4096 + PORT_BASE)
    assert (launch.host, launch.port) == _jax_coordinator(OmpiCluster, env,
                                                          monkeypatch)
    assert multihost._tcp(launch.host, launch.port) == (
        f'tcp://[{host}]:{launch.port}' if ':' in host
        else f'tcp://{host}:{launch.port}')


def test_launcher_precedence():
    """torchrun's environment before SLURM's before Open MPI's; MASTER_ADDR
    and MASTER_PORT before the coordinator SLURM's or Open MPI's derives;
    no launcher at all is None."""
    from dynamite_tpu_torch.parallel.multihost import Launch, detect_launch
    slurm = slurm_env('node[3-4]', 5, procid=2, local=0)
    ompi = ompi_env('8192.0;tcp://10.0.0.9:1', rank=1, local=1)
    torchrun = torchrun_env(rank=3, local=1)
    assert detect_launch({**ompi, **slurm, **torchrun}) == \
        Launch('torchrun', 3, 4, 1)
    assert detect_launch({**ompi, **slurm}) == \
        Launch('slurm', 2, 4, 0, 'node3', 5 + PORT_BASE)
    assert detect_launch(ompi) == Launch('ompi', 1, 4, 1, '10.0.0.9',
                                         2 + PORT_BASE)
    master = {'MASTER_ADDR': 'head', 'MASTER_PORT': '29500'}
    assert detect_launch({**slurm, **master}) == \
        Launch('slurm', 2, 4, 0, 'head', 29500)
    assert detect_launch({**ompi, **master}) == \
        Launch('ompi', 1, 4, 1, 'head', 29500)
    assert detect_launch({**slurm, 'MASTER_PORT': '29500'}).host == 'node3'
    assert detect_launch({}) is None
    assert detect_launch({'SLURM_JOB_ID': '7', 'LOCAL_RANK': '0'}) is None


@pytest.mark.parametrize('env,missing', [
    ({**slurm_env(), 'SLURM_NTASKS': None}, 'SLURM_NTASKS'),
    ({**slurm_env(), 'SLURM_LOCALID': None}, 'SLURM_LOCALID'),
    ({**slurm_env(), 'SLURM_STEP_NODELIST': None}, 'SLURM_STEP_NODELIST'),
    ({**slurm_env(), 'SLURM_JOB_ID': None}, 'SLURM_JOB_ID'),
    ({**ompi_env('4096.0;tcp://10.0.0.1:1'), 'OMPI_COMM_WORLD_SIZE': None},
     'OMPI_COMM_WORLD_SIZE'),
    (ompi_env('4096.0;ud://10.0.0.1:1'), 'tcp6://'),
    ({'RANK': '1', 'WORLD_SIZE': '2'}, 'LOCAL_RANK'),
    ({'WORLD_SIZE': '2', 'LOCAL_RANK': '0'}, 'RANK')])
def test_launcher_env_without_a_value_raises(env, missing):
    """A launcher's environment that names several processes but lacks one
    of its values raises; it never reads as one process."""
    from dynamite_tpu_torch.parallel.multihost import detect_launch
    env = {k: v for k, v in env.items() if v is not None}
    with pytest.raises(ValueError, match=missing):
        detect_launch(env)


def test_slurm_task_joins_its_job(clean_env):
    """Under srun's environment (task 1 of 2), ``initialize()`` starts a
    group of 2 as rank 1 at the coordinator jax.distributed would use; it
    does not go on as rank 0 of 1."""
    import torch.distributed as dist
    from dynamite_tpu_torch.parallel import multihost
    for k, v in slurm_env('node[001-002]', 77, procid=1, ntasks=2,
                          local=0).items():
        clean_env.setenv(k, v)
    seen = {}

    def fake_init(backend, init_method, rank, world_size):
        seen.update(backend=backend, init_method=init_method, rank=rank,
                    world_size=world_size)
    clean_env.setattr(dist, 'init_process_group', fake_init)
    multihost.initialize()
    assert seen == {'backend': 'gloo', 'init_method':
                    f'tcp://node001:{77 + PORT_BASE}', 'rank': 1,
                    'world_size': 2}


def test_no_launcher_is_one_process(clean_env):
    """With neither arguments nor a launcher's environment, no group
    starts and nothing changes."""
    import torch.distributed as dist
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.parallel import multihost
    clean_env.setattr(dist, 'init_process_group', None)  # never called
    multihost.initialize()
    assert not multihost.is_initialized()
    assert (multihost.rank(), multihost.world_size()) == (0, 1)
    assert config.device.type == 'cpu'


@pytest.mark.parametrize('kwargs,both', [
    ({'coordinator_address': 'h:1', 'init_method': 'tcp://h:1'},
     'coordinator_address and init_method'),
    ({'num_processes': 2, 'world_size': 2}, 'num_processes and world_size'),
    ({'process_id': 0, 'rank': 0}, 'process_id and rank')])
def test_both_spellings_refused(kwargs, both, clean_env):
    from dynamite_tpu_torch.parallel import multihost
    with pytest.raises(TypeError, match=both):
        multihost.initialize(**kwargs)


def test_local_rank_without_a_card_refused(clean_env):
    """A local rank at or above the number of cards this process sees
    raises before any group starts, naming both numbers."""
    import torch
    import torch.distributed as dist
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.parallel import multihost
    clean_env.setattr(torch.cuda, 'device_count', lambda: 2)
    clean_env.setattr(torch.cuda, 'set_device', lambda device: None)
    clean_env.setattr(dist, 'init_process_group', None)  # never called
    assert multihost._card(1) == torch.device('cuda', 1)
    with pytest.raises(RuntimeError, match='local rank 2 .* sees 2 CUDA'):
        multihost._card(2)
    config.device = 'cuda'
    for k, v in slurm_env(procid=3, ntasks=4, local=2).items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match='local rank 2 .* sees 2 CUDA'):
        multihost.initialize()


def test_barrier_takes_a_name(monkeypatch):
    """``barrier(name)``, the JAX package's signature: a no-op in one
    process; over ranks, an error names the barrier."""
    import torch.distributed as dist
    from dynamite_tpu_torch.parallel import multihost
    multihost.barrier('done')
    multihost.barrier()

    def broken(**kwargs):
        raise dist.DistBackendError('Connection closed by peer')
    monkeypatch.setattr(multihost, 'world_size', lambda: 2)
    monkeypatch.setattr(dist, 'barrier', broken)
    with pytest.raises(RuntimeError, match="barrier 'done' failed on rank 0 "
                                           "of 2: Connection closed"):
        multihost.barrier('done')


def test_build_scratch_name_carries_the_host(tmp_path, monkeypatch):
    """Two hosts on one shared filesystem can have the same pid: the
    build's private name carries the host as well, and the rename to the
    library's name stays."""
    from dynamite_tpu_torch.utils import build
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(socket, 'gethostname', lambda: 'node007')
    compiler = tmp_path / 'cc'
    compiler.write_text(
        f'#!{sys.executable}\n'
        'import sys\n'
        'out = sys.argv[sys.argv.index("-o") + 1]\n'
        'open(out, "w").write(out)\n')
    compiler.chmod(0o755)
    source = tmp_path / 'k.cpp'
    source.write_text('int k;\n')
    got = build.build_shared_library(str(compiler), ('-O2',), source,
                                     'libk.so')
    scratch = got['path'].read_text()
    assert os.path.basename(scratch) == f'libk.node007.{os.getpid()}.so'
    assert got['path'].name == 'libk.so' and not os.path.exists(scratch)


NCCL_LOG = """\
node0:4101:4101 [0] NCCL INFO comm 0x5581 rank 0 nRanks 4 nNodes 2 localRanks 2 localRank 0 MNNVL 0
node0:4101:4130 [0] NCCL INFO Channel 00/02 : 0 1 2 3
node0:4101:4130 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM/read
node0:4101:4130 [0] NCCL INFO Channel 00/0 : 3[1] -> 0[0] [receive] via NET/Socket/0
node0:4101:4130 [0] NCCL INFO Channel 01/0 : 0[18000] -> 2[2a000] [send] via NET/Socket/0/Shared
node0:4101:4101 [0] NCCL INFO comm 0x77a0 rank 0 nRanks 2 nNodes 1 localRanks 2 localRank 0 MNNVL 0
node0:4101:4130 [0] NCCL INFO Connected all rings
"""


def test_nccl_log_links():
    """chip_smoke.py's reading of an ``NCCL_DEBUG=INFO`` log: the
    transports of the link lines and each communicator's (ranks, nodes)."""
    sys.path.insert(0, REPO)
    from chip_smoke import nccl_links
    assert nccl_links(NCCL_LOG) == {
        'transports': ['NET/Socket', 'P2P/CUMEM'],
        'nccl_comms_ranks_nodes': [(2, 1), (4, 2)]}
    assert nccl_links('') == {'transports': [], 'nccl_comms_ranks_nodes': []}


# -- (b), (c) the emulated nodes ---------------------------------------------


def free_port():
    """A port in 61440-65535 that is free on every interface now."""
    for port in random.sample(range(PORT_BASE, 65536), 200):
        with socket.socket() as s:
            try:
                s.bind(('', port))
            except OSError:
                continue
            return port
    raise RuntimeError('no free port in 61440-65535')


def launcher_env(launcher, rank, world, local, node, port):
    """The variables ``launcher`` sets for ``rank`` on ``node``, its
    coordinator at ``port`` on this host."""
    if launcher == 'slurm':
        return {'SLURM_JOB_ID': str(port - PORT_BASE),
                'SLURM_STEP_NODELIST': 'localhost,127.0.0.1',
                'SLURM_STEP_NUM_NODES': '2', 'SLURM_NODEID': str(node),
                'SLURM_NTASKS': str(world), 'SLURM_PROCID': str(rank),
                'SLURM_LOCALID': str(local)}
    if launcher == 'ompi':
        return {'OMPI_MCA_orte_hnp_uri':
                f'{4096 * (port - PORT_BASE)}.0;tcp://127.0.0.1,'
                f'10.255.0.1:40000',
                'OMPI_COMM_WORLD_RANK': str(rank),
                'OMPI_COMM_WORLD_SIZE': str(world),
                'OMPI_COMM_WORLD_LOCAL_RANK': str(local)}
    if launcher == 'torchrun':
        # torchrun --nnodes=2 --nproc-per-node=2's variables
        return {'RANK': str(rank), 'WORLD_SIZE': str(world),
                'LOCAL_RANK': str(local), 'LOCAL_WORLD_SIZE': str(world // 2),
                'GROUP_RANK': str(node), 'MASTER_ADDR': '127.0.0.1',
                'MASTER_PORT': str(port)}
    assert launcher == 'explicit'
    return {}


def spawn_nodes(case, tmp_path, launcher='slurm', nodes=NODES,
                per_node=PER_NODE, device='cpu', extra_env=None,
                timeout=180):
    """Run ``case`` on ``nodes`` emulated nodes of ``per_node`` ranks each,
    all at once: every rank with ``launcher``'s variables, its node's
    working directory and ``TMPDIR``, and the directory ``tmp_path /
    'shared'`` for the files both nodes read; on the card, each node its
    own ``CUDA_VISIBLE_DEVICES`` block and ``NCCL_HOSTID``; plus
    ``extra_env(node, rank)``. Returns the per-rank JSON records."""
    world = nodes * per_node
    port = free_port()
    shared = tmp_path / 'shared'
    shared.mkdir(exist_ok=True)
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    base.pop('XLA_FLAGS', None)
    base.update(PYTHONPATH=REPO, OMP_NUM_THREADS='1', MKL_NUM_THREADS='1',
                OPENBLAS_NUM_THREADS='1', GLOO_SOCKET_IFNAME='lo')
    procs = []
    for r in range(world):
        node, local = divmod(r, per_node)
        home = tmp_path / f'node{node}'
        (home / 'tmp').mkdir(parents=True, exist_ok=True)
        env = dict(base, TMPDIR=str(home / 'tmp'),
                   **launcher_env(launcher, r, world, local, node, port))
        if device == 'cuda':
            env.update(CUDA_VISIBLE_DEVICES=','.join(
                str(node * per_node + i) for i in range(per_node)),
                NCCL_HOSTID=f'node{node}')
        if extra_env is not None:
            env.update(extra_env(node, r))
        args = [sys.executable, os.path.abspath(__file__), case, launcher,
                str(shared), device]
        if launcher == 'explicit':
            args += [f'127.0.0.1:{port}', str(world), str(r)]
        procs.append(subprocess.Popen(args, cwd=home, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'rank {r} of {world} failed:\n{out}'
    return [json.loads((shared / f'rank{r}.json').read_text())
            for r in range(world)]


@pytest.fixture
def one_blas_thread():
    from threadpoolctl import threadpool_limits
    with threadpool_limits(limits=1, user_api='blas'):
        yield


def test_two_nodes_main_path(tmp_path, one_blas_thread):
    """(b): the main path on 2 nodes x 2 ranks under SLURM's environment
    (the module docstring lists what is held to what)."""
    from scipy.sparse.linalg import expm_multiply
    from dynamite_tpu import subspaces as ref_subspaces
    from dynamite_tpu.models import heisenberg as ref_heisenberg
    from dynamite_tpu.models import localized as ref_localized
    from dynamite_tpu.states import State as RefState
    from dynamite_tpu_torch.models import heisenberg, localized
    from dynamite_tpu_torch.operators import Operator
    from dynamite_tpu_torch.states import State
    from dynamite_tpu_torch.subspaces import Full, SpinConserve
    from tests.test_torch_distributed import _one_device_ref

    recs = spawn_nodes('main', tmp_path)
    shared = tmp_path / 'shared'
    world = NODES * PER_NODE
    for r, rec in enumerate(recs):
        node, local = divmod(r, PER_NODE)
        assert (rec['rank'], rec['world'], rec['local_rank'],
                rec['launcher']) == (r, world, local, 'slurm')
        home = os.path.realpath(tmp_path / f'node{node}')
        assert rec['cwd'] == home
        assert rec['tmpdir'] == os.path.join(home, 'tmp')
        # the exchange reaches the other node (rank bit 1) and this one
        assert {p // PER_NODE != node for p in rec['partners']} == \
            {True, False}, rec['partners']
        assert rec['exchanges'] > 0
    keys = ('crc', 'full_evals', 'evolve_err', 'sc')
    assert all(rec[k] == recs[0][k] for rec in recs for k in keys)

    H, sub = heisenberg(L), Full(L=L)
    H.add_subspace(sub)
    M = H.to_numpy()
    exact = np.linalg.eigvalsh(M.toarray())[:2]
    got = np.asarray(recs[0]['full_evals'])
    assert np.allclose(got, exact, rtol=1e-10, atol=0)
    with _one_device_ref():
        H_ref = ref_heisenberg(L)
        s_ref = ref_subspaces.Full(L=L)
        H_ref.add_subspace(s_ref)
        want = H_ref.eigsolve(nev=2, subspace=s_ref)
    assert np.allclose(got, np.sort(want)[:2], rtol=1e-10, atol=0)
    assert recs[0]['evolve_err'] < 1e-8

    Hs, ssub = localized(L), SpinConserve(L, L // 2)
    Hs.add_subspace(ssub)
    exact = np.linalg.eigvalsh(Hs.to_numpy().toarray())[:2]
    with _one_device_ref():
        H_ref = ref_localized(L)
        s_ref = ref_subspaces.SpinConserve(L, L // 2)
        H_ref.add_subspace(s_ref)
        want = np.sort(H_ref.eigsolve(nev=2, subspace=s_ref))[:2]
    for route in ('sector_ring', 'ell'):
        one = recs[0]['sc'][route]
        assert one['engine'] == route
        assert np.allclose(one['evals'], exact, rtol=1e-10, atol=0), route
        assert np.allclose(one['evals'], want, rtol=1e-10, atol=0), route

    # Operator.save: rank 0 wrote, the others opened nothing for writing,
    # and every node read back the terms
    assert recs[0]['op_writes'] == 1
    assert [r['op_writes'] for r in recs[1:]] == [0] * (world - 1)
    assert all(r['op_loaded'] for r in recs)
    assert (shared / 'H.msc').read_bytes() == H.serialize()
    assert Operator.load(str(shared / 'H.msc')).msc.tobytes() == \
        H.msc.tobytes()
    # State.save: every node read its rows back bitwise; the JAX package
    # reads the file the ranks wrote
    assert all(r['state_reloaded'] for r in recs)
    neel = State(state='UD' * (L // 2), subspace=sub).to_numpy()
    with _one_device_ref():
        loaded = RefState.from_file(str(shared / 'evolved'))
        back = loaded.to_numpy()
    oracle = expm_multiply(-1j * 0.3 * M, neel)
    assert np.abs(back - oracle).max() < 1e-8
    # the operator of another seed on node 1: refused on every rank
    assert all('inconsistent across ranks' in r['mixed_error'] for r in recs)
    # one trace a global rank, in the directory both nodes share
    traces = sorted(os.listdir(shared / 'profiles'))
    assert [t.split('.')[0] for t in traces] == \
        [f'evolve_rank{r}' for r in range(world)]
    assert all(r['done'] for r in recs)


def light_planes():
    v = np.random.RandomState(11).standard_normal((2, 1 << L))
    return v / np.linalg.norm(v)


def check_light(recs, shared, launcher, per_node=PER_NODE):
    """The light runs' records: each rank its rank, world and local rank
    and the all-reduce's sum; heisenberg(10)'s dot within 1e-12 of numpy's
    (relative to max|y|, float64)."""
    from dynamite_tpu_torch.models import heisenberg
    from dynamite_tpu_torch.subspaces import Full
    world = len(recs)
    for r, rec in enumerate(recs):
        assert (rec['rank'], rec['world'], rec['sum']) == \
            (r, world, world * (world + 1) // 2)
        assert rec['launcher'] == (None if launcher == 'explicit'
                                   else launcher)
        if launcher != 'explicit':
            assert rec['local_rank'] == r % per_node
    H = heisenberg(L)
    H.add_subspace(Full(L=L))
    v = light_planes()
    want = H.to_numpy() @ (v[0] + 1j * v[1])
    got = np.load(shared / 'hv.npy')
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize('launcher', ['ompi', 'torchrun', 'explicit'])
def test_two_nodes_light(launcher, tmp_path):
    """(c): initialize from Open MPI's environment, torchrun's at
    ``--nnodes=2``, or the JAX package's explicit ``initialize(address,
    num_processes, process_id)``: each rank its rank, world and local
    rank, an all-reduce over both nodes, a named barrier, and a matvec
    whose exchange crosses the nodes."""
    recs = spawn_nodes('light', tmp_path, launcher)
    check_light(recs, tmp_path / 'shared', launcher)


# -- the rank processes ---------------------------------------------------


def _rank_main(case, launcher, shared, device, args):
    import builtins
    import tempfile
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from dynamite_tpu_torch import config
    from dynamite_tpu_torch.parallel import multihost

    config.device = device
    if launcher == 'explicit':
        address, n, k = args
        multihost.initialize(address, int(n), int(k))
    else:
        multihost.initialize()
    assert 'jax' not in sys.modules and 'dynamite_tpu' not in sys.modules
    me = multihost.rank()
    launch = multihost.detect_launch()
    rec = {'rank': me, 'world': multihost.world_size(),
           'launcher': None if launch is None else launch.launcher,
           'local_rank': None if launch is None else launch.local_rank,
           'cwd': os.getcwd(),
           'tmpdir': os.path.realpath(tempfile.gettempdir())}
    if device == 'cuda':
        rec['card'] = str(config.device)
        rec['host_id'] = os.environ.get('NCCL_HOSTID')

    if case == 'light':
        from dynamite_tpu_torch.models import heisenberg
        from dynamite_tpu_torch.states import State
        from dynamite_tpu_torch.subspaces import Full
        t = torch.tensor([float(me + 1)], device=config.device)
        dist.all_reduce(t)
        rec['sum'] = float(t)
        multihost.barrier('light')
        # a matvec whose exchange crosses the nodes (rank bit 0 at 2 ranks,
        # bit 1 at 4)
        H, sub = heisenberg(L), Full(L=L)
        H.add_subspace(sub)
        psi = State(subspace=sub)
        psi.set_planes(light_planes())
        hv = H.dot(psi).to_numpy()
        if me == 0:
            np.save(os.path.join(shared, 'hv.npy'), hv)
    elif case == 'main':
        from scipy.sparse.linalg import expm_multiply
        from dynamite_tpu_torch.models import heisenberg, localized
        from dynamite_tpu_torch import tracing
        from dynamite_tpu_torch.operators import Operator
        from dynamite_tpu_torch.states import State
        from dynamite_tpu_torch.subspaces import Full, SpinConserve

        config.L = L
        v = State(state='random').to_numpy()
        rec['crc'] = zlib.crc32(v.tobytes())

        H, sub = heisenberg(L), Full(L=L)
        H.add_subspace(sub)
        pairs = tracing.counter('transport.exchange.pairs')
        rec['full_evals'] = [float(e) for e in H.eigsolve(nev=2)]
        tables = H.get_mat().tables.for_layout(L - 2)
        rec['partners'] = [me ^ m for m in tables.hi_list if m]
        rec['exchanges'] = tracing.counter('transport.exchange.pairs') - pairs
        s0 = State(state='UD' * (L // 2), subspace=sub)
        config.profile_dir = os.path.join(shared, 'profiles')
        out = H.evolve(s0, 0.3)
        config.profile_dir = None
        got = out.to_numpy()
        want = expm_multiply(-1j * 0.3 * H.to_numpy(), s0.to_numpy())
        rec['evolve_err'] = float(np.abs(got - want).max())

        # files in the directory both nodes share
        opened = []
        real_open = builtins.open

        def spy(file, mode='r', *a, **k):
            if any(c in mode for c in 'wax+'):
                opened.append(file)
            return real_open(file, mode, *a, **k)
        builtins.open = spy
        try:
            H.save(os.path.join(shared, 'H.msc'))
        finally:
            builtins.open = real_open
        rec['op_writes'] = len(opened)
        back = Operator.load(os.path.join(shared, 'H.msc'))
        rec['op_loaded'] = back.msc.tobytes() == H.msc.tobytes()
        out.save(os.path.join(shared, 'evolved'))
        loaded = State.from_file(os.path.join(shared, 'evolved'))
        rec['state_reloaded'] = bool(torch.equal(loaded.data, out.data))

        rec['sc'] = {}
        for route, use_sector in (('sector_ring', True), ('ell', False)):
            config.use_sector = use_sector
            Hs = localized(L)
            Hs.add_subspace(SpinConserve(L, L // 2))
            rec['sc'][route] = {'engine': Hs.get_mat().engine,
                                'evals': [float(e) for e in
                                          Hs.eigsolve(nev=2)]}
        config.use_sector = True

        # node 1 draws its random fields with another seed
        Hm = localized(L, seed=me // PER_NODE)
        Hm.add_subspace(sub)
        try:
            Hm.get_mat()
            rec['mixed_error'] = ''
        except RuntimeError as err:
            rec['mixed_error'] = str(err)
        multihost.barrier('done')
        rec['done'] = True
    else:
        raise ValueError(case)

    with open(os.path.join(shared, f'rank{me}.json'), 'w') as f:
        json.dump(rec, f)
    multihost.barrier('records')
    multihost.shutdown()


if __name__ == '__main__':
    _rank_main(*sys.argv[1:5], sys.argv[5:])
