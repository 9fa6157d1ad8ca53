"""
The JAX package's own test suite (``tests/unit``, ``tests/integration``)
against the port: which files run unchanged on the port through
``python -m dynamite_tpu_torch.switch --pytest``, which cannot, and what in
the port's tests mirrors each case of those. Plain data, checked by
``tests/test_torch_reference_suite.py`` and read by ``chip_smoke.py``'s
phase ``reference_suite``; not a test (pytest does not collect it), and
importing it imports neither JAX nor the JAX package.

Paths are relative to ``tests/``; a case is ``name`` or ``Class::name``; a
mirror is ``test_torch_*.py::name`` or a mark.
"""

#: (a) the reference test files that run unchanged on the port: every file
#: under tests/unit and tests/integration that does not import JAX, except
#: the two whose subprocesses run the JAX package itself (MIRRORED).
UNCHANGED = [
    'unit/test_bitwise.py',
    'unit/test_msc.py',
    'unit/test_native.py',
    'unit/test_operators.py',
    'unit/test_sectors.py',
    'unit/test_states.py',
    'unit/test_subspaces.py',
    'integration/test_eigsolve.py',
    'integration/test_entropies.py',
    'integration/test_evolve.py',
    'integration/test_matrices.py',
    'integration/test_norm.py',
    'integration/test_operators.py',
    'integration/test_states.py',
    'integration/test_subspaces.py',
]

#: A case that tests a workaround for the TPU or XLA that the port does not
#: take over (ROADMAP.md, "Not to port").
TPU_WORKAROUND = 'not ported: TPU workaround'
#: A case of the reference's harnesses (``bench.py``, ``benchmarks/``),
#: which ROADMAP.md item 6 ports in the benchmark PR, not in a slice.
BENCHMARK_PR = 'not ported: the benchmark PR (ROADMAP item 6)'

#: (b) the reference test files that cannot run unchanged on the port, why,
#: and the port's test that mirrors each of their cases.
MIRRORED = {
    'unit/test_hoist.py': {
        'why': 'imports jax: tests utils/hoist.py hjit, an XLA workaround',
        'cases': {
            'test_hjit_matches_plain': TPU_WORKAROUND,
            'test_hjit_hoists_large_consts': TPU_WORKAROUND,
            'test_hjit_kernel_tables_are_arguments': TPU_WORKAROUND,
        },
    },
    'unit/test_tools.py': {
        'why': 'imports jax (jax.numpy arrays for the memory tracking and '
               'the cvec helpers)',
        'cases': {
            'test_mpi_print': 'test_torch_tools.py::test_mpi_print',
            'test_version': 'test_torch_tools.py::test_version',
            'test_memory_tracking':
                'test_torch_tools.py::test_memory_tracking',
            'test_comm_shim': 'test_torch_tools.py::test_comm_shim',
            'test_complex_enabled':
                'test_torch_tools.py::test_complex_enabled',
            'test_spectral_site_order':
                'test_torch_tools.py::test_spectral_site_order',
            'TestCvec::test_vdot': 'test_torch_reference_mirrors.py::test_cvec',
            'TestCvec::test_norm': 'test_torch_reference_mirrors.py::test_cvec',
            'TestCvec::test_axpby':
                'test_torch_reference_mirrors.py::test_cvec',
            'TestCvec::test_mul_elementwise':
                'test_torch_reference_mirrors.py::test_cvec',
            'TestCvec::test_scale_complex':
                'test_torch_reference_mirrors.py::test_cvec',
        },
    },
    'integration/test_minres.py': {
        'why': 'imports jax (jax.numpy right-hand sides)',
        'cases': {
            'test_indefinite_interior_shift':
                'test_torch_minres.py::test_solve_vs_reference_and_dense',
            'test_definite_shift':
                'test_torch_minres.py::test_solve_vs_reference_and_dense',
            'test_subspace_shift':
                'test_torch_minres.py::test_solve_vs_reference_and_dense',
            'test_zero_rhs': 'test_torch_minres.py::test_zero_rhs',
        },
    },
    'integration/test_multiply.py': {
        'why': 'imports jax (the 8-device mesh, the traced engines)',
        'cases': {
            'test_models_subspaces':
                'test_torch_xor_apply.py::test_dot_and_norm_vs_reference',
            'test_explicit_shuffled':
                'test_torch_general.py::test_applies_match_reference',
            'test_auto': 'test_torch_general.py::test_applies_match_reference',
            'test_xparity_full':
                'test_torch_sectors.py::test_xparity_xor_vs_reference',
            'test_xparity_spinconserve':
                'test_torch_sectors.py::'
                'test_sector_apply_xparity_vs_reference',
            'test_projection_full_to_sub':
                'test_torch_spinconserve.py::'
                'test_projection_gate_and_rectangular_engine',
            'test_sub_to_full_embedding':
                'test_torch_reference_mirrors.py::test_sub_to_full_embedding',
            'test_sharded_path_used':
                'test_torch_sharded_kernel.py::'
                'test_sharded_route_vs_one_block_and_reference',
            'test_scan_path': TPU_WORKAROUND,
            'test_chunked_path': TPU_WORKAROUND,
            'test_expectation':
                'test_torch_reference_mirrors.py::test_expectation',
            'test_sector_engine_mbl':
                'test_torch_sectors.py::test_sector_apply_vs_reference',
            'test_xor_dense_engine_syk':
                'test_torch_xor_dense.py::test_apply_float64',
            'test_sector_engine_disabled_falls_back':
                'test_torch_general.py::test_dispatch',
        },
    },
    'integration/test_pallas.py': {
        'why': 'imports jax: the Pallas kernel in interpret mode, which the '
               'port replaces by csrc/xor_apply.cu (held against its plain '
               'version on the card by test_torch_cuda.py and chip_smoke.py)',
        'cases': {
            'test_pallas_vs_engine':
                'test_torch_xor_tiles.py::test_tile_tables_vs_reference',
            'test_pallas_sharded_vs_oracle':
                'test_torch_sharded_kernel.py::'
                'test_sharded_route_vs_one_block_and_reference',
        },
    },
    'integration/test_precision.py': {
        'why': 'imports jax (its snippets set the JAX precision in '
               'subprocesses)',
        'cases': {
            'TestSinglePrecision::test_evolve_f32':
                'test_torch_solvers.py::'
                'test_single_precision_evolve_and_eigsolve',
            'TestSinglePrecision::test_eigsolve_f32':
                'test_torch_solvers.py::'
                'test_single_precision_evolve_and_eigsolve',
            'TestSinglePrecision::test_entropy_f32':
                'test_torch_rdm.py::test_rdm_float32',
            'TestLargeL::test_L34_explicit_subspace':
                'test_torch_large_l.py::test_L34_explicit_subspace',
            'TestLargeL::test_L33_parity_matvec':
                'test_torch_large_l.py::test_L33_auto_subspace',
            'TestLargeL::test_serialization_L40':
                'test_torch_large_l.py::test_serialization_L40',
        },
    },
    'integration/test_rdm.py': {
        'why': 'imports jax (the mesh and the on-device RDM)',
        'cases': {
            'test_rdm_oracle':
                'test_torch_rdm.py::test_rdm_against_jax_and_host',
            'test_keep_all_is_pure': 'test_torch_rdm.py::test_keep_all_is_pure',
            'test_product_state_zero_entropy':
                'test_torch_rdm.py::test_product_state_zero_entropy',
            'test_complement_symmetry':
                'test_torch_rdm.py::test_complement_symmetry',
            'test_device_matches_host':
                'test_torch_rdm.py::test_rdm_against_jax_and_host',
            'test_rdm_sharded_mesh':
                'test_torch_distributed.py::test_rdm_gathered_to_rank0',
            'test_rdm_errors': 'test_torch_rdm.py::test_validation',
        },
    },
    'integration/test_sector_shard.py': {
        'why': 'imports jax (the sector engine over a jax.sharding mesh)',
        'cases': {
            'test_heisenberg_ring':
                'test_torch_reference_mirrors.py::'
                'test_spinconserve_over_ranks',
            'test_mbl_diag_and_cross':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_long_range_many_groups':
                'test_torch_reference_mirrors.py::'
                'test_spinconserve_over_ranks',
            'test_xparity_wrapped':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_double_default_tight':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_solver_integration':
                'test_torch_distributed.py::test_general_routes',
            'test_memory_scales_with_devices':
                'test_torch_sharded_general.py::'
                'test_ring_tables_scale_with_ranks',
            'test_ring_general_path':
                'test_torch_sharded_general.py::test_routes_match_reference',
        },
    },
    'integration/test_sharded.py': {
        'why': 'imports jax (the 8-device mesh)',
        'cases': {
            'test_spinconserve_general_path':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_spinconserve_syk_scan_path':
                'test_torch_reference_mirrors.py::'
                'test_spinconserve_over_ranks',
            'test_explicit_general_path':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_full_xor_path_matches_general':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_sharded_eigsolve': 'test_torch_distributed.py::test_eigsolve',
            'test_sharded_eigsolve_spinconserve':
                'test_torch_distributed.py::test_general_routes',
            'test_sharded_target_eigsolve':
                'test_torch_distributed.py::test_target_eigsolve',
            'test_parity_sharded_evolution':
                'test_torch_reference_mirrors.py::'
                'test_parity_evolution_over_ranks',
        },
    },
    'integration/test_uneven.py': {
        'why': 'imports jax (meshes of 6 and 8 devices)',
        'cases': {
            'test_storage_dim': 'test_torch_sharded_general.py::test_storage_dim',
            'test_uneven_spinconserve_matvec':
                'test_torch_sharded_general.py::test_routes_match_reference',
            'test_six_device_mesh':
                'test_torch_distributed.py::'
                'test_layouts_the_xor_path_cannot_take',
            'test_uneven_eigsolve_c20_10':
                'test_torch_distributed.py::test_general_routes',
            'test_uneven_save_load_streamed':
                'test_torch_distributed.py::'
                'test_state_files_and_convert_over_ranks',
            'test_xparity_convert_device_roundtrip':
                'test_torch_distributed.py::'
                'test_state_files_and_convert_over_ranks',
        },
    },
    'integration/test_harnesses.py': {
        'why': 'its subprocesses run the JAX package itself (bench.py, '
               'benchmarks/benchmark.py, the example scripts, nbconvert on '
               'a notebook whose setup cell imports jax)',
        'cases': {
            'test_benchmark_harness': BENCHMARK_PR,
            'test_benchmark_subspace': BENCHMARK_PR,
            'test_bench_json': BENCHMARK_PR,
            'test_tutorial_notebook_executes':
                'test_torch_tutorial.py::test_notebook_vs_jax',
            'test_example_mbl': 'test_torch_examples.py::test_mbl_vs_reference',
            'test_example_floquet':
                'test_torch_examples.py::test_floquet_vs_reference',
            'test_example_syk': 'test_torch_examples.py::test_syk_on_port',
            'test_example_kagome':
                'test_torch_examples.py::test_kagome_vs_reference',
        },
    },
    'integration/test_multiprocess.py': {
        'why': 'its worker processes (multiprocess_worker.py) import jax',
        'cases': {
            'test_two_process_distributed':
                'test_torch_distributed.py::test_multiprocess_contracts',
        },
    },
}

#: (c) tests of UNCHANGED files that the port's run leaves out, by node id
#: prefix (``--deselect``), each with its reason: a TPU or XLA workaround of
#: ROADMAP.md's "Not to port", a test of JAX-only internals, or a reference
#: fault logged in ROADMAP.md queue 3. None is needed.
EXCLUDED = {}

#: Names that the reference's tests, examples and notebooks import from the
#: JAX package and that the port does not have, with why.
UNRESOLVED_NAMES = {
    ('dynamite_tpu.computations', '_state_sharding'):
        "a jax.sharding helper of examples/scripts/sharded_spinconserve/"
        "run_sharded.py, which drives JAX itself; its port "
        "run_sharded_torch.py runs on the port's process groups",
    ('dynamite_tpu.ops.pallas_apply', 'build_pallas_apply'):
        'the Pallas kernel, replaced by csrc/xor_apply.cu '
        '(ops/xor_apply.py::xor_apply)',
    ('dynamite_tpu.ops.pallas_apply', 'build_pallas_sharded_parts'):
        'the Pallas kernel, replaced by csrc/xor_apply.cu '
        '(ops/xor_apply.py::xor_apply_sharded)',
    ('dynamite_tpu.parallel.mesh', 'AXIS'):
        "the jax.sharding mesh axis; the port's ranks are process groups "
        'or ops/apply.py::VirtualTransport',
    ('dynamite_tpu.parallel.mesh', 'device_put_state'):
        "places a state on a jax.sharding mesh; the port's states hold "
        "their rank's rows",
    ('dynamite_tpu.parallel.mesh', 'make_mesh'):
        "builds a jax.sharding mesh; the port's ranks are process groups "
        'or ops/apply.py::VirtualTransport',
    ('dynamite_tpu.utils.hoist', 'hjit'):
        'an XLA workaround (ROADMAP.md, "Not to port")',
}
