"""The port of the repository's ``benchmarks/``: one module per JAX script,
of the same name, each run as
``python -m irm_motion_planning_tpu_torch.benchmarks.<name>``.

* ``quality``, ``quality_sweep``: the cross-backend quality gate and its
  seed sweep;
* ``certify``: the sequential oracle (``--phase oracle``) and the engine
  phase of both BLS ladder tiers against it (``--phase engine``);
* ``schedule_sweep``, ``hetero``: K2 (one penalty round) driven round by
  round, for inner schedules and for lane-compaction policies;
* ``epilogue``: K1's BLS step with one phase removed at a time
  (compile-time builds of csrc/warp_body.cuh, ``WB_ABLATE_*``);
* ``decompose``, ``ablation``, ``roofline``: the fleet solve's stages, the
  ``lambda_max_cost`` table, K5's and K1's rates against the H100's;
* ``problemsize``, ``scaling``, ``replan``: runtime against T, against
  devices and processes, and the replanning loop.

Each takes the JAX script's flags where they mean something on the card,
plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain versions as
a rehearsal at a small size), and prints the JAX script's JSON keys with
the card's name and power limit beside them.  Times come from CUDA events
or host clocks ended by ``torch.cuda.synchronize()``.
"""
