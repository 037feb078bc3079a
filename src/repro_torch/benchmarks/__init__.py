"""The paper's reproduction suite on the port: one module per table or
figure (Tables 1-4, Figures 10-14), the scenario bench, the kernel bench and
the hot-path record with its regression gate (``bench_hotpath``,
``regress``), each the counterpart of the repo's ``benchmarks/`` module of
the same name.

    python -m repro_torch.benchmarks.run [names] [--device cpu]

Rows are ``name,us_per_call,derived``, as in the reference; simulations run
the array drain and VENN's replan on ``cuda:0`` unless ``--device cpu``.
``REPRO_BENCH_FAST=1`` runs seed 1 and 30 jobs.
"""
