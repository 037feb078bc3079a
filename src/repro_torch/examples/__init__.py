"""The repo's five examples on the port, each the counterpart of the
``examples/`` script of the same name:

    python -m repro_torch.examples.<name> [--device cpu]

``quickstart`` and ``scenario_tour`` drive the scheduler through the array
drain; ``serve_batched`` serves three reduced model families;
``fl_multijob_training`` trains three reduced LMs under one Venn scheduler;
``elastic_restart`` checkpoints, restores and trains on.  Each runs on
``cuda:0`` unless given ``--device cpu``.
"""
