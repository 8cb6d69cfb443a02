"""Sharding on ``torch.distributed``: the counterpart of the reference's
``distributed/`` package.

- ``ctx``: the logical-axis rules (``TRAIN_RULES``, ``SERVE_RULES``,
  ``dp_rules``, ...) and the installed context (``use_sharding``);
- ``sharding``: the reference's spec functions, and their placements as
  DTensors (``shard_model``, ``shard_cache``);
- ``parallel``: the collectives of a sharded step on each rank's local
  tensors (the gathers, reductions and tensor parallelism GSPMD inserts
  for the reference);
- ``ring_attention``: sequence-parallel attention through the
  ``flash_attention`` kernel;
- ``compression``: the int8 error-feedback gradient all-reduce.

Meshes are built by ``repro_torch.launch.mesh.init_mesh`` (NCCL on
``cuda``, gloo on ``cpu``).
"""
