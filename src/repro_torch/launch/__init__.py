"""Launch layer: the serving and training drivers
(``python -m repro_torch.launch.serve``, ``python -m repro_torch.launch.train``),
the mesh and sharding rules, and the dry run and perf harness
(``python -m repro_torch.launch.dryrun``, ``python -m repro_torch.launch.perf``)."""
