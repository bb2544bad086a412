"""Launch layer: the serving and training drivers
(``python -m repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
