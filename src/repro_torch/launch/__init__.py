"""Entry points: the trainer (``python -m repro_torch.launch.train``)."""
