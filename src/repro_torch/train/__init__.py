"""repro_torch.train — format-4 checkpoints (``checkpoint.py``), the port
of the JAX package's ``train/checkpoint.py``. The training scaffold of
the JAX package's ``train/`` is not ported yet."""
