"""Measurement harnesses of the port, counterparts of the repo's
``experiments/`` scripts (``python -m analyzer_tpu_torch.experiments.<name>``)."""
