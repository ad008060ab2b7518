"""The port's twins of ``examples/*.py``: ``python -m repro_torch.examples.<name>``."""
