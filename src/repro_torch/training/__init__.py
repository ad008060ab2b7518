"""Port of ``repro.training``."""
