"""Port of ``repro.data``."""
