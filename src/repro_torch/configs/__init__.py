"""Port of ``repro.configs``."""
