"""Port of ``repro.models``."""
