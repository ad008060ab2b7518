"""Port of ``repro.launch``: command-line entry points."""
