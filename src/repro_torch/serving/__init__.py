"""Port of ``repro.serving``: the model zoo's prefill and decode."""
