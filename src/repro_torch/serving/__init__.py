"""Port of ``repro.serving``: the model zoo's prefill and decode, and the
anomaly-scoring service (``serving.anomaly``)."""
