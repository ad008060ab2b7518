"""Port of ``repro.core``: ``topology``, ``failure`` (failure specs and
traces, the Monte-Carlo trace samplers, alive masks on the device),
``aggregation``, ``simulate`` (the Tol-FL round loop with a leading
scenario axis) and ``campaign`` (batched (cell x trace x seed) failure
campaigns over that loop)."""
