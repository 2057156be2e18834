"""One reader per metric of ``BENCHMARK.json``, found by the metric's name:
``read(run) -> float | None``, where ``run`` is ``harness.Reading``. A
reader that finds nothing to read returns None, and the metric is left out
of the line."""
