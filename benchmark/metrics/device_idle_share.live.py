"""The device's idle share of the profiled slice (%) of a live cell, read
as ``device_idle_share`` is."""
from benchmark.harness import spec

read = spec.metric_reader("device_idle_share")
