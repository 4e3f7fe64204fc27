"""The bank's host time a step (ms) of a live cell, read as
``bank_host_ms`` is."""
from benchmark.harness import spec

read = spec.metric_reader("bank_host_ms")
