"""The harness: the manifest, the traffic generator, seeded weights,
spans and the profiler reader, the yardstick and the correctness check.
Runners, sources, metrics, architectures and tracker references sit in
files of their own, found by name (named.py)."""
