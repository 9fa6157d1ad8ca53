"""The benchmark harness (see portbench/run.py)."""
