"""The benchmark of dynamite_tpu_torch (see portbench/run.py)."""
