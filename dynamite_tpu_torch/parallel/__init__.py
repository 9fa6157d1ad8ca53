"""Process groups and the row layout of the distributed (one process per
GPU) XOR path."""
