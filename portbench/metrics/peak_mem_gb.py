"""The largest torch.cuda.max_memory_allocated over the window, on the
fullest card, in GB (1e9 bytes); also for ``peak_mem_gb.<suffix>``, a
cell whose peak gets a bound of its own."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
