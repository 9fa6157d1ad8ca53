"""Device operations (kernels, memcpys, memsets) charged to one apply
inside a solve."""

from portbench.core.readers import launches_per_apply


def read(run):
    return launches_per_apply(run)
