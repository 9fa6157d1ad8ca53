"""The run's refusal of JAX: no module whose top-level name (the part
before the first dot, compared whole) is one of ``REFUSED`` may be loaded
in the process that prints the result. ``dynamite_tpu_torch`` begins with
``dynamite_tpu`` and is allowed."""

import sys

REFUSED = ('jax', 'jaxlib', 'flax', 'dynamite_tpu')


def loaded_refused(modules=None):
    """The refused top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({n.partition('.')[0] for n in names}
                  & set(REFUSED))
