"""Wall seconds a cycle on one card: the window, which ends at a device
sync, over the steps it completed (host clock)."""

from portbench.core.readers import step_seconds as read  # noqa: F401
