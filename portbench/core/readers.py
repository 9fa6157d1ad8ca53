"""Arithmetic shared by the metric readers (``portbench/metrics``). Each
returns None where the run holds nothing to read."""

from . import roofline


def per_step(run, key):
    """The mean over the window's steps of a per-step record."""
    values = [s[key] for s in run.steps if key in s]
    return sum(values) / len(values) if values else None


def step_seconds(run):
    """The window's wall seconds over the steps it completed."""
    return run.window_s / len(run.steps) if run.steps else None


def device_ms_per_step(run, category):
    """Device milliseconds a traced step charged to one category of
    ``trace.reduce`` ('krylov', 'matvec', ...); None without matvec ranges,
    which the categories are told apart by."""
    s = run.summary
    if not s or not s['steps'] or not s['matvecs']:
        return None
    return s['device_s'][category] / s['steps'] * 1e3


def matvec_roofline(run):
    """The least time of one H x (``roofline``) over the device time of
    one apply inside a solve, in %."""
    s, work = run.summary, getattr(run.study, 'work', None)
    if not s or not s['matvecs'] or not s['device_s']['matvec'] or not work:
        return None
    rows, itemsize, flops, dtype = work
    least, _ = roofline.least_seconds(rows, itemsize, flops, dtype)
    return least / (s['device_s']['matvec'] / s['matvecs']) * 100


def launches_per_apply(run):
    s = run.summary
    if not s or not s['matvecs']:
        return None
    return s['matvec_ops'] / s['matvecs']


def idle_percent(run):
    s = run.summary
    if not s or not s['window_s']:
        return None
    return (1 - s['busy_s'] / s['window_s']) * 100


def nccl_ms_per_step(run):
    s = run.summary
    if not s or not s['steps'] or not s['nccl_s']:
        return None
    return s['nccl_s'] / s['steps'] * 1e3
