"""device_idle for the sync cells: see _idle.py."""

from portbench.metrics._idle import read  # noqa: F401
