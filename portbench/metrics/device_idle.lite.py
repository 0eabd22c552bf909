"""device_idle for the light-client cell: see _idle.py."""

from portbench.metrics._idle import read  # noqa: F401
