"""device_idle for the valset cells: see _idle.py."""

from portbench.metrics._idle import read  # noqa: F401
