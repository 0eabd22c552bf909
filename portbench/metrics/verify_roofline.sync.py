"""verify_roofline for the sync cells: see _roofline.py."""

from portbench.metrics._roofline import read  # noqa: F401
