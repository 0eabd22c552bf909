"""verify_roofline for the valset cells: see _roofline.py."""

from portbench.metrics._roofline import read  # noqa: F401
