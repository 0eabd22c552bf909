"""verify_roofline for the light-client cell: see _roofline.py."""

from portbench.metrics._roofline import read  # noqa: F401
