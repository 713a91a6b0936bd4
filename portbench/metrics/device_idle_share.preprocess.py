"""The share of a unit of the window with nothing running on the card (no
kernel, copy or set): the device-busy time a unit from the profiler's
device-only span over the window's time a unit."""

from portbench.metrics._common import idle_pct as read  # noqa: F401
