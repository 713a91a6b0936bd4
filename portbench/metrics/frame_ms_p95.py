"""The 95th percentile (nearest rank) of the window's frame times on the
host clock, each from the call to the frame's rgb and depth on the host."""

import math


def read(rec):
    xs = sorted(rec["window"].get("frame_s", []))
    if len(xs) < 20:  # fewer than one sample beyond the percentile
        return None
    return 1e3 * xs[math.ceil(0.95 * len(xs)) - 1]
