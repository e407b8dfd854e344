"""Share of the traced requests' wall with nothing running on the device, %."""

from portbench import readers


def read(m):
    return readers.idle_pct(m, "serve_video")
