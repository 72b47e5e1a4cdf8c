"""Share of the traced training window with no kernel or copy on the device."""

from portbench.yardstick.readers import idle_share


def read(trace):
    return idle_share(trace)
