"""B1 (`vsc22::swin_block`): share of its roofline over the window's calls."""

from portbench.yardstick.readers import roofline_share


def read(trace):
    return roofline_share(trace, "vsc22::swin_block")
