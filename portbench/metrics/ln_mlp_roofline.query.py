"""K2 (`vsc22::ln_mlp_residual`): share of its roofline over the window's calls."""

from portbench.yardstick.readers import roofline_share


def read(trace):
    return roofline_share(trace, "vsc22::ln_mlp_residual")
