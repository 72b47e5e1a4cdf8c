"""K2 (`vsc22::ln_mlp_residual`) in the train step's forwards: share of its roofline."""

from portbench.yardstick.readers import roofline_share


def read(trace):
    return roofline_share(trace, "vsc22::ln_mlp_residual")
