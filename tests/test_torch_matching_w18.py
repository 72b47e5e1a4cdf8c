"""SAM HRNet-W18 at full width (stem 64, branches 18/36/72/144, stages of
1/4/3 modules, the 334-channel split fuse) in the port against the JAX
model on the CPU, in float32 with the packed-branch-0 numerics off and on,
at a small even input (1 x 32 x 32) so the CPU run stays short; the JAX
variables are random (`test_torch_matching_models.jax_variables`) and
carried by `utils.jax_params`.

Tolerance: logits within 1e-3 absolute and relative, probabilities 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_matching_models import assert_logits_close, jax_forward, jax_variables
from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu_torch.models import hrnet
from vsc22_tpu_torch.utils import jax_params


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
def test_sam_hrnet_w18_full_width_matches_jax(s2d):
    x = np.random.default_rng(4).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jm = jhrnet.sam_hrnet_w18(s2d=s2d)
    variables = jax_variables(jm, x, seed=4, last="fuse2")
    want = jax_forward(jm, variables, x, jnp.float32)
    model = jax_params.load_sam_hrnet(hrnet.sam_hrnet_w18(s2d=s2d, device="cpu"), variables)
    assert model.in_channels == (64, 18, 36, 72, 144) and sum(model.in_channels) == 334
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 32, 32, 2)
    assert_logits_close(got.numpy(), want, torch.float32, axis=-1)
