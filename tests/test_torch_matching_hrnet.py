"""The SAM HRNet (Similarity Alignment Model) in the port against the JAX
model on the CPU: the tiny test config in float32 and bfloat16, each with
the packed-branch-0 numerics (`s2d_branch0`) off and on, at 32x32, batch
2, with the JAX variables carried by `utils.jax_params` (random, as
`test_torch_matching_models.jax_variables` draws them).

Tolerances (on the [B, H, W, 2] logits and the class-1 probability map):
- float32: logits within 1e-3 absolute and relative, probabilities 1e-5;
- bfloat16: the JAX side runs eagerly (each op rounds to bf16 as written);
  probabilities within 5e-2 (measured 0.020, ulp flips of sums taken in
  another order, magnified by the head's rescaling). The `s2d_branch0`
  cases round the folded BN twice (product, then sum) on branch 0, as
  `hrnet.py:182-187` does (`test_folded_bn_rounds_twice_in_bf16`).
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_matching_models import DTYPES, assert_logits_close, jax_forward, jax_variables
from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu_torch.models import hrnet, layers
from vsc22_tpu_torch.utils import jax_params


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sam_hrnet_tiny_matches_jax(dt, s2d):
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    variables = jax_variables(jhrnet.sam_hrnet_tiny_test(), x, seed=2, last="fuse2")
    want = jax_forward(jhrnet.sam_hrnet_tiny_test(dtype=jdt, s2d=s2d), variables, x, jdt)
    model = jax_params.load_sam_hrnet(hrnet.sam_hrnet_tiny_test(dtype=tdt, s2d=s2d), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 2)
    assert_logits_close(got.numpy(), want, tdt, axis=-1)


def test_folded_bn_rounds_twice_in_bf16():
    """The packed branch 0's BN: mult and add folded in f32, cast to bf16,
    then y * mult and + add each rounded; the standard BN rounds once."""
    gen = torch.Generator().manual_seed(3)
    bn = layers.BatchNorm(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0, 0.1, generator=gen)
        bn.mean.normal_(0, 0.1, generator=gen)
        bn.var.uniform_(0.5, 1.5, generator=gen)
    y = torch.randn((64, 8), generator=gen).to(torch.bfloat16)
    mult = bn.weight / torch.sqrt(bn.var + 1e-5)
    add = bn.bias - bn.mean * mult
    prod = (y.float() * mult.to(torch.bfloat16).float()).to(torch.bfloat16)
    want = (prod.float() + add.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(bn.folded(y), want)
    once = ((y.float() - bn.mean) * (torch.rsqrt(bn.var + 1e-5) * bn.weight) + bn.bias)
    assert torch.equal(bn(y), once.to(torch.bfloat16))


def test_sam_hrnet_loader_rejects_another_config():
    x = np.zeros((1, 16, 16, 3), np.float32)
    shapes = jax.eval_shape(lambda: jhrnet.SAMHRNet(
        cfg=jhrnet.HRNetConfig(width=6, layer1_blocks=1, stage_modules=(1, 1, 1),
                               blocks_per_branch=1, stem_channels=8),
        fuse_channels=8).init(jax.random.PRNGKey(0), x))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    with pytest.raises(ValueError, match="does not fit"):
        jax_params.load_sam_hrnet(hrnet.sam_hrnet_tiny_test(), variables)


def test_seeded_random_weights_are_reproducible():
    a, b = hrnet.sam_hrnet_tiny_test(), hrnet.sam_hrnet_tiny_test()
    layers.reset_parameters(a, torch.Generator().manual_seed(7))
    layers.reset_parameters(b, torch.Generator().manual_seed(7))
    for (na, pa), (_, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(pa, pb), na
    assert a.fuse1_weight.abs().max() > 0 and a.backbone.stem1.bn.var.eq(1).all()
