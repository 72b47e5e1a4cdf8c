"""Which attention core a launch of K1, B8, B9 or B10 takes, and how much
shared memory a block of it needs (`ops/attn.py`, mirroring
`csrc/attn_core.cuh`). The kernels run only on the card; these checks of
the rule that picks and sizes them run anywhere."""

import pytest
import torch

from vsc22_tpu_torch.ops.attn import (
    SMEM_PER_BLOCK,
    attn_core,
    attn_mma_warps,
    attn_smem_bytes,
    check_attn_smem,
)


@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 96, 112, 128])
def test_bf16_multiples_of_16_up_to_128_take_the_tensor_core_core(hd):
    assert attn_core(torch.bfloat16, hd) == "mma"
    assert attn_core(torch.float32, hd) == "ffma"


@pytest.mark.parametrize("hd", [1, 8, 20, 24, 40, 144, 256])
def test_other_head_dims_take_the_ffma_core(hd):
    assert attn_core(torch.bfloat16, hd) == "ffma"
    assert attn_core(torch.float32, hd) == "ffma"


def largest_l(hd, dtype):
    l = 1
    while attn_smem_bytes(l + 1, hd, dtype) <= SMEM_PER_BLOCK:
        l += 1
    return l


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, 736), (torch.float32, 423)])
def test_largest_l_at_hd_64(dtype, want):
    """bf16: (2 * 736 + 16 * 8) rows of 72 bf16 = 230,400 bytes; 737 tokens
    take 752 rows of K and V. f32: 2 * 423 * 64 * 4 + 8 * (64 + 423) * 4 =
    232,160 bytes."""
    assert largest_l(64, dtype) == want
    check_attn_smem(want, 64, dtype)
    for longer in range(want + 1, want + 200):
        with pytest.raises(RuntimeError, match="shared memory"):
            check_attn_smem(longer, 64, dtype)


@pytest.mark.parametrize("l,warps", [(1, 1), (16, 1), (17, 2), (64, 4), (65, 5), (128, 8),
                                     (129, 5), (145, 5), (257, 6), (736, 8)])
def test_mma_row_tiles_spread_evenly(l, warps):
    """ceil(L/16) tiles of 16 query rows over the fewest blocks of at most
    8 warps: every block but the last full, none more than a tile short."""
    assert attn_mma_warps(l) == warps
    tiles = -(-l // 16)
    blocks = -(-tiles // warps)
    assert blocks == -(-tiles // 8)
    assert blocks * warps - tiles < blocks


def test_mma_smem_rounds_l_up_to_16_rows():
    # K and V of 257 tokens take 272 rows each, beside 6 warps' 96 Q rows.
    assert attn_smem_bytes(257, 64, torch.bfloat16) == (2 * 272 + 96) * 72 * 2
    assert attn_smem_bytes(256, 64, torch.bfloat16) == (2 * 256 + 128) * 72 * 2
    assert attn_smem_bytes(1, 16, torch.bfloat16) == (2 * 16 + 16) * 24 * 2


def test_ffma_smem_formula():
    assert attn_smem_bytes(257, 64, torch.float32) == 2 * 257 * 64 * 4 + 8 * (64 + 257) * 4
    assert attn_smem_bytes(257, 20, torch.bfloat16) == 2 * 257 * 20 * 2 + 8 * (20 + 257) * 4


def test_refusal_names_the_core_and_the_size():
    with pytest.raises(RuntimeError, match=r"\(mma\): L=1024, hd=64 .* 313344 bytes"):
        check_attn_smem(1024, 64, torch.bfloat16)
    with pytest.raises(RuntimeError, match=r"\(ffma\): L=1024, hd=64"):
        check_attn_smem(1024, 64, torch.float32)
