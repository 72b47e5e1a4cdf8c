"""Which window-attention core a launch of B6 or B1 takes, how much shared
memory a block of it needs (`ops/window_attn.py`, mirroring
`csrc/window_attn.cuh`), and which loop each of B1's four products takes
(`ops/swin_block.py`, mirroring `csrc/gemm_nt.cuh`). The kernels run only
on the card; these checks of the rules that pick and size them run
anywhere."""

import pytest
import torch

from vsc22_tpu_torch.ops.gemm import GEMM_MMA_SMEM, gemm_route
from vsc22_tpu_torch.ops.swin_block import routes
from vsc22_tpu_torch.ops.window_attn import (
    SMEM_PER_BLOCK,
    check_window_smem,
    window_core,
    window_mma_warps,
    window_smem_bytes,
)

# (N, hd) of the SwinV2-Base stages: window 16 at stages 1-3, 8 at stage 4.
SWIN_BASE = [(256, 32), (64, 32)]


@pytest.mark.parametrize("n,hd", SWIN_BASE + [(16, 16), (36, 16), (1, 32), (255, 16)])
def test_tensor_cores_at_hd_16_and_32_up_to_256_tokens(n, hd):
    assert window_core(n, hd) == "mma"


@pytest.mark.parametrize("n,hd", [(16, 20), (36, 8), (64, 48), (64, 64), (257, 32), (1024, 16)])
def test_every_other_shape_takes_the_ffma_core(n, hd):
    assert window_core(n, hd) == "ffma"


@pytest.mark.parametrize("n,warps", [(1, 1), (16, 1), (36, 3), (64, 4), (128, 8), (144, 5),
                                     (256, 8)])
def test_mma_row_tiles_spread_evenly(n, warps):
    assert window_mma_warps(n) == warps
    tiles = -(-n // 16)
    blocks = -(-tiles // warps)
    assert blocks == -(-tiles // 8) and blocks * warps - tiles < blocks


def test_mma_smem_at_the_swinv2_base_shapes():
    """N 256: a 128-row bias tile at a pitch of 264 f32 (135,168 bytes),
    then k and v of 256 rows: bf16 at 40 (20,480 each) or f32 at 36
    (36,864 each). B6 in bf16 keeps two buffers of the raw k and v and
    k's 256 f32 norms; B1 rounds k̂ to bf16 and holds v in f32 for its
    FMA chains."""
    bias = 128 * 264 * 4
    assert window_smem_bytes(256, 32, torch.bfloat16) == bias + 4 * 20_480 + 1_024
    assert window_smem_bytes(256, 32, torch.float32) == bias + 2 * 36_864
    assert window_smem_bytes(256, 32, torch.bfloat16, round_qk=True) == bias + 20_480 + 36_864
    assert window_smem_bytes(64, 32, torch.float32) == 64 * 72 * 4 + 2 * 64 * 36 * 4
    for n, hd in SWIN_BASE:
        for dtype in (torch.float32, torch.bfloat16):
            for round_qk in (False, True):
                assert window_smem_bytes(n, hd, dtype, round_qk) <= SMEM_PER_BLOCK
                check_window_smem(n, hd, dtype, round_qk)


def test_mma_rows_round_up_to_16():
    # 36 tokens: 3 warps' 48 bias rows at a pitch of 72; k̂, v 48 rows.
    assert window_smem_bytes(36, 16, torch.float32) == 48 * 72 * 4 + 2 * 48 * 20 * 4


def largest_n(hd, dtype):
    n = 1
    while window_smem_bytes(n + 1, hd, dtype) <= SMEM_PER_BLOCK:
        n += 1
    return n


@pytest.mark.parametrize("hd,want", [(16, 1449), (20, 1206), (32, 803)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_largest_n_of_the_ffma_core(hd, want, dtype):
    """Past 256 tokens the FFMA core holds k̂^T and v of one head and 8
    warps' q and probability rows in f32: (hd (N + 1) + N hd + 8 (hd + N))
    * 4 bytes, whatever the dtype (hd 32: N 803 takes 232,416 bytes)."""
    assert largest_n(hd, dtype) == want
    check_window_smem(want, hd, dtype)
    for longer in range(want + 1, want + 50):
        with pytest.raises(RuntimeError, match="shared memory"):
            check_window_smem(longer, hd, dtype)


def test_refusal_names_the_core_and_the_size():
    with pytest.raises(RuntimeError, match=r"\(ffma\): N=1024, hd=32 .* 296064 bytes"):
        check_window_smem(1024, 32, torch.bfloat16)


@pytest.mark.parametrize("k", [8, 40, 48, 128, 1000, 4096])
def test_bf16_products_with_k_a_multiple_of_8_take_tensor_cores(k):
    a = torch.zeros(4, k, dtype=torch.bfloat16)
    w = torch.zeros(8, k, dtype=torch.bfloat16)
    assert gemm_route(torch.bfloat16, k, a, w) == "mma"
    assert gemm_route(torch.float32, k, a.float(), w.float()) == "ffma"


@pytest.mark.parametrize("k", [1, 4, 20, 36, 1001])
def test_other_k_take_the_ffma_tile(k):
    a = torch.zeros(4, k, dtype=torch.bfloat16)
    assert gemm_route(torch.bfloat16, k, a, a) == "ffma"


def test_misaligned_operands_take_the_ffma_tile():
    buf = torch.zeros(1 + 4 * 64, dtype=torch.bfloat16)
    a = buf[1:].view(4, 64)
    assert a.data_ptr() % 16 != 0
    assert gemm_route(torch.bfloat16, 64, a, torch.zeros(8, 64, dtype=torch.bfloat16)) == "ffma"


def test_routes_of_a_swinv2_base_block():
    c, f, h = 128, 512, 4
    x = torch.zeros(2, 256, c, dtype=torch.bfloat16)
    ws = [torch.zeros(s, dtype=torch.bfloat16) for s in ((3 * c, c), (c, c), (f, c), (c, f))]
    assert routes(x, *ws, h) == dict(core="mma", qkv="ffma128", proj="mma", fc1="mma",
                                     fc2="mma")
    x32, ws32 = x.float(), [w.float() for w in ws]
    assert routes(x32, *ws32, h) == dict(core="mma", qkv="ffma", proj="ffma", fc1="ffma",
                                         fc2="ffma")
    # C 40 and 2 heads: hd 20 takes the FFMA core; K 40 and 160 are whole 16-byte rows.
    x = torch.zeros(1, 16, 40, dtype=torch.bfloat16)
    ws = [torch.zeros(s, dtype=torch.bfloat16) for s in ((120, 40), (40, 40), (160, 40), (40, 160))]
    assert routes(x, *ws, 2) == dict(core="ffma", qkv="ffma128", proj="mma", fc1="mma",
                                     fc2="mma")
    # C 36: K 36 is no whole number of 16-byte rows, so proj and fc1 (K 36)
    # take the FFMA tile; fc2's K is 144.
    x = torch.zeros(1, 16, 36, dtype=torch.bfloat16)
    ws = [torch.zeros(s, dtype=torch.bfloat16) for s in ((108, 36), (36, 36), (144, 36), (36, 144))]
    assert routes(x, *ws, 2) == dict(core="ffma", qkv="ffma128", proj="ffma", fc1="ffma",
                                     fc2="mma")


def test_gemm_smem():
    assert GEMM_MMA_SMEM == 61_440
