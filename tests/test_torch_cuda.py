"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not reach (odd rows and widths, head dims
other than 64 or 32, window sizes other than 16 and 8, tiny, single-row and
single-window operands; B5 at every e, ragged blocks and duplicate rows;
B8, B9 and B10 at L 17, 50, 145 and 257 and hd 16, 32 and 64; the
tensor-core attention core through B8 and K1 at L 1 to 257, soft and
peaked, at its shared-memory edge and on misaligned operands; K1's
projection and K2's products on the tensor-core loop at ragged rows, and
K2's LN-rows kernel bit for bit; B9 and B10 on their bf16 loops at the
ViT-B/32 and CLIP widths, and B10's q-scale epilogue at ragged N and hd 32;
B1's, f32 K1's and f32 B9's and B10's outputs bit for bit as pinned
before; B7 at the SwinV2-Base stage 1 and 4 widths on the tensor-core loop
(bf16) and 3xTF32 (f32), and at shapes and alignments across its route
rule; B5's product loop for every case, and its FFMA route's outputs bit
for bit as pinned before the tensor-core route; K3's split
grid with the max in the last split, all-negative and zero maxima, and D
padded to a multiple of 16; the outputs and gradients of K1, K2, B7, B9,
B10, B8, B6 and B1 through their recompute VJPs against autograd of their
plain versions, in f32 and bf16 at ragged shapes, and B5 and K3 raising on an
operand that requires grad); for the legacy zoo, K1 and K2 at MAE
ViT-B/16's L 197 in bf16, B7 in f32 at Swin-T v1's K 96 and C 768, and the
tiny legacy members on the card against the CPU; for the matching trainers, BatchNorm's
train mode against the CPU and the float32 convolution's backward with
TF32 kept off while the global flag is on; and for the per-video path,
OpenCV's resize and Canny arithmetic bit for bit as on the CPU, the tiny
per-video `QueryPipeline` against the CPU, and the offline CLIs on the
card by default; and the tiny ViT exported with `utils/export`, its program
holding a K1 and a K2 op node per block and equal to the eager model; and
for the multi-device layer, the sharded step and the sharded search in an
NCCL world of one, bit for bit the unsharded ones).

Needs a CUDA device; skips elsewhere. The shared conftest imports JAX,
which the GPU host lacks, so run it there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from scripts.torch_gemm_probe import b1_digest_args, block_digests
from scripts.torch_topk_probe import b5_digest
from vsc22_tpu_torch.kernels import build
from vsc22_tpu_torch.ops.attn import attn_core, packed_attention, packed_attention_reference
from vsc22_tpu_torch.ops import attn_proj, mlp
from vsc22_tpu_torch.ops import vit_block as vit_block_ops
from vsc22_tpu_torch.ops.attn_proj import (
    attn_proj_residual,
    attn_proj_residual_reference,
    ln_attn_proj_residual,
    ln_attn_proj_residual_reference,
)
from vsc22_tpu_torch.ops.mlp import (
    fused_mlp,
    fused_mlp_reference,
    layernorm_rows,
    ln_mlp_residual,
    ln_mlp_residual_reference,
    ln_rows,
)
from vsc22_tpu_torch.ops.sim import row_max_gemm, row_max_gemm_reference, row_max_grid
from vsc22_tpu_torch.models.swinv2 import _shift_attn_mask
from vsc22_tpu_torch.ops.swin_block import routes, swin_block, swin_block_reference
from vsc22_tpu_torch.ops.topk import extract_topk, extract_topk_reference, topk_route
from vsc22_tpu_torch.ops.vit_block import vit_block, vit_block_reference
from vsc22_tpu_torch.ops.window_attn import (
    window_attention,
    window_attention_reference,
    window_core,
)

pytestmark = pytest.mark.cuda

# Elementwise |kernel - plain| <= atol + rtol |plain|. f32: exact arithmetic
# in another summation order; bf16: outputs one or two bf16 ulps apart.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def randn(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen) * std).to(dtype).to(device)


def assert_close(got, want, tol):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,c,h", [(2, 17, 32, 2), (3, 145, 96, 3), (1, 1, 64, 1),
                                     (2, 70, 256, 2)])
def test_attn_proj_ragged(device, dtype, b, l, c, h):
    gen = torch.Generator().manual_seed(b * l + c)
    x = randn(gen, (b, l, c), 0.05, dtype, device)
    qkv = randn(gen, (b, l, 3 * c), 1.5, dtype, device)
    pw = randn(gen, (c, c), c**-0.5, dtype, device)
    pb = randn(gen, (c,), 0.1, torch.float32, device)
    before = attn_proj_residual.launches
    got = attn_proj_residual(x, qkv, pw, pb, h)
    assert attn_proj_residual.launches == before + 1
    assert_close(got, attn_proj_residual_reference(x, qkv, pw, pb, h), TOL[dtype])


def test_attn_proj_raises_past_shared_memory(device):
    # f32 K and V of 257 tokens at hd=256 need 526 KB of shared memory.
    x = torch.zeros(1, 257, 256, device=device)
    with pytest.raises(RuntimeError):
        attn_proj_residual(x, torch.zeros(1, 257, 768, device=device),
                           torch.zeros(256, 256, device=device),
                           torch.zeros(256, device=device), 1)


# sha256 of K1's output bytes on `k1_clip_inputs` (NVIDIA H100 80GB HBM3,
# torch 2.11.0+cu128, CUDA 12.8). float32: as K1 gave them before its
# attention core moved into csrc/attn_core.cuh; the f32 FFMA core and
# projection have not changed since. bfloat16: from the tensor-core core
# and the projection on the tensor-core loop, pinned after K1 met the bf16
# bar against `attn_proj_residual_reference` at this shape (chip_smoke
# phase 2). A redesign that changes K1's arithmetic replaces them.
K1_DIGESTS = {
    torch.float32: "ddcbd304ca66e841e2f85056383816589a42b85ab424b1e1a257e730a9152a36",
    torch.bfloat16: "39b5f631ec9ac4dcf387d5c7f8b094733ad638f62a6123c325f41ee5fef649d8",
}


def k1_clip_inputs(dtype, device):
    """K1's operands at a full 128-frame CLIP chunk, from a CPU generator."""
    gen = torch.Generator().manual_seed(2024)
    b, l, c = 128, 257, 1024
    return (randn(gen, (b, l, c), 0.05, dtype, device),
            randn(gen, (b, l, 3 * c), 1.5, dtype, device),
            randn(gen, (c, c), c**-0.5, dtype, device),
            randn(gen, (c,), 0.1, torch.float32, device), 16)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_proj_bitwise_as_before_the_core_moved(device, dtype):
    out = attn_proj_residual(*k1_clip_inputs(dtype, device))
    torch.cuda.synchronize()
    assert digest(out) == K1_DIGESTS[dtype]


# The tensor-core core (bf16, hd a multiple of 16) at L whose query and
# key tails are 1, 15 and 16 rows past a 16-row tile, or none; K1 reads
# q, k and v from packed rows (stride 3C), B8 from separate ones (stride C).
MMA_L = (1, 16, 17, 50, 64, 65, 145, 257)


def bf16_bar(got, want):
    """TOL per element, and at most 2% of the elements differing at all:
    a misplaced rounding of the probabilities moves 30-50% of them."""
    assert_close(got, want, TOL[torch.bfloat16])
    share = float((got != want).float().mean())
    assert share <= chip_smoke.BF16_MAX_SHARE, share


@pytest.mark.parametrize("peak", [1.0, 8.0], ids=["soft", "peaked"])
@pytest.mark.parametrize("hd", (16, 32, 64))
@pytest.mark.parametrize("l", MMA_L)
def test_mma_core_packed_attention(device, l, hd, peak):
    """B8 on the tensor-core core; `peaked` scales q by 8 (logits of std
    ~16, most probabilities 0 or nearly 1)."""
    assert attn_core(torch.bfloat16, hd) == "mma"
    gen = torch.Generator().manual_seed(7 * l + hd)
    q, k, v = (randn(gen, (3, l, 2, hd), std, torch.bfloat16, device)
               for std in (2.0 * peak * hd**-0.5, 1.0, 1.0))
    before = packed_attention.launches
    got = packed_attention(q, k, v)
    assert packed_attention.launches == before + 1
    bf16_bar(got, packed_attention_reference(q, k, v))


@pytest.mark.parametrize("peak", [1.0, 8.0], ids=["soft", "peaked"])
@pytest.mark.parametrize("hd", (16, 32, 64))
@pytest.mark.parametrize("l", MMA_L)
def test_mma_core_attn_proj(device, l, hd, peak):
    """K1 on the tensor-core core (stride 3C); `peaked` scales q by 8."""
    assert attn_core(torch.bfloat16, hd) == "mma"
    c, h = WIDTHS[hd]
    gen = torch.Generator().manual_seed(5 * l + hd)
    x = randn(gen, (2, l, c), 0.05, torch.bfloat16, device)
    qkv = randn(gen, (2, l, 3 * c), 1.5, torch.bfloat16, device)
    qkv[..., :c] *= peak
    pw = randn(gen, (c, c), c**-0.5, torch.bfloat16, device)
    pb = randn(gen, (c,), 0.1, torch.float32, device)
    before = attn_proj_residual.launches
    got = attn_proj_residual(x, qkv, pw, pb, h)
    assert attn_proj_residual.launches == before + 1
    bf16_bar(got, attn_proj_residual_reference(x, qkv, pw, pb, h))


def test_mma_core_at_and_past_its_largest_l(device):
    """736 tokens at hd 64 fill (2 * 736 + 128) rows of 72 bf16 = 230,400
    bytes; 737 would take 235,008, past the 232,448 a block can have."""
    gen = torch.Generator().manual_seed(736)
    q, k, v = (randn(gen, (1, 736, 1, 64), 0.25, torch.bfloat16, device) for _ in range(3))
    bf16_bar(packed_attention(q, k, v), packed_attention_reference(q, k, v))
    q = torch.zeros(1, 737, 1, 64, device=device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=r"\(mma\).*shared memory"):
        packed_attention(q, q, q)
    x = torch.zeros(1, 737, 64, device=device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=r"\(mma\).*shared memory"):
        attn_proj_residual(x, torch.zeros(1, 737, 192, device=device, dtype=torch.bfloat16),
                           torch.zeros(64, 64, device=device, dtype=torch.bfloat16),
                           torch.zeros(64, device=device), 1)


def test_mma_core_refuses_operands_off_16_bytes(device):
    """Contiguous views one element into a buffer: the core's 16-byte
    copies cannot take them, so the launch fails and the wrapper raises."""
    n = 2 * 17 * 2 * 64
    buf = torch.zeros(n + 1, device=device, dtype=torch.bfloat16)
    q = buf[1:].view(2, 17, 2, 64)
    with pytest.raises(RuntimeError, match="misaligned"):
        packed_attention(q, q, q)


RAGGED_L = (17, 50, 145, 257)
HEAD_DIMS = (16, 32, 64)
# (width, heads) of each head dim for B9 and B10.
WIDTHS = {16: (48, 3), 32: (64, 2), 64: (128, 2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("l", RAGGED_L)
def test_packed_attention_ragged(device, dtype, l, hd):
    gen = torch.Generator().manual_seed(l * hd)
    # q carries the softmax scale; logits of std ~2, so the softmax is peaky.
    q, k, v = (randn(gen, (2, l, 3, hd), std, dtype, device)
               for std in (1.5 * hd**-0.25, 1.5 * hd**-0.25, 1.0))
    before = packed_attention.launches
    got = packed_attention(q, k, v)
    assert packed_attention.launches == before + 1
    assert_close(got, packed_attention_reference(q, k, v), TOL[dtype])


block_params = chip_smoke.block_params
HALF = ("ln1_s", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("l", RAGGED_L)
def test_ln_attn_proj_ragged(device, dtype, l, hd):
    c, h = WIDTHS[hd]
    gen = torch.Generator().manual_seed(l + hd)
    x = randn(gen, (2, l, c), 1.0, dtype, device)
    p = block_params(gen, c, 4 * c, dtype, device)
    args = (x, *(p[k] for k in HALF), h, 1e-5)
    before = ln_attn_proj_residual.launches
    got = ln_attn_proj_residual(*args)
    assert ln_attn_proj_residual.launches == before + 1
    want = ln_attn_proj_residual_reference(*args)
    torch.cuda.synchronize()
    ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL)
    assert ok, (err, words)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,eps", [("gelu", 1e-6), ("quick_gelu", 1e-5)])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("l", RAGGED_L)
def test_vit_block_ragged(device, dtype, act, eps, l, hd):
    """Against the plain version with q rounded where the kernel rounds it
    (`fold_scale`): at hd 32 in bf16 the JAX oracle's rounding moves ~40%
    of the outputs by an ulp, and that is no fault of the kernel."""
    c, h = WIDTHS[hd]
    gen = torch.Generator().manual_seed(3 * l + hd)
    x = randn(gen, (2, l, c), 1.0, dtype, device)
    args = (x, *block_params(gen, c, 4 * c, dtype, device).values(), h, act, eps)
    before = vit_block.launches
    got = vit_block(*args)
    assert vit_block.launches == before + 1
    want = vit_block_reference(*args, fold_scale=True)
    torch.cuda.synchronize()
    ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL, block=True)
    assert ok, (err, words)


# 16 frames: over 2048 token rows at both widths, where cuBLAS's f32
# product (the plain version) sums each row in order, as at the main path.
LOOP_FRAMES = 16


def block_case(model, seed, device):
    sh = chip_smoke.BLOCK_SHAPES[model]
    gen = torch.Generator().manual_seed(seed)
    x = randn(gen, (LOOP_FRAMES, sh["l"], sh["c"]), 1.0, torch.bfloat16, device)
    return sh, x, block_params(gen, sh["c"], sh["hidden"], torch.bfloat16, device)


@pytest.mark.parametrize("model", ["vit", "clip"])
def test_ln_attn_proj_on_the_loops(device, model):
    """B9 in bf16 at the ViT-B/32 and CLIP widths: LN1 rows, QKV in the
    plain version's order on the 128x128 FFMA tile, K1 with its projection
    on the tensor-core loop, within phase 2's bf16 bar."""
    sh, x, p = block_case(model, 1, device)
    assert attn_proj.routes(x, p["proj_w"], sh["h"], half_block=True) == dict(
        core="mma", ln="rows", qkv="ffma128", proj="mma")
    args = (x, *(p[k] for k in HALF), sh["h"], sh["eps"])
    got = ln_attn_proj_residual(*args)
    want = ln_attn_proj_residual_reference(*args)
    torch.cuda.synchronize()
    ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL)
    assert ok, (err, words)


@pytest.mark.parametrize("model", ["vit", "clip"])
def test_vit_block_on_the_loops(device, model):
    """B10 in bf16 at the ViT-B/32 and CLIP widths: LN1 and LN2 rows, QKV
    and proj in the plain version's order on the 128x128 FFMA tile, fc1 and
    fc2 on the tensor-core loop (K2's stages), within phase 2's block bar."""
    sh, x, p = block_case(model, 2, device)
    r = vit_block_ops.routes(x, p["fc1_w"], p["fc2_w"], sh["h"])
    assert r == dict(ln1="rows", qkv="ffma128", core="mma", proj="ffma128", ln2="rows",
                     fc1="mma", fc2="mma")
    args = (x, *p.values(), sh["h"], sh["act"], sh["eps"])
    got = vit_block(*args)
    want = vit_block_reference(*args, fold_scale=True)
    torch.cuda.synchronize()
    ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL, block=True)
    assert ok, (err, words)


# (C, heads) at hd 32, the scale 2^-2.5 that is no power of two: 3C = 288
# and 192 output columns, ragged against the loop's 128-column tile, over
# 4 x 50 = 200 rows, ragged against its 128-row tile.
@pytest.mark.parametrize("c,h", [(96, 3), (64, 2)])
def test_vit_block_q_scale_epilogue(device, c, h):
    """B10's QKV stage alone, read from the kernel's own scratch: q's
    columns (acc + b) * hd^-0.5 in f32 and then rounded, k and v rounded,
    against the plain QKV on the same LN1 rows (bf16 bar); then the whole
    block against the plain version with that rounding of q."""
    gen = torch.Generator().manual_seed(c + h)
    x = randn(gen, (4, 50, c), 1.0, torch.bfloat16, device)
    p = block_params(gen, c, 4 * c, torch.bfloat16, device)
    ln, attn, x1, out = (torch.empty_like(x) for _ in range(4))
    qkv = torch.empty((4, 50, 3 * c), dtype=torch.bfloat16, device=device)
    hidden = torch.empty((4, 50, 4 * c), dtype=torch.bfloat16, device=device)
    build.call("vit_block", "vsc22_vit_block", vit_block_ops._ARGTYPES,
               x.data_ptr(), *(t.data_ptr() for t in p.values()), ln.data_ptr(),
               qkv.data_ptr(), attn.data_ptr(), x1.data_ptr(), hidden.data_ptr(),
               out.data_ptr(), 4, 50, c, h, 4 * c, 2, 1e-5, 1, build.stream_ptr(device))
    ln1 = ln_rows(x.float(), p["ln1_s"], p["ln1_b"], 1e-5).to(torch.bfloat16)
    bf16_bar(qkv, attn_proj.qkv_reference(ln1, p["qkv_w"], p["qkv_b"], (c // h) ** -0.5))
    want = vit_block_reference(x, *p.values(), h, "quick_gelu", 1e-5, fold_scale=True)
    ok, err, share, words = chip_smoke.agreement(out, want, chip_smoke.F32_TOL, block=True)
    assert ok, (err, words)


# sha256 of B9's and B10's float32 outputs on `block_digests`'s operands
# (NVIDIA H100 80GB HBM3, torch 2.11.0+cu128, CUDA 12.8), from the kernels
# before their bf16 products moved to the tensor-core loop: f32 keeps the
# FFMA tiles, and so its outputs bit for bit.
BLOCK_F32_DIGESTS = {
    "B9": "8d7b66c13b763d629a506fe350c78cbc955eb8f70fcc2bc61fe669c9f1692c21",
    "B10": "4d61c5809a0ed04a6f35427e3445bdf91ccd4b24d0cddead3ff0ad122ca49643",
}


@pytest.mark.parametrize("name", list(BLOCK_F32_DIGESTS))
def test_block_f32_bitwise_as_before_the_loops(device, name):
    assert block_digests("float32", device)[name] == BLOCK_F32_DIGESTS[name]


def test_attention_kernels_raise_past_shared_memory(device):
    # f32 K and V of 1024 tokens at hd=64 need 524 KB of shared memory.
    q = torch.zeros(1, 1024, 1, 64, device=device)
    with pytest.raises(RuntimeError, match="shared memory"):
        packed_attention(q, q, q)
    p = block_params(torch.Generator().manual_seed(0), 64, 256, torch.float32, device)
    x = torch.zeros(1, 1024, 64, device=device)
    with pytest.raises(RuntimeError, match="shared memory"):
        ln_attn_proj_residual(x, *(p[k] for k in HALF), 1)
    with pytest.raises(RuntimeError, match="shared memory"):
        vit_block(x, *p.values(), 1)


def test_attention_kernels_reject_a_cpu_cuda_mix(device):
    q = torch.zeros(2, 17, 2, 16, device=device)
    with pytest.raises(ValueError):
        packed_attention(q, q.cpu(), q)
    p = block_params(torch.Generator().manual_seed(0), 32, 128, torch.float32, device)
    x = torch.zeros(2, 17, 32, device=device)
    with pytest.raises(ValueError):  # qkv weights on the CPU
        ln_attn_proj_residual(x, *(p[k].cpu() if k == "qkv_w" else p[k] for k in HALF), 2)
    with pytest.raises(ValueError):  # fc2 bias on the CPU
        vit_block(x, *(v.cpu() if k == "fc2_b" else v for k, v in p.items()), 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,eps", [("gelu", 1e-6), ("quick_gelu", 1e-5)])
@pytest.mark.parametrize("rows,c,hidden", [(37, 48, 80), (1, 32, 128), (130, 200, 70)])
def test_ln_mlp_ragged(device, dtype, act, eps, rows, c, hidden):
    gen = torch.Generator().manual_seed(rows + c + hidden)
    args = (
        randn(gen, (rows, c), 1.0, dtype, device),
        1 + randn(gen, (c,), 0.1, torch.float32, device),
        randn(gen, (c,), 0.1, torch.float32, device),
        randn(gen, (hidden, c), c**-0.5, dtype, device),
        randn(gen, (hidden,), 0.1, torch.float32, device),
        randn(gen, (c, hidden), hidden**-0.5, dtype, device),
        randn(gen, (c,), 0.1, torch.float32, device),
        act, eps,
    )
    assert_close(ln_mlp_residual(*args), ln_mlp_residual_reference(*args), TOL[dtype])


def mlp_args(gen, rows, c, hidden, act, eps, dtype, device):
    return (
        randn(gen, (rows, c), 1.0, dtype, device),
        1 + randn(gen, (c,), 0.1, torch.float32, device),
        randn(gen, (c,), 0.1, torch.float32, device),
        randn(gen, (hidden, c), c**-0.5, dtype, device),
        randn(gen, (hidden,), 0.1, torch.float32, device),
        randn(gen, (c, hidden), hidden**-0.5, dtype, device),
        randn(gen, (c,), 0.1, torch.float32, device),
        act, eps,
    )


# Three CLIP frames of rows: 771, off the tensor-core loop's 128-row tile.
MMA_ROWS = 3 * 257


@pytest.mark.parametrize("act,eps", [("gelu", 1e-6), ("quick_gelu", 1e-5)])
@pytest.mark.parametrize("c", (768, 1024))
def test_ln_mlp_on_the_mma_loop(device, c, act, eps):
    """K2 in bf16 at the ViT-B/32 and CLIP widths: the LN-rows kernel, then
    fc1 and fc2 on the tensor-core loop, within the bf16 bar."""
    gen = torch.Generator().manual_seed(c + len(act))
    args = mlp_args(gen, MMA_ROWS, c, 4 * c, act, eps, torch.bfloat16, device)
    assert mlp.routes(args[0], args[3], args[5]) == dict(ln="rows", fc1="mma", fc2="mma")
    before = ln_mlp_residual.launches
    got = ln_mlp_residual(*args)
    assert ln_mlp_residual.launches == before + 1
    bf16_bar(got, ln_mlp_residual_reference(*args))


@pytest.mark.parametrize("c", (768, 1024))
def test_ln_mlp_f32_keeps_the_ffma_tile(device, c):
    gen = torch.Generator().manual_seed(c)
    args = mlp_args(gen, MMA_ROWS, c, 4 * c, "quick_gelu", 1e-5, torch.float32, device)
    assert mlp.routes(args[0], args[3], args[5]) == dict(ln="prologue", fc1="ffma", fc2="ffma")
    assert_close(ln_mlp_residual(*args), ln_mlp_residual_reference(*args), TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(MMA_ROWS, 1024), (MMA_ROWS, 768), (1, 48), (37, 200)])
def test_ln_rows_kernel_bitwise(device, dtype, rows, c):
    """K2's LN-rows kernel equals its plain version bit for bit: the f64
    statistics are the correctly rounded mean and variance, and each
    operation after them rounds once on both sides."""
    gen = torch.Generator().manual_seed(rows + c)
    x = randn(gen, (rows, c), 1.0, dtype, device) + 0.3
    s = 1 + randn(gen, (c,), 0.1, torch.float32, device)
    b = randn(gen, (c,), 0.1, torch.float32, device)
    got = layernorm_rows(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got, ln_rows(x.float(), s, b, 1e-5).to(dtype))


@pytest.mark.parametrize("model", ["vit", "clip"])
def test_attn_proj_on_the_mma_loop(device, model):
    """K1 in bf16 at the ViT-B/32 and CLIP shapes (8 frames): the
    projection on the tensor-core loop, within the bf16 bar."""
    sh = chip_smoke.BLOCK_SHAPES[model]
    b, l, c, h = 8, sh["l"], sh["c"], sh["h"]
    gen = torch.Generator().manual_seed(l)
    x = randn(gen, (b, l, c), 0.05, torch.bfloat16, device)
    qkv = randn(gen, (b, l, 3 * c), 1.5, torch.bfloat16, device)
    pw = randn(gen, (c, c), c**-0.5, torch.bfloat16, device)
    pb = randn(gen, (c,), 0.1, torch.float32, device)
    assert attn_proj.routes(x, pw, h) == dict(core="mma", proj="mma")
    bf16_bar(attn_proj_residual(x, qkv, pw, pb, h), attn_proj_residual_reference(x, qkv, pw, pb, h))


# (27, 2000): the query pass's shape, one query tile over 264 ref splits;
# D 15 and 511 reach the kernel padded with zeros to 16 and 512.
@pytest.mark.parametrize("nq,nr,d", [(70, 130, 15), (1, 1, 511), (200, 65, 64), (27, 2000, 511),
                                     (27, 2000, 15)])
def test_row_max_ragged(device, nq, nr, d):
    gen = torch.Generator().manual_seed(nq + nr + d)
    q = randn(gen, (nq, d), 1.0, torch.float32, device)
    r = randn(gen, (nr, d), 1.0, torch.float32, device)
    assert_close(row_max_gemm(q, r), row_max_gemm_reference(q, r), (1e-5 * d, 0.0))


def unit(x):
    return x / x.norm(dim=1, keepdim=True)


def k3_last_split(gen):
    """One query row against 100,000 refs whose best match, the query
    itself, is the last ref: it lies in the last of the grid's splits."""
    q = unit(torch.randn((1, 511), generator=gen))
    r = unit(torch.randn((100_000, 511), generator=gen))
    r[-1] = q[0]
    tiles, splits = row_max_grid(1, 100_000)
    assert (tiles, splits) == (1, 264) and (splits - 1) * 100_000 // splits <= 99_999
    return q, r


def k3_all_negative(gen):
    """Positive queries against negative refs: every score is below 0."""
    return (unit(torch.randn((300, 64), generator=gen).abs()),
            -unit(torch.randn((2000, 64), generator=gen).abs()))


def k3_zero_max(gen):
    """Each row's max is 0 (of either sign): the first refs share no
    dimension with the queries (their products are +0.0 or -0.0, as the
    ref entries are negative or positive), the rest score below 0."""
    q = torch.zeros((5, 32))
    q[:, :16] = torch.randn((5, 16), generator=gen).abs() + 0.1
    r = -(torch.randn((600, 32), generator=gen).abs() + 0.1)
    r[:4, :16] = 0.0
    r[1:3, 16:] *= -1.0
    return q, r


K3_EDGES = {"max in the last split": k3_last_split, "all negative": k3_all_negative,
            "zero max": k3_zero_max}


@pytest.mark.parametrize("case", K3_EDGES)
def test_row_max_split_grid_edges(device, case):
    q, r = K3_EDGES[case](torch.Generator().manual_seed(9))
    q, r = q.to(device), r.to(device)
    before = row_max_gemm.launches
    got = row_max_gemm(q, r)
    assert row_max_gemm.launches == before + 1
    want = row_max_gemm_reference(q, r)
    assert_close(got, want, (1e-5, 0.0))
    if case == "all negative":
        assert (got < 0).all()
    if case == "zero max":
        assert (got == 0).all() and (want == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    x = torch.zeros(2, 5, 32, device=device, dtype=torch.float16)
    with pytest.raises(TypeError):
        attn_proj_residual(x, torch.zeros(2, 5, 96, device=device, dtype=torch.float16),
                           torch.zeros(32, 32, device=device, dtype=torch.float16),
                           torch.zeros(32, device=device), 2)
    x = torch.zeros(2, 5, 32, device=device)
    with pytest.raises(ValueError):  # qkv not contiguous
        attn_proj_residual(x, torch.zeros(2, 5, 192, device=device)[..., ::2],
                           torch.zeros(32, 32, device=device), torch.zeros(32, device=device), 2)
    with pytest.raises(ValueError):  # weights on the CPU
        ln_mlp_residual(torch.zeros(4, 8, device=device), torch.ones(8), torch.zeros(8),
                        torch.zeros(16, 8), torch.zeros(16), torch.zeros(8, 16), torch.zeros(8))


def window_tables(gen, h, n, nw, device):
    """rpb = 16 sigmoid(N(0,1)), scale = exp(N(2, 0.3^2)), and a shift-like
    mask (-100 on 20% of the pairs; zeros for one window per item)."""
    rpb = (16 * torch.sigmoid(torch.randn((h, n, n), generator=gen))).to(device)
    scale = torch.exp(2 + 0.3 * torch.randn((h,), generator=gen)).to(device)
    mask = torch.where(torch.rand((nw, n, n), generator=gen) > 0.8, -100.0, 0.0)
    if nw == 1:
        mask.zero_()
    return rpb, scale, mask.to(device)


# (W, N, C, H, nW): stage-1 and stage-2 classes with ragged window counts,
# a stage-4 class, a single window, and windows of 36 and 16 tokens whose
# row counts are no multiple of the 64-row tiles, with head dims 16 and 20.
SWIN_CASES = [(16, 256, 128, 4, 16), (12, 256, 256, 8, 4), (3, 64, 128, 4, 1),
              (1, 256, 128, 4, 1), (10, 36, 48, 3, 5), (7, 16, 40, 2, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,n,c,h,nw", SWIN_CASES)
def test_swin_block_ragged(device, dtype, w, n, c, h, nw):
    gen = torch.Generator().manual_seed(w * n + c)
    f = 4 * c
    qkv_b = randn(gen, (3 * c,), 0.05, torch.float32, device)
    qkv_b[c : 2 * c] = 0.0  # the zero k bias of the contract
    args = (
        randn(gen, (w, n, c), 1.0, dtype, device),
        randn(gen, (3 * c, c), c**-0.5, dtype, device), qkv_b,
        randn(gen, (c, c), c**-0.5, dtype, device), randn(gen, (c,), 0.05, torch.float32, device),
        1 + randn(gen, (c,), 0.1, torch.float32, device), randn(gen, (c,), 0.1, torch.float32, device),
        randn(gen, (f, c), c**-0.5, dtype, device), randn(gen, (f,), 0.05, torch.float32, device),
        randn(gen, (c, f), f**-0.5, dtype, device), randn(gen, (c,), 0.05, torch.float32, device),
        1 + randn(gen, (c,), 0.1, torch.float32, device), randn(gen, (c,), 0.1, torch.float32, device),
        *window_tables(gen, h, n, nw, device), h, nw,
    )
    before = swin_block.launches
    got = swin_block(*args)
    assert swin_block.launches == before + 1
    want = swin_block_reference(*args)
    torch.cuda.synchronize()
    ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL, block=True)
    assert ok, (err, words)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,h,n,hd,nw", [(32, 4, 256, 32, 16), (9, 8, 256, 32, 3),
                                         (5, 32, 64, 32, 1), (1, 4, 256, 32, 1),
                                         (6, 3, 36, 16, 2), (4, 2, 16, 20, 4)])
def test_window_attention_ragged(device, dtype, w, h, n, hd, nw):
    gen = torch.Generator().manual_seed(w * n + hd)
    q, k, v = (randn(gen, (w, h, n, hd), 1.0, dtype, device) for _ in range(3))
    args = (q, k, v, *window_tables(gen, h, n, nw, device), nw)
    before = window_attention.launches
    got = window_attention(*args)
    assert window_attention.launches == before + 1
    want = window_attention_reference(*args)
    assert_close(got, want, TOL[dtype])
    if dtype == torch.bfloat16:
        bf16_bar(got, want)


def test_window_attention_raises_past_shared_memory(device):
    # f32 k and v of 1024 tokens at hd=32 need 264 KB of shared memory.
    q = torch.zeros(1, 1, 1024, 32, device=device)
    with pytest.raises(RuntimeError):
        window_attention(q, q, q, torch.zeros(1, 1024, 1024, device=device),
                         torch.ones(1, device=device), torch.zeros(1, 1024, 1024, device=device), 1)


# The SwinV2-Base stages: (resolution, window, C, heads). Stages 1 and 2
# also run shifted, with the model's own -100 shift mask.
BASE_STAGES = {1: (64, 16, 128, 4), 2: (32, 16, 256, 8), 3: (16, 16, 512, 16), 4: (8, 8, 1024, 32)}
STAGE_CASES = [(st, sh) for st in BASE_STAGES for sh in ((False, True) if st < 3 else (False,))]
# B1's items per stage: 4096 token rows at least. On few windows cuBLAS
# sums the plain version's f32 products in another order, and even a B1
# whose products are FFMA chains (equal to cuBLAS's sums on more rows)
# then differs from it in 6-10% of its bf16 outputs at stages 3 and 4 on
# 2 items, ~0.4% on 32 and more (scripts/torch_swin_probe.py --sizes).
B1_ITEMS = {1: 2, 2: 4, 3: 16, 4: 64}


def stage_tables(gen, stage, shifted, peak, device):
    """rpb, scale and mask of a stage; `peak` multiplies the logit scale
    (q * 8 would do nothing under the L2 normalisation), up to the model's
    clamp at 100."""
    res, window, c, h = BASE_STAGES[stage]
    n, per_item = window * window, (res // window) ** 2
    mask = (_shift_attn_mask(res, res, window, window // 2) if shifted
            else torch.zeros(1, n, n).numpy())
    rpb = (16 * torch.sigmoid(torch.randn((h, n, n), generator=gen))).to(device)
    scale = (torch.exp(2 + 0.3 * torch.randn((h,), generator=gen)) * peak).clamp(max=100.0)
    return rpb, scale.to(device), torch.as_tensor(mask).to(device), (per_item if shifted else 1)


@pytest.mark.parametrize("peak", [1.0, 8.0], ids=["soft", "peaked"])
@pytest.mark.parametrize("stage,shifted", STAGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_at_the_swinv2_base_stages(device, dtype, stage, shifted, peak):
    """B6 on the tensor-core core, two items of each stage; a q row and a
    k row all zero (q̂ = 0 through the 1e-12)."""
    res, window, c, h = BASE_STAGES[stage]
    n, hd = window * window, c // h
    assert window_core(n, hd) == "mma"
    gen = torch.Generator().manual_seed(10 * stage + shifted)
    rpb, scale, mask, nw = stage_tables(gen, stage, shifted, peak, device)
    w = 2 * nw
    q, k, v = (randn(gen, (w, h, n, hd), 1.0, dtype, device) for _ in range(3))
    q[0, 0, 3] = 0.0
    k[w - 1, h - 1, 5] = 0.0
    args = (q, k, v, rpb, scale, mask, nw)
    got = window_attention(*args)
    want = window_attention_reference(*args)
    if dtype == torch.bfloat16:
        bf16_bar(got, want)
    else:
        # At logit scales of 60-100 one f32 rounding of q̂ . k̂ in another
        # order moves a logit by ~1e-5: peaked f32 cases are held to
        # chip_smoke's f32 bar, soft ones to TOL.
        assert_close(got, want, TOL[dtype] if peak == 1.0 else chip_smoke.F32_TOL)


@pytest.mark.parametrize("hd", (16, 20, 32))
@pytest.mark.parametrize("n", (16, 36, 64, 256))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_token_counts_and_head_dims(device, dtype, n, hd):
    """N 16, 36, 64 and 256 at hd 16 and 32 (tensor cores) and 20 (FFMA),
    with a -100 mask on 20% of the pairs and on two whole rows but their
    diagonal."""
    gen = torch.Generator().manual_seed(n + hd)
    h, nw = 3, 2
    q, k, v = (randn(gen, (2 * nw, h, n, hd), 1.0, dtype, device) for _ in range(3))
    rpb, scale, mask = window_tables(gen, h, n, nw, device)
    mask[:, :2] = -100.0
    mask[:, 0, 0] = mask[:, 1, 1] = 0.0
    args = (q, k, v, rpb, scale, mask, nw)
    got = window_attention(*args)
    want = window_attention_reference(*args)
    assert_close(got, want, TOL[dtype])
    if dtype == torch.bfloat16:
        bf16_bar(got, want)


def test_window_core_refuses_operands_off_16_bytes(device):
    """A contiguous view one element into a buffer: the tensor-core core's
    vector loads cannot take it, so the launch fails and the wrapper raises."""
    w, h, n, hd = 2, 2, 64, 32
    buf = torch.zeros(w * h * n * hd + 1, device=device, dtype=torch.bfloat16)
    q = buf[1:].view(w, h, n, hd)
    with pytest.raises(RuntimeError, match="misaligned"):
        window_attention(q, q, q, torch.zeros(h, n, n, device=device),
                         torch.ones(h, device=device), torch.zeros(1, n, n, device=device), 1)


def swin_args(gen, w, n, c, h, dtype, device, tables):
    f = 4 * c
    qkv_b = randn(gen, (3 * c,), 0.05, torch.float32, device)
    qkv_b[c : 2 * c] = 0.0  # the zero k bias of the contract
    vec = lambda m, std: randn(gen, (m,), std, torch.float32, device)
    return (
        randn(gen, (w, n, c), 1.0, dtype, device),
        randn(gen, (3 * c, c), c**-0.5, dtype, device), qkv_b,
        randn(gen, (c, c), c**-0.5, dtype, device), vec(c, 0.05), 1 + vec(c, 0.1), vec(c, 0.1),
        randn(gen, (f, c), c**-0.5, dtype, device), vec(f, 0.05),
        randn(gen, (c, f), f**-0.5, dtype, device), vec(c, 0.05), 1 + vec(c, 0.1), vec(c, 0.1),
        *tables,
    )


def assert_block_bar(got, want):
    torch.cuda.synchronize()
    ok, err, share, words = chip_smoke.agreement(got, want, chip_smoke.F32_TOL, block=True)
    assert ok, (err, words)


@pytest.mark.parametrize("peak", [1.0, 8.0], ids=["soft", "peaked"])
@pytest.mark.parametrize("stage,shifted", STAGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swin_block_at_the_swinv2_base_stages(device, dtype, stage, shifted, peak):
    """B1 at each stage (`B1_ITEMS`): the attention on the tensor-core core,
    proj, fc1 and fc2 on tensor cores in bf16, QKV on an FFMA tile."""
    res, window, c, h = BASE_STAGES[stage]
    n = window * window
    gen = torch.Generator().manual_seed(20 * stage + shifted)
    rpb, scale, mask, nw = stage_tables(gen, stage, shifted, peak, device)
    w = B1_ITEMS[stage] * (res // window) ** 2
    args = swin_args(gen, w, n, c, h, dtype, device, (rpb, scale, mask, h, nw))
    bf16 = dtype == torch.bfloat16
    mma = "mma" if bf16 else "ffma"
    assert routes(*(args[i] for i in (0, 1, 3, 7, 9)), h) == dict(
        core="mma", qkv="ffma128" if bf16 else "ffma", proj=mma, fc1=mma, fc2=mma)
    assert_block_bar(swin_block(*args), swin_block_reference(*args))


# (W, N, C, H): B1's products at tails in M (W N off 128 rows), N (3C, C
# and 4C off 128 columns) and K (C and 4C off the 32-deep slice: 40, 136;
# under one slice: 24).
GEMM_TAILS = [(5, 36, 136, 4), (3, 64, 96, 3), (7, 16, 40, 2), (2, 16, 24, 1)]


@pytest.mark.parametrize("w,n,c,h", GEMM_TAILS)
def test_swin_block_product_tails(device, w, n, c, h):
    gen = torch.Generator().manual_seed(w * n * c)
    tables = (*window_tables(gen, h, n, 1, device), h, 1)
    args = swin_args(gen, w, n, c, h, torch.bfloat16, device, tables)
    assert routes(*(args[i] for i in (0, 1, 3, 7, 9)), h)["fc2"] == "mma"
    assert_block_bar(swin_block(*args), swin_block_reference(*args))


# sha256 of B1's bf16 output on `b1_digest_args` (NVIDIA H100 80GB HBM3,
# torch 2.11.0+cu128, CUDA 12.8), as B1 gave it before `gemm_mma_kernel`
# took its residual epilogue (`scripts/torch_gemm_probe.py --digests` on
# both checkouts); B1 never reads that epilogue, so its arithmetic must not
# move.
B1_DIGESTS = {
    3: "723593496c3191f1f6f5662c833bf187f359123f21dafbbb382b29c27a74df45",
    4: "96251d5dd4ca39e635eef8628c558788e9aca5eaae9745c0dc08a1b4634f9f9a",
}


@pytest.mark.parametrize("stage,items", [(3, 16), (4, 64)])
def test_swin_block_bitwise_as_before_the_residual_epilogue(device, stage, items):
    out = swin_block(*b1_digest_args(stage, items, device))
    torch.cuda.synchronize()
    assert digest(out) == B1_DIGESTS[stage]


def test_swin_block_misaligned_x(device):
    """x one element into a buffer: QKV's FFMA tile and the residual reads
    take it as they take any row-major operand; the block still agrees
    with its plain version."""
    w, n, c, h = 4, 64, 128, 4
    gen = torch.Generator().manual_seed(3)
    tables = (*window_tables(gen, h, n, 1, device), h, 1)
    args = list(swin_args(gen, w, n, c, h, torch.bfloat16, device, tables))
    buf = torch.zeros(w * n * c + 1, device=device, dtype=torch.bfloat16)
    x = buf[1:].view(w, n, c)
    x.copy_(args[0])
    args[0] = x
    assert routes(*(args[i] for i in (0, 1, 3, 7, 9)), h)["qkv"] == "ffma128"
    assert_block_bar(swin_block(*args), swin_block_reference(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,hidden", [(37, 48, 80), (1, 32, 128), (16448, 128, 512)])
def test_fused_mlp_ragged(device, dtype, rows, c, hidden):
    gen = torch.Generator().manual_seed(rows + c + hidden)
    args = (
        randn(gen, (rows, c), 1.0, dtype, device),
        randn(gen, (hidden, c), c**-0.5, dtype, device),
        randn(gen, (hidden,), 0.1, dtype, device),  # biases in the dtype, as layers.Mlp
        randn(gen, (c, hidden), hidden**-0.5, dtype, device),
        randn(gen, (c,), 0.1, dtype, device),
    )
    before = fused_mlp.launches
    got = fused_mlp(*args)
    assert fused_mlp.launches == before + 1
    assert_close(got, fused_mlp_reference(*args), TOL[dtype])


# B7 at SwinV2-Base's stage 1 and stage 4 widths (C 128 and 1024, hidden
# 4C): 16 frames' rows of stage 1 and a 128-frame chunk's of stage 4.
B7_STAGES = {1: (16 * 64 * 64, 128), 4: (128 * 8 * 8, 1024)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", sorted(B7_STAGES))
def test_fused_mlp_at_the_swinv2_base_stages(device, dtype, stage):
    """Both products on tensor cores: the tensor-core loop in bf16 (the
    bf16 bar), 3xTF32 in f32 (TOL)."""
    rows, c = B7_STAGES[stage]
    gen = torch.Generator().manual_seed(40 + stage)
    args = chip_smoke.fused_mlp_args(gen, rows, c, 4 * c, dtype, device)
    loop = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert mlp.fused_mlp_routes(args[0], args[1], args[3]) == dict(fc1=loop, fc2=loop)
    before = fused_mlp.launches
    got = fused_mlp(*args)
    assert fused_mlp.launches == before + 1
    want = fused_mlp_reference(*args)
    if dtype == torch.bfloat16:
        bf16_bar(got, want)
    else:
        assert_close(got, want, TOL[dtype])


# (rows, C, hidden, x offset) across B7's route rule: K off 8 but on 4 (C
# 36, hidden 132), fc2's K off both (hidden 70), fc1's off both (C 30),
# rows off the 128-row tile, and x one element into its buffer (fc1's
# operand off 16 bytes).
B7_RULE_CASES = [(33, 36, 132, 0), (130, 100, 70, 0), (300, 30, 128, 0), (1000, 64, 256, 0),
                 (129, 128, 512, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,hidden,offset", B7_RULE_CASES)
def test_fused_mlp_across_the_route_rule(device, dtype, rows, c, hidden, offset):
    gen = torch.Generator().manual_seed(rows + c + hidden + offset)
    x, w1, b1, w2, b2 = chip_smoke.fused_mlp_args(gen, rows, c, hidden, dtype, device)
    if offset:
        buf = torch.zeros(rows * c + offset, dtype=dtype, device=device)
        buf[offset:].copy_(x.flatten())
        x = buf[offset:].view(rows, c)
    bf16 = dtype == torch.bfloat16

    def rule(k, aligned):
        if aligned and k % (8 if bf16 else 4) == 0:
            return "mma" if bf16 else "tf32x3"
        return "ffma"

    assert mlp.fused_mlp_routes(x, w1, w2) == dict(fc1=rule(c, offset == 0), fc2=rule(hidden, True))
    before = fused_mlp.launches
    got = fused_mlp(x, w1, b1, w2, b2)
    assert fused_mlp.launches == before + 1
    assert_close(got, fused_mlp_reference(x, w1, b1, w2, b2), TOL[dtype])


# The legacy zoo's shapes (chip_smoke.py phase 13), 4 frames each: MAE
# ViT-B/16@224's blocks (L 197, a ragged token count at hd 64) through K1
# and K2 in bf16, and Swin-T v1's B7 in f32 at stage 1 (C 96: K 96 for fc1)
# and stage 4 (C 768), both products on 3xTF32.
MAE_B16 = dict(l=197, c=768, h=12)
SWIN_V1_B7 = {1: (4 * 56 * 56, 96), 4: (4 * 7 * 7, 768)}


def test_attn_proj_at_mae_vit_b16(device):
    b, l, c, h = 4, MAE_B16["l"], MAE_B16["c"], MAE_B16["h"]
    gen = torch.Generator().manual_seed(197)
    x = randn(gen, (b, l, c), 0.05, torch.bfloat16, device)
    qkv = randn(gen, (b, l, 3 * c), 1.5, torch.bfloat16, device)
    pw = randn(gen, (c, c), c**-0.5, torch.bfloat16, device)
    pb = randn(gen, (c,), 0.1, torch.float32, device)
    assert attn_proj.routes(x, pw, h) == dict(core="mma", proj="mma")
    before = attn_proj_residual.launches
    got = attn_proj_residual(x, qkv, pw, pb, h)
    assert attn_proj_residual.launches == before + 1
    bf16_bar(got, attn_proj_residual_reference(x, qkv, pw, pb, h))


def test_ln_mlp_at_mae_vit_b16(device):
    c = MAE_B16["c"]
    gen = torch.Generator().manual_seed(198)
    args = mlp_args(gen, 4 * MAE_B16["l"], c, 4 * c, "gelu", 1e-6, torch.bfloat16, device)
    assert mlp.routes(args[0], args[3], args[5]) == dict(ln="rows", fc1="mma", fc2="mma")
    before = ln_mlp_residual.launches
    got = ln_mlp_residual(*args)
    assert ln_mlp_residual.launches == before + 1
    bf16_bar(got, ln_mlp_residual_reference(*args))


@pytest.mark.parametrize("stage", sorted(SWIN_V1_B7))
def test_fused_mlp_at_swin_v1_stages(device, stage):
    rows, c = SWIN_V1_B7[stage]
    gen = torch.Generator().manual_seed(50 + stage)
    args = chip_smoke.fused_mlp_args(gen, rows, c, 4 * c, torch.float32, device)
    assert mlp.fused_mlp_routes(args[0], args[1], args[3]) == dict(fc1="tf32x3", fc2="tf32x3")
    before = fused_mlp.launches
    got = fused_mlp(*args)
    assert fused_mlp.launches == before + 1
    assert_close(got, fused_mlp_reference(*args), TOL[torch.float32])


@pytest.mark.parametrize("name", ["swin_v1_tiny_test", "efficientnet_tiny_test",
                                  "mae_tiny_test", "roberta_tiny_test"])
def test_tiny_legacy_members_on_the_card_match_the_cpu(device, name):
    """Each tiny legacy member in f32, the card (B7 for Swin v1, K1 and K2
    for MAE, B8 for the unmasked text encoder, cuDNN's convolutions with
    TF32 off) against the CPU's plain path, same seeded weights."""
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.models.registry import build_backbone

    cpu = build_backbone({"type": name})
    reset_parameters(cpu, torch.Generator().manual_seed(3))
    card = build_backbone({"type": name}, device=device)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    if name == "roberta_tiny_test":
        x = torch.randint(0, 64, (2, 12), generator=gen)
    else:
        x = torch.randn((2, 32, 32, 3), generator=gen)
    with torch.no_grad():
        want = cpu(x)
        got = card(x.to(device))
    assert_close(got.cpu(), want, (1e-4, 1e-4))


# (nq, nr, d, num_valid, e, tile_r, k): query counts off the 64-row tile,
# D 1, 511 and 512, num_valid inside the last (ragged) block, e 1 to 8,
# tile_r off the 64-column sub-tile, and k past nb * e (padded).
TOPK_CASES = [(70, 3000, 512, 2950, 4, 1024, 16), (1, 2048, 511, 2048, 1, 256, 5),
              (130, 700, 1, 650, 8, 128, 20), (64, 1500, 64, 1499, 2, 100, 40),
              (200, 5000, 96, 4900, 3, 512, 50), (33, 4096, 128, 3000, 5, 1024, 8),
              (257, 9000, 32, 8999, 6, 1000, 16), (5, 640, 48, 640, 7, 64, 64)]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("nq,nr,d,nv,e,tile_r,k", TOPK_CASES)
def test_extract_topk_ragged(device, dtype, nq, nr, d, nv, e, tile_r, k):
    gen = torch.Generator().manual_seed(nq + nr + d + e)
    # entries of variance 1/D, so the scores are O(1) at every D
    q = randn(gen, (nq, d), d**-0.5, dtype, device)
    r = randn(gen, (nr, d), d**-0.5, dtype, device)
    route = "mma" if dtype == torch.float16 and d % 8 == 0 else "ffma"
    assert topk_route(dtype, d, q, r) == route
    before, on_route = extract_topk.launches, extract_topk.route_launches[route]
    got = extract_topk(q, r, nv, e=e, tile_r=tile_r, k=k)
    assert extract_topk.launches == before + 1
    assert extract_topk.route_launches[route] == on_route + 1
    want = extract_topk_reference(q, r, nv, e=e, tile_r=tile_r, k=k + 1)
    torch.cuda.synchronize()
    ok, err, differ = chip_smoke.topk_agreement(got, want)
    assert ok, (err, differ)
    nb_e = -(-nr // tile_r) * e
    if k > nb_e:
        assert (got[0][:, nb_e:] == want[0][:, nb_e:k]).all()
        assert (got[1][:, nb_e:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
@pytest.mark.parametrize("e", [1, 2, 4, 8])
def test_extract_topk_duplicate_rows_lowest_column_wins(device, dtype, e):
    """Duplicate ref rows score exactly alike (small integers: every
    product and sum is exact in any order), so the kernel must surface
    them in column order within a block and rank them so across blocks."""
    gen = torch.Generator().manual_seed(e)
    d, nr, tile_r = 40, 2100, 256
    r = torch.randint(-1, 2, (nr, d), generator=gen).float()
    q = torch.randint(0, 3, (70, d), generator=gen).float()
    dup = [3, 70, 71, 200, 255, 256, 300, 301, 1800, 2099]
    r[dup] = 3.0
    r[2000:2050] = r[1999]  # a run of equal rows across a block edge
    q, r = q.to(dtype).to(device), r.to(dtype).to(device)
    assert topk_route(dtype, d, q, r) == ("mma" if dtype == torch.float16 else "ffma")
    got = extract_topk(q, r, nr, e=e, tile_r=tile_r, k=12)
    want = extract_topk_reference(q, r, nr, e=e, tile_r=tile_r, k=12)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    per_block = {}
    for col in dup:
        per_block.setdefault(col // tile_r, []).append(col)
    lowest = sorted(c for cols in per_block.values() for c in cols[:e])
    assert got[1][:, : len(lowest)].tolist() == [lowest] * 70


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_extract_topk_operands_off_the_vector_alignment(device, dtype):
    """Contiguous views that start one element into a buffer: the kernel
    must not take its aligned vector loads there."""
    gen = torch.Generator().manual_seed(11)
    nq, nr, d = 50, 700, 64
    qb = randn(gen, (nq * d + 1,), d**-0.5, dtype, device)
    rb = randn(gen, (nr * d + 1,), d**-0.5, dtype, device)
    q, r = qb[1:].view(nq, d), rb[1:].view(nr, d)
    assert topk_route(dtype, d, q, r) == "ffma"
    got = extract_topk(q, r, nr, e=4, tile_r=256, k=10)
    want = extract_topk_reference(q, r, nr, e=4, tile_r=256, k=11)
    torch.cuda.synchronize()
    ok, err, differ = chip_smoke.topk_agreement(got, want)
    assert ok, (err, differ)


def test_extract_topk_rejects_what_the_kernel_does_not_take(device):
    q = torch.zeros(4, 8, device=device)
    with pytest.raises(TypeError):  # mixed types
        extract_topk(q, torch.zeros(16, 8, device=device, dtype=torch.float16), 16, e=2,
                     tile_r=8, k=2)
    with pytest.raises(ValueError):  # refs on the CPU
        extract_topk(q, torch.zeros(16, 8), 16, e=2, tile_r=8, k=2)
    with pytest.raises(ValueError):  # e past the template range
        extract_topk(q, torch.zeros(16, 8, device=device), 16, e=9, tile_r=16, k=2)


@pytest.mark.parametrize("nq,nr,d,nv,e,tile_r,k", [c for c in TOPK_CASES if c[2] % 8 == 0])
def test_extract_topk_bf16_on_the_tensor_core_route(device, nq, nr, d, nv, e, tile_r, k):
    """B5 in bf16 (the searcher's `compute_dtype`): the tensor-core route,
    held to its plain version (the f32 products of the bf16 operands) at
    TOPK_TOL; off the route's rule (D % 8, alignment) it raises."""
    gen = torch.Generator().manual_seed(nq + nr + d + e)
    q = randn(gen, (nq, d), d**-0.5, torch.bfloat16, device)
    r = randn(gen, (nr, d), d**-0.5, torch.bfloat16, device)
    assert topk_route(torch.bfloat16, d, q, r) == "mma"
    before = dict(extract_topk.route_launches), extract_topk.dtype_launches[torch.bfloat16]
    got = extract_topk(q, r, nv, e=e, tile_r=tile_r, k=k)
    assert extract_topk.route_launches["mma"] == before[0]["mma"] + 1
    assert extract_topk.dtype_launches[torch.bfloat16] == before[1] + 1
    want = extract_topk_reference(q, r, nv, e=e, tile_r=tile_r, k=k + 1)
    torch.cuda.synchronize()
    ok, err, differ = chip_smoke.topk_agreement(got, want)
    assert ok, (err, differ)
    with pytest.raises(ValueError, match="tensor-core loop only"):
        extract_topk(q[:, 1:].contiguous(), r[:, 1:].contiguous(), nv, e=e, tile_r=tile_r, k=k)


def test_extract_topk_bf16_duplicate_rows_bitwise(device):
    """Small integers are exact in bf16, and so is every sum: B5's bf16
    route equals its plain version bit for bit, lowest column first."""
    gen = torch.Generator().manual_seed(5)
    d, nr, tile_r = 40, 2100, 256
    r = torch.randint(-1, 2, (nr, d), generator=gen).float()
    q = torch.randint(0, 3, (70, d), generator=gen).float()
    r[[3, 70, 71, 200, 255, 256, 300, 301, 1800, 2099]] = 3.0
    r[2000:2050] = r[1999]
    q, r = q.bfloat16().to(device), r.bfloat16().to(device)
    got = extract_topk(q, r, nr, e=4, tile_r=tile_r, k=12)
    want = extract_topk_reference(q, r, nr, e=4, tile_r=tile_r, k=12)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# sha256 of B5's outputs on `b5_digest_args`, from the kernel before the
# tensor-core route was added: the FFMA route must not have moved.
B5_FFMA_DIGESTS = {
    ("f32", 512): "9ba03624b7671b000a3f6f0b1a831154d654b48cf6d6007814e647b400b0bda1",
    ("f16", 511): "8440a6636e967d58333f43f6c09a4502c664d4ea9034f88d924f940cb572ffbf",
}


@pytest.mark.parametrize("dt,d", list(B5_FFMA_DIGESTS))
def test_extract_topk_ffma_route_bitwise_as_before(device, dt, d):
    assert b5_digest(dt, d, device) == B5_FFMA_DIGESTS[(dt, d)]


# --- gradients: each differentiable wrapper's recompute VJP ------------------


def _grad_case(name, dtype, device):
    """(wrapper, plain, args, static) at a ragged shape of `name`."""
    gen = torch.Generator().manual_seed(13)
    r = lambda shape, std=1.0: randn(gen, shape, std, dtype, device)
    v = lambda n, std=0.05: randn(gen, (n,), std, torch.float32, device)
    b, l, c, h, f = 3, 37, 96, 3, 160
    p = chip_smoke.block_params(gen, c, f, dtype, device)
    half = [r((b, l, c)), p["ln1_s"], p["ln1_b"], p["qkv_w"], p["qkv_b"], p["proj_w"],
            p["proj_b"]]
    if name == "K1":
        return (attn_proj_residual, attn_proj_residual_reference,
                [r((b, l, c)), r((b, l, 3 * c)), p["proj_w"], p["proj_b"]], (h,))
    if name == "B9":
        return ln_attn_proj_residual, ln_attn_proj_residual_reference, half, (h, 1e-6)
    if name == "B10":
        return (vit_block, vit_block_reference,
                half + [p["ln2_s"], p["ln2_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"]],
                (h, "quick_gelu", 1e-5))
    if name == "K2":
        return (ln_mlp_residual, ln_mlp_residual_reference,
                [r((130, c)), p["ln2_s"], p["ln2_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"],
                 p["fc2_b"]], ("gelu", 1e-6))
    if name == "B7":
        return (fused_mlp, fused_mlp_reference,
                [r((130, c)), p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"]], ())
    if name == "B8":
        return (packed_attention, packed_attention_reference,
                [r((b, l, h, 32), 0.2), r((b, l, h, 32)), r((b, l, h, 32))], ())
    n, nw = 49, 2
    mask = torch.as_tensor(_shift_attn_mask(14, 14, 7, 3)[:nw]).to(device)
    rpb, scale, _ = chip_smoke.window_tables(gen, h, n, mask.cpu().numpy(), device)
    if name == "B6":
        return (window_attention, window_attention_reference,
                [r((4, h, n, 32)) for _ in range(3)] + [rpb, scale, mask], (nw,))
    qkv_b = p["qkv_b"].clone()
    qkv_b[c:2 * c] = 0.0
    return (swin_block, swin_block_reference,
            [r((4, n, c)), p["qkv_w"], qkv_b, p["proj_w"], p["proj_b"], p["ln1_s"],
             p["ln1_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"], p["ln2_s"],
             p["ln2_b"], rpb, scale, mask], (h, nw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["K1", "K2", "B7", "B9", "B10", "B8", "B6", "B1"])
def test_wrapper_gradients_match_the_plain_version(device, name, dtype):
    """On a CUDA tensor that requires grad each wrapper launches its kernel,
    returns a result with a grad_fn and the plain version's output (phase
    2's bar, B1's and B10's block atol for them; B10's q rounded as the
    kernel rounds it), and its input gradients
    are autograd's through the plain version (`chip_smoke.grad_check`: f32
    within 1e-4 of each input's max |g|, bf16 by phase 2's bar)."""
    wrapper, plain, args, static = _grad_case(name, dtype, device)
    # B10 at hd 32: the kernel folds q's scale before rounding q, the JAX
    # oracle (the recompute) after (`ops/vit_block.py`).
    plain_out = functools.partial(vit_block_reference, fold_scale=True) if name == "B10" else None
    chip_smoke.grad_check(f"{name} {dtype}", wrapper, plain, args, static,
                          block=name in ("B1", "B10"), reps=1, plain_out=plain_out)


def test_topk_and_row_max_refuse_grad_on_the_card(device):
    q = torch.randn(16, 64, device=device, requires_grad=True)
    r = torch.randn(300, 64, device=device)
    with pytest.raises(RuntimeError, match="not differentiable"):
        extract_topk(q, r, 300, e=2, tile_r=64, k=4)
    with pytest.raises(RuntimeError, match="not differentiable"):
        row_max_gemm(q, r)
    with torch.no_grad():
        assert row_max_gemm(q, r).shape == (16,)


def test_matmul_f32_gradients_on_the_card(device):
    """`layers.matmul_f32` in bf16 (`torch.mm(..., out_dtype=float32)`, the
    ViT's QKV): its cotangents are autograd's through the f32 upcast, the
    f32 products rounded once to each operand's dtype."""
    from vsc22_tpu_torch.models.layers import matmul_f32

    gen = torch.Generator().manual_seed(14)
    x = randn(gen, (2, 37, 96), 1.0, torch.bfloat16, device)
    w = randn(gen, (288, 96), 96**-0.5, torch.bfloat16, device)
    cot = randn(gen, (2, 37, 288), 1.0, torch.float32, device)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    got = matmul_f32(xs[0], ws[0].t())
    want = xs[1].float() @ ws[1].float().t()
    assert got.dtype == torch.float32 and got.grad_fn is not None
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    got.backward(cot)
    want.backward(cot)
    for a, b in ((xs[0], xs[1]), (ws[0], ws[1])):
        assert a.grad.dtype == torch.bfloat16
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=0, atol=0)


def test_dropout_masks_are_drawn_on_the_card(device):
    """`DropRng` draws each mask on the tensor's device and keeps it for the
    step's second pass; the VSM trainer (dropout 0.1, EMA) steps on the card
    with its masks and parameters there, and a step's seed comes from the
    CPU generator, so a reseeded run repeats it."""
    from vsc22_tpu_torch.models.layers import DropRng, reset_parameters
    from vsc22_tpu_torch.models.vsm import VSM_TINY_TEST, VideoScoreModel
    from vsc22_tpu_torch.train import vid_score

    rng = DropRng(torch.Generator().manual_seed(0))
    mask = rng.keep_mask("k", (64, 32), 0.9, device)
    assert mask.device.type == "cuda" and mask.dtype == torch.bool
    assert rng.keep_mask("k", (64, 32), 0.9, device) is mask
    assert 0.8 < float(mask.float().mean()) < 0.97
    cfg = vid_score.VidScoreConfig(learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
                                   ema_decay=0.9)
    gen = torch.Generator().manual_seed(15)
    feats = randn(gen, (4, 8, 16), 1.0, torch.float32, device)
    batch = {"feats": feats, "label": torch.tensor([1.0, 0.0, 1.0, 0.0], device=device)}
    losses = []
    for _ in range(2):
        model = VideoScoreModel(VSM_TINY_TEST, torch.float32, device)
        reset_parameters(model, torch.Generator().manual_seed(16))
        state, tx = vid_score.create_vid_score_state(model, cfg)
        step = vid_score.make_vid_score_train_step(model, tx, cfg)
        seeds = torch.Generator().manual_seed(17)
        run = [float(step(state, batch, seeds)[1]["loss"]) for _ in range(3)]
        assert all(v == v and abs(v) < 1e3 for v in run)
        assert all(t.device.type == "cuda" for t in state.params.values())
        losses.append(run)
    assert losses[0] == losses[1]


def test_batch_norm_train_mode_on_the_card(device):
    """`layers.BatchNorm` in train mode (flax's fast variance, the running
    buffers' update) on the card against the CPU: output and gradients
    within 1e-5 of max |g| (f32 reductions in another order), buffers
    within 1e-6."""
    from vsc22_tpu_torch.models.layers import BatchNorm

    gen = torch.Generator().manual_seed(18)
    x = torch.randn((6, 9, 11, 24), generator=gen) * 1.5 + 0.3
    cot = torch.randn(x.shape, generator=gen)
    runs = []
    for dev in ("cpu", device):
        bn = BatchNorm(24)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen.manual_seed(19))
            bn.bias.normal_(0, 0.1, generator=gen)
            bn.var.uniform_(0.5, 1.5, generator=gen)
        bn.to(dev)
        xs = x.clone().to(dev).requires_grad_()
        out = bn(xs, train=True)
        out.backward(cot.to(dev))
        runs.append([t.detach().cpu() for t in (out, xs.grad, bn.weight.grad, bn.bias.grad,
                                                bn.mean, bn.var)])
    for i, (want, got) in enumerate(zip(*runs)):
        atol = 1e-6 if i >= 4 else 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("groups", [1, 8])
def test_conv_backward_keeps_tf32_off(device, groups):
    """`layers.Conv` in float32 with cuDNN's TF32 flag ON (torch's default):
    the forward and both gradients within 1e-5 of max |.| of float64 on the
    CPU (TF32's 10-bit mantissa would leave ~1e-3), and the caller's flag
    still on after the backward."""
    from vsc22_tpu_torch.models.layers import Conv

    gen = torch.Generator().manual_seed(20)
    conv = Conv(64, 96, 3, stride=2, pad=1, groups=groups)
    with torch.no_grad():
        conv.weight.normal_(0, conv.weight[0].numel() ** -0.5, generator=gen)
    x = torch.randn((4, 33, 40, 64), generator=gen)
    cot = torch.randn((4, 17, 20, 96), generator=gen)
    ref = Conv(64, 96, 3, stride=2, pad=1, groups=groups, dtype=torch.float64)
    with torch.no_grad():
        ref.weight.copy_(conv.weight.double())
    x64 = x.double().requires_grad_()
    want = ref(x64)
    want.backward(cot.double())
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv.to(device)
        xs = x.to(device).requires_grad_()
        got = conv(xs)
        got.backward(cot.to(device))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for g, w in ((got, want), (xs.grad, x64.grad), (conv.weight.grad, ref.weight.grad)):
        err = float((g.detach().cpu().double() - w.detach()).abs().max())
        assert err <= 1e-5 * float(w.detach().abs().max()), err


# --- the per-video path: OpenCV's arithmetic and the pipeline on the card --------


def test_cv2_resize_and_canny_same_bits_on_the_card(device):
    """`resize_cubic_u8` (integer and float32 elementwise) and `canny_edges`
    (integer and boolean) give the CPU's bits on the card, and so do the
    normalization after the resize and the float64 maps of
    `variance_and_edges_host` (divisions by a device tensor, not a host
    scalar)."""
    from vsc22_tpu_torch.data import fsd
    from vsc22_tpu_torch.data.transforms import clip_preprocess_frames, resize_cubic_u8

    videos = chip_smoke.synth_videos(8, 6, 120, 200, seed=3)
    x = torch.from_numpy(videos[6])  # letterboxed
    for oh, ow in [(384, 384), (224, 373), (37, 61), (120, 200)]:
        assert torch.equal(resize_cubic_u8(x.to(device), oh, ow).cpu(), resize_cubic_u8(x, oh, ow))
    assert torch.equal(clip_preprocess_frames(x.to(device), 224).cpu(),
                       clip_preprocess_frames(x, 224))
    assert torch.equal(fsd.canny_edges(x.to(device)).cpu(), fsd.canny_edges(x))
    for v in videos[5:]:
        cpu = fsd.variance_and_edges_host(list(v), "cpu")
        card = fsd.variance_and_edges_host(list(v), device)
        for a, b in zip(cpu, card):
            assert (a == b).all()


def tiny_query_pipeline(device):
    from vsc22_tpu_torch.models import clip, swinv2, vit, vsm
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.ops.pca import pca_fit
    from vsc22_tpu_torch.pipelines import query_extract as q

    gen = torch.Generator().manual_seed(21)
    models = [vit.vit_tiny_test_descriptor(), swinv2.swinv2_tiny_test_descriptor(),
              clip.clip_tiny_test(),
              vsm.VideoScoreModel(vsm.VSMConfig(feat_dim=32, hidden=32, layers=1, heads=2,
                                                max_frames=8))]
    for m in models:
        reset_parameters(m, gen)
        m.to(device)
    rng = torch.Generator().manual_seed(22)
    pca = pca_fit(torch.randn((200, 24), generator=rng).numpy(), 8, "cpu")
    return q.QueryPipeline(
        [q.DescriptorExtractor(models[0], 64, "efficientnet", chunk=4, device=device),
         q.DescriptorExtractor(models[1], 32, "vit", chunk=4, device=device)],
        pca=pca, ved=q.VideoEditDetector(models[2], models[3], max_frames=8, chunk=4,
                                         device=device),
        score_threshold=0.0, out_dim=8, device=device)


def test_per_video_pipeline_card_equals_cpu(device):
    """The tiny per-video `QueryPipeline` (VED, exact FSD, two members, PCA)
    in float32 on the card against the CPU: the same timestamps (so the same
    FSD crops and dedup), features within 1e-4 and VED scores within 1e-5
    (f32 sums in other orders through the kernels)."""
    videos = chip_smoke.synth_videos(8, 6, 256, 256, seed=4)  # 7: a 2-up stack
    runs = []
    for dev in ("cpu", device):
        pipe = tiny_query_pipeline(dev)
        runs.append(([pipe.process_video(f"Q{i:06d}", list(v)) for i, v in enumerate(videos)],
                     pipe.video_scores))
    (want, want_s), (got, got_s) = runs
    assert len(want[7][1][0].feature) == 12  # FSD split the stack
    for (g, gsub), (w, wsub) in zip(got, want):
        np.testing.assert_array_equal(g.timestamps, w.timestamps)
        np.testing.assert_allclose(g.feature, w.feature, atol=1e-4, rtol=0)
        for a, b in zip(gsub, wsub):
            np.testing.assert_allclose(a.feature, b.feature, atol=1e-4, rtol=0)
        assert abs(got_s[g.video_id] - want_s[w.video_id]) <= 1e-5


def test_offline_clis_default_to_the_card(device, tmp_path, monkeypatch):
    """Without `--device`, `ref_cli`, `query_cli` and `ensemble_cli` run on
    the card (the decode replaced by in-memory frames: the card host may
    have no decoder)."""
    from vsc22_tpu_torch.core.storage import load_features
    from vsc22_tpu_torch.pipelines import ensemble, ensemble_cli, query_cli, ref_cli

    videos = chip_smoke.synth_videos(3, 6, 48, 64, seed=5)
    seen = []

    def fake_decode(videos_dir, fps):
        return [(f"{videos_dir[-1]}{i:05d}", list(v)) for i, v in enumerate(videos)]

    monkeypatch.setattr(query_cli, "decoded_videos", fake_decode)
    monkeypatch.setattr(ref_cli, "decoded_videos", fake_decode)
    real_fit = ensemble.pca_fit
    monkeypatch.setattr(ensemble, "pca_fit",
                        lambda x, k, dev: seen.append(dev) or real_fit(x, k, dev))
    refs = {}
    for split in ("a", "b"):
        refs[split] = ref_cli.main(["--videos", f"R{split}", "--out", str(tmp_path / split),
                                    "--model", "vit_tiny_test:-:64:vit"])
    ensemble_cli.main(["--train_refs", refs["a"], "--test_refs", refs["b"], "--out_dir",
                       str(tmp_path / "fused"), "--components", "8"])
    assert seen and all(torch.device(d).type == "cuda" for d in seen)
    out = query_cli.main(["--videos", "Q", "--out_dir", str(tmp_path / "q"), "--model",
                          "m:vit_tiny_test:-:64:vit", "--pca", str(tmp_path / "fused" /
                                                                   "pca_model.npz"),
                          "--norm_refs", str(tmp_path / "fused" / "train_refs.npz")])
    feats = load_features(out)
    assert len(feats) == 3 and all(np.isfinite(f.feature).all() for f in feats)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_exported_vit_runs_the_kernels(device, dtype, tmp_path):
    """The tiny ViT exported on the card: its program holds a K1 and a K2
    op node per block, the reloaded forward launches them (the wrappers'
    counters), equals the eager model bit for bit, and refuses another
    batch size."""
    import collections

    from vsc22_tpu_torch.models import vit
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.utils.export import export_model, load_exported

    model = vit.vit_tiny_test_descriptor(dtype, device=device)
    reset_parameters(model, torch.Generator().manual_seed(0))
    shape = (4, 64, 64, 3)
    _, path = export_model(str(tmp_path / "vit"), model, shape, dtype)
    program = torch.export.load(path)
    calls = collections.Counter(str(n.target) for n in program.graph.nodes
                                if n.op == "call_function")
    depth = model.backbone.cfg.depth
    assert calls["vsc22.attn_proj_residual.default"] == depth
    assert calls["vsc22.ln_mlp_residual.default"] == depth
    x = randn(torch.Generator().manual_seed(1), shape, 1.0, dtype, device)
    with torch.no_grad():
        eager = model(x)
    call = load_exported(path)
    attn_proj_residual.launches = ln_mlp_residual.launches = 0
    got = call(x)
    torch.cuda.synchronize()
    assert attn_proj_residual.launches == ln_mlp_residual.launches == depth
    assert torch.equal(got, eager)
    with pytest.raises(ValueError):
        call(x[:2])


@pytest.fixture
def nccl_world_of_one(device):
    """A world of one under NCCL on the card, and its (1, 1) mesh."""
    import torch.distributed as dist

    from vsc22_tpu_torch.parallel.distributed import initialize
    from vsc22_tpu_torch.parallel.mesh import create_mesh

    initialize(backend="nccl", world_size=1, rank=0, store=dist.HashStore(), device=device)
    try:
        yield create_mesh()
    finally:
        dist.destroy_process_group()


def test_sharded_step_in_a_world_of_one_is_the_unsharded_step(device, nccl_world_of_one):
    """The tiny ViT's FGM step (drop-path 0.3 in its last block) through
    the NCCL world of one: the gradients and loss of the unsharded step bit
    for bit, K1 and K2 launched; one update through the sharded state."""
    import dataclasses

    from vsc22_tpu_torch.models import vit
    from vsc22_tpu_torch.models.layers import reset_parameters
    from vsc22_tpu_torch.train import contrastive as tc

    model = vit.VitDescriptor(dataclasses.replace(vit.VIT_TINY_TEST, drop_path=0.3),
                              head_dim=64, out_dim=16, device=device)
    reset_parameters(model, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {k: randn(gen, (4, 64, 64, 3), 1.0, torch.float32, device) for k in ("img_a", "img_b")}
    cfg = tc.ContrastiveConfig(fgm_epsilon=0.1, barlow_weight=0.5)
    tx = tc.make_optimizer(cfg)
    want_m, want = tc.make_train_step(model, tx, cfg).gradients(
        batch, torch.Generator().manual_seed(2))
    sharded = tc.make_train_step(model, tx, cfg, mesh=nccl_world_of_one)
    attn_proj_residual.launches = ln_mlp_residual.launches = 0
    got_m, got = sharded.gradients(batch, torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    # block 0 (drop-path 0) on the kernels in both FGM passes
    assert attn_proj_residual.launches >= 2 and ln_mlp_residual.launches >= 2
    assert float(got_m["loss"]) == float(want_m["loss"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    state, _ = tc.create_train_state(model, cfg, mesh=nccl_world_of_one)
    state, metrics = sharded(state, batch, torch.Generator().manual_seed(3))
    assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    assert all(t.device.type == "cuda" for t in state.params.values())


def test_sharded_search_in_a_world_of_one_is_the_one_device_search(device, nccl_world_of_one):
    """B5 serves the shard (f16, 65,536 refs); row_topk and global_topk
    equal the one-device searcher's."""
    from vsc22_tpu_torch.retrieval.search import SimilaritySearcher

    rng = np.random.default_rng(4)
    refs = rng.standard_normal((65536, 128), dtype=np.float32)
    refs /= np.linalg.norm(refs, axis=1, keepdims=True)
    q = refs[:200] + rng.normal(0, 0.05, (200, 128)).astype(np.float32)
    one = SimilaritySearcher(refs, device=device, transfer_dtype=np.float16)
    extract_topk.launches = 0
    shard = SimilaritySearcher(refs, device=device, transfer_dtype=np.float16,
                               mesh=nccl_world_of_one)
    got_rows, got_glob = shard.row_topk(q, 10), shard.global_topk(q, 3000)
    assert extract_topk.launches >= 2
    for got, want in ((got_rows, one.row_topk(q, 10)), (got_glob, one.global_topk(q, 3000))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
