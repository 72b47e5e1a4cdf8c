"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not reach (odd rows and widths, head dims
other than 64 or 32, window sizes other than 16 and 8, tiny, single-row and
single-window operands; B5 at every e, ragged blocks and duplicate rows).

Needs a CUDA device; skips elsewhere. The shared conftest imports JAX,
which the GPU host lacks, so run it there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

import chip_smoke
from vsc22_tpu_torch.ops.attn_proj import attn_proj_residual, attn_proj_residual_reference
from vsc22_tpu_torch.ops.mlp import (
    fused_mlp,
    fused_mlp_reference,
    ln_mlp_residual,
    ln_mlp_residual_reference,
)
from vsc22_tpu_torch.ops.sim import row_max_gemm, row_max_gemm_reference
from vsc22_tpu_torch.ops.swin_block import swin_block, swin_block_reference
from vsc22_tpu_torch.ops.topk import extract_topk, extract_topk_reference
from vsc22_tpu_torch.ops.window_attn import window_attention, window_attention_reference

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


@pytest.mark.parametrize("nq,nr,d", [(70, 130, 15), (1, 1, 511), (200, 65, 64)])
def test_row_max_ragged(device, nq, nr, d):
    gen = torch.Generator().manual_seed(nq + nr + d)
    q = randn(gen, (nq, d), 1.0, torch.float32, device)
    r = randn(gen, (nr, d), 1.0, torch.float32, device)
    assert_close(row_max_gemm(q, r), row_max_gemm_reference(q, r), (1e-5 * d, 0.0))


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
    assert_close(got, window_attention_reference(*args), TOL[dtype])


def test_window_attention_raises_past_shared_memory(device):
    # f32 k and v of 1024 tokens at hd=32 need 264 KB of shared memory.
    q = torch.zeros(1, 1, 1024, 32, device=device)
    with pytest.raises(RuntimeError):
        window_attention(q, q, q, torch.zeros(1, 1024, 1024, device=device),
                         torch.ones(1, device=device), torch.zeros(1, 1024, 1024, device=device), 1)


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
    before = extract_topk.launches
    got = extract_topk(q, r, nv, e=e, tile_r=tile_r, k=k)
    assert extract_topk.launches == before + 1
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
