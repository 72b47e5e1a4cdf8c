"""Which product loop B5 takes (`ops/topk.topk_route`, mirrored by
`topk_is_mma` in `csrc/extract_topk.cu`), K3's grid (`ops/sim.row_max_grid`),
and K3's zero padding of D to `ops/sim.padded_width` (the kernel's f16
copies of its operands): the plain version on padded operands equals it
on unpadded ones bit for bit, and both equal the JAX Pallas kernel
(interpret mode on the CPU). The kernels run only on the
card; these checks run anywhere."""

import numpy as np
import pytest
import torch

from vsc22_tpu.ops.pallas_sim import row_max_gemm as jax_row_max_gemm
from vsc22_tpu_torch.ops.sim import (
    MIN_BLOCKS,
    padded_width,
    row_max_gemm,
    row_max_gemm_reference,
    row_max_grid,
)
from vsc22_tpu_torch.ops.topk import topk_route

F16, F32 = torch.float16, torch.float32


def rows(n, d, dtype=F16, offset=0):
    """n rows of width d, `offset` elements into a buffer (an offset of 1
    puts an f16 operand off 16 bytes); the eval corpus's 1.28M rows as a
    broadcast view of one row, which allocates nothing."""
    if n > 100_000:
        return torch.zeros((1, d), dtype=dtype).expand(n, d)
    return torch.zeros(n * d + offset, dtype=dtype)[offset:].view(n, d)


ROUTE_CASES = {
    # the eval's search: f16 transfer, a 4096-row query tile, 1.28M refs
    "eval f16 D512": ((F16, 512, rows(4096, 512), rows(1_280_000, 512)), "mma"),
    "f16 D64": ((F16, 64, rows(70, 64), rows(300, 64)), "mma"),
    "f16 D40": ((F16, 40, rows(70, 40), rows(2100, 40)), "mma"),
    # the searcher's default transfer type
    "f32 D512": ((F32, 512, rows(4096, 512, F32), rows(3000, 512, F32)), "ffma"),
    "f16 D511": ((F16, 511, rows(4096, 511), rows(3000, 511)), "ffma"),
    "f16 D12": ((F16, 12, rows(5, 12), rows(30, 12)), "ffma"),
    "queries off 16 bytes": ((F16, 64, rows(50, 64, offset=1), rows(700, 64)), "ffma"),
    "refs off 16 bytes": ((F16, 64, rows(50, 64), rows(700, 64, offset=1)), "ffma"),
}


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_topk_route(case):
    args, want = ROUTE_CASES[case]
    assert topk_route(*args) == want


@pytest.mark.parametrize("nq,nr", [(27, 2000), (1, 100_000), (1, 5), (3, 1), (130, 600),
                                   (32_000, 128_000), (320_000, 128_000), (33_792, 7)])
def test_row_max_grid(nq, nr):
    tiles, splits = row_max_grid(nq, nr)
    assert tiles == -(-nq // 128)
    assert 1 <= splits <= nr
    # at least two blocks per SM wherever the refs allow it, and no more
    # splits than that takes
    assert tiles * splits >= min(MIN_BLOCKS, tiles * nr)
    assert splits == 1 or tiles * (splits - 1) < MIN_BLOCKS
    # every split (refs s * nr // splits .. (s + 1) * nr // splits) is non-empty
    bounds = [s * nr // splits for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == nr and min(np.diff(bounds)) >= 1
    if (nq, nr) == (27, 2000):
        assert tiles * splits >= 264


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def padded_f16(x):
    """x rounded to f16 with zero columns up to padded_width: the copy the
    kernel's first pass writes."""
    out = torch.zeros((x.shape[0], padded_width(x.shape[1])), dtype=F16)
    out[:, : x.shape[1]] = x
    return out


@pytest.mark.parametrize("d,width", [(511, 512), (512, 512), (15, 16), (1, 16), (17, 32)])
def test_padded_width(d, width):
    assert padded_width(d) == width


@pytest.mark.parametrize("nq,nr,d", [(27, 200, 511), (37, 203, 15), (5, 64, 512), (9, 33, 1)])
def test_row_max_padding_is_exact(nq, nr, d):
    rng = np.random.default_rng(nq + d)
    q, r = unit_rows(rng, nq, d), unit_rows(rng, nr, d)
    tq, tr = torch.from_numpy(q), torch.from_numpy(r)
    got = row_max_gemm_reference(padded_f16(tq), padded_f16(tr))
    want = row_max_gemm_reference(tq, tr)
    assert torch.equal(got, want)
    assert torch.equal(row_max_gemm(tq, tr), want)  # the wrapper on the CPU
    jax_want = jax_row_max_gemm(q, r, tile_q=64, tile_r=64)
    np.testing.assert_allclose(got.numpy(), jax_want, atol=1e-6, rtol=0)
