"""Which GEMM loop each product of K1 and B9 (`attn_proj.routes`), K2
(`mlp.routes`), B7 (`mlp.fused_mlp_routes`) and B10 (`vit_block.routes`)
takes, by the shared rule `ops/gemm.gemm_route` that mirrors `gemm_is_mma`
and `gemm_is_tf32x3` in `csrc/gemm_nt.cuh` (B1's `swin_block.routes` reads
the same rule), and the shared memory of a block of each tensor-core loop
against the header's constants; and K2's LN rows, which the tensor-core path writes
to a scratch before fc1, against the LN inside the JAX oracle
`_xla_ln_mlp`. The kernels run only on the card; these checks run
anywhere."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vsc22_tpu.ops import pallas_mlp
from vsc22_tpu_torch.ops import attn_proj, mlp, swin_block, vit_block
from vsc22_tpu_torch.ops.gemm import GEMM_MMA_SMEM, GEMM_TF32X3_SMEM, gemm_route

BF16, F32 = torch.bfloat16, torch.float32


def zeros(shape, dtype=BF16, offset=0):
    """A zero tensor of `shape`, `offset` elements into its buffer (an
    offset of 1 puts a bf16 tensor off 16 bytes)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def k2_case(c, hidden, dtype=BF16, w1_offset=0, w2_offset=0):
    x = zeros((6, c), dtype)
    return mlp.routes(x, zeros((hidden, c), dtype, w1_offset), zeros((c, hidden), dtype, w2_offset))


def b7_case(c, hidden, dtype, x_offset=0, w1_offset=0, w2_offset=0):
    return mlp.fused_mlp_routes(zeros((6, c), dtype, x_offset),
                                zeros((hidden, c), dtype, w1_offset),
                                zeros((c, hidden), dtype, w2_offset))


def k1_case(c, heads, dtype=BF16, offset=0):
    return attn_proj.routes(zeros((2, 5, c), dtype), zeros((c, c), dtype, offset), heads)


def b1_case(c, heads, dtype=BF16):
    f = 4 * c
    ws = [zeros(s, dtype) for s in ((3 * c, c), (c, c), (f, c), (c, f))]
    return swin_block.routes(zeros((2, 64, c), dtype), *ws, heads)


def b9_case(c, heads, dtype=BF16, proj_offset=0):
    return attn_proj.routes(zeros((2, 5, c), dtype), zeros((c, c), dtype, proj_offset), heads,
                            half_block=True)


def b10_case(c, heads, dtype=BF16, fc1_offset=0, fc2_offset=0):
    f = 4 * c
    return vit_block.routes(zeros((2, 5, c), dtype), zeros((f, c), dtype, fc1_offset),
                            zeros((c, f), dtype, fc2_offset), heads)


# bf16 B9 and B10: each LN written by the LN-rows kernel first; fc1, fc2 and
# B9's proj (K1's) on the tensor-core loop by the rule; QKV and B10's proj
# in the plain version's order of summation on the 128x128 FFMA tile, whose
# moves to the loop broke the 2% bf16 bar (PERF.md), whatever the
# operands.
B9_BF16 = dict(core="mma", ln="rows", qkv="ffma128", proj="mma")
B10_BF16 = dict(ln1="rows", qkv="ffma128", core="mma", proj="ffma128", ln2="rows", fc1="mma",
                fc2="mma")
B10_F32 = dict(ln1="prologue", qkv="ffma", core="ffma", proj="ffma", ln2="prologue",
               fc1="ffma", fc2="ffma")

MMA = dict(ln="rows", fc1="mma", fc2="mma")
FFMA = dict(ln="prologue", fc1="ffma", fc2="ffma")

ROUTE_CASES = {
    # K2 at the CLIP and ViT-B/32 widths, bf16: both products on tensor cores.
    "k2 clip bf16": (lambda: k2_case(1024, 4096), MMA),
    "k2 vit bf16": (lambda: k2_case(768, 3072), MMA),
    "k2 clip f32": (lambda: k2_case(1024, 4096, F32), FFMA),
    # C 100: fc1's K is no whole number of 16-byte rows; fc2's K (400) is.
    "k2 C 100": (lambda: k2_case(100, 400), dict(ln="prologue", fc1="ffma", fc2="mma")),
    # hidden 70: fc2's K is off the rule, fc1's (C 64) on it.
    "k2 hidden 70": (lambda: k2_case(64, 70), dict(ln="rows", fc1="mma", fc2="ffma")),
    "k2 w1 off 16 bytes": (lambda: k2_case(64, 256, w1_offset=1),
                           dict(ln="prologue", fc1="ffma", fc2="mma")),
    "k2 w2 off 16 bytes": (lambda: k2_case(64, 256, w2_offset=1),
                           dict(ln="rows", fc1="mma", fc2="ffma")),
    # B7: bf16 on the tensor-core loop (K % 8 == 0), f32 on 3xTF32 (K % 4
    # == 0), both with 16-byte-aligned operands; x is fc1's own operand.
    "b7 C 128 bf16": (lambda: b7_case(128, 512, BF16), dict(fc1="mma", fc2="mma")),
    "b7 C 128 f32": (lambda: b7_case(128, 512, F32), dict(fc1="tf32x3", fc2="tf32x3")),
    # C 36, hidden 132: whole 16-byte f32 rows, not whole 16-byte bf16 rows.
    "b7 C 36 bf16": (lambda: b7_case(36, 132, BF16), dict(fc1="ffma", fc2="ffma")),
    "b7 C 36 f32": (lambda: b7_case(36, 132, F32), dict(fc1="tf32x3", fc2="tf32x3")),
    # C 100, hidden 70: fc1's K 100 holds f32's rule only, fc2's K 70 neither.
    "b7 C 100 hidden 70 bf16": (lambda: b7_case(100, 70, BF16), dict(fc1="ffma", fc2="ffma")),
    "b7 C 100 hidden 70 f32": (lambda: b7_case(100, 70, F32), dict(fc1="tf32x3", fc2="ffma")),
    # C 30: fc1 off both rules, fc2's K 128 on them.
    "b7 C 30 bf16": (lambda: b7_case(30, 128, BF16), dict(fc1="ffma", fc2="mma")),
    "b7 C 30 f32": (lambda: b7_case(30, 128, F32), dict(fc1="ffma", fc2="tf32x3")),
    "b7 x off 16 bytes bf16": (lambda: b7_case(64, 256, BF16, x_offset=1),
                               dict(fc1="ffma", fc2="mma")),
    "b7 x off 16 bytes f32": (lambda: b7_case(64, 256, F32, x_offset=1),
                              dict(fc1="ffma", fc2="tf32x3")),
    "b7 w1 off 16 bytes f32": (lambda: b7_case(64, 256, F32, w1_offset=2),
                               dict(fc1="ffma", fc2="tf32x3")),
    "b7 w2 off 16 bytes f32": (lambda: b7_case(64, 256, F32, w2_offset=3),
                               dict(fc1="tf32x3", fc2="ffma")),
    "b7 w2 off 16 bytes bf16": (lambda: b7_case(64, 256, BF16, w2_offset=4),
                                dict(fc1="mma", fc2="ffma")),
    "k1 clip bf16": (lambda: k1_case(1024, 16), dict(core="mma", proj="mma")),
    "k1 vit bf16": (lambda: k1_case(768, 12), dict(core="mma", proj="mma")),
    "k1 clip f32": (lambda: k1_case(1024, 16, F32), dict(core="ffma", proj="ffma")),
    # C 100, 4 heads: hd 25 takes the FFMA core, K 100 the FFMA tile.
    "k1 C 100": (lambda: k1_case(100, 4), dict(core="ffma", proj="ffma")),
    "k1 proj_w off 16 bytes": (lambda: k1_case(64, 4, offset=1), dict(core="mma", proj="ffma")),
    # B1 reads the same rule for proj, fc1 and fc2, as before it moved.
    "b1 bf16": (lambda: b1_case(128, 4),
                dict(core="mma", qkv="ffma128", proj="mma", fc1="mma", fc2="mma")),
    "b1 f32": (lambda: b1_case(128, 4, F32),
               dict(core="mma", qkv="ffma", proj="ffma", fc1="ffma", fc2="ffma")),
    "b1 C 36": (lambda: b1_case(36, 2),
                dict(core="ffma", qkv="ffma128", proj="ffma", fc1="ffma", fc2="mma")),
    "b9 clip bf16": (lambda: b9_case(1024, 16), B9_BF16),
    "b9 vit bf16": (lambda: b9_case(768, 12), B9_BF16),
    "b9 clip f32": (lambda: b9_case(1024, 16, F32),
                    dict(core="ffma", ln="prologue", qkv="ffma", proj="ffma")),
    # C 100: K % 8 != 0 (and hd 25 takes the FFMA core); QKV is in order
    # on the 128x128 tile all the same, the projection off the rule.
    "b9 C 100": (lambda: b9_case(100, 4), dict(B9_BF16, core="ffma", proj="ffma")),
    "b9 proj_w off 16 bytes": (lambda: b9_case(64, 4, proj_offset=1),
                               dict(B9_BF16, proj="ffma")),
    "b10 clip bf16": (lambda: b10_case(1024, 16), B10_BF16),
    "b10 vit bf16": (lambda: b10_case(768, 12), B10_BF16),
    "b10 clip f32": (lambda: b10_case(1024, 16, F32), B10_F32),
    # hd 32 (the folded scale is no power of two): the same loops.
    "b10 hd 32 bf16": (lambda: b10_case(96, 3), B10_BF16),
    # C 100: fc1's K off the rule (LN2 back in the FFMA prologue), fc2's
    # K (400) on it.
    "b10 C 100": (lambda: b10_case(100, 4),
                  dict(B10_BF16, core="ffma", ln2="prologue", fc1="ffma")),
    "b10 fc1_w off 16 bytes": (lambda: b10_case(64, 4, fc1_offset=1),
                               dict(B10_BF16, ln2="prologue", fc1="ffma")),
    "b10 fc2_w off 16 bytes": (lambda: b10_case(64, 4, fc2_offset=1),
                               dict(B10_BF16, fc2="ffma")),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_routes(case):
    routes, want = ROUTE_CASES[case]
    assert routes() == want


def test_the_rule_is_one_function():
    """B1, K1 and K2 read the one `gemm_route`, not copies of it (B9 and
    B10 through K1's and K2's routes)."""
    assert swin_block.gemm_route is gemm_route
    assert mlp.gemm_route is gemm_route and attn_proj.gemm_route is gemm_route
    assert vit_block.mlp_routes is mlp.routes


@pytest.mark.parametrize("k", [4, 36, 1024, 4096])
def test_only_b7_takes_tf32x3(k):
    """3xTF32 is B7's alone: without `tf32x3` an f32 product keeps the FFMA
    tile whatever its K (K1's, K2's, B1's, B9's and B10's f32 sums do not
    move), and the flag changes no bf16 route."""
    w = zeros((8, k), F32)
    assert gemm_route(F32, k, w) == "ffma"
    assert gemm_route(F32, k, w, tf32x3=True) == "tf32x3"
    wb = zeros((8, k), BF16)
    assert gemm_route(BF16, k, wb, tf32x3=True) == gemm_route(BF16, k, wb)


def header_constants(prefix: str) -> dict:
    """The `constexpr int <prefix>...` values of csrc/gemm_nt.cuh, with
    their `+ n` offsets resolved."""
    src = (Path(mlp.__file__).parent.parent / "csrc" / "gemm_nt.cuh").read_text()
    vals = {}
    for name, expr in re.findall(rf"constexpr int ({prefix}\w+) = ([^;]+);", src):
        vals[name] = eval(expr, {}, dict(vals))
    return vals


def test_block_smem_matches_the_header():
    """The mirrors' shared memory per block: stages x (BM + BN) rows x the
    pitch x the element size (the 3xTF32 tile stages W's big and small
    slices and A's), as the header's constants give it, and within the
    232,448 bytes a block can have."""
    mma = header_constants("kMma")
    assert GEMM_MMA_SMEM == mma["kMmaStages"] * (mma["kMmaBM"] + mma["kMmaBN"]) \
        * mma["kMmaPitch"] * 2
    x3 = header_constants("kX3")
    assert GEMM_TF32X3_SMEM == x3["kX3Stages"] * (2 * x3["kX3BN"] * x3["kX3BK"]
                                                  + x3["kX3BM"] * x3["kX3Pitch"]) * 4 + 1024
    assert x3["kX3Pitch"] % 4 == 0 and (x3["kX3Pitch"] // 4) % 2 == 1  # 16-byte rows, odd
    assert GEMM_TF32X3_SMEM <= 232_448


def jax_ln(x, ln_s, ln_b, eps):
    """The LN rows `_xla_ln_mlp` computes, in x's dtype: its first product's
    left operand, read by a spy on the module's `jnp.dot`."""
    seen = []

    class Spy:
        def __getattr__(self, name):
            return getattr(jnp, name)

        def dot(self, a, *args, **kwargs):
            seen.append(a)
            return jnp.dot(a, *args, **kwargs)

    real = pallas_mlp.jnp
    pallas_mlp.jnp = Spy()
    try:
        c = x.shape[1]
        w1 = jnp.zeros((c, 8), x.dtype)
        w2 = jnp.zeros((8, c), x.dtype)
        pallas_mlp._xla_ln_mlp(x, ln_s, ln_b, w1, jnp.zeros(8), w2, jnp.zeros(c), "gelu", eps)
    finally:
        pallas_mlp.jnp = real
    return np.array(seen[0].astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,c,eps", [(64, 128, 1e-5), (37, 48, 1e-6), (5, 200, 1e-5)])
def test_ln_rows_match_the_jax_oracle_ln(dtype, rows, c, eps):
    """`layernorm_rows` on the CPU (`ln_rows` rounded to the dtype, the
    plain version of the LN-rows kernel) against `_xla_ln_mlp`'s LN. bf16:
    chip_smoke's bar (2^-7 + 2 ulps, at most 2% of the elements differing;
    the f32 means differ by order only); f32: 1e-5."""
    rng = np.random.default_rng(rows + c)
    x = (rng.standard_normal((rows, c)) + 0.3).astype(np.float32)
    ln_s = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    ln_b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = mlp.layernorm_rows(torch.from_numpy(x).to(tdt), torch.from_numpy(ln_s),
                             torch.from_numpy(ln_b), eps)
    assert got.dtype == tdt
    want = jax_ln(jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(ln_s),
                  jnp.asarray(ln_b), eps)
    want = torch.from_numpy(want).to(tdt)
    ok, err, share, words = chip_smoke.agreement(got, want, (1e-5, 0.0))
    assert ok, (err, words)
