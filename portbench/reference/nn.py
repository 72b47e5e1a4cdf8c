"""Plain PyTorch building blocks of the reference models.

Every product goes through a `Numerics`: "f32" computes in float32 with
TF32 off (the reference), "fp8" rounds both operands of each product to
float8 e4m3 with a per-tensor scale first (the control: the next precision
below the bfloat16 that the configurations state). Sums, norms and
softmaxes stay float32 in both. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3


class Numerics:
    """How the reference computes its products; see the module docstring."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """An operand as the products read it: itself in f32; in fp8 rounded
        to e4m3 at a per-tensor scale (absmax to 448), the gradient passed
        straight through."""
        t = t.float()
        if self.mode == "f32":
            return t
        scale = FP8_MAX / t.detach().abs().amax().clamp(min=1e-30)
        rounded = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (rounded - t).detach()

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


@contextlib.contextmanager
def exact_f32():
    """float32 products in full float32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps)


def gelu(x):
    return F.gelu(x)  # exact (erf)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def gem(x, p: float, eps: float = 1e-6):
    """Generalized mean over the token axis (1) of [B, L, C]."""
    return x.clamp(min=eps).pow(p).mean(dim=1).pow(1.0 / p)


def l2n(x, eps: float = 1e-12):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def patch_embed(nx: Numerics, images, w, b, patch: int):
    """Non-overlapping patches of NHWC images through an OIHW weight
    [C, 3, p, p], patch pixels in (row, col, channel) order."""
    n, h, wd, c = images.shape
    x = images.reshape(n, h // patch, patch, wd // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, (h // patch) * (wd // patch), patch * patch * c)
    wt = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
    return nx.linear(x, wt, b)


def attention(nx: Numerics, x, qkv_w, qkv_b, proj_w, proj_b, heads: int, bias=None):
    """Multi-head self-attention of [B, L, C]: softmax(q k^T / sqrt(hd) +
    bias) v, then the projection."""
    n, l, c = x.shape
    hd = c // heads
    qkv = nx.linear(x, qkv_w, qkv_b).reshape(n, l, 3, heads, hd)
    q, k, v = qkv.unbind(2)
    logits = nx.einsum("blhd,bmhd->bhlm", q, k) * hd ** -0.5
    if bias is not None:
        logits = logits + bias
    out = nx.einsum("bhlm,bmhd->blhd", torch.softmax(logits, dim=-1), v)
    return nx.linear(out.reshape(n, l, c), proj_w, proj_b)
