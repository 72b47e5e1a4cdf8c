"""SwinV2 cosine window attention (kernel B6).

    out = softmax(q̂ k̂^T * scale[h] + rpb[h] + mask[w % nW]) v

per (window w, head h), with q̂ and k̂ the rows of q and k L2-normalised in
f32. Counterpart of `vsc22_tpu/ops/pallas_window_attn.py`
`window_attention_fused` (its `_fused_call`); the CUDA kernel is
`csrc/window_attn.cu`, whose attention core `csrc/window_attn.cuh` the
whole-block kernel B1 shares. The SwinV2 module path calls it.

q, k, v and out are [W, H, N, hd] in the working dtype (float32 or
bfloat16), W = batch * nW windows, window-major per item. rpb [H, N, N]
(16 * sigmoid(CPB)), scale [H] (exp(min(logit_scale, ln 100))) and mask
[nW, N, N] are float32. Rounding as the Pallas kernel: q̂ and k̂ stay f32,
the probabilities are rounded to v's dtype, the output to q's.
"""

from __future__ import annotations

import torch

from vsc22_tpu_torch.kernels import build

_ARGTYPES = [build.PTR] * 7 + [build.INT] * 6 + [build.PTR]


def window_attention_reference(q, k, v, rpb, scale, mask, num_shift_windows: int):
    """Plain PyTorch version: the JAX `window_attention_reference`."""
    w = q.shape[0]
    qf, kf = q.float(), k.float()
    qf = qf * torch.rsqrt((qf * qf).sum(-1, keepdim=True) + 1e-12)
    kf = kf * torch.rsqrt((kf * kf).sum(-1, keepdim=True) + 1e-12)
    attn = torch.einsum("whnd,whmd->whnm", qf, kf)
    attn = attn * scale.float().reshape(1, -1, 1, 1)
    attn = attn + rpb.float()[None]
    idx = torch.arange(w, device=q.device) % num_shift_windows
    attn = attn + mask.float()[idx][:, None]
    probs = torch.softmax(attn, dim=-1).to(v.dtype).float()
    return torch.einsum("whnm,whmd->whnd", probs, v.float()).to(q.dtype)


def window_attention(q, k, v, rpb, scale, mask, num_shift_windows: int):
    """B6 on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, rpb, scale, mask, num_shift_windows)
    device = build.require_cuda(q)
    code = build.working_dtype(q)
    w, h, n, hd = q.shape
    nw = num_shift_windows
    if nw < 1 or w % nw:
        raise ValueError(f"{w} windows are not a whole number of {nw}-window items")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(name, t, device, q.dtype, (w, h, n, hd))
    build.check_cuda("rpb", rpb, device, torch.float32, (h, n, n))
    build.check_cuda("scale", scale, device, torch.float32, (h,))
    build.check_cuda("mask", mask, device, torch.float32, (nw, n, n))
    out = torch.empty_like(q)
    build.call(
        "window_attn", "vsc22_window_attention", _ARGTYPES,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rpb.data_ptr(), scale.data_ptr(),
        mask.data_ptr(), out.data_ptr(), w, h, n, hd, nw, code, build.stream_ptr(device),
    )
    window_attention.launches += 1
    return out


window_attention.launches = 0
