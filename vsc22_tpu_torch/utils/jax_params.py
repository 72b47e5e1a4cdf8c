"""Carry JAX param trees into the port's modules.

The JAX package's variables (`model.init(...)`, or
`flax.serialization.to_state_dict`, fetched to the host as numpy) map onto
`VitDescriptor`, `SwinTransformerV2`, `CLIPVisual`, `VideoScoreModel`,
a lone `MultiHeadAttention`, and the matching track's CNNs
(`MobileNetV3Small`, `SAMHRNet`, from their `{params, batch_stats}`
trees): Dense kernels [in, out] are transposed to Linear [out, in], HWIO
convs become OIHW (a depthwise [k, k, 1, C] becomes [C, 1, k, k]), BN
scale and bias come from `params` and its running mean and variance from
`batch_stats`, and every array is copied into the existing parameter
(which casts it to that parameter's dtype and device). A shape that does
not fit raises. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from vsc22_tpu_torch.models.clip import CLIPVisual
from vsc22_tpu_torch.models.hrnet import SAMHRNet
from vsc22_tpu_torch.models.layers import LayerNorm, Linear, MultiHeadAttention, PatchEmbed
from vsc22_tpu_torch.models.mobilenetv3 import MobileNetV3Small
from vsc22_tpu_torch.models.swinv2 import SwinTransformerV2
from vsc22_tpu_torch.models.vit import VitDescriptor
from vsc22_tpu_torch.models.vsm import VideoScoreModel


def _copy(dst: torch.Tensor, src) -> None:
    arr = torch.from_numpy(np.array(src, np.float32))
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(arr.shape)} does not fit parameter {tuple(dst.shape)}")
    dst.copy_(arr)


def _dense(mod: Linear, kernel, bias=None) -> None:
    _copy(mod.weight, np.asarray(kernel).T)
    if mod.bias is not None:
        _copy(mod.bias, bias)


def _dense_tree(mod: Linear, tree) -> None:
    if (mod.bias is None) != ("bias" not in tree):
        raise ValueError("a Dense bias on one side only")
    _dense(mod, tree["kernel"], tree.get("bias"))


def _ln(mod: LayerNorm, tree) -> None:
    _copy(mod.weight, tree["scale"])
    _copy(mod.bias, tree["bias"])


def _conv(mod: PatchEmbed, tree) -> None:
    _copy(mod.weight, np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
    if mod.bias is not None:
        _copy(mod.bias, tree["bias"])


def _attention(mod, tree) -> None:
    """The {qkv, proj} Dense trees of a JAX `MultiHeadAttention` or
    `AttentionParams` (qkv without a bias where `qkv_bias=False`)."""
    _dense_tree(mod.qkv, tree["qkv"])
    _dense_tree(mod.proj, tree["proj"])


def _params(variables) -> dict:
    return variables["params"] if "params" in variables else variables


@torch.no_grad()
def load_vit_descriptor(model: VitDescriptor, variables) -> VitDescriptor:
    p = _params(variables)
    bb = p["backbone"]
    vit = model.backbone
    _conv(vit.patch_embed, bb["patch_embed"])
    _copy(vit.cls_token, bb["cls_token"])
    _copy(vit.pos_embed, bb["pos_embed"])
    for i, block in enumerate(vit.blocks):
        t = bb[f"block{i}"]
        _ln(block.norm1, t["norm1"])
        _attention(block.attn, t["attn"])
        _ln(block.norm2, t["norm2"])
        _dense(block.mlp.fc1, t["mlp"]["fc1_kernel"], t["mlp"]["fc1_bias"])
        _dense(block.mlp.fc2, t["mlp"]["fc2_kernel"], t["mlp"]["fc2_bias"])
    _ln(vit.norm, bb["norm"])
    _dense(model.gem.proj, p["gem"]["proj"]["kernel"], p["gem"]["proj"]["bias"])
    _dense(model.head, p["head"]["kernel"], p["head"]["bias"])
    return model


@torch.no_grad()
def load_swinv2_descriptor(model: SwinTransformerV2, variables) -> SwinTransformerV2:
    """The JAX `SwinTransformerV2` tree (either block path: both declare
    it) into the port's model."""
    p = _params(variables)
    _conv(model.patch_embed, p["patch_embed"])
    _ln(model.patch_norm, p["patch_norm"])
    for s, blocks in enumerate(model.stages):
        for i, block in enumerate(blocks):
            t = p[f"stage{s}_block{i}"]
            a, ta = block.attn, t["attn"]
            _copy(a.logit_scale, ta["logit_scale"])
            _copy(a.qkv_weight, np.asarray(ta["qkv_kernel"]).T)
            _copy(a.q_bias, ta["q_bias"])
            _copy(a.v_bias, ta["v_bias"])
            _dense_tree(a.cpb_fc1, ta["cpb_fc1"])
            _dense_tree(a.cpb_fc2, ta["cpb_fc2"])
            _dense_tree(a.proj, ta["proj"])
            _ln(block.norm1, t["norm1"])
            _dense(block.mlp.fc1, t["mlp"]["fc1_kernel"], t["mlp"]["fc1_bias"])
            _dense(block.mlp.fc2, t["mlp"]["fc2_kernel"], t["mlp"]["fc2_bias"])
            _ln(block.norm2, t["norm2"])
    for s, merge in enumerate(model.merges):
        _dense_tree(merge.reduction, p[f"merge{s}"]["reduction"])
        _ln(merge.norm, p[f"merge{s}"]["norm"])
    _ln(model.norm, p["norm"])
    _dense_tree(model.output_proj, p["output_proj"])
    return model


@torch.no_grad()
def load_clip_visual(model: CLIPVisual, variables) -> CLIPVisual:
    p = _params(variables)
    _conv(model.conv1, p["conv1"])
    _copy(model.class_embedding, p["class_embedding"])
    _copy(model.positional_embedding, p["positional_embedding"])
    _ln(model.ln_pre, p["ln_pre"])
    for i, block in enumerate(model.blocks):
        t = p[f"block{i}"]
        _ln(block.ln_1, t["ln_1"])
        _attention(block.attn, t["attn"])
        _ln(block.ln_2, t["ln_2"])
        _dense(block.c_fc, t["c_fc"]["kernel"], t["c_fc"]["bias"])
        _dense(block.c_proj, t["c_proj"]["kernel"], t["c_proj"]["bias"])
    _ln(model.ln_post, p["ln_post"])
    return model


@torch.no_grad()
def load_video_score_model(model: VideoScoreModel, variables) -> VideoScoreModel:
    p = _params(variables)
    _dense(model.frame_proj, p["frame_proj"]["kernel"], p["frame_proj"]["bias"])
    _ln(model.frame_norm, p["frame_norm"])
    _copy(model.cls_emb, p["cls_emb"])
    _copy(model.sep_emb, p["sep_emb"])
    _copy(model.pos_embed, p["pos_embed"])
    _ln(model.emb_norm, p["emb_norm"])
    for i, layer in enumerate(model.layers):
        t = p[f"layer{i}"]
        _attention(layer.attn, t["attn"])
        _ln(layer.ln_attn, t["ln_attn"])
        _dense(layer.fc1, t["fc1"]["kernel"], t["fc1"]["bias"])
        _dense(layer.fc2, t["fc2"]["kernel"], t["fc2"]["bias"])
        _ln(layer.ln_mlp, t["ln_mlp"])
    _dense(model.output_proj, p["output_proj"]["kernel"], p["output_proj"]["bias"])
    return model


@torch.no_grad()
def load_multi_head_attention(model: MultiHeadAttention, variables) -> MultiHeadAttention:
    """A JAX `MultiHeadAttention` tree, with or without its qkv bias."""
    _attention(model, _params(variables))
    return model


def _conv_bn(mod, params, stats) -> None:
    """A JAX `ConvBNAct` / `ConvBN` ({Conv_0, BatchNorm_0}) into the port's."""
    _copy(mod.conv.weight, np.asarray(params["Conv_0"]["kernel"]).transpose(3, 2, 0, 1))
    bn, p, s = mod.bn, params["BatchNorm_0"], stats["BatchNorm_0"]
    _copy(bn.weight, p["scale"])
    _copy(bn.bias, p["bias"])
    _copy(bn.mean, s["mean"])
    _copy(bn.var, s["var"])


def _cnn_trees(variables):
    if "batch_stats" not in variables:
        raise ValueError("a BatchNorm CNN needs its batch_stats collection")
    return variables["params"], variables["batch_stats"]


@torch.no_grad()
def load_mobilenetv3(model: MobileNetV3Small, variables) -> MobileNetV3Small:
    p, s = _cnn_trees(variables)
    _conv_bn(model.stem, p["stem"], s["stem"])
    for i, block in enumerate(model.blocks):
        bp, bs = p[f"block{i}"], s[f"block{i}"]
        if (block.expand is None) != ("expand" not in bp) or (block.se is None) != ("se" not in bp):
            raise ValueError(f"block{i}: the expand or SE layers differ")
        for name in ("expand", "dw", "project"):
            if getattr(block, name) is not None:
                _conv_bn(getattr(block, name), bp[name], bs[name])
        if block.se is not None:
            _dense_tree(block.se.fc1, bp["se"]["fc1"])
            _dense_tree(block.se.fc2, bp["se"]["fc2"])
    _conv_bn(model.head_conv, p["head_conv"], s["head_conv"])
    _dense_tree(model.pre_logits, p["pre_logits"])
    _dense_tree(model.classifier, p["classifier"])
    return model


def _hr_module(mod, p, s) -> None:
    for i, blocks in enumerate(mod.branches):
        for b, block in enumerate(blocks):
            t = f"branch{i}_block{b}"
            _conv_bn(block.conv1, p[t]["conv1"], s[t]["conv1"])
            _conv_bn(block.conv2, p[t]["conv2"], s[t]["conv2"])
    for key, f in mod.fuse.items():
        if isinstance(f, torch.nn.ModuleList):
            for k, step in enumerate(f):
                _conv_bn(step, p[f"fuse{key}_step{k}"], s[f"fuse{key}_step{k}"])
        else:
            _conv_bn(f, p[f"fuse{key}"], s[f"fuse{key}"])


@torch.no_grad()
def load_sam_hrnet(model: SAMHRNet, variables) -> SAMHRNet:
    """The JAX `SAMHRNet` tree (either `s2d_branch0` setting: both declare
    it) into the port's model."""
    p, s = _cnn_trees(variables)
    bp, bs = p["backbone"], s["backbone"]
    bb = model.backbone
    for name in ("stem1", "stem2", "trans2", "trans3"):
        _conv_bn(getattr(bb, name), bp[name], bs[name])
    for b, block in enumerate(bb.layer1):
        t = f"layer1_{b}"
        for name in ("conv1", "conv2", "conv3", "downsample"):
            if getattr(block, name) is not None:
                _conv_bn(getattr(block, name), bp[t][name], bs[t][name])
    for i, t in enumerate(bb.trans1):
        _conv_bn(t, bp[f"trans1_{i}"], bs[f"trans1_{i}"])
    for stage in ("stage2", "stage3", "stage4"):
        for m, mod in enumerate(getattr(bb, stage)):
            _hr_module(mod, bp[f"{stage}_m{m}"], bs[f"{stage}_m{m}"])
    _copy(model.fuse1_weight, np.asarray(p["fuse1"]["kernel"])[0, 0])
    _copy(model.fuse1_bias, p["fuse1"]["bias"])
    _copy(model.fuse2_weight, np.asarray(p["fuse2"]["kernel"])[0, 0].T)
    _copy(model.fuse2_bias, p["fuse2"]["bias"])
    return model
