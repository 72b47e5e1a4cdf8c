"""Carry JAX param trees into the port's modules.

The JAX package's variables (`model.init(...)`, or
`flax.serialization.to_state_dict`, fetched to the host as numpy) map onto
`VitDescriptor`, `SwinTransformerV2`, `CLIPVisual`, `VideoScoreModel`,
a lone `MultiHeadAttention`, the matching track's CNNs
(`MobileNetV3Small`, `SAMHRNet`, from their `{params, batch_stats}`
trees), the legacy zoo (`SwinTransformerV1`, `EfficientNet` and
`DeConvModel` with their `batch_stats`, `MaeDescriptor`, `TextEncoder`)
and BYOL's online and target dicts (`ByolNet`): Dense kernels [in, out]
are transposed to Linear [out, in], HWIO convs become OIHW (a depthwise
[k, k, 1, C] becomes [C, 1, k, k]), a ConvTranspose kernel is flipped in
space into [in, out, k, k], BN scale and bias come from `params` and its
running mean and variance from `batch_stats`, and every array is copied
into the existing parameter (which casts it to that parameter's dtype and
device). A shape that does not fit raises. Nothing here imports JAX.

The other direction, for every model with a key table (`model_entries`):
`jax_flat_params` writes a port model's tensors (or its EMA) under the
flat `/`-joined keys and in the layouts of the JAX package's
`save_ema_snapshot` and `save_cnn_snapshot`, so that a port snapshot loads
into the JAX model and a JAX snapshot into the port's
(`train/checkpoint.py`)."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from vsc22_tpu_torch.models.clip import CLIPVisual
from vsc22_tpu_torch.models.deconv import DeConvModel
from vsc22_tpu_torch.models.efficientnet import EfficientNet
from vsc22_tpu_torch.models.hrnet import SAMHRNet
from vsc22_tpu_torch.models.layers import LayerNorm, Linear, MultiHeadAttention, PatchEmbed
from vsc22_tpu_torch.models.mae import MaeDescriptor
from vsc22_tpu_torch.models.mobilenetv3 import MobileNetV3Small
from vsc22_tpu_torch.models.swin_v1 import SwinTransformerV1
from vsc22_tpu_torch.models.swinv2 import SwinTransformerV2
from vsc22_tpu_torch.models.text_encoder import TextEncoder
from vsc22_tpu_torch.models.vit import VisionTransformer, VitDescriptor
from vsc22_tpu_torch.models.vsm import VideoScoreModel
from vsc22_tpu_torch.train.byol import ByolNet


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


# --- both directions from one table ------------------------------------------
#
# For the ViT and SwinV2 descriptors, CLIP, the VSM and the matching CNNs, an
# entry list names every JAX leaf: (its key path from the collection down,
# the port tensor it fills, the layout between them). `load_*` fills the
# model from a tree; `jax_flat_params` writes the flat `/`-joined keys of
# the JAX package's `save_ema_snapshot` and `save_cnn_snapshot`.

_TO_PORT = {
    "id": lambda a: a,
    "T": lambda a: a.T,  # Dense kernel [in, out] <-> Linear [out, in]
    "conv": lambda a: a.transpose(3, 2, 0, 1),  # HWIO <-> OIHW
    "k00": lambda a: a[0, 0],  # a 1x1 conv kernel [1, 1, in, out] <-> [in, out]
    "k00T": lambda a: a[0, 0].T,  # ... <-> [out, in]
    # A flax ConvTranspose kernel HWIO <-> torch's conv_transpose2d weight
    # [in, out, k, k], flipped in space (`layers.ConvTranspose`).
    "convT": lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
}
_TO_JAX = {
    "id": lambda a: a,
    "T": lambda a: a.T,
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "k00": lambda a: a[None, None],
    "k00T": lambda a: a.T[None, None],
    "convT": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
}


def _e_dense(key, mod: Linear):
    out = [(key + ("kernel",), mod.weight, "T")]
    if mod.bias is not None:
        out.append((key + ("bias",), mod.bias, "id"))
    return out


def _e_ln(key, mod: LayerNorm):
    return [(key + ("scale",), mod.weight, "id"), (key + ("bias",), mod.bias, "id")]


def _e_conv(key, mod):
    out = [(key + ("kernel",), mod.weight, "conv")]
    if getattr(mod, "bias", None) is not None:
        out.append((key + ("bias",), mod.bias, "id"))
    return out


def _e_mlp(key, mlp):
    return [(key + ("fc1_kernel",), mlp.fc1.weight, "T"), (key + ("fc1_bias",), mlp.fc1.bias, "id"),
            (key + ("fc2_kernel",), mlp.fc2.weight, "T"), (key + ("fc2_bias",), mlp.fc2.bias, "id")]


def vit_entries(model: VitDescriptor) -> list:
    out = vit_backbone_entries(model.backbone, ("params", "backbone"))
    out += _e_dense(("params", "gem", "proj"), model.gem.proj)
    return out + _e_dense(("params", "head"), model.head)


def vit_backbone_entries(vit: VisionTransformer, bb=("params",)) -> list:
    """A JAX `VisionTransformer` tree under `bb` (bare: its params; in a
    `VitDescriptor`: its `backbone`)."""
    out = _e_conv(bb + ("patch_embed",), vit.patch_embed)
    out += [(bb + ("cls_token",), vit.cls_token, "id"), (bb + ("pos_embed",), vit.pos_embed, "id")]
    for i, block in enumerate(vit.blocks):
        t = bb + (f"block{i}",)
        out += _e_ln(t + ("norm1",), block.norm1)
        out += _e_dense(t + ("attn", "qkv"), block.attn.qkv)
        out += _e_dense(t + ("attn", "proj"), block.attn.proj)
        out += _e_ln(t + ("norm2",), block.norm2)
        out += _e_mlp(t + ("mlp",), block.mlp)
    return out + _e_ln(bb + ("norm",), vit.norm)


def swinv2_entries(model: SwinTransformerV2) -> list:
    """The JAX `SwinTransformerV2` tree (either block path: both declare it)."""
    p = ("params",)
    out = _e_conv(p + ("patch_embed",), model.patch_embed)
    out += _e_ln(p + ("patch_norm",), model.patch_norm)
    for s, blocks in enumerate(model.stages):
        for i, block in enumerate(blocks):
            t = p + (f"stage{s}_block{i}",)
            a, ta = block.attn, t + ("attn",)
            out += [(ta + ("logit_scale",), a.logit_scale, "id"),
                    (ta + ("qkv_kernel",), a.qkv_weight, "T"),
                    (ta + ("q_bias",), a.q_bias, "id"), (ta + ("v_bias",), a.v_bias, "id")]
            out += _e_dense(ta + ("cpb_fc1",), a.cpb_fc1) + _e_dense(ta + ("cpb_fc2",), a.cpb_fc2)
            out += _e_dense(ta + ("proj",), a.proj)
            out += _e_ln(t + ("norm1",), block.norm1) + _e_mlp(t + ("mlp",), block.mlp)
            out += _e_ln(t + ("norm2",), block.norm2)
    for s, merge in enumerate(model.merges):
        out += _e_dense(p + (f"merge{s}", "reduction"), merge.reduction)
        out += _e_ln(p + (f"merge{s}", "norm"), merge.norm)
    return out + _e_ln(p + ("norm",), model.norm) + _e_dense(p + ("output_proj",),
                                                            model.output_proj)


def clip_entries(model: CLIPVisual) -> list:
    """The JAX `CLIPVisual` tree (`load_clip_visual`'s keys)."""
    p = ("params",)
    out = _e_conv(p + ("conv1",), model.conv1)
    out += [(p + ("class_embedding",), model.class_embedding, "id"),
            (p + ("positional_embedding",), model.positional_embedding, "id")]
    out += _e_ln(p + ("ln_pre",), model.ln_pre)
    for i, block in enumerate(model.blocks):
        t = p + (f"block{i}",)
        out += _e_ln(t + ("ln_1",), block.ln_1)
        out += _e_dense(t + ("attn", "qkv"), block.attn.qkv)
        out += _e_dense(t + ("attn", "proj"), block.attn.proj)
        out += _e_ln(t + ("ln_2",), block.ln_2)
        out += _e_dense(t + ("c_fc",), block.c_fc) + _e_dense(t + ("c_proj",), block.c_proj)
    return out + _e_ln(p + ("ln_post",), model.ln_post)


def vsm_entries(model: VideoScoreModel) -> list:
    p = ("params",)
    out = _e_dense(p + ("frame_proj",), model.frame_proj) + _e_ln(p + ("frame_norm",),
                                                                  model.frame_norm)
    out += [(p + ("cls_emb",), model.cls_emb, "id"), (p + ("sep_emb",), model.sep_emb, "id"),
            (p + ("pos_embed",), model.pos_embed, "id")]
    out += _e_ln(p + ("emb_norm",), model.emb_norm)
    for i, layer in enumerate(model.layers):
        t = p + (f"layer{i}",)
        out += _e_dense(t + ("attn", "qkv"), layer.attn.qkv)
        out += _e_dense(t + ("attn", "proj"), layer.attn.proj)
        out += _e_ln(t + ("ln_attn",), layer.ln_attn)
        out += _e_dense(t + ("fc1",), layer.fc1) + _e_dense(t + ("fc2",), layer.fc2)
        out += _e_ln(t + ("ln_mlp",), layer.ln_mlp)
    return out + _e_dense(p + ("output_proj",), model.output_proj)


def npz_tree(path: str) -> dict:
    """An npz of flat `/`-joined keys (a JAX package snapshot) as the
    nested tree the loaders take."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _leaf(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def _flat_keys(tree, prefix=()) -> set:
    if not isinstance(tree, Mapping):
        return {prefix}
    return set().union(*(_flat_keys(v, prefix + (k,)) for k, v in tree.items())) \
        if tree else set()


@torch.no_grad()
def load_entries(entries, variables) -> None:
    """Fill each entry's tensor from `variables` (a {params[, batch_stats]}
    tree, the params alone, or a tree under the entries' own roots, such as
    BYOL's {backbone, heads}); a leaf on one side only raises."""
    want = {key for key, _, _ in entries}
    roots = {key[0] for key in want}
    tree = variables if "params" in variables or roots <= set(variables) \
        else {"params": variables}
    have = _flat_keys({k: tree[k] for k in roots})
    if want != have:
        raise ValueError(f"JAX leaves without a port tensor: {sorted(have - want)[:4]}; "
                         f"port tensors without a JAX leaf: {sorted(want - have)[:4]}")
    for key, dst, layout in entries:
        _copy(dst, _TO_PORT[layout](np.asarray(_leaf(tree, key))))


def jax_flat_params(entries, tensors=None) -> dict:
    """{"params/.../kernel": numpy array in the JAX layout} from an entry
    list: the flat keys and layouts the JAX package's `save_ema_snapshot`
    writes. `tensors`, where given, maps each entry's port tensor (by
    identity: `{id(param): value}`) to the value to write instead, such as
    an EMA."""
    out = {}
    for key, t, layout in entries:
        v = t if tensors is None else tensors.get(id(t), t)
        out["/".join(key)] = _TO_JAX[layout](v.detach().float().cpu().numpy())
    return out


@torch.no_grad()
def load_vit_descriptor(model: VitDescriptor, variables) -> VitDescriptor:
    load_entries(vit_entries(model), variables)
    return model


@torch.no_grad()
def load_swinv2_descriptor(model: SwinTransformerV2, variables) -> SwinTransformerV2:
    """The JAX `SwinTransformerV2` tree (either block path: both declare
    it) into the port's model."""
    load_entries(swinv2_entries(model), variables)
    return model


@torch.no_grad()
def load_clip_visual(model: CLIPVisual, variables) -> CLIPVisual:
    load_entries(clip_entries(model), variables)
    return model


@torch.no_grad()
def load_video_score_model(model: VideoScoreModel, variables) -> VideoScoreModel:
    load_entries(vsm_entries(model), variables)
    return model


@torch.no_grad()
def load_multi_head_attention(model: MultiHeadAttention, variables) -> MultiHeadAttention:
    """A JAX `MultiHeadAttention` tree, with or without its qkv bias."""
    _attention(model, _params(variables))
    return model


def _e_conv_bn(key, mod) -> list:
    """A JAX `ConvBNAct` / `ConvBN` ({Conv_0, BatchNorm_0}): the conv kernel
    and BN scale and bias in `params`, the running mean and variance in
    `batch_stats`."""
    p, s = ("params",) + key, ("batch_stats",) + key
    return [(p + ("Conv_0", "kernel"), mod.conv.weight, "conv"),
            (p + ("BatchNorm_0", "scale"), mod.bn.weight, "id"),
            (p + ("BatchNorm_0", "bias"), mod.bn.bias, "id"),
            (s + ("BatchNorm_0", "mean"), mod.bn.mean, "id"),
            (s + ("BatchNorm_0", "var"), mod.bn.var, "id")]


def _dense_p(key, mod: Linear) -> list:
    return _e_dense(("params",) + key, mod)


def mobilenetv3_entries(model: MobileNetV3Small) -> list:
    out = _e_conv_bn(("stem",), model.stem)
    for i, block in enumerate(model.blocks):
        for name in ("expand", "dw", "project"):
            if getattr(block, name) is not None:
                out += _e_conv_bn((f"block{i}", name), getattr(block, name))
        if block.se is not None:
            out += _dense_p((f"block{i}", "se", "fc1"), block.se.fc1)
            out += _dense_p((f"block{i}", "se", "fc2"), block.se.fc2)
    out += _e_conv_bn(("head_conv",), model.head_conv)
    return out + _dense_p(("pre_logits",), model.pre_logits) + _dense_p(("classifier",),
                                                                       model.classifier)


def _hr_module_entries(key, mod) -> list:
    out = []
    for i, blocks in enumerate(mod.branches):
        for b, block in enumerate(blocks):
            t = key + (f"branch{i}_block{b}",)
            out += _e_conv_bn(t + ("conv1",), block.conv1) + _e_conv_bn(t + ("conv2",),
                                                                        block.conv2)
    for name, f in mod.fuse.items():
        if isinstance(f, torch.nn.ModuleList):
            for k, step in enumerate(f):
                out += _e_conv_bn(key + (f"fuse{name}_step{k}",), step)
        else:
            out += _e_conv_bn(key + (f"fuse{name}",), f)
    return out


def sam_hrnet_entries(model: SAMHRNet) -> list:
    """The JAX `SAMHRNet` tree (either `s2d_branch0` setting: both declare it)."""
    bb, k = model.backbone, ("backbone",)
    out = []
    for name in ("stem1", "stem2", "trans2", "trans3"):
        out += _e_conv_bn(k + (name,), getattr(bb, name))
    for b, block in enumerate(bb.layer1):
        for name in ("conv1", "conv2", "conv3", "downsample"):
            if getattr(block, name) is not None:
                out += _e_conv_bn(k + (f"layer1_{b}", name), getattr(block, name))
    for i, t in enumerate(bb.trans1):
        out += _e_conv_bn(k + (f"trans1_{i}",), t)
    for stage in ("stage2", "stage3", "stage4"):
        for m, mod in enumerate(getattr(bb, stage)):
            out += _hr_module_entries(k + (f"{stage}_m{m}",), mod)
    p = ("params",)
    return out + [(p + ("fuse1", "kernel"), model.fuse1_weight, "k00"),
                  (p + ("fuse1", "bias"), model.fuse1_bias, "id"),
                  (p + ("fuse2", "kernel"), model.fuse2_weight, "k00T"),
                  (p + ("fuse2", "bias"), model.fuse2_bias, "id")]


def _cnn_trees(variables):
    if "batch_stats" not in variables:
        raise ValueError("a BatchNorm CNN needs its batch_stats collection")
    return variables


@torch.no_grad()
def load_mobilenetv3(model: MobileNetV3Small, variables) -> MobileNetV3Small:
    load_entries(mobilenetv3_entries(model), _cnn_trees(variables))
    return model


@torch.no_grad()
def load_sam_hrnet(model: SAMHRNet, variables) -> SAMHRNet:
    """The JAX `SAMHRNet` tree (either `s2d_branch0` setting: both declare
    it) into the port's model."""
    load_entries(sam_hrnet_entries(model), _cnn_trees(variables))
    return model


# --- the legacy zoo and BYOL --------------------------------------------------------


def _e_bn(key, bn) -> list:
    """A flax `nn.BatchNorm` named by `key`: scale and bias in `params`,
    the running mean and variance in `batch_stats`."""
    p, st = ("params",) + key, ("batch_stats",) + key
    return [(p + ("scale",), bn.weight, "id"), (p + ("bias",), bn.bias, "id"),
            (st + ("mean",), bn.mean, "id"), (st + ("var",), bn.var, "id")]


def swin_v1_entries(model: SwinTransformerV1) -> list:
    p = ("params",)
    out = _e_conv(p + ("patch_embed",), model.patch_embed)
    out += _e_ln(p + ("patch_norm",), model.patch_norm)
    if model.absolute_pos_embed is not None:
        out.append((p + ("absolute_pos_embed",), model.absolute_pos_embed, "id"))
    for s, blocks in enumerate(model.stages):
        for i, block in enumerate(blocks):
            t = p + (f"stage{s}_block{i}",)
            out += _e_ln(t + ("norm1",), block.norm1)
            out += _e_dense(t + ("attn", "qkv"), block.attn.qkv)
            out.append((t + ("attn", "rpb_table"), block.attn.rpb_table, "id"))
            out += _e_dense(t + ("attn", "proj"), block.attn.proj)
            out += _e_ln(t + ("norm2",), block.norm2) + _e_mlp(t + ("mlp",), block.mlp)
    for s, merge in enumerate(model.merges):
        out += _e_ln(p + (f"merge{s}", "norm"), merge.norm)
        out += _e_dense(p + (f"merge{s}", "reduction"), merge.reduction)
    return out + _e_ln(p + ("norm",), model.norm) + _e_dense(p + ("output_proj",),
                                                            model.output_proj)


def efficientnet_entries(model: EfficientNet) -> list:
    """The JAX `EfficientNet`'s `params` and `batch_stats`."""
    p = ("params",)
    out = _e_conv(p + ("stem",), model.stem) + _e_bn(("stem_bn",), model.stem_bn)
    i = 0
    for si, stage in enumerate(model.cfg.stages):
        for li in range(stage.layers):
            block, t = model.blocks[i], (f"stage{si}_block{li}",)
            i += 1
            out += _e_conv(p + t + ("expand_conv",), block.expand_conv)
            out += _e_bn(t + ("bn0",), block.bn0)
            if block.dw_conv is not None:
                out += _e_conv(p + t + ("dw_conv",), block.dw_conv)
                out += _e_bn(t + ("bn1",), block.bn1)
            if block.se is not None:
                out += _e_conv(p + t + ("se", "reduce"), block.se.reduce)
                out += _e_conv(p + t + ("se", "expand"), block.se.expand)
            out += _e_conv(p + t + ("project_conv",), block.project_conv)
            out += _e_bn(t + ("bn2",), block.bn2)
    return out + _e_dense(p + ("fc",), model.fc) + _e_bn(("bn",), model.bn)


def mae_entries(model: MaeDescriptor) -> list:
    out = vit_backbone_entries(model.backbone, ("params", "backbone"))
    return out + _e_dense(("params", "fc"), model.fc) + _e_dense(("params", "output_proj"),
                                                                 model.output_proj)


def text_encoder_entries(model: TextEncoder, tree=None) -> list:
    """The JAX `TextEncoder` tree. JAX declares `word_embeddings` only
    when its init saw ids and `token_type_embeddings` only when it saw
    token types: given the JAX `tree`, an entry it lacks is left out."""
    p = ("params",)
    params = None if tree is None else (tree["params"] if "params" in tree else tree)
    out = []
    for name in ("word_embeddings", "token_type_embeddings"):
        if params is None or name in params:
            out.append((p + (name, "embedding"), getattr(model, name).weight, "id"))
    out.append((p + ("position_embeddings",), model.position_embeddings, "id"))
    out += _e_ln(p + ("embeddings_norm",), model.embeddings_norm)
    for i, layer in enumerate(model.layers):
        t = p + (f"layer{i}",)
        out += _e_dense(t + ("attn", "qkv"), layer.attn.qkv)
        out += _e_dense(t + ("attn", "proj"), layer.attn.proj)
        out += _e_ln(t + ("ln_attn",), layer.ln_attn)
        out += _e_dense(t + ("fc1",), layer.fc1) + _e_dense(t + ("fc2",), layer.fc2)
        out += _e_ln(t + ("ln_mlp",), layer.ln_mlp)
    if model.pooler is not None:
        out += _e_dense(p + ("pooler",), model.pooler)
    return out


def _e_res_block(key, block) -> list:
    p = ("params",) + key
    return (_e_conv(p + ("conv1",), block.conv1) + _e_bn(key + ("bn1",), block.bn1)
            + _e_conv(p + ("conv2",), block.conv2) + _e_bn(key + ("bn2",), block.bn2))


def _e_conv_t(key, mod) -> list:
    return [(key + ("kernel",), mod.weight, "convT"), (key + ("bias",), mod.bias, "id")]


def deconv_entries(model: DeConvModel) -> list:
    """The JAX `DeConvModel`'s `params` and `batch_stats`."""
    out = []
    for name in ("res0", "res1", "res2"):
        out += _e_res_block((name,), getattr(model, name))
    for name in ("up0", "up1", "out"):
        out += _e_conv_t(("params", name), getattr(model, name))
    return out


def _e_byol_mlp(key, mlp) -> list:
    return _e_dense(key + ("fc1",), mlp.fc1) + _e_ln(key + ("norm",), mlp.norm) + _e_dense(
        key + ("fc2",), mlp.fc2)


def byol_heads_entries(heads, key=("params",)) -> list:
    """The JAX `ByolHeads` tree (its projector and predictor) under `key`."""
    return _e_byol_mlp(key + ("projector",), heads.projector) + _e_byol_mlp(
        key + ("predictor",), heads.predictor)


def byol_entries(net: ByolNet) -> list:
    """One of BYOL's online or target dicts, {"backbone": the backbone's
    variables, "heads": the `ByolHeads` variables}."""
    out = [(("backbone",) + key, t, layout) for key, t, layout in model_entries(net.backbone)]
    return out + byol_heads_entries(net.heads, ("heads", "params"))


def model_entries(model, tree=None) -> list:
    """The key table of any port model with a JAX twin (`tree`, where
    given, the JAX tree it is to be filled from: see
    `text_encoder_entries`)."""
    tables = ((VitDescriptor, vit_entries), (SwinTransformerV2, swinv2_entries),
              (VideoScoreModel, vsm_entries), (CLIPVisual, clip_entries),
              (MobileNetV3Small, mobilenetv3_entries), (SAMHRNet, sam_hrnet_entries),
              (SwinTransformerV1, swin_v1_entries), (EfficientNet, efficientnet_entries),
              (MaeDescriptor, mae_entries), (DeConvModel, deconv_entries),
              (ByolNet, byol_entries))
    if isinstance(model, TextEncoder):
        return text_encoder_entries(model, tree)
    for cls, entries in tables:
        if isinstance(model, cls):
            return entries(model)
    raise TypeError(f"no JAX key table for {type(model).__name__}")


@torch.no_grad()
def load_swin_v1(model: SwinTransformerV1, variables) -> SwinTransformerV1:
    load_entries(swin_v1_entries(model), variables)
    return model


@torch.no_grad()
def load_efficientnet(model: EfficientNet, variables) -> EfficientNet:
    load_entries(efficientnet_entries(model), _cnn_trees(variables))
    return model


@torch.no_grad()
def load_mae(model: MaeDescriptor, variables) -> MaeDescriptor:
    load_entries(mae_entries(model), variables)
    return model


@torch.no_grad()
def load_text_encoder(model: TextEncoder, variables) -> TextEncoder:
    """The JAX `TextEncoder` tree (with or without its word and token-type
    tables) into the port's model."""
    load_entries(text_encoder_entries(model, variables), variables)
    return model


@torch.no_grad()
def load_deconv(model: DeConvModel, variables) -> DeConvModel:
    load_entries(deconv_entries(model), _cnn_trees(variables))
    return model


@torch.no_grad()
def load_byol(net: ByolNet, tree) -> ByolNet:
    """One of JAX BYOL's online or target dicts ({"backbone", "heads"})
    into a `ByolNet`."""
    load_entries(byol_entries(net), tree)
    return net
