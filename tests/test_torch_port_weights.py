"""The port's reference-checkpoint loaders (`vsc22_tpu_torch/utils/port_weights.py`)
against the JAX package's (`vsc22_tpu/utils/port_weights.py`), on the CPU.

Each reference layout (an AugReg npz, timm/SSCD ViT, SwinV2, OpenAI CLIP,
the BERT video score model, timm MobileNetV3 and HRNet, each also as a
`torch.jit.trace` archive where the reference ships one) goes through both
packages' `port_*`: the JAX one into a template made by `model.init`, the
port one into a port module holding that template's values. The port
module's leaves, written under the JAX keys and layouts
(`jax_params.jax_flat_params`), must equal the JAX tree bit for bit, and
both models' f32 outputs on the same input agree within OUT_TOL. Then the
position-embedding resize, each prefix that is stripped (and the ones that
are not), and the KeyError and ValueError cases.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ref_torch_loader import (
    TorchMobileNetV3Small,
    TorchMS,
    TorchSAMHRNet,
    TorchViT,
    randomize_bn_stats,
)
from test_port_weights import make_augreg_npz
from vsc22_tpu.models import clip as jclip
from vsc22_tpu.models import hrnet as jhrnet
from vsc22_tpu.models import mobilenetv3 as jmnv3
from vsc22_tpu.models import swinv2 as jsw
from vsc22_tpu.models import vit as jvit
from vsc22_tpu.models import vsm as jvsm
from vsc22_tpu.utils import port_weights as jpw
from vsc22_tpu_torch.models import clip, hrnet, mobilenetv3, swinv2, vit, vsm
from vsc22_tpu_torch.utils import jax_params
from vsc22_tpu_torch.utils import port_weights as tpw

OUT_TOL = 1e-4  # f32 outputs, JAX against the port on the CPU
INTERP_TOL = 1e-6  # F.interpolate(antialias=True) against jax.image.resize


# --- the two sides ------------------------------------------------------------


@dataclasses.dataclass
class Pair:
    """A JAX model, its port twin, the port's key table, and an input."""

    jax_model: object
    port: torch.nn.Module
    entries: object  # port module -> its jax_params entry list
    sample: np.ndarray
    apply_kwargs: dict = dataclasses.field(default_factory=dict)


def vit_pair(cfg=jvit.VIT_TINY_TEST, head_dim=64, out_dim=16):
    pcfg = vit.ViTConfig(**dataclasses.asdict(cfg))
    return Pair(jvit.VitDescriptor(cfg=cfg, head_dim=head_dim, out_dim=out_dim),
                vit.VitDescriptor(pcfg, head_dim=head_dim, out_dim=out_dim),
                jax_params.vit_entries, images(2, cfg.img_size), {"train": False})


def backbone_pair(cfg):
    return Pair(jvit.VisionTransformer(cfg), vit.VisionTransformer(
        vit.ViTConfig(**dataclasses.asdict(cfg))), jax_params.vit_backbone_entries,
        images(2, cfg.img_size), {"train": False})


def images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


_APPLY: dict = {}


def jax_apply(pair: Pair):
    """The pair's JAX `apply`, compiled once per configuration for the
    whole file."""
    key = repr(pair.jax_model), tuple(pair.apply_kwargs.items())
    if key not in _APPLY:
        model, kw = pair.jax_model, pair.apply_kwargs
        _APPLY[key] = jax.jit(lambda v, x: model.apply(v, x, **kw))
    return _APPLY[key]


def template(pair: Pair, seed: int = 11):
    """A JAX template (the variables' shapes from `model.init`, seeded
    values: scales near 1, running variances above 0.5), and the port
    module filled with the same values."""
    shapes = jax.eval_shape(lambda: pair.jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(pair.sample[:1]), **pair.apply_kwargs))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        v = (rng.standard_normal(s.shape) * 0.1).astype(s.dtype)
        name = getattr(path[-1], "key", "")
        return np.abs(v) + 0.5 if name == "var" else v + 1 if name == "scale" else v

    variables = jax.tree_util.tree_map_with_path(draw, flax.core.unfreeze(shapes))
    jax_params.load_entries(pair.entries(pair.port), variables)
    return variables


def assert_same(pair: Pair, jax_vars, resized=()):
    """The port module's leaves equal the JAX tree's bit for bit (key set,
    dtype and bits), except the `resized` position embeddings, within
    INTERP_TOL; and the two forwards agree within OUT_TOL."""
    want = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(jax_vars, sep="/").items()}
    got = jax_params.jax_flat_params(pair.entries(pair.port))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k in resized:
            np.testing.assert_allclose(got[k], want[k], atol=INTERP_TOL, rtol=0)
        else:
            assert np.array_equal(got[k], want[k]), k
    out_j = np.asarray(jax_apply(pair)(jax_vars, jnp.asarray(pair.sample)))
    with torch.no_grad():
        out_t = pair.port(torch.from_numpy(pair.sample)).numpy()
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t, out_j, atol=OUT_TOL, rtol=OUT_TOL)


def traced(module, sample, tmp_path, name):
    """`module` as the reference ships it: a `torch.jit.trace` archive."""
    path = tmp_path / f"{name}.torchscript.pt"
    torch.jit.save(torch.jit.trace(module.eval(), sample), str(path))
    return path


# --- _interp_pos_embed ------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(7, 12), (24, 12), (14, 12), (12, 7)])
def test_interp_pos_embed_matches_jax_both_ways(src, dst):
    pos = np.random.default_rng(src * 100 + dst).standard_normal(
        (1, 1 + src * src, 768)).astype(np.float32)
    want = jpw._interp_pos_embed(pos, 1 + dst * dst)
    got = tpw._interp_pos_embed(pos, 1 + dst * dst)
    assert got.shape == want.shape == (1, 1 + dst * dst, 768) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=INTERP_TOL, rtol=0)
    assert tpw._interp_pos_embed(pos, pos.shape[1]) is pos


# --- AugReg npz -------------------------------------------------------------------

AUGREG = jvit.ViTConfig(img_size=32, patch_size=16, embed_dim=16, depth=2, num_heads=2)


@pytest.mark.parametrize("case", ["descriptor", "bare", "resized", "file"])
def test_augreg_npz_matches_jax(case, tmp_path):
    """Into a descriptor (GeM and head keep their values), a bare backbone,
    a backbone on a 4x4 grid from the npz's 2x2 (the position embedding
    resized), and from the npz file as `np.load` gives it."""
    npz = make_augreg_npz(np.random.default_rng(1), AUGREG)
    if case == "descriptor":
        pair = vit_pair(AUGREG, head_dim=32, out_dim=8)
    elif case == "resized":
        pair = backbone_pair(dataclasses.replace(AUGREG, img_size=64))
    else:
        pair = backbone_pair(AUGREG)
    if case == "file":
        np.savez(tmp_path / "augreg.npz", **npz)
        npz = np.load(tmp_path / "augreg.npz")
    jax_vars = jpw.port_vit_augreg_npz(npz, template(pair))
    assert tpw.port_vit_augreg_npz(npz, pair.port) is pair.port
    assert_same(pair, jax_vars, {"params/pos_embed"} if case == "resized" else ())


# --- timm / SSCD ViT ------------------------------------------------------------------


def sscd_reference(cfg, seed=0):
    """The timm twin plus the SSCD head, and its forward on NHWC images."""
    torch.manual_seed(seed)
    tv = TorchViT(img_size=cfg.img_size, patch_size=cfg.patch_size, dim=cfg.embed_dim,
                  depth=cfg.depth, heads=cfg.num_heads).eval()
    head_conv, head_lin = torch.nn.Conv1d(cfg.embed_dim, 64, 1), torch.nn.Linear(64, 16)
    with torch.no_grad():
        for p in (*tv.parameters(), *head_conv.parameters(), *head_lin.parameters()):
            p.normal_(0, 0.1)
    sd = {f"backbone.{k}": v for k, v in tv.state_dict().items()}
    sd.update({"embeddings.0.conv.weight": head_conv.weight,
               "embeddings.0.conv.bias": head_conv.bias,
               "embeddings.1.weight": head_lin.weight, "embeddings.1.bias": head_lin.bias})
    return sd, tv


@pytest.mark.parametrize("prefix", ["", "module.backbone.model.", "module.backbone.", "model.",
                                    "torchscript"])
def test_vit_state_dict_matches_jax(prefix, tmp_path):
    cfg = jvit.VIT_TINY_TEST
    sd, tv = sscd_reference(cfg)
    if prefix == "torchscript":  # the backbone archive's keys under `backbone.`, as traced
        path = traced(tv, torch.zeros(1, 3, cfg.img_size, cfg.img_size), tmp_path, "vit")
        arch = tpw.load_torchscript_state_dict(path)
        assert arch.keys() == jpw.load_torchscript_state_dict(path).keys()
        sd = {**{f"backbone.{k}": v for k, v in arch.items()},
              **{k: v for k, v in sd.items() if k.startswith("embeddings.")}}
    else:
        sd = {f"{prefix}{k}": v for k, v in sd.items()}
    pair = vit_pair()
    jax_vars = jpw.port_vit_torch_state_dict(sd, template(pair))
    assert tpw.port_vit_torch_state_dict(sd, pair.port) is pair.port
    assert_same(pair, jax_vars)


# --- SwinV2 (official keys) ---------------------------------------------------------


def swinv2_state_dict(seed=3):
    """A seeded state dict in the official SwinV2 keys for the tiny config,
    its shapes from the JAX template (as `test_port_weights.py` builds it)."""
    model = jsw.SwinTransformerV2(cfg=jsw.SWINV2_TINY_TEST)
    flat = flax.traverse_util.flatten_dict(
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3))))["params"])
    rng = np.random.default_rng(seed)

    def rand(key, t=False):
        v = (rng.standard_normal(flat[key].shape) * 0.2).astype(np.float32)
        return v.T if t else v

    sd = {"patch_embed.proj.weight": rand(("patch_embed", "kernel")).transpose(3, 2, 0, 1),
          "patch_embed.proj.bias": rand(("patch_embed", "bias")),
          "patch_embed.norm.weight": rand(("patch_norm", "scale")),
          "patch_embed.norm.bias": rand(("patch_norm", "bias")),
          "norm.weight": rand(("norm", "scale")), "norm.bias": rand(("norm", "bias")),
          "output_proj.weight": rand(("output_proj", "kernel"), True),
          "output_proj.bias": rand(("output_proj", "bias"))}
    names = {("norm1", "scale"): "norm1.weight", ("norm1", "bias"): "norm1.bias",
             ("norm2", "scale"): "norm2.weight", ("norm2", "bias"): "norm2.bias",
             ("attn", "logit_scale"): "attn.logit_scale", ("attn", "q_bias"): "attn.q_bias",
             ("attn", "v_bias"): "attn.v_bias", ("attn", "cpb_fc1", "bias"): "attn.cpb_mlp.0.bias",
             ("attn", "proj", "bias"): "attn.proj.bias", ("mlp", "fc1_bias"): "mlp.fc1.bias",
             ("mlp", "fc2_bias"): "mlp.fc2.bias"}
    kernels = {("attn", "qkv_kernel"): "attn.qkv.weight",
               ("attn", "cpb_fc1", "kernel"): "attn.cpb_mlp.0.weight",
               ("attn", "cpb_fc2", "kernel"): "attn.cpb_mlp.2.weight",
               ("attn", "proj", "kernel"): "attn.proj.weight",
               ("mlp", "fc1_kernel"): "mlp.fc1.weight", ("mlp", "fc2_kernel"): "mlp.fc2.weight"}
    for key in sorted(flat):
        head = key[0]
        if head.startswith("stage"):
            t = f"layers.{int(head[5])}.blocks.{int(head.split('block')[1])}"
            if key[1:] in names:
                sd[f"{t}.{names[key[1:]]}"] = rand(key)
            elif key[1:] in kernels:
                sd[f"{t}.{kernels[key[1:]]}"] = rand(key, True)
        elif head.startswith("merge"):
            t = f"layers.{int(head[5])}.downsample"
            if key[1:] == ("reduction", "kernel"):
                sd[f"{t}.reduction.weight"] = rand(key, True)
            else:
                sd[f"{t}.norm.{'weight' if key[2] == 'scale' else 'bias'}"] = rand(key)
    return sd


def swin_pair():
    return Pair(jsw.SwinTransformerV2(cfg=jsw.SWINV2_TINY_TEST),
                swinv2.SwinTransformerV2(swinv2.SWINV2_TINY_TEST), jax_params.swinv2_entries,
                images(2, 32), {"train": False})


@pytest.mark.parametrize("values", ["numpy", "torch"])
def test_swinv2_state_dict_matches_jax(values):
    sd = swinv2_state_dict()
    if values == "torch":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    pair = swin_pair()
    jax_vars = jpw.port_swinv2_torch_state_dict(sd, template(pair))
    assert tpw.port_swinv2_torch_state_dict(sd, pair.port) is pair.port
    assert_same(pair, jax_vars)


# --- OpenAI CLIP visual tower ---------------------------------------------------------


def clip_state_dict(seed=4):
    """Seeded OpenAI-layout keys for the tiny tower (shapes from the JAX
    template), with a projection and a text key the loaders skip."""
    model = jclip.clip_tiny_test()
    flat = flax.traverse_util.flatten_dict(
        jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 32, 32, 3))))["params"])
    rng = np.random.default_rng(seed)

    def rand(shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)

    width = flat[("ln_pre", "scale")].shape[0]
    sd = {"conv1.weight": rand(flat[("conv1", "kernel")].shape).transpose(3, 2, 0, 1),
          "class_embedding": rand(flat[("class_embedding",)].shape),
          "positional_embedding": rand(flat[("positional_embedding",)].shape),
          "proj": rand((width, 8))}
    for ln in ("ln_pre", "ln_post"):
        sd[f"{ln}.weight"], sd[f"{ln}.bias"] = rand((width,)) + 1, rand((width,))
    i = 0
    while ("block%d" % i, "ln_1", "scale") in flat:
        t = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{t}.{ln}.weight"], sd[f"{t}.{ln}.bias"] = rand((width,)) + 1, rand((width,))
        sd[f"{t}.attn.in_proj_weight"] = rand((3 * width, width))
        sd[f"{t}.attn.in_proj_bias"] = rand((3 * width,))
        sd[f"{t}.attn.out_proj.weight"] = rand((width, width))
        sd[f"{t}.attn.out_proj.bias"] = rand((width,))
        hidden = flat[(f"block{i}", "c_fc", "bias")].shape[0]
        sd[f"{t}.mlp.c_fc.weight"], sd[f"{t}.mlp.c_fc.bias"] = rand((hidden, width)), rand((hidden,))
        sd[f"{t}.mlp.c_proj.weight"] = rand((width, hidden))
        sd[f"{t}.mlp.c_proj.bias"] = rand((width,))
        i += 1
    return sd


@pytest.mark.parametrize("prefix", ["", "visual."])
def test_clip_state_dict_matches_jax(prefix):
    sd = {f"{prefix}{k}": v for k, v in clip_state_dict().items()}
    if prefix:  # a whole CLIP checkpoint: keys of the text side, which are not read
        sd["logit_scale"] = np.ones((), np.float32)
        sd["token_embedding.weight"] = np.ones((4, 8), np.float32)
    pair = Pair(jclip.clip_tiny_test(), clip.clip_tiny_test(), jax_params.clip_entries,
                images(2, 32))
    jax_vars = jpw.port_clip_torch_state_dict(sd, template(pair))
    assert tpw.port_clip_torch_state_dict(sd, pair.port) is pair.port
    assert_same(pair, jax_vars)


# --- the BERT video score model -----------------------------------------------------


def vsm_reference():
    torch.manual_seed(5)
    return TorchMS(feat_dim=16, bert_dim=32, layers=2, heads=2, max_frames=8,
                   vocab_size=256).eval()


def vsm_feats():
    feats = np.random.default_rng(6).standard_normal((2, 8, 16)).astype(np.float32)
    feats[1, 5:] = 0.0  # padded frames
    return feats


@pytest.mark.parametrize("source", ["eager", "module.", "torchscript"])
def test_vsm_state_dict_matches_jax(source, tmp_path):
    ref = vsm_reference()
    if source == "torchscript":
        sd = tpw.load_torchscript_state_dict(
            traced(ref, torch.from_numpy(vsm_feats()), tmp_path, "ms"))
    else:
        sd = {f"{'module.' if source == 'module.' else ''}{k}": v
              for k, v in ref.state_dict().items()}
    pair = Pair(jvsm.VideoScoreModel(cfg=jvsm.VSM_TINY_TEST, dtype=jnp.float32),
                vsm.vsm_tiny_test(), jax_params.vsm_entries, vsm_feats())
    jax_vars = jpw.port_vsm_torch_state_dict(sd, template(pair))
    assert tpw.port_vsm_torch_state_dict(sd, pair.port) is pair.port
    assert_same(pair, jax_vars)
    with torch.no_grad():  # and the reference itself
        np.testing.assert_allclose(pair.port(torch.from_numpy(pair.sample)).numpy(),
                                   ref(torch.from_numpy(pair.sample)).numpy(), atol=OUT_TOL)


# --- the matching CNNs ----------------------------------------------------------------


def randomized(ref, seed):
    with torch.no_grad():
        for p in ref.parameters():
            if p.ndim >= 2:
                p.normal_(0, 0.05)
    randomize_bn_stats(ref, seed=seed)
    return ref.eval()


def mnv3_reference():
    torch.manual_seed(7)
    return randomized(TorchMobileNetV3Small(jmnv3.MNV3_SMALL_SPEC, num_classes=2), 8)


def cnn_sd(ref, source, tmp_path, sample, name):
    if source == "torchscript":
        nchw = torch.from_numpy(sample.transpose(0, 3, 1, 2).copy())
        return tpw.load_torchscript_state_dict(traced(ref, nchw, tmp_path, name))
    return {f"{'module.' if source == 'module.' else ''}{k}": v
            for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("source", ["eager", "module.", "torchscript"])
def test_mobilenetv3_state_dict_matches_jax(source, tmp_path):
    ref = mnv3_reference()
    pair = Pair(jmnv3.MobileNetV3Small(num_classes=2, dtype=jnp.float32),
                mobilenetv3.MobileNetV3Small(num_classes=2), jax_params.mobilenetv3_entries,
                images(2, 64, seed=9), {"train": False})
    sd = cnn_sd(ref, source, tmp_path, pair.sample, "cls")
    jax_vars = jpw.port_mnv3_torch_state_dict(sd, template(pair))
    assert tpw.port_mnv3_torch_state_dict(sd, pair.port) is pair.port
    assert_same(pair, jax_vars)


HRNET_TWIN = dict(width=4, stem_ch=8, layer1_blocks=1, stage_modules=(1, 1, 1),
                  blocks_per_branch=1)


@pytest.mark.parametrize("source", ["wrapper", "module.", "timm", "torchscript"])
def test_hrnet_state_dict_matches_jax(source, tmp_path):
    """The SAM wrapper's keys (`model.` backbone + the fuse head), with and
    without `module.`, as a traced archive, and raw timm keys (the
    backbone alone: the fuse head keeps its values)."""
    torch.manual_seed(7)
    ref = randomized(TorchSAMHRNet(out_chann=8, **HRNET_TWIN), 8)
    pair = Pair(jhrnet.sam_hrnet_tiny_test(dtype=jnp.float32), hrnet.sam_hrnet_tiny_test(),
                jax_params.sam_hrnet_entries, images(2, 32, seed=10), {"train": False})
    if source == "timm":
        sd = ref.model.state_dict()
    else:
        sd = cnn_sd(ref, "eager" if source == "wrapper" else source, tmp_path, pair.sample,
                    "sam")
    jax_vars = jpw.port_hrnet_torch_state_dict(sd, template(pair))
    assert tpw.port_hrnet_torch_state_dict(sd, pair.port) is pair.port
    assert_same(pair, jax_vars)


# --- prefixes stripped only where JAX strips them ------------------------------------


def _vit_sd(prefix):
    sd, _ = sscd_reference(jvit.VIT_TINY_TEST)
    return {f"{prefix}{k}": v for k, v in sd.items()}


def _cnn_sd(prefix):
    return {f"{prefix}{k}": v for k, v in mnv3_reference().state_dict().items()}


UNSTRIPPED = {
    # (the function's name in both packages, pair maker, state dict maker)
    "vit backbone.model.": ("port_vit_torch_state_dict", lambda: vit_pair(),
                            lambda: _vit_sd("backbone.model.")),
    "vit module.model.": ("port_vit_torch_state_dict", lambda: vit_pair(),
                          lambda: _vit_sd("module.model.")),
    "clip module.visual.": ("port_clip_torch_state_dict",
                            lambda: Pair(jclip.clip_tiny_test(), clip.clip_tiny_test(),
                                         jax_params.clip_entries, images(1, 32)),
                            lambda: {f"module.visual.{k}": v
                                     for k, v in clip_state_dict().items()}),
    "vsm bert.": ("port_vsm_torch_state_dict",
                  lambda: Pair(jvsm.VideoScoreModel(cfg=jvsm.VSM_TINY_TEST),
                               vsm.vsm_tiny_test(), jax_params.vsm_entries, vsm_feats()),
                  lambda: {f"model.{k}": v for k, v in vsm_reference().state_dict().items()}),
    "mnv3 model.": ("port_mnv3_torch_state_dict",
                    lambda: Pair(jmnv3.MobileNetV3Small(num_classes=2),
                                 mobilenetv3.MobileNetV3Small(num_classes=2),
                                 jax_params.mobilenetv3_entries, images(1, 64),
                                 {"train": False}),
                    lambda: _cnn_sd("model.")),
    "swinv2 module.": ("port_swinv2_torch_state_dict", swin_pair,
                       lambda: {f"module.{k}": v for k, v in swinv2_state_dict().items()}),
}


@pytest.mark.parametrize("case", sorted(UNSTRIPPED))
def test_other_prefixes_are_not_stripped(case):
    """A prefix that JAX does not strip leaves the keys unknown: both raise
    KeyError, and the port module keeps every value it had."""
    name, make_pair, make_sd = UNSTRIPPED[case]
    pair, sd = make_pair(), make_sd()
    jax_template = template(pair)
    before = {k: v.clone() for k, v in pair.port.state_dict().items()}
    with pytest.raises(KeyError):
        getattr(jpw, name)(sd, jax_template)
    with pytest.raises(KeyError):
        getattr(tpw, name)(sd, pair.port)
    after = pair.port.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


# --- KeyError and ValueError ----------------------------------------------------------


def _deeper_vit_sd():
    """A state dict of three blocks for the two-block model."""
    sd = _vit_sd("")
    for k in [k for k in sd if k.startswith("backbone.blocks.1.")]:
        sd[k.replace("blocks.1.", "blocks.2.")] = sd[k]
    return sd


def _wider_swin_sd():
    sd = swinv2_state_dict()
    sd["norm.weight"] = np.ones(sd["norm.weight"].shape[0] + 1, np.float32)
    return sd


def _missing_hrnet_sd():
    torch.manual_seed(7)
    sd = randomized(TorchSAMHRNet(out_chann=8, **HRNET_TWIN), 8).state_dict()
    sd.pop("model.bn2.running_var")
    return sd


def _short_vocab_vsm_sd():
    sd = vsm_reference().state_dict()
    sd["bert.embeddings.word_embeddings.weight"] = sd[
        "bert.embeddings.word_embeddings.weight"][:102]
    return sd


def _wrong_npz_width():
    npz = make_augreg_npz(np.random.default_rng(1), AUGREG)
    npz["embedding/bias"] = np.zeros(17, np.float32)
    return npz


ERRORS = {
    # (port function, pair maker, state dict maker, the error both raise)
    "vit more blocks than the model": ("port_vit_torch_state_dict", vit_pair, _deeper_vit_sd,
                                       KeyError),
    "vit missing head": ("port_vit_torch_state_dict", vit_pair,
                         lambda: {k: v for k, v in _vit_sd("").items()
                                  if not k.startswith("embeddings.1")}, KeyError),
    "swinv2 wrong width": ("port_swinv2_torch_state_dict", swin_pair, _wider_swin_sd,
                           ValueError),
    "hrnet missing running_var": ("port_hrnet_torch_state_dict",
                                  lambda: Pair(jhrnet.sam_hrnet_tiny_test(),
                                               hrnet.sam_hrnet_tiny_test(),
                                               jax_params.sam_hrnet_entries, images(1, 32),
                                               {"train": False}),
                                  _missing_hrnet_sd, KeyError),
    "vsm vocabulary without [SEP]": ("port_vsm_torch_state_dict",
                                     lambda: Pair(jvsm.VideoScoreModel(cfg=jvsm.VSM_TINY_TEST),
                                                  vsm.vsm_tiny_test(), jax_params.vsm_entries,
                                                  vsm_feats()),
                                     _short_vocab_vsm_sd, IndexError),
    "augreg wrong width": ("port_vit_augreg_npz", lambda: backbone_pair(AUGREG),
                           _wrong_npz_width, ValueError),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(case):
    """Where JAX raises, the port raises the same error, and leaves the
    module as it was (every value is checked before any is written)."""
    name, make_pair, make_sd, error = ERRORS[case]
    pair, sd = make_pair(), make_sd()
    jax_template = template(pair)
    before = {k: v.clone() for k, v in pair.port.state_dict().items()}
    with pytest.raises(error):
        getattr(jpw, name)(sd, jax_template)
    with pytest.raises(error):
        getattr(tpw, name)(sd, pair.port)
    after = pair.port.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_casts_to_the_parameter_dtype():
    """A bf16 port model takes f32 reference values rounded to bf16 in its
    matmul weights and keeps f32 in its biases and norms, as a JAX template
    in bf16 would; a bf16 checkpoint loads exactly."""
    sd, _ = sscd_reference(jvit.VIT_TINY_TEST)
    model = vit.vit_tiny_test_descriptor(dtype=torch.bfloat16)
    tpw.port_vit_torch_state_dict(sd, model)
    w = model.backbone.blocks[0].attn.qkv.weight
    assert w.dtype == torch.bfloat16
    assert torch.equal(w, sd["backbone.blocks.0.attn.qkv.weight"].to(torch.bfloat16))
    assert model.backbone.blocks[0].attn.qkv.bias.dtype == torch.float32
    bf = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    f32 = vit.vit_tiny_test_descriptor()
    tpw.port_vit_torch_state_dict(bf, f32)
    assert torch.equal(f32.head.weight, bf["embeddings.1.weight"].float())
