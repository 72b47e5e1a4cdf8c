"""The port's model export (`vsc22_tpu_torch/utils/export.py`) and its
kernels as registered torch ops (`vsc22_tpu_torch/ops/library.py`), on the
CPU.

The twin of the JAX package's `TestExport` (`tests/test_export_clipfeat.py`):
a tiny ViT exported and reloaded gives the eager port's descriptors bit for
bit and the JAX `model.apply`'s within EXPORT_TOL; a `.params.npz` written
by the JAX package's `export_model` rebinds the port's program; a call at
another shape raises `ValueError`. Then each op's fake implementation on
`meta` tensors against its plain version's shape and dtype (K3's output is
f32 whatever its operands' dtype), a program
exported on fake CUDA tensors, which take the card's path through the
wrappers, holding one op node per K1 and K2 launch, and `load_exported`
reading a saved op node in an interpreter that has not registered it.
"""

import collections
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from vsc22_tpu.models import vit as jvit
from vsc22_tpu.utils import export as jexport
from vsc22_tpu_torch.models import vit
from vsc22_tpu_torch.ops import attn, attn_proj, mlp, sim, swin_block, vit_block, window_attn
from vsc22_tpu_torch.ops.library import OPS as REGISTERED
from vsc22_tpu_torch.ops.library import register_ops
from vsc22_tpu_torch.utils import jax_params
from vsc22_tpu_torch.utils.export import (
    export_model,
    load_exported,
    load_exported_with_params,
)

ROOT = Path(__file__).resolve().parent.parent
EXPORT_TOL = 1e-5  # f32 descriptors, the exported port against JAX (as TestExport)
SHAPE = (2, 64, 64, 3)


def jax_vit(seed):
    model = jvit.vit_tiny_test_descriptor()
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros(SHAPE), train=False)
    return model, jax.tree.map(np.asarray, params)


def port_vit(params):
    return jax_params.load_vit_descriptor(vit.vit_tiny_test_descriptor(), params)


def images(seed=1):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(np.float32)


def test_export_and_reload_matches(tmp_path):
    jm, params = jax_vit(0)
    model = port_vit(params)
    params_path, export_path = export_model(str(tmp_path / "vit_tiny"), model, SHAPE,
                                            torch.float32)
    assert params_path.endswith(".params.npz") and export_path.endswith(".pt2")
    x = images()
    with torch.no_grad():
        eager = model(torch.from_numpy(x))
    expect = np.asarray(jm.apply(params, jnp.asarray(x), train=False))

    got = load_exported(export_path)(torch.from_numpy(x))
    assert torch.equal(got, eager)
    np.testing.assert_allclose(got.numpy(), expect, atol=EXPORT_TOL)

    fresh = vit.vit_tiny_test_descriptor()  # other weights, until the snapshot binds
    got2 = load_exported_with_params(export_path, params_path, fresh)(torch.from_numpy(x))
    assert torch.equal(got2, eager)


def test_jax_snapshot_rebinds_the_port_program(tmp_path):
    """The JAX package's `export_model` writes its `.params.npz`; bound to
    the port's program (exported with other weights), it gives the port
    model holding those params, and JAX's outputs within EXPORT_TOL."""
    _, first = jax_vit(0)
    _, export_path = export_model(str(tmp_path / "port"), port_vit(first), SHAPE,
                                  torch.float32)
    jm, params = jax_vit(5)
    jax_params_path, _ = jexport.export_model(str(tmp_path / "jax"), jm, params, SHAPE,
                                              jnp.float32)
    x = images(2)
    fwd = load_exported_with_params(export_path, jax_params_path,
                                    vit.vit_tiny_test_descriptor())
    got = fwd(torch.from_numpy(x))
    with torch.no_grad():
        assert torch.equal(got, port_vit(params)(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, jnp.asarray(x),
                                                                train=False)),
                               atol=EXPORT_TOL)


@pytest.mark.parametrize("images_of", ["batch", "size", "dtype"])
def test_export_shape_mismatch_rejected(tmp_path, images_of):
    _, params = jax_vit(0)
    _, export_path = export_model(str(tmp_path / "m"), port_vit(params), SHAPE,
                                  torch.float32)
    call = load_exported(export_path)
    wrong = {"batch": torch.zeros(3, 64, 64, 3), "size": torch.zeros(2, 32, 32, 3),
             "dtype": torch.zeros(SHAPE, dtype=torch.bfloat16)}[images_of]
    with pytest.raises(ValueError):
        call(wrong)


# --- the registered ops -------------------------------------------------------------


def _t(gen, shape, dtype=torch.float32):
    return (torch.randn(shape, generator=gen) * 0.3).to(dtype)


def op_cases(dt):
    """(op name, wrapper, arguments) at small shapes: the wrapper's plain
    version runs on these CPU tensors, the op's fake on their meta copies."""
    g = torch.Generator().manual_seed(0)
    b, l, c, h, f, m = 2, 5, 8, 2, 32, 10
    ln = lambda: (_t(g, (c,)) + 1, _t(g, (c,)))  # noqa: E731
    x3 = _t(g, (b, l, c), dt)
    qkv_w, qkv_b = _t(g, (3 * c, c), dt), _t(g, (3 * c,))
    proj_w, proj_b = _t(g, (c, c), dt), _t(g, (c,))
    fc1_w, fc1_b, fc2_w, fc2_b = _t(g, (f, c), dt), _t(g, (f,)), _t(g, (c, f), dt), _t(g, (c,))
    w, n, nw = 4, 4, 2
    rpb, scale, mask = _t(g, (h, n, n)), _t(g, (h,)) + 1, _t(g, (nw, n, n))
    hd = c // h
    return [
        ("attn_proj_residual", attn_proj.attn_proj_residual,
         (x3, _t(g, (b, l, 3 * c), dt), proj_w, proj_b, h)),
        ("ln_attn_proj_residual", attn_proj.ln_attn_proj_residual,
         (x3, *ln(), qkv_w, qkv_b, proj_w, proj_b, h, 1e-5)),
        ("ln_mlp_residual", mlp.ln_mlp_residual,
         (_t(g, (m, c), dt), *ln(), fc1_w, fc1_b, fc2_w, fc2_b, "gelu", 1e-5)),
        ("fused_mlp", mlp.fused_mlp, (_t(g, (m, c), dt), fc1_w, fc1_b, fc2_w, fc2_b)),
        ("swin_block", swin_block.swin_block,
         (_t(g, (w, n, c), dt), qkv_w, qkv_b.index_fill(0, torch.arange(c, 2 * c), 0.0),
          proj_w, proj_b, *ln(), fc1_w, fc1_b, fc2_w, fc2_b, *ln(), rpb, scale, mask, h, nw)),
        ("window_attention", window_attn.window_attention,
         (*(_t(g, (w, h, n, hd), dt) for _ in range(3)), rpb, scale, mask, nw)),
        ("packed_attention", attn.packed_attention,
         tuple(_t(g, (b, l, h, hd), dt) for _ in range(3))),
        ("vit_block", vit_block.vit_block,
         (x3, *ln(), qkv_w, qkv_b, proj_w, proj_b, *ln(), fc1_w, fc1_b, fc2_w, fc2_b, h,
          "quick_gelu", 1e-6)),
        ("row_max", sim.row_max_gemm, (_t(g, (m, c), dt), _t(g, (2 * m, c), dt))),
    ]


OPS = [name for name, _, _ in op_cases(torch.float32)]
OUT_DTYPES = {"row_max": torch.float32}  # else the first operand's dtype


def test_every_forward_kernel_is_a_registered_op():
    """K1, B9, K2, B7, B1, B6, B8 and B10, and K3 (score-norm's, for the
    trace), are ops of one namespace; B5, the search's kernel, is not."""
    register_ops()
    assert sorted(REGISTERED) == sorted(f"vsc22::{n}" for n in OPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", OPS)
def test_fake_gives_the_plain_versions_shape_and_dtype(name, dtype):
    (_, wrapper, args), = [c for c in op_cases(dtype) if c[0] == name]
    plain = wrapper(*args)  # CPU tensors: the plain version
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    fake = getattr(torch.ops.vsc22, name)(*meta)
    assert fake.device.type == "meta"
    assert fake.shape == plain.shape and fake.dtype == plain.dtype == OUT_DTYPES.get(name, dtype)


@pytest.mark.parametrize("name", OPS)
def test_op_refuses_cpu_tensors(name):
    """No fallback: the op has a CUDA kernel only (the wrapper keeps CPU
    tensors on the plain version before they reach it)."""
    (_, _, args), = [c for c in op_cases(torch.float32) if c[0] == name]
    with pytest.raises(NotImplementedError):
        getattr(torch.ops.vsc22, name)(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_program_holds_one_node_per_kernel_launch(dtype):
    """Exported on fake CUDA tensors (this CPU build makes them under
    `FakeTensorMode`), the tiny ViT takes the card's path through the
    wrappers: its program holds a K1 and a K2 node per block, and nothing
    of the plain versions' attention."""
    with FakeTensorMode():
        model = vit.vit_tiny_test_descriptor(dtype, device="cuda")
        images = torch.empty(SHAPE, dtype=dtype, device="cuda")
    with torch.no_grad():
        program = torch.export.export(model, (images,))
    calls = collections.Counter(str(n.target) for n in program.graph.nodes
                                if n.op == "call_function")
    depth = model.backbone.cfg.depth
    assert calls["vsc22.attn_proj_residual.default"] == depth
    assert calls["vsc22.ln_mlp_residual.default"] == depth
    assert not any("softmax" in k or "einsum" in k for k in calls), calls


class _MlpOp(torch.nn.Module):
    """K2's op called directly, on `meta` parameters."""

    def __init__(self, c=8, hidden=32):
        super().__init__()
        m = lambda *s: torch.nn.Parameter(torch.empty(s, device="meta"))  # noqa: E731
        self.ln_s, self.ln_b, self.b1, self.b2 = m(c), m(c), m(hidden), m(c)
        self.w1, self.w2 = m(hidden, c), m(c, hidden)

    def forward(self, x):
        return torch.ops.vsc22.ln_mlp_residual(x, self.ln_s, self.ln_b, self.w1, self.b1,
                                               self.w2, self.b2, "gelu", 1e-6)


def test_load_exported_registers_the_ops_itself(tmp_path):
    """A saved program holding a `vsc22` node, loaded by `load_exported` in
    a fresh interpreter that has imported none of the op modules."""
    with torch.no_grad():
        program = torch.export.export(_MlpOp(), (torch.empty(10, 8, device="meta"),))
    path = tmp_path / "mlp.pt2"
    torch.export.save(program, str(path))
    code = (
        "import sys, torch\n"
        "from vsc22_tpu_torch.utils.export import load_exported\n"
        f"call = load_exported({str(path)!r})\n"
        "ops = [str(n.target) for n in call.program.graph.nodes if n.op == 'call_function']\n"
        "print(ops)\n"
        "try:\n"
        "    call(torch.empty(3, 8, device='meta'))\n"
        "except ValueError:\n"
        "    print('refused')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["['vsc22.ln_mlp_residual.default']", "refused"]
