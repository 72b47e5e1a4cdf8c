"""The port package stands without JAX, without the JAX package and without
pandas (the card host has none)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def test_port_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib, vsc22_tpu_torch\n"
        "for m in pkgutil.walk_packages(vsc22_tpu_torch.__path__, 'vsc22_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "             or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


MATCHING_MODULES = (
    "vsc22_tpu_torch.models.mobilenetv3",
    "vsc22_tpu_torch.models.hrnet",
    "vsc22_tpu_torch.utils.jax_params",
    "vsc22_tpu_torch.matching.simmat",
    "vsc22_tpu_torch.matching.decode",
    "vsc22_tpu_torch.pipelines.query_extract",
    "vsc22_tpu_torch.pipelines.matching_infer",
    "vsc22_tpu_torch.pipelines.matching_cli",
    "vsc22_tpu_torch.train.matching",
    "vsc22_tpu_torch.train.matching_cli",
    "vsc22_tpu_torch.align.vta",
    "vsc22_tpu_torch.align.metrics",
    "vsc22_tpu_torch.align.vcsl_io",
)


def test_matching_modules_each_import_alone_without_jax():
    """Each module of the matching track (its inference, its trainers and
    the alignment methods), imported first in a fresh interpreter, then
    `chip_smoke`: none loads JAX, the JAX package or pandas, and both CLIs'
    entry points are there."""
    code = (
        "import sys, importlib\n"
        f"for name in {MATCHING_MODULES!r} + ('chip_smoke',):\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "    assert not bad, (name, bad)\n"
        "assert callable(sys.modules['vsc22_tpu_torch.pipelines.matching_cli'].main)\n"
        "assert callable(sys.modules['vsc22_tpu_torch.train.matching_cli'].main)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in MATCHING_MODULES:
        assert (ROOT / (name.replace(".", "/") + ".py")).is_file(), name


TRAIN_MODULES = (
    "vsc22_tpu_torch.ops.vjp",
    "vsc22_tpu_torch.train",
    "vsc22_tpu_torch.train.contrastive",
    "vsc22_tpu_torch.train.checkpoint",
    "vsc22_tpu_torch.train.vid_score",
    "scripts.torch_perf_train",
)


def test_train_modules_each_import_alone_without_jax():
    """Each training module, imported first in a fresh interpreter: none
    loads JAX, the JAX package or pandas, and the trainers' entry points
    are there."""
    code = (
        "import sys, importlib\n"
        f"for name in {TRAIN_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "    assert not bad, (name, bad)\n"
        "c = sys.modules['vsc22_tpu_torch.train.contrastive']\n"
        "assert callable(c.make_train_step) and callable(c.create_train_state)\n"
        "assert callable(sys.modules['scripts.torch_perf_train'].main)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in TRAIN_MODULES:
        path = ROOT / name.replace(".", "/")
        assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), name


OFFLINE_MODULES = (
    "vsc22_tpu_torch.ops.pca",
    "vsc22_tpu_torch.data.transforms",
    "vsc22_tpu_torch.data.fsd",
    "vsc22_tpu_torch.data.frames",
    "vsc22_tpu_torch.pipelines.preprocess",
    "vsc22_tpu_torch.models.registry",
    "vsc22_tpu_torch.pipelines.query_extract",
    "vsc22_tpu_torch.pipelines.query_cli",
    "vsc22_tpu_torch.pipelines.ref_extract",
    "vsc22_tpu_torch.pipelines.ref_cli",
    "vsc22_tpu_torch.pipelines.ensemble",
    "vsc22_tpu_torch.pipelines.ensemble_cli",
    "vsc22_tpu_torch.pipelines.clip_features",
    "vsc22_tpu_torch.pipelines.dev_tools",
)


def test_offline_modules_each_import_alone_without_jax_or_opencv():
    """Each module of the offline CLIs' path, imported first in a fresh
    interpreter: none loads JAX, the JAX package, pandas or OpenCV (the
    decoder imports OpenCV only when it decodes), and the CLIs' entry
    points are there."""
    code = (
        "import sys, importlib\n"
        f"for name in {OFFLINE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas', 'cv2')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.', 'cv2.')))\n"
        "    assert not bad, (name, bad)\n"
        "for cli in ('query_cli', 'ref_cli', 'ensemble_cli'):\n"
        "    assert callable(sys.modules['vsc22_tpu_torch.pipelines.' + cli].main)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in OFFLINE_MODULES:
        assert (ROOT / (name.replace(".", "/") + ".py")).is_file(), name


DATA_LAYER_MODULES = (
    "vsc22_tpu_torch.utils.config",
    "vsc22_tpu_torch.utils.observability",
    "vsc22_tpu_torch.data.store",
    "vsc22_tpu_torch.data.augment",
    "vsc22_tpu_torch.data.datasets",
    "vsc22_tpu_torch.pipelines.preprocess",
    "vsc22_tpu_torch.train.descriptor_cli",
)


def test_data_layer_modules_each_import_alone_without_jax():
    """Each module of the training data layer and the descriptor trainer's
    CLI, imported first in a fresh interpreter, then `chip_smoke`: none
    loads JAX, the JAX package or pandas; the CLIs' entry points and the
    record store's source are there."""
    code = (
        "import sys, importlib\n"
        f"for name in {DATA_LAYER_MODULES!r} + ('chip_smoke',):\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "    assert not bad, (name, bad)\n"
        "assert callable(sys.modules['vsc22_tpu_torch.train.descriptor_cli'].main)\n"
        "assert callable(sys.modules['vsc22_tpu_torch.pipelines.preprocess'].main)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in DATA_LAYER_MODULES:
        assert (ROOT / (name.replace(".", "/") + ".py")).is_file(), name
    assert (ROOT / "vsc22_tpu_torch" / "csrc" / "recordstore.cpp").is_file()


UTIL_MODULES = (
    "vsc22_tpu_torch.ops.library",
    "vsc22_tpu_torch.utils.hostmem",
    "vsc22_tpu_torch.utils.port_weights",
    "vsc22_tpu_torch.utils.export",
)


def test_util_modules_each_import_alone_without_jax():
    """The reference-checkpoint loaders, the export and the allocator
    tuning, each imported first in a fresh interpreter, then `chip_smoke`:
    none loads JAX, the JAX package or pandas, and every kernel op is
    registered once the export module is in."""
    code = (
        "import sys, importlib\n"
        f"for name in {UTIL_MODULES!r} + ('chip_smoke',):\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "    assert not bad, (name, bad)\n"
        "assert len(sys.modules['vsc22_tpu_torch.ops.library'].OPS) == 8\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_loader_workers_load_without_torch():
    """A spawned loader worker rebuilds its dataset from the data layer and
    opens the record store's host library: none of it imports torch."""
    code = (
        "import sys\n"
        "import vsc22_tpu_torch.data.datasets, vsc22_tpu_torch.data.store as store\n"
        "store.library()\n"
        "assert 'torch' not in sys.modules\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_only_the_decoder_imports_opencv():
    """The resize and the Canny are the port's own arithmetic: no line of
    the offline path's modules but the decoder's imports cv2."""
    for name in OFFLINE_MODULES:
        f = ROOT / (name.replace(".", "/") + ".py")
        for line in f.read_text().splitlines():
            mod = _imported_module(line.strip())
            if mod is not None and mod.split(".")[0] == "cv2":
                assert f == ROOT / "vsc22_tpu_torch" / "data" / "frames.py", (f, line)


def _imported_module(line: str):
    """The module an `import x` / `from x import y` line names, else None."""
    words = line.split()
    if len(words) >= 2 and words[0] in ("import", "from"):
        return words[1].rstrip(",")
    return None


def test_port_sources_never_import_jax():
    """Neither JAX, nor the JAX package, nor pandas: `vsc22_tpu` is
    imported by no line, not even inside a function."""
    files = [*(ROOT / "vsc22_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
             ROOT / "scripts" / "torch_perf_train.py", ROOT / "scripts" / "torch_learning_demo.py"]
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            mod = _imported_module(line)
            if mod is None:
                continue
            top = mod.split(".")[0]
            assert top not in ("jax", "flax", "vsc22_tpu", "pandas"), (f, line)


def test_shell_entry_points_have_port_twins():
    """Each `scripts/X.sh` has `scripts/torch_X.sh`, the same lines but its
    header comment, every `python -m vsc22_tpu.<m>` run as
    `python -m vsc22_tpu_torch.<m>` (a module the port has), and no line
    naming the JAX package; and the learning demo imports alone without
    JAX."""
    scripts = sorted(p for p in (ROOT / "scripts").glob("*.sh") if not p.name.startswith("torch_"))
    assert len(scripts) == 7
    for sh in scripts:
        twin = sh.with_name("torch_" + sh.name)
        body = [line for line in sh.read_text().splitlines()[1:] if not line.startswith("#")]
        port = [line for line in twin.read_text().splitlines()[1:] if not line.startswith("#")]
        assert port == [line.replace("python -m vsc22_tpu.", "python -m vsc22_tpu_torch.")
                        .replace(f"usage: {sh.name}", f"usage: {twin.name}") for line in body]
        modules = [w for line in port for w in line.split() if w.startswith("vsc22_tpu")]
        assert modules and all(m.startswith("vsc22_tpu_torch.") for m in modules), twin
        assert all((ROOT / (m.replace(".", "/") + ".py")).is_file() for m in modules), modules
        assert twin.stat().st_mode & 0o111, twin
    code = ("import sys\n"
            "import scripts.torch_learning_demo as d\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
            "             or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
            "assert not bad and callable(d.main), bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize(
    "timestamps",
    [np.arange(3, dtype=np.float32), np.array([[0.0, 1.0], [1.0, 2.0], [2.0, 3.0]])],
    ids=["instants", "spans"],
)
def test_video_feature_copy_matches_reference(timestamps):
    from vsc22_tpu.core import types as ref
    from vsc22_tpu_torch.core import types as port

    for name in ("VideoMetadata", "VideoFeature"):
        assert [f.name for f in dataclasses.fields(getattr(port, name))] == [
            f.name for f in dataclasses.fields(getattr(ref, name))
        ]
    feature = np.arange(6, dtype=np.float32).reshape(3, 2)
    a = ref.VideoFeature(video_id="Q000001", timestamps=timestamps, feature=feature)
    b = port.VideoFeature(video_id="Q000001", timestamps=timestamps, feature=feature)
    assert len(a) == len(b) == 3 and a.dimensions() == b.dimensions() == 2
    assert [a.get_timestamps(i) for i in range(3)] == [b.get_timestamps(i) for i in range(3)]
    assert dataclasses.asdict(a.metadata()).keys() == dataclasses.asdict(b.metadata()).keys()
    for mod in (ref, port):
        with pytest.raises(ValueError, match="feature rows"):
            mod.VideoFeature(video_id="Q1", timestamps=timestamps, feature=feature[:2])


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


ZOO_MODULES = (
    "vsc22_tpu_torch.models.swin_v1",
    "vsc22_tpu_torch.models.efficientnet",
    "vsc22_tpu_torch.models.mae",
    "vsc22_tpu_torch.models.text_encoder",
    "vsc22_tpu_torch.models.deconv",
    "vsc22_tpu_torch.train.byol",
)


def test_zoo_modules_each_import_alone_without_jax():
    """Each module of the legacy zoo and the BYOL recipe, imported first in
    a fresh interpreter: none loads JAX, the JAX package or pandas, and the
    registry holds every zoo name."""
    code = (
        "import sys, importlib\n"
        f"for name in {ZOO_MODULES!r} + ('vsc22_tpu_torch.models.registry',):\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "    assert not bad, (name, bad)\n"
        "r = sys.modules['vsc22_tpu_torch.models.registry'].BACKBONES\n"
        "assert all(k in r for k in ('efficientnet_v2_s', 'swin_v1_tiny_224', "
        "'mae_base_patch16_224', 'roberta_base', 'deconv_model', 'video_score_md'))\n"
        "assert callable(sys.modules['vsc22_tpu_torch.train.byol'].make_byol_step)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in ZOO_MODULES:
        assert (ROOT / (name.replace(".", "/") + ".py")).is_file(), name


PARALLEL_MODULES = (
    "vsc22_tpu_torch.parallel",
    "vsc22_tpu_torch.parallel.launcher",
    "vsc22_tpu_torch.parallel.distributed",
    "vsc22_tpu_torch.parallel.mesh",
    "vsc22_tpu_torch.parallel.dryrun",
)


def test_parallel_modules_each_import_alone_without_jax():
    """Each module of the multi-process layer, imported first in a fresh
    interpreter: none loads JAX, the JAX package or pandas, none forms a
    process group on import, and the package exports the JAX twin's five
    names."""
    code = (
        "import sys, importlib\n"
        f"for name in {PARALLEL_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'vsc22_tpu', 'pandas')\n"
        "                 or m.startswith(('jax.', 'flax', 'vsc22_tpu.', 'pandas.')))\n"
        "    assert not bad, (name, bad)\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "p = sys.modules['vsc22_tpu_torch.parallel']\n"
        "names = ('batch_sharding', 'create_mesh', 'infer_param_spec', 'param_shardings',\n"
        "         'replicated')\n"
        "assert all(callable(getattr(p, n)) for n in names)\n"
        "assert callable(sys.modules['vsc22_tpu_torch.parallel.dryrun'].dryrun_multichip)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for name in PARALLEL_MODULES:
        path = ROOT / name.replace(".", "/")
        assert path.with_suffix(".py").is_file() or (path / "__init__.py").is_file(), name
