"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU, and chip_smoke.py fails
(with no result line) where there is no CUDA card or no package."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|nrhints_tpu)\b", re.M)


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nrhints_torch\n"
        "for m in pkgutil.walk_packages(nrhints_torch.__path__, 'nrhints_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'nrhints_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_import_no_jax():
    files = sorted((REPO / "nrhints_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files if IMPORT_RE.search(f.read_text())]
    assert not offenders, offenders


def test_resolve_device_never_falls_back():
    from nrhints_torch.utils import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(dev)


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    runs = [(REPO / "chip_smoke.py", REPO)]
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    runs.append((lone, tmp_path))
    for script, cwd in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_state_builders_default_to_the_card():
    """The functions that build the model state place it on the card by
    default, and without CUDA raise rather than build on the CPU; with
    device="cpu" they build on the CPU."""
    from nrhints_torch.camera.rays import RayGeneratorConfig, ray_generator_init
    from nrhints_torch.convert import params_from_jax
    from nrhints_torch.fields.mlp import torch_default_linear_init
    from nrhints_torch.fields.reflectance import reflectance_init
    from nrhints_torch.fields.sdf import SDFNetConfig, sdf_init
    from nrhints_torch.fields.variance import variance_init
    from nrhints_torch.render.renderer import ModelConfig, init_model_params

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    small = SDFNetConfig(n_layers=2, d_hidden=16, d_out_feat=8, skip_in=(1,), multi_res=2)
    gen = torch.Generator().manual_seed(0)
    builders = {
        "init_model_params": lambda **kw: init_model_params(ModelConfig(sdf_network=small), gen, **kw),
        "ray_generator_init": lambda **kw: ray_generator_init(gen, RayGeneratorConfig(cam_opt_mode="SO3xR3"), 2, **kw),
        "params_from_jax": lambda **kw: params_from_jax({"a": {"w": [[1.0, 2.0]]}}, **kw),
        "sdf_init": lambda **kw: sdf_init(gen, small, **kw),
        "variance_init": lambda **kw: variance_init(**kw),
        "reflectance_init": lambda **kw: reflectance_init(gen, d_feature=8, **kw),
        "torch_default_linear_init": lambda **kw: torch_default_linear_init(gen, 3, 4, **kw),
    }
    for name, build in builders.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        leaves = []
        stack = [build(device="cpu")]
        while stack:
            t = stack.pop()
            if isinstance(t, dict):
                stack += list(t.values())
            elif isinstance(t, (tuple, list)):
                stack += list(t)
            else:
                leaves.append(t)
        assert leaves and all(t.device.type == "cpu" for t in leaves), name
