"""PyTorch port, package rules: the port, ``chip_smoke.py`` and
``scripts/compare_port_commits.py`` (both run where there is no JAX)
import nothing of JAX or of the JAX package; entry points default to CUDA and
raise without a GPU; K1's build raises without ``nvcc`` instead of
handing back the plain result; both packages declare the same config
keys."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "analytics_zoo_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "analytics_zoo_tpu"}


def _sources():
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "compare_port_commits.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_no_jax_or_reference_imports():
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in _sources() for line, root in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import analytics_zoo_tpu_torch.serving\n"
            "import analytics_zoo_tpu_torch.models\n"
            "import analytics_zoo_tpu_torch.bridge\n"
            "import analytics_zoo_tpu_torch.ops.flash_attention\n"
            "import analytics_zoo_tpu_torch.learn\n"
            "import analytics_zoo_tpu_torch.learn.checkpoint\n"
            "import analytics_zoo_tpu_torch.data\n"
            "import analytics_zoo_tpu_torch.common.triggers\n"
            "import analytics_zoo_tpu_torch.models.text.bert_squad\n"
            "import analytics_zoo_tpu_torch.serving.generation\n"
            "import analytics_zoo_tpu_torch.inference.kv_cache\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_keys_and_specs_match_reference():
    from analytics_zoo_tpu.common import config as ref
    from analytics_zoo_tpu_torch.common import config as port

    assert port._DEFAULTS == ref._DEFAULTS
    assert port._SPECS == ref._SPECS


class TestDeviceRules:
    @pytest.fixture(autouse=True)
    def _no_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")

    def test_inference_model_defaults_to_cuda(self):
        from analytics_zoo_tpu_torch.inference.inference_model import (
            InferenceModel)

        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceModel()
        assert InferenceModel(device="cpu").device.type == "cpu"

    def test_zoo_model_load_defaults_to_cuda(self, tmp_path):
        from analytics_zoo_tpu_torch.models.common import ZooModel
        from analytics_zoo_tpu_torch.models.text.bert_estimators import (
            BERTClassifier)

        BERTClassifier(num_classes=2, vocab=64, hidden_size=64,
                       n_block=1, n_head=1, intermediate_size=64,
                       max_position_len=128,
                       device="cpu").save_model(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            ZooModel.load_model(str(tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            BERTClassifier(num_classes=2, vocab=64)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fa, "_lib", None)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed at its default path")
    q = torch.zeros(1, 1, 128, 64)
    fa.flash_attention.launches = 0
    with pytest.raises(RuntimeError, match="nvcc"):
        fa._launch(q, q, q, False, 0.125, False)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.build_kernels()
    assert fa.flash_attention.launches == 0


def test_kernel_build_dir_checkout_and_installed(monkeypatch, tmp_path):
    """A source checkout builds into its own ``build/``; an installed
    package (no pyproject.toml two levels up) into a per-user cache. The
    kernel source ships with the package either way."""
    import tomllib

    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    assert fa._build_dir() == REPO / "build"
    site = tmp_path / "site-packages" / "analytics_zoo_tpu_torch" / "ops"
    site.mkdir(parents=True)
    monkeypatch.setattr(fa, "__file__", str(site / "flash_attention.py"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert fa._build_dir() == (tmp_path / "cache" / "analytics_zoo_tpu_torch"
                               / "build")
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"][
        "analytics_zoo_tpu_torch"]
    names = {src.name for src in fa._SOURCES + fa._HEADERS}
    assert {"flash_attn_fwd.cu", "flash_attn_bwd_dq.cu",
            "flash_attn_bwd_dkv.cu", "flash_attn_bwd.cuh"} <= names
    for src in fa._SOURCES + fa._HEADERS:
        assert any(src.relative_to(PORT).match(g) for g in globs), src
