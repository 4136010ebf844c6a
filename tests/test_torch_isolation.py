"""The port stands alone: no JAX, nothing of the JAX package, no silent
CPU fallback."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_gpu_device_plugin_torch"
FORBIDDEN = ("jax", "jaxlib", "k8s_gpu_device_plugin_tpu")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("torch_*.py")))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
            node.func, "id", getattr(node.func, "attr", None)
        ) in ("import_module", "__import__") and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            yield str(node.args[0].value)


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import k8s_gpu_device_plugin_torch.serving.server\n"
        "import k8s_gpu_device_plugin_torch.models.convert\n"
        "import k8s_gpu_device_plugin_torch.models.generate\n"
        "import k8s_gpu_device_plugin_torch.models.paging\n"
        "import k8s_gpu_device_plugin_torch.models.quantized_serving\n"
        "import k8s_gpu_device_plugin_torch.ops.quant\n"
        "import k8s_gpu_device_plugin_torch.models.trainer\n"
        "import k8s_gpu_device_plugin_torch.ops.flash_attention\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_server_without_cuda_exits_naming_cuda(monkeypatch, capsys):
    from k8s_gpu_device_plugin_torch.serving import server as srv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert srv._main(["--preset", "tiny", "--port", "0"]) == 2
    assert "CUDA" in capsys.readouterr().err


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from k8s_gpu_device_plugin_torch.device import resolve_device
    from k8s_gpu_device_plugin_torch.models.llama import (
        LlamaConfig,
        init_params,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(LlamaConfig.tiny())
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("mps")
