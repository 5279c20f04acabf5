"""The port stands alone: no JAX, nothing of the JAX package, and no
quiet fall-back to the CPU."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro|ml_dtypes)(\.|\s|$)",
                       re.MULTILINE)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax():
    script = ("import sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['repro'] = None\n"
              f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
              "import importlib\n"
              f"for name in {_modules()!r}:\n"
              "    importlib.import_module(name)\n"
              "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    assert len(_modules()) >= 20
    assert {"repro_torch.configs.rwkv6_3b", "repro_torch.models.rwkv6",
            "repro_torch.kernels.rwkv6_scan.rwkv6_scan",
            "repro_torch.kernels.flash_decode.flash_decode",
            "repro_torch.core.autotune", "repro_torch.models.rglru",
            "repro_torch.kernels.rglru_scan.rglru_scan",
            "repro_torch.configs.recurrentgemma_9b"} <= set(_modules())


def test_no_source_names_jax_or_the_reference_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        found = FORBIDDEN.findall(f.read_text())
        assert not found, (f, found)


def test_entry_points_default_to_the_card():
    """No ``device`` argument means CUDA; without a card that raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import build_engine_full
    from repro_torch.models.rglru import rglru_state_init
    from repro_torch.models.rwkv6 import rwkv6_state_init
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import ServeConfig, init_decode_state
    cfg = reduced(get_config("llama2-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine_full(cfg, max_seq=16, batch_global=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_decode_state(cfg, ServeConfig(max_seq=16, batch_local=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rwkv6_state_init(2, 2, 16, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rglru_state_init(2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine_full(reduced(get_config("recurrentgemma-9b")),
                          max_seq=16, batch_global=2)
