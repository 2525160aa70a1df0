"""The port stands alone: importing ``repro_torch`` (every submodule)
and ``chip_smoke`` pulls in neither ``jax`` nor the JAX package, and its
entry points refuse to run on the CPU unless asked to."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke            # imported, not run
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
assert "triton" not in sys.modules
print("imported", len(names))
"""


def _submodules():
    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]


def test_import_pulls_in_no_jax_and_nothing_of_the_jax_package():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == f"imported {1 + len(_submodules())}"


def test_every_module_of_the_slice_is_there():
    want = {"configs.base", "configs.registry", "configs.qwen3_1_7b",
            "configs.deepseek_7b", "kernels._build",
            "kernels.decode_attention", "kernels.guard", "kernels.ops",
            "models.layers", "models.attention", "models.transformer",
            "models.model", "convert", "serve.kv_pool", "serve.engine",
            "launch.serve", "core.isa", "core.machine", "core.prims",
            "core.locator", "core.policy", "core.offload",
            "kernels.blockprog", "kernels.codegen",
            "kernels.fused_elementwise", "kernels.fused_matmul",
            "kernels.fused_matmul_bwd", "kernels.adamw_update",
            "data.pipeline", "optim.adamw", "optim.schedule",
            "ckpt.manager", "train.step", "train.loop", "launch.train",
            "kernels.ssd_scan", "kernels.wkv6", "models.ssm",
            "models.rwkv", "configs.zamba2_1_2b", "configs.rwkv6_1_6b"}
    have = {n.removeprefix("repro_torch.") for n in _submodules()}
    assert want <= have, want - have
    csrc = ROOT / "src/repro_torch/kernels/csrc/paged_decode_attention.cu"
    text = csrc.read_text()
    assert "__global__" in text and 'extern "C"' in text
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    gemm = (csrc / "fused_matmul.cuh").read_text()
    assert "__global__" in gemm and "fm_gemm_fma" in gemm
    # the wgmma forms live in the Hopper primitives' one copy, which the
    # B3 / B4 / B6 mainloop and the flash kernels include and call
    assert "wgmma.mma_async" in (csrc / "sm90_common.cuh").read_text()
    for header in ("fused_matmul_sm90.cuh", "flash_attention_sm90.cuh",
                   "flash_attention_bwd_sm90.cuh"):
        assert "sm90_mma" in (csrc / header).read_text(), header
    for header in ("fused_matmul_sm90.cuh", "flash_attention_sm90.cuh"):
        assert '#include "sm90_common.cuh"' in (csrc / header).read_text()
    assert "fm_cp16(" in (csrc / "fused_matmul_stream.cuh").read_text()
    assert "cp.async.cg" in gemm


def test_sources_name_no_jax_import_and_no_library_attention():
    """The static side of the same claim, plus: the port itself never
    calls a library's fused attention or ``torch.compile``."""
    for path in [*(ROOT / "src/repro_torch").rglob("*.py"),
                 ROOT / "chip_smoke.py"]:
        text = path.read_text()
        for line in text.splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro ", "from repro ",
                                     "from repro.", "import repro.")), \
                (path, line)
        if path.name != "chip_smoke.py":     # its yardstick may call sdpa
            assert "scaled_dot_product_attention" not in text, path
            assert "torch.compile" not in text, path


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = reduced(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    params = build_model(cfg, device="cpu").init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, params)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--local", "--requests", "1"])


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--local", "--device", "cpu", "--requests", "3"])
    assert "served 3 requests / 24 tokens" in capsys.readouterr().out


def test_launcher_serves_offloaded_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--local", "--device", "cpu", "--requests", "2",
                "--offload-mode", "all_near"])
    out = capsys.readouterr().out
    assert "served 2 requests / 16 tokens" in out
    assert "'plan_misses': 1" in out and "fused" in out


def test_chip_smoke_fails_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
