"""The port stands alone: no module of mxnet_tpu_torch (nor chip_smoke.py)
imports JAX or the JAX package, the package imports where both are blocked
and where neither nvcc nor triton exists, and its entry points default to
the GPU and raise without one instead of running on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as pt
from mxnet_tpu_torch.serving import KVCacheDecoder

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(module):
    return module.split(".")[0] in FORBIDDEN


def _port_files():
    return sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, "%s imports %s" % (path, bad)


_BLOCKER = r"""
import importlib.abc, sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _run_blocked(blocked, body, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    code = _BLOCKER.format(blocked=tuple(blocked)) + body
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_package_imports_with_jax_and_the_jax_package_blocked():
    out = _run_blocked(FORBIDDEN, """
import mxnet_tpu_torch, mxnet_tpu_torch.serving, mxnet_tpu_torch.models.transformer
import mxnet_tpu_torch.analysis, mxnet_tpu_torch.convert
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ok")
""")
    assert out.strip().endswith("ok")


def test_ops_import_and_run_without_nvcc_or_triton():
    out = _run_blocked(FORBIDDEN + ("triton",), """
import shutil, torch
assert shutil.which("nvcc") is None
from mxnet_tpu_torch import ops
from mxnet_tpu_torch.ops import norm_residual as nr
x = torch.randn(4, 16)
y, _, _ = nr.layer_norm_affine(x, torch.ones(16), torch.zeros(16))
assert y.shape == (4, 16) and ops.launch_counts()["norm_residual"] == 0
print("ok")
""", env_extra={"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"})
    assert out.strip().endswith("ok")


def test_entry_points_default_to_the_gpu_and_do_not_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pt.current_context() == pt.gpu(0)
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        pt.gpu(0).torch_device
    params = {"embed_weight": np.zeros((8, 4), np.float32)}
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        KVCacheDecoder(params, vocab_size=8, num_layers=1, num_heads=1, model_dim=4,
                       ffn_dim=8, max_len=8, batch=1)
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        pt.params_from_numpy(params)
    # the CPU is taken only when asked for
    assert pt.params_from_numpy(params, ctx=pt.cpu())["embed_weight"].device.type == "cpu"
    # a training bind with no ctx is a GPU bind too
    net = pt.sym.FullyConnected(pt.sym.Variable("x"), num_hidden=3, name="fc")
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        net.simple_bind(grad_req="write", x=(2, 4))
    exe = net.simple_bind(ctx=pt.cpu(), grad_req="write", x=(2, 4))
    exe.arg_dict["x"][:] = np.ones((2, 4), np.float32)
    exe.forward_backward()
    np.testing.assert_array_equal(exe.grad_dict["fc_weight"].asnumpy(),
                                  np.full((3, 4), 2.0, np.float32))
