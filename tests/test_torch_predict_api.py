"""The port's C predict ABI (``mxnet_tpu_torch/csrc/host/predict_api.cc``)
against the JAX package's (``src/predict_api.cc``).

The reference's C program (``tests/test_predict_api.py``'s ``C_SMOKE``:
``MXPredCreate`` at ``dev_type=1``, ``SetInput``, ``Forward``,
``GetOutputShape``/``GetOutput`` on a checkpoint the Python API saved) is
compiled against each package's library: both print the same output
shape, and the port's values equal the JAX library's and the port's
in-process ``Predictor`` (rtol 1e-5, atol 1e-6). The header-only C++
wrapper serves through the port's library, its ``Reshape`` an independent
predictor. ``dev_type=2`` without CUDA fails naming CUDA.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import predict_api as jax_predict_api
from mxnet_tpu_torch import predict_api as port_predict_api
from test_predict_api import C_SMOKE, CPP_SMOKE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C_NO_CARD = r"""
#include <stdio.h>
#include "mxtpu/c_predict_api.h"

int main(int argc, char** argv) {
  const char* json = "{\"nodes\": [{\"op\": \"null\", \"name\": \"data\", \"inputs\": []}],"
                     " \"arg_nodes\": [0], \"heads\": [[0, 0, 0]]}";
  const char* keys[] = {"data"};
  mx_uint indptr[] = {0, 2}, shape[] = {1, 4};
  PredictorHandle h = NULL;
  if (MXPredCreate(json, NULL, 0, 2, 0, 1, keys, indptr, shape, &h) == 0) return 1;
  printf("gpu: %s\n", MXGetLastError());
  return h == NULL ? 0 : 2;
}
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]),
               JAX_PLATFORMS="cpu", MXNET_DEFAULT_CONTEXT="cpu")
    env.update(extra)
    return env


def _compile(src_text, lib, exe, cxx=False):
    src = exe.parent / (exe.name + (".cc" if cxx else ".c"))
    src.write_text(src_text)
    compiler = ["g++", "-std=c++17"] if cxx else ["gcc"]
    subprocess.run(compiler + [str(src), "-I", os.path.join(ROOT, "include"), "-o", str(exe),
                               lib, "-Wl,-rpath," + os.path.dirname(lib)],
                   check=True, capture_output=True)
    return str(exe)


@pytest.fixture(scope="module")
def libs():
    out = {"jax": jax_predict_api.build(), "torch": port_predict_api.build()}
    if None in out.values():
        pytest.skip("no toolchain for the predict libraries")
    assert out["torch"] == port_predict_api.lib_path()
    return out


@pytest.fixture
def model(tmp_path):
    """The reference test's FC + softmax net, its weights saved by the JAX
    package, and a batch of 4."""
    rs = np.random.RandomState(0)
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=5, name="fc"),
        name="softmax")
    (tmp_path / "m-symbol.json").write_text(net.tojson())
    mx.nd.save(str(tmp_path / "m.params"),
               {"arg:fc_weight": mx.nd.array(rs.randn(5, 8).astype("float32") * 0.3),
                "arg:fc_bias": mx.nd.array(rs.randn(5).astype("float32") * 0.1)})
    x = rs.rand(4, 8).astype("float32")
    (tmp_path / "input.bin").write_bytes(x.tobytes())
    return tmp_path, x


def _port_predictor(tmp_path, x):
    pred = pt.predictor.Predictor((tmp_path / "m-symbol.json").read_text(),
                                  (tmp_path / "m.params").read_bytes(), {"data": (4, 8)},
                                  ctx=pt.cpu())
    pred.forward(data=x)
    return pred.get_output(0)


def test_the_reference_c_program_serves_through_both_libraries(model, libs):
    tmp_path, x = model
    outs = {}
    for name, lib in libs.items():
        exe = _compile(C_SMOKE, lib, tmp_path / ("smoke_" + name))
        out_bin = tmp_path / ("out_%s.bin" % name)
        r = subprocess.run([exe, str(tmp_path / "m-symbol.json"), str(tmp_path / "m.params"),
                            str(tmp_path / "input.bin"), str(x.size), str(out_bin)],
                           capture_output=True, text=True, timeout=300, env=_env())
        assert r.returncode == 0, (name, r.stderr[-800:])
        blob = out_bin.read_bytes()
        ndim = np.frombuffer(blob[:4], np.uint32)[0]
        shape = tuple(np.frombuffer(blob[4:4 + 4 * ndim], np.uint32))
        outs[name] = np.frombuffer(blob[4 + 4 * ndim:], np.float32).reshape(shape)
    assert outs["torch"].shape == outs["jax"].shape == (4, 5)
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs["torch"], _port_predictor(tmp_path, x), rtol=1e-5,
                               atol=1e-6)


def test_the_cpp_wrapper_serves_and_reshapes_through_the_port(model, libs):
    tmp_path, x = model
    exe = _compile(CPP_SMOKE, libs["torch"], tmp_path / "smokecc", cxx=True)
    out_bin = tmp_path / "o.bin"
    r = subprocess.run([exe, str(tmp_path / "m-symbol.json"), str(tmp_path / "m.params"),
                        str(tmp_path / "input.bin"), str(out_bin)],
                       capture_output=True, text=True, timeout=300, env=_env())
    assert r.returncode == 0, r.stderr[-800:]
    blob = np.frombuffer(out_bin.read_bytes(), np.float32)
    want = _port_predictor(tmp_path, x)
    np.testing.assert_allclose(blob[:20].reshape(4, 5), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(blob[20:].reshape(1, 5), want[:1], rtol=1e-5, atol=1e-6)


def test_dev_type_2_without_a_card_names_cuda(tmp_path, libs):
    exe = _compile(C_NO_CARD, libs["torch"], tmp_path / "nocard")
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       env=_env(CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-800:])
    assert "CUDA is not available" in r.stdout, r.stdout
