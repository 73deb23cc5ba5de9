"""The port's training C ABI (``mxnet_tpu_torch/csrc/host/c_api.cc``,
``mxnet_tpu_torch/c_api.py``) against the JAX package's (``src/c_api.cc``).

The reference's own C program (``tests/test_c_api.py``'s ``C_TRAIN``: LeNet
bound from symbol JSON through ``MXTrainExecutorCreate``, forward, backward
and an in-place ``sgd_update`` through ``MXImperativeInvokeByName``, then a
KVStore round trip) is compiled once against each package's library and
run with the CPU as the default context: the ten losses it prints agree
(rtol 1e-5, atol 1e-6) and fall. ``dev_type`` is honoured by the port: 2
without CUDA fails with an error that names CUDA, 1 is the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import c_api as jax_c_api
from mxnet_tpu.models import lenet
from mxnet_tpu_torch import c_api as port_c_api
from test_c_api import C_TRAIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

C_DEVICES = r"""
#include <stdio.h>
#include <string.h>
#include "mxtpu/c_api.h"

int main(void) {
  mx_uint shape[] = {2, 3};
  NDArrayHandle h = NULL;
  /* 2 is the card: without CUDA an error that names it, no array */
  if (MXNDArrayCreate(shape, 2, 2, 0, 0, &h) == 0 || h != NULL) return 1;
  printf("gpu: %s\n", MXGetLastError());
  if (MXNDArrayCreate(shape, 2, 7, 0, 0, &h) == 0) return 2;
  printf("bad: %s\n", MXGetLastError());
  /* 1 is the CPU */
  if (MXNDArrayCreate(shape, 2, 1, 0, 0, &h) != 0) return 3;
  float buf[6] = {1, 2, 3, 4, 5, 6}, back[6];
  if (MXNDArraySyncCopyFromCPU(h, buf, 6) || MXNDArraySyncCopyToCPU(h, back, 6)) return 4;
  if (memcmp(buf, back, sizeof buf) != 0) return 5;
  MXNDArrayFree(h);
  printf("cpu ok\n");
  return 0;
}
"""


def _env(**extra):
    """The embedded interpreter finds both packages and this interpreter's
    site-packages."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT] + [p for p in sys.path if p]),
               JAX_PLATFORMS="cpu", MXNET_DEFAULT_CONTEXT="cpu")
    env.update(extra)
    return env


def _compile(src_text, lib, exe):
    src = exe.parent / (exe.name + ".c")
    src.write_text(src_text)
    subprocess.run(["gcc", str(src), "-I", os.path.join(ROOT, "include"), "-o", str(exe),
                    lib, "-Wl,-rpath," + os.path.dirname(lib), "-lm"],
                   check=True, capture_output=True)
    return str(exe)


@pytest.fixture(scope="module")
def libs():
    out = {"jax": jax_c_api.build(), "torch": port_c_api.build()}
    if None in out.values():
        pytest.skip("no toolchain for the C ABI libraries")
    assert out["torch"] == port_c_api.lib_path()
    assert os.path.dirname(out["torch"]).endswith(os.path.join("build", "torch_native"))
    return out


def test_the_reference_c_program_trains_lenet_on_both_libraries(tmp_path, libs):
    json_path = tmp_path / "lenet-symbol.json"
    json_path.write_text(lenet.get_symbol(num_classes=10).tojson())
    losses = {}
    for name, lib in libs.items():
        exe = _compile(C_TRAIN, lib, tmp_path / ("train_" + name))
        r = subprocess.run([exe, str(json_path)], capture_output=True, text=True,
                           timeout=300, env=_env())
        assert r.returncode == 0, (name, r.returncode, r.stdout[-500:], r.stderr[-800:])
        losses[name] = np.array([float(line.split()[-1]) for line in r.stdout.splitlines()
                                 if line.startswith("step")])
    assert len(losses["torch"]) == 10
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5, atol=1e-6)
    assert losses["torch"][-1] < losses["torch"][0] * 0.9


def test_dev_type_is_honoured_and_a_missing_card_names_cuda(tmp_path, libs):
    exe = _compile(C_DEVICES, libs["torch"], tmp_path / "devices")
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300,
                       env=_env(CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-800:])
    lines = dict(line.split(": ", 1) for line in r.stdout.splitlines() if ": " in line)
    assert "CUDA is not available" in lines["gpu"], lines
    assert "dev_type 7" in lines["bad"], lines
    assert "cpu ok" in r.stdout


def test_glue_places_arrays_by_dev_type_and_invokes_as_the_reference():
    """The Python glue the library calls, in process: ``zeros`` honours
    ``dev_type``, and the allocating and in-place invoke modes give the
    JAX glue's values."""
    a = pt.c_api.zeros((2, 2), 1, 0)
    assert a.context == pt.cpu() and a.shape == (2, 2)
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        pt.c_api.zeros((2, 2), 2, 0)
    x = np.array([[1.0, 2.0], [3.0, 4.0]], "f")
    y = np.array([[10.0, 20.0], [30.0, 40.0]], "f")
    got = []
    for glue, nd, ctx in ((jax_c_api, mx.nd, mx.cpu()), (port_c_api, pt.nd, pt.cpu())):
        a, b = nd.array(x, ctx=ctx), nd.array(y, ctx=ctx)
        (out,) = glue.invoke("elemwise_add", [a, b], [], [], None)
        (same,) = glue.invoke("sgd_update", [a, b], ["lr"], ["0.1"], [a])
        assert same is a
        got.append((out.asnumpy(), a.asnumpy()))
        with pytest.raises(ValueError, match="out targets"):
            glue.invoke("sgd_mom_update", [a, b, b], ["lr"], ["0.1"], [a])
    for g, w in zip(got[1], got[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
