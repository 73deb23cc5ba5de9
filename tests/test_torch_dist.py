"""The port's dist KVStore over two gloo ranks on the CPU.

Each case writes a worker script into ``tmp_path`` that imports only the
port (numpy and torch besides), and runs it as two ranks under
``tools/launch.py -n 2 --launcher local --cpu-devices 1`` (which sets the
``MXNET_TPU_*`` coordination variables and ``MXNET_DEFAULT_CONTEXT=cpu``:
``dist.init`` joins a gloo process group over worker 0's TCPStore). Every
launch has a timeout of its own, well under a minute of work.

* ``dist_sync`` training of the MNIST ``mlp`` (784-128-64-10), each rank on
  its half of every batch of 32, three SGD-momentum steps: both ranks end
  with the same bits, and those equal the JAX package's single-process
  ``Module`` over ``[cpu(0), cpu(1)]`` (its fused step) on the whole
  batches (rtol 1e-4, atol 1e-5). Through the fused step (a ``dist*`` sync
  store engages it, as in JAX: each rank's gradients are summed over the
  ranks inside the step) and, with ``MXNET_MODULE_FUSED_STEP=0``, through
  the per-device path and the store.
* The per-device path through the bucketed engine with ``MXNET_KVSTORE_UPDATE=sharded``
  (reduce-scatter, the flat update on each rank's half, all-gather; same
  tolerance) and with ``MXNET_KVSTORE_COMM_DTYPE=bf16`` (gradients on the
  wire in bf16: within rtol 1e-2, atol 1e-3 of JAX's float32 run), plus a
  probe whose bf16 sum (1 + 2^-8 rounds to 1) differs from its float32 sum:
  the store returns the float32 sum.
* A sparse round: each rank pushes its own rows; both ranks hold the union,
  the lazy Adam update of the summed rows (checked against numpy), the
  JAX package's counter values (``kvstore.sparse_rows_pushed``,
  ``kvstore.bytes.sparse`` by the padded wire formula) and untouched rows
  bit for bit rank 0's initial table (rank 1 started from another table:
  ``init`` adopts rank 0's).
* BatchNorm across ranks trains through the fused step (its statistics
  summed over the ranks, ``tests/test_torch_sync_bn.py`` holds the values
  against the JAX package's); what the fused step still refuses across
  ranks is a model axis, naming ROADMAP.md section 1.4c.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5

WORKER = r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as pt

mode, tmp = sys.argv[1], sys.argv[2]
os.environ["MXNET_TELEMETRY"] = "counters"
rank = int(os.environ["MXNET_TPU_WORKER_ID"])
ctx = pt.cpu()


def counters(names):
    return {n: pt.telemetry.counter(n).value for n in names}


if mode == "mlp":
    case = np.load(os.path.join(tmp, "case.npz"))
    x, y = case["x"], case["y"]
    # this rank's half of every batch of 32
    rows = np.concatenate([np.arange(b * 32 + rank * 16, b * 32 + rank * 16 + 16)
                           for b in range(len(x) // 32)])
    with ctx:
        it = pt.io.NDArrayIter(x[rows], y[rows], batch_size=16)
        net = pt.models.get_symbol("mlp", num_classes=10)
        mod = pt.mod.Module(net, context=ctx)
        params = {k[2:]: pt.nd.array(case[k]) for k in case.files if k.startswith("p_")}
        mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4)),
                arg_params=params)
        args, _ = mod.get_params()
        kv = mod._kvstore
        assert kv.num_workers == 2 and kv.rank == rank
        out = {"w_" + k: v.asnumpy() for k, v in args.items()}
        out["fused"] = np.array(mod._spmd is not None)
        if mod._spmd is not None:
            out["processes"] = np.array(mod._spmd.trainer.mesh.process_count)
        engine = kv._bucket_engine
        out["engine_mode"] = np.array(engine.mode if engine is not None else "none")
        out.update({"c_" + k: np.array(v) for k, v in counters(
            ["kvstore.bucket_flushes", "kvstore.bytes.allreduce",
             "kvstore.bytes.reduce_scatter", "kvstore.bytes.all_gather"]).items()})
        if os.environ.get("MXNET_KVSTORE_COMM_DTYPE") == "bf16":
            probe = pt.kv.create("dist_sync")
            probe.init("p", pt.nd.zeros((8,)))
            probe.push("p", pt.nd.full((8,), 1.0 if rank == 0 else 2.0 ** -8))
            got = pt.nd.zeros((8,))
            probe.pull("p", out=got)
            out["probe"] = got.asnumpy()
            out["probe_wire"] = np.array(probe._bucket_engine.plan.buckets[0].comm_dtype)
    np.savez(os.path.join(tmp, "out%d.npz" % rank), **out)

elif mode == "bn":
    with ctx:
        data = pt.sym.Variable("data")
        net = pt.sym.FullyConnected(data, num_hidden=8, name="fc")
        net = pt.sym.BatchNorm(net, name="bn")
        net = pt.sym.SoftmaxOutput(net, name="softmax")
        mod = pt.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[("data", (4, 6))], label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        try:
            mod.init_optimizer(kvstore="dist_sync", optimizer="sgd")
            raised = ""
        except pt.MXNetError as e:
            raised = str(e)
        fused = mod._spmd is not None
        try:
            pt.parallel.make_mesh({"data": 1, "model": 2})
            model_raised = ""
        except pt.MXNetError as e:
            model_raised = str(e)
    np.savez(os.path.join(tmp, "out%d.npz" % rank), raised=np.array(raised),
             fused=np.array(fused), model_raised=np.array(model_raised))

elif mode == "sparse":
    case = np.load(os.path.join(tmp, "case.npz"))
    with ctx:
        kv = pt.kv.create("dist_sync")
        kv.set_optimizer(pt.optimizer.Adam(learning_rate=0.01))
        kv.init("emb", pt.nd.array(case["w0"] if rank == 0 else case["w0"] + 1.0))
        rows = case["rows%d" % rank]
        vals = case["vals%d" % rank]
        kv.push("emb", pt.sparse.row_sparse_array((vals, rows), case["w0"].shape))
        got = pt.nd.zeros(case["w0"].shape)
        kv.pull("emb", out=got)
        st = kv._updater.states["emb"]
        out = {"w": got.asnumpy(), "state_rows": st.indices, "mean": st.rows[0],
               "var": st.rows[1]}
        out.update({"c_" + k: np.array(v) for k, v in counters(
            ["kvstore.sparse_rows_pushed", "kvstore.bytes.sparse",
             "kvstore.sparse_dense_fallbacks"]).items()})
    np.savez(os.path.join(tmp, "out%d.npz" % rank), **out)
pt.dist.shutdown()
'''


def _launch(tmp_path, mode, env_extra=None, timeout=120):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **(env_extra or {}))
    env.pop("MXNET_TELEMETRY", None)
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "launch.py"), "-n", "2", "--launcher", "local",
         "--cpu-devices", "1", sys.executable, str(script), mode, str(tmp_path)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    return [dict(np.load(tmp_path / ("out%d.npz" % r))) for r in range(2)]


def _mlp_case(tmp_path):
    rs = np.random.RandomState(3)
    templates = rs.rand(10, 784) > 0.7
    y = rs.randint(0, 10, 96)
    x = np.clip(templates[y] + rs.normal(0, 0.12, (96, 784)), 0, 1).astype("float32")
    net = mxnet_tpu.models.get_symbol("mlp", num_classes=10)
    arg_shapes, _, _ = net.infer_shape(data=(32, 784))
    params = {n: (rs.randn(*s) * 0.05).astype("float32")
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    np.savez(tmp_path / "case.npz", x=x, y=y.astype("float32"),
             **{"p_" + k: v for k, v in params.items()})
    return x, y.astype("float32"), params


def _jax_reference(x, y, params):
    """The JAX package's single-process Module over [cpu(0), cpu(1)] on the
    whole batches of 32."""
    mx = mxnet_tpu
    it = mx.io.NDArrayIter(x, y, batch_size=32)
    mod = mx.mod.Module(mx.models.get_symbol("mlp", num_classes=10),
                        context=[mx.cpu(0), mx.cpu(1)])
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4)),
            arg_params={k: mx.nd.array(v) for k, v in params.items()})
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("update,wire", [("replicated", "f32"), ("sharded", "f32"),
                                         ("replicated", "bf16")])
def test_dist_sync_mlp_matches_jax_single_process(tmp_path, update, wire):
    x, y, params = _mlp_case(tmp_path)
    # the per-device path and the store's engine (a dist store engages the
    # fused step unless asked not to)
    env = {"MXNET_KVSTORE_UPDATE": update, "MXNET_MODULE_FUSED_STEP": "0"}
    if wire == "bf16":
        env["MXNET_KVSTORE_COMM_DTYPE"] = "bf16"
    outs = _launch(tmp_path, "mlp", env)
    ref = _jax_reference(x, y, params)
    tol = dict(rtol=RTOL, atol=ATOL) if wire == "f32" else dict(rtol=1e-2, atol=1e-3)
    for k, want in ref.items():
        np.testing.assert_array_equal(outs[0]["w_" + k], outs[1]["w_" + k], err_msg=k)
        np.testing.assert_allclose(outs[0]["w_" + k], want, err_msg=k, **tol)
    for o in outs:
        assert not bool(o["fused"])
        # the bucket engine ran: one plan, async flushes, the JAX byte formulas
        assert str(o["engine_mode"]) == update
        assert int(o["c_kvstore.bucket_flushes"]) > 0
        if update == "sharded":
            assert int(o["c_kvstore.bytes.reduce_scatter"]) > 0
            assert int(o["c_kvstore.bytes.allreduce"]) == 0
        else:
            assert int(o["c_kvstore.bytes.allreduce"]) > 0
    if wire == "bf16":
        want = np.float32(1.0) + np.float32(2.0 ** -8)
        bf16_sum = np.float32(1.0)  # 1 + 2^-8 is a tie in bf16: rounds to even, 1
        assert want != bf16_sum
        for o in outs:
            assert str(o["probe_wire"]) == "bfloat16"
            np.testing.assert_array_equal(o["probe"], np.full(8, want, np.float32))


def test_dist_sync_fused_step_matches_jax_single_process(tmp_path):
    """Two gloo ranks, each feeding half the rows, through the fused step:
    the gradients are summed over the ranks inside the step, both ranks end
    with the same bits, equal to the JAX package's single-process fused
    Module over [cpu(0), cpu(1)] (rtol 1e-4, atol 1e-5); the store's
    engine never runs."""
    x, y, params = _mlp_case(tmp_path)
    outs = _launch(tmp_path, "mlp")
    ref = _jax_reference(x, y, params)
    for k, want in ref.items():
        np.testing.assert_array_equal(outs[0]["w_" + k], outs[1]["w_" + k], err_msg=k)
        np.testing.assert_allclose(outs[0]["w_" + k], want, rtol=RTOL, atol=ATOL, err_msg=k)
    for o in outs:
        assert bool(o["fused"]) and int(o["processes"]) == 2
        assert str(o["engine_mode"]) == "none" or int(o["c_kvstore.bucket_flushes"]) == 0


def test_dist_fused_step_refuses_batchnorm_across_ranks(tmp_path):
    """BatchNorm across ranks no longer refuses: the fused step binds it
    (ROADMAP.md section 1.4b step 4). The refusal left is a model axis
    across the ranks, naming section 1.4c."""
    outs = _launch(tmp_path, "bn")
    for o in outs:
        assert str(o["raised"]) == "" and bool(o["fused"])
        assert "a model axis across processes" in str(o["model_raised"])
        assert "section 1.4c" in str(o["model_raised"])


def test_dist_sparse_round_unions_rows_and_updates_lazily(tmp_path):
    rs = np.random.RandomState(4)
    V, D = 50, 8
    w0 = rs.rand(V, D).astype("float32")
    rows0, rows1 = np.array([1, 4, 9, 30]), np.array([4, 11, 30, 49])
    vals0 = rs.rand(4, D).astype("float32") - 0.5
    vals1 = rs.rand(4, D).astype("float32") - 0.5
    np.savez(tmp_path / "case.npz", w0=w0, rows0=rows0, rows1=rows1, vals0=vals0, vals1=vals1)
    outs = _launch(tmp_path, "sparse")
    union = np.union1d(rows0, rows1)
    g = np.zeros((V, D), "float32")
    g[rows0] += vals0
    g[rows1] += vals1
    # one lazy Adam step (t = 1) on the union rows
    gu = g[union]
    mean = 0.1 * gu
    var = 0.001 * gu * gu
    lr = 0.01 * np.sqrt(1 - 0.999) / (1 - 0.9)
    want = w0.copy()
    want[union] = w0[union] - lr * mean / (np.sqrt(var) + 1e-8)
    U_pad = 8  # next power of two >= 6 rows
    for o in outs:
        np.testing.assert_array_equal(o["state_rows"], union)
        np.testing.assert_allclose(o["w"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["mean"], mean, rtol=1e-6, atol=1e-7)
        unt = np.setdiff1d(np.arange(V), union)
        np.testing.assert_array_equal(o["w"][unt], w0[unt])
        assert int(o["c_kvstore.sparse_rows_pushed"]) == union.size
        assert int(o["c_kvstore.bytes.sparse"]) == int(2 * (2 - 1) / 2 * U_pad * D * 4)
        assert int(o["c_kvstore.sparse_dense_fallbacks"]) == 0
    np.testing.assert_array_equal(outs[0]["w"], outs[1]["w"])
