"""BatchNorm across processes in the port's fused step, held against the JAX
package's fused step over two virtual CPUs.

Two gloo ranks (``tools/launch.py -n 2 --cpu-devices 1``) train a narrow
pre-activation bottleneck net (the zoo's ``residual_unit``: conv+BN sites
with folded prologues, stats reuse and residual defers, an unfused BatchNorm
on the data itself, and one the planner leaves to the op, ``output_mean_var``)
through ``Module.fit(kvstore='dist_sync')``, each rank feeding its half of
every batch. Each conv+BN site runs the kernel's plain version on the rank's
rows and sums (Σc, Σc²) over the ranks (``fusion._conv_block_sharded``); the
other two sum their own (``fusion._global_moments``). The
JAX package trains the same net over ``[cpu(0), cpu(1)]`` at the global
batch under ``MXNET_FUSED_CONV_BN=1`` (``MXNET_FUSED_CONV_BN_BWD=recompute``),
which routes each site through its ``_conv_block_sharded`` (``shard_map`` +
``psum``, the Pallas kernels in interpret mode). After 2 SGD-momentum steps
the weights, the moving statistics and the last step's loss agree within
rtol 1e-4, atol 1e-5 (measured on the CPU: weights within 1.2e-7, moving
stats within 1.2e-7, the loss equal). The same ranks train through
``SPMDTrainer(remat=True|'dots')`` against JAX's remat trainer (weights within
1.2e-7, moving stats within 2.4e-7, the loss within 4.8e-7): backward's
recompute must sum the statistics as the forward did. A last job asks for a
``model`` axis across the two processes and gets the raise naming ROADMAP.md
section 1.4c.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as mx

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
BATCH, SHAPE, STEPS = 4, (16, 8, 8), 2
FORCED = {"MXNET_FUSED_CONV_BN": "1", "MXNET_FUSED_CONV_BN_BWD": "recompute"}
OPT = (("learning_rate", 0.05), ("momentum", 0.9), ("wd", 1e-4))

NET = r'''
def narrow(pkg, residual_unit):
    """A data BatchNorm (unfused: its input is the data), three bottlenecks
    (projection, stride 2, identity), the zoo's head with an unplanned
    BatchNorm before its pooling."""
    sym = pkg.sym
    with pkg.name.NameManager():
        body = sym.BatchNorm(data=sym.Variable("data"), fix_gamma=False, eps=2e-5,
                             name="bn_data")
        body = residual_unit(body, 32, (1, 1), False, "u1")
        body = residual_unit(body, 32, (2, 2), False, "u2")
        body = residual_unit(body, 32, (1, 1), True, "u3")
        bn = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5, name="bn")
        relu = sym.Activation(data=bn, act_type="relu", name="relu")
        # the planner leaves a BatchNorm whose moments are outputs unplanned:
        # the op itself runs it
        head = sym.BatchNorm(data=relu, fix_gamma=False, eps=2e-5, output_mean_var=True,
                             name="bn_head")[0]
        pool = sym.Pooling(data=head, global_pool=True, kernel=(4, 4), pool_type="avg",
                           name="pool")
        fc = sym.FullyConnected(data=sym.Flatten(data=pool), num_hidden=10, name="fc")
        return sym.SoftmaxOutput(data=fc, name="softmax")
'''

WORKER = NET + r'''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as pt
from mxnet_tpu_torch.models.resnet import residual_unit

mode, tmp = sys.argv[1], sys.argv[2]
rank = int(os.environ["MXNET_TPU_WORKER_ID"])
case = np.load(os.path.join(tmp, "case.npz"))
B = int(case["batch"])
half = B // 2
with pt.cpu():
    net = narrow(pt, residual_unit)
    out = {}
    if mode == "train":
        x, y = case["x"], case["y"]
        rows = np.concatenate([np.arange(b * B + rank * half, b * B + rank * half + half)
                               for b in range(len(x) // B)])
        it = pt.io.NDArrayIter(x[rows], y[rows], batch_size=half)
        mod = pt.mod.Module(net, context=pt.cpu())
        args = {k[2:]: pt.nd.array(case[k]) for k in case.files if k.startswith("p_")}
        aux = {k[2:]: pt.nd.array(case[k]) for k in case.files if k.startswith("a_")}
        mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
                optimizer_params=%(opt)r, arg_params=args, aux_params=aux)
        assert mod._spmd is not None and mod._spmd.trainer.mesh.process_count == 2
        a, x_ = mod.get_params()
        out.update({"w_" + k: v.asnumpy() for k, v in a.items()})
        out.update({"x_" + k: v.asnumpy() for k, v in x_.items()})
        out["prob"] = mod.get_outputs()[0].asnumpy()
    elif mode.startswith("remat="):
        pt.dist.init()
        mesh = pt.parallel.make_mesh({"data": 2})
        assert mesh.process_count == 2
        tr = pt.parallel.SPMDTrainer(net, mesh, optimizer="sgd",
                                     optimizer_params=dict(%(opt)r, rescale_grad=1.0 / B),
                                     remat=%(remat)r[mode[6:]])
        tr.set_params({k[2:]: case[k] for k in case.files if k.startswith("p_")},
                      {k[2:]: case[k] for k in case.files if k.startswith("a_")})
        for b in range(len(case["x"]) // B):
            rows = slice(b * B + rank * half, b * B + rank * half + half)
            outs = tr.step({"data": case["x"][rows]}, {"softmax_label": case["y"][rows]})
        a, x_ = tr.get_params()
        out.update({"w_" + k: v for k, v in a.items()})
        out.update({"x_" + k: v for k, v in x_.items()})
        out["prob"] = outs[0].detach().numpy()
    else:
        pt.dist.init()
        try:
            pt.parallel.make_mesh({"data": 1, "model": 2})
            out["raised"] = np.array("")
        except pt.MXNetError as e:
            out["raised"] = np.array(str(e))
np.savez(os.path.join(tmp, "out%%d.npz" %% rank), **out)
pt.dist.shutdown()
''' % {"opt": OPT, "remat": {"True": True, "dots": "dots"}}


def _narrow_jax():
    from mxnet_tpu.models.resnet import residual_unit

    scope = {}
    exec(NET, scope)
    return scope["narrow"](mx, residual_unit)


def _case(tmp_path):
    rs = np.random.RandomState(11)
    net = _narrow_jax()
    n = BATCH * STEPS
    arg_shapes, _, aux_shapes = net.infer_shape(data=(BATCH,) + SHAPE)
    params, aux = {}, {}
    for name, s in zip(net.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            params[name] = rs.uniform(0.5, 1.5, s)
        elif name.endswith("_beta") or name.endswith("_bias"):
            params[name] = rs.uniform(-0.2, 0.2, s)
        else:
            params[name] = rs.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
    for name, s in zip(net.list_auxiliary_states(), aux_shapes):
        aux[name] = rs.uniform(0.5, 1.5, s) if name.endswith("_var") else rs.uniform(-0.1, 0.1, s)
    x = rs.uniform(-1, 1, (n,) + SHAPE).astype("f")
    y = rs.randint(0, 10, n).astype("f")
    params = {k: v.astype("f") for k, v in params.items()}
    aux = {k: v.astype("f") for k, v in aux.items()}
    np.savez(tmp_path / "case.npz", x=x, y=y, batch=BATCH,
             **{"p_" + k: v for k, v in params.items()},
             **{"a_" + k: v for k, v in aux.items()})
    return x, y, params, aux


def _launch(tmp_path, mode, timeout=240):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("MXNET_TELEMETRY", None)
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "launch.py"), "-n", "2", "--launcher", "local",
         "--cpu-devices", "1", sys.executable, str(script), mode, str(tmp_path)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    return [dict(np.load(tmp_path / ("out%d.npz" % r))) for r in range(2)]


def _jax_reference(x, y, params, aux, monkeypatch):
    """The JAX package's fused Module over [cpu(0), cpu(1)] on the whole
    batches, its conv+BN sites forced onto ``_conv_block_sharded``."""
    for k, v in FORCED.items():
        monkeypatch.setenv(k, v)
    it = mx.io.NDArrayIter(x, y, batch_size=BATCH)
    mod = mx.mod.Module(_narrow_jax(), context=[mx.cpu(0), mx.cpu(1)])
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=OPT,
            arg_params={k: mx.nd.array(v) for k, v in params.items()},
            aux_params={k: mx.nd.array(v) for k, v in aux.items()})
    assert mod._spmd is not None, "the JAX fused step did not engage"
    a, x_ = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()}, {k: v.asnumpy() for k, v in x_.items()},
            mod.get_outputs()[0].asnumpy())


def _jax_trainer_reference(x, y, params, aux, remat, monkeypatch):
    """The JAX package's ``SPMDTrainer`` under ``remat`` over [cpu(0),
    cpu(1)] on the whole batches, its conv+BN sites forced onto
    ``_conv_block_sharded``."""
    import jax

    for k, v in FORCED.items():
        monkeypatch.setenv(k, v)
    tr = mx.parallel.SPMDTrainer(
        _narrow_jax(), mx.parallel.make_mesh((2,), ("data",), jax.devices()[:2]),
        optimizer="sgd", optimizer_params=dict(OPT, rescale_grad=1.0 / BATCH), remat=remat)
    tr.set_params(params, aux)
    for b in range(len(x) // BATCH):
        outs = tr.step({"data": x[b * BATCH:(b + 1) * BATCH]},
                       {"softmax_label": y[b * BATCH:(b + 1) * BATCH]})
    w, a = tr.get_params()
    return ({k: np.asarray(v) for k, v in w.items()}, {k: np.asarray(v) for k, v in a.items()},
            np.asarray(outs[0]))


def _compare(outs, jw, jx, jprob, y, aux, what):
    """Both ranks hold the same state, within tolerance of JAX's; the
    moving stats moved; the last batch's loss agrees. Returns the errors."""
    errs = {"w": 0.0, "x": 0.0}
    for key, want_all in (("w", jw), ("x", jx)):
        for k, want in want_all.items():
            np.testing.assert_array_equal(outs[0][key + "_" + k], outs[1][key + "_" + k],
                                          err_msg=k)
            np.testing.assert_allclose(outs[0][key + "_" + k], want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
            errs[key] = max(errs[key], float(np.abs(outs[0][key + "_" + k] - want).max()))
    # the moving stats moved: the global moments, not a rank's own
    assert any(np.abs(jx[k] - aux[k]).max() > 1e-3 for k in jx)
    assert np.abs(jx["bn_head_moving_mean"] - aux["bn_head_moving_mean"]).max() > 1e-3
    prob = np.concatenate([outs[0]["prob"], outs[1]["prob"]])
    last = y[-BATCH:]
    np.testing.assert_allclose(_loss(prob, last), _loss(jprob, last), rtol=RTOL, atol=ATOL)
    errs["loss"] = abs(_loss(prob, last) - _loss(jprob, last))
    print("%s max abs err: weights %.3g, moving stats %.3g, loss %.3g"
          % (what, errs["w"], errs["x"], errs["loss"]))
    return errs


def _loss(prob, labels):
    return float(-np.mean(np.log(prob[np.arange(len(labels)), labels.astype(int)])))


def test_two_rank_sync_batchnorm_matches_jax_two_device_fused_step(tmp_path, monkeypatch):
    x, y, params, aux = _case(tmp_path)
    outs = _launch(tmp_path, "train")
    _compare(outs, *_jax_reference(x, y, params, aux, monkeypatch), y, aux, "sync_bn")


@pytest.mark.parametrize("remat", [True, "dots"])
def test_two_rank_sync_batchnorm_under_remat_matches_jax(tmp_path, monkeypatch, remat):
    """``SPMDTrainer(remat=...)`` across the two processes: the recompute
    that backward makes sums the statistics over the ranks as the forward
    did, so the weights and moving stats are JAX's remat trainer's."""
    x, y, params, aux = _case(tmp_path)
    outs = _launch(tmp_path, "remat=%s" % remat)
    _compare(outs, *_jax_trainer_reference(x, y, params, aux, remat, monkeypatch), y, aux,
             "sync_bn remat=%s" % remat)


def test_a_model_axis_across_processes_raises_naming_section_1_4c(tmp_path):
    _case(tmp_path)
    outs = _launch(tmp_path, "model_axis")
    for o in outs:
        msg = str(o["raised"])
        assert "a model axis across processes" in msg and "section 1.4c" in msg, msg


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_narrow_net_has_fused_sites_and_an_unfused_batchnorm(pkg):
    """The net exercises both paths: conv+BN directives with stats reuse,
    and a BatchNorm (on the data) whose input carries no kernel sums."""
    if pkg == "jax":
        net = _narrow_jax()
        from mxnet_tpu import fusion
    else:
        import mxnet_tpu_torch as pt
        from mxnet_tpu_torch import fusion
        from mxnet_tpu_torch.models.resnet import residual_unit

        scope = {}
        exec(NET, scope)
        net = scope["narrow"](pt, residual_unit)
    topo = net._topo()
    plan = fusion.plan(topo, output_ids={id(n) for n, _ in net._outputs})
    by_name = {n.name: plan.get(id(n)) for n in topo}
    assert by_name["bn_data"]["kind"] == "bn" and not by_name["bn_data"]["fold"]
    assert by_name["bn_head"] is None
    convs = [d for d in plan.values() if d["kind"] == "conv"]
    assert len(convs) == 10 and sum(d["defer"] for d in convs) == 3


def test_one_rank_group_gives_the_local_statistics(monkeypatch):
    """Over a one-rank gloo group the all_reduce copies: the sharded conv+BN
    site equals ``ConvBlock`` bitwise (outputs, sums, every gradient), and
    the unfused BatchNorm's path across processes (``output_mean_var``'s,
    autograd through the summed moments) equals the one-process op's
    hand-derived backward (rtol 1e-5, atol 1e-6)."""
    import torch
    import torch.distributed as tdist

    import mxnet_tpu_torch as pt
    from mxnet_tpu_torch import fusion
    from mxnet_tpu_torch.ops import conv_bn as cb
    from mxnet_tpu_torch.ops import nn as pnn
    from mxnet_tpu_torch.parallel.mesh import Mesh

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    tdist.init_process_group("gloo", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = Mesh(np.array([pt.cpu()], dtype=object), ("data",), 1, tdist.group.WORLD)
        x, w, res = randn(2, 16, 8, 8), randn(16, 16, 3, 3) * 0.1, randn(2, 16, 8, 8)
        scale, shift = randn(16).abs() + 0.5, randn(16) * 0.1
        cots = [randn(2, 16, 8, 8), randn(16), randn(16)]
        got = []
        for run in (lambda *a: fusion._conv_block_sharded(mesh, *a, (1, 1), True),
                    lambda *a: cb.ConvBlock.apply(*a, (1, 1), True)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, scale, shift, res)]
            outs = run(*leaves)
            got.append([o.detach() for o in outs]
                       + list(torch.autograd.grad(outs, leaves, grad_outputs=cots)))
        for a, b in zip(*got):
            assert torch.equal(a, b)
        gamma, beta = randn(16).abs() + 0.5, randn(16) * 0.1
        got = []
        for run in (lambda *a: pnn._batch_norm_across(mesh, *a, 1e-3, False),
                    lambda *a: pnn._BatchNormTrain.apply(*a, 1e-3, False)):
            leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
            outs = run(*leaves)
            got.append([o.detach() for o in outs]
                       + list(torch.autograd.grad(outs, leaves, grad_outputs=cots)))
        for a, b in zip(*got):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    finally:
        tdist.destroy_process_group()
    assert not tdist.is_initialized()
