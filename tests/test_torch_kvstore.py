"""The port's KVStore, bucket engine and several-context Module held
against the JAX package's.

* ``tests/test_module.py``'s three data-parallel gate cases
  (``test_module_multi_device_data_parallel``,
  ``test_module_multi_device_matches_single_device`` within rtol 1e-4,
  atol 1e-5, ``test_kvstore_local_semantics``) on BOTH packages (fixture
  ``mx``, the port inside ``with cpu():``), and the port's several contexts
  holding tensors of their own though every ``cpu(i)`` is one device.
* Every case of ``tests/test_kvstore_bucket.py`` on both packages:
  ``_group_kv``, the bucket plan, the env knobs, the flat kernels against
  the fused per-key ops (atol 1e-6), the digest windows (the world size
  faked to 2), the topological priorities and the prefetching iterator.
  ``reform`` re-arms the digest window in both packages.
* Optimizer states across packages: a state file the JAX store wrote,
  ``RowSparseState`` included, loads into the port's store, and the
  port's file goes back to the JAX store, every state equal.
"""
import importlib
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


def _mod(mx, name):
    return importlib.import_module(mx.__name__ + "." + name)


def _world2(mx, monkeypatch):
    """Fake a two-worker world for the digest checks."""
    if mx is mxnet_tpu:
        import jax

        monkeypatch.setattr(jax, "process_count", lambda: 2)
    else:
        monkeypatch.setattr(pt.dist, "num_workers", lambda: 2)


# ----------------------------------------- tests/test_module.py's 1.4 gate
def _synthetic_classification(n=600, n_features=20, n_classes=5, seed=7):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-3, 3, (n_classes, n_features)).astype("f")
    y = rs.randint(0, n_classes, n)
    x = centers[y] + rs.normal(0, 0.3, (n, n_features)).astype("f")
    return x.astype("f"), y.astype("f")


def mlp_symbol(mx, num_classes=5):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=64, name="fc1")
    net = mx.sym.Activation(data=net, act_type="relu")
    net = mx.sym.FullyConnected(data=net, num_hidden=num_classes, name="fc2")
    return mx.sym.SoftmaxOutput(data=net, name="softmax")


def test_module_multi_device_data_parallel(mx):
    x, y = _synthetic_classification(n=400)
    ctxs = [mx.cpu(i) for i in range(4)]
    train = mx.io.NDArrayIter(x, y, batch_size=40, shuffle=True)
    mod = mx.mod.Module(mlp_symbol(mx), context=ctxs)
    mod.fit(train, optimizer="sgd", optimizer_params=(("learning_rate", 0.1),), num_epoch=4)
    score = mod.score(mx.io.NDArrayIter(x, y, batch_size=40), "acc")
    assert score[0][1] > 0.9


def test_module_multi_device_matches_single_device(mx):
    x, y = _synthetic_classification(n=40, seed=3)
    batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)], pad=0, index=None)
    results = []
    for ctxs in ([mx.cpu(0)], [mx.cpu(i) for i in range(4)]):
        mx.random.seed(11)
        mod = mx.mod.Module(mlp_symbol(mx), context=ctxs)
        mod.bind(data_shapes=[("data", (40, 20))], label_shapes=[("softmax_label", (40,))])
        mod.init_params(initializer=mx.init.Xavier())
        mod.init_optimizer(optimizer="sgd", optimizer_params=(("learning_rate", 0.5),))
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        args, _ = mod.get_params()
        results.append({k: v.asnumpy() for k, v in args.items()})
    for k in results[0]:
        assert np.allclose(results[0][k], results[1][k], rtol=1e-4, atol=1e-5), k


def test_kvstore_local_semantics(mx):
    shape = (4, 4)
    kv = mx.kv.create("local")
    kv.init(3, mx.nd.zeros(shape))
    kv.push(3, mx.nd.ones(shape))
    out = mx.nd.zeros(shape)
    kv.pull(3, out=out)
    assert np.allclose(out.asnumpy(), 1.0)
    vals = [mx.nd.ones(shape) for _ in range(4)]
    kv.push(3, vals)
    kv.pull(3, out=out)
    assert np.allclose(out.asnumpy(), 4.0)
    kv2 = mx.kv.create("local")
    kv2.init(9, mx.nd.ones(shape))
    opt = mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0)
    kv2.set_optimizer(opt)
    kv2.push(9, [mx.nd.ones(shape)] * 2)  # grad sum = 2
    kv2.pull(9, out=out)
    assert np.allclose(out.asnumpy(), 1.0 - 0.1 * 2.0)


def test_each_context_holds_its_own_tensors():
    """Every cpu(i) is one torch device: the per-context parameters,
    gradients and inputs are still distinct tensors, so a parity test
    cannot pass by two executors sharing one."""
    with pt.cpu():
        mod = pt.mod.Module(mlp_symbol(pt), context=[pt.cpu(0), pt.cpu(1), pt.cpu(2)])
        mod.bind(data_shapes=[("data", (12, 20))], label_shapes=[("softmax_label", (12,))])
        mod.init_params()
    group = mod._exec_group
    for per_ctx in group.param_arrays + group.grad_arrays + group.data_arrays:
        assert len({id(a) for a in per_ctx}) == 3
        assert len({a._tensor().data_ptr() for a in per_ctx}) == 3
    assert [a.shape[0] for a in group.data_arrays[0]] == [4, 4, 4]
    assert [a.context for a in group.param_arrays[0]] == [pt.cpu(0), pt.cpu(1), pt.cpu(2)]


def test_multi_context_optimizer_states_match_jax_key_for_key():
    """Without a store update (kvstore 'local' over two contexts), the
    updater is keyed ``index * num_device + k`` as in the JAX package:
    the same keys, the same momentum, state for state (rtol 1e-4, atol
    1e-5). The JAX side runs its per-device path over cpu(0) twice: that
    path's ``nd.add_n`` cannot sum arrays of two distinct devices."""
    x, y = _synthetic_classification(n=40, seed=5)
    rs = np.random.RandomState(2)
    params = {"fc1_weight": rs.randn(64, 20).astype("f") * 0.1,
              "fc1_bias": np.zeros(64, "f"),
              "fc2_weight": rs.randn(5, 64).astype("f") * 0.1,
              "fc2_bias": np.zeros(5, "f")}
    states = []
    for mx in (mxnet_tpu, pt):
        with (pt.cpu() if mx is pt else _Null()):
            ctxs = [mx.cpu(0), mx.cpu(1)] if mx is pt else [mx.cpu(0), mx.cpu(0)]
            mod = mx.mod.Module(mlp_symbol(mx), context=ctxs, fused_step=False)
            mod.bind(data_shapes=[("data", (40, 20))], label_shapes=[("softmax_label", (40,))])
            mod.init_params(arg_params={k: mx.nd.array(v) for k, v in params.items()})
            mod.init_optimizer(kvstore="local", optimizer="sgd",
                               optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
            assert mod._update_on_kvstore is False
            batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)], pad=0,
                                    index=None)
            for _ in range(2):
                mod.forward_backward(batch)
                mod.update()
            states.append({k: v.asnumpy() for k, v in mod._updater.states.items()})
    assert sorted(states[0]) == sorted(states[1]) == list(range(8))
    for k in states[0]:
        np.testing.assert_allclose(states[1][k], states[0][k], rtol=1e-4, atol=1e-5)


def test_multi_context_fused_step_matches_jax():
    """The same two steps over the distinct contexts [cpu(0), cpu(1)] in
    both packages, fused step on (the default there): the weights and the
    momentum within rtol 2e-4, atol 2e-5 (the fused step's tolerance,
    ``tests/test_module_spmd.py``)."""
    x, y = _synthetic_classification(n=40, seed=5)
    rs = np.random.RandomState(2)
    params = {"fc1_weight": rs.randn(64, 20).astype("f") * 0.1,
              "fc1_bias": np.zeros(64, "f"),
              "fc2_weight": rs.randn(5, 64).astype("f") * 0.1,
              "fc2_bias": np.zeros(5, "f")}
    got = []
    for mx in (mxnet_tpu, pt):
        with (pt.cpu() if mx is pt else _Null()):
            mod = mx.mod.Module(mlp_symbol(mx), context=[mx.cpu(0), mx.cpu(1)])
            mod.bind(data_shapes=[("data", (40, 20))], label_shapes=[("softmax_label", (40,))])
            mod.init_params(arg_params={k: mx.nd.array(v) for k, v in params.items()})
            mod.init_optimizer(kvstore="local", optimizer="sgd",
                               optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
            assert mod._spmd is not None
            batch = mx.io.DataBatch(data=[mx.nd.array(x)], label=[mx.nd.array(y)], pad=0,
                                    index=None)
            for _ in range(2):
                mod.forward_backward(batch)
                mod.update()
            mom = mod._spmd.trainer.opt_state["mom"]
            got.append(({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                        {k: np.asarray(v) if mx is mxnet_tpu else v.numpy()
                         for k, v in mom.items()}))
    for (j, p) in zip(*got):
        for k in j:
            np.testing.assert_allclose(p[k], j[k], rtol=2e-4, atol=2e-5, err_msg=k)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ---------------------------------------------------------------- _group_kv
def test_group_kv_single_key_single_value(mx):
    keys, grouped = _mod(mx, "kvstore")._group_kv("w", mx.nd.ones((2,)))
    assert keys == ["w"] and len(grouped) == 1 and len(grouped[0]) == 1


def test_group_kv_single_key_list_value(mx):
    vals = [mx.nd.ones((2,)), mx.nd.ones((2,))]
    keys, grouped = _mod(mx, "kvstore")._group_kv("w", vals)
    assert keys == ["w"]
    assert len(grouped) == 1 and len(grouped[0]) == 2


def test_group_kv_parallel_lists(mx):
    keys, grouped = _mod(mx, "kvstore")._group_kv([3, 5], [mx.nd.ones((2,)), mx.nd.zeros((2,))])
    assert keys == [3, 5]
    assert all(len(g) == 1 for g in grouped)


def test_group_kv_nested_per_device_lists(mx):
    keys, grouped = _mod(mx, "kvstore")._group_kv(
        [3, 5], [[mx.nd.ones((2,))] * 3, [mx.nd.zeros((2,))] * 2])
    assert keys == [3, 5]
    assert [len(g) for g in grouped] == [3, 2]


def test_group_kv_duplicate_keys(mx):
    keys, grouped = _mod(mx, "kvstore")._group_kv([7, 7], [mx.nd.ones((2,)), mx.nd.ones((2,))])
    assert keys == [7, 7]
    assert len(grouped) == 2


# --------------------------------------------------------------- BucketPlan
RECORDS = [("fc3_w", (4, 32), "float32", 0), ("fc3_b", (4,), "float32", 0),
           ("fc2_w", (32, 64), "float32", -1), ("fc2_b", (32,), "float32", -1),
           ("fc1_w", (64, 8), "float32", -2), ("fc1_b", (64,), "float32", -2)]


def test_plan_deterministic(mx):
    plan = _mod(mx, "kvstore_bucket").BucketPlan
    a = plan.build(RECORDS, n_workers=8, bucket_cap=4096)
    b = plan.build(list(RECORDS), n_workers=8, bucket_cap=4096)
    assert a.hash == b.hash
    assert a.describe() == b.describe()


def test_plan_order_sensitivity(mx):
    plan = _mod(mx, "kvstore_bucket").BucketPlan
    a = plan.build(RECORDS, n_workers=8, bucket_cap=4096)
    b = plan.build(list(reversed(RECORDS)), n_workers=8, bucket_cap=4096)
    assert a.hash != b.hash


def test_plan_packing_and_padding(mx):
    plan = _mod(mx, "kvstore_bucket").BucketPlan.build(RECORDS, n_workers=8, bucket_cap=4096)
    seen = [(s.key, s.part) for b in plan.buckets for s in b.slots]
    assert len(seen) == len(set(seen))
    assert {k for k, _ in seen} == {r[0] for r in RECORDS}
    for b in plan.buckets:
        assert b.total % 8 == 0
        used = sum(s.size for s in b.slots)
        assert b.total - used == b.pad < 8
        off = 0
        for s in b.slots:
            assert s.offset == off
            off += s.size


def test_plan_respects_cap(mx):
    plan = _mod(mx, "kvstore_bucket").BucketPlan.build(RECORDS, n_workers=2, bucket_cap=1024)
    assert len(plan.buckets) > 1
    for b in plan.buckets:
        if len(b.slots) > 1:
            assert sum(s.size for s in b.slots) * 4 <= 1024


def test_plan_splits_oversize_key(mx):
    plan = _mod(mx, "kvstore_bucket").BucketPlan.build(
        [("big", (3000,), "float32", 0), ("tail", (10,), "float32", -1)],
        n_workers=2, bucket_cap=4096)
    parts = plan.key_to_slots["big"]
    assert len(parts) == 3
    assert [s.part for _, s in parts] == [0, 1, 2]
    assert [s.src_off for _, s in parts] == [0, 1024, 2048]
    assert sum(s.size for _, s in parts) == 3000
    assert plan.key_to_slots["tail"][0][0].index == parts[-1][0].index


def test_plan_groups_by_dtype(mx):
    plan = _mod(mx, "kvstore_bucket").BucketPlan.build(
        [("a", (8,), "float32", 0), ("b", (8,), "float64", 0), ("c", (8,), "float32", 0)],
        n_workers=2, bucket_cap=10**6)
    assert {b.dtype for b in plan.buckets} == {"float32", "float64"}
    for b in plan.buckets:
        assert all(s.dtype == b.dtype for s in b.slots)


def test_plans_of_both_packages_are_the_same(monkeypatch):
    """The port's plan is the JAX package's, slot for slot and hash for
    hash, with and without the bf16 wire."""
    for env in ("", "bf16"):
        monkeypatch.setenv("MXNET_KVSTORE_COMM_DTYPE", env)
        for cap in (1024, 4096, 10**6):
            a = mxnet_tpu.kvstore_bucket.BucketPlan.build(RECORDS, n_workers=4, bucket_cap=cap)
            b = pt.kvstore_bucket.BucketPlan.build(RECORDS, n_workers=4, bucket_cap=cap)
            assert a.describe() == b.describe()


# ------------------------------------------------------------------ env knobs
def test_bucket_bytes_env(mx, monkeypatch):
    bucket_bytes = _mod(mx, "kvstore_bucket").bucket_bytes
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_MB", "4")
    assert bucket_bytes() == 4_000_000
    monkeypatch.setenv("MXNET_KVSTORE_BUCKET_MB", "not-a-number")
    assert bucket_bytes() == 25_000_000
    monkeypatch.delenv("MXNET_KVSTORE_BUCKET_MB")
    assert bucket_bytes() == 25_000_000


def test_update_mode_env(mx, monkeypatch):
    update_mode = _mod(mx, "kvstore_bucket").update_mode
    monkeypatch.setenv("MXNET_KVSTORE_UPDATE", "sharded")
    assert update_mode() == "sharded"
    monkeypatch.setenv("MXNET_KVSTORE_UPDATE", "bogus")
    assert update_mode() == "replicated"
    monkeypatch.delenv("MXNET_KVSTORE_UPDATE")
    assert update_mode() == "replicated"


def test_comm_dtype_env(mx, monkeypatch):
    comm_dtype_for = _mod(mx, "kvstore_bucket").comm_dtype_for
    monkeypatch.delenv("MXNET_KVSTORE_COMM_DTYPE", raising=False)
    assert comm_dtype_for("float32") == "float32"
    monkeypatch.setenv("MXNET_KVSTORE_COMM_DTYPE", "bf16")
    assert comm_dtype_for("float32") == "bfloat16"
    assert comm_dtype_for("float64") == "float64"
    assert comm_dtype_for("int32") == "int32"


def test_bf16_plan_halves_comm_bytes(mx, monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_COMM_DTYPE", "bf16")
    plan = _mod(mx, "kvstore_bucket").BucketPlan.build([("a", (1000,), "float32", 0)],
                                                       n_workers=2, bucket_cap=10**6)
    b = plan.buckets[0]
    assert b.comm_dtype == "bfloat16" and b.dtype == "float32"


# ------------------------------------------------------- flat kernel parity
def _vec(mx, x):
    if mx is mxnet_tpu:
        import jax.numpy as jnp

        return jnp.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_flat_sgd_matches_fused_op(mx, momentum):
    rs = np.random.RandomState(3)
    w0 = rs.rand(64).astype("float32")
    g = (rs.rand(64).astype("float32") - 0.5)
    lr, wd, rescale = 0.05, 1e-4, 1.0 / 16
    opt = mx.optimizer.SGD(learning_rate=lr, momentum=momentum, wd=wd, rescale_grad=rescale,
                           clip_gradient=0.4)
    kind, hyper, n_states = opt.flat_update_spec()
    assert kind == "sgd" and n_states == (1 if momentum else 0)
    kernel = _mod(mx, "kvstore_bucket")._FLAT_KERNELS[kind](hyper)
    upd = mx.optimizer.get_updater(opt)
    w_ref = mx.nd.array(w0.copy())
    for _ in range(3):
        upd(0, mx.nd.array(g), w_ref)
    w = _vec(mx, w0)
    states = (_vec(mx, np.zeros(64, "float32")),) * n_states
    lrv = _vec(mx, np.full((64,), lr, "float32"))
    wdv = _vec(mx, np.full((64,), wd, "float32"))
    for _ in range(3):
        w, states = kernel(w, _vec(mx, g), states, lrv, wdv)
    np.testing.assert_allclose(np.asarray(w), w_ref.asnumpy(), atol=1e-6)


def test_flat_adam_matches_fused_op(mx):
    import math

    rs = np.random.RandomState(4)
    w0 = rs.rand(32).astype("float32")
    g = (rs.rand(32).astype("float32") - 0.5)
    opt = mx.optimizer.Adam(learning_rate=0.01, wd=1e-3, rescale_grad=0.125)
    kind, hyper, n_states = opt.flat_update_spec()
    assert kind == "adam" and n_states == 2
    kernel = _mod(mx, "kvstore_bucket")._FLAT_KERNELS[kind](hyper)
    upd = mx.optimizer.get_updater(opt)
    w_ref = mx.nd.array(w0.copy())
    for _ in range(3):
        upd(0, mx.nd.array(g), w_ref)
    w = _vec(mx, w0)
    states = (_vec(mx, np.zeros(32, "float32")), _vec(mx, np.zeros(32, "float32")))
    wdv = _vec(mx, np.full((32,), 1e-3, "float32"))
    for t in range(1, 4):
        lr_t = 0.01 * math.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        w, states = kernel(w, _vec(mx, g), states, _vec(mx, np.full((32,), lr_t, "float32")),
                           wdv)
    np.testing.assert_allclose(np.asarray(w), w_ref.asnumpy(), atol=1e-6)


def test_flat_spec_absent_where_math_differs(mx):
    assert mx.optimizer.NAG(momentum=0.9).flat_update_spec() is None
    assert mx.optimizer.RMSProp().flat_update_spec() is None
    assert mx.optimizer.create("ccsgd").flat_update_spec() is not None


# -------------------------------------------------- key-set mismatch raise
def _fake_digests(mx, monkeypatch, delta):
    eng_cls = _mod(mx, "kvstore_bucket").BucketEngine
    monkeypatch.setattr(eng_cls, "_allgather_digest", staticmethod(
        lambda arr: np.array([arr[0], arr[0] + delta], dtype=np.asarray(arr).dtype)))
    return eng_cls


def test_key_mismatch_raises(mx, monkeypatch):
    _world2(mx, monkeypatch)
    eng_cls = _fake_digests(mx, monkeypatch, 1)
    eng = eng_cls.__new__(eng_cls)
    eng._check_rounds = 3
    with pytest.raises(mx.base.MXNetError, match="disagree on the pushed key"):
        eng._verify_across_workers("round:[('w1', (4,), 'float32')]")


def test_key_match_passes(mx, monkeypatch):
    _world2(mx, monkeypatch)
    eng_cls = _fake_digests(mx, monkeypatch, 0)
    eng = eng_cls.__new__(eng_cls)
    eng._check_rounds = 3
    eng._verify_across_workers("round:[('w1', (4,), 'float32')]")


def _digest_eng(mx, monkeypatch, delta):
    _world2(mx, monkeypatch)
    eng_cls = _fake_digests(mx, monkeypatch, delta)
    eng = eng_cls.__new__(eng_cls)
    eng._check_rounds = 2
    eng._rounds_done = 0
    eng._round_flushes = []
    eng._ticked = set()
    return eng


def _close_one_round(eng):
    eng._round_t0 = 1.0
    eng._round_seq = [("w1", (4,), "float32")]
    eng._round_flushes = []
    eng._close_round()


def test_digest_window_closes_then_rearms(mx, monkeypatch):
    eng = _digest_eng(mx, monkeypatch, delta=1)
    eng._rounds_done = eng._check_rounds
    _close_one_round(eng)
    eng.rearm_verify()
    assert eng._rounds_done == 0
    with pytest.raises(mx.base.MXNetError, match="disagree on the pushed key"):
        _close_one_round(eng)


def test_digest_window_counts_rounds(mx, monkeypatch):
    eng = _digest_eng(mx, monkeypatch, delta=0)
    for _ in range(5):
        _close_one_round(eng)
    assert eng._rounds_done == 5
    _fake_digests(mx, monkeypatch, 1)
    _close_one_round(eng)
    eng.rearm_verify()
    with pytest.raises(mx.base.MXNetError, match="disagree on the pushed key"):
        _close_one_round(eng)


def test_monolithic_push_round_verify_and_rearm(mx, monkeypatch):
    kv_cls = _mod(mx, "kvstore").KVStore
    eng_cls = _mod(mx, "kvstore_bucket").BucketEngine
    kv = kv_cls.__new__(kv_cls)
    kv._type = "dist_sync"
    kv._verify_rounds_done = 0
    kv._verify_check_rounds = None
    kv._bucket_engine = None
    _world2(mx, monkeypatch)
    monkeypatch.setattr(eng_cls, "_env_check_rounds", staticmethod(lambda: 2))
    _fake_digests(mx, monkeypatch, 0)
    kv._verify_push_round(["w1", "w2"])
    kv._verify_push_round(["w1", "w2"])
    _fake_digests(mx, monkeypatch, 1)
    kv._verify_push_round(["w1", "w2"])  # window spent, silent
    kv.rearm_verify()
    with pytest.raises(mx.base.MXNetError, match="disagree on the pushed key"):
        kv._verify_push_round(["w1", "w2"])


def test_kvstore_rearm_propagates_to_engine(mx):
    class _Eng:
        rearmed = 0

        def rearm_verify(self):
            self.rearmed += 1

    kv_cls = _mod(mx, "kvstore").KVStore
    kv = kv_cls.__new__(kv_cls)
    kv._verify_rounds_done = 9
    kv._verify_check_rounds = 3
    kv._bucket_engine = _Eng()
    kv.rearm_verify()
    assert kv._verify_rounds_done == 0
    assert kv._bucket_engine.rearmed == 1


def test_reform_rearms_digest_window_or_raises_naming_the_next_item(mx, monkeypatch):
    """After an elastic reform the survivors must re-prove push-stream
    agreement: reform() re-opens the digest window in both packages (the
    port's raised until ROADMAP.md section 1.4b step 3 landed)."""
    kv_cls = _mod(mx, "kvstore").KVStore
    kv = kv_cls.__new__(kv_cls)
    kv._type = "dist_sync"
    kv._verify_rounds_done = 7
    kv._verify_check_rounds = 3
    kv._bucket_engine = None
    monkeypatch.setattr(kv_cls, "_set_elastic_state", lambda self, state: None)
    kv.reform()
    assert kv._verify_rounds_done == 0


# ---------------------------------------------------------- topo priorities
def test_param_priorities_follow_topo_order(mx):
    sym = mx.sym.Variable("data")
    sym = mx.sym.FullyConnected(sym, num_hidden=8, name="fc1")
    sym = mx.sym.Activation(sym, act_type="relu")
    sym = mx.sym.FullyConnected(sym, num_hidden=4, name="fc2")
    sym = mx.sym.SoftmaxOutput(sym, name="softmax")
    mod = mx.mod.Module(sym, context=mx.cpu(), fused_step=False)
    mod.bind([("data", (2, 16))], [("softmax_label", (2,))])
    prios = mod._exec_group.param_priorities
    names = mod._exec_group.param_names
    assert sorted(prios) == list(range(len(names)))
    assert sorted(prios.values()) == [-i for i in reversed(range(len(names)))]
    by_name = {names[i]: p for i, p in prios.items()}
    assert by_name["fc1_weight"] > by_name["fc2_weight"]


# ------------------------------------------------ PrefetchingIter satellite
def _blocking_iter(mx):
    class _BlockingIter(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=2)
            self.provide_data = [mx.io.DataDesc("data", (2, 2))]
            self.provide_label = [mx.io.DataDesc("softmax_label", (2,))]
            self._n = 0
            self.release = threading.Event()

        def next(self):
            self._n += 1
            if self._n > 1:
                self.release.wait()
                raise StopIteration
            # the pump thread does not inherit the test's default context
            return mx.io.DataBatch(data=[mx.nd.zeros((2, 2), ctx=mx.cpu())],
                                   label=[mx.nd.zeros((2,), ctx=mx.cpu())], pad=0, index=None)

        def reset(self):
            pass

    return _BlockingIter()


def test_prefetching_iter_wedged_pump_raises_and_latches(mx):
    child = _blocking_iter(mx)
    pf = mx.io.PrefetchingIter(child, shutdown_timeout=0.3)
    assert pf.iter_next()
    time.sleep(0.05)
    with pytest.raises(mx.base.MXNetError, match="pump thread"):
        pf.reset()
    with pytest.raises(mx.base.MXNetError, match="wedged"):
        pf.iter_next()
    with pytest.raises(mx.base.MXNetError, match="wedged"):
        pf.reset()
    child.release.set()


def test_prefetching_iter_normal_epoch_cycle(mx):
    data = np.arange(24, dtype="float32").reshape(12, 2)
    labels = np.zeros((12,), "float32")
    pf = mx.io.PrefetchingIter(mx.io.NDArrayIter(data, labels, batch_size=4))
    for _ in range(2):
        assert sum(1 for _ in pf) == 3
        pf.reset()


# ------------------------------------------ optimizer states across packages
def _sparse_state_store(mx, w0, rounds, dense_key_vals):
    """A local store with an Adam updater, one row-sparse key pushed through
    ``rounds`` and one dense key pushed once."""
    sp = _mod(mx, "sparse")
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=0.01))
    kv.init("emb", mx.nd.array(w0))
    kv.init(1, mx.nd.array(dense_key_vals[0]))
    for rows, vals in rounds:
        kv.push("emb", sp.row_sparse_array((vals, rows), w0.shape))
    kv.push(1, mx.nd.array(dense_key_vals[1]))
    return kv


def test_optimizer_states_cross_packages(tmp_path):
    rs = np.random.RandomState(21)
    w0 = rs.rand(20, 4).astype("f")
    rounds = [(np.array([2, 5]), rs.rand(2, 4).astype("f")),
              (np.array([5, 11]), rs.rand(2, 4).astype("f"))]
    dense = (rs.rand(3, 3).astype("f"), rs.rand(3, 3).astype("f"))
    jkv = _sparse_state_store(mxnet_tpu, w0, rounds, dense)
    jfile = str(tmp_path / "jax.states")
    jkv.save_optimizer_states(jfile)

    with pt.cpu():
        pkv = pt.kv.create("local")
        pkv.set_optimizer(pt.optimizer.Adam(learning_rate=0.01))
        pkv.init("emb", pt.nd.array(w0))
        pkv.init(1, pt.nd.array(dense[0]))
        pkv.load_optimizer_states(jfile)
    st = pkv._updater.states
    assert isinstance(st["emb"], pt.sparse.RowSparseState)
    np.testing.assert_array_equal(st["emb"].indices, jkv._updater.states["emb"].indices)
    for a, b in zip(st["emb"].rows, jkv._updater.states["emb"].rows):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(st[1], jkv._updater.states[1]):
        assert a.context == pt.cpu()
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())

    # and back: the port's file, read as numpy, seeds the JAX store
    pfile = str(tmp_path / "port.states")
    pkv.save_optimizer_states(pfile)
    with open(pfile, "rb") as f:
        back = pt.convert.updater_states_to_numpy(pt.convert.load_states(f.read()))
    jkv2 = mxnet_tpu.kv.create("local")
    jkv2.set_optimizer(mxnet_tpu.optimizer.Adam(learning_rate=0.01))
    jkv2._updater.states = {
        k: (mxnet_tpu.sparse.RowSparseState.__new__(mxnet_tpu.sparse.RowSparseState)
            if isinstance(v, pt.sparse.RowSparseState) else
            tuple(mxnet_tpu.nd.array(x) for x in v)) for k, v in back.items()}
    jkv2._updater.states["emb"].__setstate__(back["emb"].__getstate__())
    blob = pickle.loads(jkv2._updater.get_states())
    np.testing.assert_array_equal(blob["emb"].indices, jkv._updater.states["emb"].indices)
    for a, b in zip(blob[1], jkv._updater.states[1]):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert type(blob["emb"]).__module__ == "mxnet_tpu.sparse"


def test_sharded_and_elastic_store_features_raise_naming_the_next_item(tmp_path):
    """The sharded checkpoint and the elastic state machine landed with
    ROADMAP.md section 1.4b steps 2-3: a local store runs them (its reform
    is a no-op, a load of a missing set raises the reference's structured
    error, the elastic calls outside an elastic job raise as in the
    reference); what still raises names section 1.4b step 4."""
    kv = pt.kv.create("local")
    kv.set_optimizer(pt.optimizer.SGD(learning_rate=0.1))
    assert kv.elastic_state == "running"
    kv.reform()
    assert kv.elastic_state == "running"
    with pytest.raises(pt.MXNetError, match="no COMPLETE sharded checkpoint"):
        kv.load_sharded_checkpoint(str(tmp_path / "nonexistent"))
    with pytest.raises(pt.MXNetError, match="no readable manifest"):
        kv._load_sharded_states("f", {"dir": str(tmp_path), "step": 3})
    kv._seed_sparse_states(str(tmp_path), 0, {})  # no sparse section: nothing to seed
    assert pt.dist.members() is None and pt.dist.generation() == 0
    assert pt.dist.orig_rank() is None
    for name in ("coordination_client", "poll_pause"):
        with pytest.raises(pt.MXNetError, match="elastic job"):
            getattr(pt.dist, name)()
    with pytest.raises(pt.MXNetError, match="section 1.4b"):
        pt.mod.executor_group.PipelineExecutorGroup(None, None, [])


# ---------------------------------------------- FeedForward, heartbeat, convert
def test_feedforward_over_two_contexts_and_a_store_matches_jax(monkeypatch):
    """``FeedForward`` over ``[cpu(0), cpu(1)]`` with a local KVStore object
    (the store runs the optimizer) trains to the JAX package's one-context
    ``FeedForward`` within rtol 1e-4, atol 1e-5, from the same numpy
    weights over the same unshuffled batches."""
    x, y = _synthetic_classification(n=60, seed=9)
    rs = np.random.RandomState(4)
    params = {"fc1_weight": rs.randn(64, 20).astype("f") * 0.1, "fc1_bias": np.zeros(64, "f"),
              "fc2_weight": rs.randn(5, 64).astype("f") * 0.1, "fc2_bias": np.zeros(5, "f")}
    got = {}
    # the per-device path: the port's distinct contexts would otherwise
    # engage the fused step (JAX's one context takes the per-device path)
    monkeypatch.setenv("MXNET_MODULE_FUSED_STEP", "0")
    for mx in (mxnet_tpu, pt):
        with pt.cpu() if mx is pt else _Null():
            it = mx.io.NDArrayIter(x, y, batch_size=20)
            ctx = [mx.cpu(0), mx.cpu(1)] if mx is pt else [mx.cpu(0)]
            ff = mx.model.FeedForward(mlp_symbol(mx), ctx=ctx, num_epoch=2, optimizer="sgd",
                                      learning_rate=0.1, momentum=0.9,
                                      arg_params={k: mx.nd.array(v) for k, v in params.items()})
            kv = mx.kv.create("local")
            ff.fit(it, kvstore=kv)
            if mx is pt:
                assert ff._module._kvstore is kv and ff._module._update_on_kvstore
            got[mx.__name__] = {k: v.asnumpy() for k, v in ff.arg_params.items()}
    for k, want in got["mxnet_tpu"].items():
        np.testing.assert_allclose(got["mxnet_tpu_torch"][k], want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)



def test_feedforward_over_two_contexts_fused_matches_jax():
    """``FeedForward`` over ``[cpu(0), cpu(1)]`` in both packages, which
    both run the fused step there: the weights within rtol 2e-4, atol 2e-5."""
    x, y = _synthetic_classification(n=60, seed=9)
    rs = np.random.RandomState(4)
    params = {"fc1_weight": rs.randn(64, 20).astype("f") * 0.1, "fc1_bias": np.zeros(64, "f"),
              "fc2_weight": rs.randn(5, 64).astype("f") * 0.1, "fc2_bias": np.zeros(5, "f")}
    got = {}
    for mx in (mxnet_tpu, pt):
        with (pt.cpu() if mx is pt else _Null()):
            it = mx.io.NDArrayIter(x, y, batch_size=20)
            ff = mx.model.FeedForward(mlp_symbol(mx), ctx=[mx.cpu(0), mx.cpu(1)], num_epoch=2,
                                      optimizer="sgd", learning_rate=0.1, momentum=0.9,
                                      arg_params={k: mx.nd.array(v) for k, v in params.items()})
            ff.fit(it, kvstore="local")
            assert ff._module._spmd is not None
            got[mx.__name__] = {k: v.asnumpy() for k, v in ff.arg_params.items()}
    for k, want in got["mxnet_tpu"].items():
        np.testing.assert_allclose(got["mxnet_tpu_torch"][k], want, rtol=2e-4, atol=2e-5,
                                   err_msg=k)

def test_heartbeat_scan_matches_jax(tmp_path, monkeypatch):
    """``dist.num_dead_nodes`` and ``dead_members`` over the launcher's
    heartbeat files: a fresh file is alive, a stale one dead, a missing
    one alive inside the startup grace and dead after it, in both
    packages."""
    import os

    monkeypatch.setenv("MXNET_TPU_HEARTBEAT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_TPU_NUM_WORKERS", "3")
    (tmp_path / "worker-0").write_text("")
    (tmp_path / "worker-1").write_text("")
    old = time.time() - 120
    os.utime(tmp_path / "worker-1", (old, old))
    for dist in (mxnet_tpu.dist, pt.dist):
        assert dist.num_dead_nodes(timeout=60, startup_grace=1e6) == 1
        assert dist.dead_members(timeout=60, startup_grace=1e6) == [1]
        assert dist.num_dead_nodes(timeout=60, startup_grace=0) == 2
        assert dist.dead_timeout_seconds() == 60.0
        assert not dist.is_heartbeating()
    kv = pt.kv.KVStore("dist_sync")
    assert kv.num_dead_nodes(timeout=60, startup_grace=1e6) == 1
    assert pt.kv.KVStore("local").num_dead_nodes() == 0


def test_updater_states_from_numpy_carries_a_row_sparse_state():
    """A JAX ``RowSparseState`` (indices and rows as numpy) crosses into the
    port's as it is; dense states become NDArrays on the context."""
    st = mxnet_tpu.sparse.RowSparseState((10, 4), "float32", 2)
    st.scatter(np.array([2, 7]), [np.ones((2, 4), "f"), np.full((2, 4), 3.0, "f")])
    out = pt.updater_states_from_numpy({0: st, 1: (np.ones(3, "f"), None)}, pt.cpu())
    assert isinstance(out[0], pt.sparse.RowSparseState)
    np.testing.assert_array_equal(out[0].indices, [2, 7])
    np.testing.assert_array_equal(out[0].rows[1], np.full((2, 4), 3.0, "f"))
    assert out[1][0].context == pt.cpu() and out[1][1] is None
    assert pt.convert.updater_states_to_numpy(out)[0] is out[0]
