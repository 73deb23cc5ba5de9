"""The port's row-sparse subsystem held against the JAX package's.

Every case of the reference's own ``tests/test_sparse.py`` runs here on
BOTH packages (fixture ``mx``, the port inside ``with cpu():``), the four
that need ``analysis/`` or ``parallel/`` (the shard-rule category, the
GL405 hint, autoplan, the lint of the zoo entry) included: the zoo entry's
lint takes its shapes from each package's own ``graphlint`` CLI table
(``analysis/cli.py``; the port's equals JAX's). Then the recommender: ``get_symbol`` gives
the JAX builder's JSON under both names, and one ``Module.fit`` step at
batch 64 through a ``local`` KVStore object, from the same numpy weights
and batch, gives the same weights and the same sparse optimizer states in
both packages (rtol 1e-5, atol 1e-6), over one context and over two.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

V, D = 20, 4
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


def _sp(mx):
    return importlib.import_module(mx.__name__ + ".sparse")


def _rsp(mx, rs, rows, scale=1.0):
    rows = np.asarray(sorted(set(rows)), np.int64)
    vals = (rs.rand(rows.size, D).astype("float32") - 0.5) * scale
    return _sp(mx).row_sparse_array((vals, rows), (V, D)), rows, vals


# ------------------------------------------------------------ storage kind
def test_roundtrip_to_dense_from_dense(mx):
    rs = np.random.RandomState(0)
    r, rows, vals = _rsp(mx, rs, [3, 7, 11])
    dense = r.to_dense()
    assert dense.shape == (V, D)
    np.testing.assert_array_equal(dense.asnumpy()[rows], vals)
    back = _sp(mx).from_dense(dense)
    np.testing.assert_array_equal(back.indices.asnumpy(), rows)
    np.testing.assert_array_equal(back.values.asnumpy(), vals)


def test_from_dense_with_row_hint_skips_scan(mx):
    rs = np.random.RandomState(1)
    dense = mx.nd.array(rs.rand(V, D).astype("float32"))
    r = _sp(mx).from_dense(dense, rows=[5, 2, 5])
    assert r.indices.asnumpy().tolist() == [2, 5]
    np.testing.assert_array_equal(r.values.asnumpy(), dense.asnumpy()[[2, 5]])


def test_retain(mx):
    rs = np.random.RandomState(2)
    r, rows, vals = _rsp(mx, rs, [1, 4, 9, 15])
    kept = r.retain([4, 15, 19])
    assert kept.indices.asnumpy().tolist() == [4, 15]
    np.testing.assert_array_equal(kept.values.asnumpy(), vals[[1, 3]])


def test_add_merges_index_union(mx):
    rs = np.random.RandomState(3)
    a, _, _ = _rsp(mx, rs, [2, 6])
    b, _, _ = _rsp(mx, rs, [6, 13])
    c = a + b
    assert c.indices.asnumpy().tolist() == [2, 6, 13]
    np.testing.assert_allclose(c.to_dense().asnumpy(),
                               a.to_dense().asnumpy() + b.to_dense().asnumpy(), atol=1e-6)


def test_invalid_indices_rejected(mx):
    sp = _sp(mx)
    with pytest.raises(mx.base.MXNetError):
        sp.RowSparseNDArray([3, 1], np.zeros((2, D), "f"), (V, D))  # unsorted
    with pytest.raises(mx.base.MXNetError):
        sp.RowSparseNDArray([1, V], np.zeros((2, D), "f"), (V, D))  # range
    with pytest.raises(mx.base.MXNetError):
        sp.RowSparseNDArray([1], np.zeros((2, D), "f"), (V, D))  # shape


def test_zero_nnz_valid(mx):
    r = _sp(mx).row_sparse_array((np.zeros((0, D), "f"), np.zeros((0,), np.int64)), (V, D))
    assert r.nnz == 0 and r.size == 0
    assert not np.any(r.to_dense().asnumpy())


# --------------------------------------------------- segment-sum backward
def test_embedding_backward_matches_dense_reference(mx):
    rs = np.random.RandomState(4)
    ids = rs.randint(0, V, (3, 5))  # repeated ids must accumulate
    og = rs.rand(3, 5, D).astype("float32")
    g = _sp(mx).embedding_backward(ids, mx.nd.array(og), V)
    ref = np.zeros((V, D), "float32")
    for i, o in zip(ids.reshape(-1), og.reshape(-1, D)):
        ref[i] += o
    assert g.nnz == np.unique(ids).size
    np.testing.assert_allclose(g.to_dense().asnumpy(), ref, atol=1e-5)


def test_embedding_backward_matches_executor_grad(mx):
    """The segment-sum backward equals the dense autodiff gradient the
    executor computes for the same lookup."""
    rs = np.random.RandomState(5)
    data = mx.sym.Variable("data")
    net = mx.sym.LinearRegressionOutput(
        mx.sym.SparseEmbedding(data=data, input_dim=V, output_dim=D, name="emb"),
        label=mx.sym.Variable("label"), name="out")
    ex = net.simple_bind(mx.cpu(), data=(6,), label=(6, D))
    ids = rs.randint(0, V, (6,))
    ex.arg_dict["data"][:] = ids.astype("float32")
    ex.arg_dict["emb_weight"][:] = rs.rand(V, D).astype("float32")
    ex.arg_dict["label"][:] = rs.rand(6, D).astype("float32")
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    dense_grad = ex.grad_dict["emb_weight"].asnumpy()
    og = (out - ex.arg_dict["label"].asnumpy()) / D  # LinearRegressionOutput's backward
    g = _sp(mx).embedding_backward(ids, mx.nd.array(og), V)
    np.testing.assert_allclose(g.to_dense().asnumpy(), dense_grad, atol=1e-5)


def test_sparse_embedding_forward_matches_embedding(mx):
    rs = np.random.RandomState(6)
    w = rs.rand(V, D).astype("float32")
    ids = rs.randint(0, V, (7,)).astype("float32")
    a = mx.nd.Embedding(mx.nd.array(ids), mx.nd.array(w), input_dim=V, output_dim=D)
    b = mx.nd.SparseEmbedding(mx.nd.array(ids), mx.nd.array(w), input_dim=V, output_dim=D)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


# ------------------------------------------------------- lazy-update contract
def _fit_rounds(mx, opt, rounds, fallback_pct=None, monkeypatch=None):
    """Sparse push rounds through a local kvstore; returns (w0, kv)."""
    if fallback_pct is not None:
        monkeypatch.setenv("MXNET_SPARSE_DENSE_FALLBACK_PCT", str(fallback_pct))
    rs = np.random.RandomState(7)
    kv = mx.kv.create("local")
    kv.set_optimizer(opt)
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    for rows in rounds:
        r, _, _ = _rsp(mx, rs, rows)
        kv.push("emb", r)
    return w0, kv


def test_lazy_sgd_momentum_parity_with_dense_on_touched_rows(mx):
    rs = np.random.RandomState(8)
    opt = mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3)
    kv = mx.kv.create("local")
    kv.set_optimizer(opt)
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    r, rows, vals = _rsp(mx, rs, [0, 5, 19])
    kv.push("emb", r)
    out = mx.nd.zeros((V, D))
    kv.pull("emb", out=out)
    w1 = out.asnumpy()
    mom = 0.9 * 0 - 0.1 * (vals + 1e-3 * w0[rows])
    np.testing.assert_allclose(w1[rows], w0[rows] + mom, atol=1e-6)
    unt = np.setdiff1d(np.arange(V), rows)
    np.testing.assert_array_equal(w1[unt], w0[unt])


def test_lazy_adam_untouched_state_bit_identical_to_seed(mx):
    opt = mx.optimizer.Adam(learning_rate=0.01)
    _, kv = _fit_rounds(mx, opt, [[1, 3], [3, 8], [1, 15]])
    st = kv._updater.states["emb"]
    assert isinstance(st, _sp(mx).RowSparseState)
    assert set(st.indices.tolist()) == {1, 3, 8, 15}
    assert opt._index_update_count["emb"] == 3


def test_dense_wire_fallback_preserves_lazy_state(mx, monkeypatch):
    opt = mx.optimizer.Adam(learning_rate=0.01)
    _, kv = _fit_rounds(mx, opt, [[2, 9], [9, 12]], fallback_pct=1e-6,
                        monkeypatch=monkeypatch)
    st = kv._updater.states["emb"]
    assert isinstance(st, _sp(mx).RowSparseState)
    assert set(st.indices.tolist()) == {2, 9, 12}


def test_sparse_vs_dense_fallback_same_weights(mx, monkeypatch):
    w_a, kv_a = _fit_rounds(mx, mx.optimizer.Adam(learning_rate=0.01), [[1, 4], [4, 11]],
                            fallback_pct=100.0, monkeypatch=monkeypatch)
    w_b, kv_b = _fit_rounds(mx, mx.optimizer.Adam(learning_rate=0.01), [[1, 4], [4, 11]],
                            fallback_pct=1e-6, monkeypatch=monkeypatch)
    a = mx.nd.zeros((V, D))
    kv_a.pull("emb", out=a)
    b = mx.nd.zeros((V, D))
    kv_b.pull("emb", out=b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_push_without_updater_replaces_touched_rows_only(mx):
    rs = np.random.RandomState(9)
    kv = mx.kv.create("local")
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    r, rows, vals = _rsp(mx, rs, [6, 17])
    kv.push("emb", r)
    out = mx.nd.zeros((V, D))
    kv.pull("emb", out=out)
    got = out.asnumpy()
    np.testing.assert_array_equal(got[rows], vals)
    unt = np.setdiff1d(np.arange(V), rows)
    np.testing.assert_array_equal(got[unt], w0[unt])


def test_row_sparse_pull(mx):
    rs = np.random.RandomState(10)
    kv = mx.kv.create("local")
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    r = kv.row_sparse_pull("emb", [7, 2, 7])
    assert r.indices.asnumpy().tolist() == [2, 7]
    np.testing.assert_array_equal(r.values.asnumpy(), w0[[2, 7]])


def test_optimizer_without_flat_spec_densifies_with_warning(mx, caplog):
    rs = np.random.RandomState(11)
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.RMSProp(learning_rate=0.01))
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    r, rows, _ = _rsp(mx, rs, [3])
    with caplog.at_level("WARNING"):
        kv.push("emb", r)
    assert "NOT lazy" in caplog.text
    out = mx.nd.zeros((V, D))
    kv.pull("emb", out=out)
    assert not np.allclose(out.asnumpy()[rows], w0[rows])
    assert not isinstance(kv._updater.states["emb"], _sp(mx).RowSparseState)


def test_flat_kernels_shared_with_bucket_engine(mx):
    bucket = importlib.import_module(mx.__name__ + ".kvstore_bucket")
    assert bucket._FLAT_KERNELS is mx.optimizer.FLAT_KERNELS


# ------------------------------------------------- shard rules / lint / plan
def test_shard_rule_category_registered(mx):
    im = importlib.import_module(mx.__name__ + ".ops.infer_meta")
    assert "row_sparse_embedding" in im.SHARD_RULES
    assert im.get_meta("SparseEmbedding").shard_rule == "row_sparse_embedding"
    assert im.get_meta("SparseEmbedding").param_slots == ("weight",)
    assert set(im.EMBEDDING_RULES) == {"embedding", "row_sparse_embedding"}


def test_gl405_hint_names_embedding_table_pspec(mx):
    """The GL405 fix hint for a replicated embedding table names the
    table's param_pspec placement, not the generic rank-2 advice."""
    analysis = importlib.import_module(mx.__name__ + ".analysis")
    if mx is mxnet_tpu:
        from jax.sharding import PartitionSpec as P

        empty = P()
    else:
        empty = ()
    mesh = mx.parallel.parse_mesh_spec("dp=2,model=2")
    rules = mx.parallel.ShardingRules.infer_axes(mesh, param_rule=lambda name, shape: empty)
    net = mx.sym.SparseEmbedding(data=mx.sym.Variable("ids"), input_dim=4096, output_dim=64,
                                 name="table")
    report = analysis.lint(net, shapes={"ids": (8,)}, types={"ids": "int32"}, mesh=mesh,
                           rules=rules)
    gl405 = [d for d in report.diagnostics if d.code == "GL405"]
    assert gl405, report.codes()
    hint = gl405[0].fix_hint
    assert "embedding table" in hint and "param_pspec" in hint
    assert "table_weight" in hint and "row-sparse" in hint


def test_autoplan_recommender_shards_embedding_over_model_axis(mx):
    """At 8 devices with a budget that replicated tables blow, the planner
    lands a model-axis-sharded embedding spec and beats naive all-dp on
    predicted comm."""
    autoplan = importlib.import_module(mx.__name__ + ".parallel.autoplan")
    net = mx.models.get_symbol("recommender")
    shapes = {"user": (64,), "item": (64,), "dense": (64, 16), "label": (64,)}
    plan = autoplan.plan_parallel(net, shapes, types={"user": "int32", "item": "int32"},
                                  devices=8, budget_gb=0.0625, label="recommender")
    assert plan.feasible and plan.mesh.get("model", 1) > 1
    sharded = [n for n in ("user_embed_weight", "item_embed_weight")
               if any(plan.param_specs.get(n, []))]
    assert sharded, plan.param_specs
    assert plan.predicted["comm_bytes"] < plan.naive["comm_bytes"]


def test_autoplan_recommender_plan_is_the_references():
    shapes = {"user": (64,), "item": (64,), "dense": (64, 16), "label": (64,)}
    plans = [importlib.import_module(m.__name__ + ".parallel.autoplan").plan_parallel(
        m.models.get_symbol("recommender"), shapes, types={"user": "int32", "item": "int32"},
        devices=8, budget_gb=0.0625, label="recommender").to_json() for m in (mxnet_tpu, pt)]
    assert plans[1] == plans[0]


def test_recommender_in_zoo_and_lints_clean(mx):
    cli = importlib.import_module(mx.__name__ + ".analysis.cli")
    DEFAULT_SHAPES, DEFAULT_TYPES = cli.DEFAULT_SHAPES, cli.DEFAULT_TYPES
    from mxnet_tpu.analysis import cli as ref_cli

    assert (DEFAULT_SHAPES, DEFAULT_TYPES) == (ref_cli.DEFAULT_SHAPES, ref_cli.DEFAULT_TYPES)
    analysis = importlib.import_module(mx.__name__ + ".analysis")
    assert "recommender" in DEFAULT_SHAPES and "dlrm" in DEFAULT_SHAPES
    net = mx.models.get_symbol("dlrm")
    report = analysis.lint(net, shapes=DEFAULT_SHAPES["recommender"],
                           types=DEFAULT_TYPES["recommender"])
    errors = [d for d in report.diagnostics if d.severity == "error"]
    assert not errors, [d.format() for d in errors]


def test_sparse_param_names(mx):
    net = mx.models.get_symbol("recommender")
    names = _sp(mx).sparse_param_names
    assert sorted(names(net)) == ["item_embed_weight", "user_embed_weight"]
    d = mx.sym.Variable("data")
    e = mx.sym.Embedding(data=d, input_dim=V, output_dim=D, sparse_grad=True, name="emb")
    assert names(e) == ["emb_weight"]
    e2 = mx.sym.Embedding(data=d, input_dim=V, output_dim=D, name="emb2")
    assert names(e2) == []


def test_module_fit_routes_sparse_grad_params(mx, monkeypatch):
    """The Module glue resolves the sparse-grad params and routes their
    pushes through the KVStore sparse round."""
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    rs = np.random.RandomState(12)
    data = mx.sym.Variable("data")
    emb = mx.sym.SparseEmbedding(data=data, input_dim=64, output_dim=8, name="emb")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(emb, num_hidden=4, name="fc"),
                               name="softmax")
    it = mx.io.NDArrayIter(rs.randint(0, 64, (24,)).astype("float32"),
                           rs.randint(0, 4, (24,)).astype("float32"), batch_size=8)
    kv = mx.kv.create("local")
    pre = mx.telemetry.counter("kvstore.sparse_rows_pushed").value
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.05),))
    idx = next(i for i, n in enumerate(mod._param_names) if n == "emb_weight")
    assert isinstance(kv._updater.states.get(idx), _sp(mx).RowSparseState)
    assert mx.telemetry.counter("kvstore.sparse_rows_pushed").value > pre


def test_updater_dense_grad_on_sparse_state_stays_lazy(mx):
    rs = np.random.RandomState(13)
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.Adam(learning_rate=0.01))
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    r, _, _ = _rsp(mx, rs, [2, 7])
    kv.push("emb", r)
    dense = np.zeros((V, D), "float32")
    dense[[7, 11]] = rs.rand(2, D).astype("float32")
    kv.push("emb", mx.nd.array(dense))  # dense grad, sparse state
    st = kv._updater.states["emb"]
    assert isinstance(st, _sp(mx).RowSparseState)
    assert set(st.indices.tolist()) == {2, 7, 11}
    out = mx.nd.zeros((V, D))
    kv.pull("emb", out=out)
    unt = np.setdiff1d(np.arange(V), [2, 7, 11])
    np.testing.assert_array_equal(out.asnumpy()[unt], w0[unt])


# ---------------------------------------------------------- the port alone
def test_sparse_embedding_backward_is_the_same_bits_twice():
    """The port's SparseEmbedding gradient comes from F.embedding's sorted
    backward and the segment sum from one host sort: two runs, same bits."""
    rs = np.random.RandomState(14)
    ids = rs.randint(0, V, (64,))
    og = rs.rand(64, D).astype("float32")
    a = pt.sparse.embedding_backward(ids, pt.nd.array(og, ctx=pt.cpu()), V)
    b = pt.sparse.embedding_backward(ids, pt.nd.array(og, ctx=pt.cpu()), V)
    assert np.array_equal(a.values.asnumpy(), b.values.asnumpy())
    w = torch.tensor(rs.rand(V, D).astype("float32"), requires_grad=True)
    out = pt.ops.registry.get_op("SparseEmbedding").fn(
        {"input_dim": V, "output_dim": D}, torch.tensor(ids, dtype=torch.float32), w)
    out.backward(torch.tensor(og))
    np.testing.assert_array_equal(w.grad.numpy()[a.host_indices()], a.values.asnumpy())


def test_from_dense_scan_counts_its_host_sync(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "counters")
    pre = pt.telemetry.counter("embedding.host_syncs").value
    dense = np.zeros((V, D), "float32")
    dense[[3, 9]] = 1.0
    r = pt.sparse.from_dense(pt.nd.array(dense, ctx=pt.cpu()))
    assert r.indices.asnumpy().tolist() == [3, 9]
    assert pt.telemetry.counter("embedding.host_syncs").value == pre + 1
    pt.sparse.from_dense(pt.nd.array(dense, ctx=pt.cpu()), rows=[3])
    assert pt.telemetry.counter("embedding.host_syncs").value == pre + 1


# ---------------------------------------------------------------- recommender
@pytest.mark.parametrize("name", ["recommender", "dlrm"])
def test_recommender_json_matches_jax(name):
    with mxnet_tpu.name.NameManager():
        js = mxnet_tpu.models.get_symbol(name)
    with pt.NameManager():
        ps = pt.models.get_symbol(name)
    assert ps.tojson() == js.tojson()
    shapes = dict(user=(512,), item=(512,), dense=(512, 16), label=(512,))
    assert [list(map(tuple, s)) for s in ps.infer_shape(**shapes)] == \
        [list(map(tuple, s)) for s in js.infer_shape(**shapes)]


SMALL = dict(num_users=300, num_items=200, embed_dim=16, dense_dim=16,
             bottom_hidden=(32,), top_hidden=(64, 32))


def _recommender_fit(mx, contexts, params, batch, optimizer, optimizer_params, fused_step=None):
    names = ["user", "item", "dense"]
    net = mx.models.get_symbol("recommender", **SMALL)
    it = mx.io.NDArrayIter({n: batch[n] for n in names}, {"label": batch["label"]},
                           batch_size=64)
    mod = mx.mod.Module(net, data_names=names, label_names=["label"], context=contexts,
                        **({} if fused_step is None else {"fused_step": fused_step}))
    kv = mx.kv.create("local")
    mod.fit(it, num_epoch=1, kvstore=kv, optimizer=optimizer,
            optimizer_params=optimizer_params,
            arg_params={k: mx.nd.array(v) for k, v in params.items()})
    args, _ = mod.get_params()
    # the fused step keeps its state on its trainer, not the store's updater
    states = kv._updater.states if kv._updater is not None else None
    return {k: v.asnumpy() for k, v in args.items()}, states, mod


def _recommender_case(seed=0):
    rs = np.random.RandomState(seed)
    net = pt.models.get_symbol("recommender", **SMALL)
    arg_shapes, _, _ = net.infer_shape(user=(64,), item=(64,), dense=(64, 16), label=(64,))
    params = {n: (rs.rand(*s).astype("float32") - 0.5) * 0.2
              for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("user", "item", "dense", "label")}
    batch = {"user": rs.randint(0, 300, 64).astype("float32"),
             "item": rs.randint(0, 200, 64).astype("float32"),
             "dense": rs.rand(64, 16).astype("float32"),
             "label": (rs.rand(64) > 0.5).astype("float32")}
    return params, batch


@pytest.mark.parametrize("n_ctx", [1, 2])
@pytest.mark.parametrize("optimizer,optimizer_params", [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))),
    ("adam", (("learning_rate", 0.01),))])
def test_recommender_fit_step_matches_jax(n_ctx, optimizer, optimizer_params):
    """One Module.fit step at batch 64 through a local KVStore object: every
    weight and every optimizer state, the sparse ones as RowSparseState,
    within rtol 1e-5, atol 1e-6 of the JAX package's. The JAX side runs its
    per-device path (fused_step off), the one the port has, over cpu(0)
    once or twice: its row-sparse local reduce cannot add values of two
    distinct devices (``RowSparseNDArray.__add__`` scatters a cpu(1) array
    into a cpu(0) one). The port runs over cpu(0), cpu(1)."""
    params, batch = _recommender_case()
    # the per-device path in both packages (distinct contexts would engage
    # the port's fused step, held against JAX's below)
    jw, jst, jmod = _recommender_fit(mxnet_tpu, [mxnet_tpu.cpu(0)] * n_ctx, params, batch,
                                     optimizer, optimizer_params, fused_step=False)
    with pt.cpu():
        pw, pst, pmod = _recommender_fit(pt, [pt.cpu(i) for i in range(n_ctx)], params,
                                         batch, optimizer, optimizer_params, fused_step=False)
    assert jmod._spmd is None and pmod._spmd is None
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=RTOL, atol=ATOL, err_msg=k)
    sparse_keys = {i for i, n in enumerate(pmod._param_names) if n.endswith("_embed_weight")}
    assert set(jst) == set(pst)
    for key in jst:
        j, p = jst[key], pst[key]
        if key in sparse_keys:
            assert isinstance(p, pt.sparse.RowSparseState)
            np.testing.assert_array_equal(p.indices, j.indices)
            for a, b in zip(p.rows, j.rows):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            # untouched rows: the seed weights, bit for bit
            name = pmod._param_names[key]
            unt = np.setdiff1d(np.arange(params[name].shape[0]), p.indices)
            np.testing.assert_array_equal(pw[name][unt], params[name][unt])
            continue
        js = j if isinstance(j, tuple) else (j,)
        ps = p if isinstance(p, tuple) else (p,)
        for a, b in zip(ps, js):
            if b is None:
                assert a is None
            else:
                np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("optimizer,optimizer_params", [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9))),
    ("adam", (("learning_rate", 0.01),))])
def test_recommender_fused_step_matches_jax(optimizer, optimizer_params):
    """The port's fused step over the distinct contexts [cpu(0), cpu(1)]
    (dense embedding gradients, as JAX's fused step takes them) held
    against the JAX package's per-device step over cpu(0): JAX's own fused
    step raises on the recommender (a reference fault, ROADMAP.md section
    3), and the two paths agree on one step from a zero optimizer state
    with wd 0, where the lazy row update equals the dense one (an
    untouched row has a zero gradient and zero state). Weights within
    rtol 2e-4, atol 2e-5, the fused step's tolerance."""
    params, batch = _recommender_case()
    jw, _, jmod = _recommender_fit(mxnet_tpu, [mxnet_tpu.cpu(0)], params, batch, optimizer,
                                   optimizer_params, fused_step=False)
    with pt.cpu():
        pw, _, pmod = _recommender_fit(pt, [pt.cpu(0), pt.cpu(1)], params, batch, optimizer,
                                       optimizer_params)
    assert jmod._spmd is None and pmod._spmd is not None
    assert int(pmod._spmd.trainer.opt_state["t"]) == 1
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=2e-4, atol=2e-5, err_msg=k)


def _recommender_steps(mx, contexts, params, batches, optimizer, optimizer_params,
                       fused_step=None):
    """Module.forward_backward/update over ``batches`` through a local
    KVStore object (the store PR 15's lazy row-sparse update runs on), each
    batch a DataBatch whose arrays follow ``data_names`` (the order JAX's
    fused adapter takes them in); returns the weights as numpy and the
    module."""
    names = ["user", "item", "dense"]
    net = mx.models.get_symbol("recommender", **SMALL)
    mod = mx.mod.Module(net, data_names=names, label_names=["label"], context=contexts,
                        **({} if fused_step is None else {"fused_step": fused_step}))
    mod.bind(data_shapes=[(n, batches[0][n].shape) for n in names],
             label_shapes=[("label", batches[0]["label"].shape)])
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in params.items()})
    mod.init_optimizer(kvstore=mx.kv.create("local"), optimizer=optimizer,
                       optimizer_params=optimizer_params)
    for b in batches:
        mod.forward_backward(mx.io.DataBatch(data=[mx.nd.array(b[n]) for n in names],
                                             label=[mx.nd.array(b["label"])]))
        mod.update()
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}, mod


@pytest.mark.parametrize("optimizer,optimizer_params", [
    ("sgd", (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))),
    ("adam", (("learning_rate", 0.01),))])
def test_recommender_fused_steps_match_jax_fused_step(optimizer, optimizer_params):
    """Four fused recommender steps over [cpu(0), cpu(1)] in both packages,
    each batch's arrays in ``data_names`` order: weights within rtol 2e-4,
    atol 2e-5. The fused step's embedding gradients are dense, as JAX's
    are, so it updates every row where the per-device path's lazy
    row-sparse update touches only a batch's rows: a row an earlier batch
    touched and the last did not still moves at the last step under
    momentum or Adam, and the two paths part there."""
    params = _recommender_case()[0]
    batches = [_recommender_case(seed)[1] for seed in range(1, 5)]
    jw, jmod = _recommender_steps(mxnet_tpu, [mxnet_tpu.cpu(0), mxnet_tpu.cpu(1)], params,
                                  batches, optimizer, optimizer_params)
    with pt.cpu():
        pw, pmod = _recommender_steps(pt, [pt.cpu(0), pt.cpu(1)], params, batches, optimizer,
                                      optimizer_params)
        lw, lmod = _recommender_steps(pt, [pt.cpu(0), pt.cpu(1)], params, batches, optimizer,
                                      optimizer_params, fused_step=False)
    assert jmod._spmd is not None and pmod._spmd is not None and lmod._spmd is None
    assert int(pmod._spmd.trainer.opt_state["t"]) == len(batches)
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], rtol=2e-4, atol=2e-5, err_msg=k)
    for name, key in (("user_embed_weight", "user"), ("item_embed_weight", "item")):
        seen = [set(b[key].astype(int)) for b in batches]
        untouched = np.array(sorted(set(range(params[name].shape[0])).difference(*seen)))
        earlier = np.array(sorted(set().union(*seen[:-1]) - seen[-1]))
        assert len(untouched) and len(earlier)
        np.testing.assert_array_equal(lw[name][untouched], params[name][untouched])
        assert np.abs(pw[name][earlier] - lw[name][earlier]).max() > 1e-6, name
