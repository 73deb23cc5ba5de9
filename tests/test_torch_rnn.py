"""The port's ``rnn/`` package and fused ``RNN`` op against the JAX package.

Every case of the reference's own ``tests/test_rnn.py`` runs here on BOTH
packages (fixture ``mx``, the port inside ``with cpu():``). Then parity,
inputs and weights made with numpy from a seed and handed to both: the
fused ``RNN`` op in all four modes, bidirectional and with
``state_outputs``, forward and every gradient (rtol 1e-5, atol 1e-6); the
unrolled cells, the modifier cells and a two-layer bidirectional fused
stack (outputs rtol 1e-5, atol 1e-6), ``unfuse()`` of a two-layer one; the cells' symbol JSON;
``BucketSentenceIter``'s batches (equal); the ``FusedRNN`` initializer
(equal to JAX's where JAX's draws nothing, else each block's statistics);
and the bucketed LSTM language model of ``example/rnn/lstm_bucketing.py``,
trained through ``BucketingModule.fit`` on both packages from the same
weights (parameters rtol 1e-4, atol 1e-5, the ``Module.fit`` parity
tolerance of ``test_torch_module.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = dict(rtol=1e-5, atol=1e-6), dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


# -------------------------------------------- tests/test_rnn.py, both packages
def _bind_and_run(mx, out_sym, args_np):
    exe = mx.executor.bind(
        out_sym, mx.cpu(),
        {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in args_np.items()},
        args_grad=None, grad_req="null", aux_states={})
    return [o.asnumpy() for o in exe.forward(is_train=False)]


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_fused_matches_unfused(mx, mode):
    rnn, sym = mx.rnn, mx.sym
    T, N, I, H = 5, 3, 4, 6
    rs = np.random.RandomState(42)
    x = rs.uniform(-1, 1, (N, T, I)).astype("float32")
    nparam = mx.ops.rnn.rnn_param_size(1, I, H, False, mode)
    blob = rs.uniform(-0.5, 0.5, (nparam,)).astype("float32")

    fused = rnn.FusedRNNCell(H, num_layers=1, mode=mode, prefix="%s_" % mode)
    data = sym.Variable("data")
    fout, _ = fused.unroll(T, inputs=data, layout="NTC", merge_outputs=True)
    n_states = 2 if mode == "lstm" else 1
    fargs = {"data": x, "%s_parameters" % mode: blob}
    for i in range(n_states):
        fargs["%s_begin_state_%d" % (mode, i)] = np.zeros((1, N, H), "float32")
    fres = _bind_and_run(mx, fout, fargs)[0]

    unfused = fused.unfuse()
    uout_list, _ = unfused.unroll(T, inputs=sym.Variable("data"), layout="NTC")
    uout = sym.Group(uout_list)
    weights = fused.unpack_weights({"%s_parameters" % mode: mx.nd.array(blob)})
    uargs = {"data": x}
    for k, v in weights.items():
        uargs[k] = v.asnumpy()
    for i in range(n_states):
        uargs["%s_l0_begin_state_%d" % (mode, i)] = np.zeros((N, H), "float32")
    ures = _bind_and_run(mx, uout, uargs)
    stacked = np.stack(ures, axis=1)  # (N, T, H)
    np.testing.assert_allclose(fres, stacked, rtol=1e-4, atol=1e-5)


def test_pack_unpack_roundtrip(mx):
    I, H = 4, 6
    fused = mx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="lstm_")
    nparam = mx.ops.rnn.rnn_param_size(2, I, H, False, "lstm")
    blob = np.arange(nparam, dtype="float32")
    unpacked = fused.unpack_weights({"lstm_parameters": mx.nd.array(blob)})
    assert "lstm_l0_i2h_weight" in unpacked and "lstm_l1_h2h_bias" in unpacked
    packed = fused.pack_weights(unpacked)
    np.testing.assert_array_equal(packed["lstm_parameters"].asnumpy(), blob)


def test_lstm_cell_unroll_shapes(mx):
    cell = mx.rnn.LSTMCell(16, prefix="c_")
    outs, states = cell.unroll(3, input_prefix="c_")
    out = mx.sym.Group(outs)
    shapes = {"c_t%d_data" % i: (2, 8) for i in range(3)}
    shapes.update({"c_begin_state_0": (2, 16), "c_begin_state_1": (2, 16)})
    _, out_shapes, _ = out.infer_shape(**shapes)
    assert [tuple(s) for s in out_shapes] == [(2, 16)] * 3


def test_sequential_stack(mx):
    stack = mx.rnn.SequentialRNNCell()
    stack.add(mx.rnn.LSTMCell(8, prefix="l0_"))
    stack.add(mx.rnn.LSTMCell(8, prefix="l1_"))
    outs, states = stack.unroll(2, input_prefix="s_")
    assert len(outs) == 2 and len(states) == 4


def test_bidirectional_unroll(mx):
    cell = mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(4, prefix="l_"), mx.rnn.LSTMCell(4, prefix="r_"))
    data = mx.sym.Variable("data")
    outs, states = cell.unroll(3, inputs=data, layout="NTC")
    out = mx.sym.Group(outs)
    shapes = {"data": (2, 3, 5)}
    for p in ("l_", "r_"):
        shapes["%sbegin_state_0" % p] = (2, 4)
        shapes["%sbegin_state_1" % p] = (2, 4)
    _, out_shapes, _ = out.infer_shape(**shapes)
    assert [tuple(s) for s in out_shapes] == [(2, 8)] * 3  # fwd+bwd concat


def test_residual_cell(mx):
    cell = mx.rnn.ResidualCell(mx.rnn.RNNCell(4, prefix="rc_"))
    data = mx.sym.Variable("data")
    outs, _ = cell.unroll(2, inputs=data, layout="NTC")
    _, out_shapes, _ = mx.sym.Group(outs).infer_shape(
        data=(2, 2, 4), rc_begin_state_0=(2, 4))
    assert [tuple(s) for s in out_shapes] == [(2, 4)] * 2


def test_bucket_sentence_iter(mx):
    rs = np.random.RandomState(0)
    sentences = [list(rs.randint(1, 50, rs.randint(2, 12))) for _ in range(100)]
    it = mx.rnn.BucketSentenceIter(sentences, batch_size=4, buckets=[4, 8, 12],
                                   invalid_label=0)
    n = 0
    for batch in it:
        n += 1
        assert batch.bucket_key in (4, 8, 12)
        d = batch.data[0].asnumpy()
        lb = batch.label[0].asnumpy()
        assert d.shape == (4, batch.bucket_key)
        # label is data shifted by one step
        np.testing.assert_array_equal(lb[:, :-1], d[:, 1:])
    assert n > 0
    it.reset()
    assert sum(1 for _ in it) == n


# ------------------------------------------------------------ parity with JAX
def test_the_rnn_package_exports_what_the_references_does():
    assert pt.rnn.__all__ == mxnet_tpu.rnn.__all__
    for name in pt.rnn.__all__:
        assert hasattr(pt.rnn, name), name


def _rnn_inputs(mode, L, I, H, bidir, T=4, N=3, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bidir else 1
    ins = [rs.uniform(-1, 1, (T, N, I)).astype(np.float32),
           rs.uniform(-0.4, 0.4, (pt.ops.rnn.rnn_param_size(L, I, H, bidir, mode),)
                      ).astype(np.float32),
           rs.uniform(-0.5, 0.5, (L * d, N, H)).astype(np.float32)]
    if mode == "lstm":
        ins.append(rs.uniform(-0.5, 0.5, (L * d, N, H)).astype(np.float32))
    return ins


@pytest.mark.parametrize("mode,layers,bidir,state_outputs", [
    ("lstm", 2, False, True), ("lstm", 1, True, False), ("lstm", 2, True, True),
    ("gru", 2, False, True), ("gru", 1, True, True), ("rnn_tanh", 2, True, True),
    ("rnn_relu", 2, False, True), ("rnn_relu", 1, True, False)])
def test_rnn_op_forward_and_gradients_match_jax(mode, layers, bidir, state_outputs):
    """Every output and the gradient of a weighted sum of them with respect
    to each input (data, the packed parameters, the initial states)."""
    I, H = 5, 4
    ins = _rnn_inputs(mode, layers, I, H, bidir)
    attrs = {"mode": mode, "state_size": str(H), "num_layers": str(layers),
             "bidirectional": str(bidir), "state_outputs": str(state_outputs)}
    jop, pop = jreg.get_op("RNN"), preg.get_op("RNN")
    jattrs, pattrs = jreg.parse_attrs(jop, attrs), preg.parse_attrs(pop, attrs)
    n_out = pop.num_outputs(pattrs)
    rs = np.random.RandomState(1)

    def jfn(*xs):
        return tuple(jop.apply(jattrs, list(xs))[0])

    jouts, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in ins])
    heads = [rs.uniform(-1, 1, np.shape(o)).astype(np.float32) for o in jouts]
    jgrads = vjp(tuple(jnp.asarray(h) for h in heads))

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    pouts = pop.apply(pattrs, leaves)[0]
    assert len(pouts) == len(jouts) == n_out
    pgrads = torch.autograd.grad(pouts, leaves, [torch.from_numpy(h) for h in heads])
    for p, j in zip(pouts, jouts):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), **OUT_TOL)
    for name, p, j in zip(pop.input_names(pattrs), pgrads, jgrads):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), err_msg=name, **GRAD_TOL)


def test_rnn_op_dropout_between_layers_draws_from_the_nodes_generator():
    """Dropout p between layers in a training forward: the identity at
    inference and at p = 0 (equal to JAX there); at p > 0 the same seed
    gives the same outputs, and the first layer's rows are never dropped
    (a one-layer net is unchanged by p)."""
    ins = [torch.from_numpy(x) for x in _rnn_inputs("lstm", 2, 5, 4, False)]
    op = preg.get_op("RNN")
    base = {"mode": "lstm", "state_size": "4", "num_layers": "2"}
    plain = op.apply(preg.parse_attrs(op, base), ins, is_train=True)[0][0]
    drop = preg.parse_attrs(op, dict(base, p="0.5"))
    assert torch.equal(op.apply(drop, ins, is_train=False)[0][0], plain)
    gen = pt.random.generator("cpu")
    gen.manual_seed(3)
    a = op.apply(drop, ins, is_train=True, rng=gen)[0][0]
    gen.manual_seed(3)
    b = op.apply(drop, ins, is_train=True, rng=gen)[0][0]
    assert torch.equal(a, b) and not torch.equal(a, plain)
    one = [torch.from_numpy(x) for x in _rnn_inputs("lstm", 1, 5, 4, False)]
    one_attrs = {"mode": "lstm", "state_size": "4", "num_layers": "1"}
    assert torch.equal(op.apply(preg.parse_attrs(op, dict(one_attrs, p="0.5")), one,
                                is_train=True, rng=gen)[0][0],
                       op.apply(preg.parse_attrs(op, one_attrs), one, is_train=True)[0][0])


def _unrolled(pkg, name_mgr, T=3):
    """Every cell kind: a bidirectional LSTM layer unrolled over the
    sequence, then a stack of a dropout cell, a residual GRU cell and a tanh
    RNN cell under zoneout stepped over its outputs."""
    rnn = pkg.rnn
    with name_mgr():
        bi = rnn.BidirectionalCell(rnn.LSTMCell(4, prefix="bl_"), rnn.LSTMCell(4, prefix="br_"),
                                   output_prefix="bi_")
        outs, bi_states = bi.unroll(T, inputs=pkg.sym.Variable("data"), layout="NTC")
        stack = rnn.SequentialRNNCell()
        stack.add(rnn.DropoutCell(0.3, prefix="drop_"))
        stack.add(rnn.ResidualCell(rnn.GRUCell(8, prefix="g_")))
        stack.add(rnn.ZoneoutCell(rnn.RNNCell(8, prefix="z_"), zoneout_outputs=0.2,
                                  zoneout_states=0.1))
        outs, states = stack.unroll(T, inputs=outs, layout="NTC", merge_outputs=True)
        return pkg.sym.Group([outs] + list(bi_states) + list(states))


def _values(sym, shapes, seed=5):
    rs = np.random.RandomState(seed)
    arg_shapes = sym.infer_shape(**shapes)[0]
    return {n: (rs.uniform(-0.5, 0.5, s).astype(np.float32)) for n, s in
            zip(sym.list_arguments(), arg_shapes)}


def test_cell_stack_symbols_and_inference_outputs_match_jax():
    """The stack's JSON equals JAX's; an inference forward (Dropout and
    zoneout are the identity there) gives JAX's outputs and states."""
    from mxnet_tpu import name as jname

    js, ps = _unrolled(mxnet_tpu, jname.NameManager), _unrolled(pt, pt.NameManager)
    assert ps.tojson() == js.tojson()
    shapes = {"data": (2, 3, 5)}
    for p in ("bl_", "br_"):
        shapes.update({"%sbegin_state_0" % p: (2, 4), "%sbegin_state_1" % p: (2, 4)})
    shapes.update({"g_begin_state_0": (2, 8), "z_begin_state_0": (2, 8)})
    vals = _values(js, shapes)
    want = _bind_and_run(mxnet_tpu, js, vals)
    got = _bind_and_run(pt, ps, vals)
    assert len(got) == len(want) == 1 + 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **OUT_TOL)


def _fused_stack(pkg, name_mgr, T=4):
    with name_mgr():
        cell = pkg.rnn.FusedRNNCell(5, num_layers=2, mode="lstm", bidirectional=True,
                                    get_next_state=True, prefix="f_")
        outs, states = cell.unroll(T, inputs=pkg.sym.Variable("data"), layout="NTC")
        return pkg.sym.Group([outs] + list(states))


def test_fused_bidirectional_stack_unfuses_to_jaxs_outputs():
    """A two-layer bidirectional FusedRNNCell with its next states: JSON
    equal to JAX's, outputs equal to JAX's; and the ``unfuse()`` stack of a
    two-layer one over ``unpack_weights`` gives the fused outputs in the
    port (a bidirectional stack unfuses into cells that cannot be stepped,
    in both packages)."""
    from mxnet_tpu import name as jname

    js = _fused_stack(mxnet_tpu, jname.NameManager)
    ps = _fused_stack(pt, pt.NameManager)
    assert ps.tojson() == js.tojson()
    shapes = {"data": (3, 4, 6), "f_begin_state_0": (4, 3, 5), "f_begin_state_1": (4, 3, 5)}
    vals = _values(js, shapes)
    want = _bind_and_run(mxnet_tpu, js, vals)
    got = _bind_and_run(pt, ps, vals)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **OUT_TOL)
    # unfuse() of a two-layer (one-way) stack: the fused outputs in the port
    with pt.cpu():
        cell = pt.rnn.FusedRNNCell(5, num_layers=2, mode="lstm", prefix="u_")
        fout, _ = cell.unroll(4, inputs=pt.sym.Variable("data"), layout="NTC")
        fvals = _values(fout, {"data": (3, 4, 6), "u_begin_state_0": (2, 3, 5),
                               "u_begin_state_1": (2, 3, 5)})
        uouts, _ = cell.unfuse().unroll(4, inputs=pt.sym.Variable("data"), layout="NTC",
                                        merge_outputs=True)
        weights = cell.unpack_weights({"u_parameters": pt.nd.array(fvals["u_parameters"])})
        uargs = {"data": fvals["data"]}
        uargs.update({k: v.asnumpy() for k, v in weights.items()})
        for layer in range(2):
            for i in range(2):
                uargs["u_l%d_begin_state_%d" % (layer, i)] = fvals["u_begin_state_%d" % i][layer]
        np.testing.assert_allclose(_bind_and_run(pt, uouts, uargs)[0],
                                   _bind_and_run(pt, fout, fvals)[0], rtol=1e-4, atol=1e-5)


def test_bucket_sentence_iter_gives_jaxs_batches():
    rs = np.random.RandomState(3)
    sentences = [list(rs.randint(2, 40, rs.randint(3, 20))) for _ in range(300)]

    def batches(pkg):
        it = pkg.rnn.BucketSentenceIter(sentences, batch_size=8, buckets=[5, 10, 20],
                                        invalid_label=0, seed=4)
        out = []
        for _ in range(2):  # the second epoch reshuffles
            out += [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
                     b.provide_data[0].shape) for b in it]
            it.reset()
        return out, it.default_bucket_key, it.provide_data[0].shape

    want = batches(mxnet_tpu)
    with pt.cpu():
        got = batches(pt)
    assert got[1:] == want[1:] and len(got[0]) == len(want[0])
    for (gk, gd, gl, gs), (wk, wd, wl, ws) in zip(got[0], want[0]):
        assert gk == wk and tuple(gs) == tuple(ws)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True), ("rnn_tanh", False)])
def test_fused_rnn_initializer_matches_jax(mode, bidir):
    """With a deterministic inner init (Constant) the packed vector equals
    JAX's bit for bit; with Uniform(0.1) every weight block lies in
    [-0.1, 0.1] with mean and spread within 5 standard errors of U(-0.1,
    0.1)'s, and every bias block is zero, as in JAX."""
    L, I, H = 2, 6, 8
    n = pt.ops.rnn.rnn_param_size(L, I, H, bidir, mode)

    def run(pkg, inner):
        init = pkg.init.FusedRNN(inner, num_hidden=H, num_layers=L, mode=mode,
                                 bidirectional=bidir)
        arr = pkg.nd.zeros((n,))
        init(pkg.init.InitDesc("rnn_weight"), arr)  # _init_weight, by the suffix
        return arr.asnumpy()

    want = run(mxnet_tpu, mxnet_tpu.init.Constant(0.25))
    with pt.cpu():
        got = run(pt, pt.init.Constant(0.25))
        pt.random.seed(9)
        drawn = run(pt, pt.init.Uniform(0.1))
    np.testing.assert_array_equal(got, want)
    with pt.cpu():
        cell = pt.rnn.FusedRNNCell(H, L, mode, bidir, prefix="")
        for name, sl, _ in cell._slice_layout(I):
            block = drawn[sl]
            if name.endswith("_bias"):
                assert not block.any(), name
                continue
            assert np.abs(block).max() <= 0.1
            se = 0.1 / np.sqrt(3) / np.sqrt(block.size)
            assert abs(block.mean()) < 5 * se, name
            assert abs(block.std() - 0.1 / np.sqrt(3)) < 5 * se, name


# --------------------------------------- lstm_bucketing.py through BucketingModule
BUCKETS = [4, 8]


# copied from example/rnn/lstm_bucketing.py (_synthetic_corpus), with its
# bucket list passed in
def _synthetic_corpus(n_sentences, vocab_size=500, seed=0, buckets=BUCKETS):
    rs = np.random.RandomState(seed)
    probs = 1.0 / np.arange(2, vocab_size + 2)
    probs /= probs.sum()
    sentences = []
    for _ in range(n_sentences):
        length = int(rs.choice(buckets)) - rs.randint(0, 3)
        toks = rs.choice(np.arange(2, vocab_size + 2), size=max(length, 3), p=probs)
        sentences.append(toks.tolist())
    return sentences, vocab_size + 2


def _bucketing_fit(pkg, params, sentences, vocab, batches, hidden=8, embed=6, batch=4):
    """The example's network and fit, at a small width, on ``pkg``."""
    it = pkg.rnn.BucketSentenceIter(sentences, batch, buckets=BUCKETS, invalid_label=0)
    stack = pkg.rnn.SequentialRNNCell()
    for i in range(2):
        stack.add(pkg.rnn.LSTMCell(num_hidden=hidden, prefix="lstm_l%d_" % i))

    def sym_gen(seq_len):
        data = pkg.sym.Variable("data")
        label = pkg.sym.Variable("softmax_label")
        emb = pkg.sym.Embedding(data=data, input_dim=vocab, output_dim=embed, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=emb, merge_outputs=True,
                                  begin_state=stack.begin_state(batch_size=batch))
        pred = pkg.sym.Reshape(outputs, shape=(-1, hidden))
        pred = pkg.sym.FullyConnected(data=pred, num_hidden=vocab, name="pred")
        label = pkg.sym.Reshape(label, shape=(-1,))
        return (pkg.sym.SoftmaxOutput(data=pred, label=label, name="softmax"),
                ("data",), ("softmax_label",))

    class _Cut(pkg.io.DataIter):
        """The first ``batches`` batches of ``it``."""

        def __init__(self):
            super().__init__(batch)
            self.provide_data, self.provide_label = it.provide_data, it.provide_label
            self.default_bucket_key = it.default_bucket_key
            self.n = 0

        def reset(self):
            it.reset()
            self.n = 0

        def next(self):
            if self.n == batches:
                raise StopIteration
            self.n += 1
            return it.next()

    mod = pkg.mod.BucketingModule(sym_gen=sym_gen, default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    metric = pkg.metric.Perplexity(0)
    mod.fit(_Cut(), eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.0, "wd": 1e-5},
            arg_params=params, num_epoch=1)
    return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}, metric.get()[1]


def test_lstm_bucketing_example_trains_to_jaxs_parameters():
    """Six batches over both buckets through ``BucketingModule.fit`` from the
    same weights: JAX's parameters and perplexity (rtol 1e-4, atol 1e-5)."""
    sentences, vocab = _synthetic_corpus(64, vocab_size=30)
    rs = np.random.RandomState(2)
    params = {"embed_weight": rs.uniform(-0.3, 0.3, (vocab, 6)),
              "pred_weight": rs.uniform(-0.3, 0.3, (vocab, 8)), "pred_bias": np.zeros(vocab)}
    for i in range(2):
        k = 6 if i == 0 else 8
        params.update({"lstm_l%d_i2h_weight" % i: rs.uniform(-0.3, 0.3, (32, k)),
                       "lstm_l%d_h2h_weight" % i: rs.uniform(-0.3, 0.3, (32, 8)),
                       "lstm_l%d_i2h_bias" % i: rs.uniform(-0.1, 0.1, 32),
                       "lstm_l%d_h2h_bias" % i: rs.uniform(-0.1, 0.1, 32)})
    params = {k: v.astype(np.float32) for k, v in params.items()}
    want, want_ppl = _bucketing_fit(mxnet_tpu, {k: mxnet_tpu.nd.array(v)
                                                for k, v in params.items()},
                                    sentences, vocab, batches=6)
    with pt.cpu():
        got, got_ppl = _bucketing_fit(pt, {k: pt.nd.array(v) for k, v in params.items()},
                                      sentences, vocab, batches=6)
    assert sorted(got) == sorted(want)
    for n in want:
        assert not np.array_equal(want[n], params[n]), n  # every array moved
        np.testing.assert_allclose(got[n], want[n], rtol=1e-4, atol=1e-5, err_msg=n)
    np.testing.assert_allclose(got_ppl, want_ppl, rtol=1e-4)
