"""BucketingModule over the port's fused step, the cases of
``tests/test_bucketing_fused.py``: one step a bucket shape, every bucket
training ONE set of tensors (a shared ``_TrainState`` cell), and the
params after a mixed-bucket schedule equal to the per-device path's and to
the JAX package's fused bucketing run from the same numpy weights (rtol
3e-4, atol 3e-5, the JAX test's tolerance).
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch as pt

torch.set_num_threads(1)

VOCAB = 40
EMBED = 8
HIDDEN = 16
BATCH = 16
BUCKETS = [4, 6]
RTOL, ATOL = 3e-4, 3e-5


def _sym_gen_of(mx):
    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=VOCAB, output_dim=EMBED, name="embed")
        cell = mx.rnn.LSTMCell(num_hidden=HIDDEN, prefix="lstm_")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True,
                                 begin_state=cell.begin_state(batch_size=BATCH))
        pred = mx.sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=VOCAB, name="pred")
        label = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _host_batches(n, seed=0):
    """Alternating-bucket token batches."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        L = BUCKETS[i % len(BUCKETS)]
        x = rs.randint(1, VOCAB, (BATCH, L)).astype("float32")
        y = np.concatenate([x[:, 1:], np.zeros((BATCH, 1), "float32")], axis=1)
        out.append((L, x, y))
    return out


def _params():
    sym, _, _ = _sym_gen_of(pt)(max(BUCKETS))
    shapes, _, _ = sym.infer_shape(data=(BATCH, max(BUCKETS)),
                                   softmax_label=(BATCH, max(BUCKETS)))
    rs = np.random.RandomState(3)
    return {n: (rs.randn(*s) * 0.2).astype("f")
            for n, s in zip(sym.list_arguments(), shapes) if n not in ("data", "softmax_label")}


def _train(mx, ctxs, batches, fused=True):
    with pt.cpu() if mx is pt else contextlib.nullcontext():
        mod = mx.mod.BucketingModule(sym_gen=_sym_gen_of(mx), default_bucket_key=max(BUCKETS),
                                     context=ctxs, fused_step=fused)
        L = max(BUCKETS)
        mod.bind(data_shapes=[mx.io.DataDesc("data", (BATCH, L))],
                 label_shapes=[mx.io.DataDesc("softmax_label", (BATCH, L))])
        mod.init_params(arg_params={k: mx.nd.array(v) for k, v in _params().items()})
        mod.init_optimizer(kvstore="local", optimizer="sgd",
                           optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)))
        for L, x, y in batches:
            mod.forward_backward(mx.io.DataBatch(
                data=[mx.nd.array(x)], label=[mx.nd.array(y)], bucket_key=L,
                provide_data=[mx.io.DataDesc("data", (BATCH, L))],
                provide_label=[mx.io.DataDesc("softmax_label", (BATCH, L))]))
            mod.update()
        args, _ = mod.get_params()
        return mod, {k: v.asnumpy() for k, v in args.items()}


def test_fused_adapter_active_per_bucket():
    mod, _ = _train(pt, [pt.cpu(i) for i in range(4)], _host_batches(4))
    assert mod._curr_module._spmd is not None
    # every bound bucket has its own adapter, all sharing ONE state cell
    # and one set of tensors
    adapters = [m._spmd for m in mod._buckets.values()]
    assert len(adapters) == 2 and all(a is not None for a in adapters)
    assert len({id(a.trainer._state) for a in adapters}) == 1
    ptrs = [{k: v.data_ptr() for k, v in a.trainer.params.items()} for a in adapters]
    assert ptrs[0] == ptrs[1]


def test_params_match_legacy_path():
    batches = _host_batches(6)
    _, fused = _train(pt, [pt.cpu(i) for i in range(8)], batches, fused=True)
    _, legacy = _train(pt, [pt.cpu(0)], batches, fused=False)
    assert set(fused) == set(legacy)
    for k in fused:
        np.testing.assert_allclose(fused[k], legacy[k], rtol=RTOL, atol=ATOL,
                                   err_msg="param %s diverged (fused bucketing vs legacy)" % k)


@pytest.mark.parametrize("n_ctx", [2, 8])
def test_params_match_the_jax_fused_bucketing(n_ctx):
    batches = _host_batches(6)
    jmod, jax_p = _train(mxnet_tpu, [mxnet_tpu.cpu(i) for i in range(n_ctx)], batches)
    pmod, port_p = _train(pt, [pt.cpu(i) for i in range(n_ctx)], batches)
    assert jmod._curr_module._spmd is not None and pmod._curr_module._spmd is not None
    for k in jax_p:
        np.testing.assert_allclose(port_p[k], jax_p[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_checkpoint_after_bucketed_steps():
    """get_params sees weights updated through a non-default bucket."""
    batches = _host_batches(3)
    mod, params = _train(pt, [pt.cpu(i) for i in range(4)], batches)
    before = {k: v.copy() for k, v in params.items()}
    L, x, y = [b for b in batches if b[0] == min(BUCKETS)][0]
    with pt.cpu():
        mod.forward_backward(pt.io.DataBatch(
            data=[pt.nd.array(x)], label=[pt.nd.array(y)], bucket_key=L,
            provide_data=[pt.io.DataDesc("data", (BATCH, L))],
            provide_label=[pt.io.DataDesc("softmax_label", (BATCH, L))]))
        mod.update()
        args, _ = mod.get_params()
    changed = any(np.abs(args[k].asnumpy() - before[k]).max() > 1e-7 for k in before)
    assert changed, "a step through a non-default bucket must move params"


def _bucket_batch(L, x, y):
    return pt.io.DataBatch(
        data=[pt.nd.array(x)], label=[pt.nd.array(y)], bucket_key=L,
        provide_data=[pt.io.DataDesc("data", (BATCH, L))],
        provide_label=[pt.io.DataDesc("softmax_label", (BATCH, L))])


def test_every_buckets_executors_follow_the_shared_state():
    """A step through one bucket, a host read, then a forward through each
    bucket: every bucket's executors run on the shared cell's params, as a
    per-device module given those params does (rtol 1e-4, atol 1e-5)."""
    batches = _host_batches(5)
    mod, _ = _train(pt, [pt.cpu(i) for i in range(4)], batches[:3])  # ends on get_params
    with pt.cpu():
        for L in BUCKETS:  # bind both buckets' executors, then step the small one
            mod.forward(_bucket_batch(*[b for b in batches if b[0] == L][0]), is_train=False)
        mod.forward_backward(_bucket_batch(*batches[3]))
        mod.update()
        args, auxs = mod.get_params()
        params = {k: v.asnumpy() for k, v in args.items()}
        ref = pt.mod.BucketingModule(sym_gen=_sym_gen_of(pt), default_bucket_key=max(BUCKETS),
                                     context=[pt.cpu(0)], fused_step=False)
        ref.bind(data_shapes=[pt.io.DataDesc("data", (BATCH, max(BUCKETS)))],
                 label_shapes=[pt.io.DataDesc("softmax_label", (BATCH, max(BUCKETS)))],
                 for_training=False)
        ref.init_params(arg_params={k: pt.nd.array(v) for k, v in params.items()})
        for L in BUCKETS:
            b = [b for b in batches if b[0] == L][-1]
            mod.forward(_bucket_batch(*b), is_train=False)
            got = mod.get_outputs()[0].asnumpy()
            ref.forward(_bucket_batch(*b), is_train=False)
            want = ref.get_outputs()[0].asnumpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg="bucket %d" % L)
