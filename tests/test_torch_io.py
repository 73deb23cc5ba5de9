"""The port's data iterators against the JAX package's: the same sources
give the same batches, pad and index, bitwise, through ``NDArrayIter``
(pad, discard, roll_over, shuffle under the same ``np.random.seed``, dict
and list sources), ``ResizeIter``, ``PrefetchingIter``, and ``CSVIter`` and
``MNISTIter`` over files the test writes. ``DevicePrefetchIter`` on
``cpu()`` is the identity; on the card, ``test_torch_cuda.py``."""
import gzip
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt

torch.set_num_threads(1)


def _epochs(it, n=2):
    """[(data arrays, label arrays, pad, index)] over ``n`` epochs."""
    out = []
    for _ in range(n):
        for b in it:
            out.append(([d.asnumpy() for d in b.data], [lb.asnumpy() for lb in (b.label or [])],
                        b.pad, None if b.index is None else list(b.index)))
        it.reset()
    return out


def _same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp, gi), (wd, wl, wp, wi) in zip(got, want):
        assert gp == wp and gi == wi
        for g, w in zip(gd + gl, wd + wl):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _both(make, seed=None):
    """``make(pkg)`` run in each package (the port on the CPU), after the
    same ``np.random.seed`` when given: (port epochs, JAX epochs)."""
    res = []
    for pkg in (pt, mx):
        if seed is not None:
            np.random.seed(seed)
        if pkg is pt:
            with pt.cpu():
                it = make(pkg)
                res.append(_epochs(it))
        else:
            res.append(_epochs(make(pkg)))
    return res


X = np.arange(11 * 6, dtype="f").reshape(11, 2, 3)
Y = np.arange(11, dtype="f") * 0.5


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    got, want = _both(lambda p: p.io.NDArrayIter(X, Y, batch_size=4, shuffle=shuffle,
                                                 last_batch_handle=handle), seed=3)
    _same(got, want)


def test_ndarray_iter_dict_and_list_sources_and_descs_match_jax():
    def make(p):
        return p.io.NDArrayIter({"a": X, "b": X[:, :1] * 2}, [Y, Y + 1], batch_size=5)

    got, want = _both(make)
    _same(got, want)
    with pt.cpu():
        pit = make(pt)
    jit = make(mx)
    assert [(d.name, d.shape) for d in pit.provide_data + pit.provide_label] == \
        [(d.name, d.shape) for d in jit.provide_data + jit.provide_label]


def test_ndarray_iter_keeps_its_data_on_its_context():
    with pt.cpu():
        it = pt.io.NDArrayIter(X, Y, batch_size=4)
    b = next(it)
    assert b.data[0].context == pt.cpu() and b.label[0].context == pt.cpu()
    # a full batch is a view of the source on its device, not a host copy
    assert b.data[0]._chunk is it.data[0][1]._chunk


def test_resize_iter_matches_jax():
    got, want = _both(lambda p: p.io.ResizeIter(p.io.NDArrayIter(X, Y, batch_size=3), 7))
    _same(got, want)


def test_prefetching_iter_matches_jax():
    def make(p):
        a = p.io.NDArrayIter(X, Y, batch_size=4, last_batch_handle="discard")
        b = p.io.NDArrayIter(X * 2, Y * 3, batch_size=4, last_batch_handle="discard",
                             data_name="data2", label_name="label2")
        return p.io.PrefetchingIter([a, b], prefetch_depth=3)

    got, want = _both(make)
    _same(got, want)


def test_device_prefetch_iter_on_the_cpu_is_the_identity():
    with pt.cpu():
        plain = _epochs(pt.io.NDArrayIter(X, Y, batch_size=4))
        it = pt.io.DevicePrefetchIter(pt.io.NDArrayIter(X, Y, batch_size=4), device=pt.cpu())
        wrapped = _epochs(it)
        assert it.provide_data[0].shape == (4, 2, 3)
    _same(wrapped, plain)


def test_device_prefetch_env_wraps_fit_with_the_same_result(monkeypatch):
    """``MXNET_IO_DEVICE_PREFETCH=1``: ``Module.fit`` trains through a
    DevicePrefetchIter onto the module's context, bit-identically."""
    def fit():
        with pt.cpu():
            np.random.seed(0)
            net = pt.sym.SoftmaxOutput(pt.sym.FullyConnected(
                pt.sym.Flatten(pt.sym.Variable("data")), num_hidden=3, name="fc"),
                name="softmax")
            mod = pt.mod.Module(net, context=pt.cpu())
            rs = np.random.RandomState(1)
            mod.fit(pt.io.NDArrayIter(X, (Y * 2) % 3, batch_size=4, shuffle=True),
                    arg_params={"fc_weight": pt.nd.array(rs.randn(3, 6) * 0.1),
                                "fc_bias": pt.nd.zeros((3,))}, num_epoch=2)
            return mod.get_params()[0]["fc_weight"].asnumpy()

    plain = fit()
    monkeypatch.setenv("MXNET_IO_DEVICE_PREFETCH", "1")
    assert pt.io.device_prefetch_enabled()
    np.testing.assert_array_equal(fit(), plain)


def test_csv_iter_matches_jax(tmp_path):
    rs = np.random.RandomState(0)
    data, label = rs.randn(9, 6).astype("f"), rs.randint(0, 3, (9, 1)).astype("f")
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    got, want = _both(lambda p: p.io.CSVIter(dpath, (2, 3), label_csv=lpath, batch_size=4))
    _same(got, want)


def _write_idx(path, arr, code, gz=False):
    dims = arr.shape
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", (code << 8) | len(dims)))
        for d in dims:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(arr.dtype.newbyteorder(">")).tobytes())


@pytest.mark.parametrize("flat", [False, True])
def test_mnist_iter_matches_jax_on_idx_files(tmp_path, flat):
    """The port's MNISTIter over idx files against JAX's NDArrayIter over the
    same arrays, scaled, shaped, shuffled and cut as JAX's MNISTIter does
    (``mxnet_tpu/io.py:741-763``). JAX's own MNISTIter cannot read an idx
    file under numpy 2: its reader calls ``newbyteorder`` on the scalar
    type (``mxnet_tpu/io.py:727``), which numpy 2 removed."""
    rs = np.random.RandomState(4)
    images = rs.randint(0, 256, (37, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 37).astype(np.uint8)
    ipath, lpath = str(tmp_path / "img-idx3-ubyte.gz"), str(tmp_path / "lbl-idx1-ubyte")
    _write_idx(ipath, images, 0x08, gz=True)
    _write_idx(lpath, labels, 0x08)
    np.testing.assert_array_equal(pt.io._read_idx_file(ipath), images)
    np.testing.assert_array_equal(pt.io._read_idx_file(lpath), labels)
    x = images.astype(np.float32) / 255.0
    x = x.reshape(37, -1) if flat else x.reshape(37, 1, 28, 28)

    def make(p):
        if p is pt:
            return pt.io.MNISTIter(ipath, lpath, batch_size=10, shuffle=True, flat=flat)
        return mx.io.NDArrayIter(x, labels.astype(np.float32), batch_size=10, shuffle=True,
                                 last_batch_handle="discard")

    got, want = _both(make, seed=9)
    _same(got, want)
    assert got[0][0][0].shape == ((10, 784) if flat else (10, 1, 28, 28))
    assert len(got) == 6  # 3 whole batches an epoch: the last 7 images are discarded
