"""The port's image pipeline (``mxnet_tpu_torch/image.py`` over
``image_native.py``) against the JAX package's.

A ``.rec``/``.idx`` pack of JPEG records made from a numpy seed is read by
both packages' ``ImageRecordIter`` with the same arguments and seed: on
the native C++ pipeline (each package's build of ``src/image_native.cc``)
and on the Python path (``MXNET_NATIVE_IMAGE_PIPELINE=0``), shuffled, with
random crops and mirrors, over two epochs and a short last batch, the
batches are bitwise equal. ``ImageDetIter``'s labels and ``ImageIter``'s
batches from an image list match too, and the MNIST ``mlp`` trained by
``Module.fit`` from an ``ImageRecordIter`` ends at JAX's weights (rtol
1e-5, atol 1e-6). The port's batches land on the CPU here (the default
context of the tests); on the card they go through page-locked buffers
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import image as jimage
from mxnet_tpu import image_native as jnative
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image as pimage
from mxnet_tpu_torch import image_native as pnative

PKGS = {"jax": jimage, "torch": pimage}


def _pack(tmp_path, n=21, size=40, label_width=1, seed=0):
    rs = np.random.RandomState(seed)
    rec = jrec.MXIndexedRecordIO(str(tmp_path / "p.idx"), str(tmp_path / "p.rec"), "w")
    for i in range(n):
        img = rs.randint(0, 255, (size, size + 6, 3), np.uint8)
        label = float(i % 5) if label_width == 1 else rs.rand(label_width).astype(np.float32)
        rec.write_idx(i, jrec.pack_img((0, label, i, 0), img, quality=92))
    rec.close()
    return str(tmp_path / "p.rec"), str(tmp_path / "p.idx")


def _epochs(mod, rec, idx, epochs=2, **kw):
    it = mod.ImageRecordIter(rec, (3, 32, 32), 8, path_imgidx=idx, **kw)
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return it, out


AUG = dict(shuffle=True, rand_crop=True, rand_mirror=True, mean_r=123.68, mean_g=116.779,
           mean_b=103.939, std_r=58.4, std_g=57.1, std_b=57.4, seed=5)
# the native pipeline draws crops and mirrors from one generator a worker
# (src/image_native.cc:373), and which worker takes a record is a race, so
# its random augments repeat with one worker; the Python path draws a seed
# a record and repeats with any number of threads
THREADS = {True: 1, False: 3}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_image_record_iter_batches_are_bitwise_the_references(tmp_path, monkeypatch, native):
    if native and not (pnative.available() and jnative.available()):
        pytest.skip("no toolchain for the native image pipeline")
    if not native:
        monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", "0")
    rec, idx = _pack(tmp_path)
    (pit, got), (jit, want) = (_epochs(m, rec, idx, preprocess_threads=THREADS[native], **AUG)
                               for m in (pimage, jimage))
    assert pit.native == native and (jit._native is not None) == native
    assert len(got) == len(want) == 6
    assert [b[2] for b in got] == [0, 0, 3] * 2
    for (gd, gl, _), (wd, wl, _) in zip(got, want):
        assert gd.shape == (8, 3, 32, 32) and gl.shape == (8,)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    # the two epochs were shuffled differently
    assert not np.array_equal(got[0][1], got[3][1])


def test_label_arrays_and_unshuffled_order_on_both_paths(tmp_path, monkeypatch):
    rec, idx = _pack(tmp_path, n=10, label_width=3)
    runs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", flag)
        for name, mod in PKGS.items():
            _, runs[flag, name] = _epochs(mod, rec, idx, epochs=1, label_width=3,
                                          round_batch=False, preprocess_threads=2)
    for key, batches in runs.items():
        assert len(batches) == 1 and batches[0][1].shape == (8, 3), key
        np.testing.assert_array_equal(batches[0][1], runs["0", "jax"][0][1])
        np.testing.assert_array_equal(batches[0][0], runs[key[0], "jax"][0][0])


def test_native_and_python_paths_agree_within_the_decoders_rounding(tmp_path, monkeypatch):
    """The JAX package's tolerance between the two decoders
    (tests/test_image_native.py: mean |diff| < 0.02, max < 0.2) on one
    unaugmented batch."""
    if not pnative.available():
        pytest.skip("no toolchain for the native image pipeline")
    rec, idx = _pack(tmp_path, n=8, size=32, seed=3)
    kw = dict(mean_r=120.0, mean_g=115.0, mean_b=100.0, std_r=58.0, std_g=57.0, std_b=56.0)
    nat = pimage.ImageRecordIter(rec, (3, 32, 32), 8, path_imgidx=idx, **kw)
    monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", "0")
    py = pimage.ImageRecordIter(rec, (3, 32, 32), 8, path_imgidx=idx, **kw)
    assert nat.native and not py.native
    a, b = nat.next().data[0].asnumpy(), py.next().data[0].asnumpy()
    assert np.abs(a - b).mean() < 0.02 and np.abs(a - b).max() < 0.2


@pytest.mark.parametrize("native", ["1", "0"])
def test_image_det_iter_labels_match(tmp_path, monkeypatch, native):
    monkeypatch.setenv("MXNET_NATIVE_IMAGE_PIPELINE", native)
    rs = np.random.RandomState(1)
    rec = jrec.MXIndexedRecordIO(str(tmp_path / "d.idx"), str(tmp_path / "d.rec"), "w")
    for i in range(6):
        img = rs.randint(0, 255, (48, 48, 3), np.uint8)
        boxes = np.concatenate([[i % 3], np.sort(rs.rand(2)), np.sort(rs.rand(2)),
                                [1], [0.1, 0.2, 0.7, 0.8]]).astype(np.float32)
        rec.write_idx(i, jrec.pack_img((0, boxes[[0, 1, 3, 2, 4, 5, 6, 7, 8, 9]], i, 0), img,
                                       img_fmt=".png"))
    rec.close()
    out = {}
    for name, mod in PKGS.items():
        it = mod.ImageDetIter(path_imgrec=str(tmp_path / "d.rec"), data_shape=(3, 40, 40),
                              batch_size=4, max_objects=3, rand_crop=True, rand_mirror=True,
                              seed=2, preprocess_threads=1)
        out[name] = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    assert len(out["torch"]) == len(out["jax"]) == 2
    for (gd, gl), (wd, wl) in zip(out["torch"], out["jax"]):
        assert gl.shape == (4, 3, 5)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_image_iter_from_a_list_matches(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(2)
    lines = []
    for i in range(6):
        Image.fromarray(rs.randint(0, 255, (30, 36, 3), np.uint8)).save(
            str(tmp_path / ("%d.png" % i)))
        lines.append("%d\t%d\t%d.png" % (i, i % 2, i))
    (tmp_path / "list.lst").write_text("\n".join(lines) + "\n")
    out = {}
    for name, mod in PKGS.items():
        it = mod.ImageIter(batch_size=3, data_shape=(3, 24, 24),
                           path_imglist=str(tmp_path / "list.lst"), path_root=str(tmp_path),
                           shuffle=True, seed=4)
        out[name] = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    assert len(out["torch"]) == 2
    for (gd, gl), (wd, wl) in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_module_fit_from_image_record_iter_matches(tmp_path):
    rec, idx = _pack(tmp_path, n=24, size=28, seed=6)
    rs = np.random.RandomState(7)
    net_j = mx.models.mlp.get_symbol(num_classes=5)
    shapes = dict(zip(net_j.list_arguments(),
                      net_j.infer_shape(data=(8, 3, 28, 28), softmax_label=(8,))[0]))
    init = {n: (rs.randn(*s) * 0.01).astype(np.float32) for n, s in shapes.items()
            if n not in ("data", "softmax_label")}
    kw = dict(shuffle=True, rand_mirror=True, mean_r=128.0, mean_g=128.0, mean_b=128.0,
              std_r=64.0, std_g=64.0, std_b=64.0, preprocess_threads=THREADS[True], seed=1)
    fit = dict(num_epoch=2, optimizer="sgd", eval_metric="acc",
               optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    got = {}
    for name, pkg in (("jax", mx), ("torch", pt)):
        it = pkg.image.ImageRecordIter(rec, (3, 28, 28), 8, path_imgidx=idx, **kw)
        mod = pkg.mod.Module(pkg.models.mlp.get_symbol(num_classes=5), context=pkg.cpu())
        mod.fit(it, arg_params={k: pkg.nd.array(v) for k, v in init.items()}, **fit)
        got[name] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert sorted(got["torch"]) == sorted(got["jax"])
    for k, want in got["jax"].items():
        assert not np.array_equal(want, init[k]), k
        np.testing.assert_allclose(got["torch"][k], want, rtol=1e-5, atol=1e-6, err_msg=k)


def test_a_missing_native_library_selects_the_python_path(tmp_path, monkeypatch):
    """The selection the JAX package makes (``image.py:317-358``): no
    native library, the Python path; ``native`` says which ran."""
    rec, idx = _pack(tmp_path, n=8)
    monkeypatch.setattr(pnative, "_load", lambda: None)
    it = pimage.ImageRecordIter(rec, (3, 32, 32), 8, path_imgidx=idx)
    assert not it.native
    assert it.next().data[0].shape == (8, 3, 32, 32)


def test_the_gpu_default_without_a_card_raises_at_construction(tmp_path, monkeypatch):
    """No CPU fallback: with the default context the card and no CUDA, the
    iterator refuses when it is made, not at its first batch."""
    import torch

    rec, idx = _pack(tmp_path, n=8)
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pt.MXNetError, match="CUDA is not available"):
        pimage.ImageRecordIter(rec, (3, 32, 32), 8, path_imgidx=idx)
    with pt.cpu():
        assert pimage.ImageRecordIter(rec, (3, 32, 32), 8, path_imgidx=idx).next() \
            .data[0].context == pt.cpu()
