"""The port's RecordIO (``mxnet_tpu_torch/recordio.py``) and native IO
reader (``io_native.py``) against the JAX package's.

The same records, made from a numpy seed, written by either package give
byte-identical ``.rec`` and ``.idx`` files, and each package reads the
other's: payloads, ``IRHeader`` fields, label arrays (``flag`` > 0) and
indexed seeks. ``pack_img``/``unpack_img`` encode the same bytes and decode
the same pixels. The native sequential and prefetching readers and
``read_idx`` (built into ``build/torch_native/``) return what JAX's do.
"""
import numpy as np
import pytest

import mxnet_tpu.io_native as jio
import mxnet_tpu.recordio as jrec
import mxnet_tpu_torch.io_native as pio
import mxnet_tpu_torch.recordio as prec

PKGS = {"jax": jrec, "torch": prec}


def _records(n=23, seed=0):
    """(header, payload) pairs: scalar labels, label arrays of several
    widths, payloads of every length mod 4 (the framing's padding)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        payload = rs.bytes(int(rs.randint(0, 70)))
        if i % 3 == 0:
            label = rs.randn(int(rs.randint(1, 6))).astype(np.float32)
        else:
            label = float(rs.randint(0, 1000))
        out.append(((0, label, i, 7 * i), payload))
    return out


def _write(rec_mod, tmp_path, name, records):
    rec = rec_mod.MXIndexedRecordIO(str(tmp_path / (name + ".idx")),
                                    str(tmp_path / (name + ".rec")), "w")
    for i, (header, payload) in enumerate(records):
        rec.write_idx(i, rec_mod.pack(header, payload))
    rec.close()
    return tmp_path / (name + ".rec"), tmp_path / (name + ".idx")


def _same_header(got, want):
    assert (got.flag, got.id, got.id2) == (want.flag, want.id, want.id2)
    np.testing.assert_array_equal(np.asarray(got.label), np.asarray(want.label))


def test_files_are_byte_identical_and_read_back_in_the_other(tmp_path):
    records = _records()
    files = {k: _write(m, tmp_path, k, records) for k, m in PKGS.items()}
    for a, b in zip(files["jax"], files["torch"]):
        assert a.read_bytes() == b.read_bytes(), a.name
    order = np.random.RandomState(1).permutation(len(records))
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        rec_path, idx_path = files[writer]
        seq = PKGS[reader].MXRecordIO(str(rec_path), "r")
        idx = PKGS[reader].MXIndexedRecordIO(str(idx_path), str(rec_path), "r")
        for i in range(len(records)):
            want = PKGS[writer].unpack(PKGS[writer].pack(*records[i]))
            got = PKGS[reader].unpack(seq.read())
            _same_header(got[0], want[0])
            assert got[1] == want[1] == records[i][1]
        assert seq.read() is None
        assert idx.keys == list(range(len(records)))
        for i in order:  # seeks in a shuffled order
            header, payload = PKGS[reader].unpack(idx.read_idx(int(i)))
            assert payload == records[i][1]
            if isinstance(records[i][0][1], np.ndarray):
                assert header.flag == records[i][0][1].size
                np.testing.assert_array_equal(header.label, records[i][0][1])
            else:
                assert header.flag == 0 and header.label == records[i][0][1]
        seq.close()
        idx.close()


def test_a_corrupt_magic_raises_in_both(tmp_path):
    for name, mod in PKGS.items():
        path = tmp_path / (name + ".rec")
        path.write_bytes(b"\x00" * 16)
        with pytest.raises(Exception, match="magic"):
            mod.MXRecordIO(str(path), "r").read()


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_bytes_and_unpack_img_pixels_match(fmt):
    img = np.random.RandomState(2).randint(0, 255, (24, 20, 3), np.uint8)
    header = (0, np.array([1.0, 2.0], np.float32), 5, 0)
    blobs = {k: m.pack_img(header, img, quality=90, img_fmt=fmt) for k, m in PKGS.items()}
    assert blobs["jax"] == blobs["torch"]
    hj, ij = jrec.unpack_img(blobs["jax"])
    hp, ip = prec.unpack_img(blobs["torch"])
    _same_header(hp, hj)
    np.testing.assert_array_equal(ip, ij)
    if fmt == ".png":
        np.testing.assert_array_equal(ip, img)


def _seq_file(tmp_path, n):
    rs = np.random.RandomState(3)
    payloads = [rs.bytes(int(rs.randint(1, 90))) for _ in range(n)]
    w = prec.MXRecordIO(str(tmp_path / "seq.rec"), "w")
    for p in payloads:
        w.write(p)
    w.close()
    return str(tmp_path / "seq.rec"), payloads


@pytest.fixture(scope="module")
def native():
    if not (pio.available() and jio.available()):
        pytest.skip("no toolchain for the native IO libraries")


def test_native_readers_match_the_reference(tmp_path, native):
    path, payloads = _seq_file(tmp_path, 150)
    for cls in ("NativeRecordIOReader", "NativePrefetchReader"):
        args = (path,) if cls == "NativeRecordIOReader" else (path, 8)
        got = list(getattr(pio, cls)(*args))
        want = list(getattr(jio, cls)(*args))
        assert got == want == payloads, cls


def test_native_read_idx_matches_the_reference(tmp_path, native):
    arr = np.random.RandomState(4).randint(0, 255, (3, 5, 7)).astype(np.uint8)
    path = tmp_path / "images-idx3-ubyte"
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, 3]))
        for d in arr.shape:
            f.write(int(d).to_bytes(4, "big"))
        f.write(arr.tobytes())
    for fn in (pio.read_idx, pio._read_idx_py, jio.read_idx):
        np.testing.assert_array_equal(fn(str(path)), arr)
    assert pio._lib is not None and pio._lib._name.endswith("build/torch_native/libmxtpu_io.so")
