"""Sharded-checkpoint round trips of row-sparse tables, on both packages.

Every case of the reference's ``tests/test_sparse_checkpoint.py`` runs here
on BOTH packages (fixture ``mx``, the port inside ``with cpu():``): the
manifest's ``sparse`` section (worker r writes the r-th piece of each dense
table and of its touched-index set with the state rows), re-assembled by
concatenation for any reader world; uneven and empty splits; the nnz guard;
a local store's ``save_sharded`` → fresh store ``load_sharded_checkpoint``
with weights, state rows, the touched set and update counts bit for bit;
the replicated state pickle keeping dense keys beside sparse ones.
``tests/test_torch_checkpoint.py`` crosses such a set between the packages.
"""
import hashlib
import io
import json
import os

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


V, D = 24, 4


def _tables(mx, rs, nnz_rows):
    st = mx.sparse.RowSparseState((V, D), "float32", 2)
    idx = np.asarray(sorted(nnz_rows), np.int64)
    st.scatter(idx, [rs.rand(idx.size, D).astype("float32"),
                     rs.rand(idx.size, D).astype("float32")])
    return {"emb": {"shape": (V, D), "dtype": "float32",
                    "w": rs.rand(V, D).astype("float32"),
                    "indices": st.indices,
                    "states": [r.copy() for r in st.rows]}}


def _write_step(ckpt, root, step, world, tables, n_states=2):
    d = ckpt.step_dir(root, step)
    os.makedirs(d, exist_ok=True)
    for rank in range(world):
        local = ckpt.sparse_shard_arrays(tables, rank, world)
        buf = io.BytesIO()
        np.savez(buf, **local)
        data = buf.getvalue()
        base = os.path.join(d, "shard-%05d-of-%05d" % (rank, world))
        with open(base + ".npz", "wb") as f:
            f.write(data)
        with open(base + ".json", "w") as f:
            json.dump({"digest": hashlib.sha256(data).hexdigest(),
                       "rank": rank, "world": world, "step": step,
                       "plan_hash": None, "nbytes": len(data)}, f)
    manifest = {"format": 1, "kind": "sharded", "step": step, "world": world,
                "plan_hash": None, "plan": {"buckets": []},
                "sparse": ckpt.sparse_manifest_section(tables),
                "optimizer": {"kind": "adam", "n_states": n_states,
                              "hyper": {}, "class": "Adam"},
                "update_counts": [["emb", 3]], "num_update": 3, "files": []}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def _assert_tables_equal(got, want):
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["indices"], want["indices"])
    assert len(got["states"]) == len(want["states"])
    for a, b in zip(got["states"], want["states"]):
        np.testing.assert_array_equal(a, b)


def test_save_w2_resume_w2_and_w1_bit_parity(mx, tmp_path):
    """The satellite's core claim: shards written under W=2 re-assemble
    bit-identically for a W=2 AND a W=1 reader (the reader never needs the
    writer's world — concatenation is world-agnostic)."""
    rs = np.random.RandomState(0)
    tables = _tables(mx, rs, [1, 5, 9, 17, 22])
    root = str(tmp_path)
    manifest = _write_step(mx.checkpoint, root, 11, world=2, tables=tables)
    got = mx.checkpoint.latest_complete(root)
    assert got is not None and got[0] == 11
    # any-world readers: the manifest names the WRITER world; readers of
    # any live world call the same re-assembly
    out = mx.checkpoint.read_sparse_tables(root, 11, manifest)
    _assert_tables_equal(out["emb"], tables["emb"])


def test_uneven_nnz_split_across_workers(mx, tmp_path):
    """nnz not divisible by world: np.array_split slices must still
    re-assemble exactly (the W-1 resume's bread and butter)."""
    rs = np.random.RandomState(1)
    tables = _tables(mx, rs, [2, 3, 19])  # 3 rows over 2 workers
    manifest = _write_step(mx.checkpoint, str(tmp_path), 5, world=2, tables=tables)
    out = mx.checkpoint.read_sparse_tables(str(tmp_path), 5, manifest)
    _assert_tables_equal(out["emb"], tables["emb"])
    # and over 3 workers (one worker gets a zero-row piece)
    manifest = _write_step(mx.checkpoint, str(tmp_path), 6, world=3, tables=tables)
    out = mx.checkpoint.read_sparse_tables(str(tmp_path), 6, manifest)
    _assert_tables_equal(out["emb"], tables["emb"])


def test_zero_nnz_table_round_trips(mx, tmp_path):
    rs = np.random.RandomState(2)
    tables = _tables(mx, rs, [])
    manifest = _write_step(mx.checkpoint, str(tmp_path), 1, world=2, tables=tables)
    out = mx.checkpoint.read_sparse_tables(str(tmp_path), 1, manifest)
    assert out["emb"]["indices"].size == 0
    np.testing.assert_array_equal(out["emb"]["w"], tables["emb"]["w"])


def test_manifest_nnz_mismatch_raises(mx, tmp_path):
    rs = np.random.RandomState(3)
    tables = _tables(mx, rs, [4, 8])
    manifest = _write_step(mx.checkpoint, str(tmp_path), 2, world=2, tables=tables)
    manifest["sparse"][0]["nnz"] = 99
    with pytest.raises(mx.base.MXNetError):
        mx.checkpoint.read_sparse_tables(str(tmp_path), 2, manifest)


def test_kvstore_save_resume_full_stack(mx, tmp_path):
    """Local-store end to end: sparse fit → Checkpointer.save_sharded →
    fresh store load_sharded_checkpoint → weights, state rows, touched set
    and update counts all bit-identical."""
    rs = np.random.RandomState(4)
    kv = mx.kv.create("local")
    opt = mx.optimizer.Adam(learning_rate=0.01)
    kv.set_optimizer(opt)
    w0 = rs.rand(V, D).astype("float32")
    kv.init("emb", mx.nd.array(w0))
    for _ in range(3):
        ids = rs.randint(0, V, (6,))
        og = rs.rand(6, D).astype("float32")
        kv.push("emb", mx.sparse.embedding_backward(ids, mx.nd.array(og), V))
    writer = mx.checkpoint.Checkpointer(str(tmp_path))
    try:
        writer.save_sharded(kv, 9, block=True)
    finally:
        writer.close()
    manifest = mx.checkpoint.load_manifest(str(tmp_path), 9)
    assert manifest["sparse"] and manifest["plan"]["buckets"] == []

    kv2 = mx.kv.create("local")
    opt2 = mx.optimizer.Adam(learning_rate=0.01)
    kv2.set_optimizer(opt2)
    kv2.init("emb", mx.nd.zeros((V, D)))
    step, _ = kv2.load_sharded_checkpoint(str(tmp_path))
    assert step == 9
    a = mx.nd.zeros((V, D))
    kv.pull("emb", out=a)
    b = mx.nd.zeros((V, D))
    kv2.pull("emb", out=b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    st1, st2 = kv._updater.states["emb"], kv2._updater.states["emb"]
    assert isinstance(st2, mx.sparse.RowSparseState)
    np.testing.assert_array_equal(st1.indices, st2.indices)
    for x, y in zip(st1.rows, st2.rows):
        np.testing.assert_array_equal(x, y)
    assert opt2._index_update_count == opt._index_update_count
    # and the resumed store trains on identically: one more identical round
    ids = rs.randint(0, V, (6,))
    og = rs.rand(6, D).astype("float32")
    kv.push("emb", mx.sparse.embedding_backward(ids, mx.nd.array(og), V))
    kv2.push("emb", mx.sparse.embedding_backward(ids, mx.nd.array(og), V))
    kv.pull("emb", out=a)
    kv2.pull("emb", out=b)
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_save_optimizer_states_keeps_dense_keys_next_to_sparse(mx, tmp_path):
    """Regression: a mixed store (sparse table + dense FC) must persist BOTH
    keys' optimizer state through save/load_optimizer_states — an early
    sparse-only reroute into the sharded writer silently dropped every
    dense key's momentum."""
    rs = np.random.RandomState(6)
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv.init("emb", mx.nd.array(rs.rand(V, D).astype("float32")))
    kv.init("fc_weight", mx.nd.array(rs.rand(8, 4).astype("float32")))
    ids = rs.randint(0, V, (5,))
    og = rs.rand(5, D).astype("float32")
    kv.push("emb", mx.sparse.embedding_backward(ids, mx.nd.array(og), V))
    kv.push("fc_weight", mx.nd.array(rs.rand(8, 4).astype("float32")))
    path = str(tmp_path / "opt.states")
    kv.save_optimizer_states(path)
    kv2 = mx.kv.create("local")
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv2.load_optimizer_states(path)
    assert set(kv2._updater.states) == {"emb", "fc_weight"}
    assert isinstance(kv2._updater.states["emb"], mx.sparse.RowSparseState)
    np.testing.assert_array_equal(
        kv2._updater.states["fc_weight"].asnumpy(),
        kv._updater.states["fc_weight"].asnumpy())


def test_updater_state_pickle_round_trip(mx):
    """RowSparseState must survive the classic per-key state pickle
    (save_optimizer_states' replicated path)."""
    rs = np.random.RandomState(5)
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv.init("emb", mx.nd.array(rs.rand(V, D).astype("float32")))
    ids = rs.randint(0, V, (5,))
    og = rs.rand(5, D).astype("float32")
    kv.push("emb", mx.sparse.embedding_backward(ids, mx.nd.array(og), V))
    blob = kv._updater.get_states()
    kv2 = mx.kv.create("local")
    kv2.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    kv2._updater.set_states(blob)
    st1, st2 = kv._updater.states["emb"], kv2._updater.states["emb"]
    np.testing.assert_array_equal(st1.indices, st2.indices)
    for x, y in zip(st1.rows, st2.rows):
        np.testing.assert_array_equal(x, y)
