"""Bucketing sentence iterator (reference: python/mxnet/rnn/io.py:61
BucketSentenceIter), the counterpart of ``mxnet_tpu/rnn/io.py``. Pads each
sentence to its bucket length; batches are grouped per bucket, so a
``BucketingModule`` binds one executor per bucket length, all sharing the
parameters. Batches are made on ``current_context()`` as it was when the
iterator was made (the card unless the caller runs in ``with cpu():``), as
``io.NDArrayIter`` does."""
from __future__ import annotations

import random as _pyrandom

import numpy as np

from ..io import DataBatch, DataDesc, DataIter
from ..context import current_context
from ..ndarray import array

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Iterate over sentences of varying length, bucketed + padded.

    ``sentences`` is a list of lists of int token ids. ``buckets`` is a sorted
    list of bucket lengths (auto-derived when None). ``invalid_label`` pads.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", label_shift=1, shuffle=True, seed=0):
        super().__init__(batch_size)
        if not buckets:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens) if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets = sorted(buckets)

        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[: len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        self.ndiscard = ndiscard

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.label_shift = label_shift
        self.shuffle = shuffle
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(buckets)
        self._rng = _pyrandom.Random(seed)
        self._ctx = current_context()

        self.provide_data = [DataDesc(data_name, self._shape(self.default_bucket_key), dtype, layout)]
        self.provide_label = [DataDesc(label_name, self._shape(self.default_bucket_key), dtype, layout)]
        self.reset()

    def _shape(self, seq_len):
        if self.major_axis == 0:
            return (self.batch_size, seq_len)
        return (seq_len, self.batch_size)

    def reset(self):
        self.curr_idx = 0
        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend((i, j) for j in range(0, len(buck) - self.batch_size + 1, self.batch_size))
        if self.shuffle:
            self._rng.shuffle(self.idx)
            for buck in self.data:
                self._rng.shuffle(list(range(len(buck))))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        buck = self.data[i][j : j + self.batch_size]
        # next-token label, like the reference examples: label[t] = data[t+1]
        label = np.full_like(buck, self.invalid_label)
        label[:, : -self.label_shift] = buck[:, self.label_shift :]
        if self.major_axis == 1:
            buck = buck.T
            label = label.T
        seq_len = self.buckets[i]
        return DataBatch(
            [array(buck, ctx=self._ctx)], [array(label, ctx=self._ctx)], pad=0,
            bucket_key=seq_len,
            provide_data=[DataDesc(self.data_name, buck.shape, buck.dtype, "NT" if self.major_axis == 0 else "TN")],
            provide_label=[DataDesc(self.label_name, label.shape, label.dtype, "NT" if self.major_axis == 0 else "TN")],
        )
