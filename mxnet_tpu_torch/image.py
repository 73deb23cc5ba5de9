# copied from mxnet_tpu/image.py (backend-free); batches are staged through page-locked buffers
"""Image data pipeline: decode, augment, batch.

Counterpart of ``mxnet_tpu/image.py`` (reference: the C++ record iterators,
src/io/iter_image_recordio_2.cc:559 and src/io/image_aug_default.cc, and
python ``mxnet/image.py``). Decode and augment run on host threads: the
native C++ pipeline (``image_native``: libjpeg/libpng, off the GIL) when it
is built and the augment set is expressible there, else a thread pool per
iterator over cv2 or PIL (``preprocess_threads``). Batches are fixed-shape
NCHW float32 NDArrays on the default context at construction, the card
unless a ``with cpu():`` block or ``MXNET_DEFAULT_CONTEXT`` says otherwise.

For a batch on the card the pipeline writes into one of two page-locked
host buffers (``_HostStaging``), which is copied to the card with
``non_blocking=True`` on the current stream; an event recorded after the
copy is waited on before that buffer is written again, so the decode of
batch N+1 overlaps the copy and the step of batch N.

JPEG/PNG codec for the Python path: cv2 when installed, else PIL.
"""
from __future__ import annotations

import os
import random as _random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .base import MXNetError
from . import io as _io
from .context import current_context
from .ndarray import _wrap
from .recordio import MXIndexedRecordIO, MXRecordIO, unpack, _decode_img

__all__ = [
    "imdecode", "imresize", "fixed_crop", "random_crop", "center_crop",
    "color_normalize", "HorizontalFlipAug", "ResizeAug", "ForceResizeAug",
    "RandomCropAug", "CenterCropAug", "BrightnessJitterAug",
    "ContrastJitterAug", "SaturationJitterAug", "ColorNormalizeAug", "CastAug",
    "CreateAugmenter", "ImageIter", "ImageRecordIter", "ImageDetIter",
]


# --------------------------------------------------------------------- codec
def imdecode(buf, to_rgb=True, flag=1):
    """Decode jpeg/png bytes to an HWC uint8 array (reference: image.py
    imdecode over cv2; here cv2-or-PIL). Returns RGB by default."""
    img = _decode_img(bytes(buf), 1 if flag else 0)
    if img.ndim == 3 and to_rgb:
        img = img[:, :, ::-1]  # disk convention is BGR (cv2-compatible)
    return img


def imresize(src, w, h, interp=2):
    """Resize HWC array to (h, w) (reference: image.py resize_short/imresize)."""
    try:
        import cv2

        return cv2.resize(src, (w, h), interpolation=interp)
    except ImportError:
        from PIL import Image

        pil = Image.fromarray(np.asarray(src, np.uint8))
        return np.asarray(pil.resize((w, h), Image.BILINEAR))


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h):
    return src[y0:y0 + h, x0:x0 + w]


def random_crop(src, size, rng=None):
    """(reference: image.py random_crop) size = (w, h)."""
    rng = rng or _random
    h, w = src.shape[:2]
    cw, ch = size
    if w < cw or h < ch:
        src = imresize(src, max(w, cw), max(h, ch))
        h, w = src.shape[:2]
    x0 = rng.randint(0, w - cw) if w > cw else 0
    y0 = rng.randint(0, h - ch) if h > ch else 0
    return fixed_crop(src, x0, y0, cw, ch), (x0, y0, cw, ch)


def center_crop(src, size):
    h, w = src.shape[:2]
    cw, ch = size
    if w < cw or h < ch:
        src = imresize(src, max(w, cw), max(h, ch))
        h, w = src.shape[:2]
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return fixed_crop(src, x0, y0, cw, ch), (x0, y0, cw, ch)


def color_normalize(src, mean, std=None):
    src = src.astype(np.float32) - mean
    if std is not None:
        src /= std
    return src


# ----------------------------------------------------------------- augmenters
class Augmenter:
    """One augmentation step; called with an HWC float/uint8 array."""

    def __call__(self, src, rng):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp

    def __call__(self, src, rng):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size, self.interp = size, interp  # (w, h)

    def __call__(self, src, rng):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size

    def __call__(self, src, rng):
        return random_crop(src, self.size, rng)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        self.size = size

    def __call__(self, src, rng):
        return center_crop(src, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, rng):
        return src[:, ::-1] if rng.random() < self.p else src


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        self.brightness = brightness

    def __call__(self, src, rng):
        alpha = 1.0 + rng.uniform(-self.brightness, self.brightness)
        return src.astype(np.float32) * alpha


class ContrastJitterAug(Augmenter):
    _coef = np.array([0.299, 0.587, 0.114], np.float32)

    def __init__(self, contrast):
        self.contrast = contrast

    def __call__(self, src, rng):
        alpha = 1.0 + rng.uniform(-self.contrast, self.contrast)
        src = src.astype(np.float32)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray.mean() * (1.0 - alpha)


class SaturationJitterAug(Augmenter):
    _coef = np.array([0.299, 0.587, 0.114], np.float32)

    def __init__(self, saturation):
        self.saturation = saturation

    def __call__(self, src, rng):
        alpha = 1.0 + rng.uniform(-self.saturation, self.saturation)
        src = src.astype(np.float32)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std=None):
        self.mean = np.asarray(mean, np.float32) if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src, rng):
        src = src.astype(np.float32)
        if self.mean is not None:
            src = src - self.mean
        if self.std is not None:
            src = src / self.std
        return src


class CastAug(Augmenter):
    def __call__(self, src, rng):
        return src.astype(np.float32)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, inter_method=2):
    """Standard augmenter list (reference: image.py CreateAugmenter /
    src/io/image_aug_default.cc pipeline order: resize → crop → mirror →
    color jitter → normalize)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ------------------------------------------------------------------ iterators
class _HostStaging:
    """Where an iterator writes its batches. For the card: two sets of
    page-locked host buffers used in turn; ``buffers()`` waits for the event
    recorded after the last copy out of this turn's set, and ``ship()``
    copies the set to the card with ``non_blocking=True`` on the current
    stream and records that event. On the CPU each batch gets new tensors,
    which ``ship()`` returns as they are."""

    def __init__(self, ctx, shapes):
        self.ctx = ctx
        self._device = ctx.torch_device
        self._shapes = [tuple(s) for s in shapes]
        self._pinned = self._device.type == "cuda"
        if self._pinned:
            self._sets = [[torch.empty(s, dtype=torch.float32, pin_memory=True)
                           for s in self._shapes] for _ in range(2)]
            self._copied = [None, None]
        self._turn = 0

    def buffers(self):
        """This turn's host tensors, free to write."""
        if not self._pinned:
            self._current = [torch.empty(s, dtype=torch.float32) for s in self._shapes]
            return self._current
        event = self._copied[self._turn]
        if event is not None:
            event.synchronize()
        return self._sets[self._turn]

    def ship(self):
        """This turn's tensors on the iterator's device; the next turn
        starts."""
        if not self._pinned:
            return self._current
        out = [b.to(self._device, non_blocking=True) for b in self._sets[self._turn]]
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        self._copied[self._turn] = event
        self._turn ^= 1
        return out

    def batch(self, fill, pad, provide_data, provide_label):
        """A DataBatch of what ``fill(data, label)`` writes into this turn's
        buffers (as numpy arrays)."""
        bufs = self.buffers()
        fill(*(b.numpy() for b in bufs))
        data, label = self.ship()
        return _io.DataBatch(data=[_wrap(data, self.ctx)], label=[_wrap(label, self.ctx)],
                             pad=pad, provide_data=provide_data, provide_label=provide_label)


class _RecordSource:
    """Random-access record source over a .rec (+optional .idx) pack.

    Always offset-based (no .idx → one streaming scan collecting byte offsets,
    never payloads, so arbitrarily large packs stay out of RAM). ``get`` locks
    around the shared handle's seek+read so decode threads can fetch
    concurrently; the expensive decode/augment work stays outside the lock.
    """

    def __init__(self, path_imgrec, path_imgidx=None):
        import threading

        if path_imgidx is None and os.path.exists(
                os.path.splitext(path_imgrec)[0] + ".idx"):
            path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
        if path_imgidx:
            rec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._offsets = [rec.idx[k] for k in rec.keys]
            self._rec = rec
        else:
            rec = MXRecordIO(path_imgrec, "r")
            self._offsets = []
            while True:
                pos = rec.tell()
                if rec.read() is None:
                    break
                self._offsets.append(pos)
            self._rec = rec
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._offsets)

    def get(self, i):
        with self._lock:
            self._rec.handle.seek(self._offsets[i])
            return self._rec.read()


class ImageRecordIter(_io.DataIter):
    """Batches of decoded+augmented images from a RecordIO pack
    (reference: ImageRecordIter, src/io/iter_image_recordio_2.cc:559).

    Parameters follow the reference's ImageRecordParam/augmenter params:
    data_shape (C,H,W), shuffle, rand_crop, rand_mirror, mean_r/g/b,
    std_r/g/b, pad, num_parts/part_index (sharding), preprocess_threads,
    path_imgidx, label_width, round_batch. ``aug_list`` overrides the default
    augmenter pipeline.

    Execution: when the requested augment set is expressible natively
    (resize/crop/mirror/mean/std, RGB, single shard) the batches come from
    the C++ pipeline (src/image_native.cc — threaded libjpeg/libpng decode
    and augment off the GIL, the reference's iter_image_recordio_2.cc
    design); anything else — custom aug_list, pad, color jitter, num_parts
    sharding — runs the Python/PIL path. ``MXNET_NATIVE_IMAGE_PIPELINE=0``
    forces Python. Native batches preserve record order when unshuffled.
    ``shuffle=True`` + ``path_imgidx`` gives the Python path's full
    per-epoch permutation; shuffle WITHOUT an idx falls back to a 4096-
    record reservoir shuffle (logged) — pass the .idx for class-sorted recs.

    Batches land on the default context at construction (the card unless a
    ``with cpu():`` block says otherwise), through ``_HostStaging``.
    ``native`` says which path was chosen: a native pipeline that fails to
    open is dropped for the Python path, as in the JAX package, with a
    warning here.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0, pad=0, resize=0,
                 brightness=0, contrast=0, saturation=0, num_parts=1,
                 part_index=0, preprocess_threads=4, path_imgidx=None,
                 label_width=1, round_batch=True, seed=0, aug_list=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self.data_shape = tuple(data_shape)
        self._label_width = label_width
        self._round_batch = round_batch
        self.data_name, self.label_name = data_name, label_name
        label_shape = (batch_size,) if label_width == 1 else (batch_size, label_width)
        self.provide_data = [_io.DataDesc(data_name, (batch_size,) + self.data_shape)]
        self.provide_label = [_io.DataDesc(label_name, label_shape)]
        self._ctx = current_context()
        self._ctx.torch_device  # a card that is not there raises here, not at a batch

        self._native = None
        native_ok = (aug_list is None and pad == 0 and num_parts == 1
                     and not (brightness or contrast or saturation)
                     and data_shape[0] == 3
                     # classes that know how to consume the native batches:
                     # ImageDetIter rides them bbox-aware via the pipeline's
                     # per-sample augment records (unknown subclasses fall
                     # back to the Python path)
                     and type(self) in (ImageRecordIter, ImageDetIter))
        if native_ok:
            from . import image_native

            if image_native.available():
                idx = path_imgidx if (path_imgidx and
                                      os.path.isfile(path_imgidx)) else None
                if shuffle and idx is None:
                    import logging

                    logging.warning(
                        "ImageRecordIter(native): shuffling without a "
                        "path_imgidx uses a 4096-record reservoir, not a "
                        "full permutation — pass the .idx for class-sorted "
                        "record files")
                try:
                    self._native = image_native.NativeImagePipeline(
                        path_imgrec, batch_size, self.data_shape,
                        num_workers=max(1, preprocess_threads),
                        resize=resize, rand_crop=rand_crop,
                        rand_mirror=rand_mirror,
                        mean=(mean_r, mean_g, mean_b),
                        std=(std_r, std_g, std_b),
                        label_width=getattr(self, "_native_lw", label_width),
                        shuffle_buf=4096 if shuffle else 0, seed=seed,
                        idx_path=idx if shuffle else None)
                except Exception as e:  # noqa: BLE001  (the JAX package's selection)
                    import logging

                    logging.warning("ImageRecordIter: the native pipeline did not open "
                                    "(%s); taking the Python path", e)
                    self._native = None
        self._staging = None  # made at the first batch, once provide_label is final
        if self._native is not None:
            self._started = False  # pipeline already sits at epoch start
            return

        self._source = _RecordSource(path_imgrec, path_imgidx)
        n = len(self._source)
        self._indices = list(range(n))[part_index::num_parts]
        self._shuffle = shuffle
        self._rng = _random.Random(seed)
        self._pad = pad
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
        std = np.array([std_r, std_g, std_b], np.float32)
        self._aug = aug_list if aug_list is not None else CreateAugmenter(
            tuple(data_shape),
            resize=resize, rand_crop=rand_crop, rand_mirror=rand_mirror,
            mean=mean if mean.any() else None,
            std=std if (std != 1.0).any() else None,
            brightness=brightness, contrast=contrast, saturation=saturation)
        self._pool = (ThreadPoolExecutor(preprocess_threads)
                      if preprocess_threads > 1 else None)
        self._cursor = 0
        self.reset()

    @property
    def native(self):
        """True when the batches come from the native C++ pipeline."""
        return self._native is not None

    def _stage(self):
        if self._staging is None:
            self._staging = _HostStaging(self._ctx, [self.provide_data[0].shape,
                                                     self.provide_label[0].shape])
        return self._staging

    def reset(self):
        if self._native is not None:
            if self._started:
                self._native.reset()
                self._started = False
            return
        if self._shuffle:
            self._rng.shuffle(self._indices)
        self._cursor = 0

    def _load_one(self, i, seed):
        header, payload = unpack(self._source.get(i))
        img = imdecode(payload, to_rgb=True)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=2)
        if self._pad:
            img = np.pad(img, ((self._pad, self._pad), (self._pad, self._pad),
                               (0, 0)), mode="constant")
        rng = _random.Random(seed)
        for aug in self._aug:
            img = aug(img, rng)
        chw = np.transpose(img.astype(np.float32), (2, 0, 1))
        label = np.asarray(header.label, np.float32)
        return chw, label

    def next(self):
        if self._native is not None:
            return self._next_native()
        n_left = len(self._indices) - self._cursor
        if n_left <= 0 or (not self._round_batch and n_left < self.batch_size):
            raise StopIteration
        take = min(self.batch_size, n_left)
        idxs = [self._indices[self._cursor + j] for j in range(take)]
        # pad the final short batch by cycling its own real members
        # (round_batch semantics; safe for shards smaller than the batch)
        while len(idxs) < self.batch_size:
            idxs.append(idxs[(len(idxs) - take) % take])
        seeds = [self._rng.getrandbits(32) for _ in idxs]
        if self._pool is not None:
            results = list(self._pool.map(self._load_one, idxs, seeds))
        else:
            results = [self._load_one(i, s) for i, s in zip(idxs, seeds)]

        def fill(data, labels):
            for j, (chw, label) in enumerate(results):
                data[j] = chw
                labels[j] = self._scalar_label(label)

        self._cursor += take
        return self._stage().batch(fill, self.batch_size - take, self.provide_data,
                                   self.provide_label)

    def _next_native(self):
        self._started = True
        staging = self._stage()
        bufs = staging.buffers()
        data, labels = bufs[0].numpy(), bufs[1].numpy()
        n = self._native.next_batch_into(data, labels.reshape(self.batch_size, -1))
        if n == 0 or (not self._round_batch and n < self.batch_size):
            raise StopIteration
        # round_batch: pad the tail by cycling its own real members
        for j in range(n, self.batch_size):
            data[j] = data[j % n]
            labels[j] = labels[j % n]
        data, label = staging.ship()
        return _io.DataBatch(
            data=[_wrap(data, self._ctx)], label=[_wrap(label, self._ctx)],
            pad=self.batch_size - n,
            provide_data=self.provide_data, provide_label=self.provide_label)

    def _scalar_label(self, label):
        arr = np.atleast_1d(label)
        if self._label_width == 1:
            return np.float32(arr.flat[0])
        return arr[: self._label_width].astype(np.float32)


# reference alias: raw uint8 variant (same pipeline; cast happens in augs)
ImageRecordUInt8Iter = ImageRecordIter


class ImageDetIter(ImageRecordIter):
    """Detection variant (reference: ImageDetRecordIter,
    src/io/iter_image_det_recordio.cc:563): labels are variable-length
    ``[cls, xmin, ymin, xmax, ymax]`` rows (coords normalized to the
    original image), padded with -1 to ``(batch, max_objects, 5)``.

    Rides the native C++ decode/augment pipeline bbox-aware (reference:
    src/io/image_det_aug_default.cc did the box math in C++): pixels are
    cropped/mirrored natively and the boxes are transformed here from each
    sample's augment record {pre-crop W/H, crop origin, mirror} — an
    aspect-preserving resize leaves normalized coords unchanged, so crop
    geometry + mirror is the whole transform. Boxes are clipped to the crop
    and dropped when degenerate. The Python fallback path (custom aug_list,
    pad, jitter...) does NOT adjust boxes for crop/mirror — it warns when
    those augments are requested."""

    def __init__(self, *args, max_objects=8, **kwargs):
        self._max_objects = max_objects
        # native label copy: room for max_objects rows (extra rows are
        # truncated, matching _scalar_label)
        self._native_lw = max_objects * 5
        kwargs.setdefault("label_name", "label")
        super().__init__(*args, **kwargs)
        self.provide_label = [_io.DataDesc(
            self.label_name, (self.batch_size, max_objects, 5))]
        if self._native is None and (kwargs.get("rand_crop")
                                     or kwargs.get("rand_mirror")):
            import logging

            logging.warning(
                "ImageDetIter: Python fallback path does not adjust bboxes "
                "for rand_crop/rand_mirror — use the native pipeline "
                "(default augments, MXNET_NATIVE_IMAGE_PIPELINE=1) for "
                "geometry-consistent detection labels")

    def _scalar_label(self, label):
        rows = np.asarray(label, np.float32).reshape(-1, 5)
        out = -np.ones((self._max_objects, 5), np.float32)
        out[: min(len(rows), self._max_objects)] = rows[: self._max_objects]
        return out

    def _next_native(self):
        self._started = True
        data, labels, aug, n = self._native.next_batch(with_aug=True)
        if n == 0 or (not self._round_batch and n < self.batch_size):
            raise StopIteration
        data = data.copy()  # the pipeline reuses its staging buffers
        out_h, out_w = self.data_shape[1], self.data_shape[2]
        lab = -np.ones((self.batch_size, self._max_objects, 5), np.float32)
        for j in range(n):
            length = int(aug[j, 5])
            rows = labels[j, : length - (length % 5)].reshape(-1, 5).copy()
            W, H, x0, y0, mirror = aug[j, :5]
            identity = (x0 == 0 and y0 == 0 and mirror == 0
                        and W == out_w and H == out_h)
            if len(rows) and not identity:
                rows[:, 1] = (rows[:, 1] * W - x0) / out_w
                rows[:, 3] = (rows[:, 3] * W - x0) / out_w
                rows[:, 2] = (rows[:, 2] * H - y0) / out_h
                rows[:, 4] = (rows[:, 4] * H - y0) / out_h
                if mirror:
                    rows[:, 1], rows[:, 3] = 1.0 - rows[:, 3], 1.0 - rows[:, 1]
                # clip to the crop, drop boxes the crop removed — ONLY when
                # geometry changed (an un-augmented record's rows pass
                # through verbatim, matching the Python path exactly)
                np.clip(rows[:, 1:], 0.0, 1.0, out=rows[:, 1:])
                keep = ((rows[:, 3] - rows[:, 1] > 1e-4)
                        & (rows[:, 4] - rows[:, 2] > 1e-4))
                rows = rows[keep]
            rows = rows[: self._max_objects]
            lab[j, : len(rows)] = rows
        for j in range(n, self.batch_size):  # round_batch tail pad
            data[j] = data[j % n]
            lab[j] = lab[j % n]

        def fill(out_data, out_label):
            out_data[...] = data
            out_label[...] = lab

        return self._stage().batch(fill, self.batch_size - n, self.provide_data,
                                   self.provide_label)


class ImageIter(_io.DataIter):
    """Python-level image iterator over a .lst + image root (reference:
    python/mxnet/image.py ImageIter). For .rec input use ImageRecordIter."""

    def __init__(self, batch_size, data_shape, path_imglist=None,
                 path_root=".", shuffle=False, aug_list=None, seed=0,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if path_imglist is None:
            raise MXNetError("ImageIter needs path_imglist (or use ImageRecordIter)")
        self._items = []
        with open(path_imglist) as f:
            for line in f:
                parts = line.strip().split("\t")
                if len(parts) >= 3:
                    self._items.append((float(parts[1]),
                                        os.path.join(path_root, parts[-1])))
        self._shuffle = shuffle
        self._rng = _random.Random(seed)
        self.data_shape = tuple(data_shape)
        self._aug = aug_list if aug_list is not None else CreateAugmenter(data_shape)
        self._cursor = 0
        self.provide_data = [_io.DataDesc(data_name, (batch_size,) + self.data_shape)]
        self.provide_label = [_io.DataDesc(label_name, (batch_size,))]
        self._staging = _HostStaging(current_context(), [self.provide_data[0].shape,
                                                         self.provide_label[0].shape])
        self.reset()

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._items)
        self._cursor = 0

    def next(self):
        if self._cursor + self.batch_size > len(self._items):
            raise StopIteration
        data, labels = [], []
        for j in range(self.batch_size):
            label, path = self._items[self._cursor + j]
            with open(path, "rb") as f:
                img = imdecode(f.read())
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=2)
            for aug in self._aug:
                img = aug(img, self._rng)
            data.append(np.transpose(img.astype(np.float32), (2, 0, 1)))
            labels.append(label)
        self._cursor += self.batch_size

        def fill(out_data, out_label):
            out_data[...] = np.stack(data)
            out_label[...] = np.asarray(labels, np.float32)

        return self._staging.batch(fill, 0, self.provide_data, self.provide_label)
