# copied from mxnet_tpu/recordio.py (backend-free)
"""RecordIO: the reference's packed binary record format.

Counterpart of python/mxnet/recordio.py over dmlc-core's recordio framing:
each record is [magic u32][lrecord u32][payload][pad to 4B] with
magic 0xced7230a and lrecord = (cflag << 29) | length
(dmlc recordio convention the reference's MXRecordIO C API wraps).
``IRHeader``/``pack``/``unpack`` reproduce the image-record header layout
(flag u32, label f32, id u64, id2 u64) used by im2rec datasets.

A native C++ reader with threaded prefetch lives in src/ (io_native.py binds
it); this module is the portable pure-python implementation and the format
oracle for its tests.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_LREC_MASK = (1 << 29) - 1


class MXRecordIO:
    """Sequential record reader/writer (reference: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def write(self, buf):
        assert self.writable
        if isinstance(buf, str):
            buf = buf.encode("utf-8")
        n = len(buf)
        lrecord = n & _LREC_MASK  # cflag=0: complete record
        self.handle.write(struct.pack("<II", _MAGIC, lrecord))
        self.handle.write(buf)
        pad = (4 - n % 4) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, lrecord = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic 0x%x" % magic)
        n = lrecord & _LREC_MASK
        data = self.handle.read(n)
        pad = (4 - n % 4) % 4
        if pad:
            self.handle.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random-access records via a key→offset .idx file (reference:
    recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.isfile(idx_path):
            with open(idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write("%s\t%d\n" % (key, self.idx[key]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + payload into one record blob (reference: recordio.py
    pack). ``flag`` > 0 means the label is an array of ``flag`` floats."""
    header = IRHeader(*header)
    if isinstance(header.label, (np.ndarray, list, tuple)):
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0.0)
        payload = label.tobytes() + (s if isinstance(s, bytes) else s.encode())
    else:
        payload = s if isinstance(s, bytes) else s.encode()
    return struct.pack(_IR_FORMAT, int(header.flag), float(header.label),
                       int(header.id), int(header.id2)) + payload


def unpack(s):
    """(reference: recordio.py unpack)"""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(payload[: header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        payload = payload[header.flag * 4 :]
    return header, payload


def _encode_img(img, quality, img_fmt):
    """Encode an HWC uint8 array to jpeg/png bytes: cv2 when present, else
    PIL (this image ships PIL, not opencv)."""
    try:
        import cv2

        params = [cv2.IMWRITE_JPEG_QUALITY, quality] if img_fmt in (".jpg", ".jpeg") else None
        ret, buf = cv2.imencode(img_fmt, img, params)
        if not ret:
            raise MXNetError("failed to encode image")
        return buf.tobytes()
    except ImportError:
        import io as _io

        from PIL import Image

        arr = np.asarray(img, dtype=np.uint8)
        if arr.ndim == 3 and arr.shape[2] == 3:
            arr = arr[:, :, ::-1]  # keep the cv2 BGR disk convention
        pil = Image.fromarray(arr)
        fmt = "JPEG" if img_fmt in (".jpg", ".jpeg") else img_fmt.lstrip(".").upper()
        bio = _io.BytesIO()
        pil.save(bio, format=fmt, quality=quality)
        return bio.getvalue()


def _decode_img(payload, iscolor):
    try:
        import cv2

        return cv2.imdecode(np.frombuffer(payload, dtype=np.uint8), iscolor)
    except ImportError:
        import io as _io

        from PIL import Image

        pil = Image.open(_io.BytesIO(payload))
        if iscolor == 0:
            return np.asarray(pil.convert("L"))
        if iscolor < 0 and pil.mode == "L":
            # IMREAD_UNCHANGED semantics: grayscale stays (H, W)
            return np.asarray(pil)
        arr = np.asarray(pil.convert("RGB"))
        return arr[:, :, ::-1]  # BGR, matching the cv2 convention


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """JPEG/PNG-encode an image array (HWC, BGR like cv2) and pack it
    (reference: recordio.py pack_img)."""
    return pack(header, _encode_img(img, quality, img_fmt))


def unpack_img(s, iscolor=-1):
    """(reference: recordio.py unpack_img) — returns (header, HWC BGR array)."""
    header, payload = unpack(s)
    return header, _decode_img(payload, iscolor)
