"""Vision and detection ops.

Counterpart of ``mxnet_tpu/ops/vision.py``: ``ROIPooling``,
``BilinearSampler``, ``GridGenerator``, ``SpatialTransformer``, ``Crop``,
the SSD ops ``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget`` and
``_contrib_MultiBoxDetection``, the RPN's ``_contrib_Proposal``,
``_contrib_fft``/``_contrib_ifft``, ``_contrib_count_sketch`` and
``Correlation``, each with the JAX op's names, attributes and aliases.

Every op is a static-shaped composition of torch ops, batched over the
images where the JAX op maps one image at a time (``jax.vmap``), so that the
same numpy inputs give the same outputs on either package. Three places
need care to stay bitwise with the JAX ops:

- Sorts are stable (``torch.argsort(..., stable=True)``) over
  ``matrix.sort_key``, as ``jnp.argsort`` sorts: the
  hard-negative mining order and the NMS order sort over many ties (every
  ineligible anchor scores -inf, every invalid box -1).
- The force-match of ``MultiBoxTarget`` writes each ground-truth row's flag
  and index at its best anchor, ``.at[best_anchor].set(...)`` in JAX. Two
  rows may share a best anchor (a padded row's best anchor is 0); XLA's CPU
  scatter applies the updates in row order, so the last row wins. Here
  each anchor takes the highest row index that names it, which is that
  rule without a scatter of duplicates (``index_put_`` with duplicate
  indices is nondeterministic on CUDA).
- The greedy NMS loop runs ``min(nms_topk, N)`` trips over the
  score-sorted boxes, each a masked update of a (B, N) keep mask on the
  device with no host sync; the IoU rows it reads are computed a chunk of
  trips at a time.

The target-assignment ops (MultiBox*, Proposal) return constants with no
gradient, as the reference's backward-is-zero kernels do; the sampling and
pooling ops differentiate through torch.
"""
from __future__ import annotations

import numpy as np
import torch

from .matrix import sort_key
from .registry import AttrSpec, register

#: NMS trips whose IoU rows are computed at once: (B, chunk, N) floats
NMS_CHUNK = 64


# ------------------------------------------------------------------ helpers
def _corner_iou(a, b):
    """IoU between corner boxes a (..., P, 4) and b (..., Q, 4): (..., P, Q),
    the JAX ``_corner_iou`` (:30) element for element."""
    ax1, ay1, ax2, ay2 = (a[..., :, i:i + 1] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    ix = torch.maximum(zero, torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1))
    iy = torch.maximum(zero, torch.minimum(ay2, by2) - torch.maximum(ay1, by1))
    inter = ix * iy
    area_a = torch.maximum(zero, ax2 - ax1) * torch.maximum(zero, ay2 - ay1)
    area_b = torch.maximum(zero, bx2 - bx1) * torch.maximum(zero, by2 - by1)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, zero)


def _rows(x, idx):
    """x (B, N, k) gathered at idx (B, M) along N: (B, M, k)."""
    return x.gather(1, idx.unsqueeze(-1).expand(*idx.shape, x.shape[-1]))


# --------------------------------------------------------------- ROIPooling
@register("ROIPooling", attrs={"pooled_size": AttrSpec("shape", required=True),
                               "spatial_scale": AttrSpec("float", required=True)},
          input_names=("data", "rois"))
def _roi_pooling(attrs, data, rois):
    """Max-pool each ROI onto a fixed grid with bin masks over the feature
    map (JAX :44). rois (R, 5) = [batch_index, x1, y1, x2, y2] in image
    coordinates; an empty bin gives 0."""
    PH, PW = (int(s) for s in attrs["pooled_size"])
    scale = attrs["spatial_scale"]
    _, C, H, W = data.shape
    rois = rois.to(data.dtype)
    img = data[rois[:, 0].long()]  # (R, C, H, W)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale)[:, None] for i in range(1, 5))
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / PH
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / PW
    ph = torch.arange(PH, dtype=data.dtype, device=data.device)
    pw = torch.arange(PW, dtype=data.dtype, device=data.device)
    hstart = torch.clamp(torch.floor(ph * bin_h) + y1, 0, H)
    hend = torch.clamp(torch.ceil((ph + 1) * bin_h) + y1, 0, H)
    wstart = torch.clamp(torch.floor(pw * bin_w) + x1, 0, W)
    wend = torch.clamp(torch.ceil((pw + 1) * bin_w) + x1, 0, W)
    ys = torch.arange(H, dtype=data.dtype, device=data.device)
    xs = torch.arange(W, dtype=data.dtype, device=data.device)
    my = (ys >= hstart[:, :, None]) & (ys < hend[:, :, None])  # (R, PH, H)
    mx = (xs >= wstart[:, :, None]) & (xs < wend[:, :, None])  # (R, PW, W)
    mask = my[:, :, None, :, None] & mx[:, None, :, None, :]  # (R, PH, PW, H, W)
    neg = torch.full((), -float("inf"), dtype=data.dtype, device=data.device)
    big = torch.where(mask[:, :, :, None], img[:, None, None], neg)  # (R, PH, PW, C, H, W)
    out = big.amax(dim=(4, 5))
    empty = ~mask.any(dim=4).any(dim=3)
    out = torch.where(empty[..., None], torch.zeros((), dtype=data.dtype, device=data.device),
                      out)
    return out.permute(0, 3, 1, 2)


# --------------------------------------------------------- BilinearSampler
def _bilinear_sample(data, gx, gy):
    """data (N, C, H, W) sampled at normalised grid coordinates gx, gy in
    [-1, 1] (N, Ho, Wo), zero outside the map (JAX ``_bilinear_sample``)."""
    N, C, H, W = data.shape
    x = (gx + 1.0) * (W - 1) / 2.0
    y = (gy + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    flat = data.reshape(N, C, H * W)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)

    def gather(yy, xx):
        yi = torch.clamp(yy, 0, H - 1).long()
        xi = torch.clamp(xx, 0, W - 1).long()
        valid = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        idx = (yi * W + xi).reshape(N, 1, -1).expand(N, C, yi.shape[1] * yi.shape[2])
        vals = flat.gather(2, idx).reshape(N, C, *yi.shape[1:])
        return torch.where(valid[:, None], vals, zero)

    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    return (wa[:, None] * gather(y0, x0) + wb[:, None] * gather(y1, x0)
            + wc[:, None] * gather(y0, x1) + wd[:, None] * gather(y1, x1))


@register("BilinearSampler", attrs={}, input_names=("data", "grid"))
def _bilinear_sampler(attrs, data, grid):
    """data (N, C, H, W), grid (N, 2, Ho, Wo) of (x, y) in [-1, 1] (JAX :118)."""
    return _bilinear_sample(data, grid[:, 0], grid[:, 1])


# ------------------------------------------------------------ GridGenerator
def _affine_grid(theta, H, W):
    """The affine sampling grid (N, 2, H, W) of theta (N, 6) over an H x W
    target (JAX :138-143)."""
    dev = theta.device
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, H, device=dev),
                            torch.linspace(-1, 1, W, device=dev), indexing="ij")
    base = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(3, -1).to(theta.dtype)
    grid = torch.einsum("nij,jk->nik", theta.reshape(-1, 2, 3), base)
    return grid.reshape(-1, 2, H, W)


@register("GridGenerator", attrs={"transform_type": AttrSpec("str", required=True),
                                  "target_shape": AttrSpec("shape", default=(0, 0))})
def _grid_generator(attrs, data):
    """affine: data (N, 6) θ -> a sampling grid (N, 2, H, W); warp: data
    (N, 2, H, W), a flow -> the identity grid plus the normalised flow
    (JAX :132)."""
    tt = attrs["transform_type"]
    if tt == "affine":
        H, W = (int(s) for s in attrs["target_shape"])
        return _affine_grid(data, H, W)
    if tt == "warp":
        _, _, H, W = data.shape
        ys, xs = torch.meshgrid(torch.arange(H, dtype=data.dtype, device=data.device),
                                torch.arange(W, dtype=data.dtype, device=data.device),
                                indexing="ij")
        gx = (xs[None] + data[:, 0]) * 2.0 / max(W - 1, 1) - 1.0
        gy = (ys[None] + data[:, 1]) * 2.0 / max(H - 1, 1) - 1.0
        return torch.stack([gx, gy], dim=1)
    raise ValueError("GridGenerator: unknown transform_type %r" % tt)


# -------------------------------------------------------- SpatialTransformer
@register("SpatialTransformer", attrs={"target_shape": AttrSpec("shape", required=True),
                                       "transform_type": AttrSpec("str", default="affine"),
                                       "sampler_type": AttrSpec("str", default="bilinear")},
          input_names=("data", "loc"))
def _spatial_transformer(attrs, data, loc):
    """The affine grid of loc (N, 6), bilinearly sampled from data (JAX :155)."""
    H, W = (int(s) for s in attrs["target_shape"])
    grid = _affine_grid(loc, H, W)
    return _bilinear_sample(data, grid[:, 0], grid[:, 1])


# --------------------------------------------------------------------- Crop
def _crop_names(attrs):
    return ["data", "crop_like"] if int(attrs.get("num_args", 1)) > 1 else ["data"]


@register("Crop", attrs={"num_args": AttrSpec("int", default=1),
                         "offset": AttrSpec("shape", default=(0, 0)),
                         "h_w": AttrSpec("shape", default=(0, 0)),
                         "center_crop": AttrSpec("bool", default=False)},
          input_names=_crop_names)
def _crop(attrs, data, crop_like=None):
    """data's spatial axes cropped to h_w (or crop_like's), at offset or
    centred (JAX :181)."""
    if crop_like is not None:
        th, tw = crop_like.shape[2], crop_like.shape[3]
    else:
        th, tw = (int(s) for s in attrs["h_w"])
    H, W = data.shape[2], data.shape[3]
    if attrs["center_crop"]:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = (int(s) for s in attrs["offset"])
    return data[:, :, oy:oy + th, ox:ox + tw]


# ------------------------------------------------------------ MultiBoxPrior
@register("_contrib_MultiBoxPrior", attrs={"sizes": AttrSpec("ftuple", default=(1.0,)),
                                           "ratios": AttrSpec("ftuple", default=(1.0,)),
                                           "clip": AttrSpec("bool", default=False),
                                           "steps": AttrSpec("ftuple", default=(-1.0, -1.0)),
                                           "offsets": AttrSpec("ftuple", default=(0.5, 0.5))},
          aliases=("MultiBoxPrior",))
def _multibox_prior(attrs, data):
    """Anchor boxes at every feature-map pixel (JAX :218): (1, H*W*A, 4)
    corner boxes in [0, 1], A = len(sizes) + len(ratios) - 1, the sizes at
    the first ratio, then the other ratios at the first size."""
    H, W = data.shape[2], data.shape[3]
    sizes = [float(s) for s in attrs["sizes"]]
    ratios = [float(r) for r in attrs["ratios"]]
    step_y, step_x = (float(s) for s in attrs["steps"])
    off_y, off_x = (float(o) for o in attrs["offsets"])
    if step_y <= 0:
        step_y = 1.0 / H
    if step_x <= 0:
        step_x = 1.0 / W
    cy = (torch.arange(H, dtype=data.dtype, device=data.device) + off_y) * step_y
    cx = (torch.arange(W, dtype=data.dtype, device=data.device) + off_x) * step_x
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r)) for r in ratios[1:]]
    anchors = [torch.stack([cxg - w / 2, cyg - h / 2, cxg + w / 2, cyg + h / 2], dim=-1)
               for w, h in whs]
    out = torch.stack(anchors, dim=2).reshape(-1, 4)
    if attrs["clip"]:
        out = torch.clamp(out, 0.0, 1.0)
    return out[None]


# ----------------------------------------------------------- MultiBoxTarget
def _anchor_geometry(anchors):
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    return aw, ah, (anchors[:, 0] + anchors[:, 2]) / 2, (anchors[:, 1] + anchors[:, 3]) / 2


def force_match(best_anchor, valid, N):
    """Each valid ground-truth row claims its best anchor: (forced (B, N),
    forced_gt (B, N)). Where rows share an anchor the highest row index
    wins, as XLA's CPU scatter applies ``.at[best_anchor].set`` in row
    order (a padded row's flag is False, and it still wins its anchor)."""
    B, M = best_anchor.shape
    hit = best_anchor[:, :, None] == torch.arange(N, device=best_anchor.device)
    rows = torch.arange(M, device=best_anchor.device).reshape(1, M, 1)
    winner = torch.where(hit, rows, -1).amax(dim=1)  # (B, N)
    claimed = winner >= 0
    winner = winner.clamp(min=0)
    return claimed & valid.gather(1, winner), torch.where(claimed, winner, 0)


@register("_contrib_MultiBoxTarget",
          attrs={"overlap_threshold": AttrSpec("float", default=0.5),
                 "ignore_label": AttrSpec("float", default=-1.0),
                 "negative_mining_ratio": AttrSpec("float", default=-1.0),
                 "negative_mining_thresh": AttrSpec("float", default=0.5),
                 "minimum_negative_samples": AttrSpec("int", default=0),
                 "variances": AttrSpec("ftuple", default=(0.1, 0.1, 0.2, 0.2))},
          input_names=("anchor", "label", "cls_pred"), aliases=("MultiBoxTarget",),
          num_outputs=3, output_names=("loc_target", "loc_mask", "cls_target"))
def _multibox_target(attrs, anchor, label, cls_pred):
    """Assign ground truth to anchors (JAX :267). anchor (1, N, 4); label
    (B, M, 5) rows [cls, x1, y1, x2, y2], cls < 0 a padded row; cls_pred
    (B, classes + 1, N). Outputs loc_target (B, 4N), loc_mask (B, 4N) and
    cls_target (B, N): 0 background, k + 1 class k, and under hard negative
    mining ignore_label for the negatives not mined. The outputs are
    constants (detached), as the JAX op stops their gradient (:343)."""
    anchors = anchor[0].detach()
    label, cls_pred = label.detach(), cls_pred.detach()
    N, M = anchors.shape[0], label.shape[1]
    v = attrs["variances"]
    mine_ratio = attrs["negative_mining_ratio"]
    dt, dev = anchors.dtype, anchors.device
    zero = torch.zeros((), dtype=dt, device=dev)
    aw, ah, acx, acy = _anchor_geometry(anchors)

    valid = label[:, :, 0] >= 0  # (B, M)
    gt = label[:, :, 1:5]
    iou = torch.where(valid[:, None, :], _corner_iou(anchors, gt),
                      torch.full((), -1.0, dtype=dt, device=dev))  # (B, N, M)
    best_iou, best_gt = iou.max(dim=2)  # the first maximum, as jnp.argmax
    forced, forced_gt = force_match(iou.argmax(dim=1), valid, N)
    gt_idx = torch.where(forced, forced_gt, best_gt)
    matched = (best_iou >= attrs["overlap_threshold"]) | forced

    g = _rows(gt, gt_idx)  # (B, N, 4)
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    tx = (gcx - acx) / torch.clamp(aw, min=1e-8) / v[0]
    ty = (gcy - acy) / torch.clamp(ah, min=1e-8) / v[1]
    tw = torch.log(gw / torch.clamp(aw, min=1e-8)) / v[2]
    th = torch.log(gh / torch.clamp(ah, min=1e-8)) / v[3]
    loc_t = torch.where(matched[..., None], torch.stack([tx, ty, tw, th], dim=2), zero)
    loc_m = matched[..., None].to(dt).expand(-1, -1, 4)
    cls_of = label[:, :, 0].gather(1, gt_idx) + 1.0

    if mine_ratio > 0:
        # hard negative mining: the (ratio x positives) eligible anchors whose
        # background probability is lowest, ties in anchor order
        num_pos = matched.sum(dim=1)
        num_neg = torch.minimum((mine_ratio * num_pos).long(), N - num_pos)
        num_neg = torch.clamp(num_neg, min=attrs["minimum_negative_samples"])
        prob_bg = torch.softmax(cls_pred, dim=1)[:, 0]
        eligible = ~matched & (best_iou < attrs["negative_mining_thresh"])
        score = torch.where(eligible, -prob_bg, torch.full((), -float("inf"), dtype=dt,
                                                           device=dev))
        order = torch.argsort(sort_key(-score), dim=1, stable=True)
        ranks = torch.arange(N, device=dev).expand(order.shape[0], N)
        rank = torch.empty_like(order).scatter_(1, order, ranks)
        neg = eligible & (rank < num_neg[:, None])
        cls_t = torch.where(matched, cls_of, torch.where(
            neg, zero, torch.full((), attrs["ignore_label"], dtype=dt, device=dev)))
    else:
        cls_t = torch.where(matched, cls_of, zero)
    B = label.shape[0]
    return loc_t.reshape(B, -1), loc_m.reshape(B, -1), cls_t


# -------------------------------------------------------- MultiBoxDetection
def nms_mask(boxes, scores, keep_init, nms_threshold, topk):
    """Greedy NMS over each image's score-sorted boxes (JAX ``_nms_mask``,
    :348): boxes (B, N, 4), scores and keep_init (B, N); returns the keep
    mask (B, N) in the boxes' order. The stable sort keeps tied scores in
    box order; ``min(topk, N)`` trips, each on the device."""
    B, N = scores.shape
    order = torch.argsort(sort_key(-scores), dim=1, stable=True)
    boxes_s = _rows(boxes, order)
    keep = keep_init.gather(1, order)
    pos = torch.arange(N, device=boxes.device)
    trips = min(topk, N)
    for c0 in range(0, trips, NMS_CHUNK):
        c1 = min(c0 + NMS_CHUNK, trips)
        # box i suppresses a later box j of IoU above the threshold
        sup = (_corner_iou(boxes_s[:, c0:c1], boxes_s) > nms_threshold) \
            & (pos > pos[c0:c1, None])
        for i in range(c0, c1):
            keep.masked_fill_(sup[:, i - c0] & keep[:, i:i + 1], False)
    return torch.empty_like(keep).scatter_(1, order, keep)


@register("_contrib_MultiBoxDetection",
          attrs={"clip": AttrSpec("bool", default=True),
                 "threshold": AttrSpec("float", default=0.01),
                 "background_id": AttrSpec("int", default=0),
                 "nms_threshold": AttrSpec("float", default=0.5),
                 "force_suppress": AttrSpec("bool", default=False),
                 "variances": AttrSpec("ftuple", default=(0.1, 0.1, 0.2, 0.2)),
                 "nms_topk": AttrSpec("int", default=-1)},
          input_names=("cls_prob", "loc_pred", "anchor"), aliases=("MultiBoxDetection",))
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode and NMS (JAX :381): cls_prob (B, classes + 1, N), loc_pred
    (B, 4N), anchor (1, N, 4) -> (B, N, 6) rows [class id, score, x1, y1,
    x2, y2], class id -1 where suppressed or below ``threshold``."""
    anchors = anchor[0]
    B, N = cls_prob.shape[0], anchors.shape[0]
    v = attrs["variances"]
    bg = int(attrs["background_id"])
    topk = attrs["nms_topk"] if attrs["nms_topk"] > 0 else N
    aw, ah, acx, acy = _anchor_geometry(anchors)
    loc = loc_pred.reshape(B, N, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw
    h = torch.exp(loc[..., 3] * v[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=2)
    if attrs["clip"]:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    masked = cls_prob.index_fill(1, torch.tensor([bg], device=cls_prob.device), -1.0)
    score, cls_id = masked.max(dim=1)  # the first maximum, as jnp.argmax
    valid = score > attrs["threshold"]
    minus1 = torch.full((), -1.0, dtype=boxes.dtype, device=boxes.device)
    keep = nms_mask(boxes, torch.where(valid, score, minus1), valid, attrs["nms_threshold"], topk)
    out_id = torch.where(keep, cls_id.to(boxes.dtype) - (1.0 if bg == 0 else 0.0), minus1)
    return torch.cat([out_id[..., None], score[..., None], boxes], dim=2)


# ------------------------------------------------------------------ Proposal
@register("_contrib_Proposal",
          attrs={"rpn_pre_nms_top_n": AttrSpec("int", default=6000),
                 "rpn_post_nms_top_n": AttrSpec("int", default=300),
                 "threshold": AttrSpec("float", default=0.7),
                 "rpn_min_size": AttrSpec("int", default=16),
                 "scales": AttrSpec("ftuple", default=(4.0, 8.0, 16.0, 32.0)),
                 "ratios": AttrSpec("ftuple", default=(0.5, 1.0, 2.0)),
                 "feature_stride": AttrSpec("int", default=16),
                 "output_score": AttrSpec("bool", default=False),
                 "iou_loss": AttrSpec("bool", default=False)},
          input_names=("cls_prob", "bbox_pred", "im_info"), aliases=("Proposal",))
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """RPN proposals (JAX :435): cls_prob (B, 2A, H, W), bbox_pred (B, 4A,
    H, W), im_info (B, 3) -> rois (B * post_nms, 5) [batch index, x1, y1,
    x2, y2] (and their scores with ``output_score``)."""
    B, _, H, W = cls_prob.shape
    scales = [float(s) for s in attrs["scales"]]
    ratios = [float(r) for r in attrs["ratios"]]
    stride = attrs["feature_stride"]
    A = len(scales) * len(ratios)
    post_n = int(attrs["rpn_post_nms_top_n"])
    dev = cls_prob.device
    # base anchors centred on stride/2 (the generate_anchors convention)
    base = []
    cx = cy = (stride - 1) / 2.0
    for r in ratios:
        ws = np.round(np.sqrt(stride * stride / r))
        hs = np.round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            base.append([cx - (w - 1) / 2, cy - (h - 1) / 2, cx + (w - 1) / 2, cy + (h - 1) / 2])
    base = torch.as_tensor(np.array(base, dtype="float32"), device=dev)
    sy = torch.arange(H, dtype=torch.float32, device=dev) * stride
    sx = torch.arange(W, dtype=torch.float32, device=dev) * stride
    syg, sxg = torch.meshgrid(sy, sx, indexing="ij")
    shift = torch.stack([sxg, syg, sxg, syg], dim=-1).reshape(-1, 1, 4)
    anchors = (shift + base[None]).reshape(-1, 4)
    N = anchors.shape[0]

    scores = cls_prob[:, A:].reshape(B, A, H, W).permute(0, 2, 3, 1).reshape(B, -1)
    d = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(B, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    w = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    zero = torch.zeros((), dtype=cls_prob.dtype, device=dev)
    xmax, ymax = im_info[:, 1:2] - 1, im_info[:, 0:1] - 1
    boxes = torch.stack([torch.minimum(torch.maximum(cx - w / 2, zero), xmax),
                         torch.minimum(torch.maximum(cy - h / 2, zero), ymax),
                         torch.minimum(torch.maximum(cx + w / 2, zero), xmax),
                         torch.minimum(torch.maximum(cy + h / 2, zero), ymax)], dim=2)
    min_size = attrs["rpn_min_size"] * im_info[:, 2:3]
    valid = ((boxes[..., 2] - boxes[..., 0] + 1 >= min_size)
             & (boxes[..., 3] - boxes[..., 1] + 1 >= min_size))
    minus1 = torch.full((), -1.0, dtype=cls_prob.dtype, device=dev)
    scores = torch.where(valid, scores, minus1)
    keep = nms_mask(boxes, scores, valid, attrs["threshold"],
                    min(int(attrs["rpn_pre_nms_top_n"]), N))
    scores = torch.where(keep, scores, minus1)
    top = torch.argsort(sort_key(-scores), dim=1, stable=True)[:, :post_n]
    boxes, scores = _rows(boxes, top), scores.gather(1, top)
    bidx = torch.arange(B, dtype=boxes.dtype, device=dev).repeat_interleave(post_n)
    rois = torch.cat([bidx.reshape(B, post_n, 1), boxes], dim=2).reshape(B * post_n, 5)
    if attrs["output_score"]:
        return rois, scores.reshape(B * post_n, 1)
    return rois


# ------------------------------------------------------------------ fft/ifft
@register("_contrib_fft", attrs={"compute_size": AttrSpec("int", default=128)},
          aliases=("fft",))
def _fft(attrs, data):
    """FFT along the last axis, real and imaginary parts interleaved
    (..., 2K) (JAX :503)."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    stacked = torch.stack([out.real, out.imag], dim=-1)
    return stacked.reshape(*data.shape[:-1], 2 * data.shape[-1]).to(data.dtype)


@register("_contrib_ifft", attrs={"compute_size": AttrSpec("int", default=128)},
          aliases=("ifft",))
def _ifft(attrs, data):
    """The inverse of ``_contrib_fft``, unnormalised (times K), real part
    (JAX :513)."""
    K = data.shape[-1] // 2
    pairs = data.reshape(*data.shape[:-1], K, 2)
    z = torch.complex(pairs[..., 0].float(), pairs[..., 1].float())
    return (torch.fft.ifft(z, dim=-1).real * K).to(data.dtype)


# -------------------------------------------------------------- count_sketch
@register("_contrib_count_sketch", attrs={"out_dim": AttrSpec("int", required=True),
                                          "processing_batch_size": AttrSpec("int", default=32)},
          input_names=("data", "h", "s"), aliases=("count_sketch",))
def _count_sketch(attrs, data, h, s):
    """out[n, h[j]] += s[j]·data[n, j] (JAX :531)."""
    vals = data * s.reshape(-1).to(data.dtype)[None, :]
    out = torch.zeros((data.shape[0], int(attrs["out_dim"])), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, h.reshape(-1).long(), vals)


# --------------------------------------------------------------- Correlation
@register("Correlation", attrs={"kernel_size": AttrSpec("int", default=1),
                                "max_displacement": AttrSpec("int", default=1),
                                "stride1": AttrSpec("int", default=1),
                                "stride2": AttrSpec("int", default=1),
                                "pad_size": AttrSpec("int", default=0),
                                "is_multiply": AttrSpec("bool", default=True)},
          input_names=("data1", "data2"))
def _correlation(attrs, data1, data2):
    """FlowNet correlation (JAX :555): for each displacement (dy, dx) the
    channel mean of data1·shift(data2) (|data1 − shift(data2)| without
    ``is_multiply``), shifted by a roll of the padded maps."""
    md, s2, pad = (int(attrs[k]) for k in ("max_displacement", "stride2", "pad_size"))
    _, _, H, W = data1.shape
    p = (pad, pad, pad, pad)
    p1 = torch.nn.functional.pad(data1, p)
    p2 = torch.nn.functional.pad(data2, p)
    disp = range(-md, md + 1, s2)
    outs = []
    for dy in disp:
        for dx in disp:
            shifted = torch.roll(p2, shifts=(-dy, -dx), dims=(2, 3))
            if attrs["is_multiply"]:
                outs.append((p1 * shifted).mean(dim=1))
            else:
                outs.append((p1 - shifted).abs().mean(dim=1))
    out = torch.stack(outs, dim=1)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    return out[:, :, pad:Hp - pad, pad:Wp - pad] if pad else out
