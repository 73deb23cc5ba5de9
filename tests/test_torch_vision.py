"""The port's vision and detection ops (``ops/vision.py``) against the JAX
package.

Every case of the reference's own ``tests/test_vision.py`` runs here on BOTH
packages (fixture ``mx``: the JAX package, or the port inside ``with
cpu():``). Then the MultiBox edge cases, the same numpy inputs through the
JAX op and the port's: every decision equal (the class targets, the
location masks, the kept boxes' ids and scores) and the location targets
and boxes within rtol 1e-6, atol 1e-7 (XLA's and torch's log, exp and
division may round a float32 apart by an ulp):

- two ground-truth boxes sharing their best anchor (XLA's CPU scatter lets
  the later row win; so does the port's ``force_match``), and a padded row
  whose best anchor (0) is a valid box's;
- hard-negative mining over tied background probabilities (a stable sort:
  the lower anchor first);
- NMS over equal scores (the lower box first) and ``nms_topk`` below N;
- padded label rows only (no positive: no negative is mined).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu
import mxnet_tpu_torch as pt
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg

torch.set_num_threads(1)


@pytest.fixture(params=["jax", "torch"])
def mx(request):
    """The package under test: the JAX one, or the port on the CPU."""
    if request.param == "jax":
        yield mxnet_tpu
    else:
        with pt.cpu():
            yield pt


# ------------------------------------------ tests/test_vision.py, both packages
def _run(mx, out_sym, args, aux=None):
    exe = mx.executor.bind(out_sym, mx.cpu(),
                           {k: mx.nd.array(v) for k, v in args.items()},
                           args_grad=None, grad_req="null", aux_states=aux or {})
    return [o.asnumpy() for o in exe.forward(is_train=False)]


def test_roi_pooling_identity_roi(mx):
    # ROI covering the whole 4x4 image, pooled to 2x2 → max of each quadrant
    data = np.arange(16, dtype="float32").reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3]], dtype="float32")
    out = mx.nd.ROIPooling(mx.nd.array(data), mx.nd.array(rois),
                           pooled_size=(2, 2), spatial_scale=1.0).asnumpy()
    expected = np.array([[[[5, 7], [13, 15]]]], dtype="float32")
    np.testing.assert_array_equal(out, expected)


def test_roi_pooling_spatial_scale(mx):
    data = np.random.rand(1, 2, 8, 8).astype("float32")
    rois = np.array([[0, 0, 0, 15, 15]], dtype="float32")  # scale .5 → full map
    out = mx.nd.ROIPooling(mx.nd.array(data), mx.nd.array(rois),
                           pooled_size=(1, 1), spatial_scale=0.5).asnumpy()
    np.testing.assert_allclose(out[0, :, 0, 0], data[0].max(axis=(1, 2)), rtol=1e-6)


def test_bilinear_sampler_identity_grid(mx):
    data = np.random.rand(2, 3, 5, 6).astype("float32")
    H, W = 5, 6
    ys, xs = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij")
    grid = np.stack([xs, ys], 0)[None].repeat(2, axis=0).astype("float32")
    out = mx.nd.BilinearSampler(mx.nd.array(data), mx.nd.array(grid)).asnumpy()
    np.testing.assert_allclose(out, data, rtol=1e-5, atol=1e-6)


def test_spatial_transformer_identity_theta(mx):
    data = np.random.rand(1, 2, 4, 4).astype("float32")
    theta = np.array([[1, 0, 0, 0, 1, 0]], dtype="float32")
    out = mx.nd.SpatialTransformer(mx.nd.array(data), mx.nd.array(theta),
                                   target_shape=(4, 4)).asnumpy()
    np.testing.assert_allclose(out, data, rtol=1e-5, atol=1e-6)


def test_grid_generator_affine_identity(mx):
    theta = np.array([[1, 0, 0, 0, 1, 0]], dtype="float32")
    grid = mx.nd.GridGenerator(mx.nd.array(theta), transform_type="affine",
                               target_shape=(3, 3)).asnumpy()
    assert grid.shape == (1, 2, 3, 3)
    np.testing.assert_allclose(grid[0, 0, 0], [-1, 0, 1], atol=1e-6)  # x row
    np.testing.assert_allclose(grid[0, 1, :, 0], [-1, 0, 1], atol=1e-6)  # y col


def test_crop(mx):
    data = np.arange(36, dtype="float32").reshape(1, 1, 6, 6)
    out = mx.nd.Crop(mx.nd.array(data), offset=(1, 2), h_w=(3, 3)).asnumpy()
    np.testing.assert_array_equal(out[0, 0], data[0, 0, 1:4, 2:5])
    out_c = mx.nd.Crop(mx.nd.array(data), h_w=(2, 2), center_crop=True).asnumpy()
    np.testing.assert_array_equal(out_c[0, 0], data[0, 0, 2:4, 2:4])


def test_multibox_prior(mx):
    data = np.zeros((1, 3, 2, 2), dtype="float32")
    anchors = mx.nd.MultiBoxPrior(mx.nd.array(data), sizes=(0.5,),
                                  ratios=(1.0, 2.0)).asnumpy()
    assert anchors.shape == (1, 2 * 2 * 2, 4)
    # first anchor: center (0.25, 0.25), size 0.5 ratio 1 → square
    np.testing.assert_allclose(anchors[0, 0], [0.0, 0.0, 0.5, 0.5], atol=1e-6)
    # ratio-2 anchor is wider than tall
    a1 = anchors[0, 1]
    assert (a1[2] - a1[0]) > (a1[3] - a1[1])


def test_multibox_target_matches_gt(mx):
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0]]], dtype="float32")
    # gt overlapping the first anchor exactly, class 0
    label = np.array([[[0, 0.0, 0.0, 0.5, 0.5]]], dtype="float32")
    cls_pred = np.zeros((1, 2, 2), dtype="float32")
    loc_t, loc_m, cls_t = mx.nd.MultiBoxTarget(
        mx.nd.array(anchors), mx.nd.array(label), mx.nd.array(cls_pred))
    cls_t = cls_t.asnumpy()
    loc_m = loc_m.asnumpy()
    assert cls_t[0, 0] == 1.0 and cls_t[0, 1] == 0.0  # class0 → target 1, bg 0
    assert loc_m[0, :4].sum() == 4 and loc_m[0, 4:].sum() == 0
    # exact match → zero offsets
    np.testing.assert_allclose(loc_t.asnumpy()[0, :4], 0.0, atol=1e-5)


def test_multibox_detection_decodes_and_nms(mx):
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4],
                         [0.12, 0.1, 0.42, 0.4],
                         [0.6, 0.6, 0.9, 0.9]]], dtype="float32")
    # class probs: [background; class0] — anchors 0,1 confident class0
    cls_prob = np.array([[[0.1, 0.2, 0.9], [0.9, 0.8, 0.1]]], dtype="float32")
    loc_pred = np.zeros((1, 12), dtype="float32")
    out = mx.nd.MultiBoxDetection(mx.nd.array(cls_prob), mx.nd.array(loc_pred),
                                  mx.nd.array(anchors), nms_threshold=0.5,
                                  threshold=0.5).asnumpy()
    assert out.shape == (1, 3, 6)
    ids = out[0, :, 0]
    # one of the two overlapping anchors suppressed; far anchor under threshold
    assert (ids >= 0).sum() == 1
    assert ids[0] == 0.0 and out[0, 0, 1] == pytest.approx(0.9)


def test_proposal_shapes(mx):
    B, A, H, W = 1, 12, 4, 4  # 4 scales x 3 ratios
    cls_prob = np.random.rand(B, 2 * A, H, W).astype("float32")
    bbox_pred = (np.random.rand(B, 4 * A, H, W).astype("float32") - 0.5) * 0.1
    im_info = np.array([[64, 64, 1.0]], dtype="float32")
    rois = mx.nd.Proposal(mx.nd.array(cls_prob), mx.nd.array(bbox_pred),
                          mx.nd.array(im_info), feature_stride=16,
                          rpn_post_nms_top_n=8).asnumpy()
    assert rois.shape == (8, 5)
    assert (rois[:, 0] == 0).all()
    assert (rois[:, 1:] >= 0).all() and (rois[:, 1:] <= 64).all()


def test_fft_ifft_roundtrip(mx):
    x = np.random.rand(2, 8).astype("float32")
    f = mx.nd.fft(mx.nd.array(x))
    assert f.shape == (2, 16)
    # oracle: numpy fft interleaved
    ref = np.fft.fft(x, axis=-1)
    inter = np.stack([ref.real, ref.imag], -1).reshape(2, 16).astype("float32")
    np.testing.assert_allclose(f.asnumpy(), inter, rtol=1e-4, atol=1e-4)
    back = mx.nd.ifft(f).asnumpy() / 8  # reference ifft is unnormalized (×K)
    np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)


def test_count_sketch(mx):
    data = np.array([[1.0, 2.0, 3.0]], dtype="float32")
    h = np.array([0, 1, 0], dtype="float32")
    s = np.array([1, -1, 1], dtype="float32")
    out = mx.nd.count_sketch(mx.nd.array(data), mx.nd.array(h), mx.nd.array(s),
                             out_dim=2).asnumpy()
    np.testing.assert_allclose(out, [[4.0, -2.0]], atol=1e-6)


def test_correlation_self_is_mean_square(mx):
    x = np.random.rand(1, 4, 5, 5).astype("float32")
    out = mx.nd.Correlation(mx.nd.array(x), mx.nd.array(x),
                            max_displacement=1).asnumpy()
    assert out.shape == (1, 9, 5, 5)
    center = out[0, 4]  # zero displacement channel
    np.testing.assert_allclose(center, (x[0] ** 2).mean(axis=0), rtol=1e-5)


def test_roi_pooling_gradient_flows(mx):
    tu, sym = mx.test_utils, mx.symbol

    rs = np.random.RandomState(3)
    data = rs.rand(1, 2, 6, 6).astype("float32")
    rois = np.array([[0, 0, 0, 5, 5]], dtype="float32")
    out = sym.ROIPooling(data=sym.Variable("data"), rois=sym.Variable("rois"),
                         pooled_size=(2, 2), spatial_scale=1.0)
    g = tu.check_symbolic_backward(out, {"data": data, "rois": rois},
                                   [np.ones((1, 2, 2, 2), "float32")], {})
    # max pooling routes each bin's gradient to exactly one input element
    assert g["data"].sum() == pytest.approx(8.0)


def test_bilinear_sampler_gradient(mx):
    tu, sym = mx.test_utils, mx.symbol

    rs = np.random.RandomState(4)
    data = rs.rand(1, 1, 4, 4).astype("float32")
    ys, xs = np.meshgrid(np.linspace(-0.9, 0.9, 4), np.linspace(-0.9, 0.9, 4),
                         indexing="ij")
    grid = np.stack([xs, ys], 0)[None].astype("float32")
    out = sym.BilinearSampler(data=sym.Variable("data"), grid=sym.Variable("grid"))
    tu.check_numeric_gradient(out, {"data": data, "grid": grid},
                              numeric_eps=1e-3, check_eps=3e-2)


def test_multibox_target_hard_negative_mining(mx):
    """With mining (ratio 3): unmined negatives carry ignore_label, mined
    negatives are the lowest-background-probability anchors, positives keep
    their class (reference: multibox_target.cc:162-229)."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5],
                         [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0],
                         [0.45, 0.0, 0.95, 0.5],
                         [0.1, 0.1, 0.2, 0.2],
                         [0.8, 0.8, 0.9, 0.9]]], "float32")
    label = -np.ones((1, 2, 5), "float32")
    label[0, 0] = [2, 0.0, 0.0, 0.5, 0.5]  # matches anchor 0 exactly
    N = anchors.shape[1]
    # background logits: anchor 4 is the most confident background, anchor 5
    # the least (hardest negative)
    cls_pred = np.zeros((1, 3, N), "float32")
    cls_pred[0, 0] = [0.0, -1.0, 0.0, 1.0, 5.0, -5.0]

    a = mx.nd.array(anchors); l = mx.nd.array(label); p = mx.nd.array(cls_pred)
    _, loc_mask, cls_t = mx.nd.MultiBoxTarget(
        a, l, p, overlap_threshold=0.5, ignore_label=-1,
        negative_mining_ratio=2, negative_mining_thresh=0.5)
    ct = cls_t.asnumpy()[0]
    assert ct[0] == 3.0  # class 2 → target 3 (0 is background)
    # 1 positive × ratio 2 = 2 mined negatives; hardest = lowest bg prob
    assert (ct == 0).sum() == 2
    assert ct[5] == 0 and ct[1] == 0  # lowest background logits
    assert ct[4] == -1 and ct[3] == -1  # confident backgrounds ignored, not mined

    # without mining every unmatched anchor is background
    _, _, cls_all = mx.nd.MultiBoxTarget(a, l, p, overlap_threshold=0.5)
    assert (cls_all.asnumpy()[0] == 0).sum() == N - 1


# ------------------------------------------------ MultiBox edge cases, parity
def _both(op, attrs, inputs):
    """The JAX op's and the port's outputs on the same numpy inputs."""
    jop, pop = jreg.get_op(op), preg.get_op(op)
    jout, _ = jop.apply(jreg.parse_attrs(jop, attrs), [jnp.asarray(x) for x in inputs])
    pout, _ = pop.apply(preg.parse_attrs(pop, attrs), [torch.from_numpy(x) for x in inputs])
    return [np.asarray(j) for j in jout], [p.numpy() for p in pout]


def _assert_same(jout, pout):
    """Decisions equal, values within rounding: MultiBoxTarget's (loc_target,
    loc_mask, cls_target) and MultiBoxDetection's rows [id, score, box]."""
    assert len(jout) == len(pout)
    for j, p in zip(jout, pout):
        assert j.shape == p.shape and j.dtype == p.dtype
    if len(jout) == 3:  # targets: the masks and classes exactly
        np.testing.assert_allclose(pout[0], jout[0], **VALUES)
        np.testing.assert_array_equal(pout[1], jout[1])
        np.testing.assert_array_equal(pout[2], jout[2])
    else:  # detections: the ids and scores exactly
        np.testing.assert_array_equal(pout[0][..., :2], jout[0][..., :2])
        np.testing.assert_allclose(pout[0][..., 2:], jout[0][..., 2:], **VALUES)


GRID = np.array([[[x, y, x + 0.25, y + 0.25] for y in (0.0, 0.25, 0.5, 0.75)
                  for x in (0.0, 0.25, 0.5, 0.75)]], np.float32)  # (1, 16, 4)
# the location targets and boxes: XLA's and torch's log, exp and division
# may round a float32 apart by an ulp
VALUES = dict(rtol=1e-6, atol=1e-7)
MINING = {"negative_mining_ratio": "3", "negative_mining_thresh": "0.5", "ignore_label": "-1"}


def test_target_rows_sharing_a_best_anchor_take_the_later_row():
    label = -np.ones((2, 4, 5), np.float32)
    # image 0: two boxes whose best anchor is anchor 5, the later one class 4
    label[0, 0] = [1, 0.26, 0.26, 0.49, 0.49]
    label[0, 1] = [4, 0.27, 0.25, 0.50, 0.48]
    # image 1: one box on anchor 0; its padded rows' best anchor is 0 too
    label[1, 0] = [2, 0.0, 0.0, 0.2, 0.24]
    cls_pred = np.random.RandomState(1).randn(2, 6, 16).astype(np.float32)
    for attrs in ({"overlap_threshold": "0.95"}, dict(MINING, overlap_threshold="0.95")):
        jout, pout = _both("MultiBoxTarget", attrs, [GRID, label, cls_pred])
        _assert_same(jout, pout)
    cls_t = pout[2]
    assert cls_t[0, 5] == 5.0  # the later row (class 4) won anchor 5
    # the padded rows of image 1 came after its box and win anchor 0 with a
    # false flag: anchor 0 is matched only if its IoU passes the threshold
    assert cls_t[1, 0] in (0.0, -1.0)
    jout, pout = _both("MultiBoxTarget", {"overlap_threshold": "0.5"}, [GRID, label, cls_pred])
    _assert_same(jout, pout)
    assert pout[2][1, 0] == 3.0


def test_target_mining_ties_take_the_lower_anchor():
    label = -np.ones((1, 2, 5), np.float32)
    label[0, 0] = [0, 0.0, 0.0, 0.25, 0.25]  # anchor 0 exactly: one positive
    cls_pred = np.zeros((1, 3, 16), np.float32)  # every background probability tied
    jout, pout = _both("MultiBoxTarget", MINING, [GRID, label, cls_pred])
    _assert_same(jout, pout)
    neg = np.flatnonzero(pout[2][0] == 0)
    np.testing.assert_array_equal(neg, [1, 2, 3])  # 3 negatives, the lowest eligible


def test_target_padded_rows_only_mine_nothing():
    label = -np.ones((2, 3, 5), np.float32)
    cls_pred = np.random.RandomState(2).randn(2, 4, 16).astype(np.float32)
    for attrs in ({}, MINING, dict(MINING, minimum_negative_samples="2")):
        jout, pout = _both("MultiBoxTarget", attrs, [GRID, label, cls_pred])
        _assert_same(jout, pout)
        assert pout[1].sum() == 0  # no box, no location target
    assert (pout[2] == 0).sum() == 4  # but the minimum of 2 negatives an image


def test_detection_nms_over_equal_scores_and_topk_below_n():
    rs = np.random.RandomState(5)
    N = 16
    anchors = np.repeat(GRID, 1, axis=0)
    # four groups of four nearly coincident boxes; equal scores in each group
    loc = np.zeros((2, N, 4), np.float32)
    loc[:, :, :2] = rs.uniform(-0.05, 0.05, (2, N, 2))
    probs = np.zeros((2, 3, N), np.float32)
    probs[:, 1] = np.repeat([0.6, 0.6, 0.7, 0.7], 4)[None]
    probs[:, 2] = np.repeat([0.3, 0.2, 0.1, 0.3], 4)[None]
    probs[:, 0] = 1.0 - probs[:, 1] - probs[:, 2]
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5]] * N], np.float32)  # all overlapping
    for attrs in ({"nms_threshold": "0.5"}, {"nms_threshold": "0.5", "nms_topk": "3"},
                  {"nms_threshold": "0.9", "nms_topk": "6", "threshold": "0.65"}):
        jout, pout = _both("MultiBoxDetection", attrs, [probs, loc.reshape(2, -1), anchors])
        _assert_same(jout, pout)
    kept = np.flatnonzero(pout[0][0, :, 0] >= 0)
    assert kept.size >= 1 and (pout[0][0, kept, 1] > 0.65).all()
    # at IoU 0.5 every box overlaps the first of the top scores (0.7, anchor
    # 8, the lowest of the tied): it alone stays
    jout, pout = _both("MultiBoxDetection", {"nms_threshold": "0.5"},
                       [probs, np.zeros((2, 4 * N), np.float32), anchors])
    _assert_same(jout, pout)
    np.testing.assert_array_equal(np.flatnonzero(pout[0][0, :, 0] >= 0), [8])


def test_target_and_detection_on_an_ssd_sized_anchor_set():
    """The two ops on anchors of two SSD-300 scales (19 x 19 and 10 x 10 with
    their published sizes and ratios), a batch of labels with padded rows
    and random predictions: the same targets and detections as JAX's."""
    from mxnet_tpu_torch.models.vgg16_ssd import RATIOS, SIZES

    pop = preg.get_op("MultiBoxPrior")
    anchors = np.concatenate([
        pop.apply(preg.parse_attrs(pop, {"sizes": str(SIZES[i]), "ratios": str(RATIOS[i])}),
                  [torch.zeros(1, 1, n, n)])[0][0].numpy() for i, n in ((1, 19), (2, 10))],
        axis=1)
    N = anchors.shape[1]
    rs = np.random.RandomState(6)
    label = -np.ones((3, 5, 5), np.float32)
    for b, k in enumerate((1, 3, 5)):
        for j in range(k):
            x0, y0 = rs.uniform(0, 0.6, 2)
            label[b, j] = [rs.randint(20), x0, y0, x0 + rs.uniform(0.1, 0.4),
                           y0 + rs.uniform(0.1, 0.4)]
    cls_pred = rs.randn(3, 21, N).astype(np.float32)
    jout, pout = _both("MultiBoxTarget", dict(MINING, overlap_threshold="0.5"),
                       [anchors, label, cls_pred])
    _assert_same(jout, pout)
    assert (pout[2] > 0).sum() >= 9 and (pout[2] == -1).any()
    probs = np.exp(cls_pred) / np.exp(cls_pred).sum(axis=1, keepdims=True)
    jout, pout = _both("MultiBoxDetection", {"nms_threshold": "0.45", "nms_topk": "400"},
                       [probs.astype(np.float32), rs.randn(3, 4 * N).astype(np.float32) * 0.2,
                        anchors])
    _assert_same(jout, pout)
