"""The stash policy of the port's fused conv+BN (``MXNET_FUSED_CONV_BN_BWD=
stash``: the forward writes xn = relu(x·scale + shift), the backward reads
it) held against the JAX package's.

- ``ConvBlock(..., bwd="stash")``'s gradients against ``jax.grad`` of the
  JAX package's ``pcb.conv_block(..., True, "stash")`` (its Pallas forward
  with ``emit_xn`` and backward with ``stash``, in interpret mode) at the six
  ``_FAST`` cells of ``tests/test_pallas_conv_bn_bwd.py``, their inputs and
  fixed cotangents, each cell under the stash policy on both sides, with
  the tolerances of the port's recompute parity tests
  (``tests/test_torch_conv_bn.py``, ``tests/test_torch_train_bf16.py``).
  Each case asserts that JAX really stashed at that shape.
- The plain stash forms against the plain recompute ones, bitwise: the
  forward's c, Σc and Σc² with and without ``emit_xn``, its xn against the
  prologue (and the JAX kernel's xn output), the backward with and without
  the stashed xn, and ``ConvBlock`` under both policies.
- A site with no prologue has nothing to stash and runs recompute, in both
  packages.
- ``bwd_mode`` for each ``MXNET_FUSED_CONV_BN_BWD`` value against JAX's at
  the same shapes, in float32 and bfloat16; a tuned ``cuda:stash`` verdict
  resolves to ``"stash"`` as JAX's ``pallas:stash`` does; the tune
  measures ``cuda:stash``.
- The narrow bottleneck net of ``tests/test_torch_resnet.py`` bound in both
  packages under ``MXNET_FUSED_CONV_BN=1``, ``MXNET_FUSED_CONV_BN_BWD=
  stash``: outputs, every gradient and the aux updates, with every planned
  site that has a prologue stashing on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu.fusion
import mxnet_tpu.fusion_tune
from mxnet_tpu.ops import pallas_conv_bn as pcb
import mxnet_tpu_torch as pt
import mxnet_tpu_torch.fusion
import mxnet_tpu_torch.fusion_tune
from mxnet_tpu_torch.ops import conv_bn as cb
from test_pallas_conv_bn_bwd import _FAST, _mk
from test_torch_resnet import AUX_TOL, GRAD_TOL, INPUTS, OUT_TOL, _J, _P, _narrow, _values

torch.set_num_threads(1)
BF16 = torch.bfloat16

_ENV = ("MXNET_FUSED_CONV_BN", "MXNET_FUSED_CONV_BN_BWD", "MXNET_FUSION_TUNE_DIR")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def _cell_inputs(kernel, stride, variant, dtype, seed=10):
    """The inputs and fixed cotangents of ``test_pallas_conv_bn_bwd._case``
    for one cell, made the same way (its ReLU-tie nudge of shift included)."""
    B, K, H, W, N = 2, 8, 8, 8, 16
    if stride != (1, 1):
        H = W = 9
    x = _mk((B, K, H, W), seed, dtype)
    w = _mk((N, K) + kernel, seed + 1, dtype) * 0.1
    scale, shift = _mk((K,), seed + 2), _mk((K,), seed + 3)
    bsh = (1, -1, 1, 1)
    for _ in range(64):
        xn = x * scale.astype(dtype).reshape(bsh) + shift.astype(dtype).reshape(bsh)
        if not bool(jnp.any(xn == 0)):
            break
        shift = shift + np.float32(0.0031)
    Ho, Wo = pcb.strided_dims(H, W, stride)
    r = _mk((B, N, Ho, Wo), seed + 4, dtype) if variant == "pr" else None
    cots = (_mk((B, N, Ho, Wo), seed + 5), _mk((N,), seed + 6) * 0.1, _mk((N,), seed + 7) * 0.01)
    return (x, w, scale, shift, r), cots


def _loss_terms(c, s, q, cos, cs, cq):
    return (c.astype(jnp.float32) * cos).sum() + (s * cs).sum() + (q * cq).sum()


def _torch(a, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


def _bf16_close(got, want, atol_rel=1e-5):
    """bf16 values of one function: neighbouring bfloat16 values, or within
    ``atol_rel`` of the largest |want| (a sum that cancels)."""
    g, w = got.float(), want.float()
    near = (g - w).abs() <= atol_rel * float(w.abs().max())
    far = (cb.bf16_ulps(g, w) > 1) & ~near
    assert int(far.sum()) == 0, (int(far.sum()), float((g - w).abs().max()))


CELLS = sorted(_FAST, key=str)


@pytest.mark.parametrize("kernel,stride,variant,policy,dtype", CELLS,
                         ids=["%dx%d-s%d-%s-%s-%s" % (c[0][0], c[0][1], c[1][0], c[2], c[3], c[4])
                              for c in CELLS])
def test_stash_gradients_match_the_pallas_stash_policy(kernel, stride, variant, policy, dtype):
    """At each ``_FAST`` cell (its own policy aside: both sides run stash)
    the port's gradients of the fixed-cotangent loss against JAX's."""
    jdt = jnp.dtype(dtype)
    ins, (cos, cs, cq) = _cell_inputs(kernel, stride, variant, jdt)
    x, w, scale, shift, r = ins
    res = r is not None
    # JAX really stashes here: its forward fits the xn output, its backward
    # tiles with it, and its forward's residuals carry xn
    kw = dict(itemsize=jdt.itemsize, prologue=True, res=res)
    assert pcb.plan_blocks(x.shape, w.shape, stride, emit_xn=True, **kw) is not None
    assert pcb.plan_bwd_blocks(x.shape, w.shape, stride, stash=True, **kw) is not None
    _, saved = pcb._conv_block_fwd(x, w, scale, shift, r, kernel, stride, True, True, "stash")
    assert saved[-1] is not None and saved[-1].dtype == jdt

    argnums = tuple(i for i, a in enumerate(ins) if a is not None)
    want = jax.grad(lambda *a: _loss_terms(*pcb.conv_block(*a, kernel, stride, True, True,
                                                           "stash"), cos, cs, cq),
                    argnums=argnums)(*ins)

    tdt = BF16 if dtype == "bfloat16" else torch.float32
    leaves = [None if a is None else _torch(a, tdt if i in (0, 1, 4) else None).requires_grad_()
              for i, a in enumerate(ins)]
    seen = []
    real = cb.conv_block

    def spy(*a, **k):
        seen.append(k.get("emit_xn", False))
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "conv_block", spy)
        c, s, q = cb.ConvBlock.apply(*leaves, stride, True, "stash")
    assert seen == [True]
    loss = (c.float() * _torch(cos)).sum() + (s * _torch(cs)).sum() + (q * _torch(cq)).sum()
    got = torch.autograd.grad(loss, [t for t in leaves if t is not None])
    for i, g, jw in zip(argnums, got, want):
        name = ("x", "w", "scale", "shift", "res")[i]
        if dtype == "float32" or name in ("scale", "shift"):
            assert g.dtype == torch.float32, name
            # the tolerances of the port's recompute parity tests: rtol 1e-5,
            # atol 1e-4 (float32); 1e-5 of the largest (bf16's float32 sums)
            if dtype == "float32":
                np.testing.assert_allclose(g.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-4,
                                           err_msg=name)
            else:
                torch.testing.assert_close(g, _torch(jw), rtol=0,
                                           atol=1e-5 * float(np.abs(np.asarray(jw)).max()))
        else:
            assert g.dtype == BF16 and jw.dtype == jnp.bfloat16, name
            _bf16_close(g, _torch(jw))


def _site(kernel, stride, res, seed=3):
    rs = np.random.RandomState(seed)
    B, K, N = 2, 16, 24
    H = W = 9 if stride == 2 else 8
    x = rs.randn(B, K, H, W).astype(np.float32)
    w = (rs.randn(N, K, kernel, kernel) / np.sqrt(K * kernel * kernel)).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, K).astype(np.float32)
    shift = rs.uniform(-0.3, 0.3, K).astype(np.float32)
    Ho, Wo = pcb.strided_dims(H, W, (stride, stride)) if kernel == 1 else (H, W)
    r = rs.randn(B, N, Ho, Wo).astype(np.float32) if res else None
    cots = (rs.randn(B, N, Ho, Wo).astype(np.float32), rs.randn(N).astype(np.float32),
            (rs.randn(N) * 0.1).astype(np.float32))
    return x, w, scale, shift, r, cots


SITES = [pytest.param(k, s, r, d, id="%dx%d-s%d-%s-%s" % (k, k, s, "res" if r else "nores", d))
         for k, s in ((1, 1), (1, 2), (3, 1)) for r in (False, True)
         for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("kernel,stride,res,dtype", SITES)
def test_plain_stash_forms_equal_the_recompute_forms_bitwise(kernel, stride, res, dtype):
    """The forward with ``emit_xn`` gives the recompute forward's c, Σc and
    Σc² bit for bit, and xn the prologue of the positions the conv reads
    (the JAX kernel's xn: bitwise in bfloat16, within an f32 rounding in
    float32); the backward reading xn gives the recompute backward's five
    outputs bit for bit, and so does ``ConvBlock`` under both policies."""
    x, w, scale, shift, r, (dc, ds, dq) = _site(kernel, stride, res)
    tdt = BF16 if dtype == "bfloat16" else torch.float32
    st = (stride, stride)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    tsc, tsh = torch.from_numpy(scale), torch.from_numpy(shift)
    tr = None if r is None else torch.from_numpy(r).to(tdt)
    stashed = cb.conv_block(tx, tw, tsc, tsh, tr, st, True, emit_xn=True)
    plain = cb.conv_block(tx, tw, tsc, tsh, tr, st, True)
    assert len(stashed) == 4 and all(torch.equal(a, b) for a, b in zip(stashed, plain))
    xn = stashed[3]
    Ho, Wo = plain[0].shape[2:]
    assert xn.shape == (2, 16, Ho, Wo) and xn.dtype == tdt
    xs = tx[:, :, ::stride, ::stride] if kernel == 1 else tx
    want_xn = (cb._prologue_bf16 if dtype == "bfloat16" else cb._prologue)(xs, tsc, tsh, True)
    assert torch.equal(xn, want_xn)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jxn = pcb._conv_block_fwd_impl(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(scale),
        jnp.asarray(shift), None if r is None else jnp.asarray(r).astype(jdt),
        kernel_hw=(kernel, kernel), stride=st, relu=True, interpret=True, emit_xn=True)[3]
    if dtype == "bfloat16":
        assert torch.equal(xn, _torch(jxn, BF16))
    else:
        np.testing.assert_allclose(xn.numpy(), np.asarray(jxn), rtol=1e-6, atol=1e-6)

    tdc = torch.from_numpy(dc).to(tdt)
    tds, tdq = torch.from_numpy(ds), torch.from_numpy(dq)
    args = (tx, tw, tsc, tsh, plain[0], tdc, tds, tdq, st, True, res)
    for a, b in zip(cb.conv_block_bwd(*args, xn=xn), cb.conv_block_bwd(*args)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)

    def grads(bwd):
        leaves = [t if t is None else t.clone().requires_grad_() for t in (tx, tw, tsc, tsh, tr)]
        outs = cb.ConvBlock.apply(*leaves, st, True, bwd)
        torch.autograd.backward(outs, [tdc, tds, tdq])
        return [o.detach() for o in outs] + [t.grad for t in leaves if t is not None]

    for a, b in zip(grads("stash"), grads("recompute")):
        assert torch.equal(a, b)


def test_stash_without_a_prologue_runs_recompute_in_both_packages():
    """No prologue, nothing to stash: ``conv_block`` refuses ``emit_xn``;
    ``ConvBlock(bwd="stash")`` runs the recompute forward (no ``emit_xn``)
    and gives its bits, as JAX's forward keeps no xn there (:486)."""
    x, w, _, _, r, (dc, ds, dq) = _site(1, 1, True)
    tx, tw, tr = (torch.from_numpy(a) for a in (x, w, r))
    with pytest.raises(pt.MXNetError, match="emit_xn"):
        cb.conv_block(tx, tw, None, None, tr, (1, 1), False, emit_xn=True)
    seen, real = [], cb.conv_block

    def spy(*a, **k):
        seen.append(k.get("emit_xn", False))
        return real(*a, **k)

    def grads(bwd):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, r)]
        outs = cb.ConvBlock.apply(leaves[0], leaves[1], None, None, leaves[2], (1, 1), False,
                                  bwd)
        torch.autograd.backward(outs, [torch.from_numpy(a) for a in (dc, ds, dq)])
        return [o.detach() for o in outs] + [t.grad for t in leaves]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cb, "conv_block", spy)
        got = grads("stash")
    assert seen == [False]
    assert all(torch.equal(a, b) for a, b in zip(got, grads("recompute")))
    _, saved = pcb._conv_block_fwd(jnp.asarray(x), jnp.asarray(w), None, None, jnp.asarray(r),
                                   (1, 1), (1, 1), False, True, "stash")
    assert saved[-1] is None


# (kernel, stride, x shape, w shape, res): sites where JAX's stash tiles
BWD_SHAPES = [((1, 1), (1, 1), (2, 8, 8, 8), (16, 8, 1, 1), False),
              ((1, 1), (1, 1), (2, 8, 8, 8), (16, 8, 1, 1), True),
              ((1, 1), (2, 2), (2, 8, 9, 9), (16, 8, 1, 1), False),
              ((3, 3), (1, 1), (2, 16, 8, 8), (8, 16, 3, 3), True),
              ((3, 3), (1, 1), (2, 8, 2, 2), (16, 8, 3, 3), False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("env", ["0", "xla", "1", "recompute", "stash", "junk"])
def test_bwd_mode_matches_the_reference_for_each_env_value(env, dtype, monkeypatch):
    """``MXNET_FUSED_CONV_BN_BWD`` resolves as JAX's does: ``stash`` where
    the shape tiles (the port has no VMEM budget, so wherever recompute
    does), ``xla`` at a shape the kernels refuse. ``auto`` is the port's
    departure (no win table: recompute), pinned in
    ``test_torch_fusion_patterns.py``."""
    monkeypatch.setenv("MXNET_FUSED_CONV_BN_BWD", env)
    jdt, tdt = (jnp.bfloat16, BF16) if dtype == "bfloat16" else (np.float32, torch.float32)
    got = []
    for kernel, stride, xs, ws, res in BWD_SHAPES:
        want = mxnet_tpu.fusion.bwd_mode(kernel, stride, xs, ws, jdt, True, res=res)
        mine = pt.fusion.bwd_mode(kernel, stride, xs, ws, tdt, True, res=res)
        assert mine == want, (xs, ws, env, mine, want)
        got.append(mine)
    expect = {"0": "xla", "xla": "xla", "1": "recompute", "recompute": "recompute",
              "stash": "stash", "junk": "xla"}[env]
    # the last shape (a 2 x 2 grid) the kernels refuse
    assert got == [expect] * 4 + ["xla"]


def test_a_tuned_stash_verdict_resolves_to_stash(tmp_path, monkeypatch):
    """Under ``auto`` a site's engaged verdict whose lowering is
    ``cuda:stash`` (JAX: ``pallas:stash``) gives ``"stash"``, a schedule
    suffix aside; the port's tune measures ``cuda:stash`` beside
    ``cuda:xla`` and ``cuda:recompute``."""
    kernel, stride, xs, ws = (1, 1), (1, 1), (2, 8, 8, 8), (16, 8, 1, 1)
    for m, low in ((pt, "cuda:stash@bn=16"), (mxnet_tpu, "pallas:stash")):
        monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path / m.__name__))
        m.fusion_tune.reset()
        key = m.fusion._conv_bn_key(kernel, stride, xs, ws, np.float32, False)
        m.fusion_tune.verdict(key, lambda: {"engage": True, "lowering": low,
                                            "measured": {low: {"fwd_us": 1.0}}})
        assert m.fusion.bwd_mode(kernel, stride, xs, ws, np.float32, True) == "stash", m
        m.fusion_tune.reset()
    monkeypatch.setenv("MXNET_FUSION_TUNE_DIR", str(tmp_path / "measured"))
    monkeypatch.setenv("MXNET_FUSION_TUNE_ITERS", "1")
    with pt.cpu():
        rec = pt.fusion._conv_bn_measure(kernel, stride, xs, ws, np.float32, False)
    assert {"cuda:xla", "cuda:recompute", "cuda:stash"} <= set(rec["measured"])
    assert set(pt.fusion.BWD_POLICIES) == {"xla", "recompute", "stash"}
    pt.fusion_tune.reset()


FORCED = {"MXNET_FUSED_CONV_BN": "1", "MXNET_FUSED_CONV_BN_BWD": "stash"}
SHAPE = (2, 16, 8, 8)


def test_narrow_resnet_under_stash_matches_the_jax_executor(monkeypatch):
    """The narrow bottleneck net (three pre-activation units) bound in both
    packages under the stash policy: ``forward_backward``'s outputs, every
    gradient and the new aux states within ``tests/test_torch_resnet.py``'s
    tolerances, every planned site with a prologue stashing in both (the
    port's forwards with ``emit_xn``, JAX's backwards with an xn)."""
    for k, v in FORCED.items():
        monkeypatch.setenv(k, v)
    jstash, real_bwd = [], pcb._conv_block_bwd_impl

    def jspy(*a, **k):
        jstash.append(a[8] is not None)
        return real_bwd(*a, **k)

    monkeypatch.setattr(pcb, "_conv_block_bwd_impl", jspy)
    jnet = _narrow(_J, mxnet_tpu.name.NameManager)
    jexe = jnet.simple_bind(mxnet_tpu.cpu(), data=SHAPE, softmax_label=(SHAPE[0],))
    args, aux = _values([(n, a.shape) for n, a in jexe.arg_dict.items()],
                        [(n, a.shape) for n, a in jexe.aux_dict.items()])
    jexe.copy_params_from(args, aux)
    want = jexe.forward_backward()[0].asnumpy()
    assert jstash and all(jstash), jstash

    seen, real = [], cb.conv_block

    def spy(*a, **k):
        seen.append((a[2] is not None, k.get("emit_xn", False)))
        return real(*a, **k)

    monkeypatch.setattr(cb, "conv_block", spy)
    exe = _narrow(_P, pt.NameManager).simple_bind(pt.cpu(), data=SHAPE,
                                                  softmax_label=(SHAPE[0],))
    exe.copy_params_from(args, aux)
    got = exe.forward_backward()[0].asnumpy()
    assert seen and all(emit == pro for pro, emit in seen) and any(e for _, e in seen), seen
    assert sum(e for _, e in seen) == len(jstash)
    np.testing.assert_allclose(got, want, **OUT_TOL)
    for n, g in jexe.grad_dict.items():
        if n in INPUTS:
            continue
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(), g.asnumpy(), err_msg=n,
                                   **GRAD_TOL)
    for n, a in jexe.aux_dict.items():
        np.testing.assert_allclose(exe.aux_dict[n].asnumpy(), a.asnumpy(), err_msg=n, **AUX_TOL)
