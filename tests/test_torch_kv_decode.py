"""The serving slice as a whole: the same parameters through the JAX
package's KVCacheDecoder, in the forced serving setting its Pallas kernels
engage in (interpret mode on the CPU), and through the port's
KVCacheDecoder on the CPU, where each fused site runs its kernel's plain
version. Prefill logits, the first decode steps' logits and the greedy
tokens must agree; a sealed cache must refuse a new shape."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as pt
from mxnet_tpu import telemetry
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import KVCacheDecoder as JaxDecoder
from mxnet_tpu_torch.serving import KVCacheDecoder

torch.set_num_threads(1)

CFG = dict(vocab_size=256, num_layers=2, num_heads=2, model_dim=128, ffn_dim=256)
FORCED_INFER = "attention=pallas_flash,matmul_bias_act=pallas,norm_residual=pallas"
N_TOKENS = 16


def _params(seed=0):
    net = jtf.get_symbol(seq_len=32, **CFG)
    shapes = net.infer_shape(data=(1, 32), softmax_label=(1, 32))[0]
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _run(dec, prompt, **greedy_kw):
    """Prefill logits, three teacher-forced decode steps' logits, then greedy tokens."""
    pf = dec.prefill(prompt)
    steps = [dec.decode_step(np.argmax(pf, axis=-1))]
    for _ in range(2):
        steps.append(dec.decode_step(np.argmax(steps[-1], axis=-1)))
    dec.reset()
    return pf, np.stack(steps), dec.greedy(prompt, N_TOKENS, **greedy_kw)


# prefill_len < max_len seeds the ring by an in-place copy; prefill_len ==
# max_len swaps the tensors, and the 26 positions then wrap the 16-slot ring
SERVES = {"ring_copy": dict(batch=8, prefill_len=16, max_len=32, pos_len=32),
          "ring_swap_wrap": dict(batch=8, prefill_len=16, max_len=16, pos_len=32)}


@pytest.fixture(scope="module", params=sorted(SERVES))
def decoded(request):
    serve = SERVES[request.param]
    params = _params()
    prompt = np.random.RandomState(3).randint(1, CFG["vocab_size"], (8, 10))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_GRAPHREWRITE", "on")
        mp.setenv("MXNET_FUSED_PATTERNS_INFER", FORCED_INFER)
        mp.delenv("MXNET_FUSED_PATTERNS", raising=False)
        mp.delenv("MXNET_FUSION_TUNE_DIR", raising=False)
        mp.delenv("MXNET_DECODE_MEGASTEP_K", raising=False)
        saved = telemetry.current_override()
        telemetry.set_mode("counters")
        telemetry.reset()
        try:
            jdec = JaxDecoder(params, ctx=mx.cpu(), **CFG, **serve)
            ref = _run(jdec, prompt, k=1)
            engaged = {k: v for k, v in telemetry.snapshot().items()
                       if k.startswith("fusion.pattern_engaged.")}
        finally:
            telemetry.set_mode(saved)
            telemetry.reset()
    port_params = pt.params_from_numpy(params, ctx=pt.cpu())
    pdec = KVCacheDecoder(port_params, ctx=pt.cpu(), **CFG, **serve)
    return ref, _run(pdec, prompt), engaged, pdec


def test_reference_engaged_its_kernels(decoded):
    *_, engaged, _ = decoded
    assert engaged.get("fusion.pattern_engaged.attention", 0) > 0
    assert engaged.get("fusion.pattern_engaged.matmul_bias_act", 0) > 0
    assert engaged.get("fusion.pattern_engaged.norm_residual", 0) > 0


def test_prefill_logits_match(decoded):
    (jpf, _, _), (ppf, _, _), *_ = decoded
    assert ppf.shape == (8, CFG["vocab_size"])
    np.testing.assert_allclose(ppf, jpf, atol=1e-4, rtol=1e-4)


def test_decode_step_logits_match(decoded):
    (_, jsteps, _), (_, psteps, _), *_ = decoded
    np.testing.assert_allclose(psteps, jsteps, atol=1e-4, rtol=1e-4)


def test_greedy_tokens_identical(decoded):
    (_, _, jtok), (_, _, ptok), *_ = decoded
    assert ptok.shape == (8, N_TOKENS) and ptok.dtype == np.int64
    np.testing.assert_array_equal(ptok, jtok)


def test_post_seal_shape_miss_raises(decoded):
    *_, pdec = decoded
    assert pdec._pf_cache.sealed and pdec._dec_cache.sealed
    with pytest.raises(pt.MXNetError, match="post-warmup executable-cache miss"):
        pdec._pf_cache.executable({"data": (4, pdec.prefill_len)})
    with pytest.raises(pt.MXNetError):
        pdec.prefill(np.ones((4, 3)))
