"""Serving stack of the port: the sealed executable cache, the
continuous-batching ``InferenceEngine`` over it, the KV-cache decoders
(lockstep and paged, with megasteps), the prefix cache and speculative
decoding, and ``fleet``: replica processes of the engine behind a
load-aware ``Router`` (``serving/fleet/``).

    cache = serving.PersistentExecutableCache(sym, arg_params, aux_params)
    eng = serving.InferenceEngine(cache, {"data": (3, 224, 224)},
                                  buckets=(1, 2, 4, 8))
    eng.start()
    probs = eng.infer({"data": batch})          # blocking
    fut = eng.submit({"data": batch})           # or async
    probs = fut.result(timeout=5.0)
"""
from .cache import PersistentExecutableCache
from .engine import (InferenceEngine, ServeFuture, ServeDeadlineError,
                     ServeOverloadError, ServeClosedError)
from .kv_decode import KVCacheDecoder, PagedKVDecoder, PagedKVExhausted
from .prefix_cache import PrefixCache
from .speculative import SpeculativeDecoder, spec_decode_enabled, spec_gamma
from . import fleet

__all__ = ["PersistentExecutableCache", "InferenceEngine", "ServeFuture",
           "ServeDeadlineError", "ServeOverloadError", "ServeClosedError",
           "KVCacheDecoder", "PagedKVDecoder", "PagedKVExhausted", "PrefixCache",
           "SpeculativeDecoder", "spec_decode_enabled", "spec_gamma", "fleet"]
