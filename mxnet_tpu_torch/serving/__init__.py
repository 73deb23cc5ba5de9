"""Serving stack of the port: the sealed executable cache, the KV-cache
decoders (lockstep and paged, with megasteps), the prefix cache and
speculative decoding. ``InferenceEngine`` comes with a later slice."""
from .cache import PersistentExecutableCache
from .kv_decode import KVCacheDecoder, PagedKVDecoder, PagedKVExhausted
from .prefix_cache import PrefixCache
from .speculative import SpeculativeDecoder, spec_decode_enabled, spec_gamma

__all__ = ["PersistentExecutableCache", "KVCacheDecoder", "PagedKVDecoder",
           "PagedKVExhausted", "PrefixCache", "SpeculativeDecoder", "spec_decode_enabled",
           "spec_gamma"]
