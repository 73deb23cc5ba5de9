"""Serving stack of the port: the sealed executable cache and the KV-cache decoder."""
from .cache import PersistentExecutableCache  # noqa: F401
from .kv_decode import KVCacheDecoder  # noqa: F401
