"""Module API: high-level training interface.

Counterpart of ``mxnet_tpu/module/`` (reference: python/mxnet/module/:
BaseModule base_module.py:79, Module module.py:22, BucketingModule,
SequentialModule, PythonModule, PythonLossModule) on one context or
several, with or without a KVStore, and ``ElasticFit``, the
fault-tolerant loop behind ``fit(elastic=...)``.
"""
from .base_module import BaseModule, BatchEndParam
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from .elastic import ElasticFit

__all__ = ["BaseModule", "BatchEndParam", "Module", "BucketingModule",
           "SequentialModule", "PythonModule", "PythonLossModule", "ElasticFit"]
