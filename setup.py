"""Package setup for mxnet_tpu (reference: python/setup.py).

The native IO runtime (src/io_native.cc) is JIT-compiled on first use and
cached under build/ (see mxnet_tpu/io_native.py), so no build step is needed
at install time; an sdist/wheel ships the C++ source alongside the package.
"""
from setuptools import find_packages, setup

setup(
    name="mxnet_tpu",
    version="0.1.0",
    description="TPU-native deep learning framework with pre-Gluon MXNet capabilities",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.9",
    install_requires=["numpy", "jax"],
)
