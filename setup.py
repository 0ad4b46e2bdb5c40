"""Build the adcraft_tpu package with its native C++ host-runtime extension.

Usage:
    python setup.py build_ext --inplace   # builds adcraft_tpu/_native*.so
"""

import numpy
from setuptools import Extension, setup

setup(
    name="adcraft_tpu",
    version="0.1.0",
    packages=[
        "adcraft_tpu",
        "adcraft_tpu.agents",
        "adcraft_tpu.parallel",
        "adcraft_tpu.experiments",
        "adcraft_tpu.oracle",
        "adcraft_tpu_torch",
    ],
    # the port's CUDA sources ship as data: they are built with nvcc on
    # first use on the GPU machine, not by setup.py
    package_data={"adcraft_tpu_torch": ["csrc/*.cu"]},
    ext_modules=[
        Extension(
            "adcraft_tpu._native",
            sources=["native/_native.cpp"],
            include_dirs=[numpy.get_include()],
            extra_compile_args=["-O3", "-std=c++17"],
            language="c++",
        )
    ],
)
