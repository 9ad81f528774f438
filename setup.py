"""Package installer (counterpart of the reference's setup.py, which builds
the compiler + SWIG bindings on install; here the native host library builds
lazily on first use via yask_tpu.native)."""

from setuptools import find_packages, setup

setup(
    name="yask_tpu",
    version="0.1.0",
    description=("TPU-native stencil-computation framework: stencil DSL "
                 "compiler + JAX/XLA/Pallas kernel runtime with device-mesh "
                 "domain decomposition"),
    packages=find_packages(include=["yask_tpu", "yask_tpu.*",
                                    "yask_tpu_torch", "yask_tpu_torch.*"]),
    package_data={"yask_tpu.native": ["host.cpp", "Makefile"],
                  # the port's CUDA sources, built by nvcc at first use
                  "yask_tpu_torch": ["csrc/*.cu*"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"orbax": ["orbax-checkpoint"],
                    "torch": ["torch"]},
    entry_points={
        "console_scripts": [
            "yask-tpu=yask_tpu.main:main",
            "yask-tpu-compiler=yask_tpu.compiler.__main__:main",
        ],
    },
)
