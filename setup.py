"""deepspeed_tpu packaging + native host-ops extension.

Reference analog: setup.py building the CUDA extensions
(reference setup.py:44-118). The TPU compute path needs no compiled
kernels (Pallas is JIT-compiled), so the only native component is the
host-ops extension (csrc/host_ops.cpp). Build in place with:

    python setup.py build_ext --inplace
"""

from setuptools import Extension, find_packages, setup

ext_modules = [
    Extension(
        "_ds_host_ops",
        sources=["csrc/host_ops.cpp"],
        extra_compile_args=["-O3", "-std=c++17", "-pthread"],
        extra_link_args=["-pthread"],
        language="c++",
    )
]

setup(
    name="deepspeed_tpu",
    version=open("deepspeed_tpu/version.py").read().split('"')[1],
    description="TPU-native training acceleration library "
    "(JAX/XLA/Pallas rebuild of the DeepSpeed capability surface)",
    packages=find_packages(include=[
        "deepspeed_tpu", "deepspeed_tpu.*",
        "deepspeed_tpu_torch", "deepspeed_tpu_torch.*",
    ]),
    package_data={"deepspeed_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    scripts=["bin/deepspeed", "bin/ds", "bin/ds_ssh"],
    ext_modules=ext_modules,
    python_requires=">=3.10",
    install_requires=["jax", "flax", "numpy"],
)
