from setuptools import find_packages, setup

setup(
    name="umgen_tpu",
    version="0.1.0",
    description="TPU-native multimodal driving-scene world model framework",
    packages=find_packages(exclude=("tests",)),
    # umgen_tpu_torch (the PyTorch / CUDA port) builds its kernels from
    # these sources at first use
    package_data={"umgen_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
)
