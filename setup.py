"""Packaging (parity: reference setup.py). Not needed for in-repo use."""

from setuptools import find_packages, setup

setup(
    name="maggy-tpu",
    version="0.1.0",
    description=(
        "TPU-native asynchronous hyperparameter optimization, ablation "
        "studies, and distributed training on JAX/XLA/Pallas."
    ),
    packages=find_packages(exclude=["tests", "examples"]),
    package_data={"maggy_tpu.native": ["framing.cpp"],
                  "maggy_tpu_torch": ["ops/csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "msgpack",
        "jax",
        "flax",
        "optax",
        "scipy",
        "scikit-learn",
    ],
    extras_require={
        "checkpoint": ["orbax-checkpoint"],
        "tensorboard": ["tensorboard"],  # torch-free: proto-level writer
        "gcs": ["gcsfs"],
    },
    entry_points={
        "console_scripts": [
            "maggy-tpu-runner = maggy_tpu.runner:main",
            "maggy-tpu-monitor = maggy_tpu.monitor:main",
        ],
    },
)
