from setuptools import setup, find_packages

setup(
    name="boardlaw_tpu",
    version="0.1.0",
    description="TPU-native AlphaZero framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["boardlaw_tpu", "boardlaw_tpu.*",
                                    "boardlaw_tpu_torch", "boardlaw_tpu_torch.*"]),
    package_data={"boardlaw_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "pandas",
        "scipy",
        "portalocker",
    ],
)
