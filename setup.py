from setuptools import find_packages, setup

setup(
    name="stochastic_gcn_tpu",
    version="0.1.0",
    description=("Stochastic GCN training framework with variance "
                 "reduction (VR-GCN) in JAX"),
    packages=find_packages(),
    package_data={"stochastic_gcn_tpu": ["csrc/*.cpp"]},
    install_requires=["numpy", "scipy", "jax", "optax"],
    python_requires=">=3.10",
)
