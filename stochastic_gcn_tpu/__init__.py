"""stochastic_gcn_tpu — stochastic GCN training framework in JAX.

A from-scratch JAX/XLA re-design of the system described in "Stochastic
Training of Graph Convolutional Networks with Variance Reduction" (Chen,
Zhu, Song — ICML 2018), with the capabilities of the reference
implementation (thu-ml/stochastic_gcn): device-resident graphs, on-device
receptive-field sampling, control-variate estimators over device-resident
history, and jit/shard_map scale-out.  It runs on NVIDIA GPUs.
"""

__version__ = "0.1.0"

from .config import Config, parse_flags

__all__ = ["Config", "parse_flags"]
