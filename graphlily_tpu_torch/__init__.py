"""graphlily_tpu_torch: the PyTorch/CUDA port of graphlily_tpu.

A second package beside the JAX one, with the same layout so each module
has a counterpart there. It imports torch and never jax: its host layer
(io/) is its own numpy copy, and the JAX package's tests hold the two
equal. The chunked, roll-router, planar-router and tropical SpMV engines
run as hand-written CUDA kernels for Hopper (csrc/, built at first use by
ops/_build.py).

Layer map:
  io/       containers, generators, formatter, chunked, router, planar
            and tropical layouts (numpy)
  ops/      CUDA kernel wrappers + plain PyTorch reference engine
  module/   SpMV, SpMSpV, eWiseAdd and assign modules
  apps/     PageRank, BFS and SSSP (pull, push, pull_push)
"""

from .config import EngineConfig, DEFAULT_CONFIG
from .semiring import (ArithmeticSemiring, LogicalSemiring, TropicalSemiring,
                       Semiring, MaskType, OpType, SEMIRINGS, FLOAT_INF)
