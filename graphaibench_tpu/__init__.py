"""graphaibench_tpu — a graph-AI framework in JAX.

A from-scratch JAX/XLA rebuild of the capability surface of
GraphAIBench (C++/OpenMP/CUDA/MPI/NVSHMEM benchmark suite): CSR graph
runtime sharing the reference's binary on-disk format, full-batch GNN
training (GCN / GraphSAGE / GAT / GGNN), GraphSAINT sampling, the graph
analytics kernel family (TC, BFS, SSSP, PR, CC, BC, k-core, coloring,
CF-SGD, sampling), graph partitioning + compression tooling, and
multi-chip/multi-host scaling via edge-partitioned graphs with halo
exchange between devices.

Subpackages
-----------
graph      CSR graph container, binary I/O, transforms, partitioning, generators
ops        sparse kernels (SpMM/SDDMM/segment ops, Pallas + XLA paths), RNG, math
nn         GNN layers, losses, optimizers, the training Model, samplers
parallel   device mesh helpers, halo exchange, distributed training steps
analytics  graph analytics solvers with serial oracles
compress   CGR / VByte graph compression codecs
utils      config, timers, logging
"""

__version__ = "0.1.0"

from graphaibench_tpu.graph.csr import CSRGraph  # noqa: F401
