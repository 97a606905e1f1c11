"""omni_pq_torch: the PyTorch / CUDA (H100) port of omni_pq_tpu.

It holds the PQ-Transformer serving path and its supervised training: the
model in eval and train mode (`models`), its point-cloud ops with
hand-written CUDA kernels for furthest point sampling, ball query +
grouping and the fused SA-MLP (`ops`, `csrc`), the supervised loss
(`losses`), the train step and optimiser (`train`), the numpy decode and
corner-F1 (`evals`), synthetic scenes (`data`), the weight bridge from the
JAX package (`interop`), and the entry points (`infer`, `cli.infer`,
`cli.train`). It imports torch, numpy and scipy, never JAX or omni_pq_tpu.
"""
