"""omni_pq_torch: the PyTorch / CUDA (H100) port of omni_pq_tpu.

This slice holds the eval-mode PQ-Transformer serving path: the model
(`models`), its point-cloud ops with hand-written CUDA kernels for furthest
point sampling and ball query + grouping (`ops`, `csrc`), the numpy decode
and corner-F1 (`evals`), synthetic scenes (`data`), the weight bridge from
the JAX package (`interop`), and the inference entry points (`infer`,
`cli.infer`). It imports torch, numpy and scipy, never JAX or omni_pq_tpu.
"""
