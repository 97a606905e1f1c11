"""omni_pq_torch: the PyTorch / CUDA (H100) port of omni_pq_tpu.

It holds the PQ-Transformer serving path and its training: the model in
eval and train mode (`models`), its point-cloud ops with hand-written CUDA
kernels for furthest point sampling, ball query + grouping and the fused
SA-MLP (`ops`, `csrc`), the supervised and semi-supervised losses
(`losses`), the train step, optimiser and `.pth` checkpoints (`train`), the
numpy decode, corner-F1 and mAP (`evals`), the ScanNet and ARKitScenes
loaders, the offline preprocessing and synthetic scenes (`data`, with the
native loader core in `native`), metric logging and PLY dumps (`utils`),
the weight bridge from the JAX package (`interop`), and the entry points
(`infer`, `cli.train`, `cli.eval`, `cli.infer`) and the experiment drivers
(`experiments`). It imports torch, numpy and scipy, never JAX or
omni_pq_tpu.
"""
