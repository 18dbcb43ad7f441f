"""Hand-written Hopper kernels (``csrc/*.cu``), their wrappers with plain
PyTorch versions, and the ops dispatch the model calls."""
