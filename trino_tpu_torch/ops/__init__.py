"""Device operators of the PyTorch engine: plain functions on tensors,
plus the hand-written CUDA kernels they launch (csrc/)."""
