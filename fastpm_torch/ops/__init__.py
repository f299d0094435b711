"""Operations with hand-written CUDA kernels (see csrc/)."""
