"""Hand-written CUDA kernels (csrc/*.cu, built by _build.py) and their
plain PyTorch versions; the generic NN ops and losses of the auxiliary
model families (nn.py, losses.py: plain torch ops, as their JAX
counterparts reach no kernel)."""
