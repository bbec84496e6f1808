"""Acoustic model: xconfig DSL -> layer specs (numpy-free copies of the JAX
package's) -> the PyTorch network (network.py)."""
