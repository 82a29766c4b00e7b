"""PyTorch/CUDA port of distributed_tensorflow_models_tpu.

The subpackages and modules keep the JAX package's names so each has a
findable counterpart.  This package imports torch and numpy only: never
jax, and nothing of the JAX package.  Entry points run on CUDA unless the
caller asks for the CPU.
"""
