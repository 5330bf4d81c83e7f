"""fedml_tpu_torch — the PyTorch/CUDA port of fedml_tpu, for NVIDIA Hopper.

A package of its own beside ``fedml_tpu`` (the JAX reference), with the
same layout and names. It imports torch and numpy, never jax, flax, optax
or anything of ``fedml_tpu``. Entry points run on CUDA unless the caller
asks for the CPU.
"""
