"""Interop with the reference PyTorch implementation (counterpart of
``compat/`` in the JAX package): ``reference`` loads the reference's torch
modules on the CPU and converts their weights; ``import_reference`` turns a
reference-trained checkpoint into a bundle."""
