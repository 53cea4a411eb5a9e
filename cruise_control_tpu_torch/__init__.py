"""PyTorch/CUDA port of tpu-cruise's rebalance-plan engine.

A second package beside ``cruise_control_tpu`` (the JAX reference): the same
sub-package layout and function names, written in PyTorch for an NVIDIA
Hopper card.  It imports nothing of the JAX package.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asking for ``cuda``
without a card raises instead of running on the CPU.
"""
