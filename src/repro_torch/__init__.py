"""PyTorch/CUDA port of the Kant reproduction.

Mirrors the layout of the JAX package ``repro`` module for module, and
imports nothing of it.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
