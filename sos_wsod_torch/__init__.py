"""PyTorch/CUDA port of the SoS-WSOD system for NVIDIA Hopper GPUs.

Mirrors the layout of the JAX package ``sos_wsod_tpu`` (the reference it is
tested against) and imports no JAX: plain tensor code is PyTorch, and every
Pallas kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, bound in ``kernels/``.
"""
