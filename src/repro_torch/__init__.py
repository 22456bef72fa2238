"""FusionANNS on PyTorch and CUDA (one NVIDIA H100).

The port of ``repro`` (JAX/Pallas on a TPU), laid out module for module
like it.  The online query path runs on the card through two CUDA kernels
written for ``sm_90a`` (``kernels/pq_adc/csrc``); their plain PyTorch
versions beside them run for CPU tensors.  Entry points default to
``device="cuda"`` and raise when no card is present and no device was
asked for.
"""
