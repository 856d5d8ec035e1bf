"""Poplar's recoverable parallel logging on PyTorch and CUDA.

The PyTorch port of the batched OLTP main path: batched OCC with a fused
validate/sequence round, Poplar logging onto the storage devices, and fused
crash recovery.  Host-side framing, buffers, storage and commit stay numpy
and bytes (the log format is a wire format); the device functions live in
:mod:`repro_torch.kernels.ops`, each a hand-written CUDA kernel for Hopper
(``sm_90a``) with a plain PyTorch version beside it for CPU tensors.

The entry points run on the GPU unless the caller asks for the CPU:
``BatchOCC(..., mode="kernel", device="cuda")`` and
``recover(..., mode="kernel", device="cuda")`` are the defaults.
"""
