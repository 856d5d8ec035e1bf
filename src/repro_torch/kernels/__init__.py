# Hand-written CUDA kernels (csrc/, sm_90a), each with a plain PyTorch
# version beside it; the wrappers run the plain version for CPU tensors and
# the kernel for CUDA tensors:
#   scatter_max.py     — SSN-guarded scatter-max (recovery §5 batch replay)
#   batch_occ.py       — segmented max/min reduce and the fused
#                        validate→sequence round (batched OCC §4.2/§4.4)
#   flash_attention.py — GQA attention forward of the LLM prefill
#   ssm_scan.py        — chunked selective scan of the hybrid LLM prefill
#   rwkv6.py           — chunked wkv6 recurrence of the rwkv LLM prefill
#   ops.py             — the public wrappers; ref.py the numpy oracles
#   cuda.py            — builds csrc/ with nvcc at first use; launch counts
