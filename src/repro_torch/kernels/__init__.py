# Hand-written CUDA kernels (csrc/, sm_90a) for the OLTP hot spots, each with
# a plain PyTorch version beside it and an exact numpy oracle in ref.py;
# public wrappers in ops.py (plain version for CPU tensors, kernel for CUDA):
#   scatter_max.py  — SSN-guarded scatter-max (recovery §5 batch replay)
#   batch_occ.py    — segmented max/min reduce and the fused
#                     validate→sequence round (batched OCC §4.2/§4.4)
#   cuda.py         — builds csrc/ with nvcc at first use; launch counts
