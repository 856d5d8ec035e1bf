# Command-line entry points: serve.py (batched prefill + greedy decode) and
# train.py (training with the Poplar journal: restore, save, resume).
