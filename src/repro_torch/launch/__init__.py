# Command-line entry points: serve.py (batched prefill + greedy decode).
