# The optimizer: adamw.py (AdamW with global-norm clipping and a cosine
# schedule), functional over the reference's parameter tree.
