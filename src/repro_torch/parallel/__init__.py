# Gradient compression (compression.py).  The mesh-bound parts of the
# reference's parallel package (compressed_psum, sharding, pipeline) wait
# for a multi-card slice.
