# The parallel layer: logical-axis placements on a DeviceMesh and the
# sharded train step (sharding.py), the logical constraint context
# (axes.py), int8 gradient compression and its all-reduce
# (compression.py), and the GPipe pipeline (pipeline.py).
