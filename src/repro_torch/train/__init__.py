# The train step (step.py): loss, gradients and AdamW, with microbatch
# accumulation and optional int8 gradient compression.
