# The synthetic token pipeline with a resumable cursor (pipeline.py).
