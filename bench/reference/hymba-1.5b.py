"""The plain reference of ``bench/configs/hymba-1.5b.json``: the decoder LM of
``plain_lm``, whose family the configuration names."""

from bench.reference.plain_lm import hidden, logits, param_list, serve_groups  # noqa: F401
