# The LLM layer (serving slice): dense and hybrid (hymba) decoder-only LMs.
#   common.py     — ParamSpec trees as nn.Modules, norms, RoPE, init
#   ffn.py        — gated / gelu MLP
#   attention.py  — prefill attention (flash kernel wrapper), decode attention
#   ssm.py        — the Mamba branch (chunked scan kernel wrapper for prefill)
#   lm.py         — layer groups, Block, LM with prefill / decode_step
#   api.py        — build_model / Model
#   weights.py    — from_reference: the reference's parameter tree in
#   serve_llm.py  — ServeEngine.generate (prefill + greedy decode)
