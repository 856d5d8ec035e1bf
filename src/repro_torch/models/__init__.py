# The LLM layer: dense, hybrid (hymba) and rwkv6 decoder-only LMs; the dense
# family also trains (train_loss, through attention._Flash).
#   common.py     — ParamSpec trees as nn.Modules, norms, RoPE, init
#   ffn.py        — gated / gelu MLP
#   attention.py  — prefill attention (flash kernel wrapper), its backward
#                   (_Flash), decode attention
#   ssm.py        — the Mamba branch (chunked scan kernel wrapper for prefill)
#   lm.py         — layer groups, Block, LM with train_loss / prefill /
#                   decode_step, chunked_xent
#   api.py        — build_model / Model
#   weights.py    — from_reference / to_reference: the reference's parameter tree in
#   serve_llm.py  — ServeEngine.generate (prefill + greedy decode)
