# The LLM layer: every family of configs/registry.py (dense, moe, hybrid
# hymba, rwkv6, vlm llava, enc-dec whisper) serves and trains.
#   common.py     — ParamSpec trees as nn.Modules, norms, RoPE, init
#   ffn.py        — gated / gelu MLP, top-k MoE with capacity dispatch
#   attention.py  — prefill attention (flash kernel wrapper), its backward
#                   (_Flash), decode attention
#   ssm.py        — the Mamba branch (chunked scan kernel wrapper for prefill)
#   rwkv.py       — the rwkv6 time and channel mixes (wkv6 kernel wrapper)
#   lm.py         — layer groups, Block, LM with train_loss / prefill /
#                   decode_step, chunked_xent
#   encdec.py     — EncDecLM: the whisper encoder-decoder
#   api.py        — build_model / Model, draw_extras (patch and frame embeddings),
#                   attention_calls (flash launches per forward)
#   weights.py    — from_reference / to_reference: the reference's parameter tree in
#                   and out of the port's modules
#   serve_llm.py  — ServeEngine.generate (prefill + greedy decode)
