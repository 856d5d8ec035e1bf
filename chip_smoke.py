#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It puts ``src`` on ``sys.path`` itself, builds the ``sm_90a`` kernels
from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
together), and then:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. holds each kernel against its plain PyTorch version on the card, on
   seeded random inputs at its main path's shapes, and times both (CUDA
   events, median after warm-up) beside the one PyTorch call that computes
   the same function, where there is one: the three OLTP kernels exactly,
   each with its device operations per call, which must be one, and host
   microseconds per call (``validate_sequence`` at the hybrid and at the
   write-only round's shape, then on rounds with no writer after a round
   with writers on the same first-writer scratch, at a smaller and a larger
   cap; ``ssn_scatter_max`` also in recovery's no-image scan form and at a
   smaller and a larger S on the same scratch, which must come back all
   zero; ``seg_reduce`` min and max also at 2^19 slots);
   flash attention (hymba's prefill shape, B=8, S=T=2048, 25 query and 5 KV
   heads of 64, full and window 1024, bfloat16 and float32, plus a ragged
   S=1000, a bfloat16 full-causal D=128 case with 12 query and 2 KV
   heads, tinyllama-1.1b's training shape, 32 query and 4 KV heads,
   causal, bfloat16 and float32, stablelm-12b's prefill shape, 32 query
   and 8 KV heads of 160, causal, bfloat16 on the tensor-core kernel and
   float32 on the CUDA-core one, each named under the profiler,
   whisper-medium's encoder (B=8, S=T=1500, 16 heads of
   64, bidirectional, bfloat16 and float32) and cross-attention (S=384,
   T=1500), mixtral-8x22b's windowed prefill (B=2, S=T=8192, 48 query and 8
   KV heads of 128, window 4096) and grok-1-314b's softcapped one (B=8,
   S=T=2048, 48 / 8 heads of 128, softcap 30); every case also checks the log-sum-exp
   output against the plain version, ``o`` bit-identical with and without
   it, and its cost; the training shape also times the torch-op attention
   backward and SDPA's), the attention backward kernel at hymba-1.5b's
   training shape (B=8, S=T=2048, 25 query and 5 KV heads of 64, window
   1024 and full causal, bfloat16: against ``_flash_bwd``, with the device
   ms of each of its two launches, its bound at 10·D flops a pair, and
   ``_flash_bwd``'s and SDPA's backward times), the chunked SSM scan (B=8, H=25, S=2048, P=64, N=16, float32
   and bfloat16, plus S=1000; with its device operations per call and the
   device ms of each of its three launches) and the chunked wkv6
   recurrence (rwkv6-7b's prefill shape, B=8, H=64, S=2048, K=V=64,
   float32 and bfloat16, plus S=1000; with its device operations per call,
   which must be 3, and the device ms of each of its three launches)
   within stated tolerances;
3. drives the OLTP main path: YCSB (paper §6.2, one table, key plus 10
   columns of 100 B) with 1,000,000 rows through ``BatchOCC(mode="kernel")``
   onto four path-backed SSD devices, alternating write-only and hybrid
   batches of 65,536 transactions, a fuzzy checkpoint, one small batch that
   the fused round declines, and a kill with the last batch published but
   not drained and a torn frame on device 0;
4. recovers with ``recover(mode="kernel")`` and holds it equal to the
   vectorized and scalar modes and to every drained write, and replays the
   logs against the checkpoint through ``replay_columnar(use_kernel=True)``;
4a. runs TPC-C (paper §6.2, 20 warehouses, 66,220 rows) on the paper's
   Figure 5 engines (CENTR, SILO, NVM-D and Poplar), each with four
   ``OCCWorker`` threads, quiesced, killed and recovered in three modes,
   then Poplar batched through ``BatchOCC(mode="kernel")`` (8 batches of
   8,192 specs, the last not drained), killed and recovered; prints one
   ``tpcc_path`` JSON line;
4b. runs 4 shards over the main path's 1,000,000-row table (write-only
   batches of 65,536, 10% cross-shard) with a checkpoint of every row
   after the load, a ``ShardedReplica`` that starts from it and tails the
   logs on its own thread, a second checkpoint, one
   ``ShardedLogTruncator`` pass and a kill with a torn frame; holds
   ``recover_sharded`` in three modes equal, reads back every loaded row
   and every drained write, holds ``promote()`` equal to it and the
   scatter's scratch all zero; prints one ``sharded_path`` JSON line;
4c. drives the OLTP serving tier (``repro_torch.serve``): (a) 16,384
   conflict-free 1000-B writes arriving 2,048 per step through the stepped
   group-commit scheduler, cut at 4,096 lanes, equal one direct
   ``execute_batch`` on a second stack (logs byte for byte, SSNs, ack
   order, state); (b) ``benchmarks/fig_serve.py``'s two stacks (one engine
   on 2 SSDs; 4 shards of one SSD) over the 1,000,000-row YCSB table, each
   at 6,000 and 48,000 offered txn/s through ``OpenLoopDriver`` on the
   threaded scheduler (goodput, p50/p99/p999, rejects, queue depths,
   fused-round declines, the card's busy share, a ``HealthMonitor``
   through the 48,000 point; the serve.* counters equal ``stats()``);
   (c) per stack a run at 12,000 txn/s killed 0.5 s in after a flight
   dump, a torn frame, recovery in three modes with every ACKED write
   read back, and ``explain_recovery`` naming every ACKED gtid
   ``replayed`` with ``verify_bytes`` true; (d) a traced stepped 4-shard
   serve run (its DAG, critical path and bytes equal on a second run),
   the replay-fidelity gate and the autotuner; no executor fault and no
   ABORTED ticket but by exhausted retries; prints one
   ``serve_tier_path`` JSON line;
   on paths 3, 4a, 4b and 4c every fused OCC round's ``validate_sequence``
   is held against its plain version on the round's own inputs;
5. drives the LLM serve path (``SERVE_RUNS``) for ``hymba-1.5b``,
   ``rwkv6-7b``, ``stablelm-12b``, ``whisper-medium``,
   ``llava-next-mistral-7b`` and then ``mixtral-8x22b``, each at full width
   (rwkv6-7b at 16 of its 32 layers, stablelm-12b at 20 of 40, mixtral at
   8 of 56, the rest at full depth) in bfloat16 with seeded random weights:
   one ``ServeEngine`` answering a warm-up request of 8 prompts (8 new
   tokens), a timed one of 8 and a ragged one of 2 (64 new tokens each)
   (8 x 2048 tokens and 2 x 1000, cache 4096; whisper: 1,500 frames and
   384 tokens, 2 x 200, in its 448-token context; llava: 576 patch
   embeddings before 1,472 tokens, 2 x 424); asserts finite logits and,
   per prefill, each of the arch's kernels once per layer (flash attention
   once per encoder layer and twice per decoder layer for whisper: 72) and
   none of the others, and profiles one more prefill and 8 decode steps;
6. checks each serve path in float32 (TF32 off): at the served depth,
   the model widened in place, a prefill of the timed prompt's first row
   plus 16 decode steps against one prefill of all of them; mixtral, whose
   MoE is not continuation-exact (ROADMAP Queue C), at 2 layers: its
   prefill logits through the flash kernel against the same model through
   ``flash_attention_plain``, and the continuation printed beside the
   dropped (token, slot) counts;
6a. drives the parallel layer (``parallel_path``) over a world-size-1 NCCL
   group on a (1, 1) ("data", "model") mesh, where every leaf resolves to
   ``Replicate()``: tinyllama-1.1b at full width (8 x 2048 tokens, bf16
   weights, fp32 moments, ``compress_grads``) trained 3 steps unsharded
   twice and then through ``shard_train_step`` (parameters and moments as
   DTensors, weights gathered each step) from the same weights and batches:
   losses, grad norms and every leaf's digest equal to the first run's bit
   for bit where the two unsharded runs are, else within their spread, and
   the same flash launches; ``compressed_psum`` at tinyllama's embed
   gradient's shape equal to ``fake_quantize`` bit for bit; ``gpipe_apply``
   on a one-stage ("pod",) mesh equal to ``sequential_reference``; the group
   is destroyed before the next phase;
6b. checks the dry run against the card (``dryrun_path``): the cost mode
   (``parallel/cost_analysis.py``) over ``parallel_path``'s unsharded step
   on meta tensors, whose counted flash ops must equal the step's launches
   and whose roofline lower bound (no smaller than its flop bound) must not
   exceed the step time just measured (its predicted peak is printed beside
   the measured one); then, in a subprocess (no fake process group beside the smoke's),
   ``python -m repro_torch.launch.dryrun`` on tinyllama-1.1b's train_4k
   cell on both production meshes and its decode_32k cell on the single-pod
   one, each ``ok``; at most ``DRYRUN_LIMIT_S``;
6c. trains at full width (``train_path``), one arch at a time:
   tinyllama-1.1b and whisper-medium at full depth, hymba-1.5b at 17 of its
   32 layers, rwkv6-7b at 8 of 32, mixtral-8x22b at 1 of 56: a float32 gradient
   oracle (each kernel's training Function, ``_Flash``, ``_SsmScan``,
   ``_Wkv6``, against autograd through its plain version, 1 x 2048 tokens,
   whisper 1 x 448 over 1,500 frames, TF32 off); then, in deterministic
   mode, bf16 weights, fp32 AdamW moments, 8 x 2048 tokens a step (whisper
   8 x 448 over 1,500 frames), each step launching each of the arch's
   kernels twice per forward call (forward and recompute) and no other
   kernel.  tinyllama and hymba run steps 0-5 with
   the Poplar journal on 4 SSD lanes (step 1 saved and committed, step 3
   saved and crashed at once, a torn frame appended), a restore whose every
   leaf's SHA-256 equals the saved step's and a fresh model resumed to step
   5 with losses and final digests equal to the first run's bit for bit;
   rwkv6, whisper and mixtral run 3 steps; each then one profiled step (device ms by group:
   the kernels' forwards, the torch-op backwards, GEMMs, the optimizer; the
   card's busy share); one ``train_path`` JSON line per arch;
7. asserts that every kernel launched on its own path (each path's counts
   set to 0 just before it and read just after);
8. prints throughput, recovery and serving times beside the card's name and
   power limit, one JSON line of kernel results, and as its last line
   ``{"ok": true, "device": {...}}``.

Every phase asserts; any failure raises and the exit code is non-zero.
Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import platform
import random
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
# cuBLAS reads this when it starts: the training phase's deterministic mode
# needs it set before any product runs on the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import (
    CentrEngine,
    EngineConfig,
    NvmDEngine,
    PoplarEngine,
    ShardedLogTruncator,
    SiloEngine,
    Txn,
    make_devices,
    recover,
)
from repro_torch.core.truncate import FrontierRegistry
from repro_torch.core.checkpoint import CheckpointDaemon, load_latest_checkpoint
from repro_torch.core.recovery import (
    compute_rsne,
    device_ssn_floors,
    load_columnar_segmented,
    replay_columnar,
)
from repro_torch.db import ArrayTable, BatchOCC, OCCWorker, Table, TxnSpec
from repro_torch.db import tpcc, ycsb
from repro_torch.kernels import cuda as kcuda
from repro_torch.kernels import ops as kops
from repro_torch.kernels.batch_occ import (
    seg_reduce,
    seg_reduce_plain,
    validate_sequence,
    validate_sequence_plain,
)
from repro_torch.kernels.flash_attention import (
    attention_pairs,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_plain,
)
from repro_torch.kernels.rwkv6 import block_flops, rwkv6_chunked, rwkv6_chunked_plain
from repro_torch.kernels import scatter_max
from repro_torch.kernels.scatter_max import NO_POS, ssn_scatter_max, ssn_scatter_max_plain
from repro_torch.kernels.ssm_scan import ssm_scan_chunked, ssm_scan_chunked_plain
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.journal import PoplarCheckpointManager, restore_latest, to_pytree
from repro_torch.models import attention as attention_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.api import attention_calls, build_model, draw_extras
from repro_torch.models.serve_llm import ServeEngine
from repro_torch.models.weights import load_reference, to_reference
from repro_torch.optim import adamw
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import pipeline
from repro_torch.parallel.compression import compressed_psum, fake_quantize
from repro_torch.parallel.cost_analysis import analyze
from repro_torch.parallel.sharding import distribute_tree, shard_train_step
from repro_torch.train.step import make_train_step
from repro_torch.tree import keystr_items, tree_leaves, tree_map
from repro_torch.obs import metrics
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.forensics import RULE_REPLAYED, RULE_TORN_TAIL, explain_recovery, explain_recovery_sharded
from repro_torch.obs.health import HealthMonitor, SaturationMonitor
from repro_torch.replica import ShardedReplica
from repro_torch.serve import (
    ABORTED,
    ACKED,
    GroupCommitScheduler,
    OpenLoopDriver,
    ServeConfig,
    ShardedBackend,
    SingleBackend,
    run_stepped_schedule,
)
from repro_torch.shard import ShardedConfig, ShardedEngine, recover_sharded
from repro_torch import trace as ttrace
from bench import readers, tracing
from repro_torch.trace import span as tspan

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3.  int32 ALU rate: the data
# sheet's 67 TFLOP/s fp32 counts an FMA as two operations on 128 lanes per
# SM; int32 has 64 lanes per SM, one operation each: 67 / 4 TOP/s.  Dense
# bf16 tensor-core rate 989 TFLOP/s; fp32 outside the tensor cores 67.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

PAPER_ROWS = 10_000_000
N_ROWS = 1_000_000          # cut from PAPER_ROWS for the smoke's time limit
BATCH = 65_536              # transactions per main-path batch
N_BATCHES = 8
SMALL_BATCH = 1_500         # its rounds fall under the fused round's 2048 lanes
SEGMENT_BYTES = 64 << 20    # recovery sees sealed tiles and tail tiles
TORN_VALUE = b"TORN-VALUE-NEVER-COMMITTED"
DECLINES = ("occ.fused.decline.small_batch", "occ.fused.decline.dense_padding",
            "occ.fused.decline.i32_range")
OLTP_KERNELS = ("validate_sequence", "ssn_scatter_max", "seg_reduce")
# TPC-C, paper §6.2: 20 warehouses at db/tpcc.py's scaled widths (customers
# 120 of 3,000 per district, items 2,000 of 100,000), 66,220 rows
TPCC_WAREHOUSES = 20
TPCC_ENGINES = ("centr", "silo", "nvmd", "poplar")
TPCC_WORKERS = 4
TPCC_TXNS_PER_WORKER = 2_000     # OCCWorker attempts per thread and engine
TPCC_BATCH = 8_192               # BatchOCC specs per batch
TPCC_BATCHES = 8
# sharded Poplar on one card: 4 shards (host partitions of one engine), the
# main path's YCSB table, write-only batches with 10% cross-shard
# transactions (two 500-B writes on two shards instead of one 1000-B write)
SHARDS = 4
SHARD_BUFFERS = 2                # path-backed SSD devices per shard
SHARD_ROWS = N_ROWS
SHARD_BATCHES = 6
SHARD_CROSS = 0.1
SHARD_VALUE = 1000
SHARD_SEGMENT_BYTES = 8 << 20    # small enough that whole sealed segments drop
SMOKE_LIMIT_S = 1200             # the whole run's limit, the kernels' build included
# the serving tier (benchmarks/fig_serve.py's two stacks over the YCSB table)
SERVE_P1_TXNS = 16_384           # stepped transparency run: conflict-free writes
SERVE_P1_STEP = 2_048            # arrivals per step
SERVE_P1_CUT = 4_096             # cut size: every cut takes the fused round
SERVE_RATES = (6_000, 48_000)    # offered txn/s: below and past the knee
SERVE_MAX_TXNS = 12_000          # n = min(this, rate x SERVE_DURATION_S)
SERVE_DURATION_S = 1.0
SERVE_SETTLE_S = 30.0
SERVE_KILL_RATE = 12_000
SERVE_KILL_AT_S = 0.5
SERVE_CFG = dict(latency_budget_s=1e-3, max_batch=256)
SERVE_TRACE_TXNS = 4_096         # the traced stepped 4-shard run
SERVE_TRACE_STEP = 256
SERVE_COUNTERS = (("serve.acked", "acked"), ("serve.rejected", "rejected"),
                  ("serve.aborted", "aborted"), ("serve.retries", "retries"))
LLM_KERNELS = ("flash_attention", "ssm_scan_chunked", "rwkv6_chunked")
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, CACHE_LEN = 8, 2048, 64, 4096
WARM_NEW = 8          # the warm-up request's new tokens: it only warms the path
RAGGED_BATCH, RAGGED_PROMPT = 2, 1000
WHISPER_PROMPT, WHISPER_CONTEXT = 384, 448   # whisper's decoder context: 448 tokens
LLAVA_PATCHES = get_config("llava-next-mistral-7b").vlm.n_patches


@dataclasses.dataclass(frozen=True)
class ServeRun:
    arch: str
    kernels: tuple             # launched on every prefill (see _per_forward), and nothing else
    prompt: int = SERVE_PROMPT  # tokens of the warm-up and timed requests (SERVE_BATCH prompts)
    ragged: int = RAGGED_PROMPT  # tokens of the ragged request (RAGGED_BATCH prompts)
    cache_len: int = CACHE_LEN
    layers: int = 0            # a depth cut (0: full depth), and why
    why_layers: str = ""
    oracle_layers: int = 0     # the float32 oracle's own depth (0: the served depth)


# the LLM serve paths, at full width, each with the kernels its prefill
# launches: hymba-1.5b (32 layers, d_model 1600, 25 query / 5 KV heads of
# 64, window 1024 with full attention at layers 0, 16 and 31, a 25-head
# Mamba branch of state 16), rwkv6-7b (16 of 32 layers, d_model 4096, 64 wkv
# heads of 64, d_ff 14336, vocab 65536), stablelm-12b (20 of 40 layers, d_model 5120, 32
# query / 8 KV heads of 160, d_ff 13824, vocab 100352, LayerNorm: the flash
# kernel at head dim 160), whisper-medium (24 encoder and 24 decoder layers,
# d_model 1024, 16 heads of 64, 1,500 frames, a 384-token prompt in its
# 448-token context: the encoder's bidirectional, the decoder's causal and
# its cross-attention flash calls), llava-next-mistral-7b (32 layers,
# d_model 4096, 32 query / 8 KV heads of 128, 576 patch embeddings before
# 1,472 text tokens: 2,048 positions) and mixtral-8x22b (8 of 56 layers,
# d_model 6144, 48 query / 8 KV heads of 128, window 4096, 8 experts of
# d_ff 16384, top 2)
SERVE_RUNS = (
    ServeRun("hymba-1.5b", ("flash_attention", "ssm_scan_chunked")),
    ServeRun("rwkv6-7b", ("rwkv6_chunked",), layers=16, why_layers=(
        "the smoke's 1,200-s limit, the build included: with every path at full depth it took "
        "921-1,148 s on an H100")),
    ServeRun("stablelm-12b", ("flash_attention",), layers=20, why_layers=(
        "the smoke's 1,200-s limit, the build included: with every path at full depth it took "
        "921-1,148 s on an H100")),
    ServeRun("whisper-medium", ("flash_attention",), prompt=WHISPER_PROMPT, ragged=200,
             cache_len=WHISPER_CONTEXT),
    ServeRun("llava-next-mistral-7b", ("flash_attention",), prompt=SERVE_PROMPT - LLAVA_PATCHES,
             ragged=RAGGED_PROMPT - LLAVA_PATCHES),
    ServeRun("mixtral-8x22b", ("flash_attention",), layers=8, oracle_layers=2, why_layers=(
        "about 5.0 GB of bf16 weights a layer (140.6 B parameters over 56 layers): the 80-GB card "
        "holds 8 layers beside the 8 x 2048-token prefill's MoE activations; the float32 oracle "
        "doubles the bytes, so it runs 2 layers")),
)
ORACLE_STEPS = 16
# kernel vs plain on the card, as (atol, rtol): both compute the scores, the
# softmax and the sums in float32 from the same inputs in another order.
# float32: the reference's kernel-test tolerance (tests/test_kernels.py::_tol);
# measured on the H100 up to 1.6e-6. bfloat16: the two float32 results round
# at most one bf16 ulp apart, and one ulp is at most 2^-7 |w|; 1e-3 absolute
# covers the float32 differences near zero. The bf16 attention kernel feeds P
# to the tensor cores as a hi/lo pair of bf16 (P_hi = bf16(P), P_lo =
# bf16(P - P_hi)), which keeps P to about 2^-16; a single bf16 P would break
# this limit in the early, peaky rows. Measured on the H100: 0.0039
# (attention, |w| < 1) and 0.031 (scan and wkv6, |w| in [4, 8)), each one ulp.
LLM_TOL = {torch.bfloat16: (1e-3, 2.0 ** -7), torch.float32: (2e-4, 2e-4)}
# the full-width float32 continuation oracle.  Measured on the H100:
# 4.8e-5 with logits up to 4.1, where the two sides differ only in float32
# summation order through 32 layers.  1e-3 keeps 20x of headroom and still
# fails any stage computed in bfloat16 (2^-8 relative: ~1.6e-2 at 4.1).
# The same limit holds for rwkv6-7b, whose layer-normed logits are of the
# same scale: measured 3.5e-4 with logits up to 4.45.
ORACLE_TOL = 1e-3
# the training phase, one run per arch, each at full width with bf16
# parameters, fp32 AdamW moments, batches of 8 x 2048 tokens and
# remat_policy "none" (every block runs forward twice a step: the forward and
# the backward's recompute)
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 1e-3, 10, 100    # the train CLI's schedule


@dataclasses.dataclass(frozen=True)
class TrainRun:
    arch: str
    kernels: tuple             # launched twice per layer and step, and nothing else
    steps: int                 # run A's steps
    saves: tuple = ()          # journaled steps: the first committed, the second crashed
    journal: tuple = ()        # (SSD lanes, slices, buffer bytes); () runs no journal
    layers: int = 0            # a depth cut (0: full depth), and why
    why_layers: str = ""
    # the gradient oracle's end-to-end side is gated too (see run_grad_oracle)
    oracle_end_to_end: bool = True
    batch: int = TRAIN_BATCH   # rows a step
    seq: int = TRAIN_SEQ       # tokens a row (an encoder-decoder's decoder tokens)


TRAIN_RUNS = (
    # tinyllama-1.1b (arXiv:2401.02385 / the Hugging Face config), full depth:
    # run A trains steps 0-5, journals steps 1 (committed) and 3 (crashed
    # right after its save), the restore picks one of them and a fresh model
    # resumes to step 5.  22 slices and 64-MiB buffers: the largest record, a
    # slice of w_gate's fp32 moment (22 x 2048 x 5632 x 4 B / 22), is 46.1 MB,
    # and a record larger than a buffer raises.
    TrainRun("tinyllama-1.1b", ("flash_attention",), 6, (1, 3), (4, 22, 64 << 20)),
    # hymba-1.5b (arXiv:2411.13676 / the Hugging Face config), the same run
    # at 17 of its 32 layers (full attention at layers 0 and 16: groups of
    # 1/15/1 layers; at full depth 1/15/1/14/1).  A leaf is sliced along its
    # stacked dim only when that dim holds at least n_slices: at 14 slices
    # the largest record is two layers of an MLP weight's fp32 moment
    # (2 x 1600 x 5504 x 4 B = 70.5 MB), under 96-MiB buffers.
    # Its full-depth float32 gradients move far more than tinyllama's under
    # one float32 rounding of a forward output (the oracle's side (c); PERF.md,
    # PR 24): end to end, the kernels' own rounding reaches 1e-4 of a leaf's
    # max |g| (tools/train_oracle_split.py), so only the oracle at the
    # kernels' forward values is gated; the end-to-end reading is printed
    # beside that floor.
    TrainRun("hymba-1.5b", ("flash_attention", "ssm_scan_chunked"), 6, (1, 3),
             (4, 14, 96 << 20), oracle_end_to_end=False, layers=17, why_layers=(
                 "the smoke's 1,200-s limit, the build included: with every path at full depth "
                 "it took 921-1,148 s on an H100, hymba's training 191-227 s of it")),
    # rwkv6-7b (arXiv:2404.05892 / the Hugging Face config) at 8 of its 32
    # layers: three steps, no journal (its tree goes through the journal in
    # the CPU tests, and the journal code is hymba's)
    TrainRun("rwkv6-7b", ("rwkv6_chunked",), 3, layers=8, why_layers=(
        "the optimizer holds the old and the new parameters and moments (22 B a parameter "
        "with bf16 gradients) and one stacked leaf's float32 temporaries: 7.53 B parameters "
        "need ~166 GB at full depth, and 10 layers (2.72 B) already ~79 GB of the 80-GB card")),
    # whisper-medium (arXiv:2212.04356 / the Hugging Face config), full depth:
    # 24 encoder and 24 decoder layers, 8 rows of 448 decoder tokens (its
    # context) over 1,500 frames, three steps, no journal: the encoder's
    # bidirectional flash calls and the decoder's causal and cross ones
    # (S = 448 over T = 1,500) forward and through _Flash's backward
    TrainRun("whisper-medium", ("flash_attention",), 3, seq=WHISPER_CONTEXT),
    # mixtral-8x22b (arXiv:2401.04088 / the Hugging Face config) at 1 of its
    # 56 layers, 8 x 2048 tokens, three steps, no journal
    TrainRun("mixtral-8x22b", ("flash_attention",), 3, layers=1, why_layers=(
        "the optimizer holds the old and the new parameters and moments (22 B a parameter "
        "with bf16 gradients): one layer and the embeddings are 2.9 B parameters, ~64 GB; "
        "a second layer adds 2.5 B (~55 GB)")),
)
# the full-width float32 gradient oracle: _Flash (the kernel's forward and
# the torch-op backward) against autograd through the plain attention, each
# leaf's gradient within this share of its largest magnitude
TRAIN_ORACLE_TOL = 1e-4
# the parallel layer on one card (parallel_path): tinyllama-1.1b at full
# width, bf16 weights, fp32 moments, TRAIN_BATCH x TRAIN_SEQ tokens a step
# and the train phase's schedule, with compress_grads; compressed_psum at
# its embed gradient's shape; gpipe_apply with the reference test's stage
# function at its width
PARALLEL_ARCH = "tinyllama-1.1b"
PARALLEL_STEPS = 3
PSUM_SHAPE = (32000, 2048)
PIPE_D, PIPE_M, PIPE_MB = 2048, 6, 8
# the dry run's phase (dryrun_path): its subprocess cells and its time limit
DRYRUN_CELLS = (("train_4k", "both"), ("decode_32k", "single"))
DRYRUN_LIMIT_S = 120
# the executing thread's stages of one BatchOCC call (trace/span.py)
BATCH_STAGES = (tspan.ST_VALIDATE, tspan.ST_SEQUENCE, tspan.ST_ENCODE,
                tspan.ST_PUBLISH, tspan.ST_WRITEBACK)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _device_ms(fn):
    """Run ``fn`` under the CUDA profiler; returns ``(fn(), {activity:
    (device ms, count)})`` for every kernel and copy the card ran, or an
    empty dict when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            rows[e.key] = (us / 1e3, e.count)
    return out, rows


def _per_call_device_ms(fn, calls: int = 20):
    _, rows = _device_ms(lambda: [fn() for _ in range(calls)])
    return sum(ms for ms, _ in rows.values()) / calls if rows else None


def _flash_kernels(rows, calls: int = 1):
    """The flash kernels among ``_device_ms`` rows, by template name (e.g.
    ``flash_fwd_wgmma_kernel<160>``), with their launches per call."""
    out = {}
    for key, (_, n) in rows.items():
        m = re.search(r"flash_fwd_\w*kernel<\d+>", key)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0) + n / calls
    return out


def _profiled_calls(fn, calls: int, per_call: int = 1):
    """``_device_ms`` rows of ``calls`` calls of ``fn``, with at least
    ``per_call`` device operations per call."""
    for _ in range(3):    # the profiler may drop a window's events: take it again
        _, rows = _device_ms(lambda: [fn() for _ in range(calls)])
        if sum(n for _, n in rows.values()) >= per_call * calls:
            break
    return rows


def _launch_readings(fn, calls: int = 20, host_calls: int = 200):
    """A wrapper's launch path: ``ms`` (CUDA events around one call, median),
    ``device_ms`` and ``device_ops_per_call`` (every kernel, copy and fill
    the card ran per call, CUDA profiler), and ``host_us_per_call`` (host
    clock over ``host_calls`` calls with no synchronisation between them:
    the enqueue cost)."""
    ms = _median_ms(fn)
    rows = _profiled_calls(fn, calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(host_calls):
        fn()
    host_us = (time.perf_counter() - t0) / host_calls * 1e6
    torch.cuda.synchronize()
    return dict(ms=ms,
                device_ms=sum(ms for ms, _ in rows.values()) / calls if rows else None,
                device_ops_per_call=sum(n for _, n in rows.values()) / calls if rows else None,
                host_us_per_call=host_us)


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _bound(nbytes: int, ops: int, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- phase 2: each kernel against its plain version ---------------------------

def _validate_inputs(rng, dev, write_only=False):
    """The fused round of a hybrid batch: 65,536 txns x 16 lanes (10 reads
    plus 1 write each, the rest masked), rows over 1,000,000 tuples; or,
    ``write_only``, that of a write-only batch: 65,536 txns of one write
    lane each.  Returns the wrapper's arguments, the bound's bytes (lanes,
    a_len and outputs), this design's floor bytes (plus 8 B per written
    row), the operations and the shape."""
    n_txn, k, cap = 1 << 16, (1 if write_only else 16), 1 << 20
    lanes = n_txn * k
    lane = np.tile(np.arange(k), n_txn)
    acc = np.empty((6, lanes), np.int32)
    acc[0] = rng.integers(0, 1_000_000, lanes)
    acc[1] = np.repeat(np.arange(n_txn), k)
    acc[2] = lane == (0 if write_only else 10)
    ssn = rng.integers(0, 1 << 20, lanes).astype(np.int32)
    acc[4] = ssn
    obs = np.full(lanes, -1, np.int32)
    seen = rng.random(lanes) < 0.05
    obs[seen] = ssn[seen] + (rng.random(seen.sum()) < 0.3)   # some stale
    acc[3] = obs
    acc[5] = rng.random(lanes) < 0.01
    a_len = np.full(n_txn, k if write_only else 11, np.int32)
    if not write_only:
        a_len[-1000:] = 0                                     # padded txns
    args = (torch.from_numpy(acc).to(dev), torch.from_numpy(a_len).to(dev), n_txn, k, cap)
    nbytes = acc.nbytes + a_len.nbytes + n_txn * (1 + 4)
    written = acc[0][(acc[2] != 0) & (lane < np.repeat(a_len, k))]
    floor = nbytes + 8 * np.unique(written).size
    ops = 8 * lanes
    return args, nbytes, floor, ops, f"acc (6, {lanes}) int32, n_txn={n_txn}, k={k}, cap={cap}"


def _validate_case(rng, dev, write_only=False):
    """``validate_sequence`` against its plain version (exact, one device
    operation per call) and its readings."""
    args, nbytes, floor, ops, shape = _validate_inputs(rng, dev, write_only)
    got = validate_sequence(*args)
    torch.cuda.synchronize()
    want = validate_sequence_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), f"validate_sequence != plain: {shape}"
    assert bool(got[0].any()) and not bool(got[0].all()), f"degenerate survive mask: {shape}"
    readings = _launch_readings(lambda: validate_sequence(*args))
    assert readings["device_ops_per_call"] == 1, (shape, readings)
    return dict(
        shape=shape, max_abs_err=_max_abs_err(got, want), **readings,
        plain_ms=_median_ms(lambda: validate_sequence_plain(*args)),
        bound=_bound(nbytes, ops), floor_ms=_bound(floor, ops)[0], library_ms=None,
    )


def _validate_stale_scratch(rng, dev):
    """Writers on rows 0..63, then on the same stream rounds that read those
    rows with no writer, at a smaller and then a larger cap: each equal to
    the plain version, so no call read an earlier call's first writers."""
    n_txn, k = 1 << 12, 4
    lanes = n_txn * k
    a_len = torch.full((n_txn,), k, dtype=torch.int32, device=dev)
    for cap, writes in ((1 << 20, True), (1 << 16, False), (1 << 21, False)):
        acc = np.zeros((6, lanes), np.int32)
        acc[0] = rng.integers(0, 64, lanes)
        acc[1] = (np.arange(lanes) if writes else np.full(lanes, 1 << 30)).astype(np.int32)
        acc[2] = writes
        acc[3] = -1
        acc[4] = rng.integers(0, 1 << 20, lanes)
        args = (torch.from_numpy(acc).to(dev), a_len, n_txn, k, cap)
        got = validate_sequence(*args)
        torch.cuda.synchronize()
        want = validate_sequence_plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), \
            f"validate_sequence at cap={cap} after other calls != plain"
        assert writes or bool(got[0].all()), f"a stale first writer at cap={cap}"


def _scatter_inputs(rng, dev, s=1 << 19, w=1 << 18):
    """The replay apply against a checkpoint image: 2^19 slots (30% from
    the checkpoint), 2^18 lanes with SSN ties, duplicate keys, pad lanes at
    key -1 and at the overflow slot S."""
    img_ssn = np.full(s, -1, np.int32)
    img_pos = np.full(s, NO_POS, np.int32)
    ck = rng.random(s) < 0.3
    img_ssn[ck] = rng.integers(0, 1 << 20, ck.sum())
    img_pos[ck] = -1
    key = rng.integers(0, s, w).astype(np.int32)
    ssn = rng.integers(0, 1 << 20, w).astype(np.int32)
    pos = np.arange(w, dtype=np.int32)
    tie = (rng.random(w) < 0.05) & ck[key]
    ssn[tie] = img_ssn[key[tie]]                  # ties with the checkpoint
    dup = rng.integers(0, w, w // 50)
    key[dup[1:]] = key[dup[:-1]]                  # same key, same SSN, later pos
    ssn[dup[1:]] = ssn[dup[:-1]]
    pad = np.arange(w - w // 32, w)
    key[pad] = np.where(pad % 2, -1, s)
    ssn[pad] = -1
    pos[pad] = NO_POS
    arrs = (img_ssn, img_pos, key, ssn, pos)
    args = tuple(torch.from_numpy(a).to(dev) for a in arrs)
    nbytes = sum(a.nbytes for a in arrs) + 8 * s
    ops = 2 * w + 2 * s
    return args, nbytes, ops, f"S={s} slots, W={w} lanes"


def _seg_inputs(rng, dev, n_slots=1 << 14):
    """The declined round's first-writer / base-SSN reduce: 2^16 items over
    2^14 slots, 5% pad items at key -1."""
    w = 1 << 16
    key = rng.integers(0, n_slots, w).astype(np.int32)
    key[rng.random(w) < 0.05] = -1
    val = rng.integers(0, 2**31 - 1, w).astype(np.int32)
    args = (torch.from_numpy(key).to(dev), torch.from_numpy(val).to(dev), n_slots)
    nbytes = key.nbytes + val.nbytes + 4 * n_slots
    return args, nbytes, w, f"W={w} items, n_slots={n_slots}"


def check_kernels(seed: int):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    results = []

    main = _validate_case(rng, dev)
    write_only = _validate_case(rng, dev, write_only=True)
    _validate_stale_scratch(rng, dev)
    results.append(dict(
        name="validate_sequence", **main,
        source="src/repro_torch/kernels/csrc/validate_sequence.cu",
        replaces="src/repro/kernels/batch_occ.py:83",
        write_only=write_only,
    ))

    args, nbytes, ops, shape = _scatter_inputs(rng, dev)
    got = ssn_scatter_max(*args)
    torch.cuda.synchronize()
    want = ssn_scatter_max_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "ssn_scatter_max != plain"
    assert bool((got[1] == -1).any()), "no checkpoint slot survived its tie"
    # the one PyTorch call that computes the same join, on prepared inputs:
    # an int64 amax over (ssn + 1) << 32 | (INT32_MAX - pos), the image
    # packed into slots 0..S-1 and every pad lane routed to slot S
    img_ssn, img_pos, key, ssn, pos = args
    s_slots = img_ssn.shape[0]

    def _pack(sn, ps):
        return ((sn.long() + 1) << 32) | (2**31 - 1 - ps.long())

    def _unpack(words):
        return ((words[:s_slots] >> 32) - 1).int(), (2**31 - 1 - (words[:s_slots] & 0xFFFFFFFF)).int()

    lib_idx = torch.where((key >= 0) & (key < s_slots), key, s_slots).long()
    lib_lanes = _pack(ssn, pos)
    lib_img = torch.cat([_pack(img_ssn, img_pos), torch.zeros(1, dtype=torch.long, device=dev)])
    lib_out = lib_img.clone().scatter_reduce_(0, lib_idx, lib_lanes, "amax", include_self=True)
    assert all(torch.equal(l, g) for l, g in zip(_unpack(lib_out), got)), \
        "scatter_reduce_ on packed words != ssn_scatter_max"
    # the no-image form, as recovery's fused_replay_scan calls it: the same
    # lanes against an all-empty image that is neither built nor read
    scan = torch.stack([key, ssn, pos])
    got_scan = kops.fused_replay_scan(scan, n_slots=s_slots)
    torch.cuda.synchronize()
    want_scan = ssn_scatter_max_plain(
        torch.full_like(img_ssn, -1), torch.full_like(img_pos, int(NO_POS)), key, ssn, pos)
    assert all(torch.equal(g, w) for g, w in zip(got_scan, want_scan)), "scan form != plain"
    lib_scan = torch.zeros(s_slots + 1, dtype=torch.long, device=dev)
    lib_scan_out = lib_scan.clone().scatter_reduce_(0, lib_idx, lib_lanes, "amax", include_self=True)
    assert all(torch.equal(l, g) for l, g in zip(_unpack(lib_scan_out), got_scan)), \
        "scatter_reduce_ on packed words != the scan form"
    # a smaller, then a larger S on the same stream: each equal to the plain
    # version, so the scratch words came back clean (the larger grows it)
    for s2, w2 in ((1 << 16, 1 << 15), (1 << 20, 1 << 18)):
        args2, *_ = _scatter_inputs(rng, dev, s2, w2)
        got2 = ssn_scatter_max(*args2)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got2, ssn_scatter_max_plain(*args2))), \
            f"ssn_scatter_max at S={s2} after S={s_slots} != plain"
    assert not any(bool(b.any()) for b in scatter_max._scratch.values()), "dirty scratch words"
    lanes_bytes = sum(a.numel() * 4 for a in (key, ssn, pos))
    scan_form = dict(
        shape=f"S={s_slots} slots, W={key.shape[0]} lanes, no image",
        max_abs_err=_max_abs_err(got_scan, want_scan),
        **_launch_readings(lambda: kops.fused_replay_scan(scan, n_slots=s_slots)),
        bound=_bound(lanes_bytes + 8 * s_slots, 2 * key.shape[0] + 2 * s_slots),
        library_ms=_median_ms(lambda: lib_scan.scatter_reduce_(
            0, lib_idx, lib_lanes, "amax", include_self=True)),
    )
    readings = _launch_readings(lambda: ssn_scatter_max(*args))
    # the redesign's point: one launch per call in both forms
    assert readings["device_ops_per_call"] == scan_form["device_ops_per_call"] == 1, \
        (readings, scan_form)
    results.append(dict(
        name="ssn_scatter_max", shape=shape, max_abs_err=_max_abs_err(got, want),
        **readings,
        plain_ms=_median_ms(lambda: ssn_scatter_max_plain(*args)),
        bound=_bound(nbytes, ops),
        library_ms=_median_ms(lambda: lib_out.scatter_reduce_(
            0, lib_idx, lib_lanes, "amax", include_self=True)),
        source="src/repro_torch/kernels/csrc/scatter_max.cu",
        replaces="src/repro/kernels/scatter_max.py:125",
        scan_form=scan_form,
    ))

    def _seg_case(n_slots):
        """Min and max against the plain version and the library call; the
        readings of op="max"."""
        (key, val, n), nbytes, ops, shape = _seg_inputs(rng, dev, n_slots)
        idx = torch.where((key >= 0) & (key < n), key, n).long()
        errs = []
        for op, init in (("min", 2**31 - 1), ("max", -1)):
            got = seg_reduce(key, val, n, op=op)
            torch.cuda.synchronize()
            want = seg_reduce_plain(key, val, n, op)
            assert torch.equal(got, want), f"seg_reduce {op} != plain at n_slots={n}"
            lib = torch.full((n + 1,), init, dtype=torch.int32, device=dev).scatter_reduce_(
                0, idx, val, "a" + op, include_self=True)
            assert torch.equal(lib[:n], got), f"scatter_reduce_ != seg_reduce {op} at n_slots={n}"
            errs.append(_max_abs_err([got], [want]))
        # the one PyTorch call that computes the same reduce, on prepared inputs
        lib_out = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        return dict(
            shape=shape + ", op=max", max_abs_err=max(errs),
            **_launch_readings(lambda: seg_reduce(key, val, n, op="max")),
            plain_ms=_median_ms(lambda: seg_reduce_plain(key, val, n, "max")),
            bound=_bound(nbytes, ops),
            library_ms=_median_ms(
                lambda: lib_out.scatter_reduce_(0, idx, val, "amax", include_self=True)),
        )

    main = _seg_case(1 << 14)
    assert main["device_ops_per_call"] == 1, main
    results.append(dict(
        name="seg_reduce", **main,
        source="src/repro_torch/kernels/csrc/seg_reduce.cu",
        replaces="src/repro/kernels/batch_occ.py:118",
        # more slots than items and than any block's shared memory holds
        large_slots=_seg_case(1 << 19),
    ))
    return results


# --- phase 2: the LLM kernels against their plain versions -------------------

def _close(got, want, dtype):
    """Max abs error, asserted within LLM_TOL (absolute plus relative)."""
    atol, rtol = LLM_TOL[dtype]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    bad = int(((g - w).abs() > atol + rtol * w.abs()).sum())
    assert bad == 0 and torch.isfinite(g).all(), (err, bad)
    return err


# the plain version holds the whole (B, Hq, S, T) float32 score matrix a few
# times over; past this size it runs one batch row and KV head at a time
PLAIN_SCORES_BYTES = 8 << 30


def _flash_plain(q, k, v, **kw):
    """``flash_attention_plain``, cut into (batch row, KV head) pieces when
    the scores would pass PLAIN_SCORES_BYTES: the same function, cut along
    dims it never mixes (mixtral's 8192-token window case)."""
    b, hq, s, _ = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if b * hq * s * t * 4 <= PLAIN_SCORES_BYTES:
        return flash_attention_plain(q, k, v, **kw)
    g = hq // hkv
    rows = [[flash_attention_plain(q[i:i + 1, j * g:(j + 1) * g], k[i:i + 1, j:j + 1],
                                   v[i:i + 1, j:j + 1], **kw) for j in range(hkv)] for i in range(b)]
    if not kw.get("return_lse"):
        return torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)
    return tuple(torch.cat([torch.cat([piece[n] for piece in r], dim=1) for r in rows], dim=0)
                 for n in range(2))


def _flash_train_timings(q, k, v, out, lse):
    """The training shape's backward, timed only: the torch-op backward
    (``_flash_bwd``) against SDPA's (``is_causal``), on the same inputs and
    one seeded output gradient."""
    gen = torch.Generator(device=q.device).manual_seed(1)
    do = torch.randn(out.shape, generator=gen, device=q.device).to(out.dtype)
    qs, ks, vs, dos = (x.transpose(1, 2) for x in (q, k, v, do))   # (B, S, H, D)
    bwd_ms = _median_ms(lambda: attention_mod._flash_bwd(qs, ks, vs, lse, dos, True, None, None),
                        reps=5, warmup=1)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    ref = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
    sdpa_bwd_ms = _median_ms(lambda: torch.autograd.grad(ref, leaves, do, retain_graph=True))
    return dict(bwd_ms=bwd_ms, sdpa_bwd_ms=sdpa_bwd_ms)


def _flash_case(gen, b, s, window, dtype, dev, hq=25, hkv=5, d=64, train=False, t=None,
                causal=True, softcap=None):
    t = s if t is None else t
    # the model's (B, S, H, D) activations, handed over as (B, H, S, D) views
    q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention_fwd(q, k, v, **kw)
    with_lse, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(with_lse, got), "flash_attention: o differs when lse is asked for"
    want, want_lse = _flash_plain(q, k, v, return_lse=True, **kw)
    err = _close(got, want, dtype)
    lse_err = _close(lse, want_lse, torch.float32)
    del want, want_lse
    esz = q.element_size()
    nbytes = esz * (2 * b * hq * s * d + 2 * b * hkv * t * d)
    flops = 4 * d * b * hq * attention_pairs(s, t, window, causal)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    if softcap is not None:
        lib, library = None, "none: SDPA takes no softcap"
    elif not causal:
        lib, library = (lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
                        "SDPA, no mask")
    elif window is None:
        lib, library = (lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                               enable_gqa=True), "SDPA is_causal")
    else:
        pos = torch.arange(s, device=dev)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        lib, library = (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               enable_gqa=True),
                        "SDPA, boolean window mask")
    extra = _flash_train_timings(q, k, v, with_lse, lse) if train else {}
    calls = 5
    rows = _profiled_calls(lambda: flash_attention_fwd(q, k, v, **kw), calls)
    shape = f"B={b} S={s} T={t} Hq={hq} Hkv={hkv} D={d} {'causal' if causal else 'bidirectional'}"
    shape += f" window={window}" + (f" softcap={softcap}" if softcap is not None else "")
    return dict(
        name="flash_attention", max_abs_err=err, tol=LLM_TOL[dtype], lse_max_abs_err=lse_err,
        shape=f"{shape} {str(dtype)[6:]}",
        ms=_median_ms(lambda: flash_attention_fwd(q, k, v, **kw)),
        lse_ms=_median_ms(lambda: flash_attention_fwd(q, k, v, return_lse=True, **kw)),
        lse_device_ms=_per_call_device_ms(
            lambda: flash_attention_fwd(q, k, v, return_lse=True, **kw), 5),
        **extra,
        device_ms=sum(ms for ms, _ in rows.values()) / calls if rows else None,
        device_ops_per_call=sum(n for _, n in rows.values()) / calls if rows else None,
        device_kernels=_flash_kernels(rows, calls),
        plain_ms=_median_ms(lambda: _flash_plain(q, k, v, **kw), reps=5),
        bound=_bound(nbytes, flops, peak), library_ms=None if lib is None else _median_ms(lib),
        library=library,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:100",
    )


def _flash_bwd_case(gen, b, s, window, dev, hq=25, hkv=5, d=64):
    """The backward kernel at a training shape (bf16, causal, the model's
    (B, S, H, D) layout as views) against ``_flash_bwd`` on the same inputs
    and the forward kernel's log-sum-exp, within 3e-2 of each gradient's
    largest value (the card tests' bf16 limit); timed beside ``_flash_bwd``
    and SDPA's backward on the same inputs (timed only).  The bound: 10·D
    flops an unmasked pair (S, dP, dV, dK, dQ) against q, k, v, do and lse
    read once and dq, dk, dv written once."""
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv, hq))
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    _, lse = flash_attention_fwd(qh, kh, vh, window=window, return_lse=True)
    call = lambda: flash_attention_bwd(qh, kh, vh, lse, doh, window=window)    # noqa: E731
    got = call()
    torch.cuda.synchronize()
    want = attention_mod._flash_bwd(q, k, v, lse, do, True, window, None)
    errs = []
    for g, w in zip(got, want):
        g, w = g.transpose(1, 2).float(), w.float()
        assert torch.isfinite(g).all()
        errs.append(float((g - w).abs().max() / w.abs().max()))
    assert max(errs) <= 3e-2, errs
    del got, want
    calls = 5
    rows = _profiled_calls(call, calls, per_call=2)
    phases = {}           # device ms per call of each of the two launches
    for key, (ms, _) in rows.items():
        m = re.search(r"flash_bwd_\w+_kernel", key)
        name = m.group(0) if m else key[:60]
        phases[name] = phases.get(name, 0.0) + ms / calls
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    if window is None:
        ref, library = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True), \
            "SDPA is_causal, backward"
    else:
        pos = torch.arange(s, device=dev)
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
        ref, library = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True), \
            "SDPA, boolean window mask, backward"
    library_ms = _median_ms(lambda: torch.autograd.grad(ref, leaves, doh, retain_graph=True),
                            reps=5, warmup=1)
    del ref, leaves
    nbytes = 2 * (3 * b * hq * s * d + 4 * b * hkv * s * d) + 4 * b * hq * s
    return dict(
        name="flash_attention_bwd", max_abs_err=max(errs), tol=(0.0, 3e-2),
        shape=f"B={b} S=T={s} Hq={hq} Hkv={hkv} D={d} causal window={window} bfloat16",
        ms=_median_ms(call),
        device_ms=sum(phases.values()) if rows else None,
        device_ops_per_call=sum(n for _, n in rows.values()) / calls if rows else None,
        phase_device_ms=phases,
        plain_ms=_median_ms(lambda: attention_mod._flash_bwd(q, k, v, lse, do, True, window, None),
                            reps=5, warmup=1),
        bound=_bound(nbytes, 10 * d * b * hq * attention_pairs(s, s, window), BF16_FLOPS),
        library_ms=library_ms, library=library,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="none: the reference's backward (models/attention.py::_flash_vjp_bwd) is jnp",
    )


def _ssm_case(gen, b, s, dtype, dev):
    h, p, n = 25, 64, 16
    # the model's (B, S, H, P) activations and (B, S, H) steps as views
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype).transpose(1, 2)
    dt = (0.01 + 0.19 * torch.rand(b, s, h, generator=gen, device=dev)).transpose(1, 2)
    decay = (0.7 + 0.299 * torch.rand(b, s, h, generator=gen, device=dev)).transpose(1, 2)
    bm = torch.randn(b, s, n, generator=gen, device=dev).to(dtype)
    cm = torch.randn(b, s, n, generator=gen, device=dev).to(dtype)
    args = (x, dt, decay, bm, cm)
    y, st = ssm_scan_chunked(*args)
    torch.cuda.synchronize()
    yw, stw = ssm_scan_chunked_plain(*args)
    err = max(_close(y, yw, dtype), _close(st, stw, torch.float32))
    esz = x.element_size()
    nbytes = 2 * esz * b * h * s * p + 2 * 4 * b * h * s + 2 * esz * b * s * n + 4 * b * h * p * n
    flops = 5 * b * h * s * p * n         # per step: decay, input, add; y = C.h
    calls = 5
    rows = _profiled_calls(lambda: ssm_scan_chunked(*args), calls)
    phases = {}           # device ms per call of each of the kernel's launches
    for key, (ms, _) in rows.items():
        m = re.search(r"ssm_chunked_\w+?_kernel", key)
        name = m.group(0) if m else key[:60]
        phases[name] = phases.get(name, 0.0) + ms / calls
    return dict(
        name="ssm_scan_chunked", max_abs_err=err, tol=LLM_TOL[dtype],
        shape=f"B={b} H={h} S={s} P={p} N={n} {str(dtype)[6:]}",
        ms=_median_ms(lambda: ssm_scan_chunked(*args)),
        device_ms=sum(phases.values()) if rows else None,
        device_ops_per_call=sum(c for _, c in rows.values()) / calls if rows else None,
        phase_device_ms=phases,
        plain_ms=_median_ms(lambda: ssm_scan_chunked_plain(*args), reps=5),
        bound=_bound(nbytes, flops, FP32_FLOPS), library_ms=None,
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:82",
    )


def _rwkv6_case(gen, b, s, dtype, dev):
    h, kd = 64, 64
    # the model's (B, S, H, K) activations as (B, H, S, K) views; w as the
    # model draws it, exp(-exp(w0 + lora)) in about (0.5, 1)
    r, k, v = ((0.5 * torch.randn(b, s, h, kd, generator=gen, device=dev)).to(dtype).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(-1.5 + torch.rand(b, s, h, kd, generator=gen, device=dev))).transpose(1, 2)
    u = 0.125 * torch.randn(h, kd, generator=gen, device=dev)
    args = (r, k, v, w, u)
    y, st = rwkv6_chunked(*args)
    torch.cuda.synchronize()
    yw, stw = rwkv6_chunked_plain(*args)
    err = max(_close(y, yw, dtype), _close(st, stw, torch.float32))
    esz = r.element_size()
    nbytes = esz * 4 * b * h * s * kd + 4 * b * h * s * kd + 4 * h * kd + 4 * b * h * kd * kd
    calls = 5
    rows = _profiled_calls(lambda: rwkv6_chunked(*args), calls, per_call=3)
    phases = {}           # device ms per call of each of the kernel's launches
    for key, (ms, _) in rows.items():
        m = re.search(r"rwkv6_chunked_\w+?_kernel", key)
        name = m.group(0) if m else key[:60]
        phases[name] = phases.get(name, 0.0) + ms / calls
    ops = sum(c for _, c in rows.values()) / calls if rows else None
    assert ops == 3, f"rwkv6_chunked: {ops} device operations per call, not 3: {phases}"
    return dict(
        name="rwkv6_chunked", max_abs_err=err, tol=LLM_TOL[dtype],
        shape=f"B={b} H={h} S={s} K=V={kd} {str(dtype)[6:]}",
        ms=_median_ms(lambda: rwkv6_chunked(*args)),
        device_ms=sum(phases.values()),
        device_ops_per_call=ops,
        phase_device_ms=phases,
        plain_ms=_median_ms(lambda: rwkv6_chunked_plain(*args), reps=5),
        bound=_bound(nbytes, block_flops(b, h, s, kd, kd), FP32_FLOPS), library_ms=None,
        source="src/repro_torch/kernels/csrc/rwkv6.cu",
        replaces="src/repro/kernels/rwkv6.py:89",
    )


def family_flash_cases(gen, dev):
    """The flash kernel in the encoder-decoder, MoE and VLM families' prefill
    configurations: whisper-medium's encoder (16 heads of 64 over 1,500
    frames, bidirectional: the last 64-key tile holds 28 keys) in both types
    and its cross-attention (384 decoder queries over the 1,500 frames);
    llava-next-mistral-7b's prefill (32 query / 8 KV heads of 128, causal,
    576 patches and 1,472 tokens: 2,048 positions); mixtral-8x22b's prefill
    as its serve path runs it (48 query / 8 KV heads of 128, 2,048 tokens
    under its 4,096-token window) and its window in force (4,096 over 8,192
    tokens); grok-1-314b's softcapped prefill (48 / 8 heads of 128, softcap
    30).  Each bfloat16 case but the 8,192-token one is its serve path's
    shape."""
    frames = get_config("whisper-medium").enc_dec.enc_seq
    window = get_config("mixtral-8x22b").sliding_window
    cases = [dict(_flash_case(gen, SERVE_BATCH, frames, None, dt, dev, hq=16, hkv=16, d=64,
                              causal=False), path="whisper-medium")
             for dt in (torch.bfloat16, torch.float32)]
    cases.append(dict(_flash_case(gen, SERVE_BATCH, WHISPER_PROMPT, None, torch.bfloat16, dev,
                                  hq=16, hkv=16, d=64, t=frames, causal=False),
                      path="whisper-medium"))
    cases.append(dict(_flash_case(gen, SERVE_BATCH, SERVE_PROMPT, None, torch.bfloat16, dev,
                                  hq=32, hkv=8, d=128), path="llava-next-mistral-7b"))
    cases += [dict(_flash_case(gen, b, s, window, torch.bfloat16, dev, hq=48, hkv=8, d=128),
                   path="mixtral-8x22b") for b, s in ((SERVE_BATCH, SERVE_PROMPT), (2, 8192))]
    cases.append(_flash_case(gen, SERVE_BATCH, SERVE_PROMPT, None, torch.bfloat16, dev, hq=48,
                             hkv=8, d=128, softcap=get_config("grok-1-314b").attn_softcap))
    return cases


def check_llm_kernels(seed: int):
    """Every case at its serve path's prefill shapes; returns all cases,
    the main path's case of each kernel first (attention: bfloat16 with the
    window of 29 of hymba's 32 layers; the scan and wkv6: float32, which
    the models feed them)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, s = SERVE_BATCH, SERVE_PROMPT
    cases = [_flash_case(gen, b, s, 1024, torch.bfloat16, dev)]
    cases += [_flash_case(gen, b, s, w, dt, dev)
              for dt, w in ((torch.bfloat16, None), (torch.float32, 1024), (torch.float32, None))]
    cases.append(_flash_case(gen, RAGGED_BATCH, RAGGED_PROMPT, 1024, torch.bfloat16, dev))
    # qwen2-1.5b's heads (12 query / 2 KV of 128): the kernel's D = 128 path
    cases.append(_flash_case(gen, b, s, None, torch.bfloat16, dev, hq=12, hkv=2, d=128))
    # tinyllama-1.1b's training shape (32 query / 4 KV heads of 64, causal),
    # with the backward's timings in bfloat16
    for dt in (torch.bfloat16, torch.float32):
        cases.append(_flash_case(gen, TRAIN_BATCH, TRAIN_SEQ, None, dt, dev, hq=32, hkv=4, d=64,
                                 train=dt == torch.bfloat16))
    # the backward kernel at hymba-1.5b's training shape: its windowed and its full layers
    cases += [_flash_bwd_case(gen, TRAIN_BATCH, TRAIN_SEQ, w, dev) for w in (1024, None)]
    # stablelm-12b's prefill shape (32 query / 8 KV heads of 160, causal):
    # bf16 on the tensor-core kernel, fp32 on the CUDA-core one, one device
    # operation a call
    for dt, kernel in ((torch.bfloat16, "flash_fwd_wgmma_kernel<160>"),
                       (torch.float32, "flash_fwd_kernel<160>")):
        cases.append(_flash_case(gen, b, s, None, dt, dev, hq=32, hkv=8, d=160))
        assert cases[-1]["device_kernels"] == {kernel: 1.0}, cases[-1]["device_kernels"]
    cases += family_flash_cases(gen, dev)
    cases.append(_ssm_case(gen, b, s, torch.float32, dev))
    cases.append(_ssm_case(gen, b, s, torch.bfloat16, dev))
    cases.append(_ssm_case(gen, RAGGED_BATCH, RAGGED_PROMPT, torch.float32, dev))
    cases.append(_rwkv6_case(gen, b, s, torch.float32, dev))
    cases.append(_rwkv6_case(gen, b, s, torch.bfloat16, dev))
    cases.append(_rwkv6_case(gen, RAGGED_BATCH, RAGGED_PROMPT, torch.float32, dev))
    return cases


# --- phases 3-4: the OLTP main path -----------------------------------------

def _counters(reg):
    return {name: reg.counter_value(name) for name in ("occ.fused.rounds", *DECLINES)}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _torn_record() -> bytes:
    t = Txn(tid=777777, write_set=[(ycsb.key_of(0), TORN_VALUE)])
    t.ssn = 1 << 40          # would win every last-writer-wins race if replayed
    return t.encode()[:-7]


class _CheckedRounds:
    """Holds every fused round that a path runs against the plain version.

    While entered, ``kops.fused_validate_sequence`` (which ``BatchOCC``'s
    fused round looks up at each call) keeps each round's inputs and the
    kernel's ``(survive, bases)``.  :meth:`check`, called outside the timed
    region, recomputes them with ``validate_sequence_plain`` on the same
    inputs, which launches no kernel, and asserts equality.  ``rounds``
    counts the rounds checked per access bucket ``k``: above k = 32 the
    kernel runs its warp-per-transaction form.

    With ``seg_reduce=True`` it does the same for ``kops.occ_seg_reduce``
    (the first-writer min and the base-SSN max of every round that declines
    the fused one), against ``seg_reduce_plain``; ``seg_reduces`` counts the
    calls checked per op.  The calls may come from any thread."""

    def __init__(self, what: str, seg_reduce: bool = False):
        self.what, self.pending, self.rounds = what, [], {}
        self.seg_pending, self.seg_reduces = [], ({} if seg_reduce else None)

    def __enter__(self):
        orig = self._orig = kops.fused_validate_sequence
        orig_seg = self._orig_seg = kops.occ_seg_reduce

        @functools.wraps(orig)
        def checked(acc, a_len, *, n_txn, k, cap):
            survive, bases = orig(acc, a_len, n_txn=n_txn, k=k, cap=cap)
            self.pending.append((acc, a_len, n_txn, k, cap, survive, bases))
            return survive, bases

        @functools.wraps(orig_seg)
        def checked_seg(key_id, val, *, n_slots, op="max"):
            out = orig_seg(key_id, val, n_slots=n_slots, op=op)
            self.seg_pending.append((key_id, val, n_slots, op, out))
            return out

        kops.fused_validate_sequence = checked
        if self.seg_reduces is not None:
            kops.occ_seg_reduce = checked_seg
        return self

    def __exit__(self, *exc):
        kops.fused_validate_sequence = self._orig
        kops.occ_seg_reduce = self._orig_seg
        self.pending.clear()
        self.seg_pending.clear()

    def check(self):
        for acc, a_len, n_txn, k, cap, survive, bases in self.pending:
            want_survive, want_bases = validate_sequence_plain(acc, a_len, n_txn, k, cap)
            assert torch.equal(survive, want_survive) and torch.equal(bases, want_bases), \
                f"{self.what}: validate_sequence != plain at n_txn={n_txn}, k={k}, cap={cap}"
            self.rounds[k] = self.rounds.get(k, 0) + 1
        self.pending.clear()
        for key_id, val, n_slots, op, out in self.seg_pending:
            assert out.is_cuda, f"{self.what}: seg_reduce ran off the card"
            assert torch.equal(out, seg_reduce_plain(key_id, val, n_slots, op)), \
                f"{self.what}: seg_reduce {op} != plain at {key_id.numel()} items, {n_slots} slots"
            self.seg_reduces[op] = self.seg_reduces.get(op, 0) + 1
        self.seg_pending.clear()


def _expect_write(expect, kb, v, s):
    """Note a drained write: per key its newest SSN and the values drained at
    that SSN (SILO's transactions of one epoch share one)."""
    cur = expect.get(kb)
    if cur is None or s > cur[0]:
        expect[kb] = (s, {v})
    elif s == cur[0]:
        cur[1].add(v)


def _read_back(data, expect, what: str) -> int:
    """Every expected key recovered at its newest drained SSN or later, at
    that SSN with one of the values drained with it; no torn value.  Returns
    the number of keys checked."""
    assert all(v != TORN_VALUE for v, _ in data.values()), what
    for kb, (s, vals) in expect.items():
        got = data.get(kb)
        assert got is not None and got[1] >= s, (what, kb, s, got)
        if got[1] == s:
            assert got[0] in vals, (what, kb)
    return len(expect)


def _checkpoint(table, ckdir: str, csn_fn, epoch: int) -> int:
    """A fuzzy checkpoint of every row of ``table`` in two files; returns the
    row count."""
    n, keys, vals, ssns = table.n, table._keys_b, table.values, table.ssn
    parts = [((keys[r], vals[r], int(ssns[r])) for r in range(lo, hi))
             for lo, hi in ((0, n // 2), (n // 2, n))]
    CheckpointDaemon(ckdir, n_threads=2, m_files=2, csn_fn=csn_fn).run_once(parts, epoch=epoch)
    return n


def _state_view(st):
    return st.data, st.rsns, st.rsne, st.n_replayed, st.n_skipped_uncommitted


def _recover_modes(recover_fn, view, what: str, smi: str = ""):
    """``recover_fn(mode, **kw)`` in kernel (on the card), vectorized and
    scalar modes: the kernel mode must launch the scatter, and every mode
    must give the kernel mode's ``view`` of the state.  Returns seconds and
    launches per mode, and the kernel mode's state."""
    rec, views = {}, {}
    for mode in ("kernel", "vectorized", "scalar"):
        launches0 = dict(kcuda.LAUNCHES)
        t1 = time.perf_counter()
        st = recover_fn(mode, **({"device": "cuda"} if mode == "kernel" else {}))
        rec[mode] = dict(seconds=time.perf_counter() - t1,
                         launches=_delta(dict(kcuda.LAUNCHES), launches0))
        views[mode] = view(st)
        if mode == "kernel":
            kernel_state = st
        print(f"{what}: recover mode={mode}: {rec[mode]['seconds']:.3f} s, launches "
              f"{rec[mode]['launches']}" + (f" | {smi}" if smi else ""))
    assert rec["kernel"]["launches"]["ssn_scatter_max"] >= 1, (what, rec["kernel"])
    for mode in ("vectorized", "scalar"):
        assert views[mode] == views["kernel"], (what, mode)
    return rec, kernel_state


def run_main_path(workdir, seed=0):
    """Forward path, checkpoint, kill and recovery on the card; returns the
    measurements, with ``out["launches"]``: each kernel's launches over
    exactly that run (the extra recovery under the CUDA profiler comes
    after it and is not counted)."""
    reg = metrics.enable()
    out = {"rows": N_ROWS, "batch": BATCH, "batches": []}
    logdir = os.path.join(workdir, "logs")
    ckdir = os.path.join(workdir, "ckpt")

    t0 = time.perf_counter()
    table = ArrayTable()
    ycsb.load(table, N_ROWS, seed=seed)
    out["load_s"] = time.perf_counter() - t0

    engine = PoplarEngine(EngineConfig(
        n_buffers=4, device_kind="ssd", device_dir=logdir, device_clock="virtual",
        segment_bytes=SEGMENT_BYTES))
    engine.start()
    occ = BatchOCC(table, engine, n_workers=4, mode="kernel", device="cuda")
    # per round, in order: did the fused round take it (or decline it)?
    fused_log = []
    fused_round = occ._fused_round

    def _logged_fused_round(*a):
        res = fused_round(*a)
        fused_log.append(res is not None)
        return res

    occ._fused_round = _logged_fused_round
    wo = ycsb.YCSBWriteOnly(N_ROWS, seed=seed)
    hy = ycsb.YCSBHybrid(N_ROWS, scan_length=10, seed=seed)
    expect = {}   # key -> (ssn, values) of the newest drained write
    rounds = _CheckedRounds("main path")

    def _record(res, writes_of):
        for t, i in zip(res.committed, res.committed_idx):
            assert t.committed, "a drained transaction is not committed"
            for kb, v in writes_of(t, i):
                _expect_write(expect, kb, v, t.ssn)

    def _run(kind, n, drain=True, profiled=False):
        launches0, c0 = dict(kcuda.LAUNCHES), _counters(reg)
        if kind == "write-only":
            rd_row, rd_start, wr_row, wr_start, vals, vlen = wo.next_batch_indexed(n)
            entry = "execute_indexed"

            def execute():
                return occ.execute_indexed(rd_row, rd_start, wr_row, wr_start, vals,
                                           wr_vlen=vlen, max_rounds=3)

            def writes_of(t, i):
                return [(ycsb.key_of(int(wr_row[i])).encode(), vals[i])]
        else:
            specs = hy.next_batch(n)
            entry = "execute_batch"

            def execute():
                return occ.execute_batch(specs, max_rounds=3)

            def writes_of(t, i):
                return [(k.encode(), v) for k, v in t.write_set]
        tspan.TRACER.reset()
        fused_log.clear()
        device = {}
        t1 = time.perf_counter()
        if profiled:
            res, device = _device_ms(execute)
        else:
            res = execute()
        secs = time.perf_counter() - t1
        rounds.check()
        trace = tspan.TRACER.dump()
        stages = {tspan.STAGE_NAMES[st]: float(trace.duration()[trace.stage == st].sum())
                  for st in BATCH_STAGES}
        if drain:
            occ.drain()
            engine.quiesce(range(4))
            _record(res, writes_of)
        row = dict(kind=kind, entry=entry, txns=n, committed=len(res.committed),
                   rounds=res.rounds, fused_per_round=list(fused_log), seconds=secs,
                   txn_per_s=len(res.committed) / secs,
                   launches=_delta(dict(kcuda.LAUNCHES), launches0),
                   counters=_delta(_counters(reg), c0), drained=drain,
                   stages_s=stages, profiled=profiled)
        if device:
            copies = sum(ms for k, (ms, _) in device.items() if "emcpy" in k)
            row["device_ms"] = {"kernels": sum(ms for ms, _ in device.values()) - copies,
                                "copies": copies}
        out["batches"].append(row)
        print(f"batch {len(out['batches']) - 1}: {kind} {entry}, {n} txns, "
              f"{row['committed']} committed in {res.rounds} rounds "
              f"(fused per round {row['fused_per_round']}), {secs:.3f} s, "
              f"{row['txn_per_s']:.0f} txn/s, launches {row['launches']}, "
              f"host stages " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
              + (f", device {row['device_ms']} ms" if device else ""))
        return row

    kinds = ["write-only", "hybrid"] * (N_BATCHES // 2)
    tspan.enable()
    with rounds:
        for b, kind in enumerate(kinds):
            if b == N_BATCHES - 1:
                # a batch under 2048 lanes: the fused round declines every round
                # and the segmented reduces of _first_writer/_base_ssns take
                # seg_reduce
                row = _run("write-only", SMALL_BATCH)
                assert row["fused_per_round"] == [False] * row["rounds"], row
                assert row["counters"]["occ.fused.decline.small_batch"] == row["rounds"], row
                assert row["launches"]["seg_reduce"] >= 2, row
                # the kill: the last batch is published, not drained
                row = _run(kind, BATCH, drain=False)
            else:
                # the first batch of each kind also runs under the CUDA profiler
                row = _run(kind, BATCH, profiled=b < 2)
            # A full-size batch's first round always takes the fused round, and
            # the fused rounds come first.  Only its retry rounds may decline,
            # and only for size: the losers they retry can fall under the 2048
            # lanes below which the reference's rule (BatchOCC.fused_min_lanes)
            # declines, so decline.small_batch is held to rounds - 1, not to 0.
            c, per_round = row["counters"], row["fused_per_round"]
            assert len(per_round) == row["rounds"] and per_round[0], row
            assert per_round == sorted(per_round, reverse=True), row
            assert c["occ.fused.rounds"] == sum(per_round), row
            assert c["occ.fused.decline.dense_padding"] == 0, row
            assert c["occ.fused.decline.i32_range"] == 0, row
            assert c["occ.fused.decline.small_batch"] == row["rounds"] - sum(per_round), row
            if b == 3:
                t1 = time.perf_counter()
                n = _checkpoint(table, ckdir, lambda: engine.commit.csn, epoch=1)
                out["checkpoint_s"] = time.perf_counter() - t1
                print(f"checkpoint after batch {b}: {n} rows in {out['checkpoint_s']:.3f} s")
    out["validate_rounds_checked"] = rounds.rounds

    tspan.disable()
    engine.stop()                 # kill: loggers die, the ring's contents are lost
    for d in engine.devices:
        d.close()
    with open(os.path.join(logdir, "log_0.bin"), "ab") as f:
        f.write(_torn_record())   # a mid-flush kill leaves a partial frame
        f.flush()
        os.fsync(f.fileno())

    devs = make_devices(4, "ssd", logdir, "virtual")
    assert any(len(d.read_segment_entries()) > 1 for d in devs), "no sealed segment"
    rec, st = _recover_modes(lambda mode, **kw: recover(devs, mode=mode, **kw),
                             _state_view, "main path")
    rec["kernel"]["fused"] = st.report.fused
    assert st.report.fused is True, "the fused kernel recovery did not engage"
    rec["drained_writes_checked"] = _read_back(st.data, expect, "main path")
    rec["rsne"] = st.rsne
    rec["replayed"] = st.n_replayed
    rec["skipped"] = st.n_skipped_uncommitted
    out["recovery"] = rec
    print(f"durability: {len(expect)} drained keys read back; rsne {st.rsne}, "
          f"replayed {st.n_replayed}, skipped {st.n_skipped_uncommitted}")

    ckpt = load_latest_checkpoint(ckdir)
    logs = load_columnar_segmented(devs, parallel=True)
    rsne = compute_rsne(logs, floors=device_ssn_floors(devs))
    launches0 = dict(kcuda.LAUNCHES)
    t1 = time.perf_counter()
    with_kernel = replay_columnar(logs, rsne, base=ckpt.data, use_kernel=True,
                                  device="cuda")
    t_kernel = time.perf_counter() - t1
    launches = _delta(dict(kcuda.LAUNCHES), launches0)
    t1 = time.perf_counter()
    plain = replay_columnar(logs, rsne, base=ckpt.data)
    t_vec = time.perf_counter() - t1
    assert with_kernel == plain, "checkpoint replay: kernel apply != vectorized"
    assert launches["ssn_scatter_max"] >= 1, launches
    out["checkpoint_replay"] = dict(kernel_s=t_kernel, vectorized_s=t_vec,
                                    launches=launches, base_keys=len(ckpt.data))
    print(f"replay_columnar against the checkpoint ({len(ckpt.data)} keys): kernel "
          f"{t_kernel:.3f} s, vectorized {t_vec:.3f} s, launches {launches}")
    out["launches"] = dict(kcuda.LAUNCHES)    # the main path ends here

    # once more under the CUDA profiler: the card's share of a recovery
    t1 = time.perf_counter()
    again, dev_rows = _device_ms(lambda: recover(devs, mode="kernel", device="cuda"))
    assert again.data == st.data
    copies = sum(ms for k, (ms, _) in dev_rows.items() if "emcpy" in k)
    rec["kernel_profiled"] = dict(
        seconds=time.perf_counter() - t1, copies_ms=copies,
        kernels_ms=sum(ms for ms, _ in dev_rows.values()) - copies)
    print(f"recover mode=kernel under the profiler: {rec['kernel_profiled']}")
    for d in devs:
        d.close()
    metrics.disable()
    return out


# --- TPC-C: the paper's four engines and the batched executor ----------------

def _tpcc_engine(name: str, logdir: str):
    """One of the paper's engines over four path-backed SSDs (CENTR keeps one:
    its single log is what it is)."""
    cfg = EngineConfig(n_buffers=4, device_kind="ssd", device_dir=logdir,
                       device_clock="virtual")
    if name == "centr":
        return CentrEngine(cfg)
    if name == "silo":
        return SiloEngine(cfg, epoch_interval=50e-3)      # paper §6.1: 50 ms epochs
    if name == "nvmd":
        return NvmDEngine(n_workers=TPCC_WORKERS, n_devices=4, device_kind="ssd",
                          device_dir=logdir, device_clock="virtual")
    return PoplarEngine(cfg)


def _recover_and_read_back(devs, drained, what: str, epoch_ties: bool = False):
    """``recover`` in three modes (:func:`_recover_modes`), then every drained
    write read back.  ``drained`` holds ``(key bytes, value, ssn, has_reads)``
    per write.

    Recovery replays a record with reads only at or below RSNe, the minimum
    over devices of the newest SSN each holds.  Poplar's heartbeats lift an
    idle device to the frontier; the baselines have none, so a transaction
    that SILO or NVM-D committed by its own rule may sit above RSNe and is not
    replayed (ROADMAP Queue C): those writes are counted apart, not checked.

    ``epoch_ties``: SILO's SSN is its epoch, so writes of one key in one
    epoch tie, and the scalar mode's parallel replay keeps whichever device's
    thread came first (ROADMAP Queue C, "SILO's epoch ties"); the scalar
    oracle then replays the devices in order, as the other modes do.
    Returns seconds and launches per mode and the counts."""
    def recover_fn(mode, **kw):
        return recover(devs, mode=mode, parallel=not (epoch_ties and mode == "scalar"), **kw)

    rec, st = _recover_modes(recover_fn, _state_view, what)
    expect, above = {}, 0
    for kb, v, s, has_reads in drained:
        if has_reads and s > st.rsne:
            above += 1
        else:
            _expect_write(expect, kb, v, s)
    rec.update(drained_keys_checked=_read_back(st.data, expect, what),
               drained_writes_above_rsne=above, rsne=st.rsne, records=st.n_replayed,
               skipped=st.n_skipped_uncommitted)
    return rec


def run_tpcc_path(workdir, seed, smi):
    """TPC-C (paper §6.2, 50% Payment + 50% NewOrder) on the four engines of
    the paper's Figure 5, each with four ``OCCWorker`` threads for a fixed
    number of transactions, then quiesced, killed and recovered on the card;
    then Poplar batched through ``BatchOCC(mode="kernel")``, killed with the
    last batch published but not drained, and recovered."""
    out = {"warehouses": TPCC_WAREHOUSES, "engines": {}}
    for name in TPCC_ENGINES:
        logdir = os.path.join(workdir, f"tpcc-{name}")
        table = Table()
        tpcc.load(table, TPCC_WAREHOUSES, seed=11 + seed)
        engine = _tpcc_engine(name, logdir)
        engine.start()
        workers = [OCCWorker(table, engine, i) for i in range(TPCC_WORKERS)]
        done = [[] for _ in workers]

        def loop(i):
            gen = tpcc.TPCC(table, TPCC_WAREHOUSES, seed=seed * 100 + i)
            w = workers[i]
            for _ in range(TPCC_TXNS_PER_WORKER):
                t = gen.next_txn(w)
                if t is not None:
                    done[i].append(t)
                w.drain()

        threads = [threading.Thread(target=loop, args=(i,)) for i in range(TPCC_WORKERS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        secs = time.perf_counter() - t0
        engine.quiesce(range(TPCC_WORKERS))
        engine.stop()                                   # the kill, after the quiesce
        n_devices = len(engine.devices)
        for d in engine.devices:
            d.close()
        txns = [t for lst in done for t in lst]
        assert all(t.committed for t in txns), f"{name}: a quiesced txn is not committed"
        drained = [(k.encode(), v, t.ssn, t.has_reads) for t in txns for k, v in t.write_set]
        devs = make_devices(n_devices, "ssd", logdir, "virtual")
        rec = _recover_and_read_back(devs, drained, f"tpcc {name}",
                                     epoch_ties=name == "silo")
        if name in ("centr", "poplar"):
            assert rec["drained_writes_above_rsne"] == 0, (name, rec)
        for d in devs:
            d.close()
        row = dict(committed=len(txns), attempts=TPCC_WORKERS * TPCC_TXNS_PER_WORKER,
                   aborts=sum(w.aborts for w in workers), seconds=secs,
                   txn_per_s=len(txns) / secs, devices=n_devices, recovery=rec,
                   level=engine.level)
        out["engines"][name] = row
        print(f"tpcc {name}: {len(txns)} committed of {row['attempts']} ({row['aborts']} "
              f"aborts), {TPCC_WORKERS} threads, {n_devices} devices, {row['txn_per_s']:.1f} "
              f"txn/s; recover kernel {rec['kernel']['seconds']:.3f} s, vectorized "
              f"{rec['vectorized']['seconds']:.3f}, scalar {rec['scalar']['seconds']:.3f}; "
              f"{rec['drained_keys_checked']} drained keys read back, "
              f"{rec['drained_writes_above_rsne']} committed writes with reads above RSNe "
              f"{rec['rsne']} | {smi}")

    # Poplar, batched: next_batch against the columnar table, losers redrawn
    reg = metrics.enable()
    logdir = os.path.join(workdir, "tpcc-batched")
    table = ArrayTable()
    tpcc.load(table, TPCC_WAREHOUSES, seed=11 + seed)
    out["rows"] = table.n
    gen = tpcc.TPCC(table, TPCC_WAREHOUSES, seed=seed)
    engine = PoplarEngine(EngineConfig(n_buffers=4, device_kind="ssd", device_dir=logdir,
                                       device_clock="virtual"))
    engine.start()
    occ = BatchOCC(table, engine, n_workers=4, mode="kernel", device="cuda")
    drained, batches = [], []
    with _CheckedRounds("tpcc batched") as rounds:
        for b in range(TPCC_BATCHES):
            specs = gen.next_batch(TPCC_BATCH, lookup=table.get_or_insert)
            c0 = _counters(reg)
            t1 = time.perf_counter()
            res = occ.execute_batch(specs, max_rounds=3)
            secs = time.perf_counter() - t1
            rounds.check()
            last = b == TPCC_BATCHES - 1
            if not last:                     # the last batch is published, not drained
                occ.drain()
                engine.quiesce(range(4))
                for t in res.committed:
                    assert t.committed, "a drained transaction is not committed"
                    drained += [(k.encode(), v, t.ssn, t.has_reads) for k, v in t.write_set]
            row = dict(txns=TPCC_BATCH, committed=len(res.committed),
                       aborted=len(res.aborted), rounds=res.rounds, seconds=secs,
                       txn_per_s=len(res.committed) / secs,
                       counters=_delta(_counters(reg), c0), drained=not last)
            batches.append(row)
            print(f"tpcc batch {b}: {TPCC_BATCH} specs, {row['committed']} committed, "
                  f"{row['aborted']} aborted in {res.rounds} rounds ("
                  f"{row['counters']['occ.fused.rounds']} fused; counters {row['counters']}), "
                  f"{secs:.3f} s, {row['txn_per_s']:.1f} txn/s")
    # NewOrder's 5-15 lines make 47-62 lanes: k = 64, the warp form
    assert any(k > 32 for k in rounds.rounds), rounds.rounds
    print(f"tpcc batched: validate_sequence equal to its plain version on every fused "
          f"round, rounds per k {rounds.rounds}")
    metrics.disable()
    engine.stop()
    for d in engine.devices:
        d.close()
    devs = make_devices(4, "ssd", logdir, "virtual")
    rec = _recover_and_read_back(devs, drained, "tpcc batched")
    assert rec["drained_writes_above_rsne"] == 0, rec
    for d in devs:
        d.close()
    out["batched"] = dict(batches=batches, recovery=rec, rows_after=table.n,
                          validate_rounds_checked=rounds.rounds)
    print(f"tpcc batched: recover kernel {rec['kernel']['seconds']:.3f} s, vectorized "
          f"{rec['vectorized']['seconds']:.3f}, scalar {rec['scalar']['seconds']:.3f}; "
          f"{rec['drained_keys_checked']} drained keys read back | {smi}")
    return out


# --- sharded, truncated and replicated Poplar on one card ---------------------

class _ShardedYCSB:
    """Write-only YCSB with a fixed cross-shard share (the traffic of
    ``benchmarks/fig_shard_scalability.py``): a transaction is one
    ``SHARD_VALUE``-byte write in one shard's key bucket, or, with
    probability ``SHARD_CROSS``, two half-size writes in two distinct
    shards' buckets."""

    def __init__(self, buckets, seed):
        self.buckets = buckets
        self.rng = np.random.default_rng(seed)

    def next_batch(self, n):
        rng, nb, half = self.rng, len(self.buckets), SHARD_VALUE // 2
        blob = rng.bytes(n * SHARD_VALUE)
        cross = rng.random(n) < SHARD_CROSS
        s1 = rng.integers(0, nb, n)
        s2 = (s1 + rng.integers(1, nb, n)) % nb
        sizes = np.asarray([len(b) for b in self.buckets])
        k1, k2 = rng.integers(0, sizes[s1]), rng.integers(0, sizes[s2])
        specs = []
        for i in range(n):
            off, a = i * SHARD_VALUE, self.buckets[s1[i]][k1[i]]
            if cross[i]:
                specs.append(TxnSpec(writes=[
                    (a, blob[off:off + half]),
                    (self.buckets[s2[i]][k2[i]], blob[off + half:off + SHARD_VALUE])]))
            else:
                specs.append(TxnSpec(writes=[(a, blob[off:off + SHARD_VALUE])]))
        return specs


def _sharded_view(st):
    return (st.n_cross_seen, st.n_cross_dropped,
            [(s.data, s.rsns, s.rsne, s.n_replayed, s.n_skipped_uncommitted)
             for s in st.shards])


def _checkpoint_shards(eng, ckpt_dirs, epoch: int) -> float:
    """A fuzzy checkpoint of every row of every shard; returns its seconds."""
    t0 = time.perf_counter()
    for p, sh in enumerate(eng.shards):
        _checkpoint(sh.table, ckpt_dirs[p], sh.engine.commit.advance_csn, epoch)
    return time.perf_counter() - t0


def _retained_bytes(eng):
    return sum(d.disk_bytes() for devs in eng.devices for d in devs)


def run_sharded_path(workdir, seed, smi, t_start):
    """4 shards of one engine on one card: a checkpoint of every shard after
    the load, from which a ``ShardedReplica`` starts and then follows the logs
    live; a fuzzy checkpoint of every shard after batch 2, one
    ``ShardedLogTruncator`` pass after batch 3, and a kill with the last batch
    published but not drained and a torn frame on shard 0's device 0; then
    ``recover_sharded`` in three modes and the replica's ``promote()``."""
    logdir = os.path.join(workdir, "sharded")
    ckpt_dirs = [os.path.join(workdir, f"sharded-ckpt{p}") for p in range(SHARDS)]
    eng = ShardedEngine(ShardedConfig(
        n_shards=SHARDS, n_workers=4, mode="kernel", device="cuda", device_dir=logdir,
        table_capacity=SHARD_ROWS // SHARDS * 5 // 4,
        engine=EngineConfig(n_buffers=SHARD_BUFFERS, device_kind="ssd",
                            device_clock="virtual", segment_bytes=SHARD_SEGMENT_BYTES)))
    t0 = time.perf_counter()
    rng = random.Random(seed)
    buckets = [[] for _ in range(SHARDS)]
    expect = {}                  # every loaded row, then every drained write
    for i in range(SHARD_ROWS):
        k = ycsb.key_of(i)
        buckets[eng.shard_of(k)].append(k)
        v = rng.randbytes(SHARD_VALUE)
        eng.insert(k, v)
        _expect_write(expect, k.encode(), v, 0)
    out = {"shards": SHARDS, "rows": SHARD_ROWS, "rows_per_shard": [len(b) for b in buckets],
           "load_s": time.perf_counter() - t0, "batches": []}
    wl = _ShardedYCSB(buckets, seed)
    eng.start()
    out["base_checkpoint_s"] = _checkpoint_shards(eng, ckpt_dirs, epoch=1)
    registries = [FrontierRegistry() for _ in range(SHARDS)]
    t0 = time.perf_counter()
    rep = ShardedReplica(eng.devices, checkpoint_dirs=ckpt_dirs, mode="kernel",
                         device="cuda", parallel=False)
    out["replica_seed_s"] = time.perf_counter() - t0
    assert sum(len(r.table) for r in rep.replicas) == SHARD_ROWS, "replica not seeded"
    for p, r in enumerate(rep.replicas):
        registries[p].register_replica("replica", r)
    rep.start()
    print(f"sharded: {SHARD_ROWS} rows loaded in {out['load_s']:.3f} s, checkpointed in "
          f"{out['base_checkpoint_s']:.3f} s, replica seeded from it in "
          f"{out['replica_seed_s']:.3f} s")

    def _record(res):
        for t in res.committed:
            assert t.committed, "a drained transaction is not committed"
            for k, v in t.write_set:
                _expect_write(expect, k.encode(), v, t.ssn)
        for x in res.cross:
            assert x.committed, "a drained cross-shard transaction is not committed"
            for part in x.parts:
                tab = eng.shards[part.shard].table
                for r, v in zip(part.wr_rows.tolist(), part.wr_vals):
                    _expect_write(expect, tab.key_of(r).encode(), v, part.ssn)

    with _CheckedRounds("sharded") as rounds:
        for b in range(SHARD_BATCHES):
            specs = wl.next_batch(BATCH)
            t1 = time.perf_counter()
            res = eng.execute_batch(specs, max_rounds=3)
            secs = time.perf_counter() - t1
            rounds.check()
            last = b == SHARD_BATCHES - 1
            if not last:
                eng.quiesce()
                _record(res)
            n_ok = len(res.committed) + len(res.cross)
            row = dict(txns=BATCH, committed=len(res.committed), cross=len(res.cross),
                       aborted=len(res.aborted), seconds=secs, txn_per_s=n_ok / secs,
                       drained=not last)
            out["batches"].append(row)
            print(f"sharded batch {b}: {BATCH} txns, {row['committed']} single-shard + "
                  f"{row['cross']} cross-shard committed, {row['aborted']} aborted, {secs:.3f} s, "
                  f"{row['txn_per_s']:.1f} txn/s")
            if b == 1:
                out["checkpoint_s"] = _checkpoint_shards(eng, ckpt_dirs, epoch=2)
                print(f"sharded checkpoint after batch {b}: {SHARD_ROWS} rows in "
                      f"{out['checkpoint_s']:.3f} s")
            if b == 2:
                # the replica's frontiers cap the safe point: let it catch up first
                t1 = time.perf_counter()
                while rep.lag_bytes() or rep.held():
                    assert time.perf_counter() - t1 < 120, "replica did not catch up"
                    time.sleep(0.01)
                out["replica_catchup_s"] = time.perf_counter() - t1
                before = _retained_bytes(eng)
                t1 = time.perf_counter()
                stats = ShardedLogTruncator(eng, ckpt_dirs, registries=registries).run_once()
                out["truncation"] = dict(
                    seconds=time.perf_counter() - t1, retained_before=before,
                    retained_after=_retained_bytes(eng),
                    segments_dropped=[s.segments_dropped for s in stats],
                    bytes_dropped=[s.bytes_dropped for s in stats],
                    safe_ssn=[s.safe_ssn for s in stats])
                tr = out["truncation"]
                assert sum(tr["bytes_dropped"]) > 0, tr
                assert tr["retained_after"] == before - sum(tr["bytes_dropped"]), tr
                print(f"sharded truncation after batch {b}: replica caught up in "
                      f"{out['replica_catchup_s']:.3f} s; retained {before} -> "
                      f"{tr['retained_after']} bytes, segments dropped {tr['segments_dropped']}, "
                      f"safe SSNs {tr['safe_ssn']}")
    out["validate_rounds_checked"] = rounds.rounds
    elapsed = time.perf_counter() - t_start
    print(f"sharded path: {elapsed:.1f} s into the smoke before the kill")
    # the recoveries and both serve paths take under 4 minutes on an H100:
    # half the limit must be left here
    assert elapsed < SMOKE_LIMIT_S / 2, f"{elapsed:.0f} s before the kill: cut SHARD_ROWS"
    eng.stop()                          # the kill: loggers die, rings are lost
    for devs in eng.devices:
        for d in devs:
            d.close()
    with open(os.path.join(logdir, "shard0", "log_0.bin"), "ab") as f:
        f.write(_torn_record())
        f.flush()
        os.fsync(f.fileno())

    devs = [make_devices(SHARD_BUFFERS, "ssd", os.path.join(logdir, f"shard{p}"), "virtual")
            for p in range(SHARDS)]
    rec, st = _recover_modes(
        lambda mode, **kw: recover_sharded(devs, checkpoint_dirs=ckpt_dirs, mode=mode, **kw),
        _sharded_view, "sharded", smi)
    assert rec["kernel"]["launches"]["ssn_scatter_max"] >= SHARDS, rec["kernel"]
    data = st.data
    # the traffic writes loaded keys only: recovery holds every loaded row
    assert len(data) == SHARD_ROWS, (len(data), SHARD_ROWS)
    assert all(s.rsns > 0 for s in st.shards), "a shard recovered without its checkpoint"
    rec.update(drained_keys_checked=_read_back(data, expect, "sharded"),
               n_cross_seen=st.n_cross_seen,
               n_cross_dropped=st.n_cross_dropped,
               replayed=[s.n_replayed for s in st.shards],
               skipped=[s.n_skipped_uncommitted for s in st.shards])
    print(f"sharded durability: {len(expect)} loaded or drained keys read back; n_cross_seen "
          f"{st.n_cross_seen}, n_cross_dropped {st.n_cross_dropped}")

    # the replica, live the whole time, promotes to recovery's per-shard state;
    # a fault in its tailing thread ends the thread and loses what it shipped
    assert rep._thread is not None and rep._thread.is_alive(), \
        "the replica's tailing thread died before promote()"
    t1 = time.perf_counter()
    promoted = rep.promote()
    rec["promote_s"] = time.perf_counter() - t1
    for p, (a, b) in enumerate(zip(promoted.shards, st.shards)):
        assert a.data == b.data and a.rsne == b.rsne, f"promote() != recover_sharded, shard {p}"
    torch.cuda.synchronize()
    assert not any(bool(w.any()) for w in scatter_max._scratch.values()), \
        "dirty scatter scratch after the replica's threads"
    rec["replica"] = dict(rebases=[r.n_rebases for r in rep.replicas],
                          applied=[r.applier.n_applied for r in rep.replicas],
                          rounds=[r.applier.n_rounds for r in rep.replicas])
    print(f"sharded replica: promote {rec['promote_s']:.3f} s equals recover_sharded(kernel) "
          f"on every shard; rebases {rec['replica']['rebases']}, applied "
          f"{rec['replica']['applied']}; scatter scratch all zero")
    for ds in devs:
        for d in ds:
            d.close()
    out["recovery"] = rec
    return out


# --- phase 4c: the OLTP serving tier -----------------------------------------

def _serve_engine_cfg(path: str, n_buffers: int, **kw) -> EngineConfig:
    return EngineConfig(n_buffers=n_buffers, device_kind="ssd", device_dir=path, **kw)


def _close_all(devs):
    for ds in devs:
        for d in ds:
            d.close()


def _terminal_ok(sched, tickets, what: str):
    """No executor fault, no retry and no ABORTED ticket.  Every run of this
    phase sends blind writes, and a cut is conflict-free over its keys, so
    every transaction wins its first round: an abort or a retry can only
    come from a fault."""
    st = sched.stats()
    assert st["exec_errors"] == 0, f"{what}: {st['exec_errors']} executor faults"
    assert st["retries"] == 0 and st["aborted"] == 0, \
        f"{what}: {st['retries']} retries and {st['aborted']} aborts of blind writes"
    assert not any(t.status == ABORTED for t in tickets), f"{what}: a ticket ABORTED"
    return st


def _host() -> dict:
    """The host that ran the phase (host-clock numbers depend on it)."""
    cpu = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")), cpu)
    except OSError:
        pass
    return dict(name=platform.node(), cpu=cpu, cores=len(os.sched_getaffinity(0)))


def _serve_p1(workdir, seed):
    """Group-commit transparency (P1) on the card: conflict-free writes
    arriving ``SERVE_P1_STEP`` per step, cut at ``SERVE_P1_CUT``, equal one
    direct ``execute_batch`` of the same specs on a second stack."""
    rng = np.random.default_rng(seed)
    n = SERVE_P1_TXNS
    blob = rng.bytes(n * SHARD_VALUE)
    specs = [TxnSpec(writes=[(ycsb.key_of(i), blob[i * SHARD_VALUE:(i + 1) * SHARD_VALUE])])
             for i in range(n)]

    def stack(tag):
        cfg = _serve_engine_cfg(os.path.join(workdir, tag), 1, device_clock="virtual",
                                flush_interval=60.0)
        return SingleBackend.make("kernel", n_workers=2, cfg=cfg, table_capacity=2 * n,
                                  device="cuda")

    be_s, be_d = stack("p1-serve"), stack("p1-direct")
    # two steps of arrivals fill one cut: its head waits out a budget of 2
    sched = GroupCommitScheduler(be_s, ServeConfig(
        max_batch=SERVE_P1_CUT, latency_budget_steps=SERVE_P1_CUT // SERVE_P1_STEP,
        queue_capacity=10**6))
    with _CheckedRounds("serve tier P1", seg_reduce=True) as rounds:
        t0 = time.perf_counter()
        tickets = run_stepped_schedule(sched, [(i // SERVE_P1_STEP, sp) for i, sp in enumerate(specs)])
        serve_s = time.perf_counter() - t0
        rounds.check()
        t0 = time.perf_counter()
        res = be_d.occ.execute_batch(specs, max_rounds=1)
        direct_s = time.perf_counter() - t0
        rounds.check()
    st = _terminal_ok(sched, tickets, "serve tier P1")
    assert all(t.status == ACKED for t in tickets), "P1: an admitted write did not ack"
    assert [t.ack_seq for t in tickets] == list(range(n)), "P1: acks out of admission order"
    assert st["cuts"] == n // SERVE_P1_CUT and st["mean_cut"] == SERVE_P1_CUT, st
    assert not res.aborted and list(res.committed_idx) == list(range(n))
    for _ in range(200):
        be_d.tick()
        be_d.drain()
        if all(t.committed for t in res.committed):
            break
    assert all(t.committed for t in res.committed), "P1: the direct batch did not settle"
    assert [t.ssn for t in tickets] == [t.ssn for t in res.committed], "P1: SSNs differ"
    assert be_s.table.to_dict() == be_d.table.to_dict(), "P1: final states differ"
    _close_all([be_s.engine.devices, be_d.engine.devices])
    logs = [[d.read_all() for d in be.engine.devices] for be in (be_s, be_d)]
    assert logs[0] == logs[1], "P1: device logs differ"
    assert sum(rounds.rounds.values()) == st["cuts"] + 1, rounds.rounds
    return dict(txns=n, cut=SERVE_P1_CUT, cuts=st["cuts"], serve_s=serve_s, direct_s=direct_s,
                log_bytes=sum(len(b) for b in logs[0]), validate_rounds_checked=rounds.rounds,
                seg_reduces_checked=rounds.seg_reduces)


def _serve_stack(name, workdir, seed):
    """``benchmarks/fig_serve.py``'s two stacks over the YCSB table."""
    path = os.path.join(workdir, name)
    if name == "1shard":
        be = SingleBackend.make(
            "kernel", n_workers=2, device="cuda", table_capacity=N_ROWS + 1,
            cfg=_serve_engine_cfg(path, 2, device_clock="real", flush_interval=1e-3,
                                  logger_poll=1e-4))
        devs = [be.engine.devices]
    else:
        be = ShardedBackend.make(n_shards=SHARDS, n_buffers=1, n_workers=2, device_kind="ssd",
                                 device_dir=path, device="cuda",
                                 table_capacity=N_ROWS // SHARDS * 5 // 4)
        devs = be.eng.devices
    t0 = time.perf_counter()
    ycsb.load(be.table, N_ROWS, seed=seed)
    return be, devs, path, time.perf_counter() - t0


class _StallProbe:
    """The host's stalls during an open-loop point: the seconds of every log
    device write (its ``fsync`` and emulated device time included) and of
    every garbage-collector pass."""

    def __init__(self, devs):
        self.devs = [d for ds in devs for d in ds]
        self.writes, self.gcs, self._gc_t0 = [], [], 0.0

    def __enter__(self):
        for d in self.devs:
            def timed(data, _write=d.write):
                t0 = time.perf_counter()
                _write(data)
                self.writes.append(time.perf_counter() - t0)
            d.write = timed
        gc.callbacks.append(self._gc)
        return self

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        else:
            self.gcs.append((info["generation"], time.perf_counter() - self._gc_t0))

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        for d in self.devs:
            del d.write                      # back to the class's method

    def summary(self) -> dict:
        w = np.sort(np.asarray(self.writes)) * 1e3
        g = [ms * 1e3 for _, ms in self.gcs]
        return dict(device_writes=len(w), write_p50_ms=float(np.median(w)) if len(w) else 0.0,
                    write_max_ms=float(w[-1]) if len(w) else 0.0,
                    writes_over_50ms=int((w > 50).sum()), gc_passes=len(g),
                    gc_gen2_passes=sum(gen == 2 for gen, _ in self.gcs),
                    gc_max_ms=max(g, default=0.0))


def _open_loop_point(be, devs, rate, seed, smi, what, health=False, profiled=False):
    """One offered load through the threaded scheduler: Poisson arrivals,
    latency from the scheduled arrival (``OpenLoopDriver``); the serve.*
    counters must equal ``stats()``, and every ``seg_reduce`` of the point
    equals its plain version (checked after the point).  With ``profiled``
    the driver runs under the CUDA profiler (device activity only) for the
    card's busy share; its host-clock numbers then carry the profiler's
    cost.  ``devs``: the stack's log devices, whose writes ``_StallProbe``
    times.  Returns the point's row and its ACKED tickets."""
    n = min(SERVE_MAX_TXNS, int(rate * SERVE_DURATION_S))
    specs = ycsb.YCSBWriteOnly(N_ROWS, seed=seed + int(rate)).next_specs(n)
    metrics.enable()
    sched = GroupCommitScheduler(be, ServeConfig(**SERVE_CFG))
    tickets, submit = [], sched.submit

    def _submit(*a, **kw):               # keep the driver's tickets for the kill's oracle
        tickets.append(submit(*a, **kw))
        return tickets[-1]

    sched.submit = _submit
    depths, stop = [], threading.Event()

    def _sampler():
        while not stop.is_set():
            depths.append(be.queue_depths())
            time.sleep(5e-3)

    sampler = threading.Thread(target=_sampler, daemon=True, name="serve-depths")
    hm = HealthMonitor([SaturationMonitor(sched)]) if health else None
    launches0 = dict(kcuda.LAUNCHES)
    dev_rows = {}
    with _CheckedRounds(what, seg_reduce=True) as checked, _StallProbe(devs) as stalls:
        sched.start()
        sampler.start()
        if hm is not None:
            hm.start(poll_interval=0.05)
        t0 = time.perf_counter()
        try:
            driver = OpenLoopDriver(sched, specs, rate_per_s=rate, seed=seed + int(rate) + 1)
            if profiled:
                rep, dev_rows = _device_ms(lambda: driver.run(settle_timeout_s=SERVE_SETTLE_S))
            else:
                rep = driver.run(settle_timeout_s=SERVE_SETTLE_S)
        finally:
            wall = time.perf_counter() - t0
            if hm is not None:
                hm.stop()
            stop.set()
            sampler.join(timeout=10)
            sched.stop(quiesce=True)
        checked.check()
    tickets_st = _terminal_ok(sched, tickets, what)
    snap = metrics.disable()
    c = snap["counters"]
    for name, key in SERVE_COUNTERS:
        assert c.get(name, 0) == tickets_st[key], (what, name, c.get(name, 0), tickets_st[key])
    assert c.get("serve.cut_txns", 0) == sched.n_cut_txns, what
    assert snap["sketches"]["serve.ack_latency"]["count"] == tickets_st["acked"], what
    assert rep.acked + rep.rejected + rep.aborted == rep.submitted == n, (what, rep)
    assert rep.aborted == 0, (what, rep)
    per_shard = [max(d[i] for d in depths) for i in range(len(depths[0]))] if depths else []
    row = dict(offered_per_s=rate, profiled=profiled, submitted=rep.submitted, acked=rep.acked,
               rejected=rep.rejected, aborted=rep.aborted, retries=tickets_st["retries"],
               goodput_per_s=rep.goodput_per_s,
               p50_ms=rep.pct_ms(50), p99_ms=rep.pct_ms(99), p999_ms=rep.pct_ms(99.9),
               duration_s=rep.duration_s, mean_cut=tickets_st["mean_cut"],
               cuts=tickets_st["cuts"], sched_queue_max=tickets_st["max_queue_depth"],
               qdepth_per_shard_max=per_shard,
               declines={k: c.get(k, 0) for k in DECLINES}, fused_rounds=c.get("occ.fused.rounds", 0),
               seg_reduces_checked=checked.seg_reduces, stalls=stalls.summary(),
               launches=_delta(dict(kcuda.LAUNCHES), launches0), wall_s=wall, smi=smi)
    if profiled:
        assert dev_rows, f"{what}: the profiler saw no device activity"
        busy = sum(ms for ms, _ in dev_rows.values())
        row["device_ms"] = busy
        row["device_busy_share"] = busy / (wall * 1e3)
    if hm is not None:
        row["health_events"] = [e.to_dict() for e in hm.history]
    print(f"{what} {rate} txn/s offered{' (profiled)' if profiled else ''}: goodput "
          f"{row['goodput_per_s']:.1f}, p50/p99/p999 "
          f"{row['p50_ms']:.3f} / {row['p99_ms']:.3f} / {row['p999_ms']:.3f} ms, submitted "
          f"{rep.submitted}, acked {rep.acked}, rejected {rep.rejected}, aborted {rep.aborted}, "
          f"retries 0, mean cut {row['mean_cut']:.2f}, queue max {row['sched_queue_max']}, "
          f"per-shard depth max {per_shard}, declines {row['declines']}, launches "
          f"{row['launches']}, seg_reduce == plain on {checked.seg_reduces}, stalls "
          f"{row['stalls']}"
          + (f", device busy {row['device_busy_share']:.4%} ({row['device_ms']:.2f} ms)"
             if profiled else "") + f" | {smi}")
    if hm is not None:
        print(f"{what} health events at {rate} txn/s: {len(hm.history)}: "
              + "; ".join(f"{e.severity} {e.kind}: {e.message}" for e in list(hm.history)[:5]))
    return row, [t for t in tickets if t.status == ACKED]


def _kill_run(be, devs, path, name, seed, acked, smi):
    """Open loop at ``SERVE_KILL_RATE`` cut ``SERVE_KILL_AT_S`` in: a flight
    dump, ``stop(quiesce=False)`` (the kill), a torn frame on shard 0's
    device 0; three recovery modes equal, every ACKED write read back, and
    ``explain_recovery`` names every ACKED gtid ``replayed``."""
    n = int(SERVE_KILL_RATE * SERVE_DURATION_S)
    specs = ycsb.YCSBWriteOnly(N_ROWS, seed=seed + 7).next_specs(n)
    offsets = np.cumsum(np.random.default_rng(seed + 8).exponential(1.0 / SERVE_KILL_RATE, n))
    metrics.enable()
    sched = GroupCommitScheduler(be, ServeConfig(**SERVE_CFG))
    flight = FlightRecorder(os.path.join(path, "kill"), extra_fn=sched.stats)
    tickets = []
    with _CheckedRounds(f"{name} kill", seg_reduce=True) as checked:
        sched.start()
        t0 = time.perf_counter()
        try:
            for off, spec in zip(offsets, specs):
                if off >= SERVE_KILL_AT_S:
                    break
                wait = t0 + off - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                tickets.append(sched.submit(spec, client_id=len(tickets)))
            flight_path = flight.dump("kill")
        finally:
            sched.stop(quiesce=False)        # the kill: no final flush, no final drain
        checked.check()
    st = _terminal_ok(sched, tickets, f"{name} kill")
    metrics.disable()
    killed = [t for t in tickets if t.status == ACKED]
    assert killed, f"{name}: nothing acked before the kill"
    acked = acked + killed
    _close_all(devs)
    torn_dir = path if name == "1shard" else os.path.join(path, "shard0")
    with open(os.path.join(torn_dir, "log_0.bin"), "ab") as f:
        f.write(_torn_record())
        f.flush()
        os.fsync(f.fileno())
    expect = {}
    for t in acked:
        for k, v in t.spec.writes:
            _expect_write(expect, k.encode(), v, t.ssn)
    split = {}

    def _split(recover_fn, rdevs):
        """``recover_fn`` with each mode's decode and replay seconds and its
        garbage-collector passes kept in ``split``."""
        def fn(mode, **kw):
            with _StallProbe([]) as probe:
                st = recover_fn(rdevs, mode=mode, **kw)
            r = getattr(st, "report", None)
            split[mode] = dict(
                {k: v for k, v in probe.summary().items() if k.startswith("gc")},
                **({} if r is None else dict(fused=r.fused, decode_s=r.decode_s,
                                             replay_s=r.replay_s)))
            return st
        return fn

    if name == "1shard":
        rdevs = make_devices(len(devs[0]), "ssd", path, "virtual")
        recover_fn, view, explain = recover, _state_view, explain_recovery
    else:
        rdevs = [make_devices(1, "ssd", os.path.join(path, f"shard{p}"), "virtual")
                 for p in range(SHARDS)]
        recover_fn, view, explain = recover_sharded, _sharded_view, explain_recovery_sharded
    rec, state = _recover_modes(_split(recover_fn, rdevs), view, f"{name} kill", smi)
    for mode, parts in split.items():
        rec[mode].update(parts)
    # the kernel mode once more, after the others: does its first call pay
    # for something the later modes do not?
    t1 = time.perf_counter()
    again = _split(recover_fn, rdevs)("kernel", device="cuda")
    rec["kernel_again"] = dict(seconds=time.perf_counter() - t1, **split["kernel"])
    assert view(again) == view(state), f"{name}: the kernel mode's second recovery differs"
    t1 = time.perf_counter()
    ex = explain(rdevs, flight=flight_path)
    rec["read_back"] = _read_back(state.data, expect, f"{name} kill")
    agrees, bad = ex.verify_bytes(state)
    explain_s = time.perf_counter() - t1
    assert agrees, f"{name}: verify_bytes disagrees on {bad[:3]}"
    for t in acked:
        v = ex.verdicts[t.txn.tid]
        assert v.kept and v.rule == RULE_REPLAYED, (name, t.txn.tid, v.rule)
    counts = ex.counts()
    assert counts.get(RULE_TORN_TAIL, 0) >= 1, counts
    assert ex.flight["reason"] == "kill", ex.flight
    _close_all(rdevs if name != "1shard" else [rdevs])
    out = dict(submitted=len(tickets), acked_in_kill_run=len(killed),
               unacked_at_kill=len(tickets) - len(killed), acked_read_back=len(acked),
               recovery=rec, verdicts=counts, explain_s=explain_s,
               max_unacked=st["max_unacked"], seg_reduces_checked=checked.seg_reduces)
    print(f"{name} kill at {SERVE_KILL_AT_S} s of {SERVE_KILL_RATE} txn/s: {len(tickets)} "
          f"submitted, {len(killed)} acked before the kill; {len(expect)} acked keys read back "
          f"in every mode; verdicts {counts}, verify_bytes True ({explain_s:.3f} s); recovery "
          f"split {dict((m, rec[m]) for m in ('kernel', 'kernel_again', 'vectorized', 'scalar'))}"
          f" | {smi}")
    return out


def _traced_stepped_run(workdir, tag, seed, shards=SHARDS):
    """A stepped serve run with the tracer armed: ``SERVE_TRACE_TXNS``
    1000-B writes, ``SERVE_TRACE_STEP`` submitted per step, the submissions
    in driver spans.  On 4 shards 10% of the writes are cross-shard; on one
    shard it is the 1shard stack (2 SSDs), each write to a key of its own:
    with a key written twice the DAG is cyclic (ROADMAP Queue C).
    Every ``seg_reduce`` of the run is held against its plain version
    after the trace closes."""
    path = os.path.join(workdir, tag)
    ecfg = _serve_engine_cfg(path, 1 if shards > 1 else 2, device_clock="virtual",
                             flush_interval=60.0)
    if shards > 1:
        be = ShardedBackend.make(n_shards=shards, n_workers=2, device="cuda", device_dir=path,
                                 engine=ecfg, table_capacity=2 * SERVE_TRACE_TXNS)
        devs = be.eng.devices
        buckets = [[] for _ in range(shards)]
        for i in range(2 * SERVE_TRACE_TXNS):
            k = ycsb.key_of(i)
            buckets[be.eng.shard_of(k)].append(k)
        specs = _ShardedYCSB(buckets, seed).next_batch(SERVE_TRACE_TXNS)
    else:
        be = SingleBackend.make("kernel", n_workers=2, device="cuda", cfg=ecfg,
                                table_capacity=2 * SERVE_TRACE_TXNS + 1)
        devs = [be.engine.devices]
        rng = np.random.default_rng(seed)
        blob = rng.bytes(SERVE_TRACE_TXNS * SHARD_VALUE)
        specs = [TxnSpec(writes=[(ycsb.key_of(int(k)),
                                  blob[i * SHARD_VALUE:(i + 1) * SHARD_VALUE])])
                 for i, k in enumerate(rng.permutation(2 * SERVE_TRACE_TXNS)[:SERVE_TRACE_TXNS])]
    sched = GroupCommitScheduler(be, ServeConfig(max_batch=SERVE_CFG["max_batch"],
                                                 queue_capacity=10**6))
    with _CheckedRounds(f"traced {tag}", seg_reduce=True) as checked:
        tspan.enable()
        t0 = time.perf_counter()
        try:
            tickets = []
            for i in range(0, len(specs), SERVE_TRACE_STEP):
                td = time.perf_counter()
                tickets += [sched.submit(sp) for sp in specs[i:i + SERVE_TRACE_STEP]]
                tspan.TRACER.record(tspan.ST_DRIVER, t0=td, t1=time.perf_counter(),
                                    n_txn=SERVE_TRACE_STEP)
                sched.step()
            sched.run_until_drained()
        finally:
            dump = tspan.disable()
        elapsed = time.perf_counter() - t0
        checked.check()
    _terminal_ok(sched, tickets, f"traced {tag}")
    assert all(t.status == ACKED for t in tickets), f"traced {tag}: a write did not ack"
    _close_all(devs)
    n_cross = sum(len(t.txn.parts) > 1 for t in tickets if hasattr(t.txn, "parts"))
    return dump, elapsed, n_cross, checked.seg_reduces


def _fidelity_run():
    """The reference's replay-fidelity gate at its own shape
    (``tests/test_trace_sim.py``): a single-shard executor loop of 8 batches
    of 256 over 512 keys, its driver halves in driver spans, traced end to
    end; ``simulate_dag`` must give the measured wall time within 10%."""
    n_keys, batch, n_batch = 512, 256, 8
    be = SingleBackend.make("kernel", n_workers=2, device="cuda", table_capacity=n_keys + 1,
                            cfg=EngineConfig(n_buffers=2, device_kind="null",
                                             device_clock="virtual", flush_interval=5e-4,
                                             logger_poll=1e-5))
    for i in range(n_keys):
        be.table.insert(ycsb.key_of(i), b"\x00")
    with _CheckedRounds("fidelity loop", seg_reduce=True) as checked:
        be.execute([TxnSpec(writes=[(ycsb.key_of(0), b"w")])])
        be.drain()
        tspan.enable()
        t0 = time.perf_counter()
        for b in range(n_batch):
            td = time.perf_counter()
            specs = [TxnSpec(writes=[(ycsb.key_of((b * batch + i) % n_keys),
                                      bytes([i % 251]) * 64)]) for i in range(batch)]
            tspan.TRACER.record(tspan.ST_DRIVER, t0=td, t1=time.perf_counter(), n_txn=batch)
            be.execute(specs)
            td = time.perf_counter()
            be.drain()
            tspan.TRACER.record(tspan.ST_DRIVER, t0=td, t1=time.perf_counter())
        elapsed = time.perf_counter() - t0
        dump = tspan.disable()
        checked.check()
    return dump, elapsed, checked.seg_reduces


def _serve_trace(workdir, seed, smi):
    """The trace stack on the serving tier: the DAG of a traced stepped
    4-shard run, its critical path, the same bytes from a second identical
    run; the replay of a traced stepped 1shard run beside its measured time
    (reported: a serve trace has no span for the scheduler's own work, which
    the replay cannot see); the reference's replay-fidelity gate at its own
    shape; the autotuner."""
    dump, elapsed, n_cross, seg_a = _traced_stepped_run(workdir, "trace-a", seed)
    dump_b, _, _, seg_b = _traced_stepped_run(workdir, "trace-b", seed)
    dag = ttrace.build_dag(dump)
    assert dag.canonical_bytes() == ttrace.build_dag(dump_b).canonical_bytes(), \
        "two identical stepped runs gave different DAG bytes"
    path, attr = ttrace.critical_path(dag)
    assert abs(sum(attr.values()) - dump.makespan()) <= 1e-9 * dump.makespan(), attr
    # a sharded serve trace joins each ack to every shard's flush lanes by a
    # per-shard SSN, which makes the DAG cyclic: the reference's replay
    # refuses it too (ROADMAP Queue C); the 1shard serve trace of distinct
    # keys replays
    try:
        ttrace.simulate_dag(dag)
        sharded_replay = "ok"
    except ValueError as e:
        assert "cycle" in str(e), e
        sharded_replay = str(e)
    dump1, elapsed1, _, seg_1 = _traced_stepped_run(workdir, "trace-1shard", seed, shards=1)
    dag1 = ttrace.build_dag(dump1)
    _, attr1 = ttrace.critical_path(dag1)
    assert abs(sum(attr1.values()) - dump1.makespan()) <= 1e-9 * dump1.makespan(), attr1
    replay1 = ttrace.simulate_dag(dag1)
    fdump, fwall, seg_f = _fidelity_run()
    replay = ttrace.simulate_dag(ttrace.build_dag(fdump))
    assert abs(replay.makespan - fwall) <= 0.10 * fwall, (replay.makespan, fwall)
    model = ttrace.CostModel.fit(dump)
    prof = ttrace.WorkloadProfile.from_dump(dump)
    tune = ttrace.autotune(model, prof, n_txn=SERVE_TRACE_TXNS, shards=SHARDS,
                           cross_ratio=SHARD_CROSS)
    seg = {}
    for part in (seg_a, seg_b, seg_1, seg_f):
        for op, n in part.items():
            seg[op] = seg.get(op, 0) + n
    out = dict(txns=SERVE_TRACE_TXNS, cross=n_cross, spans=dump.n, dag_nodes=dag.n_nodes,
               makespan_s=dump.makespan(), elapsed_s=elapsed,
               critical_path=dict(nodes=len(path), attribution_s=attr),
               fingerprint=dag.fingerprint(), sharded_replay=sharded_replay,
               serve_1shard_replay=dict(measured_s=elapsed1, makespan_s=dump1.makespan(),
                                        replay_s=replay1.makespan,
                                        rel_err=replay1.makespan / elapsed1 - 1.0,
                                        critical_path_s=attr1),
               fidelity_reference_shape=dict(measured_s=fwall, replay_s=replay.makespan,
                                             rel_err=replay.makespan / fwall - 1.0),
               autotune=dict(batch_size=tune.batch_size, devices=tune.devices,
                             predicted_txn_s=tune.predicted.txn_s),
               seg_reduces_checked=seg)
    print(f"serve trace: 4-shard stepped run of {SERVE_TRACE_TXNS} txns ({n_cross} cross-shard), "
          f"{dump.n} spans, makespan {dump.makespan():.3f} s, critical path "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(attr.items(), key=lambda kv: -kv[1]))
          + f"; identical bytes on a second run; sharded replay: {sharded_replay}; 1shard serve "
          f"run: replay {replay1.makespan:.4f} s vs measured {elapsed1:.4f} s "
          f"({out['serve_1shard_replay']['rel_err']:+.2%}, not gated); fidelity gate at the "
          f"reference test's shape: replay {replay.makespan:.4f} s vs measured {fwall:.4f} s "
          f"({out['fidelity_reference_shape']['rel_err']:+.2%}); autotune picks batch "
          f"{tune.batch_size} x {tune.devices} devices ({tune.predicted.txn_s:.0f} txn/s "
          f"predicted); seg_reduce == plain on {seg} | {smi}")
    return out


def run_serve_tier_path(workdir, seed, smi):
    """The OLTP serving tier on the card: (a) stepped group-commit
    transparency at 4,096-lane cuts, (b) the open loop on
    ``benchmarks/fig_serve.py``'s two stacks over the YCSB table, (c) a kill
    per stack, recovered in three modes and explained, (d) the trace DAG,
    simulator and autotuner over the serve tier.  Each open-loop point runs
    twice: without the profiler (goodput and latencies) and then under it
    (the card's busy share).  ``seg_reduces_checked`` counts the phase's
    ``seg_reduce`` calls held against the plain version, per op."""
    out = {"rows": N_ROWS, "reduced": f"{PAPER_ROWS} -> {N_ROWS} rows", "config": SERVE_CFG,
           "host": _host()}
    t_phase = time.perf_counter()
    out["p1"] = _serve_p1(workdir, seed)
    p1 = out["p1"]
    print(f"serve tier P1: {p1['txns']} writes in {p1['cuts']} cuts of {p1['cut']} equal one "
          f"direct execute_batch (logs of {p1['log_bytes']} bytes byte-identical, SSNs, ack "
          f"order, state); serve {p1['serve_s']:.3f} s, direct {p1['direct_s']:.3f} s; rounds "
          f"checked {p1['validate_rounds_checked']}, seg_reduce == plain on "
          f"{p1['seg_reduces_checked']} | {smi}")
    seg = [p1["seg_reduces_checked"]]
    for name in ("1shard", "4shard"):
        be, devs, path, load_s = _serve_stack(name, workdir, seed)
        print(f"serve tier {name}: {N_ROWS} rows loaded in {load_s:.3f} s")
        stack = {"load_s": load_s, "points": []}
        acked = []
        for rate in SERVE_RATES:
            for profiled in (False, True):
                row, point_acked = _open_loop_point(
                    be, devs, rate, seed, smi, f"serve tier {name}",
                    health=rate == max(SERVE_RATES) and not profiled, profiled=profiled)
                stack["points"].append(row)
                seg.append(row["seg_reduces_checked"])
                acked += point_acked
        stack["kill"] = _kill_run(be, devs, path, name, seed, acked, smi)
        seg.append(stack["kill"]["seg_reduces_checked"])
        out[name] = stack
        del be, devs
    out["trace"] = _serve_trace(workdir, seed, smi)
    seg.append(out["trace"]["seg_reduces_checked"])
    out["seg_reduces_checked"] = {op: sum(part.get(op, 0) for part in seg) for op in ("min", "max")}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# --- phases 5-6: the LLM serve path ------------------------------------------

def _per_forward(cfg, name: str) -> int:
    """Launches of kernel ``name`` in one forward of ``cfg``'s model: the
    flash kernel once per attention call (``attention_calls``), the scan and
    wkv6 kernels once per layer."""
    return attention_calls(cfg) if name == "flash_attention" else cfg.n_layers


def _extras(cfg, rng, b: int, dev) -> dict:
    """``draw_extras`` on the card in bfloat16, as the serve CLI feeds them."""
    return {k: torch.from_numpy(e).to(dev, torch.bfloat16) for k, e in draw_extras(cfg, rng, b).items()}


def _model_inputs(cfg, rng, b: int, s: int, dev) -> dict:
    """``s`` prompt tokens per row, then ``_extras`` from the same generator."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)}
    return {**batch, **_extras(cfg, rng, b, dev)}


def _prefix(cfg) -> int:
    """Positions before the prompt: a vlm's patches."""
    return cfg.vlm.n_patches if cfg.vlm is not None else 0


def _cut(cfg, layers: int):
    """``cfg`` at its first ``layers`` layers, with the full-attention
    layers among them (hymba's layer groups follow ``full_attn_layers``)."""
    return dataclasses.replace(cfg, n_layers=layers, full_attn_layers=tuple(
        i for i in cfg.full_attn_layers if i < layers))


def run_serve_path(run: ServeRun, seed: int, smi: str):
    """``run.arch`` at full width in bfloat16 (at ``run.layers`` when cut): a
    warm-up request, the timed one, and a ragged one through one
    ServeEngine; each prefill must launch each of ``run.kernels``
    ``_per_forward`` times and no other kernel.  Returns the measurements
    and the bfloat16 model."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(run.arch)
    if run.layers:
        cfg = _cut(cfg, run.layers)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    # the config's analytic count (the reference's formula) and the model's own
    out = {"arch": cfg.name, "layers": cfg.n_layers, "n_params": cfg.n_params(),
           "n_params_model": sum(p.numel() for p in model.lm.parameters()),
           "init_s": time.perf_counter() - t0, "cache_len": run.cache_len, "requests": []}
    if run.layers:
        out["reduced"] = [f"depth: {run.layers} of {get_config(run.arch).n_layers} layers: "
                          f"{run.why_layers}"]
    print(f"serve {cfg.name}: {out['n_params_model']:,} parameters in the model, {cfg.n_layers} "
          f"layers ({out['n_params']:,} by the config's analytic count)")
    finite = []
    prefill, decode = model.prefill, model.decode_step

    def _prefill(batch, cache_len):
        logits, caches = prefill(batch, cache_len)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    def _decode(caches, tokens, pos):
        logits, caches = decode(caches, tokens, pos)
        finite.append(torch.isfinite(logits).all())
        return logits, caches

    model.prefill, model.decode_step = _prefill, _decode
    engine = ServeEngine(model, cache_len=run.cache_len)
    rng = np.random.default_rng(seed)
    torch.cuda.reset_peak_memory_stats()
    for tag, b, s, new in (("warm-up", SERVE_BATCH, run.prompt, WARM_NEW),
                           ("timed", SERVE_BATCH, run.prompt, SERVE_NEW),
                           ("ragged", RAGGED_BATCH, run.ragged, SERVE_NEW)):
        batch = _model_inputs(cfg, rng, b, s, dev)
        finite.clear()
        before = dict(kcuda.LAUNCHES)
        res = engine.generate(batch, max_new=new)
        launches = _delta(dict(kcuda.LAUNCHES), before)
        assert len(finite) == new and all(bool(f) for f in finite), tag
        assert res.tokens.shape == (b, new)
        assert ((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()
        for name in LLM_KERNELS + OLTP_KERNELS:    # one prefill
            assert launches[name] == (_per_forward(cfg, name) if name in run.kernels else 0), \
                (tag, launches)
        row = dict(request=tag, batch=b, prompt=s, positions=_prefix(cfg) + s, new=new,
                   prefill_ms=res.prefill_s * 1e3, decode_ms=res.decode_s * 1e3,
                   decode_ms_per_step=res.decode_s * 1e3 / (new - 1),
                   tok_per_s=res.tokens_per_s,
                   prefill_tok_per_s=b * s / res.prefill_s, launches=launches)
        out["requests"].append(row)
        print(f"serve {cfg.name} {tag}: {b} x {s} tokens ({row['positions']} positions"
              + (f", {cfg.enc_dec.enc_seq} frames" if cfg.enc_dec is not None else "")
              + f") + {new} new: prefill {row['prefill_ms']:.1f} ms "
              f"({row['prefill_tok_per_s']:.0f} tok/s), decode {row['decode_ms']:.1f} ms "
              f"({row['decode_ms_per_step']:.2f} ms/step), {row['tok_per_s']:.1f} tok/s, launches "
              f"{launches} | {smi}")
        if tag == "timed":
            out["timed_tokens"], out["timed_batch"] = res.tokens, batch
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t_phase
    del model.prefill, model.decode_step      # the class's methods again, no cycle
    return out, model


def _by_name(trace) -> dict:
    """Device ms and launches by name of a ``bench/tracing.py`` trace's
    first pass (device activity alone)."""
    rows = {}
    for e in trace.device:
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return rows


def profile_serve(model, batch, cache_len: int, steps: int = 8):
    """One more prefill and ``steps`` decode steps, each run twice under
    ``bench/tracing.py``'s passes (not counted): prefill device ms by kernel
    group and its flash launches by kernel name, and per decode step the
    device ms against the host clock (the card's busy share)."""
    kept = {}

    def _prefill():
        kept["logits"], kept["caches"] = model.prefill(batch, cache_len)
        return [{}]

    rows = _by_name(tracing.profile_units(_prefill, (), None))
    flash = _flash_kernels(rows)
    groups = {"flash_attention": 0.0, "ssm_scan_chunked": 0.0, "rwkv6_chunked": 0.0,
              "gemm": 0.0, "copies": 0.0, "other": 0.0}
    for key, (ms, _) in rows.items():
        k = key.lower()
        if "flash_fwd" in k:
            groups["flash_attention"] += ms
        elif "ssm_chunked" in k:
            groups["ssm_scan_chunked"] += ms
        elif "rwkv6_chunked" in k:
            groups["rwkv6_chunked"] += ms
        elif any(tag in k for tag in ("gemm", "nvjet", "cutlass", "gemv")):
            groups["gemm"] += ms
        elif "emcpy" in k:
            groups["copies"] += ms
        else:
            groups["other"] += ms
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]
    tok = torch.argmax(kept["logits"], dim=-1).to(torch.int32)
    s = _prefix(model.cfg) + batch["tokens"].shape[1]

    def _decode():
        for i in range(steps):
            model.decode_step(kept["caches"], tok, s + i)
        return [{}]

    dec = tracing.profile_units(_decode, (), None)
    drows = _by_name(dec)
    host_ms = dec.window_s * 1e3 / steps
    dev_ms = sum(ms for ms, _ in drows.values()) / steps
    return dict(prefill_device_ms=groups, prefill_total_ms=sum(groups.values()),
                prefill_flash_kernels=flash,
                prefill_top=[(k[:90], ms, n) for k, (ms, n) in top],
                decode_device_ms_per_step=dev_ms, decode_host_ms_per_step=host_ms,
                decode_ops_per_step=sum(n for _, n in drows.values()) / steps)


def _first_row(batch: dict) -> dict:
    return {k: v[:1] for k, v in batch.items()}


def run_oracle(model, batch, generated, cache_len: int):
    """Full width and depth in float32 with TF32 off: a prefill of the prompt
    plus ORACLE_STEPS decode steps on the tokens the bfloat16 run generated,
    against one prefill of all of them.  Returns (max abs error, max |logit|).
    The bfloat16 model is widened in place, one parameter at a time, so its
    bfloat16 copy is freed as the float32 one is made: stablelm-12b's two
    copies side by side (24 + 48 GB) would leave little of the card.  The
    batch's embeddings stay bfloat16 (the model widens them exactly)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model.lm.float()
    prompt = batch["tokens"]
    toks = torch.cat([prompt, generated[:, :ORACLE_STEPS]], dim=1)
    s = prompt.shape[1]
    start = _prefix(model.cfg) + s
    logits, caches = model.prefill(batch, cache_len)
    for i in range(ORACLE_STEPS):
        logits, caches = model.decode_step(caches, toks[:, s + i:s + i + 1], start + i)
    del caches
    full, _ = model.prefill({**batch, "tokens": toks}, cache_len)
    assert torch.isfinite(logits).all() and torch.isfinite(full).all()
    err = float((logits[:, 0] - full[:, 0]).abs().max())
    scale = float(full.abs().max())
    assert err <= ORACLE_TOL, (err, scale)
    return err, scale


class _MoeDrops:
    """Count the (token, slot) pairs each MoE routing drops (real tokens
    past their expert's capacity), and put ``moe_route`` back after."""

    def __enter__(self):
        self.dropped, self._route = 0, ffn_mod.moe_route

        def route(router, xg, valid, **kw):
            r = self._route(router, xg, valid, **kw)
            self.dropped += int((valid[..., None] & ~r.keep).sum())
            return r

        ffn_mod.moe_route = route
        return self

    def __exit__(self, *exc):
        ffn_mod.moe_route = self._route


def run_moe_oracle(run: ServeRun, batch, generated, seed: int) -> dict:
    """The float32 oracle of a MoE arch at ``run.oracle_layers`` layers (TF32
    off; seeded weights).  The reference's MoE is not continuation-exact (a
    decode step's group is its batch, with its own capacity; ROADMAP Queue
    C), so the gate is the prefill logits of the kernel path against the
    same model through ``flash_attention_plain`` on the card, within
    ORACLE_TOL; the continuation's error is printed beside the dropped
    (token, slot) counts of the prefill, the decode steps and the long
    prefill, not gated."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = _cut(get_config(run.arch), run.oracle_layers)
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    n0 = dict(kcuda.LAUNCHES)
    kernel, _ = model.prefill(batch, run.cache_len)
    saved = lm_mod.attend
    lm_mod.attend = _plain_attend
    try:
        plain, _ = model.prefill(batch, run.cache_len)
    finally:
        lm_mod.attend = saved
    launched = _delta(dict(kcuda.LAUNCHES), n0)
    assert launched["flash_attention"] == cfg.n_layers, launched     # the kernel side only
    err = float((kernel - plain).abs().max())
    scale = float(plain.abs().max())
    assert torch.isfinite(kernel).all() and err <= ORACLE_TOL, (err, scale)
    prompt = batch["tokens"]
    toks = torch.cat([prompt, generated[:, :ORACLE_STEPS]], dim=1)
    s = prompt.shape[1]
    drops = {}
    with _MoeDrops() as d:
        _, caches = model.prefill(batch, run.cache_len)
        drops["prefill"] = d.dropped
        for i in range(ORACLE_STEPS):
            logits, caches = model.decode_step(caches, toks[:, s + i:s + i + 1], s + i)
        drops["decode"] = d.dropped - drops["prefill"]
        del caches
        full, _ = model.prefill({**batch, "tokens": toks}, run.cache_len)
        drops["long_prefill"] = d.dropped - drops["prefill"] - drops["decode"]
    cont = float((logits[:, 0] - full[:, 0]).abs().max())
    out = dict(layers=cfg.n_layers, kernel_vs_plain_prefill=err, logit_scale=scale,
               continuation_err=cont, continuation_gated=False, dropped_slots=drops,
               tokens=dict(prefill=s, decode_steps=ORACLE_STEPS, long_prefill=s + ORACLE_STEPS))
    del model, kernel, plain, logits, full
    torch.cuda.empty_cache()
    return out


# --- phase 6: training with the Poplar journal --------------------------------

def _host_ram_gib() -> dict:
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(val.split()[0]) / 2**20
    return info


def _leaf_digest(t: torch.Tensor) -> str:
    """SHA-256 of a leaf's dtype, shape and bytes, as the journal records
    them (bfloat16 as its raw 2-byte words)."""
    t = torch.from_numpy(np.asarray(t)) if isinstance(t, np.ndarray) else t
    t = t.detach().to("cpu").contiguous()
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(raw.reshape(-1).view(np.uint8))
    return h.hexdigest()


def _digests(tree) -> dict:
    """``{keystr path: digest}`` of every leaf, eight leaves at a time."""
    from concurrent.futures import ThreadPoolExecutor

    items = list(keystr_items(tree))
    with ThreadPoolExecutor(8) as pool:
        return dict(zip([k for k, _ in items], pool.map(_leaf_digest, [v for _, v in items])))


def _plain_attend(q, k, v, *, causal=True, window=None, logit_softcap=None):
    """Attention through autograd over the plain version (the oracle's
    other side; the package has no such switch)."""
    out = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                causal=causal, window=window, softcap=logit_softcap)
    return out.transpose(1, 2)


class _PlainScan:
    """The scan through autograd over ``ssm_scan_chunked_plain``, in
    ``_SsmScan``'s place (the oracle's other side)."""

    @staticmethod
    def apply(xh, dt, decay, bt, ct):
        y, h = ssm_scan_chunked_plain(xh.transpose(1, 2), dt.transpose(1, 2),
                                      decay.transpose(1, 2), bt, ct)
        return y.transpose(1, 2), h


class _PlainWkv6:
    """wkv6 through autograd over ``rwkv6_chunked_plain``, in ``_Wkv6``'s
    place (the oracle's other side)."""

    @staticmethod
    def apply(rh, kh, vh, wh, u):
        y, S = rwkv6_chunked_plain(*(t.transpose(1, 2) for t in (rh, kh, vh, wh)), u)
        return y.transpose(1, 2), S


class _PlainSide:
    """Swap the three kernels' training Functions for autograd over their
    plain versions, and put them back after.  ``values="kernel_values"``: each
    plain output carries the kernel's value (the kernel wrapper's output on
    the same inputs, held against the plain output within the float32
    ``LLM_TOL``), so the two sides' forwards are equal and their gradients
    differ only by their backwards; ``values="one_ulp"``: each plain output
    is perturbed by one float32 rounding (relative noise of 2^-24), which
    shows how far the float32 rounding of a forward moves the gradients."""

    def __init__(self, values: str = "plain"):
        self.values, self.forward_err = values, {}
        self._gen = None

    def _carry(self, name, out, kernel_fn):
        if self.values == "kernel_values":
            with torch.no_grad():
                want = kernel_fn()
            self.forward_err[name] = max(self.forward_err.get(name, 0.0),
                                         _close(want, out.detach(), torch.float32))
            return out + (want - out).detach()
        if self.values == "one_ulp":
            if self._gen is None:
                self._gen = torch.Generator(device=out.device).manual_seed(7)
            noise = torch.randn(out.shape, generator=self._gen, device=out.device)
            return out * (1 + 2.0 ** -24 * noise)
        return out

    def __enter__(self):
        self._saved = (lm_mod.attend, encdec_mod.attend, encdec_mod.attend_bidir, ssm_mod._SsmScan,
                       rwkv_mod._Wkv6)
        side, (_, _, _, scan_fn, wkv_fn) = self, self._saved

        def attend(q, k, v, **kw):
            out = _plain_attend(q, k, v, **kw)
            return side._carry("flash_attention", out, lambda: attention_mod.attend(
                q.detach(), k.detach(), v.detach(), **kw))

        class Scan:
            @staticmethod
            def apply(*args):
                y, h = _PlainScan.apply(*args)
                return side._carry("ssm_scan_chunked", y, lambda: scan_fn.apply(
                    *(t.detach() for t in args))[0]), h

        class Wkv6:
            @staticmethod
            def apply(*args):
                y, S = _PlainWkv6.apply(*args)
                return side._carry("rwkv6_chunked", y, lambda: wkv_fn.apply(
                    *(t.detach() for t in args))[0]), S

        lm_mod.attend, encdec_mod.attend, ssm_mod._SsmScan, rwkv_mod._Wkv6 = attend, attend, Scan, Wkv6
        encdec_mod.attend_bidir = lambda q, k, v: attend(q, k, v, causal=False)
        return self

    def __exit__(self, *exc):
        (lm_mod.attend, encdec_mod.attend, encdec_mod.attend_bidir, ssm_mod._SsmScan,
         rwkv_mod._Wkv6) = self._saved


def _train_batch(pipe, dev, cfg, rng):
    """The pipeline's next tokens and labels, and for a vlm or an
    encoder-decoder its embeddings drawn from ``rng`` (as ``_extras``)."""
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next_batch().items()}
    return {**batch, **_extras(cfg, rng, batch["tokens"].shape[0], dev)}


def _leaf_errors(keys, got, want):
    """The largest leaf error relative to that leaf's largest |g|, and its
    leaf (the oracle's measure)."""
    worst, worst_key = 0.0, None
    for key, a, b in zip(keys, got, want):
        assert torch.isfinite(a).all(), key
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_key = rel, key
    return worst, worst_key


def run_grad_oracle(cfg, run: TrainRun, seed: int, dev) -> dict:
    """Full width in float32, TF32 off: one ``train_loss`` and backward on a
    1 x ``run.seq`` batch through the kernels' Functions (``_Flash``, ``_SsmScan``,
    ``_Wkv6``: each kernel forward, its torch-op backward), against autograd
    through each one's plain version (a) carrying the kernel's forward
    values, each call's kernel output held against the plain output within
    the float32 ``LLM_TOL`` (the gate: every leaf within TRAIN_ORACLE_TOL of
    its max |g|), (b) end to end with the plain forward (gated at the same
    limit where ``run.oracle_end_to_end``), and (c) end to end with each
    plain output perturbed by one float32 rounding: how far float32
    rounding in a forward moves this model's gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(seed + 1))
    params = to_reference(model, device=dev, release=True)
    keys = [k for k, _ in keystr_items(params)]
    batch = _train_batch(TokenPipeline(DataConfig(vocab=cfg.vocab, batch=1, seq_len=run.seq,
                                                  seed=seed)), dev, cfg, np.random.default_rng(seed))
    per_step = {k: 2 * _per_forward(cfg, k) if k in run.kernels else 0 for k in kcuda.LAUNCHES}
    out = dict(tol=TRAIN_ORACLE_TOL, layers=cfg.n_layers, seq=run.seq)
    held = {}
    # the kernels' side against (a) and (b), (c) against (b); each side's
    # gradients are dropped once nothing compares with them
    for name in ("kernels", "kernel_values", "plain", "one_ulp"):
        side = _PlainSide(name) if name != "kernels" else contextlib.nullcontext()
        with side:
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            n0 = dict(kcuda.LAUNCHES)
            loss = model.train_loss(live, batch)
            grads = torch.autograd.grad(loss, tree_leaves(live))
            launched = _delta(dict(kcuda.LAUNCHES), n0)
            del live
        loss = float(loss.detach())
        if name in ("kernels", "kernel_values"):
            assert launched == per_step, (name, launched)
        else:
            assert not any(launched.values()), (name, launched)
        if name == "kernel_values":
            # comparison launches (forward and recompute): not counted as the path's
            for k, n in launched.items():
                kcuda.LAUNCHES[k] -= n
            out["forward_max_abs_err"] = side.forward_err
        if name == "kernels":
            out["loss"] = loss
        else:
            (got_loss, got), (ref_loss, ref) = (((loss, grads), held["plain"]) if name == "one_ulp"
                                                else (held["kernels"], (loss, grads)))
            worst, key = _leaf_errors(keys, got, ref)
            out[name] = dict(loss=loss, loss_rel_err=abs(got_loss - ref_loss) / abs(ref_loss),
                             grad_rel_err=worst, grad_rel_err_leaf=key)
        if name in ("kernels", "plain"):
            held[name] = (loss, grads)
        if name == "plain":
            del held["kernels"]
        del grads
    gated = ["kernel_values"] + (["plain"] if run.oracle_end_to_end else [])
    for name in gated:
        r = out[name]
        assert r["grad_rel_err"] <= TRAIN_ORACLE_TOL and r["loss_rel_err"] <= TRAIN_ORACLE_TOL, (name, r)
    out["gated"] = gated
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del held, params, model
    torch.cuda.empty_cache()
    return out


# the torch-op backwards and the optimizer, each in a profiler range of
# ``bench/tracing.py``: (device-ms group, range)
_ANNOTATED = (("attention_backward", readers.ATTN_BWD),
              ("ssm_backward", ("bench.ssm_bwd", ssm_mod.__name__, "_chunked_scan_grad", None)),
              ("wkv_backward", ("bench.wkv_bwd", rwkv_mod.__name__, "_chunked_wkv_grad", None)),
              ("optimizer", readers.OPTIMIZER))


def profile_train_step(step_fn, params, opt, batch) -> dict:
    """One train step, run twice under ``bench/tracing.py``'s passes: device
    ms by group (the three kernels' forwards, the torch-op backwards of
    attention, the scan and wkv6, GEMMs outside them, the optimizer, the
    rest) and the card's busy share of the first pass's step."""
    gemm = re.compile("gemm|nvjet|cutlass|gemv", re.IGNORECASE)
    def step():
        step_fn(params, opt, batch)
        return [{}]

    tr = tracing.profile_units(step, [rng for _, rng in _ANNOTATED], None)
    rows = _by_name(tr)
    ms = lambda pick: sum(v for n, (v, _) in rows.items() if pick(n))
    total = ms(lambda n: True)
    groups = {"flash_forward": ms(lambda n: "flash_fwd" in n),
              "ssm_forward": ms(lambda n: "ssm_chunked" in n),
              "wkv_forward": ms(lambda n: "rwkv6_chunked" in n)}
    for group, rng in _ANNOTATED:
        groups[group] = 1e3 * (tr.device_s_under(rng[0]) or 0.0)
    tags = {rng[0] for _, rng in _ANNOTATED}

    def ranged(e):
        while e is not None and e.name not in tags:
            e = e.cpu_parent
        return e is not None

    gemm_in = sum(k.duration for e in tr.host if ranged(e) for k in e.kernels
                  if gemm.search(k.name)) / 1e3
    groups["gemm"] = ms(gemm.search) - gemm_in
    groups["other"] = total - sum(groups.values())
    wall = tr.window_s * 1e3
    top = {}
    for name, (v, _) in rows.items():
        top[name[:90]] = top.get(name[:90], 0.0) + v
    return dict(device_ms=groups, device_total_ms=total, wall_ms=wall, busy=total / wall,
                backward_gemm_ms=gemm_in, top=sorted(top.items(), key=lambda kv: -kv[1])[:8])


def _journal_sizing(cfg, workdir) -> tuple:
    """The layers that (b)-(d) can journal within this host's RAM and
    disk: a save's state bytes at full depth against the free memory (a
    restore holds about three saves' bytes: the lanes, the decoded values
    and the joined state) and the free disk (one committed save, plus the
    crashed one's start)."""
    ram = _host_ram_gib()
    disk = shutil.disk_usage(workdir).free / 2**30
    per_param = 2 + 4 + 4                    # bf16 weights, fp32 mu and nu
    full = cfg.n_params() * per_param / 2**30
    fits = lambda gib: 3.5 * gib <= ram["MemAvailable"] and 2.5 * gib <= disk
    layers, reading = cfg.n_layers, None
    if not fits(full):
        per_layer = (cfg.n_params() - cfg.vocab * cfg.d_model * 2) * per_param / cfg.n_layers / 2**30
        top = cfg.vocab * cfg.d_model * 2 * per_param / 2**30
        while layers > 1 and not fits(top + layers * per_layer):
            layers -= 1
        reading = (f"host RAM available {ram['MemAvailable']:.1f} GiB and free disk {disk:.1f} GiB "
                   f"against a full-depth save of {full:.1f} GiB")
    return ram, disk, full, layers, reading


def _largest_record(tree, n_slices: int) -> int:
    """The bytes of the largest record a save of ``tree`` logs: each leaf
    sliced along its leading dim into ``n_slices`` (``np.array_split``'s
    sizes) when that dim holds at least ``n_slices``, else whole."""
    most = 0
    for leaf in tree_leaves(tree):
        t = torch.as_tensor(leaf)
        rows = t.shape[0] if t.dim() else 1
        if t.dim() and rows >= n_slices > 1:
            rows = -(-rows // n_slices)
        most = max(most, rows * (t.numel() // max(t.shape[0], 1) if t.dim() else 1) * t.element_size())
    return most


def _per_step(cfg, name: str, run: TrainRun) -> int:
    """Launches of kernel ``name`` in one bf16 train step: each of
    ``run.kernels`` twice a forward (the forward and the backward's
    recompute), and the attention backward kernel once per causal
    self-attention call (an encoder-decoder's decoder layers, every layer
    elsewhere) where ``models/attention.py::kernel_backward`` gives it the
    run's bf16, head dim, softcap and S == T."""
    if name == "flash_attention_bwd":
        takes = "flash_attention" in run.kernels and attention_mod.kernel_backward(
            "cuda", torch.bfloat16, cfg.hd, True, cfg.attn_softcap, run.seq, run.seq)
        return cfg.n_layers if takes else 0
    return 2 * _per_forward(cfg, name) if name in run.kernels else 0


def _check_step_launches(launched, run: TrainRun, cfg, what: str):
    for name, n in launched.items():
        assert n == _per_step(cfg, name, run), (what, launched)


def _train_flops(cfg, params, b: int, s: int):
    """The model flops of one step and their formula: 6 N per token for the
    weights a token passes through (a MoE's top k of its experts; an
    encoder's N_enc weights pass its F frames, not the S tokens; the input
    embedding, a lookup, only where the head shares it, as
    ``bench/yardstick.py`` counts), plus 12 Hq D per unmasked attention pair
    and row (the decoder's causal or windowed pairs, an encoder's F^2 and the
    cross-attention's S F)."""
    n = sum(p.numel() for p in tree_leaves(params))
    if not cfg.tie_embeddings:
        n -= params["embed"].numel()
    if cfg.moe is not None:
        n -= cfg.n_layers * (cfg.moe.n_experts - cfg.moe.top_k) * 3 * cfg.d_model * cfg.d_ff
    n_enc = sum(p.numel() for p in tree_leaves(params["enc"])) if cfg.enc_dec is not None else 0
    flops = 6 * (n - n_enc) * b * s
    terms = [f"6 x {n - n_enc:,} x {b * s:,}"]
    pairs = 0
    if cfg.enc_dec is not None:
        f = cfg.enc_dec.enc_seq
        flops += 6 * n_enc * b * f
        terms.append(f"6 x {n_enc:,} x {b * f:,}")
        pairs += cfg.enc_dec.enc_layers * f * f + cfg.n_layers * s * f
    if cfg.rwkv is not None:
        return flops, " + ".join(terms)
    pairs += sum(g.n_layers * attention_pairs(s, s, g.window) for g in lm_mod.layer_groups(cfg))
    flops += 12 * cfg.n_heads * cfg.hd * pairs * b
    terms.append(f"12 x {cfg.n_heads} x {cfg.hd} x {pairs:,} x {b}")
    return flops, " + ".join(terms)


def run_train_path(workdir: str, seed: int, smi: str, run: TrainRun,
                   dev=torch.device("cuda")) -> dict:
    """``run.arch`` training at full width: (a) the float32 gradient oracle;
    (b) run A, ``run.steps`` steps, each launching each of ``run.kernels``
    twice per layer (forward and recompute) and no other kernel; with a
    journal, saves at ``run.saves[0]`` (committed) and ``run.saves[1]``
    (crashed right after ``save`` returned, a torn frame appended), then (c)
    restore, every leaf's digest equal to the saved step's, and (d) a fresh
    model resumed to run A's last step, losses and final digests equal to
    run A's bit for bit; (e) one profiled step."""
    t_phase = time.perf_counter()
    cfg = get_config(run.arch)
    reduced = [f"steps: {run.steps} of a real run's thousands (run A)"
               + (" and the resume from the restored step" if run.journal else ""),
               "data: the synthetic TokenPipeline stream; weights: random from the seed"]
    if run.layers:
        cfg = _cut(cfg, run.layers)
        reduced.append(f"depth: {run.layers} of {get_config(run.arch).n_layers} layers, "
                       f"for (a)-(e): {run.why_layers}")
    out = {"arch": cfg.name}
    if run.journal:
        lanes, slices, buffer = run.journal
        ram, disk, full_gib, layers, reading = _journal_sizing(cfg, workdir)
        out.update(host_ram_gib=ram, free_disk_gib=disk)
        print(f"train_path {cfg.name}: host RAM {ram['MemTotal']:.1f} GiB ({ram['MemAvailable']:.1f} "
              f"available), free disk under the work directory {disk:.1f} GiB; a full-depth save "
              f"{full_gib:.2f} GiB; journaled depth {layers} of {cfg.n_layers}")

    # (a) the gradient oracle, full width in float32
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out["oracle"] = run_grad_oracle(cfg, run, seed, dev)
    out["oracle"]["seconds"] = time.perf_counter() - t0
    oracle_per = {k: _per_forward(cfg, k) for k in kcuda.LAUNCHES}
    o = out["oracle"]
    print(f"train_path {cfg.name} oracle (full width, {cfg.n_layers} layers, float32, TF32 off, "
          f"1 x {run.seq}): largest leaf gradient error of its max |g| against the plain "
          f"versions at the kernels' forward values {o['kernel_values']['grad_rel_err']:.3g} "
          f"({o['kernel_values']['grad_rel_err_leaf']}), end to end "
          f"{o['plain']['grad_rel_err']:.3g} ({o['plain']['grad_rel_err_leaf']}), one float32 "
          f"rounding of the plain forward {o['one_ulp']['grad_rel_err']:.3g}; gated {o['gated']} "
          f"at {TRAIN_ORACLE_TOL}; forward max abs err {o['forward_max_abs_err']}; "
          f"{o['seconds']:.1f} s, peak {o['peak_gib']:.1f} GiB | {smi}", flush=True)

    if run.journal and layers != cfg.n_layers:
        reduced.append(f"depth for (b)-(d): {layers} of {cfg.n_layers} layers, forced by {reading}")
        cfg = _cut(cfg, layers)
    # deterministic algorithms for run A and the resume; filling each new
    # allocation with NaN (a debugging aid that mode turns on) is left off:
    # every kernel here writes all of its output
    torch.use_deterministic_algorithms(True)
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        model = build_model(cfg, device=dev, dtype=torch.bfloat16)
        model.init(torch.Generator(device=dev).manual_seed(seed))
        params = to_reference(model, device=dev, release=True)
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
        opt = adamw.init(params, opt_cfg)
        n_params = sum(p.numel() for p in tree_leaves(params))
        flops, formula = _train_flops(cfg, params, run.batch, run.seq)
        state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves({"p": params, "o": opt}))
        data_cfg = DataConfig(vocab=cfg.vocab, batch=run.batch, seq_len=run.seq, seed=seed)
        pipe = TokenPipeline(data_cfg)
        rng = np.random.default_rng(seed + 2)    # a vlm's or an encoder-decoder's embeddings
        step_fn = make_train_step(model, opt_cfg)
        desc = (f"train_path {cfg.name} run A: {n_params:,} parameters, {cfg.n_layers} layers, "
                f"bf16 weights, fp32 moments; {run.batch} x {run.seq} tokens a step"
                + (f" over {cfg.enc_dec.enc_seq} frames" if cfg.enc_dec is not None else ""))
        if run.journal:
            jdir = os.path.join(workdir, "journal")
            mgr = PoplarCheckpointManager(jdir, n_lanes=lanes, n_slices=slices,
                                          buffer_capacity=buffer)
            record = _largest_record({"params": params, "opt": opt}, slices)
            assert record < buffer, (record, buffer)
            out.update(journal_lanes=lanes, journal_slices=slices, journal_buffer=buffer,
                       largest_record=record)
            desc += (f"; journal {lanes} SSD lanes, {slices} slices, buffer {buffer >> 20} MiB "
                     f"(largest record {record / 1e6:.1f} MB); a save holds "
                     f"{state_bytes / 1e9:.3f} GB")
        print(desc, flush=True)
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, saved, journal = [], [], {}, {}
        for step in range(run.steps):
            batch = _train_batch(pipe, dev, cfg, rng)
            before = dict(kcuda.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            _check_step_launches(_delta(dict(kcuda.LAUNCHES), before), run, cfg, f"step {step}")
            assert np.isfinite(losses[-1]), losses
            print(f"train_path {cfg.name} step {step}: loss {losses[-1]:.6f}, "
                  f"{step_s[-1] * 1e3:.1f} ms | {smi}", flush=True)
            if step in run.saves:
                state = {"params": params, "opt": opt, "data": pipe.state()}
                t0 = time.perf_counter()
                handle = mgr.save(step, state, {"loss": losses[-1]})
                t_flat = time.perf_counter() - t0
                saved[step] = _digests(state)
                row = {"flatten_s": t_flat}
                if step == run.saves[0]:
                    t0 = time.perf_counter()
                    handle.wait(timeout=900)
                    row["log_s"] = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    mgr.wait_for_commit(step, timeout=900)
                    row["commit_wait_s"] = time.perf_counter() - t0
                    assert mgr.last_committed_step() == step
                else:
                    mgr.crash()      # as soon as save returned: the step's logging is cut
                    with open(os.path.join(jdir, "log_0.bin"), "ab") as f:
                        f.write(_torn_record())
                journal[step] = row
                print(f"train_path {cfg.name} save {step}: {row} | {smi}", flush=True)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        n_steps = run.steps + 2                  # run A and the profiled step's two passes
        if run.journal:
            final_a = _digests({"params": params, "opt": opt})
            lane_bytes = sum(os.path.getsize(os.path.join(jdir, f)) for f in os.listdir(jdir)
                             if f.startswith("log_"))
            del params, opt, metrics, state, model, step_fn
            torch.cuda.empty_cache()

            # (c) restore
            t0 = time.perf_counter()
            restored = restore_latest(jdir)
            restore_s = time.perf_counter() - t0
            assert restored is not None, "nothing restorable"
            rstep, flat, meta = restored
            assert rstep in run.saves, rstep
            got = {k: _leaf_digest(v) for k, v in flat.items()}
            assert got == saved[rstep], sorted(k for k in got if got[k] != saved[rstep].get(k))
            assert meta["loss"] == losses[rstep] and meta["step"] == rstep, (meta, losses)
            print(f"train_path {cfg.name} restore: step {rstep} in {restore_s:.2f} s from "
                  f"{lane_bytes:,} lane bytes; all {len(got)} leaves' digests equal the saved "
                  f"step's | {smi}", flush=True)

            # (d) resume a fresh model from the restored state
            model = build_model(cfg, device=dev, dtype=torch.bfloat16)
            specs = model.param_specs()
            like = {"params": specs, "opt": adamw.opt_state_specs(specs, opt_cfg),
                    "data": TokenPipeline(data_cfg).state()}
            tree = to_pytree(flat, like)
            load_reference(model, tree["params"])
            params = to_reference(model, device=dev)
            opt = tree_map(lambda t: t.to(dev), tree["opt"])
            pipe = TokenPipeline.restore(data_cfg, {k: v.numpy() for k, v in tree["data"].items()})
            assert pipe.cursor == rstep + 1, pipe.cursor
            del restored, flat, tree
            step_fn = make_train_step(model, opt_cfg)
            losses_b = []
            for step in range(rstep + 1, run.steps):
                before = dict(kcuda.LAUNCHES)
                params, opt, metrics = step_fn(params, opt, _train_batch(pipe, dev, cfg, rng))
                losses_b.append(float(metrics["loss"]))
                _check_step_launches(_delta(dict(kcuda.LAUNCHES), before), run, cfg,
                                     f"resumed step {step}")
            assert losses_b == losses[rstep + 1:], (losses_b, losses)
            final_b = _digests({"params": params, "opt": opt})
            assert final_b == final_a, sorted(k for k in final_b if final_b[k] != final_a[k])
            print(f"train_path {cfg.name} resume from step {rstep}: losses {losses_b} equal run "
                  f"A's bit for bit; final parameter and optimizer digests equal | {smi}", flush=True)
            n_steps += run.steps - rstep - 1
            out.update(lane_bytes=lane_bytes, restore_s=restore_s, restored_step=rstep,
                       resumed_losses=losses_b, journal=journal)

        # (e) one profiled step
        prof = profile_train_step(step_fn, params, opt, _train_batch(pipe, dev, cfg, rng))
        launches = dict(kcuda.LAUNCHES)
        want = {k: (2 * oracle_per[k] if k in run.kernels else 0) + _per_step(cfg, k, run) * n_steps
                for k in launches}
        assert launches == want, (launches, want)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    del params, opt, model, step_fn
    torch.cuda.empty_cache()

    tokens = run.batch * run.seq
    step_ms = float(np.median(step_s[min(2, run.steps - 1):])) * 1e3
    out.update(
        n_params=n_params, layers=cfg.n_layers, batch=run.batch, seq=run.seq,
        losses=losses, step_ms_each=[t * 1e3 for t in step_s], step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3), model_flops_per_step=flops,
        flop_rate=flops / (step_ms / 1e3), mfu=flops / (step_ms / 1e3) / BF16_FLOPS,
        flop_formula=formula + " per step", profile=prof, state_bytes=state_bytes,
        launches_per_step={k: _per_step(cfg, k, run) for k in kcuda.LAUNCHES if _per_step(cfg, k, run)},
        launches=launches, reduced=reduced, seconds=time.perf_counter() - t_phase)
    print(f"train_path {cfg.name}: step {step_ms:.1f} ms (median of steps "
          f"{min(2, run.steps - 1)}-{run.steps - 1}), {out['tokens_per_s']:,.0f} tok/s, "
          f"{out['flop_rate'] / 1e12:.1f} TFLOP/s = {100 * out['mfu']:.1f}% of 989 ({formula}); busy "
          f"{100 * prof['busy']:.1f}% of the profiled step; device ms {prof['device_ms']}; peak "
          f"{out['peak_gib']:.1f} GiB | {smi}")
    return out


def _parallel_train_run(cfg, seed: int, dev, opt_cfg, batches, mesh=None) -> tuple:
    """``PARALLEL_STEPS`` steps with ``compress_grads`` from the seeded
    weights: ``make_train_step`` when ``mesh`` is None, else
    ``shard_train_step`` over ``mesh`` (parameters and moments as DTensors).
    Returns the readings and the final state as plain tensors."""
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    params = to_reference(model, release=True)    # on the model's device: the card
    opt = adamw.init(params, opt_cfg)
    out = {}
    if mesh is None:
        step_fn = make_train_step(model, opt_cfg, compress_grads=True)
    else:
        step_fn = shard_train_step(model, opt_cfg, mesh, compress_grads=True)
        params = distribute_tree(params, step_fn.param_shardings)
        opt = distribute_tree(opt, step_fn.opt_shardings)
        leaves = tree_leaves(params)
        out["placements"] = sorted({str(tuple(t.placements))
                                    for t in tree_leaves({"p": params, "o": opt})})
        # what each step's gather adds to the rank's resting weights, and
        # whether on this mesh it is a copy at all
        out["gather_extra_bytes"] = sum((t.numel() - t.to_local().numel()) * t.element_size()
                                        for t in leaves)
        out["gather_copies"] = sum(t.full_tensor().data_ptr() != t.to_local().data_ptr()
                                   for t in leaves)
        del leaves           # the first step's parameters are freed when it returns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kcuda.LAUNCHES)
    metrics, step_s = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
    out.update(
        losses=[float(m["loss"]) for m in metrics],
        grad_norms=[float(m["grad_norm"]) for m in metrics],
        step_ms_each=[t * 1e3 for t in step_s],
        step_ms=float(np.median(step_s[1:])) * 1e3,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=_delta(dict(kcuda.LAUNCHES), before))
    state = {"params": params, "opt": opt}
    if mesh is not None:
        state = tree_map(lambda t: t.to_local(), state)
    out["digests"] = _digests(state)
    return out, state


def _state_errors(got, want) -> tuple:
    """``_leaf_errors`` over two state trees, a leaf at a time in float32."""
    return _leaf_errors([k for k, _ in keystr_items(want)],
                        (t.float() for t in tree_leaves(got)),
                        (t.float() for t in tree_leaves(want)))


def run_parallel_path(workdir: str, seed: int, smi: str, dev=torch.device("cuda")) -> dict:
    """The parallel layer on one card, over a world-size-1 NCCL group: (a)
    tinyllama-1.1b trained at full width unsharded twice (the spread of two
    runs) and then through ``shard_train_step`` on a (1, 1) ("data",
    "model") mesh, from the same weights and batches, equal to the first run
    bit for bit where the two unsharded runs are, else within their spread;
    (b) ``compressed_psum`` over the group equal to ``fake_quantize`` bit
    for bit; (c) ``gpipe_apply`` on a one-stage ("pod",) mesh equal to
    ``sequential_reference``.  The group is destroyed at the end."""
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(workdir, "pg_store"),
                            rank=0, world_size=1, device_id=torch.device("cuda", dev.index or 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        print(f"parallel_path: a world-size-1 NCCL group, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: "
              "on one card every extent is 1, so every leaf resolves to Replicate(); "
              "tests/test_torch_parallel.py shows real sharding on 4 CPU ranks", flush=True)
        cfg = get_config(PARALLEL_ARCH)
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                        seed=seed))
        rng = np.random.default_rng(seed + 2)
        batches = [_train_batch(pipe, dev, cfg, rng) for _ in range(PARALLEL_STEPS)]
        torch.use_deterministic_algorithms(True)
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            runs = {}
            runs["unsharded"], first = _parallel_train_run(cfg, seed, dev, opt_cfg, batches)
            runs["unsharded_again"], again = _parallel_train_run(cfg, seed, dev, opt_cfg, batches)
            spread = _state_errors(again, first)
            del again
            torch.cuda.empty_cache()
            runs["sharded"], got = _parallel_train_run(cfg, seed, dev, opt_cfg, batches, mesh)
            err = _state_errors(got, first)
            del got, first
            torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
        base, twin, sh = runs["unsharded"], runs["unsharded_again"], runs["sharded"]
        same = lambda a, b: (a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
                             and a["digests"] == b["digests"])
        bitwise = same(base, twin)
        if bitwise:
            assert same(sh, base), (sh["losses"], base["losses"], sh["grad_norms"],
                                    base["grad_norms"], err)
        else:
            loss_spread = max(abs(a - b) for a, b in zip(twin["losses"], base["losses"]))
            assert max(abs(a - b) for a, b in zip(sh["losses"], base["losses"])) <= loss_spread
            assert err[0] <= spread[0], (err, spread)
        flash = [r["launches"]["flash_attention"] for r in runs.values()]
        assert flash[0] > 0 and len(set(flash)) == 1, flash
        for name, r in runs.items():
            print(f"parallel_path {cfg.name} {name}: losses {r['losses']}, grad norms "
                  f"{r['grad_norms']}; step {r['step_ms']:.1f} ms (median of steps 2-"
                  f"{PARALLEL_STEPS}; each {[round(t, 1) for t in r['step_ms_each']]}), peak "
                  f"{r['peak_gib']:.2f} GiB, flash launches {r['launches']['flash_attention']} | {smi}",
                  flush=True)
        print(f"parallel_path {cfg.name}: two unsharded runs {'bit-identical' if bitwise else 'differ'} "
              f"(largest leaf spread {spread[0]:.3g}, {spread[1]}); sharded vs unsharded "
              f"{'bit for bit' if bitwise else f'{err[0]:.3g} ({err[1]})'}: losses, grad norms and "
              f"all {len(sh['digests'])} leaf digests; placements {sh['placements']}; the gather adds "
              f"{sh['gather_extra_bytes']:,} bytes and copies {sh['gather_copies']} leaves a step; "
              f"sharded step {sh['step_ms'] / base['step_ms'] - 1:+.2%} on the unsharded | {smi}",
              flush=True)
        for r in runs.values():
            del r["digests"]
        out = {"arch": cfg.name, "steps": PARALLEL_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
               "runs": runs, "bitwise": bitwise, "spread": spread[0], "sharded_err": err[0]}

        # (b) the int8 all-reduce over the group at the embed gradient's shape
        x = torch.randn(PSUM_SHAPE, generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        got = compressed_psum(x, mesh, "data")
        assert torch.equal(got, fake_quantize(x)), "compressed_psum != fake_quantize on one rank"
        psum_ms = _median_ms(lambda: compressed_psum(x, mesh, "data"))
        fq_ms = _median_ms(lambda: fake_quantize(x))
        print(f"parallel_path compressed_psum {PSUM_SHAPE} float32 over a 1-rank NCCL group: equal "
              f"to fake_quantize bit for bit; {psum_ms:.4f} ms (fake_quantize {fq_ms:.4f} ms) | {smi}",
              flush=True)
        out["compressed_psum"] = {"shape": list(PSUM_SHAPE), "ms": psum_ms, "fake_quantize_ms": fq_ms}
        del x, got

        # (c) the pipeline on a one-stage pod mesh
        pod = make_mesh((1,), ("pod",))
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        params = {"w": torch.randn(1, PIPE_D, PIPE_D, generator=g, device=dev) * 0.5 / PIPE_D**0.5}
        xs = torch.randn(PIPE_M, PIPE_MB, PIPE_D, generator=g, device=dev)
        stage_fn = lambda p, v: torch.tanh(v @ p["w"])
        pipeline.reset_hops()
        piped = pipeline.gpipe_apply(stage_fn, params, xs, pod)
        ref = pipeline.sequential_reference(stage_fn, params, xs)
        assert piped.shape == (PIPE_M, PIPE_MB, PIPE_D) and torch.equal(piped, ref)
        ticks = PIPE_M + pod.size(0) - 1
        print(f"parallel_path gpipe_apply: {pod.size(0)} stage, M={PIPE_M}, mb={PIPE_MB}, D={PIPE_D}, {ticks} "
              f"ticks, hops {dict(pipeline.HOPS)}: equal to sequential_reference bit for bit | {smi}",
              flush=True)
        out["gpipe"] = {"stages": pod.size(0), "micro": PIPE_M, "mb": PIPE_MB, "d": PIPE_D, "ticks": ticks}
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def run_dryrun_path(par: dict, seed: int, smi: str) -> dict:
    """The dry run held against the card.  (a) In this process, on meta
    tensors: the cost mode over ``parallel_path``'s unsharded step
    (``make_train_step`` with ``compress_grads``, tinyllama-1.1b at 8 x
    2048), whose counted flash ops, forward and backward, must each equal
    the launches a step of it made, and whose roofline lower bound must not
    exceed the measured step:
    a lower bound above a measurement means the count is wrong.  The bound
    is the largest of its compute (the flop bound: ``dot_flops`` at the bf16
    peak), memory and collective terms, so the flop bound is held too; the
    gate catches only an overcount larger than the step over the bound.
    Its predicted peak is printed
    beside the first run's measured one, not gated.  (b) In a subprocess,
    so that its fake process group never meets this process's groups: the
    dry run's CLI on ``DRYRUN_CELLS``, each cell ``ok``."""
    t_phase = time.perf_counter()
    cfg = get_config(PARALLEL_ARCH)
    model = build_model(cfg, device="meta")
    params = to_reference(model, release=True)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                    seed=seed))
    batch = _train_batch(pipe, torch.device("meta"), cfg, np.random.default_rng(seed + 2))
    cost = analyze(make_train_step(model, opt_cfg, compress_grads=True), params,
                   adamw.init(params, opt_cfg), batch)
    run = par["runs"]["unsharded"]
    for name in ("flash_attention", "flash_attention_bwd"):
        launched = run["launches"][name] / PARALLEL_STEPS
        counted = cost.kernel_ops.get(name, 0)
        assert counted == launched, f"dryrun_path: {counted} {name} ops counted, {launched} launched a step"
    launched = run["launches"]["flash_attention"] / PARALLEL_STEPS
    counted = cost.kernel_ops.get("flash_attention", 0)
    roof = dryrun.roofline(cost.dot_flops, cost.traffic_bytes, cost.collective_traffic)
    flop_ms = cost.dot_flops / dryrun.PEAK_FLOPS * 1e3
    bound_ms = roof["step_s_lower_bound"] * 1e3
    assert bound_ms <= run["step_ms"], (bound_ms, run["step_ms"])
    peak_gib = cost.peak_bytes / 2**30
    print(f"dryrun_path {cfg.name} unsharded step on meta ({TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"compress_grads): {counted} flash ops counted = {launched:.0f} launched a step; "
          f"{cost.dot_flops:.4g} flops ({flop_ms:.1f} ms at the bf16 peak), {cost.traffic_bytes:.4g} "
          f"bytes ({roof['memory_s'] * 1e3:.1f} ms at {dryrun.HBM_BW:.3g} B/s), roofline lower bound "
          f"{bound_ms:.1f} ms ({roof['bottleneck']}) <= measured step {run['step_ms']:.1f} ms "
          f"({bound_ms / run['step_ms']:.3f} of it); peak {peak_gib:.2f} GiB predicted, "
          f"{run['peak_gib']:.2f} GiB measured in the first run (ratio {peak_gib / run['peak_gib']:.3f}, "
          f"not gated) | {smi}", flush=True)
    out = {"arch": cfg.name, "counted_flash_ops": counted, "launched_flash_per_step": launched,
           "dot_flops": cost.dot_flops, "traffic_bytes": cost.traffic_bytes,
           "convert_traffic": cost.convert_traffic, "flop_bound_ms": flop_ms,
           "roofline": roof, "measured_step_ms": run["step_ms"], "peak_gib_predicted": peak_gib,
           "peak_gib_measured": run["peak_gib"]}

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke-dryrun-") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", PARALLEL_ARCH,
             "--shape", shape, "--mesh", mesh, "--out", tmp],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for shape, mesh in DRYRUN_CELLS]
        try:
            logs = [p.communicate(timeout=DRYRUN_LIMIT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, f"dryrun_path: the dry run's CLI failed:\n{log[-3000:]}"
        cells = []
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name)) as f:
                r = json.load(f)
            assert r["status"] == "ok", (name, r.get("error"))
            roof = r["roofline"]
            print(f"dryrun_path {r['arch']} {r['shape']} {r['mesh']} ({r['n_chips']} ranks, fake "
                  f"group, meta): per device peak {r['memory']['peak_gb']:.2f} GB (at rest "
                  f"{r['memory']['argument_bytes'] / 1e9:.3f} GB), {r['flops_per_device']:.4g} flops, "
                  f"{r['bytes_per_device']:.4g} bytes, collectives {r['collective_traffic_per_device']:.4g} "
                  f"bytes {json.dumps(r['collectives'])}, bottleneck {roof['bottleneck']}, step >= "
                  f"{roof['step_s_lower_bound']:.4f} s (datasheet H100 constants); traced in "
                  f"{r['trace_s']} s", flush=True)
            cells.append({k: r[k] for k in ("arch", "shape", "mesh", "n_chips", "memory",
                                            "flops_per_device", "bytes_per_device", "collectives",
                                            "collective_traffic_per_device", "roofline", "trace_s")})
    assert len(cells) == sum(2 if mesh == "both" else 1 for _, mesh in DRYRUN_CELLS), cells
    out["cells"] = cells
    out["seconds"] = time.perf_counter() - t_phase
    assert out["seconds"] <= DRYRUN_LIMIT_S, f"dryrun_path took {out['seconds']:.1f} s"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = _smi()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t_start = t0 = time.perf_counter()
    so = kcuda.build()
    kcuda.lib()
    print(f"built {os.path.basename(so)} in {time.perf_counter() - t0:.1f} s")
    for line in kcuda.build_log().splitlines():
        if any(tag in line for tag in ("registers", "Compiling entry", "spill", "wgmma")):
            print("  " + line.strip())

    def tick(phase: str):
        print(f"elapsed {time.perf_counter() - t_start:.1f} s after {phase}", flush=True)

    tick("the build")
    kernels = check_kernels(args.seed)
    tick("the OLTP kernel cases")
    for k in kernels:
        for tag, r in (("", k), (" write-only", k.get("write_only")),
                       (" scan form", k.get("scan_form")),
                       (" large slots", k.get("large_slots"))):
            if r is None:
                continue
            plain = f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""
            print(f"kernel {k['name']}{tag} ({r['shape']}): exact; {r['ms']:.4f} ms "
                  f"(device {r['device_ms']} ms, {r['device_ops_per_call']} device ops and "
                  f"{r['host_us_per_call']:.2f} host us per call){plain}, bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]})"
                  + (f", design floor {r['floor_ms']:.4f} ms" if "floor_ms" in r else "")
                  + f", library {r['library_ms']} ms | {smi}")
    llm_cases = check_llm_kernels(args.seed)
    for k in llm_cases:
        print(f"kernel {k['name']} ({k['shape']}): max abs err {k['max_abs_err']:.3g} "
              f"(atol {k['tol'][0]}, rtol {k['tol'][1]}); {k['ms']:.4f} ms (device {k['device_ms']} ms"
              + (f"; with lse {k['lse_ms']:.4f} ms (device {k['lse_device_ms']} ms), lse max abs err "
                 f"{k['lse_max_abs_err']:.3g}, o bit-identical" if "lse_ms" in k else "")
              + (f"; backward: torch ops {k['bwd_ms']:.3f} ms, SDPA {k['sdpa_bwd_ms']:.3f} ms"
                 if "bwd_ms" in k else "")
              + (f", {k['device_ops_per_call']} device ops per call: {k['phase_device_ms']}"
                 if "phase_device_ms" in k else "") + "), plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound'][0]:.4f} ms ({k['bound'][1]})"
              f", library {k['library_ms']} ms ({k.get('library', 'none')}) | {smi}")
    print("llm_kernel_cases " + json.dumps(llm_cases, default=float))
    tick("the LLM kernel cases")
    print(f"main path: YCSB {N_ROWS} rows (reduced from the paper's {PAPER_ROWS}"
          f" for the smoke's time limit), 4 SSD devices, segments of "
          f"{SEGMENT_BYTES >> 20} MiB")
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        kcuda.reset_launches()
        out = run_main_path(workdir, seed=args.seed)
        launches = out["launches"]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name in OLTP_KERNELS:
        assert launches[name] > 0, f"kernel {name} never launched on the main path"

    for b in out["batches"]:
        tag = ", under the CUDA profiler" if b["profiled"] else ""
        print(f"txn/s {b['entry']} ({b['kind']}, {b['txns']} txns{tag}): "
              f"{b['txn_per_s']:.1f} | {smi}")
    for mode in ("kernel", "vectorized", "scalar"):
        print(f"recovery s mode={mode}: {out['recovery'][mode]['seconds']:.3f} | {smi}")
    print("main_path " + json.dumps(out, default=float))
    tick("main_path")

    # TPC-C, then sharded Poplar: each path with its own counts
    for name, run in (("tpcc_path", lambda w: run_tpcc_path(w, args.seed, smi)),
                      ("sharded_path", lambda w: run_sharded_path(w, args.seed, smi, t_start))):
        workdir = tempfile.mkdtemp(prefix="chip_smoke-")
        try:
            kcuda.reset_launches()
            path = run(workdir)
            path["launches"] = dict(kcuda.LAUNCHES)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for kname in ("validate_sequence", "ssn_scatter_max"):
            assert path["launches"][kname] > 0, f"kernel {kname} never launched on {name}"
        print(f"{name} launches {path['launches']} | {smi}")
        print(f"{name} " + json.dumps(path, default=float))
        tick(name)

    # the serving tier over the YCSB table, with its own counts
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        kcuda.reset_launches()
        tier = run_serve_tier_path(workdir, args.seed, smi)
        tier["launches"] = dict(kcuda.LAUNCHES)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for kname in OLTP_KERNELS:
        assert tier["launches"][kname] > 0, f"kernel {kname} never launched on serve_tier_path"
    # every seg_reduce launch of the phase was held against its plain version
    assert sum(tier["seg_reduces_checked"].values()) == tier["launches"]["seg_reduce"], tier
    print(f"serve_tier_path launches {tier['launches']} ({tier['seconds']:.1f} s), seg_reduce == "
          f"plain on every launch {tier['seg_reduces_checked']}, host {tier['host']} | {smi}")
    print("serve_tier_path " + json.dumps(tier, default=float))
    tick("serve_tier_path")

    # the LLM serve paths, one model at a time, each with its own counts; a
    # kernel's line reports the first serve path that launched it (the D = 160
    # flash cases, stablelm-12b's; the family cases, their archs')
    serve_launches = {}
    for run in SERVE_RUNS:
        arch = run.arch
        kcuda.reset_launches()
        serve, model = run_serve_path(run, args.seed, smi)
        serve_launches[arch] = dict(kcuda.LAUNCHES)
        for name in run.kernels:
            assert serve_launches[arch][name] > 0, f"kernel {name} never launched on the {arch} path"
            launches[name] = launches[name] or serve_launches[arch][name]
        prof = profile_serve(model, serve["timed_batch"], run.cache_len)
        if "flash_attention" in run.kernels:
            # a bf16 prefill runs the tensor-core kernel at its head dim, and no other
            want = {f"flash_fwd_wgmma_kernel<{model.cfg.hd}>"}
            assert set(prof["prefill_flash_kernels"]) == want, (arch, prof["prefill_flash_kernels"])
        print(f"{arch} prefill {SERVE_BATCH} x {run.prompt} under the CUDA profiler: device "
              f"ms {prof['prefill_device_ms']}, total {prof['prefill_total_ms']:.1f}, flash "
              f"launches {prof['prefill_flash_kernels']}; decode "
              f"step: device {prof['decode_device_ms_per_step']:.2f} ms in "
              f"{prof['decode_host_ms_per_step']:.2f} ms of host clock, "
              f"{prof['decode_ops_per_step']:.0f} device ops | {smi}")
        batch = _first_row(serve["timed_batch"])
        generated = torch.from_numpy(serve["timed_tokens"][:1]).cuda()
        steps = f"{run.prompt} + {ORACLE_STEPS} decode steps vs one prefill of {run.prompt + ORACLE_STEPS}"
        if run.oracle_layers:
            del model
            torch.cuda.empty_cache()
            o = run_moe_oracle(run, batch, generated, args.seed)
            print(f"float32 oracle ({arch}, full width, {o['layers']} layers, TF32 off): prefill "
                  f"logits through the flash kernel vs flash_attention_plain: max abs error "
                  f"{o['kernel_vs_plain_prefill']:.3g} (tol {ORACLE_TOL}, max |logit| "
                  f"{o['logit_scale']:.3g}); continuation {steps}: max abs logit error "
                  f"{o['continuation_err']:.3g} (not gated: the MoE's capacity convention), dropped "
                  f"(token, slot) pairs {o['dropped_slots']} | {smi}")
            serve.update(prefill_profile=prof, oracle=o)
        else:
            err, scale = run_oracle(model, batch, generated, run.cache_len)
            print(f"float32 continuation oracle ({arch}, full width, {model.cfg.n_layers} layers, "
                  f"TF32 off): prefill {steps}: max abs logit error {err:.3g} (tol {ORACLE_TOL}, "
                  f"max |logit| {scale:.3g}) | {smi}")
            serve.update(prefill_profile=prof, oracle_err=err, oracle_logit_scale=scale)
            del model
        del serve["timed_tokens"], serve["timed_batch"], batch
        torch.cuda.empty_cache()
        serve["allocated_gib_after_free"] = torch.cuda.memory_allocated() / 2**30
        print("serve_path " + json.dumps(serve, default=float))
        tick(f"serve_path {arch}")

    # the parallel layer, with its own counts
    workdir = tempfile.mkdtemp(prefix="chip_smoke-")
    try:
        kcuda.reset_launches()
        par = run_parallel_path(workdir, args.seed, smi)
        par["launches"] = dict(kcuda.LAUNCHES)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    assert not dist.is_initialized()
    assert par["launches"]["flash_attention"] > 0, "flash_attention never launched on parallel_path"
    print(f"parallel_path launches {par['launches']} ({par['seconds']:.1f} s) | {smi}")
    print("parallel_path " + json.dumps(par, default=float))
    tick("parallel_path")

    # the dry run on meta tensors, held against parallel_path's measured step;
    # it launches nothing
    kcuda.reset_launches()
    dry = run_dryrun_path(par, args.seed, smi)
    assert not any(kcuda.LAUNCHES.values()), kcuda.LAUNCHES
    print(f"dryrun_path ({dry['seconds']:.1f} s) | {smi}")
    print("dryrun_path " + json.dumps(dry, default=float))
    tick("dryrun_path")

    # training, one arch at a time, each with its own counts
    train_launches = {}
    for run in TRAIN_RUNS:
        workdir = tempfile.mkdtemp(prefix="chip_smoke-")
        try:
            kcuda.reset_launches()
            train = run_train_path(workdir, args.seed, smi, run)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        for name in run.kernels:
            assert train["launches"][name] > 0, f"{name} never launched on train_path {run.arch}"
        train_launches[run.arch] = train["launches"]
        print("train_path " + json.dumps(train, default=float))
        tick(f"train_path {run.arch}")

    line = []
    main_cases = {name: next(k for k in llm_cases if k["name"] == name) for name in LLM_KERNELS}
    # the D = 160 cases and the family cases, each with the launches of the
    # serve path whose shape it has (grok-1-314b's softcap case has none)
    served = [(k, serve_launches["stablelm-12b"]) for k in llm_cases
              if k["name"] == "flash_attention" and " D=160 " in k["shape"]]
    served += [(k, serve_launches[k["path"]]) for k in llm_cases if k.get("path")]
    # the backward cases, with the launches of the train path at their shape
    served += [(k, train_launches["hymba-1.5b"]) for k in llm_cases
               if k["name"] == "flash_attention_bwd"]
    for k, counts in [(k, launches) for k in kernels + [main_cases[n] for n in LLM_KERNELS]] + served:
        n = counts[k["name"]]
        line.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": n,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound"][0], "bound_by": k["bound"][1],
            "library_ms": k["library_ms"], "shape": k["shape"],
            "device_ms": k["device_ms"],
        })
        extra = ("device_ops_per_call", "host_us_per_call", "write_only", "scan_form", "large_slots")
        # the design floor is computed, not measured: printed above, kept out of this line
        line[-1].update({key: ({f: v for f, v in k[key].items() if f != "floor_ms"}
                               if isinstance(k[key], dict) else k[key])
                         for key in extra if key in k})
    print(json.dumps({"kernels": line}, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
