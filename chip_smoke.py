#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints one JSON line; any failure raises and exits non-zero):

a. device: the card's name, count and power limit;
b. build: every CUDA source of the port, one ``nvcc`` each, in parallel,
   with each kernel's ``ptxas`` registers, whether ``setmaxnreg`` took
   effect (no C7508 warning) and any ``wgmma`` serialisation ptxas
   reports;
c. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main paths give it, with times (CUDA
   events; the main shape three times, for a spread) beside the least time
   the card could take (``bound_ms``), one PyTorch library call computing
   the same function where there is one (``library_ms``, a yardstick the
   port never calls), and the host's microseconds per call (wall clock
   around back-to-back enqueues), which says whether a row is host- or
   device-bound. W8A16 rows also time cuBLAS on the weight dequantized
   ahead of time and the eager ``(x @ q.to(bf16)) * s``, each over copies
   of the weight larger than L2, as a decode step meets its weights: the
   decode GEMV at every weight, the ``wgmma`` path at M = 64, 512 and 2048
   at every weight and at a speculative verify block's M = 32 (8 slots x
   4 positions, lm_head too), and ragged shapes (M, N and K off the tiles,
   strided x and q views) checked without timing; the flash kernel also at
   the cacheless embedding shapes (B of 2, 4 and 8, T = S), at
   deepseek-v2-lite's heads (16 q and kv heads, d 192: every bucket phase
   i fills, a continuation, its 8 x 2048 embedding batch), at Gemma 1's
   d 256 (gemma-7b's 16 heads on 16 at every bucket phase m fills, a
   continuation at offset 1536, its embedding batch; gemma-2b's 8 q heads
   on 1) and once at d 64; the grouped expert kernel (the routed MoE
   products: a token chunk's (token, expert) pairs sorted by expert, one
   launch over the experts they reach), int8 (``w8a16_grouped``) at
   mixtral-8x7b's, qwen3-30b-a3b's and deepseek-v2-lite's gate/up and
   down products and bf16 (``bf16_grouped``) at qwen3-30b-a3b's,
   deepseek-v2-lite's and gpt-oss-20b's, each at the routed rows of a
   seeded top-k pick of a decode step's 8 slots (the GEMV) and the 2048
   bucket (the persistent ``wgmma`` kernel, each row with its plan: unit
   rows and columns, the routing's units, CTAs and waves), every segment
   held to the plain version, timed beside the plain version,
   ``torch._grouped_mm`` (bf16; on the dequantized weight for int8) and
   the bound for the rows and experts the pick reaches; timed without a
   gate, bf16 at mixtral-8x7b's two int8 shapes (the schedule without
   the widening) and qwen3-30b-a3b's bf16 products with half the pairs
   on a quarter of the experts; then, checked only, routings that stress
   the segments (an expert no token picks, every token on one expert, a
   segment ending mid-tile, one token, 17 tokens); the flash kernel's LSE
   mode (a ring block's fp32 output and row log-sum-exp) against its
   plain version at llama3-8b's heads (T = S = 2048) and at the three
   blocks of qwen3-8b's sp4 ring over 32768 tokens (the diagonal,
   ``q_offset`` 8192 and 24576), the output to the kernel gate and the
   log-sum-exp within 1e-3, timed beside the causal mode, the plain
   version and SDPA's flash backend with its logsumexp;
d. main path: the port's OpenAI server in-process, serving llama3-8b at
   full width (bf16, random weights from a seed) with 8 slots and a
   2048-token context: chat, streaming chat, a completion whose prompt
   fills the 2048 bucket, four concurrent chats, and a repeated greedy
   prompt. A kernel prefill's last-position logits are held against a
   prefill through the plain attention. Reported: TTFT of one 2048-bucket
   prompt, decode tokens/s with 8 slots busy, peak memory, and the
   2048-bucket prefill timed with CUDA events. The chat and the streamed
   chat carry a caller's ``traceparent``: each answer has
   ``X-Request-ID`` and a ``traceparent`` of the caller's trace with a new
   span id, and the port's ``get_store("engine")`` holds that hop;
   ``/healthz`` and ``/metrics`` answer without them and leave no hop (in
   every phase that serves phase d's requests);
e. prefix reuse: the same model with ``--prefill-chunk 512
   --host-kv-cache-mb 4096``: continuations against one prefill,
   multi-turn chats with exact hit and reuse counts, a 1900-token prompt
   chunked while four chats decode, ``/metrics``; each warm turn's traced
   hop carries a ``kv_upload`` span and a ``kv_prefix_hit`` event with the
   reused tokens;
f. checkpoints and int8: llama3-8b's full widths at 2 layers written as a
   safetensors checkpoint (the script's own writer) and served through
   ``--model-dir``, the loaded tree and logits identical to the in-memory
   tree's; then llama3-8b int8 at full depth (``--quantization int8``)
   through the server with phase d's requests, its kernel logits against
   the W8A16 plain version, beside phase d's bf16 numbers;
g. speculation, embeddings and profile: llama3-8b int8 with
   ``--speculative ngram`` and bf16 with ``--speculative draft
   --draft-source llama3-8b`` (a perfect draft: the preset's weights come
   from the target's seed), each beside a plain engine over the same
   weights. Eight repetitive greedy chats on each: the speculative ids
   must equal the plain ones or part only where the plain run's top two
   logprobs were closer than twice the logit tolerance (two forwards each
   within 5% of the logit scale); the n-gram server must accept proposals,
   the perfect draft at least 90% of them. On each plain server:
   ``/v1/embeddings`` of 8 inputs at the 2048 bucket (each vector within
   cosine 0.999 of the same forward through the plain attention),
   ``dimensions``, ``base64`` and ``/v1/rerank``; then
   ``/debug/profile?steps=20`` while 8 chats decode, its Chrome trace
   summarised (device-busy share, the 10 ops with the most device time,
   idle time per step);
h. the MoE family: qwen3-30b-a3b (qk-norm, 128 experts, top-8, routed
   through the bf16 grouped kernel): its full widths at 2 layers written in
   Qwen3-MoE naming and served through ``--model-dir`` (loaded tree and
   logits identical to the in-memory tree's); then bf16 at full width and
   depth (48 layers, ~61 GB, random weights from a seed) through the
   server with phase d's requests, its kernel logits against the plain
   attention (the kernel run's expert picks replayed in the plain run:
   top-k routing on random weights flips near-tied picks on any rounding
   change; the free-routing comparison is reported beside it), TTFT,
   decode tokens/s, peak memory, the 2048-bucket prefill, and a 20-step
   ``/debug/profile`` while 8 chats decode (``moe_profile``); then a
   ``moe`` line: one MoE layer at the 2048 bucket and at 8 decoding
   slots, held against an fp32 routed reference (each token through its
   own experts), run once under ``set_sync_debug_mode("error")`` (no
   host sync on the MoE path), timed with CUDA events beside its
   dense-dispatch bound (which the 2048-bucket layer must beat: only a
   layer reading the picked experts alone can) and its routed bound (the
   experts the input's routing reaches), with its transient memory
   (within the routed x, g, u, h and y of one chunk) and its device time
   split by kernel. Phase c times the flash kernel at this model's
   heads too (32 q heads on 4 kv heads, a group of 8). The 2-layer
   checkpoint is also served with ``--quantization int8``: its tree equals
   ``quantize_params`` of the in-memory tree, bit for bit (quantized a
   layer at a time on the card), and so do its logits;
i. the DeepSeek family: deepseek-v2-lite (MLA served decompressed, K 192
   wide and V zero-padded to it; one dense layer then 26 DeepSeek-MoE
   layers of 64 experts, top-6, two shared; YaRN with its mscale² softmax
   scale) once phase h's tree is freed: its full widths at 2 layers (one
   dense, one MoE) written in DeepSeek-V2 naming and served through
   ``--model-dir`` (loaded tree and logits identical to the in-memory
   tree's); then bf16 at full width and depth (27 layers, ~31.4 GB)
   through the server with phase d's requests (flash logits against the
   plain attention with the kernel run's expert picks replayed, free
   routing beside), ``/v1/embeddings`` at the 2048 bucket against the
   plain attention, a 20-step profile, and a ``moe`` line for one of its
   MoE layers with the shared experts in the layer, its reference and its
   bounds; then ``--quantization int8`` (~16 GB: MLA's projections, the
   shared experts and the dense layer through the W8A16 kernel, the
   experts through the grouped one) with phase d's requests, exact
   launches, and its kernel logits against the plain versions with the
   kernel run's expert picks replayed;
j. the GPT-OSS family: gpt-oss-20b (attention sinks, a window of 128 on
   the even layers, q/k/v/o biases, YaRN; 32 experts, top-4, the affine
   router, clamped GLU with expert biases) once phase i's tree is freed:
   its full widths at 2 layers written in GPT-OSS naming with the expert
   weights packed as MXFP4 blocks and scales (the script's own packer)
   and served through ``--model-dir`` (the loaded tree and logits
   identical to the in-memory tree rounded to fp4 by that packing); then
   bf16 at full width and depth (24 layers, ~41.8 GB) through the server
   with phase d's requests, ``/v1/embeddings`` at the 2048 bucket, a
   20-step profile, a 2048-bucket prefill split into its attention and
   MoE time (CUDA events), and a ``moe`` line. Its prefills take the plain
   attention, as the JAX ``forward``'s do (no flash for sliding windows,
   softcaps or sinks), so its served logits and embeddings are held
   against the fp32 plain forward over the same weights, with the served
   run's expert picks replayed (free routing beside it);
k. the Gemma family: gemma2-9b (delta-gain sandwich norms, the scaled and
   tied embedding, tanh GELU, ``query_pre_attn_scalar`` 256, attention
   and final softcaps, a window of 4096 on the even layers): its full
   widths at 2 layers as a tied Gemma2 checkpoint through ``--model-dir``;
   bf16 at full width and depth (42 layers, ~18.5 GB) with phase d's
   requests and embeddings, held against the fp32 plain forward; then
   ``--quantization int8`` with phase d's requests, its W8A16 kernel
   logits against the plain version; each path's 2048-bucket prefill
   split into its attention time. Phase c times the W8A16 kernel at this
   model's widths too;
l. int8 MoE at full width and depth: mixtral-8x7b (32 layers, d 4096, 32
   q heads on 8 kv heads, 8 experts, top-2, width 14336, vocab 32000)
   with ``--quantization int8``, ~46.7 GB drawn on the card (its 93 GB of
   bf16 fit no card): phase d's requests with exact launches (a
   2048-bucket forward runs 129 2-D W8A16 products and 96 grouped ones),
   its kernel logits against the W8A16 plain versions with the kernel
   run's expert picks replayed (free routing beside), TTFT, prefill,
   decode tokens/s, the int8 tree's GB and the peak memory; then a
   ``moe`` line for one int8 MoE layer at the 2048 bucket and at 8
   slots against the fp32 routed reference and its dense bound;
m. Gemma 1 at head_dim 256: gemma-7b's published widths (d 3072, 16
   heads of 256, MLP 24576, vocab 256000, tied) at 2 of its 28 layers,
   written as a Gemma safetensors checkpoint and served bf16 through
   ``--model-dir`` (tree and logits identical to the in-memory tree's),
   then phase d's requests with exact flash launches at d 256, its served
   logits against the plain attention and ``/v1/embeddings`` at the 2048
   bucket;
n. disaggregated prefill/decode: llama3-8b bf16 at full width and depth
   as two engines on the card (``--kv-role prefill`` and ``--kv-role
   decode``, each with a host KV tier) behind two servers; a 1900-token
   prompt sent to the decode server with ``X-GPUStack-KV-Source`` naming
   the prefill server: the prefill replica prefills it for export, 7
   blocks travel, the decode replica prefills the tail at ``q_offset``
   1792. Reported: handoff seconds, bytes and blocks, the decode
   replica's TTFT beside its cold TTFT, exact flash launches over both
   runners, greedy ids against a cold single-engine run (phase g's rule),
   the decode replica's traced hop with its ``kv_handoff`` span and event;
   then one ``json_schema`` request with a schema and one streamed;
o. image chat: the repo's vision tower (64 x 64 images, 8 x 8 patches,
   dim 64, 2 layers) projected into llama3-8b (bf16, full width and
   depth) as ``llama3-8b-vision``, attached to the engine as the JAX
   server attaches one, through the server: chats with a 64 x 64 PNG and
   a 97 x 53 one (resized), a streamed one, a remote URL and a JPEG (400s),
   then image and text chats of one token count for TTFT; one flash launch
   a layer for each image prefill (``prefill_with_embeds``), its logits
   against the plain attention over the same spliced embeddings, the tower
   in bf16 against its fp32 plain version, the served greedy ids against
   the runner called directly; the tower's ms and the host ms of the PNG
   decode and resize;
p. speech to text: whisper-large-v3 (32 + 32 layers, d 1280, 20 heads,
   128 mels, vocab 51866) in bf16 from a seed behind the port's audio
   server: a 10 s WAV to ``/v1/audio/transcriptions`` and
   ``/translations``, the encoder and every forced decoder step against an
   fp32 plain forward, ``/healthz`` and ``/metrics``, encode ms, decode ms
   a token, request latency and peak memory; then a 2 + 2-layer HF Whisper
   checkpoint at the same widths through ``--model-dir`` (tree and greedy
   ids identical);
q. text to speech: tts-base (dim 256, 4 + 4 layers, 80 mels) through
   ``/v1/audio/speech``: a valid WAV, frame counts equal to the fp32 plain
   reference's and the mel within 2% of its scale (the frame owners
   replayed), ``synthesize_mel`` ms on the card and the host Griffin-Lim
   ms. Phases p and q launch no hand-written kernel (their attention is
   plain torch, as it is XLA in JAX), and their windows must count none;
r. image generation: sd15-shaped (1.03 B parameters, 512 px) and
   sdxl-shaped (3.43 B, 1024 px, two text encoders, depth 10 at its
   lowest level) at full width in bf16 from a seed behind the port's image
   server: the text encoders, a UNet call at the guided batch of 2 and
   the VAE against an fp32 run over the same weights, each step of a
   30-step sample against an fp32 step from the same latents; device
   times of the encoders, the UNet at batch 2 and 8 (its attention's
   share) and the VAE; ``/v1/images/generations`` at 30 steps (request
   ms, the host's PNG encode), n = 2, a seed twice and another (bytes
   identical, then not), 256 px on sd15-shaped, n = 4 on sdxl-shaped
   (peak memory), each of JAX's refusals, ``/healthz`` and ``/metrics``;
   sd15-shaped written whole as a diffusers checkpoint and served through
   ``--model-dir`` (config, tree and PNG bytes identical). Like p and q,
   phase r launches no hand-written kernel, and its windows count none.
s. four GPUs, when the machine has them (else one line says phase s did
   not run, and why): llama3-70b (bf16, 80 layers) under ``tp4`` and
   mixtral-8x7b (bf16) under ``ep2xtp2`` through the port's server, this
   process rank 0 and one follower process per other GPU: the served
   logits against a prefill through the plain attention on the same
   ranks, TTFT at the 2048, 512 and 128 buckets, a chat, 8 chats of 128
   tokens decoding at once, every rank's launches equal to what the
   leader's forwards need (80 flash launches a prefill on each rank for
   llama3-70b), every follower's slot state equal to the leader's, peak
   memory per rank, and the NCCL kernels' share of a decode step's
   (20-step profile) and of a 2048-bucket prefill's device time; then, one
   process per GPU: llama3-70b at 4 layers in fp32 (TF32 off) under
   ``tp4`` against the one-card forward of the same tree (each rank's
   leaves equal to the one-card tree's slices first, logits within 1e-4
   of their scale), the same in int8 (W8A16 and flash on the shards)
   against one-card int8, and one mixtral-8x7b MoE layer under
   ``ep2xtp2`` against the fp32 routed reference with the picks replayed.
t. sequence parallelism on four GPUs, when the machine has them (else one
   line says phase t did not run): qwen3-8b (bf16, 36 layers, random
   weights from a seed) under ``sp4`` with a 32768-token context and 4
   slots through the port's server: a 30000-token prefill and 8 decode
   steps' logits against one card's forward of the same tree and tokens
   (flash, no ring) after the replica is down, within 5% of the scale at
   cosine 0.999; TTFT at 32768 and 4096 beside the one-card engine's,
   decode tokens/s with 4 chats, rank ``r``'s LSE-mode flash launches
   ``(r + 1)`` a layer of each prefill, every follower's slot state equal
   to the leader's, peak memory per rank, the NCCL share of rank 0's
   32768 prefill; then, one process per GPU, llama3-8b's widths at 4
   layers in fp32 (TF32 off, the flash modes' plain versions) under
   ``sp4`` and ``sp2xtp2``: a 2000-token prefill, a chunk and a
   continuation, 8 decode steps, each logit row within 1e-4 of the one-card
   runner's scale; and the ring alone at qwen3-8b's heads over 32768
   tokens against the one-card flash kernel and the fp32 plain version
   (the kernel gate), with ms per ring call, per hop and one card's call.
u–w. (four GPUs; see each phase's function) ``dp > 1``, ``sp`` with
   ``ep``, the host KV tier and speculation on a replica.
x. disaggregated serving and embeddings on multi-GPU replicas, four GPUs
   (``phase_kv_role``): two replicas at once, each rank 0 a process of its
   own that sees two cards (``CUDA_VISIBLE_DEVICES``, which its followers
   inherit), driven over a pipe. x1: llama3-70b int8 ``--kv-role
   prefill`` on ``tp2`` and ``--kv-role decode`` on ``tp2``: a 1900-token
   prompt to the decode server naming the prefill server in
   ``X-GPUStack-KV-Source``: 7 blocks exported (every rank's heads
   gathered to rank 0), pulled and imported (each rank's heads scattered),
   the 108-token tail prefilled at ``q_offset`` 1792 on both decode ranks;
   the frames against every rank's stored blocks on both replicas (bit for
   bit, sha256), every rank's tier, exact launches per rank, greedy ids
   against a cold run on the decode replica (phase g's rule), first-token
   logits warm against cold, a ``/kv/pull`` by tail key; handoff seconds
   and bytes, TTFT with the handoff beside a cold one, peak GB a rank;
   then the same with ``--kv-cache-int8`` on both sides. x2: mixtral-8x7b
   bf16 ``ep2`` to ``tp2`` (the cold run's expert picks replayed in the
   warm tail). x3: on x1's prefill replica and x2's ``ep2`` one,
   ``/v1/embeddings`` of 8 inputs at the 512 bucket (against the same
   replica's plain-attention forward at cosine 0.999) and ``/v1/rerank``
   (in the order of the returned vectors' cosines); then fp32 embeddings
   at full width cut to 4 layers under llama3-70b ``tp4`` and
   ``dp2xtp2`` and mixtral-8x7b ``ep2xtp2``, one process per GPU, within
   1e-4 of one card's (plain attention: the kernel is bf16).
y. (four GPUs; ``phase_sp_features``) the tier, speculation, handoffs
   and embeddings under ``sp4``.
z. image chats on multi-GPU replicas, four GPUs
   (``phase_vision_replica``): phase o's tower on rank 0 alone, each
   prompt's image rows broadcast from its card. z1 llama3-70b ``tp4`` and
   z2 mixtral-8x7b ``dp2xep2`` (bf16, full width and depth) through the
   server: an image prefill's logits against the plain attention on the
   same ranks (MoE picks replayed; under ``dp2`` on each group's slot),
   with its launches per rank; chats with a 64 x 64 PNG, a 97 x 53 one
   and a streamed one, image and text TTFT of one token count, counted
   on every rank; every rank's slot state the leader's; under ``dp2``
   the two chats on different groups and each group's K/V rows untouched
   by the other's; greedy ids against the runner called directly. z3
   qwen3-8b ``sp4`` at 32768: one request with an image in rank 0's
   segment and one in rank 2's, LSE launches ``(r + 1)`` × 36 on rank
   ``r``, its logits against one card's ``prefill_with_embeds``. z4:
   fp32 at 4 layers under ``tp4``, ``dp2xep2`` and ``sp4`` within 1e-4 of
   one card. Each line: the rows' broadcast bytes and ms, peak GB a rank.

In d to o every kernel's launches are counted around the served
requests alone and must equal what that path's model forwards need,
derived from the runners' calls (a draft model's too): the flash kernel
once per layer of every prefill and embedding forward of a model whose
config takes it (none with a sliding window, softcap or sinks: phases j
and k launch it never); on the int8 path the W8A16 kernel 7 per layer of
a dense model at M = B·T plus an untied lm_head at the rows it reads (a
prefill's last position, a decode step's slots, every position of a
verify block; none for an embedding; a tied lm_head is the bf16
embedding's transpose), never on a bf16 path, and counted per path by M:
M ≤ 16 the GEMV, above it the ``wgmma`` path; on an int8 MoE path the
2-D products of MLA's projections, the shared experts and a dense layer
too; on every MoE path the grouped kernel of its expert type
(``w8a16_grouped`` for int8 experts: phases i's int8 run and l;
``bf16_grouped`` for bf16 ones: phases h, i and j) three times per MoE
layer and token chunk, per path by the chunk's rows (0 on every other
path). Each kernel must launch on at least one path. The flash kernel's
launches are split by mode (``flash_causal``, ``flash_lse``): every
one-card path launches only the causal mode; phase t's ring launches the
LSE mode, counted per rank.

The last lines are the ``kernels`` line, the ``nvidia-smi`` name and
power-limit line, and ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

import base64
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import torch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
# bf16 kernel output against the fp32 plain version of the same bf16
# inputs: bf16 output rounding (2^-8 relative) plus the kernel's bf16
# probabilities in the P.V product
KERNEL_RTOL = KERNEL_ATOL = 2e-2
# the same error per output row (one q row of one head, d values), relative
# to the row's norm: late rows average v over ~2000 keys and have |out| of
# ~0.03, where the bound above would let a kernel be tens of percent wrong
KERNEL_ROW_RTOL = 1e-2
# last-position logits, kernel prefill vs plain prefill, llama3-8b bf16:
# 32 layers of bf16 activations amplify the attention rounding; bounded
# relative to the logit scale, and the two must point the same way
LOGIT_REL_TOL = 5e-2
LOGIT_MIN_COSINE = 0.999
# W8A16 bf16 output against the fp32 plain version of the same int8 and
# bf16 inputs: bf16 output rounding and the fp32 summation order; each
# output row also within 1% of its norm, so a wrong K slice or a missing
# scale cannot hide under the element bound
W8A16_RTOL = W8A16_ATOL = 2e-2
W8A16_ROW_RTOL = 1e-2
# llama3-8b's weight products, K x N ([in, out], the JAX layout)
LLAMA3_8B_MATMULS = {
    "wq/wo": (4096, 4096),
    "wk/wv": (4096, 1024),
    "w_gate/w_up": (4096, 14336),
    "w_down": (14336, 4096),
    "lm_head": (4096, 128256),
}
# gemma2-9b's (phase k's int8 path): head_dim 256 (16 q heads, 8 kv), d
# 3584, F 14336
GEMMA2_9B_MATMULS = {
    "wq": (3584, 4096),
    "wk/wv": (3584, 2048),
    "wo": (4096, 3584),
    "w_gate/w_up": (3584, 14336),
    "w_down": (14336, 3584),
}
# llama3-70b's weight products on one rank of its tp4 shard (phase s):
# column-split q/k/v, gate and up and the vocab-split lm_head, row-split o
# and down
LLAMA3_70B_TP4_MATMULS = {
    "wq": (8192, 2048),
    "wk/wv": (8192, 256),
    "wo": (2048, 8192),
    "w_gate/w_up": (8192, 7168),
    "w_down": (7168, 8192),
    "lm_head": (8192, 32064),
}
# mixtral-8x7b's experts on one rank of its ep2xtp2 shard (phase s): 4 of
# the 8 experts at half the expert width, as (E, top-k, local experts, K,
# N)
MIXTRAL_EP2TP2_GROUPED = {
    "we_gate/we_up": (8, 2, 4, 4096, 7168),
    "we_down": (8, 2, 4, 7168, 4096),
}
# the grouped expert kernel (the routed MoE products, one launch over the
# experts a token chunk picked) at the products the served MoE paths give
# it: (E, top-k, K, N, weight types served). int8 experts serve in phases h
# (its checkpoint), i and l; bf16 experts in phases h, i and j
GROUPED_PRODUCTS = {
    "mixtral-8x7b we_gate/we_up": (8, 2, 4096, 14336, ("int8",)),
    "mixtral-8x7b we_down": (8, 2, 14336, 4096, ("int8",)),
    "qwen3-30b-a3b we_gate/we_up": (128, 8, 2048, 768, ("int8", "bf16")),
    "qwen3-30b-a3b we_down": (128, 8, 768, 2048, ("int8", "bf16")),
    "deepseek-v2-lite we_gate/we_up": (64, 6, 2048, 1408, ("int8", "bf16")),
    "deepseek-v2-lite we_down": (64, 6, 1408, 2048, ("int8", "bf16")),
    "gpt-oss-20b we_gate/we_up/we_down": (32, 4, 2880, 2880, ("bf16",)),
}
# the weights a decode step reads back to back never sit in the 50 MB L2:
# time each shape over copies of its weight totalling at least this much
L2_FLUSH_BYTES = 128 * 2**20


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started (the
    run's time budget, phase by phase)."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us_per_call(fn, iters: int = 200) -> float:
    """Host wall clock per call over back-to-back enqueues (no sync
    between them; one at the end): above the device time, a row is
    host-bound."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


# ---------------------------------------------------------------------------
# a + b
# ---------------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return kind, smi


def _kernel_name(mangled: str) -> str:
    """``name`` or ``name<N, ...>`` from an Itanium-mangled kernel name:
    the last of its length-prefixed identifiers, with the ``int`` and
    ``bool`` template arguments that follow it."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while True:
        d = re.match(r"\d+", mangled[pos:])
        if not d:
            break
        start = pos + len(d.group())
        end = start + int(d.group())
        name, pos = mangled[start:end], end
    t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    if not t:
        return name
    args = re.findall(r"L([ib])(\d+)E", t.group(1))
    return name + "<" + ", ".join(
        v if kind == "i" else ("true" if v == "1" else "false")
        for kind, v in args
    ) + ">"


def _ptxas_kernels(log: str) -> dict:
    """{kernel: registers} from an ``-Xptxas -v`` log."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def phase_build():
    from gpustack_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(ptxas=True)
    seconds = time.perf_counter() - t0
    report = {
        name: {
            "registers": _ptxas_kernels(log),
            "spills": [
                line.strip() for line in log.splitlines()
                if "spill" in line and "0 bytes spill stores, 0 bytes "
                "spill loads" not in line
            ],
            # C7508: ptxas could not place setmaxnreg and ignored it
            "setmaxnreg_applied": "C7508" not in log
            and "setmaxnreg ignored" not in log,
            # C75xx "Potential Performance Loss": each wgmma waits for the
            # one before it
            "wgmma_serialized": [
                line.strip() for line in log.splitlines()
                if "wgmma" in line and "serialized" in line
            ],
            "warnings": [
                line.strip() for line in log.splitlines()
                if "warning" in line.lower()
            ],
        }
        for name, log in logs.items()
    }
    emit("build", seconds=seconds, sources=_build.sources(), ptxas=report)


# ---------------------------------------------------------------------------
# c: kernels against their plain versions
# ---------------------------------------------------------------------------


def _check_flash(out, q, k, v, scale, off):
    from gpustack_tpu_torch.ops import flash_attention as fa

    ref = fa.flash_attention_prefill_ref(
        q.float(), k.float(), v.float(), scale, off
    )
    err = (out.float() - ref).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    rows = ref.reshape(*ref.shape[:2], q.shape[2], q.shape[3])
    row_rel = (
        (out.float().reshape(rows.shape) - rows).norm(dim=-1)
        / rows.norm(dim=-1).clamp_min(1e-30)
    ).max().item()
    if (
        not torch.isfinite(out.float()).all() or bad.any()
        or not row_rel <= KERNEL_ROW_RTOL
    ):
        raise AssertionError(
            f"flash kernel disagrees at {tuple(q.shape)} k {tuple(k.shape)} "
            f"offset {off}: max |err| {err.max().item()} "
            f"({int(bad.sum())} elements outside tolerance), max row "
            f"|err|/|ref| {row_rel}"
        )
    return err.max().item(), row_rel


def _flash_case(B, T, S, off, Hq, Hkv, d, gen, repeats=1):
    from gpustack_tpu_torch.ops import flash_attention as fa

    q = torch.randn(B, T, Hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    out = fa.flash_attention_prefill(q, k, v, scale, off)
    torch.cuda.synchronize()
    max_err, row_rel = _check_flash(out, q, k, v, scale, off)

    def kernel():
        return fa.flash_attention_prefill(q, k, v, scale, off)

    ms_runs = [cuda_time_ms(kernel) for _ in range(repeats)]
    host_us = host_us_per_call(kernel)
    plain_ms = cuda_time_ms(
        lambda: fa.flash_attention_prefill_ref(q, k, v, scale, off),
        warmup=1, iters=5,
    )
    # one library call computing the same function (yardstick only)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if off == 0 and T == S:
        mask = None
    else:
        mask = (
            torch.arange(S, device="cuda")[None, :]
            <= off + torch.arange(T, device="cuda")[:, None]
        )
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, is_causal=mask is None,
            scale=scale, enable_gqa=True,
        )
    )
    # least time: each input read once, the output written once; the
    # operations this causal offset needs (two products per visible pair)
    pairs = sum(min(S, off + t + 1) for t in range(T))
    flops = 4 * B * Hq * d * pairs
    nbytes = 2 * (2 * B * T * Hq * d + 2 * B * S * Hkv * d)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    ms = statistics.median(ms_runs)
    return {
        "shape": {"B": B, "T": T, "S": S, "q_offset": off, "Hq": Hq,
                  "Hkv": Hkv, "d": d},
        "max_abs_err": max_err, "max_row_rel_err": row_rel,
        "ms": ms, "ms_runs": ms_runs, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "host_us_per_call": host_us,
        "limited_by": "host" if host_us / 1e3 >= ms else "device",
        "tflops": flops / ms / 1e9,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


# the flash kernel's LSE mode (a ring block): its fp32 log-sum-exp
# against the fp32 plain version's, absolute (the output keeps the
# standing kernel gate)
LSE_ATOL = 1e-3
# (B, T, S, q_offset, Hq, Hkv, d): llama3-8b's heads at the 2048 bucket;
# qwen3-8b's on the three blocks of an sp4 ring over 32768 tokens (T_loc
# 8192): the diagonal, the neighbour's block, the farthest one
LSE_CASES = [
    (1, 2048, 2048, 0, 32, 8, 128),
    (1, 8192, 8192, 0, 32, 8, 128),
    (1, 8192, 8192, 8192, 32, 8, 128),
    (1, 8192, 8192, 3 * 8192, 32, 8, 128),
]
# plain-version query rows at a time (its fp32 scores and probabilities)
LSE_REF_ROWS = 2048


def _lse_ref(q, k, v, scale, off, rows=LSE_REF_ROWS):
    """The LSE mode's plain version on the card, in query-row chunks (at
    8192 x 8192 x 32 heads its fp32 scores alone are 8.6 GB)."""
    from gpustack_tpu_torch.ops import flash_attention as fa

    outs, lses = [], []
    for t in range(0, q.shape[1], rows):
        o, lse = fa.flash_attention_lse_ref(
            q[:, t:t + rows], k, v, scale, off + t)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def _check_lse(out, lse, q, ref, ref_lse, what):
    """The standing kernel gate on the fp32 output (each element, then
    each row against its norm) and ``LSE_ATOL`` on the log-sum-exp."""
    err = (out - ref).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    shape = (*ref.shape[:2], q.shape[2], q.shape[3])
    row_rel = ((out.reshape(shape) - ref.reshape(shape)).norm(dim=-1)
               / ref.reshape(shape).norm(dim=-1).clamp_min(1e-30)).max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    if (not torch.isfinite(out).all() or not torch.isfinite(lse).all()
            or bad.any() or not row_rel <= KERNEL_ROW_RTOL
            or not lse_err <= LSE_ATOL):
        raise AssertionError(
            f"{what}: max |err| {err.max().item()} ({int(bad.sum())} "
            f"outside tolerance), max row |err|/|ref| {row_rel}, max LSE "
            f"|err| {lse_err}"
        )
    return err.max().item(), row_rel, lse_err


def _sdpa_lse_ms(q, k, v, scale, causal):
    """SDPA's flash backend with its logsumexp, the yardstick of the LSE
    mode: K/V repeated to the query heads ahead of the timing (the
    backend takes no GQA). None, with the reason, where the backend
    refuses the call."""
    G = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))

    def call():
        return torch.ops.aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, causal, False, scale=scale)

    try:
        call()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return cuda_time_ms(call), None


def _lse_case(B, T, S, off, Hq, Hkv, d, gen):
    """The LSE mode against its plain version at one shape: the output's
    kernel gate and the LSE's ``LSE_ATOL``; ms beside the causal mode's
    call at the same shape, the plain version, SDPA's flash backend with
    its logsumexp and the bound (inputs read once, fp32 output and LSE
    written once; the operations of the visible pairs)."""
    from gpustack_tpu_torch.ops import flash_attention as fa

    q = torch.randn(B, T, Hq, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16()
    scale = d ** -0.5
    out, lse = fa.flash_attention_lse(q, k, v, scale, off)
    torch.cuda.synchronize()
    ref, ref_lse = _lse_ref(q, k, v, scale, off)
    max_err, row_rel, lse_err = _check_lse(
        out, lse, q, ref, ref_lse, f"flash LSE mode at {(B, T, S, off)}")
    del ref, ref_lse
    ms = cuda_time_ms(lambda: fa.flash_attention_lse(q, k, v, scale, off))
    causal_ms = cuda_time_ms(
        lambda: fa.flash_attention_prefill(q, k, v, scale, off))
    plain_ms = cuda_time_ms(lambda: _lse_ref(q, k, v, scale, off),
                            warmup=1, iters=2)
    # the diagonal block is causal; a block wholly below it is not
    library_ms, library_refused = (
        _sdpa_lse_ms(q, k, v, scale, True) if off == 0 and T == S
        else _sdpa_lse_ms(q, k, v, scale, False) if off >= S
        else (None, "no SDPA call takes this offset")
    )
    pairs = sum(min(S, off + t + 1) for t in range(T))
    flops = 4 * B * Hq * d * pairs
    nbytes = 2 * (B * T * Hq * d + 2 * B * S * Hkv * d) + 4 * (
        B * T * Hq * d + B * Hq * T)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {
        "shape": {"B": B, "T": T, "S": S, "q_offset": off, "Hq": Hq,
                  "Hkv": Hkv, "d": d},
        "max_abs_err": max_err, "max_row_rel_err": row_rel,
        "max_lse_abs_err": lse_err, "ms": ms, "causal_mode_ms": causal_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "aten._scaled_dot_product_flash_attention "
                        "(logsumexp), K/V repeated to Hq",
        "library_refused": library_refused,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flops / ms / 1e9,
    }


def phase_kernels():
    """Returns {kernel name: the row for the main path's shape}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # llama3-8b attention widths (32 q heads, 8 kv heads, d 128): every
    # bucket the main path fills (2048 long prompts, 1024 the logit check,
    # 64 the chats, 32 the short decode-rate prompts), a chunk
    # continuation against a 2048 cache, and a ragged T
    cases = [
        (1, 2048, 2048, 0, 32, 8, 128),
        (1, 1024, 1024, 0, 32, 8, 128),
        (1, 64, 64, 0, 32, 8, 128),
        (1, 32, 32, 0, 32, 8, 128),
        (1, 512, 2048, 1536, 32, 8, 128),
        (1, 1000, 1000, 0, 32, 8, 128),
        # continuations phase e serves: a 512 chunk at 1024, a 32-token
        # suffix after a 256-block prefix hit, and offsets off the
        # kernel's 128-row/128-key tiles (16-token block granularity)
        (1, 512, 2048, 1024, 32, 8, 128),
        (1, 32, 2048, 1792, 32, 8, 128),
        (1, 64, 1024, 784, 32, 8, 128),
        (1, 128, 2048, 1888, 32, 8, 128),
        # embedding forwards (phase g): cacheless, the batch padded to a
        # power of two, T = S = the bucket
        (8, 2048, 2048, 0, 32, 8, 128),
        (4, 2048, 2048, 0, 32, 8, 128),
        (2, 512, 512, 0, 32, 8, 128),
        (8, 64, 64, 0, 32, 8, 128),
        # qwen3-30b-a3b (phase h): 32 q heads on 4 kv heads, a group of 8,
        # at every bucket phase h fills
        (1, 2048, 2048, 0, 32, 4, 128),
        (1, 1024, 1024, 0, 32, 4, 128),
        (1, 64, 64, 0, 32, 4, 128),
        (1, 32, 32, 0, 32, 4, 128),
        # deepseek-v2-lite (phase i): MLA served decompressed, 16 heads at
        # d 192 (64-key tiles, 3 stages), at every bucket phase i fills, a
        # continuation and its cacheless embedding batch
        (1, 2048, 2048, 0, 16, 16, 192),
        (1, 1024, 1024, 0, 16, 16, 192),
        (1, 64, 64, 0, 16, 16, 192),
        (1, 32, 32, 0, 16, 16, 192),
        (1, 512, 2048, 1536, 16, 16, 192),
        (8, 2048, 2048, 0, 16, 16, 192),
        # d 64 (no served model has it): its code and time are kept
        (1, 2048, 2048, 0, 32, 8, 64),
        # Gemma 1 at d 256 (64-key tiles, 2 stages): gemma-7b's heads (16
        # q on 16 kv) at every bucket phase m fills, a continuation and
        # its cacheless embedding batch; gemma-2b's (8 q on 1 kv)
        (1, 2048, 2048, 0, 16, 16, 256),
        (1, 1024, 1024, 0, 16, 16, 256),
        (1, 64, 64, 0, 16, 16, 256),
        (1, 32, 32, 0, 16, 16, 256),
        (1, 512, 2048, 1536, 16, 16, 256),
        (8, 2048, 2048, 0, 16, 16, 256),
        (1, 2048, 2048, 0, 8, 1, 256),
        # a llama3-70b tp4 rank's heads (16 q on 2 kv) continuing a
        # 1792-token host-tier hit by a 256-token bucket (phase w)
        (1, 256, 2048, 1792, 16, 2, 128),
        # a tp2 decode rank's heads after a handed-off 1792-token prefix,
        # the 108-token tail in its 128 bucket (phase x): llama3-70b's
        # (32 q on 4 kv), mixtral-8x7b's (16 q on 4 kv)
        (1, 128, 2048, 1792, 32, 4, 128),
        (1, 128, 2048, 1792, 16, 4, 128),
    ]
    group8 = cases.index((1, 2048, 2048, 0, 32, 4, 128))
    tp4_cont = cases.index((1, 256, 2048, 1792, 16, 2, 128))
    tp2_cont = cases.index((1, 128, 2048, 1792, 32, 4, 128))
    mla = cases.index((1, 2048, 2048, 0, 16, 16, 192))
    gemma7b = cases.index((1, 2048, 2048, 0, 16, 16, 256))
    gemma7b_cont = cases.index((1, 512, 2048, 1536, 16, 16, 256))
    gemma2b = cases.index((1, 2048, 2048, 0, 8, 1, 256))
    rows = [
        _flash_case(*c, gen, repeats=3 if i in (
            0, group8, mla, gemma7b, gemma2b, tp4_cont, tp2_cont) else 1)
        for i, c in enumerate(cases)
    ]
    from gpustack_tpu_torch.ops import _build
    from gpustack_tpu_torch.ops import flash_attention as fa
    from gpustack_tpu_torch.ops import w8a16

    smem = _build.load("flash_attention").flash_prefill_smem_bytes
    emit("kernels", name="flash_attention_prefill",
         tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
                    "row_rtol": KERNEL_ROW_RTOL},
         smem_bytes_per_cta={d: smem(d) for d in fa.SUPPORTED_HEAD_DIMS},
         cases=rows)
    lse_rows = [_lse_case(*c, gen) for c in LSE_CASES]
    _free()
    emit("kernels", name="flash_attention_prefill", mode="lse",
         tolerance={"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
                    "row_rtol": KERNEL_ROW_RTOL, "lse_atol": LSE_ATOL},
         cases=lse_rows)
    # W8A16 at the shapes the int8 path gives it: decode (8 slots) for
    # every weight and the prefill's last position through lm_head (the
    # GEMV); the 2048 bucket, a 512 chunk and a 64-token bucket for every
    # layer weight (the wgmma path)
    layer_weights = ("w_gate/w_up", "w_down", "wq/wo", "wk/wv")
    w8_cases = [(8, *LLAMA3_8B_MATMULS[n], n) for n in (
        "w_gate/w_up", "wq/wo", "wk/wv", "w_down", "lm_head",
    )] + [(1, *LLAMA3_8B_MATMULS["lm_head"], "lm_head")] + [
        (M, *LLAMA3_8B_MATMULS[n], n)
        for M in (2048, 512, 64) for n in layer_weights
    ] + [
        # a speculative verify block (8 slots x 4 positions), lm_head too
        (32, *LLAMA3_8B_MATMULS[n], n)
        for n in layer_weights + ("lm_head",)
    ] + [
        # gemma2-9b's int8 path (phase k): a decode step's 8 slots and the
        # 2048 bucket, every layer weight (its tied lm_head stays bf16)
        (M, *GEMMA2_9B_MATMULS[n], f"gemma2-9b {n}")
        for M in (8, 2048) for n in GEMMA2_9B_MATMULS
    ]
    large = w8_cases.index((2048, *LLAMA3_8B_MATMULS["w_gate/w_up"],
                            "w_gate/w_up"))
    gemma2 = w8_cases.index((2048, *GEMMA2_9B_MATMULS["w_gate/w_up"],
                             "gemma2-9b w_gate/w_up"))
    w8_rows = [
        _w8a16_case(*c, gen, repeats=3 if i in (0, large, gemma2) else 1)
        for i, c in enumerate(w8_cases)
    ]
    # ragged shapes, checked only: M, N and K off the tiles (N % 16 but not
    # % 64, K % 8 but not % 64), q a column slice of a wider stacked layer
    # (rows ldq != N apart), x rows wider than K
    ragged = [
        _w8a16_check_strided(M, K, N, gen)
        for M, K, N in ((17, 4104, 4112), (100, 4104, 1040),
                        (2048, 4104, 4112), (333, 14336, 4112))
    ]
    smem = _build.load("w8a16_gemm").w8a16_wgmma_smem_bytes
    emit("kernels", name="w8a16_matmul",
         tolerance={"rtol": W8A16_RTOL, "atol": W8A16_ATOL,
                    "row_rtol": W8A16_ROW_RTOL},
         wgmma_smem_bytes_per_cta={bn: smem(bn) for bn in (128, 256)},
         cases=w8_rows, ragged=ragged)
    # the grouped kernel at a decode step's 8 slots (the GEMV) and the 2048
    # bucket (the wgmma path), each segment against the fp32 plain version;
    # then the routings that stress the segments, checked only
    grouped = {"int8": {}, "bf16": {}}
    for weight, (E, k, K, N, types) in GROUPED_PRODUCTS.items():
        for wtype in types:
            for n in (8, 2048):
                grouped[wtype][weight, n] = _grouped_case(
                    n, E, k, K, N, weight, wtype, gen,
                    repeats=3 if n == 2048 else 1,
                )
    # timed diagnostics, no gate on their times: bf16 at mixtral-8x7b's
    # two int8 shapes (the schedule without the widening stage) and
    # qwen3-30b-a3b's bf16 products with half the pairs on a quarter of
    # the experts, all at the 2048 bucket
    diagnostics = [
        _grouped_case(2048, E, k, K, N, f"{weight} (bf16 at the int8 shape)",
                      "bf16", gen)
        for weight in ("mixtral-8x7b we_gate/we_up", "mixtral-8x7b we_down")
        for E, k, K, N, _ in [GROUPED_PRODUCTS[weight]]
    ] + [
        _grouped_case(2048, E, k, K, N, weight, "bf16", gen,
                      routing="skewed")
        for weight in ("qwen3-30b-a3b we_gate/we_up",
                       "qwen3-30b-a3b we_down")
        for E, k, K, N, _ in [GROUPED_PRODUCTS[weight]]
    ]
    stages = _build.load("w8a16_gemm").w8a16_grouped_stages
    for wtype in grouped:
        ragged = [
            _grouped_case(n, E, k, 4096, 1024, f"ragged {routing}", wtype,
                          gen, routing=routing, timed=False)
            for routing, n, E, k in (
                ("empty", 300, 8, 2), ("empty", 12, 8, 2),
                ("one", 300, 8, 1), ("one", 16, 8, 1),
                ("midtile", 500, 4, 2), ("random", 1, 8, 2),
                ("random", 17, 16, 4),
            )
        ]
        emit("kernels", name=GROUPED_WRAPPERS[wtype],
             tolerance={"rtol": W8A16_RTOL, "atol": W8A16_ATOL,
                        "row_rtol": W8A16_ROW_RTOL},
             stages_per_unit_shape={
                 f"{bm}x{bn}": stages(bm, bn)
                 for bm in ((128,) if wtype == "int8" else (64, 128))
                 for bn in w8a16.GROUPED_BN[wtype]},
             cases=list(grouped[wtype].values()), ragged=ragged,
             **({"diagnostics": diagnostics} if wtype == "bf16" else {}))
    _shard_cases(gen)
    return {"flash_attention_prefill": rows[0], "w8a16_matmul": w8_rows[0],
            "w8a16_grouped": grouped["int8"][
                "mixtral-8x7b we_gate/we_up", 2048],
            "bf16_grouped": grouped["bf16"][
                "qwen3-30b-a3b we_gate/we_up", 2048],
            "w8a16_large_m": w8_rows[large], "w8a16_gemma2": w8_rows[gemma2],
            "grouped_cases": grouped,
            "flash_group8": rows[group8], "flash_mla": rows[mla],
            "flash_gemma7b": rows[gemma7b],
            "flash_gemma7b_continuation": rows[gemma7b_cont],
            "flash_gemma2b": rows[gemma2b],
            "flash_tp4_continuation": rows[tp4_cont],
            "flash_tp2_continuation": rows[tp2_cont], "flash_lse": lse_rows}


def _shard_cases(gen):
    """The kernels at the shapes phase s gives one rank, checked only (on
    one card, so the one-card smoke holds them too): W8A16 at llama3-70b's
    tp4 shards for a decode step (M = 8), phase s's 512-token int8 forward
    and the 2048 bucket (lm_head at a prefill's last position, 8 and 512);
    ``bf16_grouped`` as an ``ep`` rank of mixtral-8x7b's ep2xtp2 runs it:
    the pairs routed over all 8 experts, the kernel given the rank's 4
    experts and its slice of the offsets, at 8 and 2048 tokens."""
    w8 = [
        dict(_w8a16_check_strided(M, K, N, gen, strided=False), weight=name)
        for name, (K, N) in LLAMA3_70B_TP4_MATMULS.items()
        for M in ((1, 8, 512) if name == "lm_head" else (8, 512, 2048))
    ]
    grouped = [
        _grouped_shard_case(n, E, k, e0, E_loc, K, N, name, gen)
        for name, (E, k, E_loc, K, N) in MIXTRAL_EP2TP2_GROUPED.items()
        for n in (8, 2048) for e0 in (0, E_loc)
    ]
    emit("kernels_shards",
         tolerance={"rtol": W8A16_RTOL, "atol": W8A16_ATOL,
                    "row_rtol": W8A16_ROW_RTOL},
         w8a16_matmul={"model": "llama3-70b", "plan": "tp4", "cases": w8},
         bf16_grouped={"model": "mixtral-8x7b", "plan": "ep2xtp2",
                       "cases": grouped})


def _grouped_shard_case(n, E, k, e0, E_loc, K, N, weight, gen):
    """``bf16_grouped`` as an ``ep`` rank runs it (``_moe_mlp`` on a
    mesh): ``n`` tokens' top-``k`` pairs sorted over all ``E`` experts,
    the kernel given only the ``E_loc`` local experts' weights and
    ``offsets[e0:e0 + E_loc + 1]``, so its rows start mid-array and the
    other ranks' rows stay unwritten; each local segment held to its fp32
    plain product."""
    from gpustack_tpu_torch.models import transformer as tf
    from gpustack_tpu_torch.ops import w8a16

    top = _grouped_routing(n, E, k, "random", gen)
    perm, offsets, _ = tf.moe_dispatch(top, E)
    local = offsets[e0:e0 + E_loc + 1].clone()
    xs = torch.randn(n, K, generator=gen, device="cuda").bfloat16()[
        perm // k
    ].contiguous()
    w = (torch.randn(E_loc, K, N, generator=gen, device="cuda")
         / K ** 0.5).bfloat16()
    out = w8a16.bf16_grouped(xs, w, local, n)
    torch.cuda.synchronize()
    max_err, row_rel = _check_grouped(out, xs, w, None, local)
    bounds = local.tolist()
    return {"weight": weight, "shape": {"E": E, "E_local": E_loc, "e0": e0,
                                        "k": k, "n": n, "P": n * k, "K": K,
                                        "N": N},
            "local_rows": [bounds[0], bounds[-1]],
            "max_abs_err": max_err, "max_row_rel_err": row_rel}


def _check_w8a16(out, x, q, s):
    from gpustack_tpu_torch.ops import w8a16

    ref = w8a16.w8a16_plain(x.float(), q, s)
    err = (out.float() - ref).abs()
    bad = err > W8A16_ATOL + W8A16_RTOL * ref.abs()
    row_rel = (
        err.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    ).max().item()
    if (
        not torch.isfinite(out.float()).all() or bad.any()
        or not row_rel <= W8A16_ROW_RTOL
    ):
        raise AssertionError(
            f"W8A16 kernel disagrees at x {tuple(x.shape)} q "
            f"{tuple(q.shape)}: max |err| {err.max().item()} "
            f"({int(bad.sum())} elements outside tolerance), max row "
            f"|err|/|ref| {row_rel}"
        )
    return err.max().item(), row_rel


def _rotating(fn, args):
    """A call that walks ``args`` round robin, one set per call."""
    state = {"i": 0}

    def call():
        a = args[state["i"] % len(args)]
        state["i"] += 1
        return fn(*a)

    return call


def _int8pack_ms(x, qs, s):
    """The one CUDA call torch might offer for this function:
    ``torch._weight_int8pack_mm`` (q as [N, K]), a few calls only above
    the decode shapes (it takes ~0.26 s at 2048 x 4096 x 14336). Returns
    (ms or None, what was timed or why nothing was)."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "this torch has no _weight_int8pack_mm"
    qts = [q.T.contiguous() for q in qs]
    try:
        out = fn(x, qts[0], s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, (
            "torch._weight_int8pack_mm refused the card's tensors: "
            + str(e).strip().splitlines()[0][:200]
        )
    try:
        _check_w8a16(out, x, qts[0].T, s)
    except AssertionError as e:
        return None, f"torch._weight_int8pack_mm computes another function: {e}"
    few = x.shape[0] > 16
    return cuda_time_ms(
        _rotating(fn, [(x, qt, s) for qt in qts]),
        warmup=1 if few else 3, iters=3 if few else 20,
    ), "torch._weight_int8pack_mm"


def _w8a16_case(M, K, N, weight, gen, repeats=1):
    from gpustack_tpu_torch.ops import w8a16

    x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
    q = torch.randint(
        -127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8
    )
    # the int8 init's scale (3 / sqrt(fan_in) / 127), jittered per channel
    s = (
        (0.5 + torch.rand(N, generator=gen, device="cuda"))
        * (3.0 / K ** 0.5 / 127.0)
    ).bfloat16()
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    max_err, row_rel = _check_w8a16(out, x, q, s)
    copies = max(1, -(-L2_FLUSH_BYTES // (K * N)))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    kernel = _rotating(w8a16.w8a16_matmul, [(x, qi, s) for qi in qs])
    ms_runs = [cuda_time_ms(kernel) for _ in range(repeats)]
    host_us = host_us_per_call(kernel)
    plain_ms = cuda_time_ms(
        lambda: w8a16.w8a16_plain(x, q, s), warmup=1, iters=3
    )
    # yardsticks the port never calls: cuBLAS on the weight dequantized
    # ahead of time (what bf16 serving pays), and the eager line
    ws = [(qi.float() * s.float()).bfloat16() for qi in qs]
    cublas_ms = cuda_time_ms(_rotating(torch.matmul, [(x, w) for w in ws]))
    del ws
    eager_ms = cuda_time_ms(_rotating(
        lambda xi, qi, si: (xi @ qi.to(torch.bfloat16)) * si,
        [(x, qi, s) for qi in qs],
    ))
    library_ms, library_call = _int8pack_ms(x, qs, s)
    del qs
    flops = 2 * M * N * K
    nbytes = M * K * 2 + K * N + N * 2 + M * N * 2
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    ms = statistics.median(ms_runs)
    sms = w8a16._sm_count(q.device.index)
    if M <= w8a16.GEMV_MAX_M:
        ksplit = w8a16.gemv_plan(N, K, sms)[1]
        plan = {"path": "gemv", "ksplit": ksplit,
                "ctas": -(-N // w8a16.GEMV_BN) * ksplit,
                "ctas_per_sm": w8a16._kernel_lib().w8a16_gemv_ctas_per_sm(M)}
    else:
        bn, grid_m, grid_n, _, ksplit = w8a16.wgmma_plan(M, N, K, sms)
        ctas = grid_m * grid_n * ksplit
        plan = {"path": "wgmma", "bn": bn, "ksplit": ksplit, "ctas": ctas,
                "waves": ctas / sms}
    return {
        "weight": weight, "shape": {"M": M, "K": K, "N": N}, **plan,
        "max_abs_err": max_err, "max_row_rel_err": row_rel,
        "ms": ms, "ms_runs": ms_runs, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_call": library_call,
        "cublas_bf16_dequantized_ms": cublas_ms, "eager_dequant_ms": eager_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "host_us_per_call": host_us,
        "limited_by": "host" if host_us / 1e3 >= ms else "device",
        "weight_copies_timed": copies,
        "gbytes_per_s": nbytes / ms / 1e6, "tflops": flops / ms / 1e9,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


def _grouped_routing(n, E, k, routing, gen):
    """A seeded top-k pick of ``n`` tokens over ``E`` experts: uniform
    scores ("random"), expert 0 never picked ("empty"), every token's
    first pick the last expert ("one"), 200 tokens on expert 0 (a segment
    ending mid-tile, "midtile"), or half of every token's picks among a
    quarter of the experts ("skewed")."""
    scores = torch.rand(n, E, generator=gen, device="cuda")
    if routing == "skewed":
        hot = E // 4
        return torch.cat([scores[:, :hot].topk(k // 2, dim=-1).indices,
                          hot + scores[:, hot:].topk(k - k // 2,
                                                     dim=-1).indices], 1)
    if routing == "empty":
        scores[:, 0] = -1.0
    elif routing == "one":
        scores[:, E - 1] = 2.0
    elif routing == "midtile":
        scores[:200, 0] = 2.0
    return scores.topk(k, dim=-1).indices


def _check_grouped(out, xs, w, s, offsets):
    """Each expert's segment against its fp32 plain product (int8: the
    W8A16 plain version), with the W8A16 bounds."""
    bounds = offsets.tolist()
    worst = (0.0, 0.0)
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b == a:
            continue
        if s is not None:
            got = _check_w8a16(out[a:b], xs[a:b], w[e], s[e])
        else:
            ref = xs[a:b].float() @ w[e].float()
            err = (out[a:b].float() - ref).abs()
            row_rel = (err.norm(dim=-1)
                       / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
            if (not torch.isfinite(out[a:b].float()).all()
                    or (err > W8A16_ATOL + W8A16_RTOL * ref.abs()).any()
                    or not row_rel <= W8A16_ROW_RTOL):
                raise AssertionError(
                    f"bf16 grouped kernel disagrees at expert {e} of "
                    f"{tuple(w.shape)}, rows {b - a}: max |err| "
                    f"{err.max().item()}, max row |err|/|ref| {row_rel}"
                )
            got = err.max().item(), row_rel
        worst = max(worst[0], got[0]), max(worst[1], got[1])
    return worst


def _grouped_mm_ms(xs, ws, s, offsets):
    """``torch._grouped_mm`` (bf16; on the weights dequantized ahead of
    time for int8), the one PyTorch call for a routed expert product: a
    yardstick the port never calls. Returns (ms or None, what was timed or
    why nothing was)."""
    from gpustack_tpu_torch.ops import w8a16

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "this torch has no torch._grouped_mm"
    if s is not None:
        ws = [(wi.float() * s.float()[:, None, :]).bfloat16() for wi in ws]
    offs = offsets[1:].contiguous()
    try:
        out = fn(xs, ws[0], offs=offs)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, ("torch._grouped_mm refused the card's tensors: "
                      + str(e).strip().splitlines()[0][:200])
    ref = w8a16.bf16_grouped_plain(xs, ws[0], offsets).float()
    if (out.float() - ref).abs().max().item() > 2e-2 * (
        1 + ref.abs().max().item()
    ):
        return None, "torch._grouped_mm computes another function"
    return cuda_time_ms(_rotating(
        lambda xi, wi: fn(xi, wi, offs=offs), [(xs, wi) for wi in ws]
    )), "torch._grouped_mm"


def _grouped_case(n, E, k, K, N, weight, wtype, gen, routing="random",
                  timed=True, repeats=1):
    """One grouped product of ``n`` tokens' top-``k`` pairs over ``E``
    experts (``wtype`` "int8" or "bf16" weights [E, K, N]), x gathered in
    the routed order as ``_moe_mlp`` gives it: every segment held to the
    fp32 plain version; with ``timed``, the kernel timed over copies of
    the weight of >= 128 MiB in all (CUDA events) beside its plain
    version, ``torch._grouped_mm`` and the bound for the rows and experts
    this routing reaches."""
    from gpustack_tpu_torch.models import transformer as tf
    from gpustack_tpu_torch.ops import w8a16

    bf16w = wtype == "bf16"
    top = _grouped_routing(n, E, k, routing, gen)
    perm, offsets, _ = tf.moe_dispatch(top, E)
    xs = torch.randn(n, K, generator=gen, device="cuda").bfloat16()[
        perm // k
    ].contiguous()
    if bf16w:
        w = (torch.randn(E, K, N, generator=gen, device="cuda")
             / K ** 0.5).bfloat16()
        s = None

        def call(xi, wi):
            return w8a16.bf16_grouped(xi, wi, offsets, n)

        def plain():
            return w8a16.bf16_grouped_plain(xs, w, offsets)
    else:
        w = torch.randint(-127, 128, (E, K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = ((0.5 + torch.rand(E, N, generator=gen, device="cuda"))
             * (3.0 / K ** 0.5 / 127.0)).bfloat16()

        def call(xi, wi):
            return w8a16.w8a16_grouped(xi, wi, s, offsets, n)

        def plain():
            return w8a16.w8a16_grouped_plain(xs, w, s, offsets)
    out = call(xs, w)
    torch.cuda.synchronize()
    max_err, row_rel = _check_grouped(out, xs, w, s, offsets)
    bounds = offsets.tolist()
    reached = sum(b > a for a, b in zip(bounds, bounds[1:]))
    P = n * k
    row = {"weight": weight, "experts": wtype, "routing": routing,
           "shape": {"E": E, "k": k, "n": n, "P": P, "K": K, "N": N},
           "experts_reached": reached,
           "max_rows_per_expert": max(b - a for a, b in zip(bounds,
                                                            bounds[1:])),
           "max_abs_err": max_err, "max_row_rel_err": row_rel}
    if not timed:
        return row
    copies = max(1, -(-L2_FLUSH_BYTES // (w.numel() * w.element_size())))
    ws = [w] + [w.clone() for _ in range(copies - 1)]
    kernel = _rotating(call, [(xs, wi) for wi in ws])
    ms_runs = [cuda_time_ms(kernel) for _ in range(repeats)]
    host_us = host_us_per_call(kernel)
    plain_ms = cuda_time_ms(plain, warmup=1, iters=3)
    library_ms, library_call = _grouped_mm_ms(xs, ws, s, offsets)
    del ws
    # the routed work: every pair's row of x read once, the weights (and
    # int8 scales) of the experts reached once, the offsets, the output
    wb = 2 if bf16w else 1
    flops = 2 * P * K * N
    nbytes = (P * K * 2 + reached * K * N * wb
              + (0 if bf16w else reached * N * 2) + (E + 1) * 4 + P * N * 2)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    ms = statistics.median(ms_runs)
    sms = w8a16._sm_count(w.device.index)
    if n <= w8a16.GEMV_MAX_M:
        ksplit = w8a16.gemv_plan(N, K, sms, min(E, P))[1]
        plan = {"path": "gemv", "ksplit": ksplit,
                "ctas": E * -(-N // w8a16.GEMV_BN) * ksplit,
                "working_ctas": reached * -(-N // w8a16.GEMV_BN) * ksplit}
    else:
        # the persistent kernel: units of bm x bn outputs (the routing's
        # count, read here on the host for the report only), ctas CTAs
        bm, bn, grid = w8a16.grouped_plan(P, E, N, sms, not bf16w)
        units = sum(-(-(b - a) // bm)
                    for a, b in zip(bounds, bounds[1:])) * -(-N // bn)
        plan = {"path": "wgmma", "bm": bm, "bn": bn, "units": units,
                "ctas": grid, "waves": units / grid}
    return {
        **row, **plan,
        "ms": ms, "ms_runs": ms_runs, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_call": library_call,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "host_us_per_call": host_us,
        "limited_by": "host" if host_us / 1e3 >= ms else "device",
        "weight_copies_timed": copies,
        "gbytes_per_s": nbytes / ms / 1e6, "tflops": flops / ms / 1e9,
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


def _w8a16_check_strided(M, K, N, gen, strided=True):
    """One product held to the plain version, on strided views: q columns
    [0, N) of layer 1 of a stacked [2, K, N + 48] weight, x columns [0, K)
    of [M, K + 64] (``strided`` False: on whole tensors)."""
    from gpustack_tpu_torch.ops import w8a16

    pad_x, pad_q = (64, 48) if strided else (0, 0)
    xw = torch.randn(M, K + pad_x, generator=gen, device="cuda").bfloat16()
    qw = torch.randint(-127, 128, (2, K, N + pad_q), generator=gen,
                       device="cuda", dtype=torch.int8)
    s = ((0.5 + torch.rand(N, generator=gen, device="cuda"))
         * (3.0 / K ** 0.5 / 127.0)).bfloat16()
    x, q = xw[:, :K], qw[1][:, :N]
    out = w8a16.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    max_err, row_rel = _check_w8a16(out, x, q, s)
    return {"shape": {"M": M, "K": K, "N": N}, "ldx": xw.stride(0),
            "ldq": q.stride(0), "max_abs_err": max_err,
            "max_row_rel_err": row_rel}


KERNEL_META = {
    "flash_attention_prefill": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "gpustack_tpu/ops/flash_attention.py:39",
    },
    # no Pallas kernel behind it: the int8 branch of the JAX _mm, an XLA
    # fusion
    "w8a16_matmul": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/w8a16_gemm.cu",
        "replaces": "gpustack_tpu/models/transformer.py:46",
    },
    # the expert products of the JAX _moe_mlp's dense dispatch (_mm or
    # einsum over the expert axis, XLA products), routed: the same source's
    # grouped entries, int8 experts and bf16 ones
    "w8a16_grouped": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/w8a16_gemm.cu",
        "replaces": "gpustack_tpu/models/transformer.py:487",
    },
    "bf16_grouped": {
        "route": "cuda",
        "source": "gpustack_tpu_torch/ops/csrc/w8a16_gemm.cu",
        "replaces": "gpustack_tpu/models/transformer.py:487",
    },
}
# the wrappers whose launches are also counted per path: {wrapper: prefix}
# (the flash kernel's paths are its modes: causal, and the LSE mode of a
# ring block)
PATH_WRAPPERS = {"w8a16_matmul": "w8a16", "w8a16_grouped": "w8a16_grouped",
                  "bf16_grouped": "bf16_grouped",
                  "flash_attention_prefill": "flash"}
# the grouped wrapper of each expert weight type
GROUPED_WRAPPERS = {"int8": "w8a16_grouped", "bf16": "bf16_grouped"}


def _wrappers():
    from gpustack_tpu_torch.ops.flash_attention import flash_attention_prefill
    from gpustack_tpu_torch.ops.w8a16 import (
        bf16_grouped,
        w8a16_grouped,
        w8a16_matmul,
    )

    return {
        "flash_attention_prefill": flash_attention_prefill,
        "w8a16_matmul": w8a16_matmul,
        "w8a16_grouped": w8a16_grouped,
        "bf16_grouped": bf16_grouped,
    }


def launch_counts():
    """Each wrapper's launches, and each W8A16 wrapper's per path
    (``w8a16_gemv`` ... ``bf16_grouped_wgmma``)."""
    wrappers = _wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    for name, prefix in PATH_WRAPPERS.items():
        counts.update({f"{prefix}_{path}": n for path, n in
                       wrappers[name].launches_by_path.items()})
    return counts


def reset_launch_counts():
    wrappers = _wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for name in PATH_WRAPPERS:
        by_path = wrappers[name].launches_by_path
        by_path.update(dict.fromkeys(by_path, 0))


class RunnerCalls:
    """The model forwards a runner runs from here on (instance attributes
    over the methods the engine calls), each as (method, B, T, slot): the
    rows its weight products see are M = B·T (a decode step's B is a
    ``dp`` group's slots), and ``slot`` is the slot a prefill names (the
    ``dp`` group that runs it; None: every group)."""

    METHODS = ("prefill", "prefill_with_prefix", "prefill_with_embeds",
               "decode_step", "verify_step", "ingest_step", "embed")

    def __init__(self, runner, int8):
        self.runner, self.int8 = runner, int8
        self.forwards = []
        for name in self.METHODS:
            fn = getattr(runner, name)

            def counted(*args, _fn=fn, _name=name, **kw):
                self.forwards.append((_name, *self._shape(_name, args),
                                      kw.get("slot")))
                return _fn(*args, **kw)

            setattr(runner, name, counted)

    def _shape(self, name, args):
        slots = self.runner.max_slots
        if name in ("prefill", "prefill_with_embeds"):
            return 1, len(args[0])
        if name == "prefill_with_prefix":
            return 1, len(args[3])
        if name == "decode_step":
            return getattr(self.runner, "rows", slots), 1
        if name in ("verify_step", "ingest_step"):
            # a verify step runs a dp group's rows, as decode does
            return getattr(self.runner, "rows", slots), len(args[1][0])
        rows = 1                                    # embed: batch padded
        while rows < len(args[0]):
            rows *= 2
        return rows, len(args[0][0])

    def reset(self):
        self.forwards.clear()

    def counts(self):
        return {name: sum(f[0] == name for f in self.forwards)
                for name in self.METHODS}


def int8_products(cfg):
    """The 2-D W8A16 products of one forward's layers with every weight
    int8, from the config: attention's q, k, v and o (MLA: ``wq`` or
    ``wq_a`` and ``wq_b``, then ``wkv_a``, ``wkv_b`` and ``wo``); a dense
    layer's gate, up and down; an MoE layer's shared experts' gate, up and
    down (its ungated shared gate stays bf16)."""
    attn = (3 + (2 if cfg.q_lora_rank else 1)) if cfg.is_mla else 4
    moe = moe_layers(cfg)
    shared = 3 if moe and cfg.shared_expert_intermediate_size else 0
    return cfg.num_layers * attn + (cfg.num_layers - moe) * 3 + moe * shared


def moe_layers(cfg):
    """MoE layers of one forward: each runs its experts' gate, up and down
    as three grouped products per token chunk."""
    return cfg.num_layers - cfg.first_k_dense if cfg.is_moe else 0


def expected_launches(runner_calls, sp_rank=0, dp_rank=0):
    """What windows of runner forwards must launch, each
    :class:`RunnerCalls` with its own model: the flash kernel once per
    layer of every prefill forward (bucketed, continuation or with image
    embeddings) and every
    embedding forward where the model's config takes it
    (``flash_eligible``: no sliding window, softcap or sinks, the JAX
    ``forward``'s own condition), else never; with int8 weights the 2-D
    W8A16 kernel at M = B·T for every layer product of
    :func:`int8_products` (seven a layer on a dense model: q, k, v, o,
    gate, up, down), plus an untied lm_head at the rows it reads (a
    prefill's last position, a decode step's slots, all of a verify
    block's positions; an embedding forward and a draft's ingest read
    none; a tied lm_head is the bf16 embedding's transpose), never
    without int8; on an MoE model the grouped kernel of its expert type
    (``w8a16_grouped`` for int8 experts, ``bf16_grouped`` for bf16 ones)
    three times per MoE layer and token chunk (``moe_chunk_tokens``: one
    chunk up to the 2048 bucket at every served width), at the chunk's
    rows. Each product of M ≤ 16 rows (a chunk's tokens, for the grouped
    kernel) takes the GEMV, any larger one the ``wgmma`` path. The flash
    launches are counted per mode too: a runner under ``sp`` runs each
    prefill from zero (an image prompt's too) as a ring, whose rank
    ``sp_rank`` (the rank the
    counts are taken on) launches the kernel's LSE mode ``sp_rank + 1``
    times a layer (an embedding batch too: one launch a block for all its
    rows), and its continuations, decode steps and verify blocks merge
    over the sequence-sharded cache with no launch; every other flash
    launch is the causal mode. A ring prefill's MoE and W8A16 products see the rank's
    ``T / sp`` tokens. Under ``dp`` the counts are rank ``dp_rank``'s
    group's: a prefill that names a slot runs on the slot's group only,
    and a decode step's rows are the group's slots."""
    from gpustack_tpu_torch.models.transformer import (
        flash_eligible,
        moe_chunk_tokens,
        torch_dtype,
    )
    from gpustack_tpu_torch.ops.w8a16 import GEMV_MAX_M

    want = {"flash_attention_prefill": 0, "flash_causal": 0, "flash_lse": 0}
    for name, prefix in PATH_WRAPPERS.items():
        if prefix != "flash":
            want.update({name: 0, f"{prefix}_gemv": 0, f"{prefix}_wgmma": 0})

    def count(prefix, wrapper, m, n):
        path = "gemv" if m <= GEMV_MAX_M else "wgmma"
        want[f"{prefix}_{path}"] += n
        want[wrapper] += n

    for calls in runner_calls:
        cfg = calls.runner.cfg
        layers, flash = cfg.num_layers, flash_eligible(cfg)
        two_d, moe = int8_products(cfg), moe_layers(cfg)
        grouped = GROUPED_WRAPPERS["int8" if calls.int8 else "bf16"]
        chunk = moe_chunk_tokens(
            cfg.num_experts_per_tok, cfg.moe_intermediate_size,
            cfg.hidden_size, torch_dtype(cfg).itemsize,
        ) if moe else 0
        runner = calls.runner
        sp = getattr(runner, "sp_mode", False)
        dp, rows = getattr(runner, "dp", 1), getattr(runner, "rows", 0)
        for name, B, T, slot in calls.forwards:
            if dp > 1 and slot is not None and slot // rows != dp_rank:
                continue                    # another group's prefill
            if dp > 1 and name == "embed" and dp_rank:
                continue                    # the first group embeds
            tokens = B * T
            if sp and name in ("prefill", "prefill_with_embeds", "embed"):
                want["flash_attention_prefill"] += (sp_rank + 1) * layers
                want["flash_lse"] += (sp_rank + 1) * layers
                tokens //= runner.sp
            elif flash and not sp and name in (
                "prefill", "prefill_with_prefix", "prefill_with_embeds",
                "embed",
            ):
                want["flash_attention_prefill"] += layers
                want["flash_causal"] += layers
            for start in range(0, tokens if moe else 0, chunk or 1):
                count(grouped, grouped, min(chunk, tokens - start), 3 * moe)
            if not calls.int8:
                continue
            head = None if cfg.tie_word_embeddings else {
                "prefill": 1, "prefill_with_prefix": 1,
                "prefill_with_embeds": 1,
                "decode_step": B, "verify_step": B * T,
            }.get(name)
            for m, n in ((tokens, two_d), (head, 1)):
                if m is not None:
                    count("w8a16", "w8a16_matmul", m, n)
    return want


def check_launches(path, counts, want):
    if counts != want:
        raise AssertionError(
            f"{path}: kernel launches {counts}, the path needs {want}"
        )


# ---------------------------------------------------------------------------
# d: the main path through the API server
# ---------------------------------------------------------------------------


def _post(port, path, body, timeout=600, headers=None, reply_headers=None):
    """POST ``body``; returns (Content-Type, text). ``reply_headers``, a
    dict, receives the response's headers."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f"{path}: HTTP {resp.status}")
        if reply_headers is not None:
            reply_headers.update(resp.headers.items())
        return resp.headers.get("Content-Type", ""), resp.read().decode()


_TRACEPARENT = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-01$")


def _caller_trace():
    """A fresh caller's trace context (the worker proxy's, as the engine's
    hop sees it): (trace id, the caller's span id, the request headers)."""
    trace_id, span = os.urandom(16).hex(), os.urandom(8).hex()
    return trace_id, span, {"traceparent": f"00-{trace_id}-{span}-01"}


def _check_hop(reply_headers, trace_id, parent, phases=(), events=()):
    """The engine hop of a traced request: the response carries
    ``X-Request-ID`` and a ``traceparent`` of the caller's trace with a new
    span id; the port's ``get_store("engine")`` holds that hop, parented on
    the caller's span, with ``phases`` among its spans and ``events``
    among its events. Returns the hop's summary."""
    from gpustack_tpu_torch.observability.tracing import get_store

    m = _TRACEPARENT.match(reply_headers.get("traceparent", ""))
    if (not m or m.group(1) != trace_id or m.group(2) == parent
            or reply_headers.get("X-Request-ID") != trace_id):
        raise AssertionError(
            f"trace headers {reply_headers.get('traceparent')!r} / "
            f"{reply_headers.get('X-Request-ID')!r} for trace {trace_id}"
        )
    # the hop is sealed just after the handler's last byte: wait for it
    deadline = time.monotonic() + 10
    hops = get_store("engine").query(trace_id=trace_id)
    while not hops and time.monotonic() < deadline:
        time.sleep(0.01)
        hops = get_store("engine").query(trace_id=trace_id)
    if len(hops) != 1:
        raise AssertionError(f"trace {trace_id}: {len(hops)} engine hops")
    hop = hops[0]
    names = [p["phase"] for p in hop["spans"]]
    fired = [e["event"] for e in hop.get("events", ())]
    if (hop["span_id"] != m.group(2) or hop["parent_id"] != parent
            or hop["status"] != 200 or not set(phases) <= set(names)
            or not set(events) <= set(fired)):
        raise AssertionError(f"engine hop {hop}: want phases {phases}, "
                             f"events {events}")
    return {"name": hop["name"], "span_id": hop["span_id"],
            "duration_ms": hop["duration_ms"], "spans": hop["spans"],
            "events": hop.get("events", [])}


def _check_untraced(port):
    """``/healthz`` and ``/metrics``, sent a traceparent, answer without
    the trace headers and leave no engine hop."""
    from gpustack_tpu_torch.observability.tracing import get_store

    trace_id, _, headers = _caller_trace()
    for path in ("/healthz", "/metrics"):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=60) as resp:
            resp.read()
            if "traceparent" in resp.headers or "X-Request-ID" in resp.headers:
                raise AssertionError(f"{path} answered with trace headers")
    if get_store("engine").query(trace_id=trace_id):
        raise AssertionError("an untraced path left an engine hop")
    return ["/healthz", "/metrics"]


def _check_usage(data, prompt_tokens=None):
    usage = data["usage"]
    if usage["completion_tokens"] < 1:
        raise AssertionError(f"no completion tokens: {usage}")
    if prompt_tokens is not None and usage["prompt_tokens"] != prompt_tokens:
        raise AssertionError(f"prompt_tokens {usage} != {prompt_tokens}")
    return usage


class _RoutingTape:
    """Inside ``with``, ``transformer.moe_route`` records the experts each
    MoE call picks (``mode = "record"``) or replays the recorded picks
    (``"replay"``): row by row in order, so a replaying forward over the
    same tokens may run other token chunks (an fp32 forward's are half a
    bf16 one's). The combine weights are recomputed from the call's own
    router logits over those picks (softmax scoring then
    ``norm_topk_prob``, or GPT-OSS's ``softmax_topk``: the affine logits'
    softmax over the picks): the forward's one discrete step held fixed,
    and each call's count of tokens whose own picks would differ kept.
    Any other mode routes freely."""

    def __init__(self):
        self.picks, self.flips, self.mode, self.at = [], [], "record", 0

    def __enter__(self):
        from gpustack_tpu_torch.models import transformer as tf

        self._route = tf.moe_route

        def route(x, router_w, cfg, router_bias=None):
            idx, combine = self._route(x, router_w, cfg, router_bias)
            if self.mode != "replay":
                if self.mode == "record":
                    self.picks.append(idx)
                return idx, combine
            if cfg.moe_scoring not in ("softmax", "softmax_topk"):
                raise ValueError(f"the tape cannot replay {cfg.moe_scoring}")
            if self.at == 0:
                self.picks = [torch.cat(self.picks)]
            want = self.picks[0][self.at:self.at + len(idx)]
            self.at += len(idx)
            self.flips.append(int(
                (idx.sort(-1).values != want.sort(-1).values).any(-1).sum()
            ))
            logits = x.float() @ router_w.float()
            if cfg.moe_scoring == "softmax_topk":
                if router_bias is not None:
                    logits = logits + router_bias.float()
                top_w = torch.softmax(torch.gather(logits, -1, want), -1)
            else:
                gates = torch.softmax(logits, dim=-1)
                top_w = torch.gather(gates, -1, want)
                if cfg.norm_topk_prob:
                    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
            return want, torch.zeros_like(logits).scatter_(-1, want, top_w)

        tf.moe_route = route
        return self

    def __exit__(self, *exc):
        from gpustack_tpu_torch.models import transformer as tf

        tf.moe_route = self._route


class _PlainGrouped:
    """Inside ``with``, both grouped expert wrappers are their plain
    versions (the fp32 references on the card: the kernel takes bf16
    activations only; the int8 logit check's plain run). ``_moe_mlp``
    reads the wrappers from ``ops.w8a16`` at each call."""

    def __enter__(self):
        from gpustack_tpu_torch.ops import w8a16

        self._kept = w8a16.w8a16_grouped, w8a16.bf16_grouped
        w8a16.w8a16_grouped = (
            lambda x, q, s, offsets, rows: w8a16.w8a16_grouped_plain(
                x, q, s, offsets)
        )
        w8a16.bf16_grouped = (
            lambda x, w, offsets, rows: w8a16.bf16_grouped_plain(
                x, w, offsets)
        )
        return self

    def __exit__(self, *exc):
        from gpustack_tpu_torch.ops import w8a16

        w8a16.w8a16_grouped, w8a16.bf16_grouped = self._kept


class _Widened:
    """A stacked leaf read a layer at a time in fp32 (``lp[key][i]``): an
    fp32 forward over a bf16 tree without an fp32 copy of the tree
    (gpt-oss-20b's would take 84 GB)."""

    def __init__(self, t):
        self.t = t

    @property
    def shape(self):
        return self.t.shape

    def __getitem__(self, i):
        return self.t[i].float()


def _fp32_model(runner):
    """(params, cfg) of the fp32 plain reference over ``runner``'s bf16
    weights: every layer leaf widened as it is read; the embedding, the
    final norm and ``lm_head`` promote in ``_embed_lookup``, ``rms_norm``
    and ``_mm``."""
    params = dict(runner.params)
    for key in ("layers", "dense_layers"):
        if key in params:
            params[key] = {k: _Widened(t) for k, t in params[key].items()}
    return params, dataclasses.replace(runner.cfg, dtype="float32")


def _compare_logits(got, want):
    return {
        "max_abs_err": (got - want).abs().max().item(),
        "logit_scale": want.abs().max().item(),
        "cosine": torch.nn.functional.cosine_similarity(
            got, want, dim=0
        ).item(),
    }


def _logit_check(engine):
    """A served prefill's last-position logits against a reference run of
    the same prompt (outside the counted window). Where the config takes
    the flash kernel, the reference is the same bf16 forward through the
    plain attention; where it does not (sliding windows, softcaps, sinks:
    the plain attention is itself the served path, as in JAX), it is the
    fp32 plain forward over the same weights (:func:`_fp32_model`). For an
    MoE model the reference replays the served run's expert picks: on
    random weights a top-k router flips the picks of tokens near a tie on
    any rounding change, and many layers compound the flips, so replaying
    them leaves the attention (or the rounding) as the only difference
    between the runs. The free-routing comparison and its flips are
    reported beside it."""
    from gpustack_tpu_torch.models import transformer as tf

    runner = engine.runner
    cfg = runner.cfg
    flash = tf.flash_eligible(cfg)
    params, ref_cfg = (
        (runner.params, cfg) if flash else _fp32_model(runner)
    )
    prompt = engine.tokenizer.encode("The port's logit check. " * 40)
    bucket = runner.bucket_for(len(prompt))
    padded = prompt + [0] * (bucket - len(prompt))

    def plain_last():
        tokens = torch.tensor([padded], device=runner.device)
        positions = torch.arange(bucket, device=runner.device)[None, :]
        cache = tf.KVCache.create(ref_cfg, 1, bucket, runner.device)
        with _PlainGrouped() if ref_cfg is not cfg else contextlib.nullcontext():
            hidden, _ = tf.forward(
                params, ref_cfg, tokens, positions, cache,
                return_hidden=True, attn_impl="plain",
            )
        return tf.lm_head(params, ref_cfg, hidden[0, len(prompt) - 1])

    moe = {}
    with torch.no_grad(), _RoutingTape() as tape:
        served_last, _, _ = runner.prefill(padded, len(prompt))
        tape.mode = "replay"
        plain = plain_last()
        if tape.picks:
            tape.mode = "free"
            moe = {
                "routing": "the served run's expert picks replayed",
                "free_routing": {
                    **_compare_logits(served_last, plain_last()),
                    "tokens_with_a_flipped_pick_per_layer": tape.flips,
                },
            }
    if served_last.shape != (cfg.vocab_size,) or not torch.isfinite(
        served_last
    ).all():
        raise AssertionError(f"bad logits {tuple(served_last.shape)}")
    gate = _compare_logits(served_last, plain)
    emit("logit_check", model=cfg.name, prompt_tokens=len(prompt),
         bucket=bucket,
         served="flash kernel" if flash else "plain attention, bf16",
         reference=("plain attention, bf16" if flash
                    else "fp32 plain forward"),
         **gate, **moe,
         tolerance={"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE})
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
        gate["cosine"] < LOGIT_MIN_COSINE
    ):
        raise AssertionError(f"served prefill logits differ: {gate}")
    return gate["logit_scale"]


def _prefill_ms(engine, reps: int = 5) -> float:
    """One 2048-bucket prefill through the runner, CUDA events around it:
    the median of ``reps`` after a warm-up. It launches the kernels, so it
    runs outside the counted window."""
    runner = engine.runner
    ids = engine.tokenizer.encode("x" * 1500)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    times = []
    with torch.no_grad():
        for i in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runner.prefill(padded, len(ids))
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
    return statistics.median(times)


def _prefill_split(engine):
    """One 2048-bucket prefill (after ``_prefill_ms``'s warm-up, outside
    the counted windows) with CUDA events around it and around each plain
    attention (``_attend``) and MoE block (``_moe_mlp``) call in it: the
    stream time each takes of the whole."""
    from gpustack_tpu_torch.models import transformer as tf

    runner = engine.runner
    ids = engine.tokenizer.encode("x" * 1500)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    spans = {"attend": [], "moe_mlp": []}

    def timed(name, fn):
        def call(*args, **kw):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = fn(*args, **kw)
            pair[1].record()
            spans[name].append(pair)
            return out
        return call

    attend, moe_mlp = tf._attend, tf._moe_mlp
    tf._attend, tf._moe_mlp = timed("attend", attend), timed("moe_mlp", moe_mlp)
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            runner.prefill(padded, len(ids))
            end.record()
        torch.cuda.synchronize()
    finally:
        tf._attend, tf._moe_mlp = attend, moe_mlp
    split = {"prefill_ms": start.elapsed_time(end)}
    for name, pairs in spans.items():
        split[f"{name}_calls"] = len(pairs)
        split[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in pairs)
    return split


def _engine_metrics(engine):
    """TTFT of one 2048-bucket prompt on an idle engine, and decode
    tokens/s with all 8 slots busy (host clock around device work)."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    long_prompt = engine.tokenizer.encode("x" * 1500)
    ttft_ms = engine.generate(
        GenRequest(prompt_ids=long_prompt, max_tokens=2, temperature=0.0),
        timeout=600,
    ).ttft_ms
    reqs = [
        engine.submit(GenRequest(
            prompt_ids=engine.tokenizer.encode(f"slot {i} says"),
            max_tokens=64, temperature=0.0,
        ))
        for i in range(engine.max_slots)
    ]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError("decode-rate request timed out")
    t_first = max(r.first_token_at for r in reqs)
    t_end = max(r.finished_at for r in reqs)
    after_first = sum(len(r.output_ids) - 1 for r in reqs)
    return {
        "ttft_ms_2048_bucket": ttft_ms,
        "decode_tokens_per_s_8_slots": after_first / max(t_end - t_first, 1e-9),
        "prefills": 1 + len(reqs),
    }


def _serve_script(engine, port):
    """The main path's requests through the server: chat, streaming chat,
    a completion filling the 2048 bucket, four concurrent chats, and a
    repeated greedy prompt; then TTFT and decode tokens/s. Returns the
    request-derived prefill count, usages, greedy ids and metrics."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    prefills = 0
    tok = engine.tokenizer

    msgs = [{"role": "user", "content": "Say hello to the H100."}]
    chat_prompt = len(tok.apply_chat_template(msgs))
    # both chats carry a caller's traceparent: the engine hop's headers
    # and stored span (the trace middleware)
    traces = []
    trace_id, parent, headers = _caller_trace()
    got = {}
    _, raw = _post(port, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 16, "temperature": 0,
    }, headers=headers, reply_headers=got)
    prefills += 1
    traces.append(_check_hop(got, trace_id, parent))
    chat = json.loads(raw)
    chat_usage = _check_usage(chat, chat_prompt)

    trace_id, parent, headers = _caller_trace()
    got = {}
    ctype, raw = _post(port, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": 16, "temperature": 0,
        "stream": True,
    }, headers=headers, reply_headers=got)
    prefills += 1
    traces.append(_check_hop(got, trace_id, parent))
    events = [
        line[6:] for line in raw.split("\n") if line.startswith("data: ")
    ]
    if "text/event-stream" not in ctype or events[-1] != "[DONE]":
        raise AssertionError(f"bad stream: {ctype} {events[-1:]}")
    stream_usage = _check_usage(json.loads(events[-2]), chat_prompt)

    long_text = "The quick brown fox jumps over the lazy dog. " * 34
    long_ids = tok.encode(long_text)
    if not 1024 < len(long_ids) < 2048:
        raise AssertionError(f"long prompt is {len(long_ids)} tokens")
    _, raw = _post(port, "/v1/completions", {
        "prompt": long_text, "max_tokens": 8, "temperature": 0,
        "logprobs": 1,
    })
    prefills += 1
    long_data = json.loads(raw)
    long_usage = _check_usage(long_data, len(long_ids))

    results = [None] * 4

    def worker(i):
        _, body = _post(port, "/v1/chat/completions", {
            "messages": [{"role": "user", "content": f"request {i}"}],
            "max_tokens": 24, "temperature": 0.8, "seed": i,
        })
        results[i] = json.loads(body)

    threads = [
        threading.Thread(target=worker, args=(i,)) for i in range(4)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads) or None in results:
        raise AssertionError("a concurrent request did not finish")
    prefills += 4
    for r in results:
        _check_usage(r)

    # repeated greedy prompt: identical token ids and logprobs
    _, raw = _post(port, "/v1/completions", {
        "prompt": long_text, "max_tokens": 8, "temperature": 0,
        "logprobs": 1,
    })
    prefills += 1
    again = json.loads(raw)
    if again["choices"][0]["logprobs"]["token_logprobs"] != (
        long_data["choices"][0]["logprobs"]["token_logprobs"]
    ):
        raise AssertionError("repeated greedy prompt diverged")
    first = engine.generate(GenRequest(
        prompt_ids=long_ids, max_tokens=8, temperature=0.0), timeout=600)
    second = engine.generate(GenRequest(
        prompt_ids=long_ids, max_tokens=8, temperature=0.0), timeout=600)
    prefills += 2
    if first.output_ids != second.output_ids or not first.output_ids:
        raise AssertionError(
            f"greedy ids differ: {first.output_ids} {second.output_ids}"
        )

    metrics = _engine_metrics(engine)
    prefills += metrics.pop("prefills")
    return {
        "prefills": prefills,
        "usage": {"chat": chat_usage, "stream": stream_usage,
                  "long_completion": long_usage},
        "greedy_ids": first.output_ids,
        "trace": {"hops": traces,
                  "untraced_paths": _check_untraced(port)},
        **metrics,
    }


def _serve_counted(engine, logit_check, int8, profile="", embed=False):
    """Start ``engine`` behind the server, run ``logit_check`` outside the
    counted window, then the main path's requests with every kernel's
    launches counted and checked against what the runner's forwards need;
    with a ``profile`` label, then a counted window of :func:`_profile`;
    with ``embed``, a counted window of the embedding requests
    (:func:`_embed_checks`) and their reference. Returns
    (report, {window: counts})."""
    from gpustack_tpu_torch.engine.api_server import OpenAIServer

    calls = RunnerCalls(engine.runner, int8)
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        logit_check(engine)
        reset_launch_counts()
        calls.reset()
        report = _serve_script(engine, port)
        counts = launch_counts()
        window = calls.counts()
        health = engine.health()
        if health["status"] != "ok":
            raise AssertionError(f"engine unhealthy: {health}")
        if window["prefill"] != report["prefills"] or window[
            "prefill_with_prefix"
        ]:
            raise AssertionError(
                f"runner calls {window} for {report['prefills']} prompts"
            )
        want = expected_launches([calls])
        check_launches("int8 path" if int8 else "main path", counts, want)
        report["runner_calls"] = window
        report["prefill_ms_2048_bucket"] = _prefill_ms(engine)
        windows = {"served": counts}
        if embed:
            with _RoutingTape() as tape:     # the served batch's picks
                windows["embed"], (vecs, report["embeddings"]) = _window(
                    "embeddings", [calls], lambda: _embed_checks(engine, port)
                )
            report["embeddings"].update(_embed_reference(engine, vecs, tape))
        if profile:
            windows["profile"], report["profile"] = _window(
                f"{profile} profile", [calls],
                lambda: _profile(port, profile),
            )
        return report, windows
    finally:
        server.shutdown()
        engine.stop()


MAIN_ARGV = [
    "--preset", "llama3-8b", "--max-slots", "8", "--max-seq-len", "2048",
    "--host", "127.0.0.1", "--port", "0",
]


def phase_main_path(kind, smi):
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )

    args = build_parser().parse_args(MAIN_ARGV)
    t0 = time.perf_counter()
    engine = build_engine_from_args(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    report, windows = _serve_counted(engine, _logit_check, int8=False)
    counts = windows["served"]
    emit("main_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, launches=counts, **report,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return counts, report


# ---------------------------------------------------------------------------
# e: prefix reuse and chunked prefill
# ---------------------------------------------------------------------------

E_ARGV = MAIN_ARGV + ["--prefill-chunk", "512", "--host-kv-cache-mb", "4096"]
CHUNK = 512
BLOCK = 256            # the host cache's default block
# lowercase letters (byte tokenizer: byte b is id b + 1): a reply biased to
# them is text that tokenizes back to the ids generated, as a real
# model's reply does, so turn 2's prompt holds turn 1's generated tokens
LETTERS = {str(ord(c) + 1): 100.0 for c in "abcdefghijklmnopqrstuvwxyz"}
_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$"
)


def parse_prometheus(text):
    """Strict enough for the exporter: every sample's family declared by a
    ``# TYPE`` line first, numeric values, histogram buckets cumulative
    with ``+Inf`` equal to ``_count``. Returns ({(name, labels): value},
    {family: kind})."""
    types, samples = {}, {}
    for n, line in enumerate(text.splitlines(), 1):
        if line.startswith("# TYPE "):
            _, _, family, kind = line.split(" ")
            if family in types:
                raise AssertionError(f"line {n}: {family} declared twice")
            types[family] = kind
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            raise AssertionError(f"line {n} is not a sample: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", float(m.group(3))
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in types and types.get(family) != "histogram":
            raise AssertionError(f"line {n}: {name} has no # TYPE")
        samples[(name, labels)] = value
    for family, kind in types.items():
        if kind != "histogram":
            continue
        series = {}
        for (name, labels), value in samples.items():
            if name == f"{family}_bucket":
                rest = re.sub(r',?le="[^"]*"', "", labels)
                le = re.search(r'le="([^"]*)"', labels).group(1)
                series.setdefault(rest, []).append(
                    (float("inf") if le == "+Inf" else float(le), value)
                )
        for rest, buckets in series.items():
            counts = [c for _, c in sorted(buckets)]
            count = samples[(f"{family}_count", "" if rest == "{}" else rest)]
            if counts != sorted(counts) or counts[-1] != count:
                raise AssertionError(f"{family}{rest}: bad buckets")
    return samples, types


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=60
    ) as resp:
        return resp.read().decode()


def _stream_chat(port, messages, max_tokens, arrivals=None, started=None,
                 headers=None, reply_headers=None):
    """A streaming chat; returns (reply text, TTFT s). ``arrivals`` collects
    the host time of every content chunk; ``started`` is set at the
    first one; ``reply_headers``, a dict, receives the response's
    headers."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({
            "messages": messages, "max_tokens": max_tokens,
            "temperature": 0, "stream": True, "logit_bias": LETTERS,
        }).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    t0 = time.perf_counter()
    ttft, text = None, []
    with urllib.request.urlopen(req, timeout=600) as resp:
        if reply_headers is not None:
            reply_headers.update(resp.headers.items())
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            piece = json.loads(line[6:])["choices"][0]["delta"].get(
                "content"
            )
            if piece:
                now = time.perf_counter()
                if ttft is None:
                    ttft = now - t0
                    if started is not None:
                        started.set()
                if arrivals is not None:
                    arrivals.append(now)
                text.append(piece)
    return "".join(text), ttft


def _forwards(n_tokens, matched):
    """Model forwards (each 32 flash launches) a prompt takes: one-shot
    (with or without a prefix) up to the chunk, else one per chunk of
    what the prefix left."""
    rest = n_tokens - matched
    return 1 if n_tokens <= CHUNK else -(-rest // CHUNK)


def _expected_match(prompt, stored):
    """Block-aligned tokens of ``prompt`` the cache can serve: its longest
    common prefix with any stored sequence, in whole blocks, leaving at
    least one token to prefill."""
    best = 0
    for seq in stored:
        n = 0
        while n < min(len(seq), len(prompt)) and seq[n] == prompt[n]:
            n += 1
        best = max(best, n // BLOCK * BLOCK)
    return min(best, (len(prompt) - 1) // BLOCK * BLOCK)


def _continuation_parity(engine):
    """Runner level, outside the counted window: a continuation's logits
    against one prefill of the same prompt (the flash kernel at
    ``q_offset`` > 0 against offset 0)."""
    runner = engine.runner
    rows = []

    def compare(name, got, want):
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(got, want, dim=0).item()
        rows.append({"case": name, "max_abs_err": err, "logit_scale": scale,
                     "cosine": cos})
        if (
            not torch.isfinite(got).all() or err > LOGIT_REL_TOL * scale
            or cos < LOGIT_MIN_COSINE
        ):
            raise AssertionError(
                f"{name}: continuation logits differ, max |err| {err} "
                f"(scale {scale}), cosine {cos}"
            )

    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        ids = torch.randint(1, 257, (1500,), generator=gen).tolist()
        full, k, v = runner.prefill(ids + [0] * (2048 - 1500), 1500)
        suffix = ids[1024:] + [0] * (512 - 476)
        got, _, _ = runner.prefill_with_prefix(
            k[:, :1024], v[:, :1024], 1024, suffix, 476, 2048
        )
        compare("prefix 1024 + suffix 476 (T 512, S 2048, offset 1024)",
                got, full)
        ids = torch.randint(1, 257, (1900,), generator=gen).tolist()
        full, _, _ = runner.prefill(ids + [0] * (2048 - 1900), 1900)
        last = k = v = None
        for start in range(0, 1900, CHUNK):
            part = ids[start:start + CHUNK]
            sb = runner.bucket_for(len(part))
            padded = part + [0] * (sb - len(part))
            if start == 0:
                last, k, v = runner.prefill(padded, len(part))
            else:
                last, k, v = runner.prefill_with_prefix(
                    k, v, start, padded, len(part),
                    runner.bucket_for(start + sb),
                )
        compare("four chunks of 512 (1900 tokens)", last, full)
        # device time of one 512-token forward by where it starts (CUDA
        # events, median of 3): a bucketed prefill, then continuations
        _, k, v = runner.prefill(ids[:2048] + [0] * 148, 1900)
        timing = {}
        for off in (0, 512, 1024, 1536):
            part = ids[off:off + CHUNK]
            runs = []
            for _ in range(4):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if off == 0:
                    runner.prefill(part, CHUNK)
                else:
                    runner.prefill_with_prefix(
                        k[:, :off], v[:, :off], off,
                        part + [0] * (CHUNK - len(part)),
                        len(part), runner.bucket_for(off + CHUNK),
                    )
                end.record()
                torch.cuda.synchronize()
                runs.append(start.elapsed_time(end))
            timing[str(off)] = statistics.median(runs[1:])
    return rows, timing


def _kv_tier_times(engine):
    """Host KV tier costs, outside the counted window: gathering and
    uploading a 1280-token (5-block) prefix, and storing a 2048-token
    sequence device→host (host clock; each ends on a synchronize)."""
    cache = engine.host_kv_cache
    runner = engine.runner
    out = {"store_ms_2048_tokens": [], "store_blocks": [],
           "gather_ms_1280_tokens": [], "upload_ms_1280_tokens": []}
    # twice, on two sequences: the second call finds the caching host
    # allocator's pinned blocks already made
    for rep in range(2):
        ids = [1 + (i + 7 * rep) % 250 for i in range(2048)]
        with torch.no_grad():
            _, k, v = runner.prefill(ids, 2048)
        torch.cuda.synchronize()
        before = cache.entries
        t0 = time.perf_counter()
        engine._submit_kv_copy(ids, k, v, 2048)
        engine._kv_copy_pool.submit(lambda: None).result(timeout=120)
        out["store_ms_2048_tokens"].append((time.perf_counter() - t0) * 1e3)
        out["store_blocks"].append(cache.entries - before)
        t0 = time.perf_counter()
        pk, pv = cache.gather_prefix(ids, 1280)
        out["gather_ms_1280_tokens"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine._upload_prefix(pk, pv, 1280)
        out["upload_ms_1280_tokens"].append((time.perf_counter() - t0) * 1e3)
    out["block_mib"] = pk.nbytes * 2 / 5 / 2**20
    return out


def phase_prefix_reuse(kind, smi):
    """The engine with chunked prefill and the host KV cache, through the
    port's server: multi-turn chats that reuse their earlier turns'
    blocks, a long completion chunked while chats decode, exact hit and
    launch counts, and /metrics."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )

    args = build_parser().parse_args(E_ARGV)
    engine = build_engine_from_args(args)
    # runner-level checks and KV tier timings before the scheduler starts
    parity, chunk_forward_ms = _continuation_parity(engine)
    kv_tier = _kv_tier_times(engine)
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    tok = engine.tokenizer

    def drain():
        engine._kv_copy_pool.submit(lambda: None).result(timeout=120)

    def health():
        return json.loads(_get(port, "/healthz"))

    try:
        reset_launch_counts()
        forwards = 0
        stored = []
        conversations = []
        for name, seed_text in (("a", "Tell me about the H100. "),
                                ("b", "Summarise this log line. ")):
            body = (seed_text * 60)[:1226]
            msgs = [{"role": "user", "content": body}]
            p1 = tok.apply_chat_template(msgs)
            h0 = health()
            reply, ttft_cold = _stream_chat(port, msgs, 48)
            out = tok.encode(reply)
            if len(out) != 48:
                raise AssertionError(f"turn 1 replied {len(out)} tokens")
            forwards += _forwards(len(p1), _expected_match(p1, stored))
            stored += [p1, p1 + out[:-1]]
            drain()
            msgs2 = msgs + [{"role": "assistant", "content": reply},
                            {"role": "user", "content": "Go on."}]
            p2 = tok.apply_chat_template(msgs2)
            want = _expected_match(p2, stored)
            h1 = health()
            trace_id, parent, headers = _caller_trace()
            got = {}
            _, ttft_warm = _stream_chat(port, msgs2, 16, headers=headers,
                                        reply_headers=got)
            h2 = health()
            hop = _check_hop(got, trace_id, parent, phases=("kv_upload",),
                             events=("kv_prefix_hit",))
            hit = next(e for e in hop["events"]
                       if e["event"] == "kv_prefix_hit")
            if hit["attrs"]["tokens_reused"] != want:
                raise AssertionError(f"traced prefix hit {hit}, want {want}")
            forwards += _forwards(len(p2), want)
            stored.append(p2)      # its prefill store; reply under a block
            drain()
            hits = h2["kv_cache_prefix_hits"] - h1["kv_cache_prefix_hits"]
            reused = (h2["kv_cache_prefix_tokens_reused"]
                      - h1["kv_cache_prefix_tokens_reused"])
            if want <= len(p1) or hits != 1 or reused != want:
                raise AssertionError(
                    f"conversation {name}: turn 2 ({len(p2)} tokens) reused "
                    f"{reused} tokens in {hits} hits, want {want} in 1"
                )
            if h1["kv_cache_prefix_hits"] != h0["kv_cache_prefix_hits"]:
                raise AssertionError(f"conversation {name}: turn 1 hit")
            conversations.append({
                "turn1_tokens": len(p1), "turn2_tokens": len(p2),
                "reused_tokens": reused, "ttft_ms_cold": ttft_cold * 1e3,
                "ttft_ms_warm": ttft_warm * 1e3, "warm_turn_trace": hop,
            })

        # one 1900-token completion while 4 chats decode
        arrivals = [[] for _ in range(4)]
        started = [threading.Event() for _ in range(4)]
        chats = [
            threading.Thread(target=_stream_chat, args=(
                port, [{"role": "user", "content": f"chat {i} " * 4}], 200,
                arrivals[i], started[i],
            ))
            for i in range(4)
        ]
        for t in chats:
            t.start()
        for e in started:
            if not e.wait(120):
                raise AssertionError("a chat never streamed")
        for i in range(4):
            forwards += _forwards(
                len(tok.apply_chat_template(
                    [{"role": "user", "content": f"chat {i} " * 4}]
                )), 0,
            )
        long_text = "".join(
            chr(ord("a") + (i * 7) % 26) for i in range(1900)
        )
        t_submit = time.time()
        p0 = time.perf_counter()
        _, raw = _post(port, "/v1/completions", {
            "prompt": long_text, "max_tokens": 8, "temperature": 0,
        })
        p1_ = time.perf_counter()
        _check_usage(json.loads(raw), 1900)
        forwards += _forwards(1900, 0)
        for t in chats:
            t.join(timeout=600)
        if any(t.is_alive() for t in chats):
            raise AssertionError("a chat did not finish")
        records = json.loads(_get(port, "/debug/flight?limit=2048"))[
            "records"
        ]
        chunks = [
            r for r in records
            if r["ts"] >= t_submit and r["mode"] == "prefill_chunk"
        ]
        if len(chunks) != 4 or sum(r["prompt_tokens"] for r in chunks) != 1900:
            raise AssertionError(
                f"1900-token completion ran as {len(chunks)} chunk steps "
                f"({[r['prompt_tokens'] for r in chunks]})"
            )
        gaps = [
            max((b - a for a, b in zip(ts, ts[1:]) if p0 <= b <= p1_),
                default=0.0)
            for ts in arrivals
        ]
        counts = launch_counts()
        check_launches("prefix reuse", counts, {
            **dict.fromkeys(counts, 0),
            "flash_attention_prefill": engine.cfg.num_layers * forwards,
            "flash_causal": engine.cfg.num_layers * forwards,
        })
        samples, types = parse_prometheus(_get(port, "/metrics"))
        h = health()
        if h["status"] != "ok":
            raise AssertionError(f"engine unhealthy: {h}")
        if samples[("gpustack_kv_cache_hits", "")] != h["kv_cache_hits"]:
            raise AssertionError("/metrics kv hits disagree with /healthz")
        emit("prefix_reuse", model=engine.cfg.name, device=kind,
             nvidia_smi=smi, continuation_parity=parity,
             forward_ms_512_tokens_by_offset=chunk_forward_ms,
             conversations=conversations,
             long_prompt={
                 "tokens": 1900, "chunk_steps": len(chunks),
                 "chunk_step_ms": [r["dur_ms"] for r in chunks],
                 "e2e_ms": (p1_ - p0) * 1e3,
                 "max_inter_token_gap_ms_of_running_chats": [
                     g * 1e3 for g in gaps
                 ],
             },
             forwards=forwards, launches=counts, kv_tier=kv_tier,
             kv_cache={k: h[k] for k in (
                 "kv_cache_hits", "kv_cache_misses", "kv_cache_prefix_hits",
                 "kv_cache_prefix_tokens_reused", "kv_cache_blocks",
                 "kv_cache_host_bytes",
             )},
             metrics_families=len(types),
             flight_overhead_ratio=h["flight_overhead_ratio"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return counts
    finally:
        server.shutdown()
        engine.stop()


# ---------------------------------------------------------------------------
# f: checkpoints and int8
# ---------------------------------------------------------------------------


def _hf_named(tree, cfg, mxfp4=None):
    """The param tree under HF names (llama; Qwen3-MoE with ``qk_norm`` and
    per-expert tensors; DeepSeek-V2 with MLA, its shared experts and the
    ``dense_layers`` stack first; GPT-OSS with its biases, fp32 sinks and
    router bias and fused experts, gate and up interleaved; Gemma2's
    sandwich norms), linear weights as [out, in]; a tied tree carries no
    ``lm_head.weight``. ``mxfp4`` maps a GPT-OSS expert tensor's name to
    its MXFP4 (blocks, scales), written in its place."""
    out = {
        "model.embed_tokens.weight": tree["embed"],
        "model.norm.weight": tree["final_norm"],
    }
    if "lm_head" in tree:
        out["lm_head.weight"] = tree["lm_head"].T
    attn = "self_attn."
    names = {
        "attn_norm": ("input_layernorm.weight", False),
        "wq": (attn + "q_proj.weight", True),
        "wk": (attn + "k_proj.weight", True),
        "wv": (attn + "v_proj.weight", True),
        "wo": (attn + "o_proj.weight", True),
        "bq": (attn + "q_proj.bias", False),
        "bk": (attn + "k_proj.bias", False),
        "bv": (attn + "v_proj.bias", False),
        "bo": (attn + "o_proj.bias", False),
        "sinks": (attn + "sinks", False),
        "mlp_norm": ("post_attention_layernorm.weight", False),
        "q_norm": (attn + "q_norm.weight", False),
        "k_norm": (attn + "k_norm.weight", False),
        "wq_a": (attn + "q_a_proj.weight", True),
        "q_a_norm": (attn + "q_a_layernorm.weight", False),
        "wq_b": (attn + "q_b_proj.weight", True),
        "wkv_a": (attn + "kv_a_proj_with_mqa.weight", True),
        "kv_a_norm": (attn + "kv_a_layernorm.weight", False),
        "wkv_b": (attn + "kv_b_proj.weight", True),
        "w_gate": ("mlp.gate_proj.weight", True),
        "w_up": ("mlp.up_proj.weight", True),
        "w_down": ("mlp.down_proj.weight", True),
        "router": ("mlp.gate.weight", True),
        "ws_gate": ("mlp.shared_experts.gate_proj.weight", True),
        "ws_up": ("mlp.shared_experts.up_proj.weight", True),
        "ws_down": ("mlp.shared_experts.down_proj.weight", True),
    }
    if cfg.post_norms:
        names.update({
            "post_attn_norm": ("post_attention_layernorm.weight", False),
            "mlp_norm": ("pre_feedforward_layernorm.weight", False),
            "post_mlp_norm": ("post_feedforward_layernorm.weight", False),
        })
    gptoss = cfg.moe_act == "gptoss"
    if gptoss:
        names.update({"router": ("mlp.router.weight", True),
                      "router_bias": ("mlp.router.bias", False)})
    experts = {"we_gate": "gate_proj", "we_up": "up_proj",
               "we_down": "down_proj"}
    stacks = [tree[k] for k in ("dense_layers", "layers") if k in tree]
    blocks = [(lp, j) for lp in stacks for j in range(len(lp["attn_norm"]))]
    for i, (lp, j) in enumerate(blocks):
        for key, (hf, transpose) in names.items():
            if key in lp:
                t = lp[key][j]
                out[f"model.layers.{i}.{hf}"] = t.T if transpose else t
        if gptoss:
            fused = {
                "gate_up_proj": _interleave(lp["we_gate"][j], lp["we_up"][j]),
                "gate_up_proj_bias": _interleave(lp["we_gate_b"][j],
                                                 lp["we_up_b"][j]),
                "down_proj": lp["we_down"][j],
                "down_proj_bias": lp["we_down_b"][j],
            }
            for hf, t in fused.items():
                name = f"model.layers.{i}.mlp.experts.{hf}"
                if name in (mxfp4 or {}):
                    out[name + "_blocks"], out[name + "_scales"] = mxfp4[name]
                else:
                    out[name] = t
            continue
        for key, hf in experts.items():
            for e in range(cfg.num_experts if key in lp else 0):
                out[f"model.layers.{i}.mlp.experts.{e}.{hf}.weight"] = (
                    lp[key][j, e].T
                )
    return out


def _interleave(gate, up):
    """GPT-OSS's fused layout: gate and up alternating on the last axis."""
    return torch.stack([gate, up], dim=-1).flatten(-2)


# MXFP4's e2m1 magnitudes
FP4_STEPS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def _pack_mxfp4(w):
    """An expert weight ``[E, in, out]`` as the GPT-OSS hub checkpoints
    pack it: ``blocks`` uint8 ``[E, out, in/32, 16]`` (two e2m1 nibbles a
    byte, the low one the even element; sign bit high) and e8m0
    ``scales`` uint8 ``[E, out, in/32]`` (biased by 127), each 32-value
    block scaled by the power of two that puts its largest magnitude at
    or under 6. Also returns the weight the packing stands for, each
    value rounded to its nearest step (the lower one on a tie), bf16
    ``[E, in, out]``: computed here, independently of the loader's
    decoding. One expert at a time."""
    steps = torch.tensor(FP4_STEPS, device=w.device)
    mids = (steps[1:] + steps[:-1]) / 2
    blocks, scales, rounded = [], [], []
    for we in w:
        g = we.T.float().reshape(we.shape[1], -1, 32)        # [out, G, 32]
        exp = torch.ceil(torch.log2(
            (g.abs().amax(-1, keepdim=True) / 6.0).clamp_min(1e-30)
        )).clamp(-127, 127)
        e = (exp + 127).to(torch.int32)
        # 2^exp from its exponent bits (exact on any device; e = 0 is the
        # subnormal 2^-127)
        pow2 = torch.where(e > 0, e << 23, torch.full_like(e, 1 << 22)).view(
            torch.float32
        )
        scaled = g / pow2
        idx = torch.bucketize(scaled.abs(), mids)
        neg = scaled < 0
        nib = (idx | (neg.long() << 3)).to(torch.uint8)
        blocks.append(nib[..., 0::2] | (nib[..., 1::2] << 4))
        scales.append(e[..., 0].to(torch.uint8))
        value = torch.where(neg, -steps[idx], steps[idx]) * pow2
        rounded.append(value.reshape(we.shape[1], -1).T.to(torch.bfloat16))
    return torch.stack(blocks), torch.stack(scales), torch.stack(rounded)


def _mxfp4_experts(tree):
    """Pack every GPT-OSS expert weight of ``tree`` as MXFP4 and put the
    rounded weights in the tree in place of the originals: returns {HF
    tensor name: (blocks, scales)}."""
    lp, packed = tree["layers"], {}
    for j in range(len(lp["attn_norm"])):
        name = f"model.layers.{j}.mlp.experts."
        blocks, scales, gu = _pack_mxfp4(
            _interleave(lp["we_gate"][j], lp["we_up"][j])
        )
        packed[name + "gate_up_proj"] = (blocks, scales)
        lp["we_gate"][j].copy_(gu[..., 0::2])
        lp["we_up"][j].copy_(gu[..., 1::2])
        blocks, scales, down = _pack_mxfp4(lp["we_down"][j])
        packed[name + "down_proj"] = (blocks, scales)
        lp["we_down"][j].copy_(down)
    return packed


def _hf_config(cfg):
    """``config.json`` for ``cfg``: LlamaForCausalLM, DeepseekV2ForCausalLM
    for MLA, GptOssForCausalLM for GPT-OSS, Qwen3MoeForCausalLM for the
    other MoE models, GemmaForCausalLM for the delta-gain norms alone, or
    Gemma2ForCausalLM for the sandwich norms."""
    hf = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "vocab_size": cfg.vocab_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
    }
    layer_types = [
        "sliding_attention" if s else "full_attention"
        for s in cfg.layer_sliding or ()
    ]
    if cfg.is_mla:
        del hf["head_dim"]                  # qk_nope + qk_rope
        hf.update({
            "architectures": ["DeepseekV2ForCausalLM"],
            "model_type": "deepseek_v2",
            "rope_scaling": cfg.rope_scaling,
            "q_lora_rank": cfg.q_lora_rank or None,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim,
            "n_routed_experts": cfg.num_experts,
            "n_shared_experts": cfg.n_shared_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "first_k_dense_replace": cfg.first_k_dense,
            "moe_layer_freq": 1,
            "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "scoring_func": "softmax",
            "topk_method": "greedy",
            "n_group": 1,
            "topk_group": 1,
        })
    elif cfg.moe_act == "gptoss":
        hf.update({
            "architectures": ["GptOssForCausalLM"],
            "model_type": "gpt_oss",
            "intermediate_size": cfg.moe_intermediate_size,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "rope_scaling": cfg.rope_scaling,
            "sliding_window": cfg.sliding_window,
            "layer_types": layer_types,
            "attention_bias": True,
        })
    elif cfg.is_moe:
        hf.update({
            "architectures": ["Qwen3MoeForCausalLM"],
            "model_type": "qwen3_moe",
            "num_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok,
            "moe_intermediate_size": cfg.moe_intermediate_size,
            "norm_topk_prob": cfg.norm_topk_prob,
            "decoder_sparse_step": 1,
            "mlp_only_layers": [],
        })
    elif cfg.norm_delta_gain and not cfg.post_norms:
        hf.update({
            "architectures": ["GemmaForCausalLM"],
            "model_type": "gemma",
            "hidden_activation": "gelu_pytorch_tanh",
        })
    elif cfg.post_norms:
        hf.update({
            "architectures": ["Gemma2ForCausalLM"],
            "model_type": "gemma2",
            "hidden_activation": "gelu_pytorch_tanh",
            "query_pre_attn_scalar": cfg.query_pre_attn_scalar,
            "attn_logit_softcapping": cfg.attn_logit_softcap,
            "final_logit_softcapping": cfg.final_logit_softcap,
            "sliding_window": cfg.sliding_window,
            "layer_types": layer_types,
        })
    return hf


_ST_NAMES = {torch.bfloat16: "BF16", torch.float32: "F32",
             torch.uint8: "U8"}


def write_safetensors(path, tensors):
    """A minimal safetensors writer (bf16, fp32 and uint8): 8-byte header
    length, the JSON header padded to 8 bytes, then each tensor's bytes in
    order. Returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy())
    return 8 + len(head) + offset


def _leaves(tree, prefix=""):
    """{path: tensor} over a param tree, nested stacks (``layers``,
    ``dense_layers``) and a diffusion tree's lists included (its ``None``
    nodes hold no leaf)."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


# leaves the init draws as zeros (biases, sinks, the affine router's bias,
# Gemma's delta gains): the checkpoint phase draws them at random, so a
# swapped or dropped one shows in the round trip
ZERO_INIT_LEAVES = ("bq", "bk", "bv", "bo", "sinks", "router_bias",
                    "we_gate_b", "we_up_b", "we_down_b")
DELTA_GAINS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
               "q_norm", "k_norm")


def phase_checkpoint(kind, smi, preset="llama3-8b", device="cuda",
                     mxfp4=False, int8=False, cfg=None, serve=None):
    """``preset`` (llama3-8b, qwen3-30b-a3b in Qwen3-MoE naming,
    deepseek-v2-lite in DeepSeek-V2 naming: one dense layer, one MoE;
    gpt-oss-20b in GPT-OSS naming; gemma2-9b in Gemma2 naming, tied) at
    full width but 2 layers (depth cut for disk and time), random bf16
    weights from a seed (its zero-initialised leaves drawn too), written
    as a safetensors checkpoint and served through ``--model-dir``: the
    loaded tree and a prompt's last-position logits must equal the
    in-memory tree's, bit for bit. With ``mxfp4`` the GPT-OSS expert
    weights go to disk as MXFP4 blocks and scales, and the in-memory tree
    is the one the packing rounds them to. With ``int8`` the same
    checkpoint is also served with ``--quantization int8``: its tree must
    equal ``quantize_params`` of the in-memory tree, bit for bit, and so
    must a prompt's logits through the kernels. ``cfg`` stands in for the
    preset's config (a published config.json read by ``load_hf_config``);
    ``serve(engine)`` replaces the one chat the loaded engine answers
    (it starts and stops the engine) and its result is returned."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.models.transformer import init_params

    base = cfg if cfg is not None else get_config(preset)
    cfg = dataclasses.replace(base, num_layers=2)
    if cfg.layer_sliding:
        cfg = dataclasses.replace(cfg, layer_sliding=cfg.layer_sliding[:2])
    gen = torch.Generator(device=device).manual_seed(7)
    tree = init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    zeros = ZERO_INIT_LEAVES + (DELTA_GAINS if cfg.norm_delta_gain else ())
    for key in zeros:
        if key in tree["layers"]:
            tree["layers"][key].uniform_(-0.2, 0.2, generator=gen)
    if cfg.norm_delta_gain:
        tree["final_norm"].uniform_(-0.2, 0.2, generator=gen)
    packed = _mxfp4_experts(tree) if mxfp4 else None
    with tempfile.TemporaryDirectory(prefix="ckpt-") as model_dir:
        t0 = time.perf_counter()
        nbytes = write_safetensors(
            os.path.join(model_dir, "model.safetensors"),
            _hf_named(tree, cfg, packed),
        )
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(_hf_config(cfg), f)
        write_s = time.perf_counter() - t0
        argv = [
            "--model-dir", model_dir, "--max-slots", "8",
            "--max-seq-len", "2048", "--device", device,
        ]
        t0 = time.perf_counter()
        engine = build_engine_from_args(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if int8:
            t0 = time.perf_counter()
            engine8 = build_engine_from_args(
                build_parser().parse_args(argv + ["--quantization", "int8"])
            )
            torch.cuda.synchronize()
            int8_load_s = time.perf_counter() - t0
    if dataclasses.replace(engine.cfg, name=cfg.name) != cfg:
        raise AssertionError(f"config.json read back as {engine.cfg}")
    loaded = engine.runner.params
    got, want = _leaves(loaded), _leaves(tree)
    mismatched = [
        key for key, b in want.items()
        if key not in got or got[key].dtype != b.dtype
        or not torch.equal(got[key], b)
    ]
    if mismatched or got.keys() != want.keys():
        raise AssertionError(f"loaded checkpoint differs at {mismatched}")
    in_memory = ModelRunner(
        engine.cfg, tree, engine.runner.device, max_slots=8,
        max_seq_len=2048,
    )
    prompt = engine.tokenizer.encode("A checkpoint from disk. " * 30)
    padded = prompt + [0] * (engine.runner.bucket_for(len(prompt))
                             - len(prompt))
    with torch.no_grad():
        got, _, _ = engine.runner.prefill(padded, len(prompt))
        want, _, _ = in_memory.prefill(padded, len(prompt))
    if not torch.isfinite(got).all() or not torch.equal(got, want):
        raise AssertionError(
            "logits of the loaded checkpoint differ from the in-memory "
            f"tree's: max |err| {(got - want).abs().max().item()}"
        )
    int8_report = None
    if int8:
        int8_report = _int8_checkpoint_check(engine8, tree, padded,
                                             len(prompt))
        int8_report["load_s"] = int8_load_s
        del engine8
    del in_memory, tree, loaded, got, want
    served = usage = None
    if serve is not None:
        served = serve(engine)
    else:
        engine.start()
        server = OpenAIServer(engine)
        port = server.start("127.0.0.1", 0)
        try:
            _, raw = _post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "Hello from disk."}],
                "max_tokens": 8, "temperature": 0,
            })
            usage = _check_usage(json.loads(raw))
        finally:
            server.shutdown()
            engine.stop()
    depth = base.num_layers
    emit("checkpoint", model=f"{cfg.name} (2 of {depth} layers)",
         experts="MXFP4 blocks and scales" if mxfp4 else None,
         device=kind, nvidia_smi=smi, checkpoint_gb=nbytes / 1e9, write_s=write_s,
         load_s=load_s, load_gb_per_s=nbytes / 1e9 / load_s,
         logits="identical bits", prompt_tokens=len(prompt),
         chat_usage=usage, **({"int8": int8_report} if int8 else {}))
    return served


def _int8_checkpoint_check(engine8, tree, padded, n_prompt):
    """The checkpoint served with ``--quantization int8`` (loaded, then
    quantized a layer at a time on the card) against ``quantize_params``
    of the in-memory bf16 tree: every leaf, int8 values and bf16 scales,
    bit for bit, and a prompt's logits through the kernels."""
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.models.quant import QuantW, quantize_params

    want_tree = quantize_params(tree)
    got, want = _leaves(engine8.runner.params), _leaves(want_tree)

    def same(a, b):
        if isinstance(b, QuantW):
            return isinstance(a, QuantW) and all(
                x.dtype == y.dtype and torch.equal(x, y)
                for x, y in ((a.q, b.q), (a.s, b.s))
            )
        return a.dtype == b.dtype and torch.equal(a, b)

    mismatched = [k for k, b in want.items() if k not in got
                  or not same(got[k], b)]
    if mismatched or got.keys() != want.keys():
        raise AssertionError(f"int8 checkpoint tree differs at {mismatched}")
    quantized = sorted(k for k, b in want.items() if isinstance(b, QuantW))
    in_memory = ModelRunner(
        engine8.cfg, want_tree, engine8.runner.device, max_slots=8,
        max_seq_len=2048,
    )
    with torch.no_grad():
        logits, _, _ = engine8.runner.prefill(padded, n_prompt)
        ref, _, _ = in_memory.prefill(padded, n_prompt)
    if not torch.isfinite(logits).all() or not torch.equal(logits, ref):
        raise AssertionError("int8 checkpoint logits differ from the "
                             "quantized in-memory tree's")
    return {"tree": "identical bits", "quantized_leaves": quantized,
            "int8_gb": _tree_gb(engine8.runner.params),
            "logits": "identical bits"}


def _int8_logit_check(engine):
    """The int8 tree's last-position logits through the kernels against the
    same tree through the W8A16 plain versions, 2-D and grouped (outside
    the counted window). On an MoE model the plain run replays the kernel
    run's expert picks (:class:`_RoutingTape`), and the free-routing
    comparison is reported beside it."""
    from gpustack_tpu_torch.ops import w8a16

    runner = engine.runner
    cfg = runner.cfg
    prompt = engine.tokenizer.encode("The int8 logit check. " * 40)
    bucket = runner.bucket_for(len(prompt))
    padded = prompt + [0] * (bucket - len(prompt))

    def plain_last():
        kernel = w8a16.w8a16_matmul
        w8a16.w8a16_matmul = w8a16.w8a16_plain
        try:
            with _PlainGrouped():
                return runner.prefill(padded, len(prompt))[0]
        finally:
            w8a16.w8a16_matmul = kernel

    moe = {}
    with torch.no_grad(), _RoutingTape() as tape:
        kernel_last, _, _ = runner.prefill(padded, len(prompt))
        tape.mode = "replay"
        plain = plain_last()
        if tape.picks:
            tape.mode = "free"
            moe = {
                "routing": "the kernel run's expert picks replayed",
                "free_routing": {
                    **_compare_logits(kernel_last, plain_last()),
                    "tokens_with_a_flipped_pick_per_layer": tape.flips,
                },
            }
    if kernel_last.shape != (cfg.vocab_size,) or not torch.isfinite(
        kernel_last
    ).all():
        raise AssertionError(f"bad logits {tuple(kernel_last.shape)}")
    scale = plain.abs().max().item()
    err = (kernel_last - plain).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        kernel_last, plain, dim=0
    ).item()
    emit("int8_logit_check", model=cfg.name, prompt_tokens=len(prompt),
         bucket=bucket, max_abs_err=err, logit_scale=scale, cosine=cos,
         **moe,
         tolerance={"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE})
    if err > LOGIT_REL_TOL * scale or cos < LOGIT_MIN_COSINE:
        raise AssertionError(
            f"int8 kernel logits differ from the plain version: max |err| "
            f"{err} (scale {scale}), cosine {cos}"
        )
    return scale


F_ARGV = MAIN_ARGV + ["--quantization", "int8"]


def phase_int8(kind, smi, bf16):
    """llama3-8b int8 at full width and depth, drawn on the card, through
    the server: the main path's requests with exact W8A16 and flash
    launch counts, beside phase d's bf16 numbers from this run."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.quant import QuantW

    torch.cuda.reset_peak_memory_stats()
    args = build_parser().parse_args(F_ARGV)
    t0 = time.perf_counter()
    engine = build_engine_from_args(args)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.runner.params
    weights = [params["lm_head"], params["embed"]] + [
        params["layers"][k] for k in (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"
        )
    ]
    if not all(isinstance(w, QuantW) for w in weights):
        raise AssertionError("the int8 tree holds a weight that is not int8")
    weight_gb = sum(
        t.numel() * t.element_size() for w in weights for t in (w.q, w.s)
    ) / 1e9
    report, windows = _serve_counted(engine, _int8_logit_check, int8=True)
    counts = windows["served"]
    keys = ("ttft_ms_2048_bucket", "decode_tokens_per_s_8_slots",
            "prefill_ms_2048_bucket", "peak_mem_gb")
    emit("int8_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, launches=counts, int8_weight_gb=weight_gb,
         **report, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         bf16_same_run={k: bf16[k] for k in keys})
    return counts


# ---------------------------------------------------------------------------
# g: speculation, embeddings, profile
# ---------------------------------------------------------------------------

G_NGRAM_ARGV = F_ARGV + ["--speculative", "ngram"]
G_DRAFT_ARGV = MAIN_ARGV + ["--speculative", "draft",
                            "--draft-source", "llama3-8b"]
# repetitive greedy chats: material for the n-gram proposer
SPEC_CHATS = [
    f"Repeat after me: {w} {w} {w} {w} {w} {w}."
    for w in ("alpha beta", "one two three", "la la", "tick tock",
              "red green blue", "spec spec", "go go go", "abc abc")
]
SPEC_MAX_TOKENS = 64
# two forwards that each stay within LOGIT_REL_TOL of the logit scale can
# put two logits at most twice that apart: a greedy choice may flip only
# where the top two were closer
IDS_GAP_REL = 2 * LOGIT_REL_TOL
EMBED_MIN_COSINE = 0.999
PROFILE_STEPS = 20
# the embedding batch: 8 inputs, the longest 1900 tokens (the 2048 bucket)
EMBED_TEXTS = ["x" * 1900] + [
    f"Embedding input {i}: " + "the H100 serves " * (4 + 9 * i)
    for i in range(7)
]


def _greedy(engine, port, logprobs):
    """The chats, all at once, through the engine's ``submit`` (the ids
    and, on the plain engine, each position's top-2 logprobs), then one
    through the server with temperature left unset (0 on a speculative
    server). Returns ([(ids, top-2 gaps)], decode tokens/s)."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    tok = engine.tokenizer
    reqs = [
        engine.submit(GenRequest(
            prompt_ids=tok.apply_chat_template(
                [{"role": "user", "content": c}]
            ),
            max_tokens=SPEC_MAX_TOKENS, temperature=0.0, logprobs=logprobs,
            top_logprobs=2 if logprobs else 0,
        ))
        for c in SPEC_CHATS
    ]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError("a greedy chat timed out")
        if r.finish_reason not in ("stop", "length"):
            raise AssertionError(f"a greedy chat ended {r.finish_reason}")
    t_first = max(r.first_token_at for r in reqs)
    t_end = max(r.finished_at for r in reqs)
    rate = sum(len(r.output_ids) - 1 for r in reqs) / max(
        t_end - t_first, 1e-9)
    out = [
        (r.output_ids, [t[0][1] - t[1][1] for t in r.output_top_logprobs]
         if logprobs else None)
        for r in reqs
    ]
    _, raw = _post(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": SPEC_CHATS[0]}],
        "max_tokens": 8,
    })
    _check_usage(json.loads(raw))
    return out, rate


def _ids_rule(plain, spec, threshold):
    """Speculative ids against plain greedy ones: equal, or parting only
    where the plain run's top two were within ``threshold``."""
    full, partings = 0, []
    for (p_ids, gaps), (s_ids, _) in zip(plain, spec):
        if p_ids == s_ids:
            full += 1
            continue
        i = next((j for j, (a, b) in enumerate(zip(p_ids, s_ids)) if a != b),
                 min(len(p_ids), len(s_ids)))
        gap = gaps[i] if i < len(gaps) else None
        partings.append({"position": i, "top2_gap": gap})
        if gap is None or not gap < threshold:
            raise AssertionError(
                f"speculative ids part from plain greedy at {i} where the "
                f"top-2 gap {gap} is not under {threshold}"
            )
    return {"prompts": len(plain), "identical": full, "partings": partings,
            "gap_threshold": threshold}


def _window(name, calls, body):
    """Run ``body`` with every launch counted; the counts must equal what
    the runners' forwards in it need."""
    reset_launch_counts()
    for c in calls:
        c.reset()
    out = body()
    counts = launch_counts()
    check_launches(name, counts, expected_launches(calls))
    return counts, out


def _embed_checks(engine, port):
    """``/v1/embeddings`` at the 2048 bucket (8 rows), ``dimensions``,
    ``base64`` and ``/v1/rerank``; returns (vectors, report)."""
    tok = engine.tokenizer
    lens = [len(tok.encode(t)) for t in EMBED_TEXTS]
    if engine.runner.bucket_for(max(lens)) != 2048:
        raise AssertionError(f"embedding batch lengths {lens}")
    t0 = time.perf_counter()
    _, raw = _post(port, "/v1/embeddings", {"input": EMBED_TEXTS})
    batch_ms = (time.perf_counter() - t0) * 1e3
    data = json.loads(raw)
    vecs = torch.tensor([d["embedding"] for d in data["data"]])
    if vecs.shape != (8, engine.cfg.hidden_size) or not torch.isfinite(
        vecs
    ).all() or (vecs.norm(dim=-1) - 1).abs().max() > 1e-3:
        raise AssertionError(f"bad embeddings {tuple(vecs.shape)}")
    if data["usage"]["prompt_tokens"] != sum(lens):
        raise AssertionError(f"embedding usage {data['usage']}")
    dims = engine.cfg.hidden_size // 16                 # 256 at llama3-8b
    _, raw = _post(port, "/v1/embeddings",
                   {"input": EMBED_TEXTS[1], "dimensions": dims})
    cut = torch.tensor(json.loads(raw)["data"][0]["embedding"])
    _, raw = _post(port, "/v1/embeddings",
                   {"input": EMBED_TEXTS[1], "encoding_format": "base64"})
    packed = base64.b64decode(json.loads(raw)["data"][0]["embedding"])
    full = torch.tensor(struct.unpack(f"<{len(packed) // 4}f", packed))
    want_cut = full[:dims] / full[:dims].norm()
    if cut.shape != (dims,) or (cut - want_cut).abs().max() > 1e-5:
        raise AssertionError(f"dimensions={dims} is not the renormalised cut")
    query = "Embedding input 2"
    _, raw = _post(port, "/v1/rerank",
                   {"query": query, "documents": EMBED_TEXTS[1:], "top_n": 4})
    results = json.loads(raw)["results"]
    scores = [r["relevance_score"] for r in results]
    if len(results) != 4 or scores != sorted(scores, reverse=True):
        raise AssertionError(f"rerank results out of order: {scores}")
    return vecs, {"batch": 8, "bucket": 2048, "input_tokens": lens,
                  "http_ms_batch": batch_ms, "rerank_scores": scores,
                  f"dimensions_{dims}": "renormalised cut",
                  "base64": "round trip"}


def _embed_reference(engine, vecs, tape=None):
    """Outside the counted window: the served vectors against a reference
    of the same inputs, and one 8 x 2048 embedding forward timed with
    CUDA events. Where the config takes the flash kernel the reference is
    each row through the same forward with the plain attention (one row
    at a time, the batch's bucket); where it does not, the batch through
    the fp32 plain forward (:func:`_fp32_model`) with the served batch's
    expert picks replayed from ``tape`` (an MoE model's; its recording of
    the served window)."""
    from gpustack_tpu_torch.models import transformer as tf

    tape = tape or _RoutingTape()
    runner, tok = engine.runner, engine.tokenizer
    ids = [tok.encode(t) for t in EMBED_TEXTS]
    padded = [r + [0] * (2048 - len(r)) for r in ids]
    flash = tf.flash_eligible(runner.cfg)
    cos = []
    with torch.no_grad():
        if flash:
            runner.attn_impl_for = lambda bucket: "plain"
            try:
                for row, r, v in zip(padded, ids, vecs):
                    plain = runner.embed([row], [len(r)])[0].float().cpu()
                    cos.append(torch.nn.functional.cosine_similarity(
                        plain, v, dim=0).item())
            finally:
                del runner.attn_impl_for
        else:
            params, cfg32 = _fp32_model(runner)
            tokens = torch.tensor(padded, device=runner.device)
            positions = torch.arange(2048, device=runner.device)[None, :]
            tape.mode = "replay"
            with tape, _PlainGrouped():
                hidden, _ = tf.forward(
                    params, cfg32, tokens, positions.expand(len(padded), -1),
                    return_hidden=True, attn_impl="plain",
                )
            lens = torch.tensor([len(r) for r in ids], device=runner.device)
            mask = (positions < lens[:, None])[..., None].float()
            pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1)
            ref = torch.nn.functional.normalize(pooled, dim=-1).cpu()
            cos = torch.nn.functional.cosine_similarity(
                ref, vecs, dim=-1).tolist()
        times = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runner.embed(padded, [len(r) for r in ids])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    if min(cos) < EMBED_MIN_COSINE:
        raise AssertionError(
            f"served embeddings against the reference: cosines {cos}"
        )
    reference = {
        "reference": ("plain attention, bf16" if flash
                      else "fp32 plain forward"),
        "cosine_vs_reference": cos,
        "forward_ms_8x2048": statistics.median(times[1:]),
    }
    if tape.picks:
        reference["routing"] = (
            "the served batch's expert picks replayed" if not flash
            else "free"
        )
        if not flash:
            reference["tokens_with_a_flipped_pick"] = sum(tape.flips)
    return reference


def summarize_trace(path, steps):
    """From a Chrome trace: the union of device intervals over the
    captured window (busy share), the 10 kernels with the most device
    time, and the device's idle time per step (host time between
    kernels)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not any(e["cat"] == "kernel" for e in device):
        raise AssertionError(f"{path}: the trace holds no kernel")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end, gaps = 0.0, None, []
    for e in sorted(device, key=lambda e: e["ts"]):
        s, f = e["ts"], e["ts"] + e["dur"]
        if end is None or s > end:
            if end is not None:
                gaps.append(s - end)
            busy += f - s
            end = f
        elif f > end:
            busy += f - end
            end = f
    by_name = {}
    for e in device:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    window = t1 - t0
    return {
        "window_ms": window / 1e3, "steps_in_trace": steps,
        "device_busy_share": busy / window,
        "device_ms_per_step": busy / steps / 1e3,
        "idle_ms_per_step": (window - busy) / steps / 1e3,
        "kernels_per_step": sum(e["cat"] == "kernel" for e in device) / steps,
        "gap_us_median": statistics.median(gaps) if gaps else 0.0,
        "gap_us_max": max(gaps, default=0.0),
        "top_device_ops": [
            {"name": _short_kernel_name(n), "ms": us / 1e3, "calls": c,
             "share": us / busy}
            for n, (us, c) in top
        ],
        "trace_mb": os.path.getsize(path) / 1e6,
    }


def _short_kernel_name(name):
    """A kernel's name without its parameter list and namespaces, keeping
    the functor an ATen elementwise kernel was instantiated for."""
    name = re.sub(r"\(anonymous namespace\)::|at::native::|c10::|void ", "",
                  name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):       # drop the trailing parameter list
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i:
            cut = i
            break
    return name[:cut][:240]


def _profile(port, label, read_trace=None):
    """``/debug/profile?steps=20`` while 8 chats decode; the trace
    summarised (and read by ``read_trace``, when given, into more
    fields)."""
    from gpustack_tpu_torch.engine.engine import PROFILE_TRACE_FILE

    started = [threading.Event() for _ in range(8)]
    chats = [
        threading.Thread(target=_stream_chat, args=(
            port, [{"role": "user", "content": f"Profile chat {i} " * 3}],
            256, None, started[i]))
        for i in range(8)
    ]
    for t in chats:
        t.start()
    for e in started:
        if not e.wait(120):
            raise AssertionError("a chat never streamed")
    out_dir = tempfile.mkdtemp(prefix=f"profile-{label}-")
    time.sleep(0.5)             # unprofiled decode steps to compare with
    t_capture = time.time()
    try:
        _, raw = _post(
            port, f"/debug/profile?steps={PROFILE_STEPS}&timeout_s=120"
            f"&out_dir={out_dir}", {},
        )
        result = json.loads(raw)
        if result["profiler"] != "torch" or result["steps_captured"] != (
            PROFILE_STEPS
        ):
            raise AssertionError(f"profile capture: {result['error']} "
                                 f"{result['steps_captured']} steps")
        # the trace opens after the first captured step's record
        summary = summarize_trace(
            os.path.join(out_dir, PROFILE_TRACE_FILE), PROFILE_STEPS - 1
        )
        if read_trace is not None:
            summary.update(read_trace(
                os.path.join(out_dir, PROFILE_TRACE_FILE)))
    finally:
        for t in chats:
            t.join(timeout=600)
        for name in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, name))
        os.rmdir(out_dir)
    if any(t.is_alive() for t in chats):
        raise AssertionError("a profiled chat did not finish")
    records = json.loads(_get(port, "/debug/flight?limit=400"))["records"]
    before = [r["dur_ms"] for r in records
              if r["ts"] < t_capture and r["mode"] == "decode"][-20:]
    if not before:
        raise AssertionError("no decode step before the capture")
    unprofiled = statistics.median(before)
    return {**summary, "profiler_start_ms": result["profiler_start_ms"],
            "flight_modes": result["aggregate"]["modes"],
            # the profiler slows the host; kernels keep their time
            "step_ms_unprofiled": unprofiled,
            "device_busy_share_unprofiled": (
                summary["device_ms_per_step"] / unprofiled
            )}


def _spec_pair(argv, int8, label, kind, smi):
    """A speculative server built from ``argv`` and a plain server over
    the same target weights, both through the port's server: greedy chats
    on each (ids held to the rule above), the embedding and profile checks
    on the plain one. Every window's launches are exact. Returns ({window:
    counts}, report)."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.engine.engine import LLMEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec = build_engine_from_args(build_parser().parse_args(argv))
    plain = LLMEngine(
        spec.cfg, spec.runner.params, tokenizer=spec.tokenizer,
        max_slots=spec.max_slots, max_seq_len=spec.max_seq_len,
        device=spec.device,
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check = _int8_logit_check if int8 else _logit_check
    scale = check(plain)
    spec_calls = [RunnerCalls(spec.runner, int8)]
    if spec.draft_runner is not None:
        spec_calls.append(RunnerCalls(spec.draft_runner, False))
    plain_calls = [RunnerCalls(plain.runner, int8)]
    servers, ports = [], []
    for engine in (spec, plain):
        engine.start()
        servers.append(OpenAIServer(engine))
        ports.append(servers[-1].start("127.0.0.1", 0))
    windows = {}
    try:
        windows[f"{label}_plain"], (p_out, p_rate) = _window(
            f"{label} plain chats", plain_calls,
            lambda: _greedy(plain, ports[1], logprobs=True),
        )
        windows[f"{label}_spec"], (s_out, s_rate) = _window(
            f"{label} speculative chats", spec_calls,
            lambda: _greedy(spec, ports[0], logprobs=False),
        )
        health = spec.health()
        rule = _ids_rule(p_out, s_out, IDS_GAP_REL * scale)
        windows[f"{label}_embed"], (vecs, embed) = _window(
            f"{label} embeddings", plain_calls,
            lambda: _embed_checks(plain, ports[1]),
        )
        embed.update(_embed_reference(plain, vecs))
        windows[f"{label}_profile"], profile = _window(
            f"{label} profile", plain_calls,
            lambda: _profile(ports[1], label),
        )
        for engine in (spec, plain):
            if engine.health()["status"] != "ok":
                raise AssertionError(f"engine unhealthy: {engine.health()}")
    finally:
        for server in servers:
            server.shutdown()
        spec.stop()
        plain.stop()
    report = {
        "model": spec.cfg.name, "weights": "int8" if int8 else "bf16",
        "speculative": health["speculative"],
        "draft_model": health["draft_model"], "device": kind,
        "nvidia_smi": smi, "setup_s": setup_s,
        "spec_steps": health["spec_steps"],
        "spec_extra_tokens": health["spec_extra_tokens"],
        "spec_acceptance_rate": health["spec_acceptance_rate"],
        "ids_rule": rule, "logit_scale": scale,
        "decode_tokens_per_s_8_chats": {"plain": p_rate,
                                        "speculative": s_rate},
        "embeddings": embed, "profile": profile,
        "runner_calls": {w: c.counts() for w, c in (
            ("spec", spec_calls[0]), ("plain", plain_calls[0]))},
        "launches": windows,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return windows, report


def phase_speculation(kind, smi):
    """n-gram speculation on llama3-8b int8 and a perfect draft on bf16,
    each beside a plain server over the same weights; embeddings and a
    profile on each plain server."""
    windows, ngram = _spec_pair(G_NGRAM_ARGV, True, "ngram_int8", kind, smi)
    if ngram["spec_steps"] < 1 or ngram["spec_extra_tokens"] < 1:
        raise AssertionError(f"n-gram speculation accepted nothing: {ngram}")
    emit("speculation_ngram_int8", **ngram)
    _free()
    more, draft = _spec_pair(G_DRAFT_ARGV, False, "draft_bf16", kind, smi)
    emit("speculation_draft_bf16", **draft)
    if draft["spec_acceptance_rate"] < 0.9:
        raise AssertionError(
            f"a perfect draft accepted {draft['spec_acceptance_rate']}"
        )
    windows.update(more)
    return windows


# ---------------------------------------------------------------------------
# h: the MoE family
# ---------------------------------------------------------------------------

H_PRESET = "qwen3-30b-a3b"
H_ARGV = ["--preset", H_PRESET] + MAIN_ARGV[2:]
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
# one MoE layer in bf16 against an fp32 routed reference (each token
# through its own top-k experts only): bf16 rounding of x, g, u, h·c and
# the output, relative to the output's scale
MOE_REL_TOL = 2e-2
MOE_MIN_COSINE = 0.999


def _wide(w):
    """One [K, N] weight in fp32; an int8 ``QuantW`` dequantized exactly
    (q times its per-column scale)."""
    from gpustack_tpu_torch.models.quant import QuantW

    if isinstance(w, QuantW):
        return w.q.float() * w.s.float()
    return w.float()


def _moe_routed_reference(x, lp, li, cfg):
    """One MoE layer computed the routed way, in fp32: each expert over
    only the tokens that picked it, then ``routed_scaling_factor`` and the
    ungated shared experts (DeepSeek) where the layer has them; GPT-OSS's
    router bias, expert biases and clamped GLU where it has them. An
    independent formulation of what the dense dispatch computes."""
    from gpustack_tpu_torch.models import transformer as tf

    def mlp(xs, g, u, d, e=None):
        g, u = xs @ _wide(g), xs @ _wide(u)
        if e is None or cfg.moe_act != "gptoss":
            return (torch.nn.functional.silu(g) * u) @ _wide(d)
        g = (g + lp["we_gate_b"][li, e].float()).clamp(max=7.0)
        u = (u + lp["we_up_b"][li, e].float()).clamp(-7.0, 7.0)
        h = (u + 1.0) * (g * torch.sigmoid(1.702 * g))
        return h @ _wide(d) + lp["we_down_b"][li, e].float()

    xf = x.reshape(-1, cfg.hidden_size).float()
    top_idx, combine = tf.moe_route(
        xf, lp["router"][li], cfg,
        lp["router_bias"][li] if "router_bias" in lp else None,
    )
    out = torch.zeros_like(xf)
    for e in top_idx.unique().tolist():
        rows = (top_idx == e).any(dim=-1).nonzero().squeeze(1)
        out[rows] += combine[rows, e, None] * mlp(
            xf[rows], lp["we_gate"][li, e], lp["we_up"][li, e],
            lp["we_down"][li, e], e,
        )
    out *= cfg.routed_scaling_factor
    if "ws_gate" in lp:
        out += mlp(xf, lp["ws_gate"][li], lp["ws_up"][li], lp["ws_down"][li])
    return out, top_idx


def _moe_layer_case(params, cfg, tokens, gen, li=0):
    """Layer ``li``'s MoE block over ``tokens`` rows (normalised random
    input): held against the routed fp32 reference, run once under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read of a device
    value: the engine's dispatch-ahead never waits on it), timed with
    CUDA events beside its dense-dispatch and routed bounds (the experts
    this input's routing reaches; at the 2048 bucket it must beat the
    dense bound, which only a layer that reads the picked experts alone
    can), its transient device memory (the routed formula's), and a
    ``torch.profiler`` split of its device time by kernel."""
    from gpustack_tpu_torch.models import transformer as tf
    from gpustack_tpu_torch.models.quant import QuantW

    lp = params["layers"]
    D, E, Fm, k = (cfg.hidden_size, cfg.num_experts,
                   cfg.moe_intermediate_size, cfg.num_experts_per_tok)
    int8 = isinstance(lp["we_gate"], QuantW)
    Fs = cfg.shared_expert_intermediate_size if "ws_gate" in lp else 0
    x = tf.rms_norm(
        torch.randn(1, tokens, D, generator=gen, device=gen.device).bfloat16(),
        lp["mlp_norm"][li], cfg.rms_norm_eps,
    )

    shared = (lp["ws_gate"][li], lp["ws_up"][li], lp["ws_down"][li],
              None) if Fs else None
    biases = (lp["we_gate_b"][li], lp["we_up_b"][li],
              lp["we_down_b"][li]) if cfg.moe_bias else None
    router_bias = lp["router_bias"][li] if "router_bias" in lp else None

    def layer():
        return tf._moe_mlp(x, lp["router"][li], lp["we_gate"][li],
                           lp["we_up"][li], lp["we_down"][li], cfg,
                           router_bias=router_bias, shared=shared,
                           biases=biases)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = layer()
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - base
    ref, top_idx = _moe_routed_reference(x, lp, li, cfg)
    got = out.reshape(-1, D).float()
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        got.flatten(), ref.flatten(), dim=0
    ).item()
    if not torch.isfinite(got).all() or err > MOE_REL_TOL * scale or (
        cos < MOE_MIN_COSINE
    ):
        raise AssertionError(
            f"MoE layer at {tokens} tokens differs from the routed "
            f"reference: max |err| {err} (scale {scale}), cosine {cos}"
        )
    # one chunk's routed transients: x gathered, g, u, h and y, k·(3·Fm +
    # 2·D) values a token; beyond them only small tensors (the router's,
    # the fp32 token sum, indices, the shared experts', the output)
    chunk = min(tokens, tf.moe_chunk_tokens(k, Fm, D, 2))
    routed = chunk * k * (3 * Fm + 2 * D) * 2
    x_copy = E * tokens * D * 2
    if transient > routed + (64 << 20):
        raise AssertionError(
            f"MoE layer at {tokens} tokens held {transient / 1e9} GB of "
            f"transients; the routed x, g, u, h and y are {routed / 1e9} GB"
        )
    torch.cuda.set_sync_debug_mode("error")
    try:
        layer()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms = cuda_time_ms(layer)
    # where a call's device time goes, by kernel (three calls traced)
    with tempfile.TemporaryDirectory(prefix="moe-trace-") as d:
        path = os.path.join(d, "trace.json")
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            for _ in range(3):
                layer()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        trace = summarize_trace(path, 3)
    reached = int(top_idx.unique().numel())
    # a weight's bytes per value, and its scales: int8 q and a bf16 scale
    # per output column, or bf16
    wb = 1 if int8 else 2
    # x in, out, the router, and the shared experts (every token's)
    io = (2 * tokens * D * 2 + D * E * 2 + 3 * D * Fs * wb
          + ((2 * Fs + D) * 2 if int8 and Fs else 0))
    # one expert's weights (their scales, GPT-OSS's biases)
    expert_bytes = (3 * D * Fm * wb + ((2 * Fm + D) * 2 if int8 else 0)
                    + (2 * Fm + D) * 2 * bool(biases))
    router_ops = 2 * tokens * D * E / PEAK_FP32_FLOPS * 1e3

    def bound(experts_read, expert_rows):
        flop = 2 * 3 * D * (expert_rows * Fm + tokens * Fs)
        t_ops = flop / PEAK_BF16_FLOPS * 1e3 + router_ops
        t_bytes = (io + experts_read * expert_bytes) / PEAK_BYTES_S * 1e3
        return {"ms": max(t_ops, t_bytes),
                "by": "operations" if t_ops >= t_bytes else "bytes",
                "tflop": flop / 1e12,
                "gbytes": (io + experts_read * expert_bytes) / 1e9}

    dense = bound(E, tokens * E)
    if tokens >= 2048 and not ms < dense["ms"]:
        raise AssertionError(
            f"MoE layer at {tokens} tokens took {ms} ms, not below its dense "
            f"bound {dense['ms']} ms: it reads more than the picked experts"
        )
    return {
        "tokens": tokens, "experts": "int8" if int8 else "bf16",
        "ms": ms, "ms_per_token": ms / tokens,
        "dense_bound": dense,
        "routed_bound": bound(reached, tokens * k),
        "experts_reached": reached, "sync_free": True,
        "max_abs_err": err, "out_scale": scale, "cosine": cos,
        "transient_gb": transient / 1e9,
        "chunk_transients_gb": routed / 1e9,
        "x_copy_gb_avoided": x_copy / 1e9,
        "trace": {
            "device_ms_per_call": trace["device_ms_per_step"],
            "device_busy_share": trace["device_busy_share"],
            "kernels_per_call": trace["kernels_per_step"],
            "top_device_ops": trace["top_device_ops"][:6],
        },
    }


def phase_moe(kind, smi, device="cuda"):
    """qwen3-30b-a3b: its full widths at 2 layers as a Qwen3-MoE
    checkpoint through ``--model-dir``; then bf16 at full width and depth
    through the server (phase d's requests, flash logits against the
    plain attention, exact launches, a 20-step profile while 8 chats
    decode); then one MoE layer timed at the 2048 bucket and at 8
    decoding slots. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )

    phase_checkpoint(kind, smi, preset=H_PRESET, device=device, int8=True)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(H_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tree_gb = sum(
        t.numel() * t.element_size() for t in (
            [engine.runner.params[k] for k in ("embed", "final_norm",
                                               "lm_head")]
            + list(engine.runner.params["layers"].values())
        )
    ) / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _logit_check, int8=False,
                                     profile="moe")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = report.pop("profile")
    emit("moe_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, tree_gb=tree_gb, init_peak_gb=init_peak_gb,
         launches=windows, **report, peak_mem_gb=peak_gb)
    emit("moe_profile", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         **profile)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(engine.runner.params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="routed (each token through its own k experts), bf16 "
         "experts through the grouped kernel",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    del engine
    return {f"moe_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# i: the DeepSeek family
# ---------------------------------------------------------------------------

def _tree_gb(params):
    """The tree's device bytes, in GB (an int8 leaf's values and scales)."""
    return sum(
        t.numel() * t.element_size() for w in _leaves(params).values()
        for t in ((w.q, w.s) if hasattr(w, "q") else (w,))
    ) / 1e9


def _held_gb(phase):
    """The previous phase's tree must be gone before this one's is drawn."""
    held_gb = torch.cuda.memory_allocated() / 1e9
    if held_gb > 4:
        raise AssertionError(f"{held_gb} GB still allocated before {phase}")
    return held_gb


I_PRESET = "deepseek-v2-lite"
I_ARGV = ["--preset", I_PRESET] + MAIN_ARGV[2:]


def phase_deepseek(kind, smi, device="cuda"):
    """deepseek-v2-lite (MLA served decompressed at d 192, one dense layer
    then 26 DeepSeek-MoE layers, YaRN): its full widths at 2 layers as a
    DeepSeek-V2 checkpoint through ``--model-dir``; then bf16 at full
    width and depth through the server (phase d's requests, flash logits
    against the plain attention with the kernel run's expert picks
    replayed, exact launches, embeddings at the 2048 bucket, a 20-step
    profile while 8 chats decode); then one of its MoE layers (64
    experts, top-6, two shared experts) at the 2048 bucket and at 8
    decoding slots. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.transformer import attn_scale

    held_gb = _held_gb("phase i")           # phase h's 61 GB are gone
    phase_checkpoint(kind, smi, preset=I_PRESET, device=device)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(I_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.runner.params
    tree_gb = _tree_gb(params)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _logit_check, int8=False,
                                     profile="deepseek", embed=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = report.pop("profile")
    emit("deepseek_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, tree_gb=tree_gb, init_peak_gb=init_peak_gb,
         held_before_gb=held_gb, softmax_scale=attn_scale(engine.cfg),
         launches=windows, **report, peak_mem_gb=peak_gb)
    emit("deepseek_profile", model=engine.cfg.name, device=kind,
         nvidia_smi=smi, **profile)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="routed (each token through its own k experts), shared "
         "experts on every token",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    bf16 = {**{k: report[k] for k in (
        "ttft_ms_2048_bucket", "decode_tokens_per_s_8_slots",
        "prefill_ms_2048_bucket",
    )}, "peak_mem_gb": peak_gb, "tree_gb": tree_gb}
    del engine, params
    _free()
    # the same model as int8: MLA's projections, the shared experts and
    # the dense layer through the 2-D kernel, the experts grouped
    engine, int8_windows = _int8_path(kind, smi, I_ARGV, "deepseek_int8",
                                      bf16)
    del engine
    return {
        **{f"deepseek_{w}": c for w, c in windows.items()},
        **{f"deepseek_int8_{w}": c for w, c in int8_windows.items()},
    }


def _int8_path(kind, smi, argv, label, bf16=None):
    """``argv`` with ``--quantization int8``, the tree drawn on the card:
    every leaf ``quantize_params`` quantizes is int8 and no other; phase
    d's requests through the server with exact launches, its kernel
    logits against the W8A16 plain versions (expert picks replayed).
    Emits ``<label>_path`` (beside ``bf16``'s numbers from this run where
    given); returns (engine, {window: launch counts})."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.quant import QuantW, quantizable

    held_gb = _held_gb(label)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(
        build_parser().parse_args(argv + ["--quantization", "int8"])
    )
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    leaves = _leaves(engine.runner.params)
    wrong = [
        key for key, w in leaves.items()
        if isinstance(w, QuantW) != quantizable(key.split("/")[-1],
                                                engine.cfg)
    ]
    if wrong:
        raise AssertionError(f"{label}: not int8 as quantize_params makes "
                             f"it: {wrong}")
    tree_gb = _tree_gb(engine.runner.params)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _int8_logit_check, int8=True)
    emit(f"{label}_path", model=engine.cfg.name, device=kind,
         nvidia_smi=smi, setup_s=setup_s, int8_tree_gb=tree_gb,
         int8_leaves=sum(isinstance(w, QuantW) for w in leaves.values()),
         init_peak_gb=init_peak_gb, held_before_gb=held_gb,
         launches=windows, **report,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         **({"bf16_same_run": bf16} if bf16 else {}))
    return engine, windows


# ---------------------------------------------------------------------------
# j: the GPT-OSS family
# ---------------------------------------------------------------------------

J_PRESET = "gpt-oss-20b"
J_ARGV = ["--preset", J_PRESET] + MAIN_ARGV[2:]


def phase_gptoss(kind, smi, device="cuda"):
    """gpt-oss-20b (sinks, sliding layers of 128 on the even layers, q/k/v/o
    biases, YaRN; 32 experts, top-4, the affine router and clamped GLU):
    its full widths at 2 layers as a GPT-OSS checkpoint with MXFP4 expert
    blocks through ``--model-dir``; then bf16 at full width and depth
    through the server (phase d's requests, the served logits against the
    fp32 plain forward with the served run's expert picks replayed, exact
    launches: the flash kernel never, as in JAX; embeddings at the 2048
    bucket, a 20-step profile while 8 chats decode, a 2048-bucket prefill
    split into its attention and MoE time); then one MoE layer at the
    2048 bucket and at 8 decoding slots. Returns {window: launch
    counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )

    held_gb = _held_gb("phase j")
    phase_checkpoint(kind, smi, preset=J_PRESET, device=device, mxfp4=True)
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(J_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = engine.runner.params
    tree_gb = _tree_gb(params)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, windows = _serve_counted(engine, _logit_check, int8=False,
                                     profile="gptoss", embed=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = report.pop("profile")
    emit("gptoss_path", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, tree_gb=tree_gb, init_peak_gb=init_peak_gb,
         held_before_gb=held_gb, launches=windows, **report,
         prefill_split=_prefill_split(engine), peak_mem_gb=peak_gb)
    emit("gptoss_profile", model=engine.cfg.name, device=kind,
         nvidia_smi=smi, **profile)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="routed (each token through its own k experts), expert "
         "biases and the clamped GLU",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    del engine, params
    return {f"gptoss_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# k: the Gemma family
# ---------------------------------------------------------------------------

K_PRESET = "gemma2-9b"
K_ARGV = ["--preset", K_PRESET] + MAIN_ARGV[2:]


def phase_gemma(kind, smi, device="cuda"):
    """gemma2-9b (delta-gain sandwich norms, the scaled and tied
    embedding, tanh GELU, ``query_pre_attn_scalar``, attention and final
    softcaps, a window of 4096 on the even layers): its full widths at 2
    layers as a tied Gemma2 checkpoint through ``--model-dir``; then bf16
    at full width and depth through the server (phase d's requests, the
    served logits against the fp32 plain forward, exact launches: the
    flash kernel never, as in JAX; embeddings at the 2048 bucket); then
    ``--quantization int8`` (the seven layer weights through the W8A16
    kernel at head_dim 256, d 3584, F 14336; the tied embedding bf16, so
    no W8A16 lm_head) with phase d's requests, its kernel logits against
    the W8A16 plain version; each path's 2048-bucket prefill split into
    its attention time. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.quant import QuantW

    held_gb = _held_gb("phase k")
    phase_checkpoint(kind, smi, preset=K_PRESET, device=device)
    _free()
    paths, bf16 = {}, {}
    for label, argv, int8 in (
        ("gemma", K_ARGV, False),
        ("gemma_int8", K_ARGV + ["--quantization", "int8"], True),
    ):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = build_engine_from_args(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        params = engine.runner.params
        layer_weights = [params["layers"][k] for k in (
            "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"
        )]
        if int8 != all(isinstance(w, QuantW) for w in layer_weights) or (
            isinstance(params["embed"], QuantW) or "lm_head" in params
        ):
            raise AssertionError(f"{label}: the tree's weights are not as "
                                 "this path serves them")
        tree_gb = sum(
            t.numel() * t.element_size()
            for w in [params["embed"], params["final_norm"],
                      *params["layers"].values()]
            for t in ((w.q, w.s) if isinstance(w, QuantW) else (w,))
        ) / 1e9
        report, windows = _serve_counted(
            engine, _int8_logit_check if int8 else _logit_check, int8=int8,
            embed=not int8,
        )
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        report["prefill_split"] = _prefill_split(engine)
        if not int8:
            bf16 = report
        keys = ("ttft_ms_2048_bucket", "decode_tokens_per_s_8_slots",
                "prefill_ms_2048_bucket", "peak_mem_gb")
        emit(f"{label}_path", model=engine.cfg.name, device=kind,
             nvidia_smi=smi, setup_s=setup_s, tree_gb=tree_gb,
             held_before_gb=held_gb, launches=windows, **report,
             **({"bf16_same_run": {k: bf16[k] for k in keys}}
                if int8 else {}))
        paths.update({f"{label}_{w}": c for w, c in windows.items()})
        del engine, params, layer_weights
        _free()
    return paths


# ---------------------------------------------------------------------------
# l: int8 MoE at full width and depth
# ---------------------------------------------------------------------------

L_PRESET = "mixtral-8x7b"
L_ARGV = ["--preset", L_PRESET] + MAIN_ARGV[2:]


def phase_mixtral_int8(kind, smi, device="cuda"):
    """mixtral-8x7b (32 layers, d 4096, 32 q heads on 8 kv heads, 8
    experts, top-2, width 14336, vocab 32000) with ``--quantization
    int8``: ~46.7 GB of int8 drawn on the card (93 GB in bf16: no bf16
    tree fits). Phase d's requests through the server, exact launches
    (per 2048-bucket forward 129 2-D W8A16 products and 96 grouped expert
    products), its kernel logits against the plain versions with the
    kernel run's expert picks replayed; then one MoE layer at the 2048
    bucket and at 8 decoding slots against the fp32 routed reference,
    beside its dense-dispatch bound. Returns {window: launch counts}."""
    engine, windows = _int8_path(kind, smi, L_ARGV, "mixtral_int8")
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        layers = [
            _moe_layer_case(engine.runner.params, engine.cfg, t, gen)
            for t in (2048, engine.max_slots)
        ]
    emit("moe", model=engine.cfg.name, device=kind, nvidia_smi=smi,
         dispatch="routed (each token through its own k experts), int8 "
         "experts through the grouped W8A16 kernel",
         tolerance={"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
         layers=layers)
    del engine
    return {f"mixtral_int8_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# m: Gemma 1 at head_dim 256
# ---------------------------------------------------------------------------

# gemma-7b's published config.json (google/gemma-7b), tied embeddings
# written out (GemmaConfig's default); phase m cuts it to 2 layers
GEMMA_7B_HF = {
    "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
    "hidden_size": 3072, "intermediate_size": 24576,
    "num_hidden_layers": 28, "num_attention_heads": 16,
    "num_key_value_heads": 16, "head_dim": 256, "vocab_size": 256000,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 8192, "hidden_act": "gelu",
    "hidden_activation": "gelu_pytorch_tanh", "tie_word_embeddings": True,
}


def phase_gemma1(kind, smi, device="cuda"):
    """gemma-7b (d 3072, 16 heads of 256 on 16 kv heads, MLP 24576,
    vocab 256000, tanh GELU, ``(1 + w)`` norms, the scaled and tied
    embedding; no window, softcap or sinks, so every prefill takes the
    flash kernel at d 256) at its full width and 2 of its 28 layers,
    written as a Gemma safetensors checkpoint and served bf16 through
    ``--model-dir``: the loaded tree and logits identical to the in-memory
    tree's, then phase d's requests with exact flash launches, the served
    logits against the plain attention and ``/v1/embeddings`` at the 2048
    bucket. Returns {window: launch counts}."""
    from gpustack_tpu_torch.models.config import config_from_hf

    def serve(engine):
        return _serve_counted(engine, _logit_check, int8=False, embed=True)

    torch.cuda.reset_peak_memory_stats()
    report, windows = phase_checkpoint(
        kind, smi, device=device, serve=serve,
        cfg=config_from_hf(GEMMA_7B_HF, name="gemma-7b"),
    )
    emit("gemma1_path", model="gemma-7b (2 of 28 layers)", device=kind,
         nvidia_smi=smi, launches=windows, **report,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return {f"gemma1_{w}": c for w, c in windows.items()}


# ---------------------------------------------------------------------------
# n: disaggregated prefill/decode
# ---------------------------------------------------------------------------

N_ARGV = MAIN_ARGV + ["--host-kv-cache-mb", "4096"]
# the handed-off prompt fills the 2048 bucket: 7 blocks of 256 travel and
# the decode replica prefills the last 108 tokens at q_offset 1792
N_PROMPT = "".join(chr(ord("a") + (i * 5) % 26) for i in range(1900))
N_COLD_PROMPT = "".join(chr(ord("a") + (i * 3) % 26) for i in range(1900))
N_MAX_TOKENS = 16
N_SCHEMA = {
    "type": "object",
    "properties": {"answer": {"type": "string"}},
    "required": ["answer"],
}


def _stream_completion(port, prompt, max_tokens, headers=None,
                       reply_headers=None):
    """A streaming greedy completion biased to lowercase letters (text
    that tokenizes back to the ids generated); returns (text, TTFT s on
    the client's clock). ``reply_headers``, a dict, receives the
    response's headers."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({
            "prompt": prompt, "max_tokens": max_tokens, "temperature": 0,
            "stream": True, "logit_bias": LETTERS,
        }).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    t0 = time.perf_counter()
    ttft, text = None, []
    with urllib.request.urlopen(req, timeout=600) as resp:
        if reply_headers is not None:
            reply_headers.update(resp.headers.items())
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            piece = json.loads(line[6:])["choices"][0].get("text")
            if piece:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                text.append(piece)
    return "".join(text), ttft


def _schema_requests(port):
    """One ``json_schema`` request with a schema (validated, one guided
    retry) and one streamed (skipped), through the decode replica."""
    body = {
        "messages": [{"role": "user", "content": "Answer in JSON."}],
        "max_tokens": 24, "temperature": 0,
        "response_format": {"type": "json_schema", "json_schema": {
            "name": "answer", "schema": N_SCHEMA,
        }},
    }
    _, raw = _post(port, "/v1/chat/completions", body)
    choice = json.loads(raw)["choices"][0]
    verdict = choice.get("x_schema_validation", "")
    if not (verdict == "passed" or verdict.startswith("failed: ")):
        raise AssertionError(f"json_schema verdict {verdict!r}")
    _, raw = _post(port, "/v1/chat/completions", {**body, "stream": True})
    events = [json.loads(line[6:]) for line in raw.split("\n")
              if line.startswith("data: ") and line != "data: [DONE]"]
    streamed = events[-1]["choices"][0].get("x_schema_validation")
    if streamed != "skipped (stream)":
        raise AssertionError(f"streamed json_schema verdict {streamed!r}")
    return {"verdict": verdict, "stream_verdict": streamed,
            "content": choice["message"]["content"]}


def phase_disaggregation(kind, smi):
    """llama3-8b bf16 at full width and depth as two engines on the card,
    ``--kv-role prefill`` and ``--kv-role decode``, each with a 4 GiB host
    KV tier, behind two servers. A 1900-token prompt goes to the decode
    server naming the prefill server in ``X-GPUStack-KV-Source``: the
    prefill replica prefills it for export (flash, offset 0), its 7 blocks
    travel over ``/kv/export``, and the decode replica imports them and
    prefills the 108-token tail (flash at ``q_offset`` 1792). Launches are
    counted over both runners; the decode replica's greedy ids are held to
    a cold single-engine run of the prompt (the prefill engine with its
    host tier detached) by phase g's rule; its TTFT is reported beside its
    own cold TTFT for a prompt of the same length. Then one
    ``json_schema`` request with a schema, and one streamed. Returns
    {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.engine.engine import GenRequest

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engines = [
        build_engine_from_args(build_parser().parse_args(
            N_ARGV + ["--kv-role", role]
        ))
        for role in ("prefill", "decode")
    ]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pre, dec = engines
    calls = [RunnerCalls(e.runner, False) for e in engines]
    servers = []
    try:
        ports = []
        for e in engines:
            e.start()
            servers.append(OpenAIServer(e))
            ports.append(servers[-1].start("127.0.0.1", 0))
        tok = dec.tokenizer
        ids = tok.encode(N_PROMPT)
        for port in ports:                 # first calls: warm-up
            _stream_completion(port, "warm up", 2)
        # the reference: a cold run of the prompt on one engine (the
        # prefill engine with its host tier detached, so it neither
        # matches nor stores), each position's top-2 logprobs kept
        cache, pre.host_kv_cache = pre.host_kv_cache, None
        try:
            ref = pre.generate(GenRequest(
                prompt_ids=ids, max_tokens=N_MAX_TOKENS, temperature=0.0,
                logit_bias={int(k): v for k, v in LETTERS.items()},
                logprobs=True, top_logprobs=2,
            ), timeout=600)
        finally:
            pre.host_kv_cache = cache
        gaps = [t[0][1] - t[1][1] for t in ref.output_top_logprobs]
        _, ttft_cold = _stream_completion(ports[1], N_COLD_PROMPT,
                                          N_MAX_TOKENS)
        # the handoff, every launch counted over both runners
        reset_launch_counts()
        for c in calls:
            c.reset()
        h0 = dec.health()
        sent0 = pre.kv_handoff.snapshot()
        got0 = dec.kv_handoff.snapshot()
        secs0 = dec.kv_handoff.seconds.snapshot()[1]
        source = f"http://127.0.0.1:{ports[0]}/kv/export"
        trace_id, parent, headers = _caller_trace()
        got_headers = {}
        text, ttft_warm = _stream_completion(
            ports[1], N_PROMPT, N_MAX_TOKENS,
            headers={"X-GPUStack-KV-Source": source, **headers},
            reply_headers=got_headers,
        )
        hop = _check_hop(got_headers, trace_id, parent,
                         phases=("kv_handoff",), events=("kv_handoff",))
        counts = launch_counts()
        check_launches("disaggregation", counts, expected_launches(calls))
        h1 = dec.health()
        sent = {k: v - sent0[k] for k, v in pre.kv_handoff.snapshot().items()}
        got = {k: v - got0[k] for k, v in dec.kv_handoff.snapshot().items()}
        reused = (h1["kv_cache_prefix_tokens_reused"]
                  - h0["kv_cache_prefix_tokens_reused"])
        forwards = [c.counts() for c in calls]
        blocks = (len(ids) - 1) // BLOCK
        if (
            forwards[0]["prefill"] != 1 or forwards[0]["prefill_with_prefix"]
            or forwards[1]["prefill"] or forwards[1]["prefill_with_prefix"] != 1
        ):
            raise AssertionError(f"runner calls {forwards}: want one full "
                                 "prefill there and one tail prefill here")
        if (
            got["pulls"] != 1 or got["failures"] or got["blocks_in"] != blocks
            or sent["blocks_out"] != blocks or reused != blocks * BLOCK
        ):
            raise AssertionError(
                f"handoff sent {sent}, received {got}, reused {reused} "
                f"tokens: want {blocks} blocks ({blocks * BLOCK} tokens)"
            )
        handoff_event = next(e for e in hop["events"]
                             if e["event"] == "kv_handoff")
        attrs = handoff_event["attrs"]
        if (attrs["source"] != source or attrs["blocks"] != blocks
                or not attrs["bytes"] > 0 or "failed" in attrs):
            raise AssertionError(f"traced handoff {handoff_event}")
        rule = _ids_rule([(ref.output_ids, gaps)], [(tok.encode(text), None)],
                         IDS_GAP_REL)
        schema = _schema_requests(ports[1])
        emit("disaggregation", model=dec.cfg.name, device=kind,
             nvidia_smi=smi, setup_s=setup_s, prompt_tokens=len(ids),
             handoff={
                 "seconds": dec.kv_handoff.seconds.snapshot()[1] - secs0,
                 "bytes": got["bytes_in"], "blocks": got["blocks_in"],
                 "block_tokens": BLOCK, "tail_tokens": len(ids) - reused,
                 "q_offset": reused,
             },
             sent=sent, received=got,
             ttft_ms_decode_replica_handoff=ttft_warm * 1e3,
             decode_replica_trace=hop,
             ttft_ms_decode_replica_cold=ttft_cold * 1e3,
             runner_calls={"prefill": forwards[0], "decode": forwards[1]},
             launches=counts, greedy_ids_vs_single_engine=rule,
             json_schema=schema,
             roles=[e.health()["kv_role"] for e in engines],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return {"disaggregation": counts}
    finally:
        for server in servers:
            server.shutdown()
        for e in engines:
            e.stop()


# ---------------------------------------------------------------------------
# o: image chat (the VLM path)
# ---------------------------------------------------------------------------

VISION_MIN_COSINE = 0.999
O_MAX_TOKENS = 16
O_TTFT_REPS = 3
O_TEXT = "Describe this image: "


def _seeded_image(seed, w, h):
    """A colour gradient with seeded noise, uint8 ``[h, w, 3]``."""
    gen = torch.Generator().manual_seed(seed)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    base = torch.stack([
        xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
        (xx + yy) * 127 // max(w + h - 2, 1),
    ], -1)
    noise = torch.randint(-40, 41, (h, w, 3), generator=gen)
    return (base + noise).clamp(0, 255).to(torch.uint8).numpy()


def _image_msgs(data, mime="image/png"):
    url = f"data:{mime};base64," + base64.b64encode(data).decode()
    return [{"role": "user", "content": [
        {"type": "text", "text": O_TEXT},
        {"type": "image_url", "image_url": {"url": url}},
    ]}]


def _post_status(port, path, body):
    """(status, body) of a request whose answer may be an error."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _tree_map(fn, tree):
    """``fn`` over every leaf of a param tree (dicts, lists, ``None``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _widen(tree):
    """A copy of a param tree with every leaf in fp32 (the plain
    references of the small towers, the audio and the diffusion models)."""
    return _tree_map(lambda t: t.float(), tree)


def _mm_prompt(engine, msgs):
    """A VLM prompt built as the server builds it, bucket-padded:
    (ids, padded ids, embeds, mask)."""
    import numpy as np

    from gpustack_tpu_torch.models.vlm import build_mm_prompt

    ids, embeds, mask = build_mm_prompt(engine.tokenizer, msgs, engine.vision)
    pad = engine.runner.bucket_for(len(ids)) - len(ids)
    return (ids, ids + [0] * pad, np.pad(embeds, ((0, pad), (0, 0))),
            np.pad(mask, (0, pad)))


def _image_logit_check(engine, msgs):
    """An image prompt's prefill through ``prefill_with_embeds`` (the
    flash kernel) against the same spliced embeddings through the plain
    attention: last-position logits within the served-logit tolerance."""
    from gpustack_tpu_torch.models import transformer as tf

    runner = engine.runner
    ids, padded, embeds, mask = _mm_prompt(engine, msgs)
    with torch.no_grad():
        served, _, _ = runner.prefill_with_embeds(
            padded, len(ids), embeds, mask
        )
        bucket = len(padded)
        hidden, _ = tf.forward(
            runner.params, runner.cfg,
            torch.tensor([padded], device=runner.device),
            torch.arange(bucket, device=runner.device)[None, :],
            tf.KVCache.create(runner.cfg, 1, bucket, runner.device),
            return_hidden=True, attn_impl="plain",
            embeds_override=(torch.from_numpy(embeds).to(runner.device)[None],
                             torch.from_numpy(mask).to(runner.device)[None]),
        )
        plain = tf.lm_head(runner.params, runner.cfg, hidden[0, len(ids) - 1])
    gate = _compare_logits(served, plain)
    if not torch.isfinite(served).all() or (
        gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"]
        or gate["cosine"] < LOGIT_MIN_COSINE
    ):
        raise AssertionError(f"image prefill logits differ: {gate}")
    return {"prompt_tokens": len(ids), "bucket": len(padded),
            "image_tokens": int(mask.sum()), **gate}


def _image_greedy(runner, state, slot, prompt, n):
    """Greedy ids of an image prompt (``_mm_prompt``'s tuple) from the
    runner called directly, under the letters' logit bias the served
    chats carry: ``prefill_with_embeds`` for ``slot``, ``sample_first``,
    ``insert`` into ``state``, ``n - 1`` decode steps; the slot is
    deactivated at the end."""
    ids, padded, embeds, mask = prompt
    bias = {int(k): v for k, v in LETTERS.items()}
    with torch.no_grad():
        last, k, v = runner.prefill_with_embeds(padded, len(ids), embeds,
                                                mask, slot=slot)
        toks = runner.sample_first(last, 0.0, 0, 1.0, 0, False,
                                   len(ids) - 1, 0, logit_bias=bias)[0]
        runner.insert(state, k, v, slot, len(ids), toks[0], 0.0, 0, 1.0,
                      logit_bias=bias)
        del k, v
        out = [int(toks[0])]
        for step in range(n - 1):
            state, sampled = runner.decode_step(state, step + 1)
            out.append(int(sampled[0][slot]))
        runner.deactivate(state, slot)
    return out


O_ARGV = MAIN_ARGV


def phase_vlm(kind, smi, device="cuda"):
    """Image chat at full width: the repo's vision tower (64 x 64 images,
    8 x 8 patches, dim 64, 2 layers) projected into llama3-8b (bf16, full
    width and depth, random weights from a seed) as ``llama3-8b-vision``,
    attached to the engine as the JAX server attaches one. Through the
    server: a chat with a 64 x 64 PNG, one with a 97 x 53 PNG (resized),
    a streamed one, a remote URL and a JPEG (each a 400), then image and
    text chats of one token count for TTFT. Gates: one flash launch a
    layer for every prefill (``prefill_with_embeds`` for the image ones),
    the image prefill's logits against the plain attention, the tower in
    bf16 against its fp32 plain version, the served greedy ids against the
    runner called directly. Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.models.png import encode_png
    from gpustack_tpu_torch.models.vlm import (
        VisionBundle,
        VisionConfig,
        VLMConfig,
        encode_image,
        init_vision_params,
    )

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(O_ARGV))
    vcfg = VLMConfig(name=f"{engine.cfg.name}-vision",
                     language=get_config(engine.cfg.name),
                     vision=VisionConfig())
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tower = init_vision_params(vcfg, gen)
    engine.vision = VisionBundle(vcfg, tower, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tok = engine.tokenizer
    png64 = encode_png(_seeded_image(64, 64, 64))
    png97 = encode_png(_seeded_image(97, 97, 53))
    host_ms = {}
    for name, data in (("64x64", png64), ("97x53_resized", png97)):
        t = time.perf_counter()
        for _ in range(5):
            pre = engine.vision.preprocess(data)
        host_ms[name] = (time.perf_counter() - t) / 5 * 1e3
    x = torch.from_numpy(pre).to(device)
    with torch.no_grad():
        got = encode_image(tower, vcfg, x).float()
        want = encode_image(_widen(tower), vcfg, x)
        encode_ms = cuda_time_ms(lambda: encode_image(tower, vcfg, x))
    tower_gate = {
        **_compare_logits(got.flatten(), want.flatten()),
        "shape": list(got.shape), "tolerance": {"min_cosine":
                                                VISION_MIN_COSINE},
    }
    if tower_gate["cosine"] < VISION_MIN_COSINE:
        raise AssertionError(f"vision tower bf16 vs fp32: {tower_gate}")
    msgs64, msgs97 = _image_msgs(png64), _image_msgs(png97)
    text_msgs = [{"role": "user",
                  "content": O_TEXT + "x" * engine.vision.n_image_tokens}]
    calls = RunnerCalls(engine.runner, False)
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        logit_gate = _image_logit_check(engine, msgs64)
        if len(tok.apply_chat_template(text_msgs)) != (
            logit_gate["prompt_tokens"]
        ):
            raise AssertionError("the text chat's token count differs")
        reset_launch_counts()
        calls.reset()
        served = {}
        for name, msgs in (("64x64", msgs64), ("97x53", msgs97)):
            _, raw = _post(port, "/v1/chat/completions", {
                "messages": msgs, "max_tokens": O_MAX_TOKENS,
                "temperature": 0, "logit_bias": LETTERS,
            })
            data = json.loads(raw)
            _check_usage(data, logit_gate["prompt_tokens"])
            served[name] = data["choices"][0]["message"]["content"]
        streamed, _ = _stream_chat(port, msgs64, O_MAX_TOKENS)
        if streamed != served["64x64"]:
            raise AssertionError(f"stream {streamed!r} != {served['64x64']!r}")
        refusals = {}
        for name, msgs in (
            ("remote_url", [{"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": "https://example.com/a.png"}}]}]),
            ("jpeg", _image_msgs(b"\xff\xd8\xff\xe0" + bytes(64),
                                 "image/jpeg")),
        ):
            status, raw = _post_status(port, "/v1/chat/completions", {
                "messages": msgs, "max_tokens": 2})
            if status != 400:
                raise AssertionError(f"{name}: HTTP {status} {raw[:200]}")
            refusals[name] = json.loads(raw)["error"]["message"]
        ttft = {"image": [], "text": []}
        for _ in range(O_TTFT_REPS):
            for name, msgs in (("image", msgs64), ("text", text_msgs)):
                ttft[name].append(_stream_chat(port, msgs, 4)[1] * 1e3)
        counts = launch_counts()
        window = calls.counts()
        images = 3 + O_TTFT_REPS
        if window["prefill_with_embeds"] != images or window[
            "prefill"
        ] != O_TTFT_REPS or window["prefill_with_prefix"]:
            raise AssertionError(f"runner calls {window}: want {images} "
                                 f"image prefills, {O_TTFT_REPS} text ones")
        check_launches("vlm path", counts, expected_launches([calls]))
        direct = {
            name: _image_greedy(engine.runner, engine.runner.new_state(), 0,
                                _mm_prompt(engine, msgs), O_MAX_TOKENS)
            for name, msgs in (("64x64", msgs64), ("97x53", msgs97))
        }
        for name, ids in direct.items():
            if tok.encode(served[name]) != ids:
                raise AssertionError(
                    f"{name}: served {served[name]!r}, direct {ids}")
        emit("vlm_path", model=vcfg.name, device=kind, nvidia_smi=smi,
             setup_s=setup_s, vision=dataclasses.asdict(vcfg.vision),
             runner_calls=window, launches=counts,
             flash_per_image_prefill=engine.runner.cfg.num_layers,
             logit_check={**logit_gate, "served": "flash kernel",
                          "reference": "plain attention, bf16",
                          "tolerance": {"rel": LOGIT_REL_TOL,
                                        "min_cosine": LOGIT_MIN_COSINE}},
             tower_vs_fp32=tower_gate, vision_encode_ms=encode_ms,
             png_decode_resize_host_ms=host_ms,
             greedy_ids_vs_runner={k: "identical" for k in direct},
             refusals=refusals,
             ttft_ms_image=statistics.median(ttft["image"]),
             ttft_ms_text_same_tokens=statistics.median(ttft["text"]),
             ttft_ms_runs=ttft,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        return {"vlm": counts}
    finally:
        server.shutdown()
        engine.stop()


# ---------------------------------------------------------------------------
# p + q: the audio server (speech to text, text to speech)
# ---------------------------------------------------------------------------

P_ARGV = ["--preset", "whisper-large-v3", "--port", "0"]
P_WAV_SECONDS = 10
P_FORCED_STEPS = 24
Q_ARGV = ["--preset", "tts-base", "--port", "0"]
Q_TEXT = "The port reads this sentence aloud on the card."


def _seeded_wav(seconds, seed):
    """16 kHz 16-bit mono WAV bytes: two gliding tones and seeded noise."""
    import io
    import wave

    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(seconds * 16000, dtype=torch.float64) / 16000
    x = (0.3 * torch.sin(2 * math.pi * 220 * t)
         * torch.sin(2 * math.pi * 3 * t)
         + 0.2 * torch.sin(2 * math.pi * (440 + 100 * torch.sin(t)) * t)
         + 0.05 * torch.randn(len(t), generator=gen, dtype=torch.float64))
    pcm = (x.clamp(-1, 1) * 32767).to(torch.int16).numpy()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


def _post_multipart(port, path, fields):
    """POST ``{name: (bytes, filename or None)}`` as multipart/form-data;
    returns (status, content type, body bytes)."""
    boundary = "chip-smoke-boundary"
    body = bytearray()
    for name, (value, filename) in fields.items():
        disp = f'form-data; name="{name}"' + (
            f'; filename="{filename}"' if filename else "")
        body += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n\r\n"
                 .encode() + value + b"\r\n")
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=bytes(body),
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


def _audio_health(port, modality, requests):
    health = json.loads(_get(port, "/healthz"))
    if health["status"] != "ok" or health["modality"] != f"audio/{modality}" \
            or health["requests"] != requests:
        raise AssertionError(f"healthz {health}")
    metrics = _get(port, "/metrics")
    if f"gpustack_tpu_audio_requests_total {requests}\n" not in metrics or (
        "gpustack_tpu_audio_seconds_total " not in metrics
    ):
        raise AssertionError(f"metrics {metrics!r}")
    return health, metrics.strip().splitlines()


def _count_calls(module, name, counter):
    """Wrap ``module.name`` so each call appends to ``counter``; returns
    the original (restore it after)."""
    fn = getattr(module, name)

    def counted(*args, **kw):
        counter.append(1)
        return fn(*args, **kw)

    setattr(module, name, counted)
    return fn


def _hf_whisper(tree, cfg):
    """A ``models/whisper.py`` tree under HF Whisper names (torch
    layouts: linear weights ``[out, in]``, conv weights as they are)."""
    out = {
        "model.encoder.conv1.weight": tree["conv1"],
        "model.encoder.conv1.bias": tree["conv1_b"],
        "model.encoder.conv2.weight": tree["conv2"],
        "model.encoder.conv2.bias": tree["conv2_b"],
        "model.encoder.layer_norm.weight": tree["enc_ln"],
        "model.encoder.layer_norm.bias": tree["enc_ln_b"],
        "model.decoder.embed_tokens.weight": tree["tok_embed"],
        "model.decoder.embed_positions.weight": tree["pos_embed"],
        "model.decoder.layer_norm.weight": tree["dec_ln"],
        "model.decoder.layer_norm.bias": tree["dec_ln_b"],
    }
    names = {
        "ln1": "self_attn_layer_norm.weight",
        "ln1_b": "self_attn_layer_norm.bias",
        "ln2": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
        "w_up": "fc1.weight", "b_up": "fc1.bias",
        "w_down": "fc2.weight", "b_down": "fc2.bias",
        "lnx": "encoder_attn_layer_norm.weight",
        "lnx_b": "encoder_attn_layer_norm.bias",
    }
    for tag, attn in (("", "self_attn"), ("x", "encoder_attn")):
        for leaf, proj in (("wq", "q_proj.weight"), ("bq", "q_proj.bias"),
                           ("wk", "k_proj.weight"), ("wv", "v_proj.weight"),
                           ("bv", "v_proj.bias"), ("wo", "out_proj.weight"),
                           ("bo", "out_proj.bias")):
            names[tag + leaf] = f"{attn}.{proj}"
    for side, key in (("encoder", "enc_layers"), ("decoder", "dec_layers")):
        for leaf, stacked in tree[key].items():
            for i, t in enumerate(stacked):
                out[f"model.{side}.layers.{i}.{names[leaf]}"] = (
                    t.T.contiguous() if t.dim() == 2 else t
                )
    return out


def _whisper_checkpoint(cfg, mel_np, device):
    """The preset's widths at 2 + 2 layers, biases drawn at random (the
    init's are zeros), written as an HF Whisper safetensors checkpoint and
    loaded through the audio server's ``--model-dir``: the loaded tree and
    its greedy ids identical to the in-memory tree's."""
    from gpustack_tpu_torch.engine.audio_server import (
        build_audio_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models import whisper as wh

    cfg2 = dataclasses.replace(cfg, encoder_layers=2, decoder_layers=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    tree = wh.init_whisper_params(cfg2, gen)
    for path, t in _leaves(tree).items():
        if path.split("/")[-1].startswith(("b", "xb")) or path.endswith("_b"):
            t.normal_(generator=gen).mul_(0.1)
    with tempfile.TemporaryDirectory(prefix="whisper-ckpt-") as d:
        t0 = time.perf_counter()
        nbytes = write_safetensors(os.path.join(d, "model.safetensors"),
                                   _hf_whisper(tree, cfg2))
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({
                "model_type": "whisper", "_name_or_path": "whisper-2-layer",
                "vocab_size": cfg.vocab_size,
                "num_mel_bins": cfg.num_mel_bins, "d_model": cfg.d_model,
                "encoder_layers": 2, "decoder_layers": 2,
                "encoder_attention_heads": cfg.num_heads,
                "max_source_positions": cfg.max_source_positions,
                "max_target_positions": cfg.max_target_positions,
                "eos_token_id": cfg.eos_token_id,
                "decoder_start_token_id": cfg.decoder_start_token_id,
            }, f)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = build_audio_engine_from_args(build_parser().parse_args(
            ["--model-dir", d, "--port", "0", "--device", str(device)]))
        load_s = time.perf_counter() - t0
    want, got = _leaves(tree), _leaves(loaded.params)
    bad = sorted(k for k in want if k not in got or not torch.equal(
        got[k], want[k]))
    if bad or set(got) != set(want):
        raise AssertionError(f"loaded whisper tree differs at {bad[:5]}")
    ids = wh.greedy_transcribe(loaded.params, loaded.cfg, mel_np,
                               max_tokens=8)
    if ids != wh.greedy_transcribe(tree, cfg2, mel_np, max_tokens=8):
        raise AssertionError("checkpoint greedy ids differ")
    return {"layers": "2 + 2", "bytes": nbytes, "write_s": write_s,
            "load_s": load_s, "tree": "identical", "greedy_ids": "identical"}


def phase_whisper(kind, smi):
    """whisper-large-v3 (32 + 32 layers, d 1280, 20 heads of 64, 128 mels,
    vocab 51866) at full width and depth in bf16, random weights from seed
    0, behind the port's audio server: a 10 s WAV from the seed to
    ``/v1/audio/transcriptions`` and ``/translations``; the encoder output
    against an fp32 plain forward over the same weights, the decoder's
    logits against it at every forced step, ``/healthz`` and ``/metrics``;
    then a 2 + 2-layer checkpoint at the same widths through
    ``--model-dir``. The path launches no hand-written kernel (attention
    is plain torch, as it is XLA in JAX): its window must count none.
    Returns {window: launch counts}."""
    from gpustack_tpu_torch.engine.audio_server import (
        AudioServer,
        build_audio_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models import whisper as wh
    from gpustack_tpu_torch.models.audio import decode_wav, features_for_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_audio_engine_from_args(build_parser().parse_args(P_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, params = engine.cfg, engine.params
    device = params["tok_embed"].device
    wav = _seeded_wav(P_WAV_SECONDS, 0)
    mel_np = features_for_model(decode_wav(wav), cfg)
    mel = torch.from_numpy(mel_np)[None].to(device)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _widen(params)
    with torch.no_grad():
        enc = wh.encode(params, cfg, mel)
        enc32 = wh.encode(params32, cfg32, mel)
        enc_gate = _compare_logits(enc.float().flatten(), enc32.flatten())
        if enc_gate["cosine"] < LOGIT_MIN_COSINE:
            raise AssertionError(f"encoder bf16 vs fp32: {enc_gate}")
        encode_ms = cuda_time_ms(lambda: wh.encode(params, cfg, mel),
                                 warmup=1, iters=5)
        ids = wh.greedy_transcribe(params, cfg, mel_np,
                                   max_tokens=P_FORCED_STEPS)
        forced = [cfg.decoder_start_token_id, *ids]
        xk, xv = wh.cross_kv(params, cfg, enc)
        xk32, xv32 = wh.cross_kv(params32, cfg32, enc32)
        cache = wh.DecCache.create(cfg, 1, torch.bfloat16, device)
        cache32 = wh.DecCache.create(cfg, 1, torch.float32, device)
        steps = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for pos, tid in enumerate(forced):
            tok = torch.tensor([[tid]], device=device)
            start.record()
            logits, cache = wh.decode_step(params, cfg, tok, pos, xk, xv,
                                           cache)
            end.record()
            logits32, cache32 = wh.decode_step(params32, cfg32, tok, pos,
                                               xk32, xv32, cache32)
            torch.cuda.synchronize()
            gate = _compare_logits(logits[0], logits32[0])
            gate["ms"] = start.elapsed_time(end)
            steps.append(gate)
            if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
                gate["cosine"] < LOGIT_MIN_COSINE
            ):
                raise AssertionError(f"decoder step {pos}: {gate}")
    del params32, enc32, xk32, xv32, cache32
    _free()
    server = AudioServer(engine)
    port = server.start("127.0.0.1", 0)
    decode_calls = []
    kept = _count_calls(wh, "decode_step", decode_calls)
    try:
        reset_launch_counts()
        served = {}
        for route in ("transcriptions", "translations"):
            decode_calls.clear()
            t = time.perf_counter()
            status, ctype, raw = _post_multipart(
                port, f"/v1/audio/{route}",
                {"file": (wav, "speech.wav"), "model": (b"whisper", None)})
            wall_ms = (time.perf_counter() - t) * 1e3
            data = json.loads(raw)
            want_obj = ("audio.translation" if route == "translations"
                        else "audio.transcription")
            if data["object"] != want_obj or not isinstance(
                data["text"], str
            ) or data["duration_s"] != P_WAV_SECONDS:
                raise AssertionError(f"{route}: {data}")
            served[route] = {
                "request_ms": wall_ms, "server_latency_ms": data["latency_ms"],
                "decode_steps": len(decode_calls),
                "eos_before_cap": len(decode_calls)
                < cfg.max_target_positions - 1,
                "text_chars": len(data["text"]),
            }
        counts = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"the audio path launched kernels {counts}")
        health, metrics = _audio_health(port, "stt", 2)
    finally:
        setattr(wh, "decode_step", kept)
        server.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checkpoint = _whisper_checkpoint(cfg, mel_np, device)
    emit("whisper_path", model=cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, weights_gb=_tree_gb(params),
         wav_seconds=P_WAV_SECONDS, mel_frames=list(mel.shape[1:]),
         encoder_vs_fp32=enc_gate, encode_ms=encode_ms,
         forced_steps=len(forced), forced_ids=ids,
         decode_ms_per_token=statistics.median(s["ms"] for s in steps),
         decoder_vs_fp32_worst={
             "max_rel_err": max(s["max_abs_err"] / s["logit_scale"]
                                for s in steps),
             "min_cosine": min(s["cosine"] for s in steps)},
         tolerance={"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE},
         served=served, launches=counts, healthz=health, metrics=metrics,
         checkpoint=checkpoint, peak_mem_gb=peak_gb)
    return {"whisper": counts}


class _OwnerTape:
    """Inside ``with``, ``tts.frame_owners`` (the length regulation: which
    token each frame repeats) records its owners (``mode = "record"``) or
    replays the recorded ones (``"replay"``), as :class:`_RoutingTape`
    does for expert picks: a duration a hair apart in bf16 moves a frame
    across a token boundary, a discrete step that no tolerance on values
    covers. Any other mode regulates freely, and ``flips`` counts the
    frames whose owner differs from the recorded one."""

    def __init__(self):
        self.owners, self.mode, self.flips = None, "record", None

    def __enter__(self):
        from gpustack_tpu_torch.models import tts

        self._fn = tts.frame_owners

        def owners(cum, cfg):
            got = self._fn(cum, cfg)
            if self.mode == "record":
                self.owners = got
            elif self.mode == "replay":
                return self.owners
            else:
                self.flips = int((got != self.owners).sum())
            return got

        tts.frame_owners = owners
        return self

    def __exit__(self, *exc):
        from gpustack_tpu_torch.models import tts

        tts.frame_owners = self._fn


def phase_tts(kind, smi):
    """tts-base (dim 256, 4 + 4 layers, 80 mels, 1024-frame grid) in bf16,
    random weights from seed 0, behind the audio server's
    ``/v1/audio/speech``: a valid WAV of the frames the model predicts;
    ``synthesize_mel`` on the card against the fp32 plain reference over
    the same weights (frame counts equal, the mel within 2% of its scale
    with the card run's frame owners replayed in the reference; the free
    comparison and its owner flips beside it); ``synthesize_mel``'s device
    time and the host Griffin-Lim's. No hand-written kernel on this path.
    Returns {window: launch counts}."""
    import io
    import wave

    from gpustack_tpu_torch.engine.audio_server import (
        AudioServer,
        build_audio_engine_from_args,
        build_parser,
    )
    from gpustack_tpu_torch.models import tts

    t0 = time.perf_counter()
    engine = build_audio_engine_from_args(build_parser().parse_args(Q_ARGV))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, params = engine.cfg, engine.params
    ids = engine.tokenizer.encode(Q_TEXT)
    padded = torch.tensor(ids + [0] * (cfg.max_text_len - len(ids)),
                          device=params["tok_emb"].device)
    voice = tts.voice_index("alloy", cfg)
    params32 = _widen(params)
    with torch.no_grad(), _OwnerTape() as tape:
        mel, n, raw = tts.synthesize_mel(params, cfg, padded, len(ids),
                                         voice, 1.0)
        tape.mode = "replay"
        mel32, n32, raw32 = tts.synthesize_mel(params32, cfg, padded,
                                               len(ids), voice, 1.0)
        tape.mode = "free"
        free32 = tts.synthesize_mel(params32, cfg, padded, len(ids),
                                    voice, 1.0)[0]
    with torch.no_grad():
        synth_ms = cuda_time_ms(lambda: tts.synthesize_mel(
            params, cfg, padded, len(ids), voice, 1.0))
    frames = int(n)
    gate = {"n_frames": frames, "raw_frames": int(raw),
            "n_frames_fp32": int(n32), "raw_frames_fp32": int(raw32),
            "owners": "the card run's replayed",
            **_compare_logits(mel[:frames].flatten(),
                              mel32[:frames].flatten()),
            "free_owners": {
                "flipped_frames": tape.flips,
                **_compare_logits(mel[:frames].flatten(),
                                  free32[:frames].flatten())}}
    if (frames, int(raw)) != (int(n32), int(raw32)) or (
        gate["max_abs_err"] > 0.02 * gate["logit_scale"]
    ):
        raise AssertionError(f"synthesize_mel bf16 vs fp32: {gate}")
    t = time.perf_counter()
    tts.griffin_lim(mel[:frames].cpu().numpy(), cfg)
    griffin_lim_ms = (time.perf_counter() - t) * 1e3
    server = AudioServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        reset_launch_counts()
        t = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/audio/speech",
            data=json.dumps({"input": Q_TEXT, "voice": "alloy"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            ctype, data = resp.headers.get("Content-Type", ""), resp.read()
        request_ms = (time.perf_counter() - t) * 1e3
        counts = launch_counts()
        if any(counts.values()):
            raise AssertionError(f"the audio path launched kernels {counts}")
        with wave.open(io.BytesIO(data)) as wf:
            header = (wf.getnchannels(), wf.getsampwidth(),
                      wf.getframerate(), wf.getnframes())
        want = (1, 2, cfg.sample_rate, cfg.hop * (frames - 1) + cfg.n_fft)
        if ctype != "audio/wav" or header != want:
            raise AssertionError(f"WAV {ctype} {header}, want {want}")
        health, metrics = _audio_health(port, "tts", 1)
    finally:
        server.shutdown()
    emit("tts_path", model=cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, weights_gb=_tree_gb(params),
         input_tokens=len(ids), mel_vs_fp32=gate,
         tolerance={"mel_rel": 0.02, "frames": "equal"},
         synthesize_mel_ms=synth_ms, griffin_lim_host_ms=griffin_lim_ms,
         request_ms=request_ms, wav={"channels": header[0],
                                     "sample_width": header[1],
                                     "rate": header[2], "frames": header[3]},
         launches=counts, healthz=health, metrics=metrics)
    return {"tts": counts}


# ---------------------------------------------------------------------------
# r: image generation (the image server)
# ---------------------------------------------------------------------------

R_MODELS = (
    # the server's arguments, the sizes served beside the native one,
    # whether to serve n = 4 (else: the diffusers checkpoint)
    (["--preset", "sd15-shaped", "--port", "0"], (256,), False),
    (["--preset", "sdxl-shaped", "--port", "0"], (), True),
)
R_PROMPT = "a lighthouse on a cliff at dusk, oil on canvas"
R_NEGATIVE = "blurry, low quality"
R_STEPS = 30                 # the server's default
R_FEW_STEPS = 3              # determinism, extra sizes, n = 4, checkpoint
R_GUIDANCE = 7.5
R_GEN = "/v1/images/generations"
# bf16 against an fp32 run of the same functions over the same weights
# (no TF32): the text encoders and a UNet call within LOGIT_REL_TOL of the
# output's scale (the card's tolerance for deep bf16 forwards against fp32,
# as in phases j, k and p; the largest error measured is 2.3% of the
# scale, sdxl-shaped's 32-layer text2), cosine >= 0.999. The VAE's output
# is 0.8-3.1 M clipped values whose largest error is 5.8-6.2% of the
# scale at cosine >= 0.9998 (99.9% of them within 3%): its maximum is
# held within twice that, so a fault confined to a border or a tile still
# shows. Each DDIM step from the bf16 run's latents at cosine >= 0.99; the
# free 30-step runs are reported beside it (random weights saturate the
# x0 clip at +-10, so a rounding near its threshold moves a value by up
# to 20 and the runs part)
DIFFUSION_REL_TOL = LOGIT_REL_TOL
VAE_REL_TOL = 2 * LOGIT_REL_TOL
DIFFUSION_MIN_COSINE = 0.999
LATENTS_MIN_COSINE = 0.99
# each refusal of the JAX server's validation, with its body
R_REFUSALS = [
    (b"{not json", "invalid JSON"),
    ({}, "'prompt' is required"),
    ({"prompt": "x", "size": "123x123"},
     "size must be one of ['256x256', '512x512', '768x768', '1024x1024']"),
    ({"prompt": "x", "size": "512x256"}, "only square sizes are supported"),
    ({"prompt": "x", "size": "axb"}, "bad size 'axb'"),
    ({"prompt": "x", "n": "two"},
     "bad numeric parameter: invalid literal for int() with base 10: 'two'"),
]


@contextlib.contextmanager
def _exact_fp32():
    """fp32 products and convolutions without TF32 (cuDNN allows it by
    default): the references round only where fp32 does."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _diffusion_gate(got, want, min_cosine=DIFFUSION_MIN_COSINE,
                    rel=DIFFUSION_REL_TOL):
    got, want = got.float().flatten(), want.float().flatten()
    gate = _compare_logits(got, want)
    err = (got - want).abs()
    gate["p999_abs_err"] = torch.quantile(
        err[:: max(1, err.numel() // 2**24)], 0.999).item()
    gate["rms_err"] = err.square().mean().sqrt().item()
    gate["rms"] = want.square().mean().sqrt().item()
    if gate["max_abs_err"] > rel * gate["logit_scale"] or (
        gate["cosine"] < min_cosine
    ):
        raise AssertionError(f"bf16 vs fp32: {gate}")
    return gate


class _AttentionTimer:
    """Inside ``with``, each ``diffusion._attention`` call runs between
    two CUDA events; ``ms()`` sums their device time."""

    def __enter__(self):
        from gpustack_tpu_torch.models import diffusion as dm

        self._fn, self.events = dm._attention, []

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._fn(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

        dm._attention = timed
        return self

    def __exit__(self, *exc):
        from gpustack_tpu_torch.models import diffusion as dm

        dm._attention = self._fn

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _image_gates(engine):
    """The bf16 pipeline against an fp32 run of the same functions over
    the same weights upcast (no TF32), at the tolerances above: both text
    encoders (last, penultimate, pooled), one UNet call at the guided
    batch of 2, ``vae_decode``, and each step of a 30-step sample (the
    free fp32 run's final latents reported beside). Then the device
    times. Returns (gates, latents, times)."""
    from gpustack_tpu_torch.models import diffusion as dm

    cfg, params = engine.cfg, engine.params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _widen(params)
    size, ls = cfg.image_size, cfg.latent_size
    cond = engine._on_device(R_PROMPT, engine.tokenizer, 1)
    uncond = engine._on_device(R_NEGATIVE, engine.tokenizer, 1)
    enc = [("text", cond)]
    kw = {}
    if cfg.text2_dim:
        kw = {"cond_tokens2": engine._on_device(R_PROMPT, engine.tokenizer2,
                                                1),
              "uncond_tokens2": engine._on_device(
                  R_NEGATIVE, engine.tokenizer2, 1)}
        enc.append(("text2", kw["cond_tokens2"]))
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(1)
    noise = torch.randn((1, cfg.latent_channels, ls, ls), generator=gen,
                        device=engine.device)
    gates = {}
    with torch.no_grad(), _exact_fp32():
        for which, toks in enc:
            got = dm.encode_text(params, cfg, toks, which)
            want = dm.encode_text(params32, cfg32, toks, which)
            for part, g, w in zip(("last", "penultimate", "pooled"), got,
                                  want):
                gates[f"{which}_{part}"] = _diffusion_gate(g, w)
        context, added = dm.encode_prompts(params, cfg, cond, uncond, size,
                                           size, **kw)
        lat2 = torch.cat([noise, noise])
        t2 = torch.full((2,), 500, dtype=torch.int32, device=noise.device)
        gates["unet_batch2"] = _diffusion_gate(
            dm.unet_apply(params, cfg, lat2, t2, context, added),
            dm.unet_apply(params32, cfg32, lat2, t2, context, added))
        z = noise * cfg.scaling_factor
        gates["vae_decode"] = _diffusion_gate(
            dm.vae_decode(params, cfg, z), dm.vae_decode(params32, cfg32, z),
            rel=VAE_REL_TOL)
        # 30 steps from one noise: each fp32 step starts from the bf16
        # run's latents (the gate); the free fp32 run beside it
        context32, added32 = dm.encode_prompts(params32, cfg32, cond, uncond,
                                               size, size, **kw)
        lat, steps = noise, []
        for step in dm.ddim_schedule(cfg, R_STEPS):
            nxt = dm.ddim_step(params, cfg, lat, context, added, step,
                               R_GUIDANCE)
            steps.append(_diffusion_gate(
                nxt, dm.ddim_step(params32, cfg32, lat, context32, added32,
                                  step, R_GUIDANCE),
                LATENTS_MIN_COSINE, math.inf))
            lat = nxt
        lat32 = dm.denoise(params32, cfg32, noise, context32, added32,
                           R_STEPS, R_GUIDANCE)
        latents = {
            "per_step_min_cosine": min(g["cosine"] for g in steps),
            "per_step_max_rel_err": max(g["max_abs_err"] / g["logit_scale"]
                                        for g in steps),
            "per_step_last": steps[-1],
            "free_run": _compare_logits(lat.flatten(), lat32.flatten()),
        }
        del params32, context32, added32, lat32
        _free()

        times = {"text_encode_ms": cuda_time_ms(
            lambda: dm.encode_prompts(params, cfg, cond, uncond, size, size,
                                      **kw), warmup=1, iters=5)}
        times["unet_batch2_ms"] = cuda_time_ms(
            lambda: dm.unet_apply(params, cfg, lat2, t2, context, added),
            warmup=1, iters=5)
        lat8 = noise.expand(8, -1, -1, -1)
        t8 = torch.full((8,), 500, dtype=torch.int32, device=noise.device)
        context8 = context.repeat_interleave(4, dim=0)
        added8 = None if added is None else {
            k: v.repeat_interleave(4, dim=0) for k, v in added.items()}
        times["unet_batch8_ms"] = cuda_time_ms(
            lambda: dm.unet_apply(params, cfg, lat8, t8, context8, added8),
            warmup=1, iters=3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with _AttentionTimer() as timer:
            start.record()
            dm.unet_apply(params, cfg, lat2, t2, context, added)
            end.record()
            attn_ms = timer.ms()
        unet_ms = start.elapsed_time(end)
        times["unet_batch2_attention"] = {
            "calls": len(timer.events), "attention_ms": attn_ms,
            "unet_ms_timed_with_events": unet_ms, "share": attn_ms / unet_ms}
        times["vae_decode_ms"] = cuda_time_ms(
            lambda: dm.vae_decode(params, cfg, z), warmup=1, iters=3)
    return gates, latents, times


def _post_image(port, body):
    """(status, parsed body) of one generation request."""
    raw = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{R_GEN}", data=raw,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _served_pngs(port, body, n, size):
    """A generation that must succeed with ``n`` RGB PNGs of ``size``:
    (the PNG bytes, request ms)."""
    from gpustack_tpu_torch.models.png import decode_png

    t = time.perf_counter()
    status, data = _post_image(port, body)
    ms = (time.perf_counter() - t) * 1e3
    if status != 200 or len(data["data"]) != n:
        raise AssertionError(f"{body}: {status} {str(data)[:200]}")
    pngs = [base64.b64decode(d["b64_json"]) for d in data["data"]]
    for png in pngs:
        if decode_png(png).shape != (size, size, 3):
            raise AssertionError(f"{body}: a PNG is not {size} x {size} RGB")
    return pngs, ms


def _image_requests(engine, extra_sizes, n4):
    """The image server's requests, their checks and their times."""
    from gpustack_tpu_torch.engine.image_server import ImageServer, _png_bytes
    from gpustack_tpu_torch.models.png import decode_png

    cfg = engine.cfg
    native = cfg.image_size
    base = {"prompt": R_PROMPT, "negative_prompt": R_NEGATIVE}
    server = ImageServer(engine)
    port = server.start("127.0.0.1", 0)
    served, images, requests = {}, 0, 0
    try:
        pngs, ms = _served_pngs(port, {**base, "seed": 0}, 1, native)
        served["default_steps_n1"] = {"steps": R_STEPS, "size": native,
                                      "request_ms": ms, "png_bytes": len(pngs[0])}
        arr = decode_png(pngs[0]).astype("float32") / 255
        host = []
        for _ in range(3):
            t = time.perf_counter()
            _png_bytes(arr)
            host.append((time.perf_counter() - t) * 1e3)
        served["png_encode_host_ms"] = statistics.median(host)
        steps2 = R_FEW_STEPS if n4 else R_STEPS
        pngs, ms = _served_pngs(port, {**base, "seed": 1, "n": 2,
                                       "steps": steps2}, 2, native)
        if pngs[0] == pngs[1]:
            raise AssertionError("n = 2 gave two identical images")
        served["n2"] = {"steps": steps2, "request_ms": ms}
        few = {**base, "steps": R_FEW_STEPS}
        same = [_served_pngs(port, {**few, "seed": 42}, 1, native)[0][0]
                for _ in range(2)]
        other = _served_pngs(port, {**few, "seed": 43}, 1, native)[0][0]
        if same[0] != same[1] or other == same[0]:
            raise AssertionError("a seed does not fix the PNG bytes")
        served["seed"] = {"same_seed_bytes": "identical",
                          "other_seed_bytes": "differ"}
        images, requests = 1 + 2 + 3, 5
        for size in extra_sizes:
            _, ms = _served_pngs(port, {**few, "seed": 2,
                                        "size": f"{size}x{size}"}, 1, size)
            served[f"size_{size}"] = {"steps": R_FEW_STEPS, "request_ms": ms}
            images, requests = images + 1, requests + 1
        if n4:
            _free()
            torch.cuda.reset_peak_memory_stats()
            _, ms = _served_pngs(port, {**few, "seed": 3, "n": 4}, 4, native)
            served["n4"] = {"steps": R_FEW_STEPS, "request_ms": ms,
                            "peak_mem_gb":
                            torch.cuda.max_memory_allocated() / 1e9}
            images, requests = images + 4, requests + 1
        refusals = R_REFUSALS + [
            ({"prompt": "x", "size": f"{s}x{s}"},
             f"size {s} exceeds this model's native {native}")
            for s in (768, 1024) if s > native][:1]
        for body, error in refusals:
            status, data = _post_image(port, body)
            if (status, data) != (400, {"error": error}):
                raise AssertionError(f"{body}: {status} {data}")
        health = json.loads(_get(port, "/healthz"))
        want = {"status": "ok", "model": cfg.name, "modality": "image",
                "requests": requests, "images": images}
        if health != want:
            raise AssertionError(f"healthz {health}, want {want}")
        metrics = _get(port, "/metrics")
        for line in (f"gpustack_tpu_image_requests_total {requests}\n",
                     f"gpustack_tpu_images_generated_total {images}\n"):
            if line not in metrics:
                raise AssertionError(f"metrics {metrics!r}")
    finally:
        server.shutdown()
    return served, len(refusals), health, metrics.strip().splitlines()


def _randomized_tree(params, seed):
    """A copy of a diffusion tree with its biases N(0, 0.1) and norm gains
    1 + N(0, 0.1) (the init's are zeros and ones; a swapped or dropped one
    must show in a round trip)."""
    gen = torch.Generator(device=params["unet"]["conv_in_w"].device)
    gen.manual_seed(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if node is None:
            return None
        t = node.clone()
        if key.endswith("_g"):
            t.normal_(generator=gen).mul_(0.1).add_(1)
        elif re.fullmatch(r"b|b\w|.*_b\d?|.*_ob", key):
            t.normal_(generator=gen).mul_(0.1)
        return t

    return walk(params)


def _diffusers_files(tree, cfg):
    """An SD 1.x diffusion tree under diffusers names and torch layouts (linear
    ``[out, in]``; conv OIHW; SD 1.x's ``proj_in``/``proj_out``,
    ``conv_shortcut`` and ``post_quant_conv`` as 1x1 convs):
    {component: ({name: tensor}, config.json)}."""

    def lin(w):
        return w.T

    def conv1x1(w):
        return w.T[:, :, None, None]

    def clip(p):
        out = {
            "text_model.embeddings.token_embedding.weight": p["tok_emb"],
            "text_model.embeddings.position_embedding.weight": p["pos_emb"],
            "text_model.final_layer_norm.weight": p["lnf_g"],
            "text_model.final_layer_norm.bias": p["lnf_b"],
        }
        names = {"wq": "self_attn.q_proj.weight",
                 "bq": "self_attn.q_proj.bias",
                 "wk": "self_attn.k_proj.weight",
                 "bk": "self_attn.k_proj.bias",
                 "wv": "self_attn.v_proj.weight",
                 "bv": "self_attn.v_proj.bias",
                 "wo": "self_attn.out_proj.weight",
                 "bo": "self_attn.out_proj.bias",
                 "ln1_g": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
                 "ln2_g": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
                 "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
                 "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias"}
        for leaf, name in names.items():
            for i, t in enumerate(p["layers"][leaf]):
                out[f"text_model.encoder.layers.{i}.{name}"] = (
                    lin(t) if t.dim() == 2 else t)
        if "proj" in p:
            out["text_projection.weight"] = lin(p["proj"])
        return out

    def res(p, pre):
        out = {f"{pre}.{n}.{w}": p[f"{n}_{'g' if w == 'weight' else 'b'}"]
               for n in ("norm1", "norm2") for w in ("weight", "bias")}
        out.update({f"{pre}.{c}.weight": p[f"{c}_w"] for c in ("conv1",
                                                               "conv2")})
        out.update({f"{pre}.{c}.bias": p[f"{c}_b"] for c in ("conv1",
                                                             "conv2")})
        if "temb_w" in p:
            out[f"{pre}.time_emb_proj.weight"] = lin(p["temb_w"])
            out[f"{pre}.time_emb_proj.bias"] = p["temb_b"]
        if "skip_w" in p:
            out[f"{pre}.conv_shortcut.weight"] = conv1x1(p["skip_w"])
            out[f"{pre}.conv_shortcut.bias"] = p["skip_b"]
        return out

    def spatial(p, pre):
        out = {f"{pre}.norm.weight": p["norm_g"],
               f"{pre}.norm.bias": p["norm_b"],
               f"{pre}.proj_in.weight": conv1x1(p["proj_in_w"]),
               f"{pre}.proj_in.bias": p["proj_in_b"],
               f"{pre}.proj_out.weight": conv1x1(p["proj_out_w"]),
               f"{pre}.proj_out.bias": p["proj_out_b"]}
        for k, bp in enumerate(p["blocks"]):
            b = f"{pre}.transformer_blocks.{k}"
            for i in (1, 2, 3):
                out[f"{b}.norm{i}.weight"] = bp[f"ln{i}_g"]
                out[f"{b}.norm{i}.bias"] = bp[f"ln{i}_b"]
            for a in ("attn1", "attn2"):
                for x in "qkv":
                    out[f"{b}.{a}.to_{x}.weight"] = lin(bp[f"{a}_{x}"])
                out[f"{b}.{a}.to_out.0.weight"] = lin(bp[f"{a}_o"])
                out[f"{b}.{a}.to_out.0.bias"] = bp[f"{a}_ob"]
            out[f"{b}.ff.net.0.proj.weight"] = lin(bp["ff_w1"])
            out[f"{b}.ff.net.0.proj.bias"] = bp["ff_b1"]
            out[f"{b}.ff.net.2.weight"] = lin(bp["ff_w2"])
            out[f"{b}.ff.net.2.bias"] = bp["ff_b2"]
        return out

    def updown(p, pre):
        return {} if p is None else {f"{pre}.conv.weight": p["w"],
                                     f"{pre}.conv.bias": p["b"]}

    u = tree["unet"]
    unet = {"time_embedding.linear_1.weight": lin(u["time_w1"]),
            "time_embedding.linear_1.bias": u["time_b1"],
            "time_embedding.linear_2.weight": lin(u["time_w2"]),
            "time_embedding.linear_2.bias": u["time_b2"],
            "conv_in.weight": u["conv_in_w"], "conv_in.bias": u["conv_in_b"],
            "conv_norm_out.weight": u["norm_out_g"],
            "conv_norm_out.bias": u["norm_out_b"],
            "conv_out.weight": u["conv_out_w"],
            "conv_out.bias": u["conv_out_b"]}
    for side, key, sampler in (("down_blocks", "down", "downsamplers"),
                               ("up_blocks", "up", "upsamplers")):
        for li, lv in enumerate(u[key]):
            for j, rp in enumerate(lv["res"]):
                unet.update(res(rp, f"{side}.{li}.resnets.{j}"))
                if lv["attn"] is not None:
                    unet.update(spatial(lv["attn"][j],
                                        f"{side}.{li}.attentions.{j}"))
            unet.update(updown(lv[key], f"{side}.{li}.{sampler}.0"))
    unet.update(res(u["mid"]["res1"], "mid_block.resnets.0"))
    unet.update(spatial(u["mid"]["attn"], "mid_block.attentions.0"))
    unet.update(res(u["mid"]["res2"], "mid_block.resnets.1"))

    v, at = tree["vae"], "decoder.mid_block.attentions.0"
    vae = {"post_quant_conv.weight": conv1x1(v["post_quant_w"]),
           "post_quant_conv.bias": v["post_quant_b"],
           "decoder.conv_in.weight": v["conv_in_w"],
           "decoder.conv_in.bias": v["conv_in_b"],
           "decoder.conv_norm_out.weight": v["norm_out_g"],
           "decoder.conv_norm_out.bias": v["norm_out_b"],
           "decoder.conv_out.weight": v["conv_out_w"],
           "decoder.conv_out.bias": v["conv_out_b"],
           f"{at}.group_norm.weight": v["mid"]["attn"]["norm_g"],
           f"{at}.group_norm.bias": v["mid"]["attn"]["norm_b"]}
    for x, name in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                    ("o", "to_out.0")):
        vae[f"{at}.{name}.weight"] = lin(v["mid"]["attn"][f"{x}_w"])
        vae[f"{at}.{name}.bias"] = v["mid"]["attn"][f"{x}_b"]
    vae.update(res(v["mid"]["res1"], "decoder.mid_block.resnets.0"))
    vae.update(res(v["mid"]["res2"], "decoder.mid_block.resnets.1"))
    for ui, lv in enumerate(v["up"]):
        for j, rp in enumerate(lv["res"]):
            vae.update(res(rp, f"decoder.up_blocks.{ui}.resnets.{j}"))
        vae.update(updown(lv["up"], f"decoder.up_blocks.{ui}.upsamplers.0"))

    mc = cfg.model_channels
    return {
        "text_encoder": (clip(tree["text"]), {
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.text_dim,
            "num_hidden_layers": cfg.text_layers,
            "num_attention_heads": cfg.text_heads,
            "max_position_embeddings": cfg.max_text_len,
            "hidden_act": cfg.text_act}),
        "unet": (unet, {
            "in_channels": cfg.latent_channels,
            "sample_size": cfg.latent_size,
            "block_out_channels": [mc * m for m in cfg.channel_mult],
            "layers_per_block": cfg.num_res_blocks,
            "down_block_types": [
                "CrossAttnDownBlock2D" if i in cfg.attn_levels
                else "DownBlock2D" for i in range(len(cfg.channel_mult))],
            "transformer_layers_per_block": list(cfg.transformer_depth),
            "attention_head_dim": list(cfg.num_heads),
            "cross_attention_dim": cfg.context_dim,
            "prediction_type": cfg.prediction_type}),
        "vae": (vae, {
            "block_out_channels": [cfg.vae_channels * m
                                   for m in cfg.vae_channel_mult],
            "layers_per_block": cfg.vae_res_blocks,
            "scaling_factor": cfg.scaling_factor}),
    }


def _diffusion_checkpoint(engine):
    """The served model whole (its biases and norm gains drawn at random)
    written as a diffusers directory by the script's own writer and served
    through ``--model-dir``: the loaded config and tree (dtypes and
    values) identical to the in-memory ones, and the same seed's PNG bytes
    identical."""
    from gpustack_tpu_torch.engine.image_server import (
        ImageEngine,
        build_image_engine_from_args,
        build_parser,
    )

    cfg = engine.cfg
    tree = _randomized_tree(engine.params, 3)
    with tempfile.TemporaryDirectory(prefix="diffusers-ckpt-") as d:
        t0 = time.perf_counter()
        nbytes = 0
        with open(os.path.join(d, "model_index.json"), "w") as f:
            json.dump({"_class_name": "StableDiffusionPipeline"}, f)
        for sub, (tensors, config) in _diffusers_files(tree, cfg).items():
            os.makedirs(os.path.join(d, sub))
            nbytes += write_safetensors(os.path.join(
                d, sub, "diffusion_pytorch_model.safetensors"), tensors)
            with open(os.path.join(d, sub, "config.json"), "w") as f:
                json.dump(config, f)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = build_image_engine_from_args(build_parser().parse_args(
            ["--model-dir", d, "--port", "0", "--device",
             str(engine.device)]))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if dataclasses.replace(loaded.cfg, name=cfg.name) != cfg:
        raise AssertionError(f"loaded config {loaded.cfg}")
    want, got = _leaves(tree), _leaves(loaded.params)
    bad = sorted(k for k in want if k not in got or got[k].dtype
                 != want[k].dtype or not torch.equal(got[k], want[k]))
    if bad or set(got) != set(want):
        raise AssertionError(f"loaded diffusion tree differs at {bad[:5]}")
    kw = {"prompt": R_PROMPT, "negative": R_NEGATIVE, "steps": R_FEW_STEPS,
          "seed": 5}
    if ImageEngine(cfg, tree).generate(**kw) != loaded.generate(**kw):
        raise AssertionError("checkpoint PNG bytes differ")
    return {"bytes": nbytes, "write_s": write_s, "load_s": load_s,
            "tree": "identical", "png_bytes": "identical"}


def _image_path(kind, smi, argv, extra_sizes, n4):
    from gpustack_tpu_torch.engine.image_server import (
        build_image_engine_from_args,
        build_parser,
    )

    held_gb = _held_gb(argv[1])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_image_engine_from_args(build_parser().parse_args(argv))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = engine.cfg
    n_params = sum(t.numel() for t in _leaves(engine.params).values())
    reset_launch_counts()
    t0 = time.perf_counter()
    gates, latents, times = _image_gates(engine)
    gates_s = time.perf_counter() - t0
    _free()
    served, n_refusals, health, metrics = _image_requests(
        engine, extra_sizes, n4)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the image path launched kernels {counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    checkpoint = None
    if not n4:
        checkpoint = _diffusion_checkpoint(engine)
    emit("image_path", model=cfg.name, device=kind, nvidia_smi=smi,
         setup_s=setup_s, held_gb_before=held_gb, params_b=n_params / 1e9,
         weights_gb=_tree_gb(engine.params), image_size=cfg.image_size,
         latent_size=cfg.latent_size, text_encoders=2 if cfg.text2_dim else 1,
         vs_fp32=gates, tolerance={"rel": DIFFUSION_REL_TOL,
                                   "vae_rel": VAE_REL_TOL,
                                   "min_cosine": DIFFUSION_MIN_COSINE,
                                   "latents_min_cosine": LATENTS_MIN_COSINE},
         latents_30_steps_vs_fp32=latents, gates_s=gates_s, **times,
         served=served, refusals=n_refusals, launches=counts,
         healthz=health, metrics=metrics, peak_mem_gb=peak_gb,
         checkpoint=checkpoint)
    return counts


def phase_images(kind, smi):
    """sd15-shaped (0.96 B parameters, 512 px, 64 x 64 latents) and
    sdxl-shaped (3.39 B, 1024 px, 128 x 128 latents, two text encoders,
    depth 10 at its lowest level) at full width in bf16, random weights
    from seed 0, behind the port's image server. For each: both text
    encoders, one UNet call at the guided batch of 2 and ``vae_decode``
    against an fp32 run of the same functions over the same weights
    upcast (5% of the scale, the VAE 10%; cosine 0.999), each step of a
    30-step sample against an fp32 step from the same latents (cosine
    0.99; the free fp32 run beside it); the device times of the text
    encoders, a UNet call at batch 2 and 8 (with its attention's share)
    and the VAE; then ``/v1/images/generations`` at the default 30 steps
    (timed, with the host ms of its PNG encode), n = 2, one seed twice and
    another, the other sizes, n = 4 on sdxl-shaped (peak memory), every
    refusal of JAX's validation, ``/healthz`` and ``/metrics``. sd15-shaped
    is also written whole as a diffusers checkpoint and served through
    ``--model-dir``. No hand-written kernel serves this path (its
    attention is plain torch, as it is XLA in JAX): its windows must count
    none. Returns {window: launch counts}."""
    paths = {}
    for argv, extra_sizes, n4 in R_MODELS:
        paths[f"image_{argv[1].split('-')[0]}"] = _image_path(
            kind, smi, argv, extra_sizes, n4)
        _free()
    return paths


# ---------------------------------------------------------------------------
# s: four GPUs, tensor- and expert-parallel serving
# ---------------------------------------------------------------------------

S_GPUS = 4
S1_ARGV = ["--preset", "llama3-70b", "--num-devices", "4"] + MAIN_ARGV[2:]
S3_ARGV = ["--preset", "mixtral-8x7b", "--num-devices", "4"] + MAIN_ARGV[2:]
# prompt tokens of the TTFT requests, by the bucket each fills
S_TTFT_TOKENS = {2048: 1900, 512: 480, 128: 100}
S_DECODE_TOKENS = 128
# the sharded-forward checks (s2, s4): llama3-70b at full width, cut in
# depth; the MoE layer (s3): one mixtral-8x7b layer at full width
S_DENSE_PRESET = "llama3-70b"
S_MOE_PRESET = "mixtral-8x7b"
S_SHARD_LAYERS = 4
S_SHARD_TOKENS = 512
S_MOE_TOKENS = (2048, 8)
# fp32 with TF32 off, tp4 against one card: the same products summed in
# another order (the all-reduce adds four partial sums)
SHARD_REL_TOL = 1e-4
S_RANK_TIMEOUT_S = 900
S_RANK_DEVICE = "cuda"
# the kernels whose launches each rank reports (diagnostics.probe)
S_KERNELS = ("flash_attention_prefill", "w8a16_matmul", "w8a16_grouped",
             "bf16_grouped")


def _s_ids(n, vocab, seed):
    """``n`` prompt ids from a seed, inside the vocab."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(10, min(vocab, 30000), (n,), generator=gen).tolist()


def _nccl_share(path):
    """From a Chrome trace: the device time of NCCL kernels, of all
    kernels, and the share."""
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "kernel"]
    total = sum(e["dur"] for e in kernels)
    nccl = sum(e["dur"] for e in kernels if "nccl" in e["name"].lower())
    return {"nccl_ms": nccl / 1e3, "kernel_ms": total / 1e3,
            "nccl_share": nccl / max(total, 1e-9),
            "nccl_kernels": sum("nccl" in e["name"].lower() for e in kernels)}


def _s_prefill_profile(engine, n_tokens):
    """One prefill of the bucket ``n_tokens`` fills, from this thread on
    an idle engine (the leader broadcasts it; every rank runs it), timed
    with CUDA events, then once more under ``torch.profiler`` on rank 0:
    its NCCL share."""
    runner = engine.runner
    ids = _s_ids(n_tokens, runner.cfg.vocab_size, 5)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    times = []
    with torch.no_grad():
        for i in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            runner.prefill(padded, len(ids))
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        with tempfile.TemporaryDirectory(prefix="s-prefill-") as d:
            path = os.path.join(d, "trace.json")
            with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA,
            ]) as prof:
                runner.prefill(padded, len(ids))
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            share = _nccl_share(path)
    return {"prefill_ms": statistics.median(times),
            "prefill_ms_runs": times, **share}


def _s_logit_gate(engine, slot=None, replay=False):
    """The standing logit gate over the mesh: a prefill through the
    served path (the flash kernel on every rank) against a prefill of the
    same prompt through the plain attention on the same ranks
    (``probe("prefill_plain")``), last-position logits. MoE routing is
    free in both runs (each rank's router sees the same activations; a
    pick near a tie may flip between the two runs); with ``replay`` the
    plain run replays each rank's served picks (``probe("routing_*")``)
    and the free run's numbers ride beside. Under ``dp`` a ``slot``
    makes both prefills its group's, their logits sent to rank 0."""
    runner, state = engine.runner, engine._state
    ids = _s_ids(1900, runner.cfg.vocab_size, 3)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    extra = {}
    with torch.no_grad():
        if replay:
            runner.probe(state, "routing_record")
        served, _, _ = runner.prefill(padded, len(ids), slot=slot)
        if replay:
            runner.probe(state, "routing_replay")
        plain = runner.probe(state, "prefill_plain", padded, len(ids),
                             slot=slot)
        if replay:
            tapes = runner.probe(state, "routing")
            free = runner.probe(state, "prefill_plain", padded, len(ids),
                                slot=slot)
            extra = {"routing": "the served picks replayed in the plain "
                     "run, on every rank",
                     "flipped_tokens_per_rank": [sum(t["flips"])
                                                 for t in tapes],
                     "free_routing": _compare_logits(served, free)}
    if served.shape != (runner.cfg.vocab_size,) or not torch.isfinite(
        served
    ).all():
        raise AssertionError(f"bad logits {tuple(served.shape)}")
    gate = _compare_logits(served, plain)
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
        gate["cosine"] < LOGIT_MIN_COSINE
    ):
        raise AssertionError(f"served prefill logits differ: {gate}")
    return {**gate, "prompt_tokens": len(ids), "slot": slot, **extra,
            "reference": "plain attention, bf16, the same ranks",
            "tolerance": {"rel": LOGIT_REL_TOL,
                          "min_cosine": LOGIT_MIN_COSINE}}


def _s_decode_rate(engine):
    """8 chats decoding at once, ``S_DECODE_TOKENS`` each: tokens/s after
    every first token."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    reqs = [
        engine.submit(GenRequest(
            prompt_ids=_s_ids(24, engine.cfg.vocab_size, 100 + i),
            max_tokens=S_DECODE_TOKENS, temperature=0.0, stop_ids=(),
        ))
        for i in range(engine.max_slots)
    ]
    for r in reqs:
        if not r.done.wait(600):
            raise AssertionError("a decode-rate request timed out")
    if any(len(r.output_ids) != S_DECODE_TOKENS for r in reqs):
        raise AssertionError("a chat stopped early")
    t_first = max(r.first_token_at for r in reqs)
    t_end = max(r.finished_at for r in reqs)
    after_first = sum(len(r.output_ids) - 1 for r in reqs)
    return after_first / max(t_end - t_first, 1e-9), len(reqs)


def _s_served(argv, label, kind, smi, gate_slot=None, replay=False,
              checks=()):
    """One model across the GPUs through the port's server: this process
    is rank 0 (``build_engine_from_args`` starts a follower process per
    other GPU) and serves HTTP. The standing logit gate
    (:func:`_s_logit_gate` with ``gate_slot`` and ``replay``), then each
    of ``checks`` (a function of the idle engine returning its report);
    then, counted on every rank: one prompt at each TTFT bucket, a chat
    over HTTP and 8 chats decoding at once; every rank's launches equal
    what the leader's runner calls need on that rank
    (``expected_launches``: the flash kernel once per layer of each
    prefill its ``dp`` group ran, the grouped kernel three times per MoE
    layer of each forward); every follower's slot state equal to the
    leader's; peak memory per rank; then the NCCL share of a 20-step
    decode profile and of a 2048-bucket prefill on rank 0."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
        shutdown_replica,
    )
    from gpustack_tpu_torch.engine.engine import GenRequest
    from gpustack_tpu_torch.parallel.mesh import rank_coords

    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(argv))
    runner = engine.runner
    state = engine._state
    cfg, plan = runner.cfg, runner.plan
    world = plan.chips
    runner.probe(state, "memory")         # every rank is up
    setup_s = time.perf_counter() - t0
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        gate = _s_logit_gate(engine, gate_slot, replay)
        checked = {}
        for check in checks:
            checked.update(check(engine))
        for n in S_TTFT_TOKENS.values():          # warm every bucket
            engine.generate(GenRequest(
                prompt_ids=_s_ids(n, cfg.vocab_size, n), max_tokens=2,
                temperature=0.0), timeout=600)
        runner.probe(state, "reset_memory")
        calls = RunnerCalls(engine.runner, int8=False)
        runner.probe(state, "reset_launches")
        calls.reset()
        ttft = {}
        for bucket, n in S_TTFT_TOKENS.items():
            req = engine.generate(GenRequest(
                prompt_ids=_s_ids(n, cfg.vocab_size, 7 + bucket),
                max_tokens=2, temperature=0.0), timeout=600)
            ttft[f"ttft_ms_{bucket}_bucket"] = req.ttft_ms
        msgs = [{"role": "user", "content": f"Say hello to {world} H100s."}]
        _, raw = _post(port, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 16, "temperature": 0})
        _check_usage(json.loads(raw),
                     len(engine.tokenizer.apply_chat_template(msgs)))
        rate, chats = _s_decode_rate(engine)
        launches = runner.probe(state, "launches")
        memory = runner.probe(state, "memory")
        states = runner.probe(state, "slot_state")
        window = calls.counts()
        wants = []
        for r in range(world):
            c = rank_coords(plan, r)
            wants.append(expected_launches([calls], c["sp"], c["dp"]))
        for name in S_KERNELS:
            want = [w[name] for w in wants]
            if launches[name] != want:
                raise AssertionError(
                    f"{label}: {name} launched {launches[name]} per rank, "
                    f"the leader's forwards need {want}"
                )
        if window["prefill"] != len(S_TTFT_TOKENS) + 1 + chats:
            raise AssertionError(f"{label}: runner calls {window}")
        for rank, st in enumerate(states[1:], start=1):
            if not torch.equal(st, states[0]):
                raise AssertionError(
                    f"{label}: rank {rank}'s slot state parted from the "
                    f"leader's: {st.tolist()} vs {states[0].tolist()}"
                )
        health = engine.health()
        if health["status"] != "ok":
            raise AssertionError(f"{label}: engine unhealthy: {health}")
        decode_profile = _profile(port, label, read_trace=_nccl_share)
        prefill = _s_prefill_profile(engine, S_TTFT_TOKENS[2048])
        report = {
            "model": cfg.name, "plan": str(plan), "layers": cfg.num_layers,
            "device": kind, "nvidia_smi": smi, "setup_s": setup_s,
            "logit_check": gate, **checked, **ttft,
            "max_slots": engine.max_slots,
            "decode_tokens_per_s_8_slots": rate,
            "decode_tokens_per_chat": S_DECODE_TOKENS,
            "launches_per_rank": {n: launches[n] for n in S_KERNELS},
            "runner_calls": window,
            "peak_mem_gb_per_rank": [m / 1e9 for m in memory],
            "followers_slot_state_equal": True,
            "layout": health["layout"],
            "decode_profile": {k: decode_profile[k] for k in (
                "device_busy_share", "device_ms_per_step", "idle_ms_per_step",
                "step_ms_unprofiled", "nccl_ms", "kernel_ms", "nccl_share",
                "nccl_kernels", "top_device_ops")},
            "prefill_2048": prefill,
        }
        emit(f"multi_gpu_{label}", **report)
        return report
    finally:
        server.shutdown()
        engine.stop()
        shutdown_replica(engine, timeout=120)


def _s_same(a, b):
    from gpustack_tpu_torch.models.quant import QuantW

    if isinstance(a, QuantW):
        return torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    return torch.equal(a, b)


def _s_sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _s_dense_case(mesh, device, int8, preset):
    """llama3-70b at ``S_SHARD_LAYERS`` layers: this rank's shard drawn as
    the server draws it, against the slice of the one-card tree from the
    same seed (bit for bit, every leaf); then a prefill of
    ``S_SHARD_TOKENS`` through the sharded forward against the one-card
    forward of the same tree on this rank's card. fp32 with TF32 off and
    the plain attention: within ``SHARD_REL_TOL`` of the logit scale;
    int8 (bf16 activations, the flash and W8A16 kernels on the shards):
    the standing logit gate. The launches are the sharded run's."""
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models import transformer as tf
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.models.quant import init_quantized_params
    from gpustack_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(
        get_config(preset), num_layers=S_SHARD_LAYERS,
        dtype="bfloat16" if int8 else "float32",
    )

    def draw(mesh_or_none):
        if int8:
            return init_quantized_params(cfg, seed=0, device=device,
                                         mesh=mesh_or_none)
        return load_or_init_params(cfg, None, seed=0, device=device,
                                   mesh=mesh_or_none)

    shard, full = draw(mesh), draw(None)
    cut = _leaves(shard_params(full, mesh, cfg.num_kv_heads))
    mine = _leaves(shard)
    unequal = [p for p, leaf in mine.items() if not _s_same(leaf, cut[p])]
    del cut
    T = S_SHARD_TOKENS
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen).to(device)
    pos = torch.arange(T, device=device)[None]
    attn = "flash" if int8 else "plain"
    with torch.no_grad():
        reset_launch_counts()
        cache = tf.KVCache.create(cfg, 1, T, device, mesh.tp)
        got, _ = tf.forward(shard, cfg, toks, pos, cache, attn_impl=attn,
                            mesh=mesh)
        _s_sync(device)
        launches = {n: launch_counts()[n] for n in S_KERNELS}
        cache = tf.KVCache.create(cfg, 1, T, device)
        want, _ = tf.forward(full, cfg, toks, pos, cache, attn_impl=attn)
    cmp = _compare_logits(got.flatten(), want.flatten())
    if int8:
        ok = (cmp["max_abs_err"] <= LOGIT_REL_TOL * cmp["logit_scale"]
              and cmp["cosine"] >= LOGIT_MIN_COSINE)
        tol = {"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE}
    else:
        ok = cmp["max_abs_err"] <= SHARD_REL_TOL * cmp["logit_scale"]
        tol = {"rel": SHARD_REL_TOL}
    return {"model": cfg.name, "layers": cfg.num_layers, "tokens": T,
            "weights": "int8" if int8 else "fp32, TF32 off",
            "attention": attn, "leaves": len(mine), "unequal_leaves": unequal,
            **cmp, "tolerance": tol, "ok": ok and not unequal,
            "launches": launches}


def _s_moe_layer(mesh, device, preset):
    """One mixtral-8x7b MoE layer at full width under ``ep2xtp2``: the
    rank's experts and width (its shard, drawn as the server draws it;
    equal to the one-card tree's slice) through ``_moe_mlp`` on the mesh,
    against the fp32 routed reference over the one-card layer's weights
    with the sharded run's picks replayed (phase h's check), at 2048 and 8
    tokens; CUDA-event ms per call (its all-reduce included)."""
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models import transformer as tf
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.parallel.sharding import shard_params

    cfg = dataclasses.replace(get_config(preset), num_layers=1)
    shard = load_or_init_params(cfg, None, seed=0, device=device, mesh=mesh)
    full = load_or_init_params(cfg, None, seed=0, device=device)
    cut = shard_params(full, mesh, cfg.num_kv_heads)
    unequal = [k for k, v in shard["layers"].items()
               if not torch.equal(v, cut["layers"][k])]
    del cut
    lp, fl = shard["layers"], full["layers"]
    out = {"model": cfg.name, "plan": str(mesh.plan),
           "local_experts": lp["we_gate"].shape[1],
           "local_expert_width": lp["we_gate"].shape[-1],
           "unequal_leaves": unequal, "cases": []}
    for tokens in S_MOE_TOKENS:
        gen = torch.Generator(device=device).manual_seed(tokens)
        x = tf.rms_norm(
            torch.randn(1, tokens, cfg.hidden_size, generator=gen,
                        device=device).bfloat16(),
            lp["mlp_norm"][0], cfg.rms_norm_eps,
        )

        def layer():
            return tf._moe_mlp(x, lp["router"][0], lp["we_gate"][0],
                               lp["we_up"][0], lp["we_down"][0], cfg,
                               mesh=mesh)

        with torch.no_grad(), _RoutingTape() as tape:
            reset_launch_counts()
            got = layer().reshape(-1, cfg.hidden_size).float()
            _s_sync(device)
            launches = {n: launch_counts()[n] for n in S_KERNELS}
            tape.mode = "replay"
            ref, _ = _moe_routed_reference(x, fl, 0, cfg)
        with torch.no_grad():      # routing free again
            if device.type == "cuda":
                ms = cuda_time_ms(layer)
            else:
                layer()            # the same collectives, untimed
                ms = None
        cmp = _compare_logits(got.flatten(), ref.flatten())
        ok = (torch.isfinite(got).all().item()
              and cmp["max_abs_err"] <= MOE_REL_TOL * cmp["logit_scale"]
              and cmp["cosine"] >= MOE_MIN_COSINE)
        out["cases"].append({
            "tokens": tokens, "ms": ms, "launches": launches,
            "max_abs_err": cmp["max_abs_err"], "out_scale":
            cmp["logit_scale"], "cosine": cmp["cosine"],
            "flipped_picks": sum(tape.flips), "ok": bool(ok),
            "tolerance": {"rel": MOE_REL_TOL, "min_cosine": MOE_MIN_COSINE},
        })
    out["ok"] = not unequal and all(c["ok"] for c in out["cases"])
    return out


def _s_allreduce(mesh, device, shape):
    """One ``tp`` all-reduce of a bf16 ``shape`` (the sharded forward's
    own): host µs per call (wall clock around back-to-back enqueues) and
    device ms per call (CUDA events), on this rank."""
    x = torch.ones(shape, dtype=torch.bfloat16, device=device)
    out = {"shape": list(shape), "mbytes": x.numel() * 2 / 1e6}
    if device.type == "cuda":
        out["host_us_per_call"] = host_us_per_call(
            lambda: mesh.all_reduce_tp(x), iters=100)
        out["device_ms"] = cuda_time_ms(lambda: mesh.all_reduce_tp(x))
    else:
        mesh.all_reduce_tp(x)
    return out


def _s_shard_rank(rank, world, coordinator, dense, moe, device_type):
    """One rank of the sharded checks (s2, s4, the s3 MoE layer) on
    presets ``dense`` and ``moe``, in a process of its own: on
    ``cuda:<rank>`` over NCCL (``device_type`` "cpu": gloo, for a
    rehearsal)."""
    from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    mesh = init_mesh(MeshPlan(tp=world), rank, coordinator, device)
    out = {"rank": rank}
    # the all-reduce after an attention or MLP block of llama3-70b: a
    # decode step's (8 slots) and a 2048-bucket prefill's
    out["allreduce"] = [_s_allreduce(mesh, device, shape)
                        for shape in ((8, 1, 8192), (1, 2048, 8192))]
    out["fp32_tp4"] = _s_dense_case(mesh, device, False, dense)
    _s_free(device)
    out["int8_tp4"] = _s_dense_case(mesh, device, True, dense)
    _s_free(device)
    out["moe_layer"] = _s_moe_layer(Mesh(MeshPlan(ep=2, tp=world // 2), rank),
                                    device, moe)
    return out


def _s_free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _s_sharded_checks(kind, smi):
    """s2, s4 and s3's MoE layer, one process per GPU
    (``parallel.launch.run_ranks``): each check's lines, each rank held
    to its gates. Returns the ranks' reports."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    ranks = run_ranks(_s_shard_rank, S_GPUS, S_DENSE_PRESET, S_MOE_PRESET,
                      S_RANK_DEVICE, timeout=S_RANK_TIMEOUT_S)
    emit("multi_gpu_allreduce", device=kind, nvidia_smi=smi,
         per_rank=[r["allreduce"] for r in ranks])
    for key in ("fp32_tp4", "int8_tp4", "moe_layer"):
        emit(f"multi_gpu_{key}", device=kind, nvidia_smi=smi,
             **ranks[0][key], per_rank_ok=[r[key]["ok"] for r in ranks],
             per_rank_unequal_leaves=[len(r[key]["unequal_leaves"])
                                      for r in ranks])
        bad = [r["rank"] for r in ranks if not r[key]["ok"]]
        if bad:
            raise AssertionError(f"phase s {key}: ranks {bad} failed")
    return ranks


def phase_multi_gpu(kind, smi):
    """s1. llama3-70b, bf16, 80 layers, ``tp4`` through the server; s3.
    mixtral-8x7b, bf16, ``ep2xtp2`` through the server (``_s_served``
    each); then, in one process per GPU (:func:`_s_sharded_checks`): s2,
    the sharding at full width (llama3-70b at 4 layers, fp32, tp4 against
    one card), s4, int8 under tp4 against one-card int8, and s3's MoE
    layer against its fp32 routed reference. Returns each kernel's
    launches per rank on those paths."""
    if S_RANK_DEVICE == "cuda" and torch.cuda.device_count() < S_GPUS:
        raise AssertionError(f"phase s needs {S_GPUS} cards")
    dense = _s_served(S1_ARGV, "tp4", kind, smi)
    # the served engine's reference cycles (the counting wrappers) hold
    # its weights until a collection: free them before the next model
    _free()
    moe = _s_served(S3_ARGV, "ep2xtp2", kind, smi)
    _free()
    ranks = _s_sharded_checks(kind, smi)
    per_rank = {}
    for report in (dense, moe):
        for name, counts in report["launches_per_rank"].items():
            per_rank.setdefault(name, {})[report["model"]] = counts
    for key in ("fp32_tp4", "int8_tp4"):
        for name, n in ranks[0][key]["launches"].items():
            per_rank.setdefault(name, {})[f"{S_DENSE_PRESET} {key}"] = [
                r[key]["launches"][name] for r in ranks]
    return per_rank


# ---------------------------------------------------------------------------
# t: sequence parallelism (sp > 1) across four GPUs
# ---------------------------------------------------------------------------

T_GPUS = 4
T_PRESET = "qwen3-8b"
T_MAX_SEQ = 32768
T1_ARGV = ["--preset", T_PRESET, "--mesh-plan", "sp4", "--max-seq-len",
           str(T_MAX_SEQ), "--max-slots", "4", "--host", "127.0.0.1",
           "--port", "0"]
# prompt tokens of the TTFT requests, by the bucket each fills
T_TTFT_TOKENS = {32768: 30000, 4096: 4000}
T_DECODE_STEPS = 8
# t2: the sequence-parallel runner at llama3-8b's widths, cut in depth,
# fp32 with TF32 off, against one card (the ring's blocks and the merges
# add the same terms in another order)
T2_PRESET = "llama3-8b"
T2_LAYERS = 4
T2_PLANS = ("sp4", "sp2xtp2")
T2_PROMPT = 2000           # the 2048 bucket
T2_CHUNKS = (1024, 776)    # a chunk, then a continuation into 2048
# t3: the ring alone at qwen3-8b's heads over 32768 tokens on sp4
T3_TOKENS = 32768
T3_HEADS = (32, 8, 128)
T_RANK_DEVICE = "cuda"


class _PlainAttention:
    """Both modes of the flash kernel swapped for their plain versions,
    over query-row chunks (the fp32 checks of t2, v2, x3 and y3: the
    kernel takes bf16 only; phase c and t3 hold the kernel itself)."""

    def __enter__(self):
        from gpustack_tpu_torch.engine import diagnostics
        from gpustack_tpu_torch.ops import flash_attention as fa

        self._fa = fa
        self._saved = (fa.flash_attention_prefill, fa.flash_attention_lse)
        fa.flash_attention_prefill = diagnostics.plain_prefill
        fa.flash_attention_lse = diagnostics.plain_lse
        return self

    def __exit__(self, *exc):
        (self._fa.flash_attention_prefill,
         self._fa.flash_attention_lse) = self._saved


def _sp_candidates(per_rank, plan, row):
    """Candidates for a one-card replay (``diagnostics.RoutingTape``) of
    a replica's recorded picks (``per_rank``: each rank's per-call picks,
    in rank order): per call, rank 0's (tokens whole on every rank: a
    decode step), its row ``row`` alone (one slot of a decode step, where
    the one-card batch is that slot), and the ``sp`` ranks' blocks side
    by side (a ring prefill), each from the rank at ``ep`` and ``tp``
    index 0 (``dp`` is 1 under ``sp``)."""
    group = plan.ep * plan.tp
    return [
        [mine, mine[row:row + 1],
         torch.cat([per_rank[j * group][i] for j in range(plan.sp)])]
        for i, mine in enumerate(per_rank[0])
    ]


def _t_served_logits(engine):
    """On the idle replica, from this thread (every op broadcast, so every
    rank runs it): a prefill of a 30000-token prompt through the ring, its
    greedy first token inserted into a free slot, then
    ``T_DECODE_STEPS`` decode steps, each step's logits read first
    (``probe("decode_logits")``); the slot is deactivated at the end. On
    an MoE model every rank records its expert picks meanwhile
    (``probe("routing_record")``). Returns (prompt ids, prefill logits,
    [step logits], [tokens fed], the one-card replay's candidate picks
    per MoE layer call or None)."""
    runner, state = engine.runner, engine._state
    ids = _s_ids(T_TTFT_TOKENS[T_MAX_SEQ], runner.cfg.vocab_size, 3)
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))
    slot = engine._free[0]
    moe = runner.cfg.is_moe
    with torch.no_grad():
        if moe:
            runner.probe(state, "routing_record")
        last, k, v = runner.prefill(padded, len(ids))
        fed = [int(last.argmax())]
        runner.insert(state, k, v, slot, len(ids), fed[0], 0.0, 0, 1.0)
        del k, v
        steps = []
        for step in range(T_DECODE_STEPS):
            steps.append(
                runner.probe(state, "decode_logits")[slot].float().cpu())
            state, out = runner.decode_step(state, 1000 + step)
            fed.append(int(out[0][slot]))
        runner.deactivate(state, slot)
        tape = None
        if moe:
            per_rank = [r["picks"] for r in runner.probe(state, "routing")]
            tape = _sp_candidates(per_rank, runner.plan, slot)
    return ids, last.float().cpu(), steps, fed[:-1], tape


def _t_one_card(params, cfg, ids, served_last, served_steps, fed,
                tape=None, label="sp4"):
    """The one-card reference over the whole tree (under ``sp`` alone the
    leader's): a one-slot engine on this card with the flash kernel and no
    ring. Its TTFT for each TTFT prompt; then the served prefill's logits
    and each decode step's (the served tokens fed) against it, each held
    to the standing logit gate. On an MoE model (``tape``: the served
    picks, :func:`_t_served_logits`) the reference replays the served
    picks, and a second run with free routing rides beside."""
    from gpustack_tpu_torch.engine import diagnostics
    from gpustack_tpu_torch.engine.engine import GenRequest, LLMEngine

    engine = LLMEngine(cfg, params, max_slots=1, max_seq_len=T_MAX_SEQ,
                       device=params["final_norm"].device)
    engine.start()
    try:
        ttft = {}
        for bucket, n in T_TTFT_TOKENS.items():
            prompt = _s_ids(n, cfg.vocab_size, 7 + bucket)
            engine.generate(GenRequest(prompt_ids=prompt, max_tokens=2,
                                       temperature=0.0), timeout=900)
            req = engine.generate(GenRequest(
                prompt_ids=prompt, max_tokens=2, temperature=0.0),
                timeout=900)
            ttft[f"one_card_ttft_ms_{bucket}_bucket"] = req.ttft_ms
    finally:
        engine.stop()
    runner = engine.runner
    padded = ids + [0] * (runner.bucket_for(len(ids)) - len(ids))

    def run():
        gates = []
        last, k, v = runner.prefill(padded, len(ids))
        gates.append(_compare_logits(served_last, last.float().cpu()))
        state = runner.new_state()
        runner.insert(state, k, v, 0, len(ids), fed[0], 0.0, 0, 1.0)
        del k, v
        for step, served in enumerate(served_steps):
            want = diagnostics.probe(runner, state, "decode_logits")[0]
            gates.append(_compare_logits(served, want.float().cpu()))
            state, _ = runner.decode_step(state, step)
            if step + 1 < len(fed):
                state.last_tokens[0] = fed[step + 1]
        return gates

    extra = {}
    with torch.no_grad():
        if tape is None:
            gates = run()
        else:
            with diagnostics.RoutingTape() as replay:
                replay.replay(tape)
                gates = run()
            free = run()
            extra = {
                "routing": "the served picks replayed (rank 0's, or the "
                "sp ranks' ring blocks side by side)",
                "flipped_tokens": sum(replay.flips),
                "free_routing": {"prefill": free[0],
                                 "decode_steps": free[1:]},
            }
    del engine, runner
    bad = [i for i, g in enumerate(gates)
           if g["max_abs_err"] > LOGIT_REL_TOL * g["logit_scale"]
           or g["cosine"] < LOGIT_MIN_COSINE]
    if bad:
        raise AssertionError(
            f"{label} logits part from one card at {bad} (0: the prefill, "
            f"i: decode step i): {[gates[i] for i in bad]}")
    return ttft, {
        "prefill": gates[0], "decode_steps": gates[1:],
        "prompt_tokens": len(ids), "tokens_fed": fed, **extra,
        "reference": "one card, the same tree, flash, no ring",
        "tolerance": {"rel": LOGIT_REL_TOL, "min_cosine": LOGIT_MIN_COSINE},
    }


def _t_served(kind, smi, argv=None, label="sp4", line="sp_served"):
    """t1. qwen3-8b whole (36 layers, bf16, random weights from a seed)
    under ``sp4`` through the port's server (``argv``: v1's model and
    plan), this process rank 0 and one follower process per other GPU:
    the served logits (a 30000-token prefill and ``T_DECODE_STEPS``
    decode steps; an MoE model's picks recorded on every rank); then,
    counted on every rank, one prompt at each TTFT bucket, a chat over
    HTTP and 4 chats decoding at once: rank ``r`` at ``sp`` index ``i``
    launches the flash kernel's LSE mode ``i + 1`` times a layer of each
    prefill and the causal mode never, and the grouped kernel as its
    share of the tokens needs; every follower's slot state equal to the
    leader's; peak memory per rank; the NCCL share of a 32768-bucket
    prefill on rank 0. After the replica is down, the one-card reference
    (:func:`_t_one_card`) over the whole tree: rank 0's under ``sp``
    alone, else drawn from the server's seed on this card."""
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
        shutdown_replica,
    )
    from gpustack_tpu_torch.engine.engine import GenRequest
    from gpustack_tpu_torch.parallel.mesh import rank_coords

    from gpustack_tpu_torch.engine.weights import load_or_init_params

    argv = T1_ARGV if argv is None else argv
    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(argv))
    runner, state = engine.runner, engine._state
    cfg, plan = runner.cfg, runner.plan
    world = plan.chips
    runner.probe(state, "memory")         # every rank is up
    setup_s = time.perf_counter() - t0
    engine.start()
    server = OpenAIServer(engine)
    port = server.start("127.0.0.1", 0)
    try:
        for n in (*T_TTFT_TOKENS.values(), 24):       # warm every bucket
            engine.generate(GenRequest(
                prompt_ids=_s_ids(n, cfg.vocab_size, n), max_tokens=2,
                temperature=0.0), timeout=900)
        ids, served_last, served_steps, fed, tape = _t_served_logits(
            engine)
        runner.probe(state, "reset_memory")
        calls = RunnerCalls(engine.runner, int8=False)
        runner.probe(state, "reset_launches")
        calls.reset()
        ttft = {}
        for bucket, n in T_TTFT_TOKENS.items():
            req = engine.generate(GenRequest(
                prompt_ids=_s_ids(n, cfg.vocab_size, 7 + bucket),
                max_tokens=2, temperature=0.0), timeout=900)
            ttft[f"ttft_ms_{bucket}_bucket"] = req.ttft_ms
        msgs = [{"role": "user", "content": "Say hello to 4 H100s."}]
        _, raw = _post(port, "/v1/chat/completions", {
            "messages": msgs, "max_tokens": 16, "temperature": 0})
        _check_usage(json.loads(raw),
                     len(engine.tokenizer.apply_chat_template(msgs)))
        rate, chats = _s_decode_rate(engine)
        launches = runner.probe(state, "launches")
        memory = runner.probe(state, "memory")
        states = runner.probe(state, "slot_state")
        window = calls.counts()
        if window["prefill"] != len(T_TTFT_TOKENS) + 1 + chats:
            raise AssertionError(f"{label}: runner calls {window}")
        per_rank_want = []
        for r in range(world):
            want = expected_launches([calls], rank_coords(plan, r)["sp"])
            per_rank_want.append(want["flash_lse"])
            got = {n: launches[n][r] for n in S_KERNELS}
            got["flash_lse"] = launches["flash_attention_prefill_lse"][r]
            got["flash_causal"] = launches[
                "flash_attention_prefill_causal"][r]
            if any(got[n] != want[n] for n in got):
                raise AssertionError(
                    f"{label} rank {r}: launches {got}, the leader's forwards "
                    f"need {({n: want[n] for n in got})}")
        for rank, st in enumerate(states[1:], start=1):
            if not torch.equal(st, states[0]):
                raise AssertionError(
                    f"{label}: rank {rank}'s slot state parted from the "
                    f"leader's: {st.tolist()} vs {states[0].tolist()}")
        health = engine.health()
        if health["status"] != "ok":
            raise AssertionError(f"{label}: engine unhealthy: {health}")
        prefill = _s_prefill_profile(engine, T_TTFT_TOKENS[T_MAX_SEQ])
        device = runner.device
        params = runner.params if plan.chips == plan.sp else None
    finally:
        server.shutdown()
        engine.stop()
        shutdown_replica(engine, timeout=120)
    # the replica's KV cache goes; rank 0's tree (whole under sp) stays
    del engine, server, runner, state, calls
    _free()
    if params is None:
        params = load_or_init_params(cfg, None, seed=0, device=device)
    one_ttft, gate = _t_one_card(params, cfg, ids, served_last,
                                 served_steps, fed, tape, label)
    report = {
        "model": cfg.name, "plan": str(plan), "layers": cfg.num_layers,
        "max_seq_len": T_MAX_SEQ, "device": kind, "nvidia_smi": smi,
        "setup_s": setup_s, "logit_check": gate, **ttft, **one_ttft,
        "decode_tokens_per_s_4_slots": rate,
        "decode_tokens_per_chat": S_DECODE_TOKENS,
        "flash_lse_launches_per_rank": launches[
            "flash_attention_prefill_lse"],
        "flash_lse_launches_want": per_rank_want,
        "launches_per_rank": launches, "runner_calls": window,
        "peak_mem_gb_per_rank": [m / 1e9 for m in memory],
        "followers_slot_state_equal": True, "layout": health["layout"],
        "prefill_32768_rank0": prefill,
    }
    emit(line, **report)
    return report


def _t_sp_case(mesh, device, preset, layers, prompt, chunks):
    """t2 on one plan: llama3-8b at ``T2_LAYERS`` layers in fp32 (TF32
    off; the plain versions of the flash modes) through the
    sequence-parallel runner on this rank against the one-card runner on
    the same tree: a ``T2_PROMPT``-token prefill, a prompt prefilled as a
    chunk and a continuation, both inserted, then ``T_DECODE_STEPS``
    decode steps (the one-card runner fed the sp runner's tokens). Every
    logit row within ``SHARD_REL_TOL`` of its scale."""
    from gpustack_tpu_torch.engine import diagnostics
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(preset), num_layers=layers,
                              dtype="float32")
    runners = [
        ModelRunner(cfg, load_or_init_params(cfg, None, seed=0,
                                             device=device, mesh=m),
                    device, max_slots=2, max_seq_len=4096, mesh=m)
        for m in (mesh, None)
    ]
    ids = _s_ids(prompt, cfg.vocab_size, 11)
    chunked = _s_ids(sum(chunks), cfg.vocab_size, 12)
    logits = []
    with torch.no_grad(), _PlainAttention():
        states = []
        for r in runners:
            got = []
            last, k, v = r.prefill(
                ids + [0] * (r.bucket_for(len(ids)) - len(ids)), len(ids))
            got.append(last)
            a, b = chunks
            _, kc, vc = r.prefill_chunk(chunked[:a], a)
            lc, kc, vc = r.prefill_continue_chunk(
                kc, vc, a, chunked[a:] + [0] * (r.bucket_for(b) - b), b,
                r.bucket_for(a + r.bucket_for(b)))
            got.append(lc)
            st = r.new_state()
            r.insert(st, k, v, 0, len(ids), int(last.argmax()), 0.0, 0, 1.0)
            r.insert(st, kc, vc, 1, len(chunked), int(lc.argmax()), 0.0, 0,
                     1.0)
            states.append(st)
            logits.append(got)
        parted = 0
        for step in range(T_DECODE_STEPS):
            for r, st, got in zip(runners, states, logits):
                got.extend(diagnostics.probe(r, st, "decode_logits"))
                r.decode_step(st, step)
            parted += int((states[0].last_tokens
                           != states[1].last_tokens).sum())
            states[1].last_tokens.copy_(states[0].last_tokens)
    cmps = [_compare_logits(g.float(), w.float())
            for g, w in zip(*logits)]
    worst = max(c["max_abs_err"] / c["logit_scale"] for c in cmps)
    del runners, states, logits
    return {"plan": str(mesh.plan), "model": cfg.name,
            "layers": cfg.num_layers, "weights": "fp32, TF32 off",
            "rows": len(cmps), "worst_rel_err": worst,
            "min_cosine": min(c["cosine"] for c in cmps),
            "decode_tokens_parted": parted,
            "tolerance": {"rel": SHARD_REL_TOL},
            "ok": worst <= SHARD_REL_TOL}


def _t_ring_case(mesh, device, tokens, heads):
    """t3: the ring alone at qwen3-8b's heads over ``T3_TOKENS`` tokens
    (bf16, this rank's block) against the one-card flash kernel over the
    whole sequence and the fp32 plain version of this rank's rows, each
    with the standing kernel gate; ms per ring call, the one-card call and
    one hop's send/recv of a K/V block."""
    from gpustack_tpu_torch.ops import flash_attention as fa
    from gpustack_tpu_torch.ops.ring_attention import ring_attention

    Hq, Hkv, d = heads
    T, sp, i = tokens, mesh.sp, mesh.sp_rank
    n = T // sp
    gen = torch.Generator(device=device).manual_seed(31)
    q, k, v = (torch.randn(1, T, h, d, generator=gen, device=device)
               .bfloat16() for h in (Hq, Hkv, Hkv))
    scale = d ** -0.5
    rows = slice(i * n, (i + 1) * n)
    ql, kl, vl = (t[:, rows].contiguous() for t in (q, k, v))
    with torch.no_grad():
        reset_launch_counts()
        out = ring_attention(ql, kl, vl, scale, mesh)
        _s_sync(device)
        launches = fa.flash_attention_prefill.launches_by_path["lse"]
        whole = fa.flash_attention_prefill(q, k, v, scale)[:, rows].float()
        ref = torch.cat([
            fa.flash_attention_prefill_ref(
                q[:, i * n + t:i * n + min(t + LSE_REF_ROWS, n)].float(),
                k[:, :(i + 1) * n].float(), v[:, :(i + 1) * n].float(),
                scale, i * n + t)
            for t in range(0, n, LSE_REF_ROWS)
        ], dim=1)
    gates = {}
    for name, want in (("plain_fp32", ref), ("one_card_flash", whole)):
        err = (out.float() - want).abs()
        bad = int((err > KERNEL_ATOL + KERNEL_RTOL * want.abs()).sum())
        shape = (1, n, Hq, d)
        row_rel = ((out.float().reshape(shape) - want.reshape(shape))
                   .norm(dim=-1) / want.reshape(shape).norm(dim=-1)
                   .clamp_min(1e-30)).max().item()
        gates[name] = {"max_abs_err": err.max().item(),
                       "outside_tolerance": bad, "max_row_rel_err": row_rel,
                       "ok": bad == 0 and row_rel <= KERNEL_ROW_RTOL
                       and bool(torch.isfinite(out).all())}
    del whole, ref, out
    report = {"rank": i, "tokens": T, "heads": heads, "block": n,
              "lse_launches": launches, "gates": gates,
              "tolerance": {"rtol": KERNEL_RTOL, "atol": KERNEL_ATOL,
                            "row_rtol": KERNEL_ROW_RTOL}}
    if device.type == "cuda":
        report["ring_ms"] = cuda_time_ms(
            lambda: ring_attention(ql, kl, vl, scale, mesh),
            warmup=2, iters=10)
        buf = torch.stack([kl, vl])
        spare = torch.empty_like(buf)

        def hop():
            for r in mesh.sp_p2p([(buf, i + 1)], [(spare, i - 1)]):
                r.wait()

        report["hop_ms"] = cuda_time_ms(hop, warmup=2, iters=10)
        report["hop_mbytes"] = buf.numel() * buf.element_size() / 1e6
        # one batch sends a block and receives one: MB per ms is GB/s
        report["hop_gb_per_s_each_way"] = (
            report["hop_mbytes"] / report["hop_ms"])
        report["one_card_flash_ms"] = cuda_time_ms(
            lambda: fa.flash_attention_prefill(q, k, v, scale),
            warmup=1, iters=5)
    # (the plain version a CPU rehearsal runs counts no launch)
    report["ok"] = all(g["ok"] for g in gates.values()) and (
        launches == i + 1 or device.type == "cpu")
    return report


def _t_rank(rank, world, coordinator, device_type, t2, t3):
    """One rank of t2 and t3, in a process of its own: on
    ``cuda:<rank>`` over NCCL (``device_type`` "cpu": gloo, for a
    rehearsal). ``t2``: (preset, layers, prompt tokens, chunks); ``t3``:
    (tokens, heads)."""
    from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    sp4 = init_mesh(MeshPlan(sp=world), rank, coordinator, device)
    out = {"rank": rank, "t2": []}
    for plan in T2_PLANS:
        mesh = sp4 if plan == "sp4" else Mesh(MeshPlan.parse(plan), rank)
        out["t2"].append(_t_sp_case(mesh, device, *t2))
        _s_free(device)
    out["t3"] = _t_ring_case(sp4, device, *t3)
    return out


def phase_sequence_parallel(kind, smi):
    """t1 (:func:`_t_served`), then t2 and t3 in one process per GPU
    (:func:`_t_rank`), every rank held to its gates. Returns the flash
    kernel's LSE launches per rank on the served path."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    if T_RANK_DEVICE == "cuda" and torch.cuda.device_count() < T_GPUS:
        raise AssertionError(f"phase t needs {T_GPUS} cards")
    served = _t_served(kind, smi)
    _free()
    ranks = run_ranks(
        _t_rank, T_GPUS, T_RANK_DEVICE,
        (T2_PRESET, T2_LAYERS, T2_PROMPT, T2_CHUNKS), (T3_TOKENS, T3_HEADS),
        timeout=S_RANK_TIMEOUT_S)
    for j, plan in enumerate(T2_PLANS):
        emit("sp_runner", device=kind, nvidia_smi=smi, **ranks[0]["t2"][j],
             per_rank_ok=[r["t2"][j]["ok"] for r in ranks],
             per_rank_worst_rel_err=[r["t2"][j]["worst_rel_err"]
                                     for r in ranks])
    emit("sp_ring", device=kind, nvidia_smi=smi,
         per_rank=[r["t3"] for r in ranks])
    bad = [(r["rank"], j) for r in ranks for j, c in enumerate(r["t2"])
           if not c["ok"]] + [(r["rank"], "t3") for r in ranks
                              if not r["t3"]["ok"]]
    if bad:
        raise AssertionError(f"phase t: failed (rank, check) {bad}")
    return {"flash_attention_prefill": {
        f"{T_PRESET} sp4 (lse)": served["flash_lse_launches_per_rank"]}}


# ---------------------------------------------------------------------------
# u: data parallelism (dp > 1) across four GPUs
# ---------------------------------------------------------------------------

U_GPUS = 4
U1_ARGV = ["--preset", "llama3-70b", "--mesh-plan", "dp2xtp2"] + MAIN_ARGV[2:]
U2_ARGV = ["--preset", "mixtral-8x7b", "--mesh-plan", "dp2xep2"] + MAIN_ARGV[2:]
# group 1's first slot at 8 slots under dp2: u1's and u2's logit gates
# run their prefills there (rank 0 receives the logits), which also opens
# the NCCL pair communicator group 1 sends rank 0 on before any request
# is timed (its first use takes about a second)
U_GROUP1_SLOT = 4
# u1's pair: one prompt in slot 0 (group 0) and in group 1's first slot
U_PAIR_TOKENS = 500
U_PAIR_STEPS = 8
U_PAIR_REL_TOL = 1e-2
# u3: llama3-8b's widths at 4 layers, fp32 with TF32 off, a request in
# every group's slots, against one card
U3_PRESET = "llama3-8b"
U3_LAYERS = 4
U3_PLANS = ("dp2xtp2", "dp4")
U3_PROMPTS = (1000, 600, 300, 1500)       # slots 0-3, every group's
U_RANK_DEVICE = "cuda"


def _u_slot_pair(engine):
    """u1's pair, on the idle replica from this thread: one prompt
    prefilled for slot 0 (group 0) and for group 1's first slot (its
    logits sent to rank 0), each inserted with its greedy first token,
    then ``U_PAIR_STEPS`` decode steps, each step's logits read first
    (``probe("decode_logits")``, every group's rows gathered). The two
    slots' greedy ids must be identical and their logits within
    ``U_PAIR_REL_TOL`` of the scale; whether they and the slots' K/V
    rows (``probe("kv_rows")``) are equal bit for bit is recorded."""
    runner, state = engine.runner, engine._state
    n = U_PAIR_TOKENS
    ids = _s_ids(n, runner.cfg.vocab_size, 21)
    padded = ids + [0] * (runner.bucket_for(n) - n)
    slots = (0, runner.rows)
    with torch.no_grad():
        lasts, ids_of = [], {s: [] for s in slots}
        for slot in slots:
            last, k, v = runner.prefill(padded, n, slot=slot)
            lasts.append(last.float().cpu())
            ids_of[slot].append(int(last.argmax()))
            runner.insert(state, k, v, slot, n, ids_of[slot][0], 0.0, 0,
                          1.0)
            del k, v
        steps = []
        for step in range(U_PAIR_STEPS):
            logits = runner.probe(state, "decode_logits")
            steps.append([logits[s].float().cpu() for s in slots])
            state, out = runner.decode_step(state, 2000 + step)
            for s in slots:
                ids_of[s].append(int(out[0][s]))
        kv = [runner.probe(state, "kv_rows", true_len=n, slot=s)
              for s in slots]
        for s in slots:
            runner.deactivate(state, s)
    cmps = [_compare_logits(b, a) for a, b in [lasts] + steps]
    worst = max(c["max_abs_err"] / c["logit_scale"] for c in cmps)
    report = {
        "slots": list(slots), "prompt_tokens": n,
        "greedy_ids_equal": ids_of[slots[0]] == ids_of[slots[1]],
        "worst_rel_err": worst,
        "min_cosine": min(c["cosine"] for c in cmps),
        "logits_bitwise_equal": all(torch.equal(a, b)
                                    for a, b in [lasts] + steps),
        "kv_rows_bitwise_equal": torch.equal(kv[0], kv[1]),
        "kv_rows_max_abs_diff": (kv[0] - kv[1]).abs().max().item(),
        "tolerance": {"rel": U_PAIR_REL_TOL},
    }
    if not report["greedy_ids_equal"] or worst > U_PAIR_REL_TOL:
        raise AssertionError(f"slots {slots} part: {report}, ids "
                             f"{ids_of}")
    return {"slot_pair": report}


def _u_dp_case(mesh, device, preset, layers, prompts):
    """u3 on one plan: ``preset`` at ``layers`` layers in fp32 (TF32 off,
    the flash kernel's plain version) through the data-parallel runner on
    this rank against the one-card runner on the same tree: prompt ``i``
    (``prompts[i]`` tokens) prefilled for slot ``i`` (on its group;
    rank 0 receives the logits of every group's), inserted with the
    one-card greedy first token (rank 0's, broadcast), then
    ``T_DECODE_STEPS`` decode steps (the one-card runner fed the dp
    runner's tokens). Every logit row this rank holds within
    ``SHARD_REL_TOL`` of its scale."""
    from gpustack_tpu_torch.engine import diagnostics
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(preset), num_layers=layers,
                              dtype="float32")
    dp, one = (
        ModelRunner(cfg, load_or_init_params(cfg, None, seed=0,
                                             device=device, mesh=m),
                    device, max_slots=len(prompts), max_seq_len=4096,
                    mesh=m)
        for m in (mesh, None)
    )
    cmps, ran = [], []
    with torch.no_grad(), _PlainAttention():
        states = dp.new_state(), one.new_state()
        for slot, n in enumerate(prompts):
            ids = _s_ids(n, cfg.vocab_size, 40 + slot)
            padded = ids + [0] * (one.bucket_for(n) - n)
            ref, rk, rv = one.prefill(padded, n)
            got, k, v = dp.prefill(padded, n, slot=slot)
            ran.append(k is not None)
            first = torch.tensor([int(ref.argmax())], device=device)
            mesh.broadcast_(first)
            one.insert(states[1], rk, rv, slot, n, int(first), 0.0, 0, 1.0)
            dp.insert(states[0], k, v, slot, n, int(first), 0.0, 0, 1.0)
            if got is not None:
                cmps.append(_compare_logits(got.float(), ref.float()))
            del rk, rv, k, v
        parted = 0
        for step in range(T_DECODE_STEPS):
            got = diagnostics.probe(dp, states[0], "decode_logits")
            want = diagnostics.probe(one, states[1], "decode_logits")
            cmps += [_compare_logits(g.float(), w.float())
                     for g, w in zip(got, want)]
            dp.decode_step(states[0], step)
            one.decode_step(states[1], step)
            parted += int((states[0].last_tokens
                           != states[1].last_tokens).sum())
            states[1].last_tokens.copy_(states[0].last_tokens)
    worst = max(c["max_abs_err"] / c["logit_scale"] for c in cmps)
    del dp, one, states
    return {"plan": str(mesh.plan), "model": cfg.name,
            "layers": cfg.num_layers, "weights": "fp32, TF32 off",
            "prompts": list(prompts), "prefills_run": ran,
            "rows": len(cmps), "worst_rel_err": worst,
            "min_cosine": min(c["cosine"] for c in cmps),
            "decode_tokens_parted": parted,
            "tolerance": {"rel": SHARD_REL_TOL},
            "ok": worst <= SHARD_REL_TOL}


def _u_rank(rank, world, coordinator, device_type, u3):
    """One rank of u3, in a process of its own: on ``cuda:<rank>`` over
    NCCL (``device_type`` "cpu": gloo, for a rehearsal). ``u3``: (preset,
    layers, prompt lengths)."""
    from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    first = init_mesh(MeshPlan.parse(U3_PLANS[0]), rank, coordinator, device)
    out = {"rank": rank, "u3": []}
    for plan in U3_PLANS:
        mesh = first if plan == U3_PLANS[0] else Mesh(MeshPlan.parse(plan),
                                                      rank)
        out["u3"].append(_u_dp_case(mesh, device, *u3))
        _s_free(device)
    return out


def phase_data_parallel(kind, smi):
    """u1. llama3-70b, bf16, 80 layers, ``dp2xtp2`` through the server
    (``_s_served`` with u1's slot pair); u2. mixtral-8x7b, bf16,
    ``dp2xep2`` through the server (its logit gate with the served picks
    replayed, free routing beside); both logit gates on group 1's
    prefills;
    then u3 in one process per GPU (:func:`_u_rank`), every rank held to
    its gates. Returns each kernel's launches per rank on the served
    paths."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    if U_RANK_DEVICE == "cuda" and torch.cuda.device_count() < U_GPUS:
        raise AssertionError(f"phase u needs {U_GPUS} cards")
    dense = _s_served(U1_ARGV, "dp2xtp2", kind, smi,
                      gate_slot=U_GROUP1_SLOT, checks=(_u_slot_pair,))
    _free()
    moe = _s_served(U2_ARGV, "dp2xep2", kind, smi, gate_slot=U_GROUP1_SLOT,
                    replay=True)
    _free()
    ranks = run_ranks(_u_rank, U_GPUS, U_RANK_DEVICE,
                      (U3_PRESET, U3_LAYERS, U3_PROMPTS),
                      timeout=S_RANK_TIMEOUT_S)
    for j, plan in enumerate(U3_PLANS):
        emit("dp_runner", device=kind, nvidia_smi=smi, **ranks[0]["u3"][j],
             per_rank_ok=[r["u3"][j]["ok"] for r in ranks],
             per_rank_worst_rel_err=[r["u3"][j]["worst_rel_err"]
                                     for r in ranks],
             per_rank_prefills_run=[r["u3"][j]["prefills_run"]
                                    for r in ranks])
    bad = [(r["rank"], U3_PLANS[j]) for r in ranks
           for j, c in enumerate(r["u3"]) if not c["ok"]]
    if bad:
        raise AssertionError(f"phase u: failed (rank, plan) {bad}")
    per_rank = {}
    for report in (dense, moe):
        for name, counts in report["launches_per_rank"].items():
            per_rank.setdefault(name, {})[
                f"{report['model']} {report['plan']}"] = counts
    return per_rank


# ---------------------------------------------------------------------------
# v: sequence parallelism beside expert parallelism (sp2xep2), four GPUs
# ---------------------------------------------------------------------------

V_GPUS = 4
V_PRESET = "qwen3-30b-a3b"
V1_ARGV = ["--preset", V_PRESET, "--mesh-plan", "sp2xep2", "--max-seq-len",
           str(T_MAX_SEQ), "--max-slots", "4", "--host", "127.0.0.1",
           "--port", "0"]
# v2: qwen3-30b-a3b's widths at 4 layers, fp32 (TF32 off, the plain
# versions of the flash modes and of the grouped product), sp2xep2
# against one card, through a chunked prefill and decode steps, the
# one-card picks replayed
V2_PRESET = "qwen3-30b-a3b"
V2_LAYERS = 4
V2_PLAN = "sp2xep2"
V2_PROMPT = 2000
V2_CHUNKS = (1024, 776)


def _v_sp_ep_case(mesh, device, preset, layers, prompt, chunks):
    """v2: ``preset`` at ``layers`` layers in fp32 through the runner
    under ``sp2xep2`` on this rank against the one-card runner on the
    same tree, as t2 (a ``prompt``-token ring prefill; a chunk and a
    continuation; both inserted; ``T_DECODE_STEPS`` decode steps, the
    one-card runner fed the sharded runner's tokens). Each one-card
    forward records its expert picks and the sharded forward after it
    replays them (:class:`diagnostics.RoutingTape`; a ring block replays
    its rows of the one-card call's), so a near-tie pick cannot flip
    between the two; the flips are counted. Every logit row within
    ``SHARD_REL_TOL`` of its scale."""
    from gpustack_tpu_torch.engine import diagnostics
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(preset), num_layers=layers,
                              dtype="float32")
    sharded, one = (
        ModelRunner(cfg, load_or_init_params(cfg, None, seed=0,
                                             device=device, mesh=m),
                    device, max_slots=2, max_seq_len=4096, mesh=m)
        for m in (mesh, None)
    )
    sp, i = mesh.sp, mesh.sp_rank
    tape = diagnostics.RoutingTape()
    flips = []

    def pair(fn_one, fn_sharded):
        """One forward on one card (recorded), then the same on the
        mesh (replaying it): both results."""
        tape.mode, tape.calls = "record", []
        want = fn_one()
        cands = []
        for p in tape.picks():
            n = p.shape[0] // sp
            cands.append([p, p[i * n:(i + 1) * n]])
        tape.replay(cands)
        got = fn_sharded()
        flips.append(sum(tape.flips))
        return got, want

    ids = _s_ids(prompt, cfg.vocab_size, 13)
    chunked = _s_ids(sum(chunks), cfg.vocab_size, 14)
    a, b = chunks
    cmps = []
    with torch.no_grad(), _PlainAttention(), _PlainGrouped(), tape:
        states = sharded.new_state(), one.new_state()
        padded = ids + [0] * (one.bucket_for(prompt) - prompt)
        got, want = pair(lambda: one.prefill(padded, prompt),
                         lambda: sharded.prefill(padded, prompt))
        cmps.append(_compare_logits(got[0].float(), want[0].float()))
        first = int(want[0].argmax())
        sharded.insert(states[0], got[1], got[2], 0, prompt, first, 0.0,
                       0, 1.0)
        one.insert(states[1], want[1], want[2], 0, prompt, first, 0.0, 0,
                   1.0)
        del got, want
        got, want = pair(lambda: one.prefill_chunk(chunked[:a], a),
                         lambda: sharded.prefill_chunk(chunked[:a], a))
        rest = chunked[a:] + [0] * (one.bucket_for(b) - b)
        total = one.bucket_for(a + one.bucket_for(b))
        got, want = pair(
            lambda: one.prefill_continue_chunk(want[1], want[2], a, rest, b,
                                               total),
            lambda: sharded.prefill_continue_chunk(got[1], got[2], a, rest,
                                                   b, total))
        cmps.append(_compare_logits(got[0].float(), want[0].float()))
        first = int(want[0].argmax())
        sharded.insert(states[0], got[1], got[2], 1, a + b, first, 0.0, 0,
                       1.0)
        one.insert(states[1], want[1], want[2], 1, a + b, first, 0.0, 0,
                   1.0)
        del got, want
        parted = 0
        for step in range(T_DECODE_STEPS):
            got, want = pair(
                lambda: diagnostics.probe(one, states[1], "decode_logits"),
                lambda: diagnostics.probe(sharded, states[0],
                                          "decode_logits"))
            cmps += [_compare_logits(g.float(), w.float())
                     for g, w in zip(got, want)]
            pair(lambda: one.decode_step(states[1], step),
                 lambda: sharded.decode_step(states[0], step))
            parted += int((states[0].last_tokens
                           != states[1].last_tokens).sum())
            states[1].last_tokens.copy_(states[0].last_tokens)
    worst = max(c["max_abs_err"] / c["logit_scale"] for c in cmps)
    del sharded, one, states
    return {"plan": str(mesh.plan), "model": cfg.name,
            "layers": cfg.num_layers, "weights": "fp32, TF32 off",
            "rows": len(cmps), "worst_rel_err": worst,
            "min_cosine": min(c["cosine"] for c in cmps),
            "decode_tokens_parted": parted,
            "flipped_tokens_per_forward": flips,
            "tolerance": {"rel": SHARD_REL_TOL},
            "ok": worst <= SHARD_REL_TOL}


def _v_rank(rank, world, coordinator, device_type, v2):
    """One rank of v2, in a process of its own: on ``cuda:<rank>`` over
    NCCL (``device_type`` "cpu": gloo, for a rehearsal). ``v2``: (preset,
    layers, prompt tokens, chunks)."""
    from gpustack_tpu_torch.parallel.mesh import MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    mesh = init_mesh(MeshPlan.parse(V2_PLAN), rank, coordinator, device)
    return {"rank": rank, "v2": _v_sp_ep_case(mesh, device, *v2)}


def phase_sp_ep(kind, smi):
    """v1. qwen3-30b-a3b whole (48 layers, bf16) under ``sp2xep2`` at
    32768 tokens through the server (:func:`_t_served`: the served
    logits against the one-card tree with the served picks replayed,
    free routing beside; TTFT at 32768 and 4096 beside one card's at one
    slot; every rank's LSE and grouped launches); then v2 in one process
    per GPU (:func:`_v_rank`), every rank held to its gates. Returns the
    flash kernel's LSE launches and the grouped kernel's per rank on
    v1's served path."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    if U_RANK_DEVICE == "cuda" and torch.cuda.device_count() < V_GPUS:
        raise AssertionError(f"phase v needs {V_GPUS} cards")
    served = _t_served(kind, smi, V1_ARGV, "sp2xep2", "sp_ep_served")
    _free()
    ranks = run_ranks(_v_rank, V_GPUS, U_RANK_DEVICE,
                      (V2_PRESET, V2_LAYERS, V2_PROMPT, V2_CHUNKS),
                      timeout=S_RANK_TIMEOUT_S)
    emit("sp_ep_runner", device=kind, nvidia_smi=smi, **ranks[0]["v2"],
         per_rank_ok=[r["v2"]["ok"] for r in ranks],
         per_rank_worst_rel_err=[r["v2"]["worst_rel_err"] for r in ranks],
         per_rank_flips=[r["v2"]["flipped_tokens_per_forward"]
                         for r in ranks])
    bad = [r["rank"] for r in ranks if not r["v2"]["ok"]]
    if bad:
        raise AssertionError(f"phase v: v2 failed on ranks {bad}")
    launches = served["launches_per_rank"]
    key = f"{served['model']} {served['plan']}"
    return {"flash_attention_prefill": {
                f"{key} (lse)": launches["flash_attention_prefill_lse"]},
            "bf16_grouped": {key: launches["bf16_grouped"]}}


# ---------------------------------------------------------------------------
# w: the host KV tier and speculation on a multi-GPU replica, four GPUs
# ---------------------------------------------------------------------------

W_GPUS = 4
W_TIER = ["--host-kv-cache-mb", "4096", "--prefill-chunk", "512"]
W_70B = ["--preset", "llama3-70b", "--mesh-plan", "tp4"] + MAIN_ARGV[2:]
# w1: the bf16 tier over a disk spill; its RAM budget drops to
# W_SPILL_BYTES for the spill run. The same replica serves w2's plain ids.
W1_ARGV = W_70B + W_TIER + ["--kv-spill-mb", "2048"]
# w1's int8 tier, with w2's n-gram speculation on the same replica
W1_INT8_ARGV = W_70B + W_TIER + ["--kv-cache-int8", "--speculative",
                                 "ngram"]
# w2: a llama3-8b draft on rank 0's card
W2_DRAFT_ARGV = W_70B + ["--speculative", "draft", "--draft-source",
                         "llama3-8b"]
# w3: mixtral-8x7b dp2xep2 with the tier and n-gram speculation
W3_ARGV = (["--preset", "mixtral-8x7b", "--mesh-plan", "dp2xep2"]
           + MAIN_ARGV[2:] + W_TIER + ["--speculative", "ngram"])
# the chat: a first turn, then two turns each adding new tokens after the
# reply (each hits the one before); a prompt sharing the first turn's
# blocks, chunked from the hit (two continuations); a one-shot prompt and
# its extension (a one-shot hit)
W_TURNS = (1024, 300, 300)
W_REPLY = 8
W_CHUNKED = 900
W_SHORT = (300, 100)
W_SPILL_BYTES = 512 << 20
# conversations that push the cold prompt's blocks out of RAM to disk
W_FILL = (4, 1792)
W_GROUP1_SLOT = 4
W_PAIR_TOKENS = (1280, 300)


class ChunkedCalls(RunnerCalls):
    """:class:`RunnerCalls` that also counts a replica leader's chunk ops,
    each one forward: a chunk from zero as a prefill, a continuation as a
    prefix prefill (the leader's chunk ops call its own runner, so
    nothing is counted twice)."""

    CHUNK_OPS = {"prefill_chunk": "prefill",
                 "prefill_continue_chunk": "prefill_with_prefix"}

    def __init__(self, runner, int8):
        super().__init__(runner, int8)
        for name, as_name in self.CHUNK_OPS.items():
            fn = getattr(runner, name)

            def counted(*args, _fn=fn, _as=as_name, **kw):
                self.forwards.append((_as, *self._shape(_as, args),
                                      kw.get("slot")))
                return _fn(*args, **kw)

            setattr(runner, name, counted)


def _w_drain(engine):
    engine._kv_copy_pool.submit(lambda: None).result(timeout=600)


def _w_block_bytes(engine):
    """One block's bytes on a rank (its KV heads, under ``sp`` its stripe
    of the tokens; an int8 block's scales whole), in the tier's type."""
    L, _, _, H, hd = engine.runner._cache(1).k.shape
    cache = engine.host_kv_cache
    n = L * cache.block_rows * H * hd
    return 2 * (n + L * H * 4) if cache.int8 else 2 * 2 * n


def _w_tier(engine, label):
    """Every rank's tier (``probe("kv_tier")``) holds the leader's keys at
    the leader's bytes, and the same spilled keys; a block is
    :func:`_w_block_bytes`."""
    import hashlib

    tiers = engine.runner.probe(engine._state, "kv_tier")
    lead = engine.host_kv_cache
    digest = hashlib.sha256("".join(lead.keys()).encode()).hexdigest()
    for rank, t in enumerate(tiers):
        if (t["keys_digest"], t["entries"], t["bytes"], t["spill_digest"]) \
                != (digest, lead.entries, lead.bytes_used,
                    tiers[0]["spill_digest"]):
            raise AssertionError(
                f"{label}: rank {rank}'s tier {t} parted from the leader's "
                f"({lead.entries} blocks, {lead.bytes_used} B)")
    if lead.bytes_used != lead.entries * _w_block_bytes(engine):
        raise AssertionError(f"{label}: {lead.bytes_used} B for "
                             f"{lead.entries} blocks")
    return {"blocks": lead.entries, "bytes_per_rank": lead.bytes_used,
            "block_bytes_per_rank": _w_block_bytes(engine),
            "spilled_blocks_per_rank": tiers[0]["spill_entries"],
            "ranks": len(tiers), "ranks_hold_the_leaders_keys": True}


def _w_serve(engine, stored, name, prompt, n=W_REPLY):
    """One request; its reused tokens must be what the stored sequences
    give (:func:`_expected_match`). Records what the request stored."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    want = _expected_match(prompt, stored)
    req = engine.generate(GenRequest(prompt_ids=prompt, max_tokens=n,
                                     temperature=0.0, stop_ids=()),
                          timeout=600)
    _w_drain(engine)
    if req.prefix_tokens_reused != want:
        raise AssertionError(f"{name}: reused {req.prefix_tokens_reused} "
                             f"tokens, the stored blocks give {want}")
    stored.append(list(prompt))
    seq = list(prompt) + req.output_ids[:-1]
    if len(seq) // BLOCK > len(prompt) // BLOCK:
        stored.append(seq)
    return req, {"request": name, "prompt_tokens": len(prompt),
                 "reused_tokens": want, "ttft_ms": req.ttft_ms}


def _w_chat(engine, stored):
    """The three-turn chat, the chunked prompt seeded from the first
    turn's blocks, the one-shot hit, and a cold prompt as long as the
    third turn. Returns (rows, the third turn's prompt, the cold one)."""
    vocab = engine.cfg.vocab_size
    rows = []
    prompt = _s_ids(W_TURNS[0], vocab, 61)
    turns = []
    for t, extra in enumerate(W_TURNS):
        if t:
            prompt = prompt + turns[-1].output_ids + _s_ids(extra, vocab,
                                                           61 + t)
        req, row = _w_serve(engine, stored, f"turn {t + 1}", prompt)
        turns.append(req)
        rows.append(row)
    third = prompt
    first = _s_ids(W_TURNS[0], vocab, 61)
    rows.append(_w_serve(engine, stored, "chunked from a hit",
                         first + _s_ids(W_CHUNKED, vocab, 71))[1])
    short = _s_ids(W_SHORT[0], vocab, 72)
    rows.append(_w_serve(engine, stored, "one-shot", short)[1])
    rows.append(_w_serve(engine, stored, "one-shot hit",
                         short + _s_ids(W_SHORT[1], vocab, 73))[1])
    cold = _s_ids(len(third), vocab, 74)
    rows.append(_w_serve(engine, stored, "cold, the third turn's length",
                         cold)[1])
    for r in (rows[1], rows[2], rows[3], rows[5]):
        if r["reused_tokens"] <= 0:
            raise AssertionError(f"no hit: {r}")
    return rows, third, cold


def _w_hit(engine, prompt, slot):
    """A hit on ``prompt``'s stored blocks through the engine's own
    gather, adoption and prefix prefill, from this thread on the idle
    replica: the last position's logits (rank 0)."""
    import types

    from gpustack_tpu_torch.engine.engine import GenRequest

    runner, cache = engine.runner, engine.host_kv_cache
    top = runner.prefill_buckets[-1]
    plen = cache.match_prefix_len(prompt)
    while plen and plen + runner.bucket_for(len(prompt) - plen) > top:
        plen -= BLOCK
    got = engine._gather_and_upload(GenRequest(prompt_ids=prompt), prompt,
                                    plen, cache, slot)
    job = types.SimpleNamespace()
    engine._adopt_prefix(job, got, slot)
    suffix = prompt[plen:]
    sb = runner.bucket_for(len(suffix))
    with torch.no_grad():
        last, _, _ = runner.prefill_with_prefix(
            job.k, job.v, plen, suffix + [0] * (sb - len(suffix)),
            len(suffix), runner.bucket_for(plen + sb), slot=slot,
            prefix_block=job.prefix_block)
    return last.float().cpu(), plen


def _w_warm_cold(engine, prompt):
    """The standing logit gate on a hit: the warm first-token logits
    against a cold prefill of the whole prompt on the same replica (both
    through the flash kernel), and their greedy tokens (equal, or a near
    tie of the cold logits)."""
    runner = engine.runner
    warm, plen = _w_hit(engine, prompt, 0)
    bucket = runner.bucket_for(len(prompt))
    with torch.no_grad():
        cold, _, _ = runner.prefill(prompt + [0] * (bucket - len(prompt)),
                                    len(prompt), slot=0)
    cold = cold.float().cpu()
    gate = _compare_logits(warm, cold)
    top2 = cold.topk(2).values
    gap = float(top2[0] - top2[1])
    ids_equal = int(warm.argmax()) == int(cold.argmax())
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
        gate["cosine"] < LOGIT_MIN_COSINE
    ) or not (ids_equal or gap < IDS_GAP_REL * gate["logit_scale"]):
        raise AssertionError(f"warm logits part from cold: {gate}, ids "
                             f"equal {ids_equal}, top-2 gap {gap}")
    return {**gate, "prefix_tokens": plen, "prompt_tokens": len(prompt),
            "greedy_ids_equal": ids_equal, "cold_top2_gap": gap,
            "tolerance": {"rel": LOGIT_REL_TOL,
                          "min_cosine": LOGIT_MIN_COSINE}}


def _w_launches(engine, label, calls, launches):
    """Every rank's launches equal what the leader's forwards need on that
    rank (:func:`expected_launches`)."""
    from gpustack_tpu_torch.parallel.mesh import rank_coords

    plan = engine.runner.plan
    for r in range(plan.chips):
        c = rank_coords(plan, r)
        want = expected_launches([calls], c["sp"], c["dp"])
        for name in S_KERNELS:
            if launches[name][r] != want[name]:
                raise AssertionError(
                    f"{label}: {name} launched {launches[name]} per rank, "
                    f"the leader's forwards need {want[name]} on rank {r}")
    return {n: launches[n] for n in S_KERNELS}


def _w_counted(engine, label, body):
    """``body()`` with every rank's launches counted and checked."""
    runner, state = engine.runner, engine._state
    calls = ChunkedCalls(runner, int8=False)
    runner.probe(state, "reset_launches")
    calls.reset()
    out = body()
    launches = _w_launches(engine, label, calls,
                           runner.probe(state, "launches"))
    return out, launches, calls.counts()


def _w_replica(argv):
    from gpustack_tpu_torch.engine.api_server import (
        OpenAIServer,
        build_engine_from_args,
        build_parser,
    )

    t0 = time.perf_counter()
    engine = build_engine_from_args(build_parser().parse_args(argv))
    engine.runner.probe(engine._state, "memory")       # every rank is up
    setup_s = time.perf_counter() - t0
    engine.start()
    server = OpenAIServer(engine)
    return engine, server, server.start("127.0.0.1", 0), setup_s


def _w_close(engine, server):
    from gpustack_tpu_torch.engine.api_server import shutdown_replica

    server.shutdown()
    engine.stop()
    shutdown_replica(engine, timeout=120)
    _free()


def _w_spec(engine, port, label, plain, scale):
    """w2 on a speculative replica: the greedy chats (ids held to the plain
    replica's by phase f's rule), every rank's verify steps and accepted
    proposals equal, decode tokens/s and rank 0's peak memory."""
    state = engine._state
    engine.runner.probe(state, "reset_memory")
    before = engine.runner.probe(state, "spec")
    out, rate = _greedy(engine, port, logprobs=False)
    rule = _ids_rule(plain[0], out, IDS_GAP_REL * scale)
    spec = engine.runner.probe(state, "spec")
    steps = [s[0] - b[0] for s, b in zip(spec, before)]
    accepted = [s[1] - b[1] for s, b in zip(spec, before)]
    if len(set(steps)) != 1 or len(set(accepted)) != 1 or steps[0] < 1:
        raise AssertionError(f"{label}: verify steps {steps}, accepted "
                             f"{accepted} per rank")
    health = engine.health()
    return {"ids_rule": rule, "verify_steps_per_rank": steps,
            "accepted_per_rank": accepted,
            "spec_steps": health["spec_steps"],
            "spec_extra_tokens": health["spec_extra_tokens"],
            "spec_acceptance_rate": health["spec_acceptance_rate"],
            "draft_model": health["draft_model"],
            "decode_tokens_per_s_8_chats": {"plain": plain[1],
                                            "speculative": rate},
            "peak_mem_gb_per_rank": [m / 1e9 for m in engine.runner.probe(
                state, "memory")]}


def _w1(kind, smi):
    """w1 on the bf16 tier: the chat, counted (flash exact per rank; hits
    as stored), every rank's tier, warm against cold; the plain chats for
    w2; then the spill run under W_SPILL_BYTES. Returns (report, the plain
    chats, the logit scale)."""
    engine, server, port, setup_s = _w_replica(W1_ARGV)
    try:
        stored = []
        _w_serve(engine, stored, "warm-up", _s_ids(600, engine.cfg.vocab_size,
                                                   60))
        (rows, third, _), launches, calls = _w_counted(
            engine, "w1 bf16", lambda: _w_chat(engine, stored))
        tier = _w_tier(engine, "w1 bf16")
        warm_cold = _w_warm_cold(engine, third)
        plain = _greedy(engine, port, logprobs=True)
        # the spill run: the leader's budget alone decides evictions
        cache = engine.host_kv_cache
        cache.max_bytes = W_SPILL_BYTES
        before = engine.health()
        vocab = engine.cfg.vocab_size
        for i in range(W_FILL[0]):
            _w_serve(engine, stored, f"fill {i}",
                     _s_ids(W_FILL[1], vocab, 80 + i), n=1)
        cold = _s_ids(len(third), vocab, 74)
        _, hit = _w_serve(engine, stored, "from disk",
                          cold[:W_TURNS[0]] + _s_ids(60, vocab, 90))
        after = engine.health()
        spill = {
            "ram_budget_bytes": W_SPILL_BYTES, "hit": hit,
            "faultbacks": after["kv_faultbacks"] - before["kv_faultbacks"],
            "blocks_spilled": after["kv_spill"]["blocks_spilled"],
            "tier": _w_tier(engine, "w1 spill"),
        }
        if spill["faultbacks"] < 1 or hit["reused_tokens"] < BLOCK:
            raise AssertionError(f"w1 spill: nothing came back: {spill}")
        if engine.health()["status"] != "ok":
            raise AssertionError(f"w1: {engine.health()}")
        report = {"model": engine.cfg.name, "plan": str(engine.runner.plan),
                  "tier": "bf16", "device": kind, "nvidia_smi": smi,
                  "setup_s": setup_s, "requests": rows,
                  "warm_ttft_ms": rows[2]["ttft_ms"],
                  "cold_ttft_ms": rows[-1]["ttft_ms"],
                  "tier_check": tier, "warm_vs_cold": warm_cold,
                  "launches_per_rank": launches, "runner_calls": calls,
                  "spill": spill}
        emit("multi_gpu_kv_tier", **report)
        return report, plain, warm_cold["logit_scale"]
    finally:
        _w_close(engine, server)


def _w1_int8(kind, smi, plain, scale):
    """w1 on the int8 tier, and w2's n-gram speculation on the same
    replica."""
    engine, server, port, setup_s = _w_replica(W1_INT8_ARGV)
    try:
        stored = []
        _w_serve(engine, stored, "warm-up", _s_ids(600, engine.cfg.vocab_size,
                                                   60))
        (rows, third, _), launches, calls = _w_counted(
            engine, "w1 int8", lambda: _w_chat(engine, stored))
        report = {"model": engine.cfg.name, "plan": str(engine.runner.plan),
                  "tier": "int8", "device": kind, "nvidia_smi": smi,
                  "setup_s": setup_s, "requests": rows,
                  "warm_ttft_ms": rows[2]["ttft_ms"],
                  "cold_ttft_ms": rows[-1]["ttft_ms"],
                  "tier_check": _w_tier(engine, "w1 int8"),
                  "warm_vs_cold": _w_warm_cold(engine, third),
                  "launches_per_rank": launches, "runner_calls": calls,
                  "speculation": _w_spec(engine, port, "w2 ngram", plain,
                                         scale)}
        if report["speculation"]["spec_extra_tokens"] < 1:
            raise AssertionError(f"w2 n-gram accepted nothing: {report}")
        emit("multi_gpu_kv_tier_int8", **report)
        return report
    finally:
        _w_close(engine, server)


def _w2_draft(kind, smi, plain, scale):
    engine, server, port, setup_s = _w_replica(W2_DRAFT_ARGV)
    try:
        report = {"model": engine.cfg.name, "plan": str(engine.runner.plan),
                  "device": kind, "nvidia_smi": smi, "setup_s": setup_s,
                  **_w_spec(engine, port, "w2 draft", plain, scale)}
        emit("multi_gpu_speculation_draft", **report)
        return report
    finally:
        _w_close(engine, server)


def _w3(kind, smi):
    """w3: a prefix stored from slot 0 (group 0), hit for slot 0 and for
    group 1's first slot (bitwise equal logits); then the chat and the
    n-gram chats counted (the grouped kernel exact per rank)."""
    engine, server, port, setup_s = _w_replica(W3_ARGV)
    try:
        runner = engine.runner
        vocab = engine.cfg.vocab_size
        n, extra = W_PAIR_TOKENS
        prefix = _s_ids(n, vocab, 95)
        with torch.no_grad():
            _, k, v = runner.prefill(
                prefix + [0] * (runner.bucket_for(n) - n), n, slot=0)
        engine._submit_kv_copy(prefix, k, v, n, 0)
        del k, v
        _w_drain(engine)
        prompt = prefix + _s_ids(extra, vocab, 96)
        lasts = [_w_hit(engine, prompt, s)[0] for s in (0, W_GROUP1_SLOT)]
        pair = {"slots": [0, W_GROUP1_SLOT], "prefix_tokens": n,
                "logits_bitwise_equal": torch.equal(*lasts),
                "max_abs_diff": (lasts[0] - lasts[1]).abs().max().item()}
        if not pair["logits_bitwise_equal"]:
            raise AssertionError(f"w3: the two groups' hits part: {pair}")

        def body():
            stored = [prefix, prompt]
            rows = _w_chat(engine, stored)[0]
            return rows, _greedy(engine, port, logprobs=False)

        (rows, (_, rate)), launches, calls = _w_counted(engine, "w3", body)
        spec = engine.runner.probe(engine._state, "spec")
        if len({tuple(s) for s in spec}) != 1:
            raise AssertionError(f"w3: verify steps per rank {spec}")
        report = {"model": engine.cfg.name, "plan": str(runner.plan),
                  "device": kind, "nvidia_smi": smi, "setup_s": setup_s,
                  "cross_group_hit": pair, "requests": rows,
                  "tier_check": _w_tier(engine, "w3"),
                  "spec_per_rank": spec,
                  "decode_tokens_per_s_8_chats": rate,
                  "launches_per_rank": launches, "runner_calls": calls}
        emit("multi_gpu_kv_tier_dp", **report)
        return report
    finally:
        _w_close(engine, server)


def phase_tier_spec(kind, smi):
    """w1–w3 (four GPUs, one replica at a time through the port's server).
    Returns each kernel's launches per rank on the counted windows."""
    if torch.cuda.device_count() < W_GPUS:
        raise AssertionError(f"phase w needs {W_GPUS} cards")
    # each replica's tree is freed before the next is drawn: the counting
    # wrappers' closures keep a runner in a cycle until a collection
    w1, plain, scale = _w1(kind, smi)
    _free()
    w1_int8 = _w1_int8(kind, smi, plain, scale)
    _free()
    _w2_draft(kind, smi, plain, scale)
    _free()
    w3 = _w3(kind, smi)
    _free()
    out = {}
    for report, tag in ((w1, "bf16 tier"), (w1_int8, "int8 tier"),
                        (w3, "tier")):
        for name, counts in report["launches_per_rank"].items():
            out.setdefault(name, {})[
                f"{report['model']} {report['plan']} {tag}"] = counts
    return out


# ---------------------------------------------------------------------------
# x: disaggregated prefill/decode and embeddings on multi-GPU replicas
# ---------------------------------------------------------------------------

X_GPUS = 4
X_TIER = ["--host-kv-cache-mb", "4096"]
# x1: llama3-70b int8 weights, tp2 to tp2 (a replica's ranks on two cards)
X1_ARGV = (["--preset", "llama3-70b", "--quantization", "int8",
            "--mesh-plan", "tp2"] + MAIN_ARGV[2:] + X_TIER)
# x2: mixtral-8x7b bf16, ep2 (each rank every KV head) to tp2
X2_PREFILL_ARGV = (["--preset", "mixtral-8x7b", "--mesh-plan", "ep2"]
                   + MAIN_ARGV[2:] + X_TIER)
X2_DECODE_ARGV = (["--preset", "mixtral-8x7b", "--mesh-plan", "tp2"]
                  + MAIN_ARGV[2:] + X_TIER)
# each replica's cards (its rank 0 sets them; its followers inherit them)
X_CARDS = ("0,1", "2,3")
X_CALL_TIMEOUT_S = 900
# x3: 8 inputs at the 512 bucket; a query and four documents
X_EMBED_TEXTS = [f"Input {i} of the replica's batch: " + "kv heads " * (
    26 + 3 * i) for i in range(8)]
X_QUERY = "Input 3 of the replica's batch"
# a chain the source stores and the decode replica pulls by its tail key
X_PULL_PROMPT = "".join(chr(ord("a") + (i * 7) % 26) for i in range(1034))
# x3's fp32 runs: full width cut to X3_LAYERS, sharded against one card
X3_LAYERS = 4
X3_CASES = (("llama3-70b", "tp4"), ("llama3-70b", "dp2xtp2"),
            ("mixtral-8x7b", "ep2xtp2"))
X3_TOL = 1e-4
X_RANK_DEVICE = "cuda"


def _x_child(argv, cards, conn):
    """One replica's rank 0, in a process of its own that sees only
    ``cards`` (its followers inherit that): the port's server over
    ``argv``, then the parent's commands (:data:`_X_COMMANDS`) until
    ``stop``."""
    import traceback

    os.environ["CUDA_VISIBLE_DEVICES"] = cards
    # a llama3-70b prompt's 7 blocks are 587 MB on the wire; the default
    # 10 s bounds a stalled peer, not a transfer of that size
    os.environ.setdefault("GPUSTACK_TPU_KV_HANDOFF_TIMEOUT", "60")
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        engine, server, port, setup_s = _w_replica(argv)
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    # the leader's forwards, counted from the first count_start
    engine._x_calls = ChunkedCalls(engine.runner, int8="int8" in argv)
    conn.send(("ok", (port, setup_s)))
    try:
        while True:
            name, args = conn.recv()
            if name == "stop":
                return
            try:
                conn.send(("ok", _X_COMMANDS[name](engine, port, *args)))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    finally:
        _w_close(engine, server)
        conn.send(("ok", None))


# the spawn target of a replica (a rehearsal on the CPU wraps it)
X_CHILD = _x_child


class _XReplica:
    """A replica in a process of its own (:func:`_x_child`), driven over a
    pipe: ``call(command, *args)`` runs one of :data:`_X_COMMANDS` there."""

    def __init__(self, label, argv, cards):
        import multiprocessing as mp

        self.label = label
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=X_CHILD, args=(argv, cards, child),
                                daemon=True)
        self.proc.start()
        child.close()
        self.port = self.setup_s = None

    def _recv(self, what, timeout):
        if not self.conn.poll(timeout):
            raise AssertionError(f"{self.label}: {what} took over "
                                 f"{timeout} s")
        status, value = self.conn.recv()
        if status != "ok":
            raise AssertionError(f"{self.label}: {what} failed:\n{value}")
        return value

    def ready(self):
        self.port, self.setup_s = self._recv("start", X_CALL_TIMEOUT_S)
        return self

    def call(self, name, *args):
        self.conn.send((name, args))
        return self._recv(name, X_CALL_TIMEOUT_S)

    def close(self):
        try:
            if self.proc.is_alive():
                self.conn.send(("stop", ()))
                self._recv("stop", 300)
        except (AssertionError, OSError, EOFError):
            pass
        finally:
            self.proc.join(60)
            if self.proc.is_alive():
                self.proc.kill()
                self.proc.join()


def _x_count_start(engine, port):
    """Count every rank's launches and the leader's forwards from here."""
    engine.runner.probe(engine._state, "reset_launches")
    engine._x_calls.reset()


def _x_count_stop(engine, port, label):
    """Every rank's launches since :func:`_x_count_start`, each equal to
    what the leader's forwards need on that rank; and those forwards."""
    calls = engine._x_calls
    launches = _w_launches(engine, label, calls,
                           engine.runner.probe(engine._state, "launches"))
    return launches, calls.counts()


def _x_block_digests(engine, port, ids, n):
    """Each rank's sha256 of each of ``ids``' first ``n`` blocks as it
    stores them (K, V and any scales: ``probe("kv_tier")``)."""
    return [[t["block_digest"] for t in engine.runner.probe(
        engine._state, "kv_tier", ids=ids[:(b + 1) * BLOCK])]
        for b in range(n)]


def _x_state(engine, port, label):
    """The tier on every rank (:func:`_w_tier`), the handoff counters, the
    reused tokens, each rank's peak GB."""
    health = engine.health()
    return {"tier": _w_tier(engine, label),
            "handoff": dict(engine.kv_handoff.snapshot(), seconds_total=(
                engine.kv_handoff.seconds.snapshot()[1])),
            "reused_tokens": health["kv_cache_prefix_tokens_reused"],
            "role": health["kv_role"], "status": health["status"],
            "keys": engine.host_kv_cache.keys(),
            "peak_gb_per_rank": [m / 1e9 for m in engine.runner.probe(
                engine._state, "memory")]}


def _x_has(engine, port, key_hex, timeout):
    """Seconds until the leader's tier holds ``key_hex`` (None: never)."""
    t0 = time.perf_counter()
    key = bytes.fromhex(key_hex)
    while time.perf_counter() - t0 < timeout:
        if engine.host_kv_cache.block(key) is not None:
            return time.perf_counter() - t0
        time.sleep(0.01)
    return None


def _x_cold(engine, port, ids, n):
    """A cold run of ``ids`` on this replica (its tier detached, so it
    neither matches nor stores): greedy ids biased to lowercase letters,
    each position's top-2 logprob gap."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    cache, engine.host_kv_cache = engine.host_kv_cache, None
    try:
        ref = engine.generate(GenRequest(
            prompt_ids=list(ids), max_tokens=n, temperature=0.0,
            logit_bias={int(k): v for k, v in LETTERS.items()},
            logprobs=True, top_logprobs=2,
        ), timeout=600)
    finally:
        engine.host_kv_cache = cache
    return ref.output_ids, [t[0][1] - t[1][1] for t in
                            ref.output_top_logprobs]


def _x_warm_cold(engine, port, ids, replay):
    """Phase w's warm-against-cold gate on the imported blocks; with
    ``replay`` (MoE) the cold prefill's expert picks are recorded on every
    rank and its tail's rows replayed in the warm continuation."""
    runner, state = engine.runner, engine._state
    if not replay:
        return _w_warm_cold(engine, ids)
    plen = engine.host_kv_cache.match_prefix_len(ids)
    bucket = runner.bucket_for(len(ids))
    runner.probe(state, "routing_record")
    try:
        with torch.no_grad():
            cold, _, _ = runner.prefill(ids + [0] * (bucket - len(ids)),
                                        len(ids), slot=0)
        cold = cold.float().cpu()
        sb = runner.bucket_for(len(ids) - plen)
        runner.probe(state, "routing_replay", ids=[plen, plen + sb])
        warm, plen = _w_hit(engine, ids, 0)
    finally:
        tape = runner.probe(state, "routing")
    gate = _compare_logits(warm, cold)
    top2 = cold.topk(2).values
    gap = float(top2[0] - top2[1])
    ids_equal = int(warm.argmax()) == int(cold.argmax())
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
        gate["cosine"] < LOGIT_MIN_COSINE
    ) or not (ids_equal or gap < IDS_GAP_REL * gate["logit_scale"]):
        raise AssertionError(f"warm logits part from cold: {gate}")
    return {**gate, "prefix_tokens": plen, "prompt_tokens": len(ids),
            "greedy_ids_equal": ids_equal, "cold_top2_gap": gap,
            "replayed_picks": True,
            "flipped_picks_per_rank": [sum(r["flips"]) for r in tape],
            "tolerance": {"rel": LOGIT_REL_TOL,
                          "min_cosine": LOGIT_MIN_COSINE}}


def _x_embed(engine, port, moe):
    """x3 on a served replica: ``/v1/embeddings`` of 8 inputs at the 512
    bucket, every rank's launches counted (flash once a layer of the one
    forward), each vector against the same replica's forward through the
    plain attention (MoE: the served picks replayed) at cosine
    ``EMBED_MIN_COSINE``; ``/v1/rerank`` in the order of the cosines of
    the returned vectors."""
    runner, state = engine.runner, engine._state
    tok = engine.tokenizer
    lens = [len(tok.encode(t)) for t in X_EMBED_TEXTS]
    if runner.bucket_for(max(lens)) != 512:
        raise AssertionError(f"x3 batch lengths {lens}")
    _x_count_start(engine, port)
    if moe:
        runner.probe(state, "routing_record")
    try:
        t0 = time.perf_counter()
        _, raw = _post(port, "/v1/embeddings", {"input": X_EMBED_TEXTS})
        batch_ms = (time.perf_counter() - t0) * 1e3
        launches, calls = _x_count_stop(engine, port, "x3 embeddings")
        vecs = torch.tensor([d["embedding"] for d in json.loads(raw)["data"]])
        if moe:
            runner.probe(state, "routing_replay")
        runner.probe(state, "plain_attention", true_len=1)
        try:
            plain = torch.tensor(engine.embed(
                [tok.encode(t) for t in X_EMBED_TEXTS]))
        finally:
            runner.probe(state, "plain_attention", true_len=0)
    finally:
        tape = runner.probe(state, "routing") if moe else None
    cos = torch.nn.functional.cosine_similarity(vecs, plain, dim=-1)
    if vecs.shape != (8, engine.cfg.hidden_size) or not torch.isfinite(
            vecs).all() or cos.min().item() < EMBED_MIN_COSINE:
        raise AssertionError(f"x3 embeddings against the plain attention: "
                             f"cosines {cos.tolist()}")
    docs = X_EMBED_TEXTS[:4]
    _, raw = _post(port, "/v1/rerank", {"query": X_QUERY,
                                        "documents": docs})
    order = [r["index"] for r in json.loads(raw)["results"]]
    _, raw = _post(port, "/v1/embeddings", {"input": [X_QUERY] + docs})
    ev = torch.tensor([d["embedding"] for d in json.loads(raw)["data"]])
    scores = (ev[1:] @ ev[0]).tolist()
    want = sorted(range(len(docs)), key=lambda i: -scores[i])
    if order != want:
        raise AssertionError(f"x3 rerank order {order}, cosines {scores}")
    return {"batch": len(X_EMBED_TEXTS), "bucket": 512,
            "input_tokens": lens, "http_ms_batch": batch_ms,
            "min_cosine_vs_plain": cos.min().item(),
            "min_cosine_gate": EMBED_MIN_COSINE,
            "flipped_picks_per_rank": None if tape is None else [
                sum(r["flips"]) for r in tape],
            "launches_per_rank": launches, "runner_calls": calls,
            "rerank_order": order, "rerank_cosines": scores}


_X_COMMANDS = {
    "count_start": _x_count_start, "count_stop": _x_count_stop,
    "digests": _x_block_digests, "state": _x_state, "has": _x_has,
    "cold": _x_cold, "warm_cold": _x_warm_cold, "embed": _x_embed,
    "reset_memory": lambda e, p: e.runner.probe(e._state, "reset_memory"),
}


def _x_post(port, path, body=None, raw=None):
    """POST ``body`` as JSON (or ``raw`` bytes); returns (status, the
    reply's bytes)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.read()


def _x_digest_of(arrays):
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def _x_check_frames(frames, digests, plan, kv_heads, label):
    """Each rank's stored blocks are the frames' blocks at its part (its
    KV heads; under ``sp`` K and V at its stripe of the tokens, the
    scales whole), bit for bit (their sha256 digests)."""
    import numpy as np

    from gpustack_tpu_torch.parallel.mesh import (
        MeshPlan,
        kv_head_range,
        kv_stripe,
    )

    mp = MeshPlan.parse(plan)
    for b, (fr, per_rank) in enumerate(zip(frames, digests)):
        for r, got in enumerate(per_rank):
            lo, hi = kv_head_range(mp, r, kv_heads)
            r0, r1 = kv_stripe(mp, r, BLOCK)
            want = _x_digest_of(
                np.ascontiguousarray(a[:, r0:r1, lo:hi] if i < 2
                                     else a[:, :, lo:hi])
                for i, a in enumerate((fr.k, fr.v, fr.k_scale, fr.v_scale))
                if a is not None)
            if got != want:
                raise AssertionError(f"{label}: rank {r}'s block {b} is not "
                                     "the frame's at its heads")
    return {"blocks": len(frames), "ranks": len(digests[0]),
            "bit_for_bit": True}


def _x_handoff(kind, smi, label, prefill_argv, decode_argv, moe, embed,
               prompt=N_PROMPT, cold_prompt=N_COLD_PROMPT,
               line="multi_gpu_kv_role"):
    """One handoff between two live replicas (module docstring, x1/x2; y3
    with ``prompt``): returns the report; raises on a failed gate."""
    from gpustack_tpu_torch.engine.kv_host_cache import HostKVCache
    from gpustack_tpu_torch.engine.kv_transfer import decode_stream
    from gpustack_tpu_torch.engine.tokenizer import load_tokenizer
    from gpustack_tpu_torch.models.config import get_config

    t0 = time.perf_counter()
    pre = _XReplica(f"{label} prefill", prefill_argv + ["--kv-role",
                                                        "prefill"],
                    X_CARDS[0])
    dec = _XReplica(f"{label} decode", decode_argv + ["--kv-role", "decode"],
                    X_CARDS[1])
    try:
        pre.ready()
        dec.ready()
        setup_s = time.perf_counter() - t0
        cfg = get_config(decode_argv[decode_argv.index("--preset") + 1])
        tok = load_tokenizer(None)
        ids = tok.encode(prompt)
        blocks = (len(ids) - 1) // BLOCK
        for r in (pre, dec):                   # first calls: warm-up
            _stream_completion(r.port, "warm up", 2)
            r.call("reset_memory")
        _, ttft_cold = _stream_completion(dec.port, cold_prompt,
                                          N_MAX_TOKENS)
        before = dec.call("state", f"{label} decode")
        for r in (pre, dec):
            r.call("count_start")
        source = f"http://127.0.0.1:{pre.port}/kv/export"
        t1 = time.perf_counter()
        text, ttft_warm = _stream_completion(
            dec.port, prompt, N_MAX_TOKENS,
            headers={"X-GPUStack-KV-Source": source})
        request_s = time.perf_counter() - t1
        counted = {"prefill": pre.call("count_stop", f"{label} prefill"),
                   "decode": dec.call("count_stop", f"{label} decode")}
        forwards = {k: v[1] for k, v in counted.items()}
        if (forwards["prefill"]["prefill"] != 1
                or forwards["decode"]["prefill_with_prefix"] != 1
                or forwards["decode"]["prefill"]):
            raise AssertionError(f"{label}: runner calls {forwards}: want "
                                 "one prefill there, one tail prefill here")
        after = dec.call("state", f"{label} decode")
        sent = pre.call("state", f"{label} prefill")
        got = {k: after["handoff"][k] - before["handoff"][k]
               for k in after["handoff"]}
        reused = after["reused_tokens"] - before["reused_tokens"]
        if (got["pulls"] != 1 or got["failures"] or got["blocks_in"] != blocks
                or reused != blocks * BLOCK
                or sent["handoff"]["blocks_out"] != blocks):
            raise AssertionError(f"{label}: handoff received {got}, sent "
                                 f"{sent['handoff']}, reused {reused}")
        # the frames the source writes for the prompt, and every rank's
        # blocks on both replicas
        t3 = time.perf_counter()
        _, raw = _x_post(pre.port, "/kv/export", {"prompt_ids": ids})
        export_s = time.perf_counter() - t3
        frames = decode_stream(raw)
        if len(frames) != blocks:
            raise AssertionError(f"{label}: {len(frames)} frames")
        # the same frames into the decode replica, which holds them:
        # decode, stage, the scatter, nothing attached
        t3 = time.perf_counter()
        status, reply = _x_post(dec.port, "/kv/import", raw=raw)
        import_s = time.perf_counter() - t3
        if status != 200 or json.loads(reply)["blocks_attached"]:
            raise AssertionError(f"{label}: /kv/import {status} {reply}")
        plans = [a[a.index("--mesh-plan") + 1] for a in (prefill_argv,
                                                          decode_argv)]
        frames_check = {
            side: _x_check_frames(
                frames, r.call("digests", ids, blocks), plan,
                cfg.num_kv_heads, f"{label} {side}")
            for side, r, plan in (("prefill", pre, plans[0]),
                                  ("decode", dec, plans[1]))}
        # greedy ids against a cold run on the decode replica (phase g's
        # rule), the first-token logits against a cold prefill
        cold_ids, gaps = dec.call("cold", ids, N_MAX_TOKENS)
        warm = dec.call("warm_cold", ids, moe)
        rule = _ids_rule([(cold_ids, gaps)], [(tok.encode(text), None)],
                         IDS_GAP_REL * warm["logit_scale"])
        # /kv/pull by the tail key of a chain only the source holds
        chain = HostKVCache(0, block_tokens=BLOCK).chain_keys(
            tok.encode(X_PULL_PROMPT))
        tail = chain[-1].hex()
        _post(pre.port, "/v1/completions", {
            "prompt": X_PULL_PROMPT, "max_tokens": 1, "temperature": 0})
        if pre.call("has", tail, 120.0) is None:
            raise AssertionError(f"{label}: the source never stored "
                                 "the pulled chain")
        t2 = time.perf_counter()
        status, _ = _x_post(dec.port, "/kv/pull", {"source": source,
                                                   "tail_key": tail})
        waited = dec.call("has", tail, 120.0) if status == 202 else None
        pull_s = time.perf_counter() - t2
        if waited is None:
            raise AssertionError(f"{label}: /kv/pull never landed")
        final = dec.call("state", f"{label} decode after the pull")
        if not {k.hex() for k in chain} <= set(final["keys"]):
            raise AssertionError(f"{label}: the pulled chain is not held")
        report = {
            "model": cfg.name, "plans": {"prefill": plans[0],
                                         "decode": plans[1]},
            "tier": "int8" if "--kv-cache-int8" in decode_argv else "bf16",
            "device": kind, "nvidia_smi": smi, "setup_s": setup_s,
            "prompt_tokens": len(ids),
            "handoff": {"seconds": got["seconds_total"],
                        "bytes": got["bytes_in"],
                        "blocks": got["blocks_in"], "block_tokens": BLOCK,
                        "tail_tokens": len(ids) - reused,
                        "q_offset": reused, "request_s": request_s,
                        "export_again_s": export_s,
                        "import_again_s": import_s},
            "ttft_ms_decode_replica_handoff": ttft_warm * 1e3,
            "ttft_ms_decode_replica_cold": ttft_cold * 1e3,
            "frames_vs_rank_blocks": frames_check,
            "tier_check": {"prefill": sent["tier"],
                           "decode": final["tier"]},
            "greedy_ids_vs_cold": rule, "warm_vs_cold": warm,
            "launches_per_rank": {k: v[0] for k, v in counted.items()},
            "runner_calls": forwards,
            "pull": {"blocks": len(chain), "seconds": pull_s,
                     "landed_after_s": waited},
            "peak_gb_per_rank": {"prefill": sent["peak_gb_per_rank"],
                                 "decode": final["peak_gb_per_rank"]},
        }
        if embed:
            report["embeddings"] = {"prefill": pre.call("embed", moe)}
        report["seconds"] = time.perf_counter() - t0
        emit(line, **report)
        return report
    finally:
        dec.close()
        pre.close()


def _x3_case(mesh, device, preset, layers, texts, bucket=512):
    """One fp32 embedding batch of ``texts`` (token ids or text,
    ``bucket`` wide) through the one-card runner (its expert picks
    recorded), then through the sharded runner on ``mesh`` (replaying
    them), each rank building its shard as the server does; rank 0
    compares. Both take the plain versions of the kernels, which take
    bf16 only (as t2 and v2)."""
    from gpustack_tpu_torch.engine import diagnostics
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.engine.tokenizer import load_tokenizer
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(preset), num_layers=layers,
                              dtype="float32")
    tok = load_tokenizer(None)
    rows = [t if isinstance(t, list) else tok.encode(t) for t in texts]
    Tb = bucket
    batch = [r + [0] * (Tb - len(r)) for r in rows]
    lens = [len(r) for r in rows]

    def embed(m):
        runner = ModelRunner(cfg, load_or_init_params(
            cfg, None, seed=0, device=device, mesh=m), device, max_slots=8,
            max_seq_len=Tb, mesh=m)
        out = runner.embed(batch, lens)
        _s_sync(device)
        ran = runner._runs(0)
        del runner
        _s_free(device)
        return None if out is None else out.cpu(), ran

    tape = diagnostics.RoutingTape()
    with torch.no_grad(), _PlainAttention(), _PlainGrouped(), tape:
        want, _ = embed(None)
        tape.replay([[p] for p in tape.picks()])
        got, ran = embed(mesh)
    out = {"model": cfg.name, "plan": str(mesh.plan), "layers": layers,
           "batch": len(rows), "bucket": Tb, "ran": ran,
           "flipped_picks": sum(tape.flips)}
    if mesh.rank:
        return dict(out, ok=True)
    err = (got - want).abs().max().item()
    return dict(out, max_abs_err=err, tolerance=X3_TOL,
                ok=bool(err <= X3_TOL and torch.isfinite(got).all()))


def _x3_rank(rank, world, coordinator, device_type, cases, layers):
    """One rank of x3's fp32 runs (``cases``: (preset, plan) at ``layers``
    layers), in a process of its own: on ``cuda:<rank>`` over NCCL
    (``device_type`` "cpu": gloo, a rehearsal)."""
    from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    first = init_mesh(MeshPlan.parse(cases[0][1]), rank, coordinator,
                      device)
    out = []
    for preset, plan in cases:
        mesh = first if plan == cases[0][1] else Mesh(
            MeshPlan.parse(plan), rank)
        t0 = time.perf_counter()
        case = _x3_case(mesh, device, preset, layers, X_EMBED_TEXTS)
        out.append(dict(case, seconds=time.perf_counter() - t0))
        _s_free(device)
    return out


def phase_kv_role(kind, smi):
    """x1–x3 (four GPUs): two replicas at once, each in a process of its
    own on two cards; then x3's fp32 runs, one process per GPU. Returns
    each kernel's launches per rank on the counted windows."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    if X_RANK_DEVICE == "cuda" and torch.cuda.device_count() < X_GPUS:
        raise AssertionError(f"phase x needs {X_GPUS} cards")
    t0 = time.perf_counter()
    reports = [
        _x_handoff(kind, smi, "x1 bf16", X1_ARGV, X1_ARGV, False, True),
        _x_handoff(kind, smi, "x1 int8", X1_ARGV + ["--kv-cache-int8"],
                   X1_ARGV + ["--kv-cache-int8"], False, False),
        _x_handoff(kind, smi, "x2", X2_PREFILL_ARGV, X2_DECODE_ARGV, True,
                   True),
    ]
    ranks = run_ranks(_x3_rank, X_GPUS, X_RANK_DEVICE, X3_CASES, X3_LAYERS,
                      timeout=S_RANK_TIMEOUT_S)
    for j, (preset, plan) in enumerate(X3_CASES):
        emit("multi_gpu_embed_fp32", device=kind, nvidia_smi=smi,
             **ranks[0][j], per_rank_ran=[r[j]["ran"] for r in ranks])
    bad = [X3_CASES[j] for j, c in enumerate(ranks[0]) if not c["ok"]]
    if bad:
        raise AssertionError(f"phase x3: fp32 embeddings part from one "
                             f"card's: {bad}")
    emit("x", seconds=time.perf_counter() - t0)
    out = {}
    for report in reports:
        tag = f"{report['model']} {report['tier']} handoff"
        for side, launches in report["launches_per_rank"].items():
            for name, counts in launches.items():
                out.setdefault(name, {})[
                    f"{tag} {report['plans'][side]} {side}"] = counts
        for side, emb in report.get("embeddings", {}).items():
            for name, counts in emb["launches_per_rank"].items():
                out.setdefault(name, {})[
                    f"{report['model']} {report['plans'][side]} "
                    "embeddings"] = counts
    return out


# ---------------------------------------------------------------------------
# y: the host KV tier, speculation, --kv-role and embeddings under sp > 1
# ---------------------------------------------------------------------------

Y_GPUS = 4
Y_TIER = ["--host-kv-cache-mb", "4096"]
# y1: phase t's qwen3-8b sp4 replica at 32768 with the tier (4096 MB a
# rank); the int8 tier's replica runs y2's n-gram speculation too
Y1_ARGV = T1_ARGV + Y_TIER
Y1_INT8_ARGV = Y1_ARGV + ["--kv-cache-int8", "--speculative", "ngram"]
# y2: a perfect draft (the target's own seed) on rank 0's card
Y2_DRAFT_ARGV = T1_ARGV + ["--speculative", "draft", "--draft-source",
                           T_PRESET]
# the chat: a long first turn, then two turns adding tokens after the
# reply (each hits the one before), and a cold prompt as long as turn 3
Y_TURNS = (24000, 600, 600)
Y_REPLY = 8
# the first turn's blocks whose int8 stripes are held to the bf16 ones
Y_INT8_BLOCKS = (0, 47)
# y2: one chat a slot, each 8190 tokens long, so the first verify block
# (positions 8190 .. 8193) crosses rank 0's segment end at 8192; as many
# greedy tokens as phase g's chats
Y_SPEC_PROMPT = 8190
Y_SPEC_TOKENS = SPEC_MAX_TOKENS
# phase g's gate on a perfect draft's acceptance, held here to what the
# share of the served tokens the one-card draft itself predicts allows:
# under an sp4 target the ring's bf16 rounding flips some of the target's
# near ties, which no draft on one card can follow
Y_DRAFT_MIN_ACCEPT = 0.9
# y3: handoffs of a 4000-token prompt (15 blocks, a 160-token tail)
# between qwen3-8b sp2 and tp2 replicas, two cards each
Y3_ARGV = ["--preset", T_PRESET, "--max-seq-len", str(T_MAX_SEQ),
           "--max-slots", "4", "--host", "127.0.0.1", "--port", "0"] + Y_TIER
Y3_PROMPT = "".join(chr(ord("a") + (i * 11) % 26) for i in range(4000))
Y3_COLD_PROMPT = "".join(chr(ord("a") + (i * 17) % 26) for i in range(4000))
# y3's embeddings on y1's replica: x3's 8 x 512 batch and one input at
# the 32768 bucket, each against the same replica's plain attention
Y_EMBED_LONG = 32000
Y_EMBED_MIN_COSINE = 0.9999
# y3's fp32 runs: full width cut to Y3_LAYERS, sp4 against one card
Y3_LAYERS = 4
Y_RANK_DEVICE = "cuda"


def _y_chat(engine, stored):
    """y1's chat (:data:`Y_TURNS`), each request's reused tokens as the
    stored blocks give them, then the cold prompt. Returns (rows, the
    third turn's prompt, the first turn's)."""
    vocab = engine.cfg.vocab_size
    rows, turns = [], []
    prompt = first = _s_ids(Y_TURNS[0], vocab, 161)
    for t, extra in enumerate(Y_TURNS):
        if t:
            prompt = prompt + turns[-1].output_ids + _s_ids(
                extra, vocab, 161 + t)
        req, row = _w_serve(engine, stored, f"turn {t + 1}", prompt,
                            Y_REPLY)
        turns.append(req)
        rows.append(row)
    rows.append(_w_serve(engine, stored, "cold, the third turn's length",
                         _s_ids(len(prompt), vocab, 174), Y_REPLY)[1])
    if not rows[1]["reused_tokens"] or not rows[2]["reused_tokens"]:
        raise AssertionError(f"y1: no hit: {rows}")
    return rows, prompt, first


def _y_blocks(engine, prompt):
    """Every rank's stored arrays of ``prompt``'s blocks
    :data:`Y_INT8_BLOCKS` (``probe("kv_block")``)."""
    return {b: engine.runner.probe(engine._state, "kv_block",
                                   ids=prompt[:(b + 1) * BLOCK])
            for b in Y_INT8_BLOCKS}


def _y_int8_check(bf16, int8):
    """The int8 tier's stored blocks against the bf16 tier's of the same
    prompt on a replica of the same plan (the same bf16 K/V): rank 0
    joins each block's stripes, quantises the whole block once (the
    host tier's own ``_quantize_block``), and every rank's ``q`` and
    scales must equal that block's at its stripe, bit for bit."""
    import numpy as np

    from gpustack_tpu_torch.engine.host_bf16 import BF16
    from gpustack_tpu_torch.engine.kv_host_cache import _quantize_block

    out = {}
    for b, ranks in bf16.items():
        rows = [0]
        for r in ranks:
            rows.append(rows[-1] + r["k"].shape[1])
        for name in ("k", "v"):
            whole = np.concatenate([r[name] for r in ranks], axis=1)
            q, scale = _quantize_block(whole.view(BF16))
            for rank, got in enumerate(int8[b]):
                want_q = q[:, rows[rank]:rows[rank + 1]]
                if (got[name].tobytes() != want_q.tobytes()
                        or got[f"{name}_scale"].tobytes()
                        != scale.tobytes()):
                    raise AssertionError(
                        f"y1 int8: rank {rank}'s block {b} {name} is not "
                        "its stripe of the whole block's quantisation")
        out[b] = {"ranks": len(ranks), "q_and_scales_bit_for_bit": True,
                  "stripe_rows": [r["k"].shape[1] for r in ranks]}
    return out


def _y_chats(engine, logprobs):
    """Four chats at once (one a slot), each :data:`Y_SPEC_PROMPT` tokens,
    :data:`Y_SPEC_TOKENS` greedy tokens: ([(ids, each position's top-2
    gap or None)], decode tokens/s after every first token)."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    vocab = engine.cfg.vocab_size
    reqs = [engine.submit(GenRequest(
        prompt_ids=_s_ids(Y_SPEC_PROMPT, vocab, 180 + i),
        max_tokens=Y_SPEC_TOKENS, temperature=0.0, stop_ids=(),
        logprobs=logprobs, top_logprobs=2 if logprobs else 0))
        for i in range(engine.max_slots)]
    for r in reqs:
        if not r.done.wait(900):
            raise AssertionError("a y2 chat timed out")
        if len(r.output_ids) != Y_SPEC_TOKENS:
            raise AssertionError(f"a y2 chat ended {r.finish_reason}")
    t_first = max(r.first_token_at for r in reqs)
    t_end = max(r.finished_at for r in reqs)
    rate = sum(len(r.output_ids) - 1 for r in reqs) / max(
        t_end - t_first, 1e-9)
    return [(r.output_ids, [t[0][1] - t[1][1] for t in r.output_top_logprobs]
             if logprobs else None) for r in reqs], rate


def _y_spec(engine, label, plain, scale):
    """y2 on a speculative replica: :func:`_y_chats` (ids held to the plain
    replica's by phase f's rule), every rank's verify steps and accepted
    proposals equal, decode tokens/s, each rank's peak GB. Returns (the
    report, the chats' ids)."""
    state = engine._state
    engine.runner.probe(state, "reset_memory")
    before = engine.runner.probe(state, "spec")
    out, rate = _y_chats(engine, logprobs=False)
    rule = _ids_rule(plain[0], out, IDS_GAP_REL * scale)
    spec = engine.runner.probe(state, "spec")
    steps = [s[0] - b[0] for s, b in zip(spec, before)]
    accepted = [s[1] - b[1] for s, b in zip(spec, before)]
    if len(set(steps)) != 1 or len(set(accepted)) != 1 or steps[0] < 1:
        raise AssertionError(f"{label}: verify steps {steps}, accepted "
                             f"{accepted} per rank")
    health = engine.health()
    gaps = [g for _, chat in plain[0] for g in chat]
    return {"ids_rule": rule, "verify_steps_per_rank": steps,
            "accepted_per_rank": accepted,
            "spec_steps": health["spec_steps"],
            "spec_extra_tokens": health["spec_extra_tokens"],
            "spec_acceptance_rate": health["spec_acceptance_rate"],
            "draft_model": health["draft_model"],
            "plain_near_tie_share": sum(
                g < IDS_GAP_REL * scale for g in gaps) / max(1, len(gaps)),
            "prompt_tokens": Y_SPEC_PROMPT,
            "decode_tokens_per_s_4_chats": {"plain": plain[1],
                                            "speculative": rate},
            "peak_mem_gb_per_rank": [m / 1e9 for m in engine.runner.probe(
                state, "memory")]}, [ids for ids, _ in out]


def _y_embed(engine, port):
    """y3's embeddings on a served ``sp`` replica: each batch (x3's 8 x
    512, one input of :data:`Y_EMBED_LONG` tokens at the 32768 bucket)
    through ``/v1/embeddings``, every rank's launches counted (a ring of
    LSE launches), each vector against the same replica's forward with
    the ring's blocks in the plain version at cosine
    :data:`Y_EMBED_MIN_COSINE`; ``/v1/rerank`` in the order of the
    cosines of the returned vectors."""
    runner, state = engine.runner, engine._state
    tok = engine.tokenizer
    batches = {"8x512": [tok.encode(t) for t in X_EMBED_TEXTS],
               "1x32768": [_s_ids(Y_EMBED_LONG, engine.cfg.vocab_size, 5)]}
    out = {}
    for label, batch in batches.items():
        calls = ChunkedCalls(runner, int8=False)
        runner.probe(state, "reset_launches")
        calls.reset()
        t0 = time.perf_counter()
        _, raw = _post(port, "/v1/embeddings", {"input": batch})
        ms = (time.perf_counter() - t0) * 1e3
        launches = _w_launches(engine, f"y3 embeddings {label}", calls,
                               runner.probe(state, "launches"))
        vecs = torch.tensor([d["embedding"] for d in json.loads(raw)["data"]])
        runner.probe(state, "plain_attention", true_len=1)
        try:
            plain = torch.tensor(engine.embed(batch))
        finally:
            runner.probe(state, "plain_attention", true_len=0)
        cos = torch.nn.functional.cosine_similarity(vecs, plain, dim=-1)
        if vecs.shape != (len(batch), engine.cfg.hidden_size) or not (
                torch.isfinite(vecs).all()) or (
                cos.min().item() < Y_EMBED_MIN_COSINE):
            raise AssertionError(f"y3 embeddings {label} against the plain "
                                 f"attention: cosines {cos.tolist()}")
        out[label] = {"batch": len(batch),
                      "bucket": runner.bucket_for(max(map(len, batch))),
                      "input_tokens": [len(b) for b in batch],
                      "http_ms": ms,
                      "min_cosine_vs_plain": cos.min().item(),
                      "launches_per_rank": launches,
                      "runner_calls": calls.counts()}
    docs = X_EMBED_TEXTS[:4]
    _, raw = _post(port, "/v1/rerank", {"query": X_QUERY,
                                        "documents": docs})
    order = [r["index"] for r in json.loads(raw)["results"]]
    _, raw = _post(port, "/v1/embeddings", {"input": [X_QUERY] + docs})
    ev = torch.tensor([d["embedding"] for d in json.loads(raw)["data"]])
    scores = (ev[1:] @ ev[0]).tolist()
    if order != sorted(range(len(docs)), key=lambda i: -scores[i]):
        raise AssertionError(f"y3 rerank order {order}, cosines {scores}")
    out.update(min_cosine_gate=Y_EMBED_MIN_COSINE, rerank_order=order,
               rerank_cosines=scores)
    return out


def _y1(kind, smi):
    """y1 on the bf16 tier: the chat, counted (LSE launches exact per
    rank; hits as stored), every rank's tier, warm against cold, two
    blocks' stripes for the int8 check; y2's plain chats; y3's
    embeddings. Returns (report, the plain chats, the logit scale, the
    blocks)."""
    engine, server, port, setup_s = _w_replica(Y1_ARGV)
    try:
        stored = []
        _w_serve(engine, stored, "warm-up",
                 _s_ids(600, engine.cfg.vocab_size, 60), Y_REPLY)
        (rows, third, first), launches, calls = _w_counted(
            engine, "y1 bf16", lambda: _y_chat(engine, stored))
        report = {"model": engine.cfg.name, "plan": str(engine.runner.plan),
                  "tier": "bf16", "device": kind, "nvidia_smi": smi,
                  "setup_s": setup_s, "requests": rows,
                  "warm_ttft_ms": rows[2]["ttft_ms"],
                  "cold_ttft_ms": rows[-1]["ttft_ms"],
                  "tier_check": _w_tier(engine, "y1 bf16"),
                  "warm_vs_cold": _w_warm_cold(engine, third),
                  "launches_per_rank": launches, "runner_calls": calls}
        blocks = _y_blocks(engine, first)
        plain = _y_chats(engine, logprobs=True)
        report["decode_tokens_per_s_4_chats"] = plain[1]
        report["embeddings"] = _y_embed(engine, port)
        if engine.health()["status"] != "ok":
            raise AssertionError(f"y1: {engine.health()}")
        emit("sp_kv_tier", **report)
        return report, plain, report["warm_vs_cold"]["logit_scale"], blocks
    finally:
        _w_close(engine, server)


def _y1_int8(kind, smi, plain, scale, blocks):
    """y1 on the int8 tier (its blocks against the bf16 tier's joined and
    quantised whole), and y2's n-gram speculation on the same replica."""
    engine, server, port, setup_s = _w_replica(Y1_INT8_ARGV)
    try:
        stored = []
        _w_serve(engine, stored, "warm-up",
                 _s_ids(600, engine.cfg.vocab_size, 60), Y_REPLY)
        (rows, third, first), launches, calls = _w_counted(
            engine, "y1 int8", lambda: _y_chat(engine, stored))
        report = {"model": engine.cfg.name, "plan": str(engine.runner.plan),
                  "tier": "int8", "device": kind, "nvidia_smi": smi,
                  "setup_s": setup_s, "requests": rows,
                  "warm_ttft_ms": rows[2]["ttft_ms"],
                  "cold_ttft_ms": rows[-1]["ttft_ms"],
                  "tier_check": _w_tier(engine, "y1 int8"),
                  "int8_blocks": _y_int8_check(blocks,
                                               _y_blocks(engine, first)),
                  "warm_vs_cold": _w_warm_cold(engine, third),
                  "launches_per_rank": launches, "runner_calls": calls,
                  "speculation": _y_spec(engine, "y2 ngram", plain,
                                         scale)[0]}
        emit("sp_kv_tier_int8", **report)
        return report
    finally:
        _w_close(engine, server)


def _y_draft_agreement(engine, outputs):
    """The share of the served chats' tokens (``outputs``, the target's
    greedy chains) that the draft model predicts itself, teacher-forced:
    one forward of the draft over each prompt and its served tokens on
    rank 0's card, its argmax at each position against the next served
    token."""
    from gpustack_tpu_torch.models.transformer import forward, lm_head

    draft = engine.draft_runner
    vocab = engine.cfg.vocab_size
    agree = total = 0
    with torch.no_grad():
        for i, out in enumerate(outputs):
            prompt = _s_ids(Y_SPEC_PROMPT, vocab, 180 + i)
            seq = prompt + out[:-1]
            bucket = draft.bucket_for(len(seq))
            tokens = torch.tensor([seq + [0] * (bucket - len(seq))],
                                  device=draft.device)
            hidden, _ = forward(
                draft.params, draft.cfg, tokens,
                torch.arange(bucket, device=draft.device)[None, :],
                return_hidden=True, attn_impl=draft.attn_impl_for(bucket))
            pred = lm_head(draft.params, draft.cfg,
                           hidden[0, len(prompt) - 1:len(seq)]).argmax(-1)
            agree += int((pred.cpu() == torch.tensor(out)).sum())
            total += len(out)
    return agree / max(1, total)


def _y2_draft(kind, smi, plain, scale):
    """y2's draft of the target's own seed on rank 0's card: phase g's
    perfect-draft gate (:data:`Y_DRAFT_MIN_ACCEPT`) on the acceptance its
    teacher-forced agreement ``a`` allows a verify block of ``k``
    proposals, the mean of ``a^j`` over ``j = 1 .. k`` (1 where the draft
    computes the target's own logits, as on one card)."""
    engine, server, port, setup_s = _w_replica(Y2_DRAFT_ARGV)
    try:
        spec, outputs = _y_spec(engine, "y2 draft", plain, scale)
        agreement = _y_draft_agreement(engine, outputs)
        k = engine.spec_tokens - 1
        allowed = sum(agreement ** j for j in range(1, k + 1)) / k
        report = {"model": engine.cfg.name, "plan": str(engine.runner.plan),
                  "device": kind, "nvidia_smi": smi, "setup_s": setup_s,
                  **spec, "draft_teacher_forced_agreement": agreement,
                  "acceptance_allowed": allowed,
                  "acceptance_gate": Y_DRAFT_MIN_ACCEPT * allowed}
        if report["spec_acceptance_rate"] < Y_DRAFT_MIN_ACCEPT * allowed:
            raise AssertionError(
                f"y2: the draft accepted {report['spec_acceptance_rate']} "
                f"of its proposals; its agreement {agreement} with the "
                f"served tokens allows {allowed}")
        emit("sp_speculation_draft", **report)
        return report
    finally:
        _w_close(engine, server)


def _y3_rank(rank, world, coordinator, device_type, preset, layers,
             long_tokens, long_bucket):
    """One rank of y3's fp32 runs of ``preset`` at ``layers`` layers under
    ``sp4`` against one card: x3's 8 x 512 batch and one input of
    ``long_tokens`` at the ``long_bucket`` bucket (``device_type``
    "cpu": gloo, a rehearsal)."""
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.parallel.mesh import MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, rank if device_type == "cuda" else None)
    mesh = init_mesh(MeshPlan.parse("sp4"), rank, coordinator, device)
    long_ids = _s_ids(long_tokens, get_config(preset).vocab_size, 5)
    out = []
    for texts, bucket in ((X_EMBED_TEXTS, 512), ([long_ids], long_bucket)):
        t0 = time.perf_counter()
        case = _x3_case(mesh, device, preset, layers, texts, bucket)
        out.append(dict(case, seconds=time.perf_counter() - t0))
        _s_free(device)
    return out


def phase_sp_features(kind, smi):
    """y1–y3 (four GPUs): qwen3-8b ``sp4`` with the bf16 tier, then the
    int8 tier with n-gram speculation, then a perfect draft, one replica
    at a time; the handoffs, two replicas at once; the fp32 embeddings,
    one process per GPU. Returns each kernel's launches per rank on the
    counted windows."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    if Y_RANK_DEVICE == "cuda" and torch.cuda.device_count() < Y_GPUS:
        raise AssertionError(f"phase y needs {Y_GPUS} cards")
    t0 = time.perf_counter()
    y1, plain, scale, blocks = _y1(kind, smi)
    _free()
    y1_int8 = _y1_int8(kind, smi, plain, scale, blocks)
    del blocks
    _free()
    _y2_draft(kind, smi, plain, scale)
    _free()
    sp2 = ["--mesh-plan", "sp2"] + Y3_ARGV
    tp2 = ["--mesh-plan", "tp2"] + Y3_ARGV
    handoffs = [
        _x_handoff(kind, smi, "y3 sp2 to tp2", sp2, tp2, False, False,
                   Y3_PROMPT, Y3_COLD_PROMPT, "sp_kv_role"),
        _x_handoff(kind, smi, "y3 tp2 to sp2", tp2, sp2, False, False,
                   Y3_PROMPT, Y3_COLD_PROMPT, "sp_kv_role"),
    ]
    ranks = run_ranks(_y3_rank, Y_GPUS, Y_RANK_DEVICE, T_PRESET, Y3_LAYERS,
                      Y_EMBED_LONG, T_MAX_SEQ, timeout=S_RANK_TIMEOUT_S)
    for j in range(len(ranks[0])):
        emit("sp_embed_fp32", device=kind, nvidia_smi=smi, **ranks[0][j])
    bad = [c["bucket"] for c in ranks[0] if not c["ok"]]
    if bad:
        raise AssertionError(f"phase y3: fp32 embeddings part from one "
                             f"card's at buckets {bad}")
    emit("y", seconds=time.perf_counter() - t0)
    out = {}
    for report, tag in ((y1, "bf16 tier"), (y1_int8, "int8 tier")):
        for name, counts in report["launches_per_rank"].items():
            out.setdefault(name, {})[
                f"{report['model']} {report['plan']} {tag}"] = counts
    for label, emb in y1["embeddings"].items():
        if isinstance(emb, dict) and "launches_per_rank" in emb:
            for name, counts in emb["launches_per_rank"].items():
                out.setdefault(name, {})[
                    f"{y1['model']} {y1['plan']} embeddings {label}"] = counts
    for report in handoffs:
        for side, launches in report["launches_per_rank"].items():
            for name, counts in launches.items():
                out.setdefault(name, {})[
                    f"{report['model']} handoff {report['plans'][side]} "
                    f"{side}"] = counts
    return out


# ---------------------------------------------------------------------------
# z: the vision path on a multi-GPU replica (four GPUs)
# ---------------------------------------------------------------------------

Z_GPUS = 4
# z1, z2: phase o's tower projected into llama3-70b (tp4) and
# mixtral-8x7b (dp2xep2), both bf16 at full width and depth, on rank 0
Z1_ARGV = ["--preset", "llama3-70b", "--mesh-plan", "tp4"] + MAIN_ARGV[2:]
Z2_ARGV = (["--preset", "mixtral-8x7b", "--mesh-plan", "dp2xep2"]
           + MAIN_ARGV[2:])
# z3: phase t's qwen3-8b sp4 replica at 32768; one request whose second
# image follows Z3_GAP text tokens, so its rows fall in rank 2's segment
Z3_ARGV = T1_ARGV
Z3_GAP = 20000
Z3_SEGMENTS = [0, 2]
# z4: full width cut to Z4_LAYERS in fp32 (TF32 off), each plan's
# prefill_with_embeds against one card's; the second image after Z4_GAP
# text tokens straddles sp4's second and third blocks of the 512 bucket
Z4_LAYERS = 4
Z4_CASES = (("llama3-70b", "tp4"), ("mixtral-8x7b", "dp2xep2"),
            ("qwen3-8b", "sp4"))
Z4_GAP = 150
Z_RANK_DEVICE = "cuda"


def _z_bundle(lang, device):
    """Phase o's tower (seed 1) projected into ``lang``'s width."""
    from gpustack_tpu_torch.models.vlm import (
        VisionBundle,
        VisionConfig,
        VLMConfig,
        init_vision_params,
    )

    vcfg = VLMConfig(name=f"{lang.name}-vision", language=lang,
                     vision=VisionConfig())
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return VisionBundle(vcfg, init_vision_params(vcfg, gen), device)


def _z_pngs():
    from gpustack_tpu_torch.models.png import encode_png

    return (encode_png(_seeded_image(64, 64, 64)),
            encode_png(_seeded_image(97, 97, 53)))


def _z_two_images(gap):
    """One user turn: phase o's text, the 64 x 64 image, ``gap`` text
    tokens, the 97 x 53 image (resized) and a question mark."""
    parts = [_image_msgs(png)[0]["content"] for png in _z_pngs()]
    return [{"role": "user", "content": parts[0] + [
        {"type": "text", "text": "x" * gap}, parts[1][1],
        {"type": "text", "text": "?"}]}]


def _z_text_twin(engine, msgs):
    """``msgs`` with each image part as as many text tokens: a text chat
    of the image chat's token count (checked)."""
    n = engine.vision.n_image_tokens
    text = [{"role": m["role"], "content": "".join(
        p["text"] if p["type"] == "text" else "x" * n
        for p in m["content"])} for m in msgs]
    if len(engine.tokenizer.apply_chat_template(text)) != len(
            _mm_prompt(engine, msgs)[0]):
        raise AssertionError("the text chat's token count differs")
    return text


class _RowsTimer:
    """Rank 0's world broadcasts of a prompt's image rows (inside
    ``ModelRunner._image_rows``): each one's bytes and CUDA-event ms
    around the call, the wait for the followers to reach it included."""

    def __init__(self, runner):
        inner = getattr(runner, "_runner", runner)
        mesh, image_rows, self.events = inner.mesh, inner._image_rows, []

        def timed(*args):
            def broadcast(x, _plain=mesh.broadcast_):
                if x.is_cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    _plain(x)
                    end.record()
                else:                      # gloo: the host's clock
                    start = time.perf_counter()
                    _plain(x)
                    end = time.perf_counter()
                self.events.append((x.numel() * x.element_size(), start,
                                    end))
                return x

            mesh.broadcast_ = broadcast
            try:
                return image_rows(*args)
            finally:
                del mesh.broadcast_

        inner._image_rows = timed

    def read(self):
        if any(not isinstance(s, float) for _, s, _ in self.events):
            torch.cuda.synchronize()
        out = [{"bytes": b, "ms": (e - s) * 1e3 if isinstance(s, float)
                else s.elapsed_time(e)} for b, s, e in self.events]
        self.events.clear()
        return out


def _z_rows_summary(rows):
    return {"broadcasts": len(rows),
            "bytes": sorted({r["bytes"] for r in rows}),
            "ms_median": statistics.median(r["ms"] for r in rows),
            "ms_runs": [r["ms"] for r in rows]}


def _z_launches(engine, label, calls, launches):
    """:func:`_w_launches`, and every rank's flash launches by mode (the
    causal mode one a layer on each rank of the slot's group, the LSE
    mode ``(r + 1)`` a layer at ``sp`` index ``r``)."""
    from gpustack_tpu_torch.parallel.mesh import rank_coords

    out = _w_launches(engine, label, calls, launches)
    plan = engine.runner.plan
    for mode in ("causal", "lse"):
        got = launches[f"flash_attention_prefill_{mode}"]
        want = []
        for r in range(plan.chips):
            c = rank_coords(plan, r)
            want.append(expected_launches([calls], c["sp"],
                                          c["dp"])[f"flash_{mode}"])
        if got != want:
            raise AssertionError(f"{label}: flash {mode} launched {got} "
                                 f"per rank, the forwards need {want}")
        out[f"flash_{mode}"] = got
    return out


def _z_logit_gate(engine, msgs, slot, replay, label):
    """An image prompt's prefill on the idle replica from this thread
    (every rank runs it; under ``dp`` the ``slot``'s group, its logits
    sent to rank 0), counted on every rank, against the same prefill
    with the plain attention on the same ranks (``probe
    ("plain_attention")``): last-position logits within the served-logit
    tolerance. With ``replay`` the plain run replays each rank's served
    expert picks, and the free-routing run rides beside."""
    import types

    runner, state = engine.runner, engine._state
    ids, padded, embeds, mask = _mm_prompt(engine, msgs)
    args = (padded, len(ids), embeds, mask)
    extra = {}
    with torch.no_grad():
        if replay:
            runner.probe(state, "routing_record")
        runner.probe(state, "reset_launches")
        served, _, _ = runner.prefill_with_embeds(*args, slot=slot)
        launches = runner.probe(state, "launches")
        if replay:
            runner.probe(state, "routing_replay")
        runner.probe(state, "plain_attention", true_len=1)
        try:
            plain, _, _ = runner.prefill_with_embeds(*args, slot=slot)
            if replay:
                tapes = runner.probe(state, "routing")
                free, _, _ = runner.prefill_with_embeds(*args, slot=slot)
                extra = {"routing": "the served picks replayed in the "
                         "plain run, on every rank",
                         "flipped_tokens_per_rank": [sum(t["flips"])
                                                     for t in tapes],
                         "free_routing": _compare_logits(served, free)}
        finally:
            runner.probe(state, "plain_attention", true_len=0)
    one = types.SimpleNamespace(runner=runner, int8=False, forwards=[
        ("prefill_with_embeds", 1, len(padded), slot)])
    per_rank = _z_launches(engine, f"{label} image prefill", one, launches)
    if served.shape != (runner.cfg.vocab_size,) or not torch.isfinite(
            served).all():
        raise AssertionError(f"{label}: bad logits {tuple(served.shape)}")
    gate = _compare_logits(served, plain)
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
            gate["cosine"] < LOGIT_MIN_COSINE):
        raise AssertionError(f"{label}: image prefill logits differ: {gate}")
    return {**gate, "slot": slot, "prompt_tokens": len(ids),
            "bucket": len(padded), "image_tokens": int(mask.sum()),
            "launches_per_rank": per_rank, **extra,
            "reference": "plain attention, bf16, the same ranks",
            "tolerance": {"rel": LOGIT_REL_TOL,
                          "min_cosine": LOGIT_MIN_COSINE}}


def _z_last_slot(calls):
    """The slot the last prefill of ``calls`` (a :class:`RunnerCalls`)
    named: the engine's slot for the request it started."""
    return next(f[3] for f in reversed(calls.forwards)
                if f[0] in ("prefill", "prefill_with_embeds"))


def _z_chat(port, msgs, n_prompt):
    _, raw = _post(port, "/v1/chat/completions", {
        "messages": msgs, "max_tokens": O_MAX_TOKENS, "temperature": 0,
        "logit_bias": LETTERS})
    data = json.loads(raw)
    _check_usage(data, n_prompt)
    return data["choices"][0]["message"]["content"]


def _z_ttft(port, image_msgs, text_msgs):
    ttft = {"image": [], "text": []}
    for _ in range(O_TTFT_REPS):
        for name, msgs in (("image", image_msgs), ("text", text_msgs)):
            ttft[name].append(_stream_chat(port, msgs, 4)[1] * 1e3)
    return {"ttft_ms_image": statistics.median(ttft["image"]),
            "ttft_ms_text_same_tokens": statistics.median(ttft["text"]),
            "ttft_ms_runs": ttft}


def _z_same_states(engine, label):
    states = engine.runner.probe(engine._state, "slot_state")
    for rank, st in enumerate(states[1:], start=1):
        if not torch.equal(st, states[0]):
            raise AssertionError(
                f"{label}: rank {rank}'s slot state parted from the "
                f"leader's: {st.tolist()} vs {states[0].tolist()}")


def _z_served(kind, smi, argv, label):
    """z1 (``tp4``) or z2 (``dp2xep2``): the tower on rank 0 of a replica
    built through the server. The logit gate with its per-rank launches
    on a slot of each ``dp`` group (group 1's first); then, counted on
    every rank: an image chat with the 64 x 64 PNG, (under ``dp``: text
    chats until the next slot is group 1's) one with the 97 x 53 PNG, a
    streamed one, and image and text chats of one token count for TTFT;
    launches as the leader's forwards need them on each rank, every
    rank's slot state the leader's; under ``dp`` the two image chats on
    different groups, each group's K/V rows of its chat untouched by the
    other group's; the served greedy ids against the runner called
    directly on the same slot."""
    from gpustack_tpu_torch.engine.engine import GenRequest

    t0 = time.perf_counter()
    engine, server, port, setup_s = _w_replica(argv)
    try:
        runner, state = engine.runner, engine._state
        tok, plan, cfg = engine.tokenizer, runner.plan, runner.cfg
        engine.vision = _z_bundle(cfg, runner.device)
        msgs64, msgs97 = (_image_msgs(png) for png in _z_pngs())
        text = _z_text_twin(engine, msgs64)
        n = len(_mm_prompt(engine, msgs64)[0])
        timer = _RowsTimer(runner)
        dp = runner.dp > 1
        gates = [_z_logit_gate(engine, msgs64, slot, cfg.is_moe, label)
                 for slot in ((runner.rows, 0) if dp else (None,))]
        calls = RunnerCalls(runner, int8=False)
        runner.probe(state, "reset_memory")
        runner.probe(state, "reset_launches")
        calls.reset()
        timer.read()

        def last_slot():
            return _z_last_slot(calls)

        served, slots, kv = {}, {}, {}
        served["64x64"] = _z_chat(port, msgs64, n)
        slots["64x64"] = last_slot()
        fillers = 0
        if dp:
            kv["64x64"] = runner.probe(state, "kv_rows", true_len=n,
                                       slot=slots["64x64"])
            while last_slot() // runner.rows == 0:
                engine.generate(GenRequest(
                    prompt_ids=_s_ids(24, cfg.vocab_size, 300 + fillers),
                    max_tokens=1, temperature=0.0), timeout=600)
                fillers += 1
        served["97x53"] = _z_chat(port, msgs97, n)
        slots["97x53"] = last_slot()
        if dp:
            kv["97x53"] = runner.probe(state, "kv_rows", true_len=n,
                                       slot=slots["97x53"])
        streamed, _ = _stream_chat(port, msgs64, O_MAX_TOKENS)
        if streamed != served["64x64"]:
            raise AssertionError(f"{label}: stream {streamed!r} != "
                                 f"{served['64x64']!r}")

        def untouched(name):
            # the chat's K/V rows as they were after its own prefill
            after = runner.probe(state, "kv_rows", true_len=n,
                                 slot=slots[name])
            if not torch.equal(kv[name], after):
                raise AssertionError(
                    f"{label}: slot {slots[name]}'s K/V rows changed under "
                    "the other group's chats")

        if dp:
            untouched("64x64")     # group 1's two chats ran since
        ttft = _z_ttft(port, msgs64, text)
        if dp:
            untouched("97x53")     # the TTFT chats ran on group 0 since
        launches = _z_launches(engine, label, calls,
                               runner.probe(state, "launches"))
        window = calls.counts()
        images = 3 + O_TTFT_REPS
        if window["prefill_with_embeds"] != images or window["prefill"] != (
                O_TTFT_REPS + fillers) or window["prefill_with_prefix"]:
            raise AssertionError(f"{label}: runner calls {window}")
        _z_same_states(engine, label)
        memory = runner.probe(state, "memory")
        rows = timer.read()
        groups = {}
        if dp:
            groups = {name: s // runner.rows for name, s in slots.items()}
            if sorted(groups.values()) != [0, 1]:
                raise AssertionError(f"{label}: image chats on slots "
                                     f"{slots}: not one a group")
        for name, msgs in (("64x64", msgs64), ("97x53", msgs97)):
            ids = _image_greedy(runner, state, slots[name],
                            _mm_prompt(engine, msgs), O_MAX_TOKENS)
            if tok.encode(served[name]) != ids:
                raise AssertionError(f"{label} {name}: served "
                                     f"{served[name]!r}, direct {ids}")
        if engine.health()["status"] != "ok":
            raise AssertionError(f"{label}: {engine.health()}")
        report = {
            "model": cfg.name, "plan": str(plan), "layers": cfg.num_layers,
            "device": kind, "nvidia_smi": smi, "setup_s": setup_s,
            "vision": f"{cfg.name}-vision, the tower on rank 0",
            "logit_checks": gates, "slots": slots, "dp_groups": groups,
            "kv_rows_untouched_by_the_other_group": bool(kv),
            "greedy_ids_vs_runner": "identical", **ttft,
            "rows_broadcast": _z_rows_summary(rows),
            "launches_per_rank": launches, "runner_calls": window,
            "followers_slot_state_equal": True,
            "peak_mem_gb_per_rank": [m / 1e9 for m in memory],
            "seconds": time.perf_counter() - t0}
        emit(f"vision_replica_{label}", **report)
        return report
    finally:
        _w_close(engine, server)


def _z3(kind, smi):
    """z3: qwen3-8b ``sp4`` at 32768 through the server, the tower on rank
    0; one request with an image in rank 0's segment and one in rank
    2's. Its prefill's logits from the replica's runner, then, counted on
    every rank, the chat and image and text TTFT (LSE launches ``(r + 1)``
    a layer on rank ``r``, none causal), every rank's slot state the
    leader's, the served greedy ids against the runner called directly;
    after the replica is down, the logits and greedy ids against one
    card's ``prefill_with_embeds`` over rank 0's tree (flash, no ring)."""
    import numpy as np

    from gpustack_tpu_torch.engine.runner import ModelRunner

    t0 = time.perf_counter()
    engine, server, port, setup_s = _w_replica(Z3_ARGV)
    try:
        runner, state = engine.runner, engine._state
        tok, plan, cfg = engine.tokenizer, runner.plan, runner.cfg
        engine.vision = _z_bundle(cfg, runner.device)
        msgs = _z_two_images(Z3_GAP)
        text = _z_text_twin(engine, msgs)
        prompt = _mm_prompt(engine, msgs)
        ids, padded, embeds, mask = prompt
        block = len(padded) // runner.sp
        segments = sorted({int(p) // block for p in np.flatnonzero(mask)})
        if segments != Z3_SEGMENTS:
            raise AssertionError(f"z3: image rows in the segments of ranks "
                                 f"{segments}, not {Z3_SEGMENTS}")
        timer = _RowsTimer(runner)
        with torch.no_grad():
            replica, _, _ = runner.prefill_with_embeds(padded, len(ids),
                                                       embeds, mask)
        replica = replica.float().cpu()
        calls = RunnerCalls(runner, int8=False)
        runner.probe(state, "reset_memory")
        runner.probe(state, "reset_launches")
        calls.reset()
        timer.read()
        served = _z_chat(port, msgs, len(ids))
        slot = _z_last_slot(calls)
        ttft = _z_ttft(port, msgs, text)
        launches = _z_launches(engine, "z3", calls,
                               runner.probe(state, "launches"))
        window = calls.counts()
        if window["prefill_with_embeds"] != 1 + O_TTFT_REPS or window[
                "prefill"] != O_TTFT_REPS:
            raise AssertionError(f"z3: runner calls {window}")
        _z_same_states(engine, "z3")
        memory = runner.probe(state, "memory")
        rows = timer.read()
        direct = _image_greedy(runner, state, slot, prompt, O_MAX_TOKENS)
        if tok.encode(served) != direct:
            raise AssertionError(f"z3: served {served!r}, direct {direct}")
        if engine.health()["status"] != "ok":
            raise AssertionError(f"z3: {engine.health()}")
        params, device = runner.params, runner.device   # whole under sp
    finally:
        _w_close(engine, server)
    del engine, server, runner, state, calls
    _free()
    one = ModelRunner(cfg, params, device, max_slots=1,
                      max_seq_len=T_MAX_SEQ)
    with torch.no_grad():
        last, _, _ = one.prefill_with_embeds(padded, len(ids), embeds, mask)
    gate = _compare_logits(replica, last.float().cpu())
    if gate["max_abs_err"] > LOGIT_REL_TOL * gate["logit_scale"] or (
            gate["cosine"] < LOGIT_MIN_COSINE):
        raise AssertionError(f"z3: sp4 image logits part from one card's: "
                             f"{gate}")
    one_ids = _image_greedy(one, one.new_state(), 0, prompt, O_MAX_TOKENS)
    del one, params
    _free()
    top2 = last.float().topk(2).values
    report = {
        "model": cfg.name, "plan": str(plan), "layers": cfg.num_layers,
        "max_seq_len": T_MAX_SEQ, "device": kind, "nvidia_smi": smi,
        "setup_s": setup_s, "prompt_tokens": len(ids),
        "bucket": len(padded), "image_tokens": int(mask.sum()),
        "image_row_segments": segments,
        "logit_check": {**gate, "reference": "one card's "
                        "prefill_with_embeds, the same tree, flash, no ring",
                        "tolerance": {"rel": LOGIT_REL_TOL,
                                      "min_cosine": LOGIT_MIN_COSINE}},
        "greedy_ids_vs_runner": "identical",
        "greedy_ids_vs_one_card": ("identical" if one_ids == direct else {
            "replica": direct, "one_card": one_ids,
            "one_card_first_token_top2_gap": float(top2[0] - top2[1])}),
        **ttft, "rows_broadcast": _z_rows_summary(rows),
        "launches_per_rank": launches, "runner_calls": window,
        "followers_slot_state_equal": True,
        "peak_mem_gb_per_rank": [m / 1e9 for m in memory],
        "seconds": time.perf_counter() - t0}
    emit("vision_replica_z3", **report)
    return report


def _z4_case(mesh, device, preset, layers, gap):
    """z4 on one plan: ``preset`` at ``layers`` layers in fp32 (the plain
    versions of the kernels, which take bf16 only): a two-image prompt
    through ``prefill_with_embeds`` on one card (its expert picks
    recorded), then on ``mesh`` (replaying them; under ``dp`` on group
    1's first slot, the logits sent to rank 0; the rows from rank 0
    alone), each rank building its shard as the server does; rank 0
    compares the last position's logits."""
    import numpy as np

    from gpustack_tpu_torch.engine import diagnostics
    from gpustack_tpu_torch.engine.runner import ModelRunner
    from gpustack_tpu_torch.engine.tokenizer import load_tokenizer
    from gpustack_tpu_torch.engine.weights import load_or_init_params
    from gpustack_tpu_torch.models.config import get_config
    from gpustack_tpu_torch.models.vlm import build_mm_prompt

    cfg = dataclasses.replace(get_config(preset), num_layers=layers,
                              dtype="float32")
    ids, embeds, mask = build_mm_prompt(
        load_tokenizer(None), _z_two_images(gap),
        _z_bundle(get_config(preset), device))
    plan = mesh.plan
    rows = {}

    def run(m, slot):
        runner = ModelRunner(cfg, load_or_init_params(
            cfg, None, seed=0, device=device, mesh=m), device, max_slots=4,
            max_seq_len=512, mesh=m)
        pad = runner.bucket_for(len(ids)) - len(ids)
        lead = m is None or m.rank == 0
        if m is not None:
            # every rank at the prefill first: the timed broadcast waits
            # on no rank's tree
            m.broadcast_(torch.zeros(1, device=device))
            if lead:
                timer = _RowsTimer(runner)
        last, k, v = runner.prefill_with_embeds(
            ids + [0] * pad, len(ids),
            np.pad(embeds, ((0, pad), (0, 0))) if lead else None,
            np.pad(mask, (0, pad)), slot=slot)
        _s_sync(device)
        if m is not None and lead:
            rows.update(_z_rows_summary(timer.read()))
        ran = k is not None
        del runner, k, v
        _s_free(device)
        return None if last is None else last.cpu(), ran

    tape = diagnostics.RoutingTape()
    with torch.no_grad(), _PlainAttention(), _PlainGrouped(), tape:
        want, _ = run(None, None)
        tape.replay([[p] for p in tape.picks()])
        got, ran = run(mesh, (plan.dp - 1) * (4 // plan.dp)
                       if plan.dp > 1 else None)
    out = {"model": cfg.name, "plan": str(plan), "layers": layers,
           "weights": "fp32, TF32 off", "prompt_tokens": len(ids),
           "image_tokens": int(mask.sum()), "ran": ran,
           "flipped_picks": sum(tape.flips)}
    if mesh.rank:
        return dict(out, ok=True)
    gate = _compare_logits(got, want)
    return dict(out, **gate, rows_broadcast=rows,
                tolerance={"rel": SHARD_REL_TOL},
                ok=bool(gate["max_abs_err"] <= SHARD_REL_TOL
                        * gate["logit_scale"] and torch.isfinite(got).all()))


def _z4_rank(rank, world, coordinator, device_type, cases, layers, gap):
    """One rank of z4's fp32 runs (``cases``: (preset, plan) at ``layers``
    layers), in a process of its own: on ``cuda:<rank>`` over NCCL
    (``device_type`` "cpu": gloo, a rehearsal)."""
    from gpustack_tpu_torch.parallel.mesh import Mesh, MeshPlan, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device_type == "cuda"
    device = torch.device(device_type, rank if cuda else None)
    first = init_mesh(MeshPlan.parse(cases[0][1]), rank, coordinator,
                      device)
    out = []
    for preset, plan in cases:
        mesh = first if plan == cases[0][1] else Mesh(
            MeshPlan.parse(plan), rank)
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        case = _z4_case(mesh, device, preset, layers, gap)
        out.append(dict(case, seconds=time.perf_counter() - t0,
                        peak_gb=(torch.cuda.max_memory_allocated(device)
                                 / 1e9 if cuda else 0.0)))
        _s_free(device)
    return out


def phase_vision_replica(kind, smi):
    """z1–z4 (four GPUs): image chats on llama3-70b ``tp4``, mixtral-8x7b
    ``dp2xep2`` and qwen3-8b ``sp4`` replicas, one at a time, the tower on
    rank 0 and the rows broadcast from its card; then z4's fp32 runs, one
    process per GPU. Returns each kernel's launches per rank on the
    counted windows."""
    from gpustack_tpu_torch.parallel.launch import run_ranks

    if Z_RANK_DEVICE == "cuda" and torch.cuda.device_count() < Z_GPUS:
        raise AssertionError(f"phase z needs {Z_GPUS} cards")
    t0 = time.perf_counter()
    reports = []
    for run in (lambda: _z_served(kind, smi, Z1_ARGV, "z1"),
                lambda: _z_served(kind, smi, Z2_ARGV, "z2"),
                lambda: _z3(kind, smi)):
        reports.append(run())
        _free()            # the replica's runner, held in cycles till now
    t4 = time.perf_counter()
    ranks = run_ranks(_z4_rank, Z_GPUS, Z_RANK_DEVICE, Z4_CASES, Z4_LAYERS,
                      Z4_GAP, timeout=S_RANK_TIMEOUT_S)
    for j in range(len(Z4_CASES)):
        emit("vision_replica_fp32", device=kind, nvidia_smi=smi,
             **ranks[0][j], per_rank_ran=[r[j]["ran"] for r in ranks],
             peak_mem_gb_per_rank=[r[j]["peak_gb"] for r in ranks])
    bad = [Z4_CASES[j] for j, c in enumerate(ranks[0]) if not c["ok"]]
    if bad:
        raise AssertionError(f"phase z4: fp32 image logits part from one "
                             f"card's: {bad}")
    emit("z", seconds=time.perf_counter() - t0,
         z4_seconds=time.perf_counter() - t4)
    out = {}
    for report in reports:
        for name, counts in report["launches_per_rank"].items():
            out.setdefault(name, {})[
                f"{report['model']} {report['plan']} image chats"] = counts
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "gpustack_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    kind, smi = phase_device()
    phase_build()
    rows = phase_kernels()
    paths = {}
    _free()
    torch.cuda.reset_peak_memory_stats()
    paths["main_path"], bf16 = phase_main_path(kind, smi)
    bf16["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    paths["prefix_reuse"] = phase_prefix_reuse(kind, smi)
    _free()
    phase_checkpoint(kind, smi)
    _free()
    paths["int8_path"] = phase_int8(kind, smi, bf16)
    _free()
    paths.update(phase_speculation(kind, smi))
    _free()
    paths.update(phase_moe(kind, smi))
    _free()
    paths.update(phase_deepseek(kind, smi))
    _free()
    paths.update(phase_gptoss(kind, smi))
    _free()
    paths.update(phase_gemma(kind, smi))
    _free()
    paths.update(phase_mixtral_int8(kind, smi))
    _free()
    paths.update(phase_gemma1(kind, smi))
    _free()
    paths.update(phase_disaggregation(kind, smi))
    _free()
    paths.update(phase_vlm(kind, smi))
    _free()
    paths.update(phase_whisper(kind, smi))
    _free()
    paths.update(phase_tts(kind, smi))
    _free()
    paths.update(phase_images(kind, smi))
    multi_gpu = None
    if torch.cuda.device_count() >= S_GPUS:
        _free()
        multi_gpu = phase_multi_gpu(kind, smi)
    else:
        emit("s", ran=False, reason=f"needs {S_GPUS} cards, found "
             f"{torch.cuda.device_count()}")
    if torch.cuda.device_count() >= T_GPUS:
        _free()
        for name, per_model in phase_sequence_parallel(kind, smi).items():
            multi_gpu.setdefault(name, {}).update(per_model)
    else:
        emit("t", ran=False, reason=f"needs {T_GPUS} cards, found "
             f"{torch.cuda.device_count()}")
    for phase, gpus, fn in (("u", U_GPUS, phase_data_parallel),
                            ("v", V_GPUS, phase_sp_ep),
                            ("w", W_GPUS, phase_tier_spec),
                            ("x", X_GPUS, phase_kv_role),
                            ("y", Y_GPUS, phase_sp_features),
                            ("z", Z_GPUS, phase_vision_replica)):
        if torch.cuda.device_count() >= gpus:
            _free()
            for name, per_model in fn(kind, smi).items():
                multi_gpu.setdefault(name, {}).update(per_model)
        else:
            emit(phase, ran=False, reason=f"needs {gpus} cards, found "
                 f"{torch.cuda.device_count()}")
    kernels = []
    grouped_cases = rows.pop("grouped_cases")
    large_m = rows.pop("w8a16_large_m")
    gemma2 = rows.pop("w8a16_gemma2")
    group8 = rows.pop("flash_group8")
    mla = rows.pop("flash_mla")
    gemma = {tag: rows.pop(f"flash_{tag}") for tag in (
        "gemma7b", "gemma7b_continuation", "gemma2b", "tp4_continuation",
        "tp2_continuation")}
    lse_rows = rows.pop("flash_lse")
    for name, row in rows.items():
        launches = sum(counts[name] for counts in paths.values())
        if launches < 1:
            raise AssertionError(f"{name} never launched on a served path")
        kernels.append({
            "name": name, **KERNEL_META[name], "launches": launches,
            **{k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms",
            )},
            # W8A16: what bf16 serving pays for the same product
            **{k: row[k] for k in ("cublas_bf16_dequantized_ms",) if k in row},
        })
    # W8A16's two paths: the row above is the decode GEMV's (M = 8, w_gate);
    # beside it the wgmma path at 2048 x 4096 x 14336
    w8 = next(k for k in kernels if k["name"] == "w8a16_matmul")
    w8.update({
        "launches_by_path": {
            path: sum(counts[f"w8a16_{path}"] for counts in paths.values())
            for path in ("gemv", "wgmma")
        },
        "large_m_shape": large_m["shape"],
        **{f"large_m_{k}": large_m[k] for k in (
            "max_abs_err", "ms", "bound_ms", "bound_by",
            "cublas_bf16_dequantized_ms", "eager_dequant_ms",
        )},
        # at gemma2-9b's widths (phase k), w_gate at the 2048 bucket
        "gemma2_launches": sum(
            counts["w8a16_matmul"] for path, counts in paths.items()
            if path.startswith("gemma_int8")
        ),
        "gemma2_shape": gemma2["shape"],
        **{f"gemma2_{k}": gemma2[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cublas_bf16_dequantized_ms",
        )},
    })
    # the grouped kernels: the rows above are mixtral-8x7b's int8 gate
    # product and qwen3-30b-a3b's bf16 one at the 2048 bucket; beside them
    # every other case of phase c, and the launches per path and model
    for wtype, name in GROUPED_WRAPPERS.items():
        row = next(k for k in kernels if k["name"] == name)
        row.update({
            "launches_by_path": {
                path: sum(counts[f"{name}_{path}"]
                          for counts in paths.values())
                for path in ("gemv", "wgmma")
            },
            "launches_by_model": {
                model: sum(counts[name] for path, counts in paths.items()
                           if path.startswith(prefixes))
                for model, prefixes in (
                    ("mixtral-8x7b", ("mixtral_int8",)),
                    ("deepseek-v2-lite", ("deepseek",)),
                    ("qwen3-30b-a3b", ("moe_",)),
                    ("gpt-oss-20b", ("gptoss",)),
                )
            },
            "cases": [
                {"weight": weight, "n": n, **{k: case[k] for k in (
                    "path", "experts_reached", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_call",
                )}, **{k: case[k] for k in (
                    "bm", "bn", "units", "ctas", "waves") if k in case}}
                for (weight, n), case in grouped_cases[wtype].items()
            ],
        })
    # the flash kernel at qwen3-30b-a3b's heads (group 8), at
    # deepseek-v2-lite's (d 192) and at Gemma 1's (d 256), T = S = 2048,
    # and at d 256 for a 512-row continuation at offset 1536
    fl = next(k for k in kernels if k["name"] == "flash_attention_prefill")
    fl["gemma1_launches"] = sum(
        counts["flash_attention_prefill"] for path, counts in paths.items()
        if path.startswith("gemma1_")
    )
    fl["vlm_launches"] = paths["vlm"]["flash_attention_prefill"]
    for tag, row in (("group8", group8), ("mla", mla), *gemma.items()):
        fl.update({
            f"{tag}_shape": row["shape"],
            **{f"{tag}_{k}": row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms",
            )},
        })
    # the LSE mode (a ring block): launches on the served paths by mode,
    # and each phase-c case (llama3-8b's 2048 bucket, qwen3-8b's three
    # sp4 ring blocks)
    fl["launches_by_path"] = {
        mode: sum(counts[f"flash_{mode}"] for counts in paths.values())
        for mode in ("causal", "lse")
    }
    fl["lse_cases"] = [
        {k: row[k] for k in (
            "shape", "max_abs_err", "max_lse_abs_err", "ms",
            "causal_mode_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms",
        )}
        for row in lse_rows
    ]
    if multi_gpu is not None:
        # phase s: each rank's launches, by model and path
        for row in kernels:
            row["multi_gpu_launches_per_rank"] = multi_gpu.get(row["name"], {})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _free():
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
