#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (megatron_clip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc ($CUDA_HOME/bin or /usr/local/cuda/bin). It
imports nothing of JAX or of the JAX package. The whole run, the kernels'
build included, must end within 1200 s (run it under `timeout 1200`); on an
NVIDIA H100 80GB HBM3 at 700 W it took 578-604 s before phase 15 came and
559 s with it (the build 174 s). Phases, each
of which raises (and so exits non-zero) on failure:

  1. device: the card's name and power limit, as nvidia-smi reports them;
  2. build: every CUDA kernel of the port from csrc/, one nvcc per source,
     all at once, with the host libraries (the JPEG decoder
     csrc/jpeg_decode.c and the GPT dataset's index helpers
     csrc/dataset_helpers.c, by the host's C compiler) beside them, and
     each kernel's registers and spills;
  3. kernels: first the wgmma tile product of each Hopper library
     (csrc/sm90.cuh) in every operand layout its kernels use, through TMA
     and through swizzled stores, against the fp32 product; then each
     kernel against its plain PyTorch version on the card at
     the serving and training paths' shapes (ViT-B/32; ViT-L/14 and
     ViT-H/14's S=257 vision towers at D=64 and D=80 and S=77 text towers,
     at batch 4 and at the legs' own batches, 64 and 24, with their
     LayerNorms at widths 768 to 1280) and at the fused-MHA gate's edge
     (2, 1024, H=2, D=128, both masks): the
     attention forward with and without the probabilities P or the row
     statistics, the attention backward from P and the recompute backward,
     the LayerNorm forward and backward, on the same inputs in fp32 and in
     bf16, and the bf16 kernel against the plain version run in fp32 on the
     same bf16 inputs (tolerances in TOLERANCES, with their reasons), the
     bf16 fused forward and its dropout twin also row by row (one bf16 ulp
     of P on every term of a row plus an output ulp); the one-pass forward
     at S <= 128, D = 64 (csrc/attn_short_sm90.cuh) at S = 1 to 128, both
     masks, and at the S = 77 paths' batches; the one-pass backward in both
     modes (csrc/attn_short_bwd_sm90.cuh) at S = 1 to 128, both masks, and
     at the S <= 128 paths' shapes, beside tc::'s pair on the same inputs;
     the saved-P backward past S = 128 (the wgmma kernels of
     csrc/attn_bwd_sm90.cuh, P in the forward's padded layout read by TMA)
     row by row at every such shape (the legs' vision towers, a causal
     D = 128 shape among them), its second run the same bits, tc:: on the
     same P within the same bound, and the same P off its 16-byte
     alignment refused, which only the wgmma route does; then
     every attention kernel on the [B, S, *] view of S-major storage, which
     must give exactly what the contiguous tensor gives; and the wgmma
     forwards (csrc/attn_fwd_sm90.cuh: the fused forward past S = 128, the
     bf16 flash forward at D = 64 and 128) built to leave out the last key
     of every 128-key tile, in the whole sequence or its late half, and the
     one-pass forward built to leave out each row's last unmasked key, each
     failing its bounds; the bf16 gradients of both fused backwards also
     row by row, and both backwards' wgmma kernels
     (csrc/attn_bwd_sm90.cuh, recomputing P and from saved P), the one-pass
     backward (each row's last key,
     each key's last query) and the wgmma split flash pair (B=1 S=8192
     H=16, D=64 and D=128 with dropout) built to leave out the last key or
     query of every tile, failing the row bound; the LayerNorm and RMSNorm
     kernels with a bf16 scale (and bias) bit-equal to the call on its
     fp32 values, the backward's sums rounded once, two runs the same
     bits; and the norm backward built to leave each row group's last row
     out of the column sums, or to give each row's last register chunk the
     previous row's mean(g xhat), failing the sums' or dx's bound 10x;
  4. goldens: full-width ViT-B-32-quickgelu in fp32, weights rebuilt from
     tests/goldens/full/vitb32.npz's manifest, against open_CLIP's features
     (atol 1e-4);
  5. serving: ViT-B-32 bf16 with random weights from seed 0, a zero-shot
     classifier over the 1000 ImageNet classes x 7 templates, then 8
     requests of 256 seeded NHWC images answered with top-5 classes. The
     kernels' launch counters are zeroed just before and read just after,
     and must show exactly 12 attention launches per tower forward and 26
     (image) / 25 (text) LayerNorm launches, and no backward launch; bf16
     features must agree with an fp32 run of the same weights at per-row
     cosine >= 0.999. Images per second are all the window's images over
     its wall time, the first request included; the median request latency
     is reported beside it;
  6. timings: each kernel, its plain version and one PyTorch library call
     for the same function, at the ViT-B/32 batch-256 serving shapes and
     batch-384 training shapes (the recompute backward there too, beside
     the saved-P one) and at the attention shapes of the ViT-L/14
     (batch 64) and ViT-H/14 (batch 24) legs, S-major view included, with
     the bound from bytes and operations; at S <= 128 also the forward and
     both backwards on tc:: beside the one-pass kernels, in the same call;
     at the legs' vision towers also the forward with P beside the forward
     with statistics and SDPA's forward, and the saved-P backward beside
     tc:: (route 2) and three readings of SDPA's backward;
     the LayerNorm and RMSNorm backwards at every path's rows, the scale in
     the path's dtype;
  7. train: the ViT-B-32 contrastive train step of bench.py's primary leg
     (pure_bf16, batch 384, AdamW b=(0.9, 0.98) eps 1e-6 wd 0.2 with bf16
     first moments, cosine_lr(1e-3, 100, 10000), clip 1.0), 3 warm-up and
     20 timed steps on one seeded batch. The counters are zeroed just before
     and read after every step: each step must launch the attention forward
     and backward 24 times and the LayerNorm forward and backward 51 times,
     and every loss must be finite. Then one full-width fp32 step at batch 8
     on the card against the same step on the CPU (plain versions) from the
     same weights, and 10 steps in bf16 (fp32 master weights) whose loss on
     one batch must fall;
  8. legs: bench.py's ViT-L/14 (batch 64) and ViT-H/14 (batch 24) train
     legs in their recipe (pure_bf16, the step of phase 7, the recompute
     attention backward of MCT_MHA_SAVE_PROBS=0), 2 warm-up and 10 timed
     steps on one seeded batch each, the counters checked on every step
     (attention forward and recompute backward once per layer, no saved-P
     backward, LayerNorm 75 / 115 times); then each leg with saved
     probabilities for 2 + 5 steps from the same weights and batch, the
     saved-P backward once per layer, whose first loss must equal the
     recompute run's and whose peak memory must lie above it by the bytes
     of every layer's P, at the row pitch the forward writes, less the row
     statistics (within 2%); one more ViT-L/14 step in each mode takes the
     peak memory per stage (forward, backward, update); then one fp32
     recompute step at full ViT-H/14 width (2 layers per tower, batch 4),
     card against CPU;
  9. GPT: bench.py's GPT-345m train step (24 x 1024, 16 heads of 64,
     vocab 50304, pure_bf16, clip 1.0 then AdamW(1e-4, b=(0.9, 0.95)) with
     bf16 first moments, loss chunks of 1024; bench.py:134-181) at batch 6
     and S = 2048, 2 warm-up and 15 timed steps on one seeded batch, every
     step launching the flash forward and the fused flash backward 24 times
     and LayerNorm forward and backward 49 times; the same model at S = 8192
     (batch 1, pretrain_gpt.py --seq-length 8192), 2 + 5 steps through the
     split dQ and dKV backward; every loss finite and the last below the
     first; then one fp32 step at full width (2 layers, batch 1, S = 1280),
     card against CPU;
 10. example GPT: the training path of examples/pretrain_gpt_dist.sh on one
     card (24 x 1024, 16 heads, S = 2048, vocab 50304, rope, swiglu,
     rmsnorm, biases and the tied embedding, --fused-ce, bf16 compute on
     fp32 weights) at batch 8, 2 warm-up and 15 timed steps with bench.py's
     optimizer chain, every step launching the fused CE forward and
     backward once, the RMSNorm forward and backward 49 times and the flash
     forward and fused backward 24 times, the loss falling; one fp32 step
     of its config with grouped-query attention (4 k/v heads, 2 layers,
     S = 512), card against CPU; and GPT-345m (phase 9's model and batch)
     through the fused CE, beside phase 9's chunked run: step times and
     peak memory of both;
 11. pipeline GPT: the training path of examples/pretrain_gpt_pipeline.sh
     on one card (32 x 2048, 16 heads of 128, vocab 50304, learned
     positions, gelu_tanh, LayerNorm, biases, the tied embedding, attention
     and hidden dropout 0.1, --fused-ce, bf16 compute on fp32 weights,
     selective recompute; 1,718,685,696 parameters), the step's dropout
     seeded from 1234: batch 8 x S = 2048, 2 warm-up and 10 timed steps on
     the flash dropout kernels, then one full-recompute step from the same
     weights and batch (time, peak memory); the same model at S = 512,
     batch 32, 2 + 5 steps on the fused-MHA dropout kernels; S = 8192 at
     batch 1 and 8 layers, 2 + 3 steps through the split dQ / dKV backward
     with dropout; every step holding exact launch counts (no rate-0
     attention kernel; LayerNorm's forward once more per block norm that
     the recompute replays) and a falling loss; then fp32 steps at full
     width (2 layers, batch 1, attention dropout 0.1, hidden dropout 0) at
     S = 512 (fused route) and S = 1280 (flash route), card against CPU on
     the same Philox masks;
 12. trainer: the port's CLIP trainer through the entry point a user calls,
     `megatron_clip_tpu_torch.pretrain_clip.main`, in this process: (a)
     ViT-B-32 on synthetic data in phase 7's model, batch and recipe, 3
     warm-up and 10 timed steps at --log-interval 1, each step launching
     exactly phase 7's kernels; the loop's samples/s beside phase 7's
     images/s, a step's host ms in the runner and between steps, and the
     prefetch thread's copy to pinned memory; (b) webdataset shards the
     phase writes (2 tars of 32 RGB PNGs of 256 x 256, rows in all five
     PNG filters, written by its own zlib encoder, with captions) at bf16,
     batch 16, 2 decode workers: 4 steps with --save-interval 2, then the
     run as if cut before step 4's save committed (the tracker back at step
     2) resumed with --resume latest, whose steps 3-4 must give the first
     run's losses bit for bit; one process's decode images/s and the saves'
     host ms; (c) a CSV of 32 such PNG files (224 x 224) with --val-data: 2
     steps, then clip_val_loss and recall@1/5/10; (d) 2 tars of 64 JPEG
     samples made from the committed 640 x 480 fixtures (4:2:0, 4:2:2,
     4:4:4, progressive, grey) at bf16, batch 32, 2 decode workers, draft
     decode at 224 (scale 2), 2 epochs with a falling loss. Before (a) it
     holds the JPEG decoder (csrc/jpeg_decode.c, built by the host's C
     compiler in phase 2) to the digests of Pillow's decode of every
     committed fixture (tests/torch_goldens/jpeg/), whole and at each draft
     size, and times one process's JPEG decode, whole and in draft, alone
     and with the train transform (each rate over windows of at least
     JPEG_RATE_WINDOW_S), beside the host's CPU and CPU count.
     The phase must end within 60 s, and then stops the decode workers'
     forkserver and resource tracker. The fixtures include corrupt files
     (saturating IDCT, smoothed progressive scans) whose digests are
     Pillow's decode of them too;
 13. recipes: the CLIP trainer's recipe flags through
     `pretrain_clip.main`, in this process, on ViT-B-16-SigLIP (12 x 768
     both towers, 224 px, context 64, a bidirectional text tower pooled at
     its last token, a learned logit bias): (a) pure_bf16, synthetic data,
     --siglip --accum-freq 2 --force-patch-dropout 0.5 at batch 256 (two
     blocks of 128; vision S = 99, text S = 64, both on the one-pass
     fused-MHA kernels), 2 warm-up and 5 timed steps, each launching
     exactly the cache pass's forwards without P, the blocks' forwards with
     P and their backwards, finite losses, the last below the first, the
     step median and samples/s; (b) LiT: --lock-image
     --lock-image-unlocked-groups 2 --siglip at bf16 (fp32 master
     weights), batch 128, no patch dropout (vision S = 197 on the wgmma
     kernels), 3 steps, then --lock-text for 2: every locked parameter
     bit-equal before and after, every unlocked one moved, logit_bias
     still -10 (the JAX step never gives the loss the bias); (c) one fp32 --siglip --accum-freq 2
     --force-patch-dropout 0.5 step at two layers a tower, card against
     CPU, and on the card the summed block gradients of --accum-freq 2
     against the --accum-freq 1 gradient of the same batch without patch
     dropout, within 1e-4 of each gradient's norm. Within 60 s;
 14. data parallel: `pretrain_clip` launched by `python -m
     torch.distributed.run`, each rank a process running this script with
     --dp-worker (it wraps the run's steps and model as phases 12 and 13
     do, and writes what it saw for this process to read): (a) one rank
     over NCCL, phase 12's ViT-B-32 synthetic run (pure_bf16, batch 384),
     3 warm-up and 10 timed steps, each launching exactly phase 7's
     kernels, its samples/s and step interval beside phase 12's (the cost
     of the gathers, the gradient all-reduce and the rank logic at W = 1);
     (b) two ranks on the one card over gloo (NCCL refuses two ranks on one
     device), fp32, global batch 32, 3 steps, ViT-B-32 with ClipLoss and
     ViT-B-16-SigLIP with --siglip --accum-freq 2 --force-patch-dropout
     0.5, both launched at once while this process runs each in one
     process on the card on the same global batches: every loss within
     1e-5 relative, every parameter within 1e-4 of its norm, and the two
     ranks' parameters bit-equal. The launches are made before phase 2,
     their processes starting beside the build and waiting for the phase;
     (a) holds its first step until (b) has ended, so that its model is
     built beside (b) and its steps run alone. Within 60 s;
 15. GPT trainer: `megatron_clip_tpu_torch.pretrain_gpt.main` in this
     process: (a) the model and recipe of examples/pretrain_gpt_dist.sh at
     full width and depth (24 x 1024, 16 heads, S = 2048, vocab 50304,
     rope, swiglu, rmsnorm, --fused-ce, selective recompute, bf16 compute
     on fp32 weights, lr 3e-4, weight decay 0.1), less the flags that need
     4 cards (--tensor-model-parallel-size 2 --fsdp-parallel-size 2
     --sequence-parallel) and with --warmup 1 (its 2000 warm-up steps would
     leave 3 steps' loss where it starts), its global batch of 64 in
     microbatches of 8, on
     an indexed corpus the phase writes (a seeded jsonl through `python -m
     megatron_clip_tpu_torch.tools.preprocess_data --tokenizer clip-bpe`,
     its tokens/s printed): 3 steps with a background save at step 2 and
     the eval at the end on the valid split, then the tracker put back at
     step 2 and a run loaded from it for step 3, whose loss must be the
     first run's bit for bit (its grad norm and val loss within 1e-3: the
     flash backward's unordered adds into dQ); every step and eval with
     exact launches, the losses falling from about ln 50304, the step's
     device ms beside 8 x phase 10's step; (b) the 1.3b rung of
     examples/pretrain_gpt_ladder.sh (24 x 2048, batch 4 x 2048, bf16
     weights and moments, remat mlp, loss chunks of 512) on synthetic
     data (losses about ln 50304: each step a fresh uniform batch), 2 + 3
     steps, then one step of the same run with selective
     recompute, whose peak memory must lie above the mlp steps'; (c) an
     fp32 run at 2 layers of full width on the corpus with
     --micro-batch-size, card against CPU (losses and grad norms within
     1e-5 relative, gradients within 1e-4 of their norms, parameters after
     the steps within 1e-4 of their norms). tokens/s, samples/s, peaks and
     the saves' host ms printed. It writes its corpus where phase 16
     reads it, and prints this host's Unicode version beside the GPT-2
     pre-tokenizer's committed class table's source. Within 90 s;
 16. GPT trainer over torchrun ranks and the document flags: (a) one
     NCCL rank of `pretrain_gpt` (torchrun, `chip_smoke.py
     --gpt-dp-worker`) on phase 15 (a)'s model, global batch of 64 in
     microbatches of 8 and corpus, 3 steps with exact launches, its
     tokens/s and step device ms beside phase 15 (a)'s, and the device
     ms of its gradient all-reduce and division (what one rank adds); (b)
     two gloo ranks on the one card (NCCL takes one rank a device), fp32,
     2 layers at full width, S = 256, batch 4 in microbatches of 2, 2
     steps, plain and with --eod-mask-loss --reset-position-ids
     --reset-attention-mask, each against one process on the card (losses within 1e-5 relative,
     parameters within 1e-4 of their norms, the ranks bit-equal), then the
     flagged run cut by SIGTERM on rank 1 after step 1 with --save (both
     ranks stop there, rank 0 saves) and resumed over two ranks, bit-equal
     to the run left whole; (c) the three document flags on phase 15 (a)'s
     model at full width and depth, one microbatch of 8 a step, 2
     steps: exact launches (the document mask takes the unfused
     `sdpa_bshd`, so no flash kernel), the loss falling, the peak memory,
     a layer's unfused attention forward and backward in ms beside
     flash's at the same shape, and an fp32 run at 2 layers with the
     flags, batch 1, card against CPU while (b)'s ranks step (phase 15 (c)'s
     bounds, the parameters after two Adam steps within 1e-3 of their
     norms). The launches are
     made before phase 2, warm up on the CPU and wait for the phase; (a)
     takes its first step beside (b) and holds its timed steps until (b)
     has ended; the phase reads the ranks' results as they are written
     and checks at its end that every launch exited 0. Within 60 s;
 17. tensor parallelism with sequence parallelism, and FSDP: (a) four
     gloo ranks of `pretrain_gpt` on the one card (torchrun,
     `chip_smoke.py --gpt-dp-worker`) at examples/pretrain_gpt_dist.sh's
     layout, --tensor-model-parallel-size 2 --fsdp-parallel-size 2
     --sequence-parallel, on its model at full width (1024, 16 heads,
     S = 2048, vocab 50304, rope, swiglu, rmsnorm, --fused-ce, selective
     recompute, bf16 compute on fp32 weights), 2 layers, batch 4 in one
     microbatch, 2 steps, plain (each rank's launches exactly one
     process's step's: the flash kernels at 8 heads, the RMSNorm kernels
     on S/2 rows, the fused CE on its rows) and, one step, with
     --attention-dropout 0.1, each against one process of the same run
     on the card (losses within TP_LOSS_RTOL, grad norms within
     TP_NORM_RTOL, the share of the parameters' elements a learning rate
     apart); each rank's parameter and moment bytes at most 0.26 of one
     process's, its peak memory; (b) two gloo ranks of `pretrain_clip` at
     --fsdp-parallel-size 2 on ViT-B-16, fp32, batch 8, 2 steps, held
     until (a) ends, against one process (losses within 1e-5, each rank's
     shards within 1e-4 of their norms, its bytes at most 0.51 of one
     process's). The launches are made before phase 2 and wait for the
     phase. Within 60 s. `python3 chip_smoke.py --tp-faults` runs the
     dropout kernels' checks of phase 3 and then (a) with planted faults
     beside its jobs (TP_FAULTS), printing each one's readings and the
     bounds it breaks: the readings the bounds were set from.
 18. GPT text generation: the server tool
     (`python -m megatron_clip_tpu_torch.tools.run_text_generation_server
     --load CKPT --port 0 ...`), each server a process of its own
     (`chip_smoke.py --gpt-serve-worker`: the tool's `build`, served with
     the server's handler plus a probe of each generation's outputs,
     launches, seconds and peak memory), made before phase 2 and loading
     beside phase 17: (a) GPT-345m at full width and depth (24 x
     1024, 16 heads, learned positions, LayerNorm, gelu, vocab 50304, bf16
     compute on fp32 weights from seed 0, the vocabulary's padding rows
     held to a logit of -20.48), written with `save_checkpoint` in the
     trainer's tree and served over HTTP: 8 ragged prompts greedy for 128
     tokens with log-probabilities, 1 prompt greedy, a top-k 40 and a
     decayed top-p 0.9 sample, beam width 4 and stop_on_eol, each with
     exact LayerNorm launches ((2L+1) a forward, 1 + N forwards, N for a
     beam); the greedy request teacher-forced through the port's cached
     forward against `GPTModel`'s forward over the served tokens
     (GEN_LOGIT_TOL, which a planted off-by-one position must break),
     its tokens the forward's argmax wherever its top-2 margin is above
     the tolerance, its log-probabilities the forward's log_softmax within
     GEN_LOGPROB_TOL; the top-k sample within the top 40; the time to
     the first token, the decode step's host ms, its interval on the
     device clock (CUDA events) and its kernels' busy time (a profile) at
     B = 8 and 1, tokens/s, each request's HTTP latency, peak memory and
     the step against its weight-streaming bound; (b)
     examples/pretrain_gpt_dist.sh's model from phase 15 (a)'s
     checkpoint (its padding rows set to 0), prompts of its corpus's
     words, greedy and top-k, the same checks but the planted position
     (RMSNorm launches); (c) GPT-345m at 2 layers in fp32, card against
     CPU in this process: the same text, log-probabilities within
     GEN_CPU_LOGPROB_TOL (with fp32 caches too, printed); (d) two gloo
     ranks of the server at tp 2 on the one card on (c)'s weights against
     (c)'s card: the same text, log-probabilities within
     GEN_TP_LOGPROB_TOL. The LayerNorm and RMSNorm forwards are held
     against their plain versions and timed at the serving rows (B and
     B P x 1024). Within 60 s. `python3 chip_smoke.py --gpt-serving` runs
     phases 1, 2, 15 (a) (for (b)'s checkpoint) and 18 alone.

Before its last lines the script fails if a process it started (a build,
a decode worker, the forkserver, the resource tracker) is still alive.

Phases 3 and 6 also hold and time the fused lm-head cross entropy (forward;
the backward's dX and dW, on wgmma in bf16, in chunks of 4096 tokens) at
full width and vocabulary (T of 2048 in bf16, 512 in fp32), on the tied and
untied head, at a ragged T over two chunks with V = 1000 and at W = 1000
(bf16 rows the tensor cores do not take), with a kernel made to leave out
the last vocabulary tile failing its bounds; hold it in bf16 at the
example's T = 16384, W = 1024 and the pipeline GPT's T = 16384, W = 2048,
and time it at both beside F.cross_entropy(x @ w); and the RMSNorm
kernels at the example's rows. They also hold and time the four
flash-attention kernels at the GPT shapes (B=6 H=16 S=2048 D=64 and B=1
S=8192, both masks), at D = 128, at ragged lengths (1100, 4200), with
Sq != Sk, and on the packed projection's head
views, against their plain versions and F.scaled_dot_product_attention
(bf16 gradients row by row, and each backward kernel made to leave out a
row per tile must fail that bound), and the LayerNorm kernels at GPT's
and the pipeline GPT's rows.

Phases 3 and 6 also hold and time the dropout kernels (flash's four and
the fused-MHA forward and recompute backward, each drawing its mask from
Philox4x32-10 in the kernel): the mask each library exports against the
plain Philox of ops/dropout.py bit for bit and its keep share within 5
sigma, each kernel against its plain version fed the same multipliers in
fp32 and bf16 (the fused route at the pipeline GPT's S = 512 heads, at
its batch 32 there, at H = 12, D = 64 and at S = 333; flash at B = 2,
S = 2048, at S = 1100, and at the path's B = 8, S = 2048 and B = 1,
S = 8192 on the packed projection's head views, the backward also into
the packed gradient buffer; both routes also placed as a tensor-parallel
rank of phase 17 launches them, 8 of 16 heads a row from row 2 of the
step, drawing the step's bits), kernels built to draw per tile or a column off
failing the mask check and the output bounds, and each kernel's time at
the pipeline GPT's shapes beside its rate-0 kernel, its plain version and
SDPA with dropout_p = 0.1.

The last three lines of standard output are the card's name and power
limit, the {"kernels": [...]} line and {"ok": true, "device": {...}}.
"""
import atexit
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_BATCH = 256
SERVE_REQUESTS = 8
CLASSES_PER_TEXT_BATCH = 64
TRAIN_BATCH = 384
TRAIN_WARMUP = 3
TRAIN_STEPS = 20
PARITY_BATCH = 8
# the fp32 parity step: each gradient, card against CPU, within this share
# of its norm (see train_parity)
GRAD_REL_TOL = 1e-4
LEARN_STEPS = 10
# the learning check: the recipe's schedule (lr 1e-5 to 1e-4 over the 10
# steps), and the loss after LEARN_STEPS updates at most this share of the
# first. The recipe's peak reached in 10 steps instead of 100 (lr up to
# 1e-3) left the loss where it started, 5.997 -> 5.950 with a spike to 7.2
# (NVIDIA H100 80GB HBM3, 700.00 W).
LEARN_LR = (1e-3, 100, 10000)
LEARN_MAX_RATIO = 0.9
# phase 8: bench.py's legs (bench.py:190-212), in its step counts
LEGS = (("ViT-L-14", 64), ("ViT-H-14", 24))
LEG_WARMUP, LEG_STEPS = 2, 10
SAVED_P_WARMUP, SAVED_P_STEPS = 2, 5
H_PARITY_LAYERS, H_PARITY_BATCH = 2, 4
# phase 9: bench.py's GPT-345m (bench.py:134-181) and its recipe
GPT_345M = {"num_layers": 24, "hidden_size": 1024, "num_heads": 16,
            "vocab_size": 50304}
GPT_LOSS_CHUNK = 1024
# (batch, S, warm-up steps, timed steps): bench.py's leg, then
# pretrain_gpt.py --seq-length 8192 at batch 1 (the split flash backward)
GPT_RUNS = ((6, 2048, 2, 15), (1, 8192, 2, 5))
GPT_SHAPES = tuple((b, s) for b, s, _, _ in GPT_RUNS)
# the fp32 parity step: full width, 2 layers, one sequence above the fused
# gate; lr 1e-6 (see gpt_parity)
GPT_PARITY_LAYERS, GPT_PARITY_SEQ, GPT_PARITY_LR = 2, 1280, 1e-6
# phase 10: examples/pretrain_gpt_dist.sh's GPT (rope, swiglu, rmsnorm;
# biases and the tied embedding, pretrain_gpt.py's defaults) at batch 8, the
# 345m rung's batch of examples/pretrain_gpt_ladder.sh; (batch, S, warm-up
# steps, timed steps)
EXAMPLE_GPT = {"position_embedding": "rope", "swiglu": True,
               "normalization": "rmsnorm"}
EXAMPLE_RUN = (8, 2048, 2, 15)
# its fp32 parity step with grouped-query attention (2 layers, 4 k/v heads
# for 16 query heads), and GPT-345m's timed steps through the fused CE
GQA_KV_HEADS, GQA_PARITY_SEQ = 4, 512
FUSED_345M_STEPS = 15
# phase 11: examples/pretrain_gpt_pipeline.sh's GPT without its PP/VPP/TP
# flags (32 x 2048, 16 heads of 128, vocab 50304, learned positions,
# gelu_tanh, LayerNorm, biases, the tied embedding, megatron's dropout
# defaults, --fused-ce, bf16 compute on fp32 weights, its default
# REMAT=selective), the step's dropout seeded from PIPELINE_SEED
PIPELINE_GPT = {"num_layers": 32, "hidden_size": 2048, "num_heads": 16,
                "vocab_size": 50304, "attention_dropout": 0.1,
                "hidden_dropout": 0.1}
PIPELINE_PARAMS = 1_718_685_696
PIPELINE_SEED = 1234
PIPELINE_HEADS, PIPELINE_HEAD_DIM = 16, 128
# (batch, S, warm-up steps, timed steps): the example's microbatch of
# 128 / 16 = 8 at S = 2048 (flash with dropout), then the same model at
# --seq-length 512 on the same 16,384 tokens (the fused-MHA dropout kernels)
PIPELINE_RUNS = ((8, 2048, 2, 10), (32, 512, 2, 5))
# (batch, S, layers, warm-up, timed): S = 8192 at full width and 8 layers,
# through the split dQ / dKV backward with dropout
PIPELINE_LONG = (1, 8192, 8, 2, 3)
# the fp32 card-against-CPU steps: 2 layers, batch 1, attention dropout
# 0.1 and hidden dropout 0 (the CPU's generator draws another hidden mask),
# at S = 512 (fused route) and S = 1280 (flash route)
PIPELINE_PARITY_SEQS = (512, 1280)
# the kernels made wrong on purpose (csrc/philox.cuh): a mask drawn per
# 64 x 64 tile, and one shifted by a column
DROPOUT_FAULTS = ("MCT_DROPOUT_FAULT=1", "MCT_DROPOUT_FAULT=2")
# the wgmma attention kernels made wrong on purpose, one build for each
# pair of defines: the forwards (csrc/attn_fwd_sm90.cuh) leave out the last
# key of every 128-key tile, the recompute backward (csrc/attn_bwd_sm90.cuh)
# and the split flash pair (csrc/flash_attention.cu hop::bwd_dq, bwd_dkv)
# the last key of every key tile from dQ (and delta) and the last query of
# every query tile from dK and dV; in the whole sequence (1) and in the
# tiles of its late half (2). fwd_teeth runs only the forwards of such a
# build, bwd_teeth only the backwards, each on the plain version's inputs.
TILE_FAULTS = (("MCT_FWD_TILE_FAULT=1", "MCT_BWD_TILE_FAULT=1"),
               ("MCT_FWD_TILE_FAULT=2", "MCT_BWD_TILE_FAULT=2"))
# the norm backward made wrong on purpose (csrc/layernorm.cu): each row
# group's last row left out of the column sums, and the last register chunk
# of each row given the previous row's mean(g xhat); ln_bwd_teeth holds
# each to LN_TEETH_FACTOR times the bound it must fail
LN_BWD_FAULTS = ("MCT_LN_BWD_FAULT=1", "MCT_LN_BWD_FAULT=2")
LN_TEETH_FACTOR = 10.0
# phase 12: the trainer (`python -m megatron_clip_tpu_torch.pretrain_clip`),
# run in-process, after the JPEG decoder's fixture digests: (a) phase 7's
# model, batch and recipe on synthetic data, warm-up + timed steps; (b)
# WDS_SHARDS tars of WDS_PER_SHARD PNG samples (WDS_IMAGE px) at batch
# WDS_BATCH with WDS_WORKERS decode workers; (c) a CSV of CSV_IMAGES PNGs at
# batch CSV_BATCH with --val-data; (d) JPEG shards. Scratch files under
# SMOKE_DIR (gitignored), removed at the phase's end, which must come
# within TRAINER_PHASE_LIMIT_S.
TRAINER_WARMUP, TRAINER_STEPS = 3, 10
TRAINER_SYNTHETIC = [
    "--model", "ViT-B-32", "--precision", "pure_bf16", "--batch-size",
    str(TRAIN_BATCH), "--dataset-type", "synthetic", "--train-num-samples",
    str(TRAIN_BATCH * (TRAINER_WARMUP + TRAINER_STEPS)), "--lr", "1e-3",
    "--warmup", "100", "--grad-clip-norm", "1.0", "--log-interval", "1"]
# (b) was 2 x 256 samples at batch 128 until (d) came: 34.6 s of the 60 on
# a host that decoded 51 PNGs/s a worker. The phase is paced by the host
# (decode, PNG encoding, five model inits drawn on the CPU): with 3 + 20
# steps in (a), 2 x 128 PNGs at batch 64 in (b), 64 at 32 in (c), 2 x 128
# JPEGs at 64 in (d) and 0.5 s rate windows it took 40.9-51.2 s on the
# card's hosts and 67.5 s on a slower one; these sizes keep every check and
# about half the host's work
WDS_SHARDS, WDS_PER_SHARD, WDS_IMAGE = 2, 32, 256
WDS_BATCH, WDS_WORKERS = 16, 2
CSV_IMAGES, CSV_IMAGE, CSV_BATCH = 32, 224, 16
# the committed JPEG fixtures and Pillow's digests of them
JPEG_GOLDENS = REPO / "tests" / "torch_goldens" / "jpeg"
# (d): JPEG_SHARDS tars of JPEG_PER_SHARD samples made from the committed
# 640 x 480 JPEG fixtures (JPEG_GOLDENS), at batch JPEG_BATCH,
# JPEG_EPOCHS epochs, draft decode on (224: scale 2), with a falling loss
JPEG_SHARDS, JPEG_PER_SHARD, JPEG_BATCH, JPEG_EPOCHS = 2, 64, 32, 2
JPEG_RECIPE = ["--lr", "1e-4", "--warmup", "2"]
# the JPEG decode rates: each mode's decode timed in JPEG_RATE_WINDOWS
# windows, its transform in one, each cycling through the fixtures until
# JPEG_RATE_WINDOW_S seconds have passed
JPEG_RATE_WINDOWS, JPEG_RATE_WINDOW_S = 2, 0.15
SMOKE_DIR = REPO / "_smoke"
TRAINER_PHASE_LIMIT_S = 60.0

# phase 13: the recipe flags on ViT-B-16-SigLIP through the trainer. (a)
# the SigLIP recipe with accumulation and patch dropout, RECIPE_WARMUP +
# RECIPE_STEPS steps at RECIPE_BATCH in RECIPE_ACCUM blocks; (b) LiT at
# LIT_BATCH, each of LIT_RUNS; (c) fp32 parity at RECIPE_PARITY_LAYERS a
# tower and batch RECIPE_PARITY_BATCH. Within RECIPE_PHASE_LIMIT_S.
RECIPE_MODEL = "ViT-B-16-SigLIP"
RECIPE_BATCH, RECIPE_ACCUM, RECIPE_PATCH_DROPOUT = 256, 2, 0.5
RECIPE_WARMUP, RECIPE_STEPS = 2, 5
RECIPE_SIGLIP = [
    "--model", RECIPE_MODEL, "--precision", "pure_bf16", "--batch-size",
    str(RECIPE_BATCH), "--dataset-type", "synthetic", "--train-num-samples",
    str(RECIPE_BATCH * (RECIPE_WARMUP + RECIPE_STEPS)), "--siglip",
    "--accum-freq", str(RECIPE_ACCUM), "--force-patch-dropout",
    str(RECIPE_PATCH_DROPOUT), "--lr", "1e-4", "--warmup", "2",
    "--grad-clip-norm", "1.0", "--log-interval", "1"]
LIT_BATCH, LIT_UNLOCKED = 128, 2
# (b)'s runs: the tower locked, its unlocked groups or layers, the steps
LIT_RUNS = (("image", LIT_UNLOCKED, 3), ("text", 0, 2))


def recipe_lit_argv(tower: str, unlocked: int, steps: int) -> list:
    unlocked_flag = ("--lock-image-unlocked-groups" if tower == "image"
                     else "--lock-text-unlocked-layers")
    return ["--model", RECIPE_MODEL, "--precision", "bf16", "--batch-size",
            str(LIT_BATCH), "--dataset-type", "synthetic",
            "--train-num-samples", str(LIT_BATCH * steps), "--siglip",
            f"--lock-{tower}", unlocked_flag, str(unlocked), "--lr", "1e-3",
            "--warmup", "2", "--grad-clip-norm", "1.0", "--log-interval",
            "1"]
RECIPE_PARITY_LAYERS, RECIPE_PARITY_BATCH = 2, 8
RECIPE_PHASE_LIMIT_S = 60.0

# phase 14: data parallel through torchrun. (a) one rank over NCCL, phase
# 12's synthetic run for DP_WARMUP + DP_STEPS steps; (b) DP_RANKS ranks on
# the one card over gloo, fp32, global batch DP_PARITY_BATCH,
# DP_PARITY_STEPS steps, each run of DP_PARITY_RUNS against one process on
# the card: losses within DP_LOSS_RTOL, parameters within DP_PARAM_RTOL of
# their norms. Scratch under DP_DIR; within DP_PHASE_LIMIT_S.
DP_WARMUP, DP_STEPS = 3, 10
DP_RANKS, DP_PARITY_BATCH, DP_PARITY_STEPS = 2, 32, 3
DP_PARITY_RUNS = {
    "ViT-B-32 clip": ["--model", "ViT-B-32"],
    f"{RECIPE_MODEL} siglip accum patch dropout": [
        "--model", RECIPE_MODEL, "--siglip", "--accum-freq", "2",
        "--force-patch-dropout", "0.5"]}
DP_LOSS_RTOL, DP_PARAM_RTOL = 1e-5, 1e-4
DP_DIR = REPO / "_smoke_dp"
# how long a launch waits for its go or gate file: the script's own limit
DP_GO_TIMEOUT_S = 1200.0
DP_PHASE_LIMIT_S = 60.0

# phase 15: the GPT trainer (`python -m megatron_clip_tpu_torch.pretrain_gpt`)
# in this process. (a) examples/pretrain_gpt_dist.sh's model and recipe at
# full width and depth (GPT_DIST, less GPT_DIST_DROPPED, which need more
# cards), its global batch of 64 in microbatches of GPT_DIST_MICRO, on an
# indexed corpus the phase writes (GPT_CORPUS_DOCS seeded jsonl documents
# of GPT_CORPUS_WORDS words from a seeded vocabulary, through the port's
# tools/preprocess_data.py with GPT_CORPUS_WORKERS workers): GPT_DIST_STEPS
# steps, a save at GPT_DIST_SAVE_AT, the eval at the end, then a run loaded
# from the save for the last step; (b) examples/pretrain_gpt_ladder.sh's
# 1.3b rung (GPT_RUNG) on synthetic data, GPT_RUNG_WARMUP +
# GPT_RUNG_STEPS steps, then one step of the same run with selective
# recompute; (c) GPT_TRAINER_PARITY (fp32, 2 layers at full width, the
# corpus, --micro-batch-size), card against CPU. Scratch under
# GPT_SMOKE_DIR; within GPT_TRAINER_LIMIT_S.
GPT_DIST = [
    "--num-layers", "24", "--hidden-size", "1024", "--num-heads", "16",
    "--seq-length", "2048", "--vocab-size", "50304",
    "--position-embedding", "rope", "--swiglu", "--normalization",
    "rmsnorm", "--batch-size", "64", "--warmup", "2000", "--lr", "3e-4",
    "--weight-decay", "0.1", "--precision", "bf16",
    "--recompute-granularity", "selective", "--fused-ce"]
# the phase's 3 steps take the full rate: the script's 2000 warm-up steps
# would leave the loss where it starts
GPT_DIST_WARMUP = ["--warmup", "1"]
GPT_DIST_DROPPED = ["--tensor-model-parallel-size", "2",
                    "--fsdp-parallel-size", "2", "--sequence-parallel"]
GPT_DIST_MICRO, GPT_DIST_STEPS, GPT_DIST_SAVE_AT = 8, 3, 2
GPT_DIST_EVAL_ITERS = 1
GPT_CORPUS_DOCS, GPT_CORPUS_WORDS, GPT_CORPUS_WORKERS = 1200, (60, 400), 4
GPT_RUNG = [
    "--num-layers", "24", "--hidden-size", "2048", "--num-heads", "16",
    "--seq-length", "2048", "--batch-size", "4", "--recompute-granularity",
    "mlp", "--params-dtype", "bf16", "--nu-dtype", "bf16",
    "--loss-seq-chunk", "512"]
GPT_RUNG_WARMUP, GPT_RUNG_STEPS = 2, 3
GPT_TRAINER_PARITY = [
    "--num-layers", "2", "--hidden-size", "1024", "--num-heads", "16",
    "--seq-length", "256", "--vocab-size", "50304",
    "--position-embedding", "rope", "--swiglu", "--normalization",
    "rmsnorm", "--fused-ce", "--precision", "fp32", "--batch-size", "2",
    "--micro-batch-size", "1", "--train-steps", "2", "--warmup", "1",
    "--lr", "1e-4", "--log-interval", "1"]
# the resumed step's grad norm and the val loss after it, against the
# whole run's: the flash backward adds into dQ in no fixed order (fp32
# ulps of a gradient), which the update carries into the parameters
GPT_RESUME_DRIFT = 1e-3
GPT_SMOKE_DIR = REPO / "_smoke_gpt"
GPT_TRAINER_LIMIT_S = 90.0
GPT_DIST_BATCH = int(GPT_DIST[GPT_DIST.index("--batch-size") + 1])

# phase 16: the GPT trainer over torchrun ranks and the document flags.
# (a) one NCCL rank of `pretrain_gpt` (torchrun, launched before phase 2,
# its timed steps gated) on phase 15 (a)'s model, batch and corpus,
# GPT_DP_STEPS steps, beside phase 15 (a); (b) DP_RANKS gloo ranks on the
# card (NCCL takes one rank a device), GPT_DP_PARITY (fp32, 2 layers at
# full width, S = 256, --micro-batch-size below the batch, the chunked
# loss: the fp32 fused CE adds with atomics) plain and with the document
# flags against one process (DP_LOSS_RTOL, DP_PARAM_RTOL, the ranks
# bit-equal), then the flagged run cut by SIGTERM on rank 1 after step
# GPT_DP_TERM_AFTER with --save and resumed, bit-equal to it left whole;
# (c) the document flags (GPT_DOC_FLAGS; the corpus's EOD is CLIP's
# <|endoftext|>) on pretrain_gpt_dist.sh's model at full width and depth,
# GPT_DOC_BATCH in microbatches of GPT_DOC_MICRO, GPT_DOC_STEPS steps, the
# unfused attention's ms a layer, and fp32 card against CPU. Scratch under
# GPT_DP_DIR (phase 15's corpus too); within GPT_DP_LIMIT_S.
CLIP_EOD = 49407
GPT_DOC_FLAGS = ["--eod-token", str(CLIP_EOD), "--eod-mask-loss",
                 "--reset-position-ids", "--reset-attention-mask"]
GPT_DP_STEPS, GPT_DP_PARITY_STEPS, GPT_DP_TERM_AFTER = 3, 2, 1
GPT_DP_PARITY = [a for a in GPT_TRAINER_PARITY if a != "--fused-ce"]
for _flag, _value in (("--batch-size", "4"), ("--micro-batch-size", "2"),
                      ("--train-steps", str(GPT_DP_PARITY_STEPS))):
    GPT_DP_PARITY[GPT_DP_PARITY.index(_flag) + 1] = _value
GPT_DOC_BATCH, GPT_DOC_MICRO, GPT_DOC_STEPS = 8, 8, 2
# (c)'s fp32 card-against-CPU run: phase 15 (c)'s, with the flags, at a
# batch of one row (the accumulation is (b)'s to check; the CPU's plain
# fused CE over 50304 entries is most of the phase's host time)
GPT_DOC_PARITY = GPT_DOC_FLAGS + ["--batch-size", "1", "--micro-batch-size",
                                  "1"]
# (c)'s fp32 card-against-CPU run with the flags: losses, grad norms and
# gradients under phase 15 (c)'s bounds; its parameters after two Adam
# steps within GPT_DOC_PARAM_RTOL of their norms, the CPU tests' bound on
# Adam steps (tests/test_torch_gpt.py): an element whose gradient sits at
# rounding level moves by up to lr either way, and the loss mask leaves
# more of them in the zero-initialised biases (on an H100, 700 W: 1.01e-4
# and 1.07e-4 of blocks.0.mlp.b1's norm, its gradients within 4.3e-6 of
# theirs)
GPT_DOC_PARAM_RTOL = 1e-3
GPT_DP_DIR = REPO / "_smoke_gpt_dp"
GPT_DP_LIMIT_S = 60.0

# phase 17: tensor parallelism with sequence parallelism and FSDP, over
# torchrun ranks on the one card over gloo (NCCL takes one rank a device),
# launched before phase 2 and waiting for `go`. (a) TP_RANKS ranks at
# pretrain_gpt_dist.sh's layout (GPT_DIST_DROPPED: tp2 x fsdp2, sequence
# parallelism) on its model at full width (GPT_DIST: bf16 compute on fp32
# weights, the fused CE, selective recompute), TP_LAYERS layers, TP_BATCH
# rows in microbatches of TP_MICRO, TP_STEPS steps on the synthetic stream,
# plain and (one step) with --attention-dropout 0.1, each against one
# process of the same run on the card: losses within TP_LOSS_RTOL, grad
# norms within TP_NORM_RTOL, at most TP_FAR_SHARE of the parameters'
# elements more than the learning rate apart from the one process's (bf16
# products reduced in another order flip the sign of gradients at rounding
# level, and Adam's first steps move such an element by about lr either
# way: the distance between the runs' parameters was 5.4e-2 of the distance
# the steps moved them on an H100 at 700 W, over the 5e-2 first set for
# it). The bounds are set from readings on an H100 at 700 W (PERF.md §6,
# `--tp-faults`): sound runs read losses within 1.1e-5, grad norms within
# 1.6e-4 and 0.13-0.17% of the elements lr apart; of the planted faults
# (TP_FAULTS), attention dropout at tensor rank 0's heads
# read 5.7e-5, 7.3e-4 and 5.0%, the partial gradients left unsummed over
# the tensor ranks 2.3e-5, 3.7e-2 (and ranks no longer bit-equal), the
# embedding's gradient doubled 1.8e-6, 0.24 and 0.16%; the norm gains
# counted once a replica in the norm (3.5e-4) pass, and the CPU tests'
# grad norms (within 1e-5) hold them. Each rank's launches those of one
# process's step (the same kernels at the rank's shapes: 8 heads, S/2 norm
# rows, the fused CE on its rows), its parameter and moment bytes at most
# TP_STATE_SHARE of one process's, its peak memory. (The fp32 layout
# against one process is the CPU tests', tests/test_torch_tp_fsdp.py: on
# the card it read losses within 8.7e-8 and the parameters 5.9e-5 of their
# displacement apart, and took a fifth of the phase.) (b) CLIP_FSDP_RANKS ranks at --fsdp-parallel-size 2 on
# ViT-B-16, fp32, CLIP_FSDP_BATCH rows, CLIP_FSDP_STEPS steps, gated until
# (a) ends, against one process: losses within DP_LOSS_RTOL, each rank's
# shards within DP_PARAM_RTOL of the one process's, its bytes at most
# CLIP_FSDP_SHARE. Scratch under TP_DIR; within TP_LIMIT_S.
# (one microbatch a step, and one step with dropout: the phase read 29-45 s
# of its 60 over hosts with two microbatches and two steps each, its ranks'
# collectives staged through the host)
TP_RANKS, TP_LAYERS, TP_BATCH, TP_MICRO, TP_STEPS = 4, 2, 4, 4, 2
TP_LOSS_RTOL, TP_NORM_RTOL, TP_FAR_SHARE = 5e-5, 1e-3, 1e-2
TP_STATE_SHARE, CLIP_FSDP_SHARE = 0.26, 0.51
TP_GPT = [a for a in GPT_DIST] + GPT_DIST_WARMUP + GPT_DIST_DROPPED + [
    "--log-interval", "1"]
for _flag, _value in (("--num-layers", str(TP_LAYERS)),
                      ("--batch-size", str(TP_BATCH))):
    TP_GPT[TP_GPT.index(_flag) + 1] = _value
TP_GPT += ["--micro-batch-size", str(TP_MICRO), "--train-steps",
           str(TP_STEPS)]
CLIP_FSDP_RANKS, CLIP_FSDP_BATCH, CLIP_FSDP_STEPS = 2, 8, 2
CLIP_FSDP = ["--model", "ViT-B-16", "--precision", "fp32", "--batch-size",
             str(CLIP_FSDP_BATCH), "--dataset-type", "synthetic",
             "--train-num-samples", str(CLIP_FSDP_BATCH * CLIP_FSDP_STEPS),
             "--lr", "1e-4", "--warmup", "1", "--grad-clip-norm", "1.0",
             "--log-interval", "1"]
TP_DIR = REPO / "_smoke_tp"
TP_LIMIT_S = 60.0
# (a)'s planted faults, run by `python3 chip_smoke.py --tp-faults` (not in
# the script's run): each a job of the ranks beside the job it spoils, read
# against that job's one process as the job itself is; the readings that
# set TP_LOSS_RTOL and TP_NORM_RTOL (PERF.md). name: (the job it spoils,
# what goes wrong)
TP_FAULTS = {
    "fault_placement": ("bf16 dropout", "each rank's attention dropout "
                        "draws the heads of tensor rank 0"),
    "fault_partial_sum": ("bf16", "the leaves a tensor rank holds a "
                          "partial gradient of (the norm gains, the "
                          "row-parallel biases) not summed over the "
                          "tensor ranks"),
    "fault_norm_weight": ("bf16", "each replica of a norm gain counted in "
                          "the global norm"),
    "fault_embed_twice": ("bf16", "the embedding's gradient summed twice")}


# phase 18: GPT text generation through the server tool
# (megatron_clip_tpu_torch.tools.run_text_generation_server, each server a
# `chip_smoke.py --gpt-serve-worker SPEC` process, made before phase 2 and
# building its service at `go`): (a) GPT-345m (GPT_345M, pretrain_gpt's
# defaults: learned positions, LayerNorm, gelu, biases, the tied
# embedding; bf16 compute on fp32 weights from seed 0, `serving_model`)
# answering GEN_REQUESTS; (b) examples/pretrain_gpt_dist.sh's model
# (GPT_DIST) from phase 15 (a)'s checkpoint, GEN_EXAMPLE_REQUESTS; (c)
# GEN_FP32 (GPT-345m at 2 layers, fp32) on the card against the CPU in
# this process; (d) GEN_TP_RANKS gloo ranks of the server at tp 2 on the
# one card, on (c)'s weights, against (c)'s card. Scratch under GEN_DIR;
# within GEN_LIMIT_S.
GEN_345M = ["--num-layers", str(GPT_345M["num_layers"]), "--hidden-size",
              str(GPT_345M["hidden_size"]), "--num-heads",
              str(GPT_345M["num_heads"]), "--seq-length", "2048",
              "--vocab-size", str(GPT_345M["vocab_size"])]
GEN_FP32 = [a for a in GEN_345M] + ["--precision", "fp32"]
GEN_FP32[GEN_FP32.index("--num-layers") + 1] = "2"
GEN_TP_RANKS = 2
GEN_TP_PLACE = ["--device", "cuda:0", "--dist-backend", "gloo"]
# the CLIP BPE's ids; past them, the vocabulary's padding rows
CLIP_BPE_VOCAB, GEN_PAD_ROW = 49408, -0.02
# 8 prompts of 1 to 14 CLIP BPE tokens: one prompt bucket of 16
GEN_PROMPTS = [
    "a photo of a dog on the beach at sunset with a red ball",
    "the old map", "an oil painting of a lighthouse in a storm",
    "two cats", "a diagram of the human heart with labels",
    "street food in bangkok at night", "hello",
    "a close up photo of a green leaf with water drops"]
GEN_NEW = 128
GEN_REQUESTS = {
    "greedy8": {"prompts": GEN_PROMPTS, "tokens_to_generate": GEN_NEW,
                "temperature": 0.0, "logprobs": True},
    "greedy1": {"prompts": GEN_PROMPTS[:1],
                "tokens_to_generate": GEN_NEW, "temperature": 0.0},
    "top_k": {"prompts": GEN_PROMPTS[:4], "tokens_to_generate": 32,
              "temperature": 1.0, "top_k": 40, "random_seed": 1},
    "top_p": {"prompts": GEN_PROMPTS[:4], "tokens_to_generate": 32,
              "temperature": 1.0, "top_p": 0.9, "top_p_decay": 0.98,
              "top_p_bound": 0.5, "random_seed": 2},
    "beam": {"prompts": GEN_PROMPTS[2:3], "tokens_to_generate": 16,
             "beam_width": 4},
    "stop_on_eol": {"prompts": GEN_PROMPTS[:2], "tokens_to_generate": 16,
                    "temperature": 0.0, "stop_on_eol": True}}
# (b) answers prompts of its corpus's words (`corpus_prompts`): on the
# English prompts above, this model barely trained turns the rounding of
# one row's bf16 K and V into logits 1.75 apart in fp32 (PERF.md §6)
GEN_EXAMPLE_REQUESTS = {
    "greedy8": dict(GEN_REQUESTS["greedy8"], tokens_to_generate=32),
    "top_k": dict(GEN_REQUESTS["top_k"], tokens_to_generate=16,
                  random_seed=3)}
GEN_FP32_REQUEST = {"prompts": GEN_PROMPTS, "tokens_to_generate": 32,
                      "temperature": 0.0, "logprobs": True}
# the norms' serving rows at W = 1024: B = 8 and 1 a step, B P at prefill
GEN_NORM_ROWS = (8, 1, 128, 16)
GEN_TIMED_STEPS, GEN_PROFILED_STEPS = 10, 3
# the planted off-by-one position's decode steps
GEN_TEETH_STEPS = 16
# the teacher-forced decode's logits against the forward's, and the
# served log-probabilities against the forward's log_softmax, bf16 (PERF.md
# phase 18: the readings and the planted off-by-one position)
GEN_LOGIT_TOL, GEN_LOGPROB_TOL = 0.2, 0.2
# (c) and (d), fp32: the cache is bf16 on every device, as the JAX
# package makes it, so an fp32 ulp between the two sides' K or V can
# round to bf16 an ulp apart (2^-8); readings 7.9e-5 and 1.2e-4 (PERF.md
# §6), and with fp32 caches the card and the CPU agree closer (printed)
GEN_CPU_LOGPROB_TOL = GEN_TP_LOGPROB_TOL = 5e-4
GEN_DIR = REPO / "_smoke_serve"
GEN_LIMIT_S = 60.0
GEN_GO_TIMEOUT_S, GEN_READY_TIMEOUT_S, GEN_HTTP_TIMEOUT_S = (
    1200.0, 45.0, 60.0)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print `msg`; a phase's header ("[n] ...") with the seconds since
    the script started."""
    if msg.startswith("["):
        msg = f"{msg} (at {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, atol_of_max: float = 0.0) -> float:
    """Raise unless |got - want| <= atol + atol_of_max*max|want| +
    rtol*|want| everywhere; returns the largest absolute difference."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    atol = atol + atol_of_max * float(want.abs().max())
    err = (got - want).abs()
    worst = float(err.max())
    tol = atol + rtol * want.abs()
    excess = float((err - tol).max())
    used = float((err / tol).nan_to_num(nan=0.0).max())
    log(f"  {label}: max_abs_err={worst:.3e} (atol {atol:g}, rtol {rtol:g}; "
        f"{used:.3f} of the tolerance)")
    if excess > 0:
        raise AssertionError(f"{label}: max_abs_err {worst:.3e} exceeds the "
                             "tolerance")
    return worst


def rows_used(got: torch.Tensor, want: torch.Tensor, rel: float,
              floor: float) -> float:
    """The share of the row bound that the worst row uses: the largest,
    over rows r (the last axis: one query's dQ, one key's dK or dV), of
    ||got_r - want_r|| / (rel ||want_r|| + floor rms), where rms is the
    root mean square of the rows' norms."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    norms = want.norm(dim=-1)
    rms = float(norms.square().mean().sqrt())
    return float(((got - want).norm(dim=-1)
                  / (rel * norms + floor * rms)).max())


def compare_rows(label: str, got: torch.Tensor, want: torch.Tensor,
                 rel: float, floor: float) -> float:
    """Raise unless every row of `got` is within `rel` of its own norm plus
    `floor` of the rms row norm of `want` (rows_used <= 1); returns the
    largest absolute difference. CPU tensors are held by the same rule."""
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    used = rows_used(got, want, rel, floor)
    worst = float((got.float() - want.float()).abs().max())
    log(f"  {label}: max_abs_err={worst:.3e} (rows: rel {rel:g}, floor "
        f"{floor:g} of the rms row; {used:.3f} of the tolerance)")
    if used > 1:
        raise AssertionError(f"{label}: a row exceeds the tolerance")
    return worst


# cycles of the device-side wait that cuda_ms queues before its window
# (about 2 ms on an H100): the host enqueues the window's calls meanwhile
QUEUE_CYCLES = 4_000_000


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `reps` calls.
    The window starts behind a device-side wait long enough for the host to
    enqueue every call, so that the calls run back to back: a call whose
    host side (wrapper, allocations, launch) takes longer than its kernels
    is timed by its kernels, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mha_cost(b: int, s: int, h: int, d: int, causal: bool, itemsize: int,
             with_probs: bool = False, with_stats: bool = False):
    """Bytes: qkv read once, output written once, and with_probs P [B, H,
    S, S] or with_stats the fp32 row max and sum written once. Operations:
    the QK^T and PV multiply-adds over the (query, key) pairs the mask
    keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = b * s * 4 * h * d * itemsize
    if with_probs:
        nbytes += b * h * s * s * itemsize
    if with_stats:
        nbytes += b * h * s * 8
    return nbytes, 4 * b * h * d * pairs


def mha_bwd_cost(b: int, s: int, h: int, d: int, causal: bool,
                 itemsize: int, recompute: bool = False):
    """Bytes: qkv, dO and P (recompute: the fp32 row max and sum instead)
    read once, dqkv written once. Operations: the dV = P^T dO, dP = dO V^T,
    dQ = dS K and dK = dS^T Q multiply-adds over the kept pairs, 8 D per
    pair, and for the recompute S = Q K^T too, 10 D per pair."""
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = b * s * 7 * h * d * itemsize
    nbytes += b * h * s * 8 if recompute else b * h * s * s * itemsize
    return nbytes, (10 if recompute else 8) * b * h * d * pairs


def flash_cost(b: int, h: int, sq: int, sk: int, d: int, causal: bool,
               itemsize: int, products: int = 2, q_side: int = 2,
               k_side: int = 2, rows: int = 1):
    """Bytes: each [B, H, S, D] operand read or written once, `q_side` of
    them with Sq rows (q, out, dO, dq) and `k_side` with Sk (k, v, dk, dv),
    plus `rows` fp32 [B, H, Sq] vectors (lse, delta). Operations: the JAX
    kernel's `products` matrix products, each 2 Sq Sk D per head, halved
    under the causal mask (forward 2, fused backward 5, dQ 3, dKV 4)."""
    nbytes = b * h * ((q_side * sq + k_side * sk) * d * itemsize
                      + rows * sq * 4)
    ops = products * 2 * b * h * sq * sk * d
    return nbytes, ops // 2 if causal else ops


def flash_bwd_cost(kind: str, b: int, h: int, sq: int, sk: int, d: int,
                   causal: bool, itemsize: int):
    """flash_cost of a backward wrapper: fused reads q, k, v, out, dO and
    lse and writes dq, dk, dv (5 products); dq reads q, k, v, dO, lse and
    delta and writes dq (3); dkv reads the same and writes dk, dv (4)."""
    products, q_side, k_side, rows = {"fused": (5, 4, 4, 1),
                                      "dq": (3, 3, 2, 2),
                                      "dkv": (4, 2, 4, 2)}[kind]
    return flash_cost(b, h, sq, sk, d, causal, itemsize, products, q_side,
                      k_side, rows)


def ln_cost(rows: int, w: int, itemsize: int):
    """Bytes: x read and y written once, fp32 scale and bias read once.
    Operations: ~8 fp32 operations per element (mean, centring, variance,
    normalise, scale, shift)."""
    return 2 * rows * w * itemsize + 2 * w * 4, 8 * rows * w


def ln_bwd_cost(rows: int, w: int, itemsize: int, param_itemsize: int = 4):
    """Bytes: x and dy read and dx written once, scale read and dscale,
    dbias written once in the parameters' dtype. Operations: ~16 fp32
    operations per element (the statistics, xhat, the two row sums and two
    column sums, dx)."""
    return 3 * rows * w * itemsize + 3 * w * param_itemsize, 16 * rows * w


def rms_cost(rows: int, w: int, itemsize: int):
    """Bytes: x read and y written once, the fp32 scale read once.
    Operations: ~4 fp32 operations per element (square, sum, normalise,
    scale)."""
    return 2 * rows * w * itemsize + w * 4, 4 * rows * w


def rms_bwd_cost(rows: int, w: int, itemsize: int, param_itemsize: int = 4):
    """Bytes: x and dy read and dx written once, the scale read and dscale
    written once in its dtype. Operations: ~10 fp32 operations per element
    (the statistic, xhat, the row sum, the column sum, dx)."""
    return 3 * rows * w * itemsize + 2 * w * param_itemsize, 10 * rows * w


def ce_cost(t: int, w: int, v: int, itemsize: int, backward: bool = False):
    """Bytes: x [T, W] and the head [W, V] read once, int64 labels read
    once; the forward writes loss and lse (fp32), the backward reads lse and
    dloss and writes dX and dW in the inputs' dtype. Operations: 2 T W V per
    contraction: the forward's logits; the backward's logits again, dX and
    dW, which the function needs since only lse is given."""
    nbytes = (t + v) * w * itemsize + 8 * t + 8 * t
    if backward:
        nbytes += (t + v) * w * itemsize
    return nbytes, (3 if backward else 1) * 2 * t * w * v


def kernel_fns(mha, ln) -> dict:
    """Every kernel wrapper, by kernel name; each counts its launches."""
    from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    return {"fused_mha_fwd": mha.fused_mha_fwd,
            "fused_mha_bwd": mha.fused_mha_bwd,
            "fused_mha_bwd_recompute": mha.fused_mha_bwd_recompute,
            "layer_norm_fwd": ln.layer_norm_fwd,
            "layer_norm_bwd": ln.layer_norm_bwd,
            "flash_fwd": fa.flash_fwd,
            "flash_bwd_fused": fa.flash_bwd_fused,
            "flash_bwd_dq": fa.flash_bwd_dq,
            "flash_bwd_dkv": fa.flash_bwd_dkv,
            "rms_norm_fwd": ln.rms_norm_fwd,
            "rms_norm_bwd": ln.rms_norm_bwd,
            "fused_ce_fwd": ce.fused_ce_fwd,
            "fused_ce_bwd": ce.fused_ce_bwd,
            "flash_fwd_dropout": fa.flash_fwd_dropout,
            "flash_bwd_fused_dropout": fa.flash_bwd_fused_dropout,
            "flash_bwd_dq_dropout": fa.flash_bwd_dq_dropout,
            "flash_bwd_dkv_dropout": fa.flash_bwd_dkv_dropout,
            "fused_mha_dropout_fwd": mha.fused_mha_dropout_fwd,
            "fused_mha_dropout_bwd": mha.fused_mha_dropout_bwd}


def zero_counts(mha, ln) -> None:
    for fn in kernel_fns(mha, ln).values():
        fn.launches = 0


def read_counts(mha, ln) -> dict:
    return {name: fn.launches for name, fn in kernel_fns(mha, ln).items()}


def phase_build(kernels_build):
    """Build every kernel, then log each one's registers and spills from
    ptxas's report, its name demangled by the CUDA toolkit's cu++filt."""
    log("[2] build")
    t0 = time.perf_counter()
    faults = [(name, fault) for name in ("flash_attention", "fused_mha")
              for fault in tuple((f,) for f in DROPOUT_FAULTS) + TILE_FAULTS]
    faults += [("layernorm", (fault,)) for fault in LN_BWD_FAULTS]
    took = kernels_build.build(list(kernels_build.SOURCES) + faults
                               + list(kernels_build.HOST_SOURCES))
    log(f"  built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in took.items()})})")
    demangle = Path(kernels_build._nvcc()).with_name("cu++filt")
    for name in kernels_build.SOURCES:
        report, kernel, spill = [], None, ""
        notes = {}  # ptxas's wgmma notes (C75xx) by kernel: code -> count
        for line in kernels_build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            note = re.search(r"\((C75\d\d)\).*function '(\w+)'", line)
            used = re.search(r"Used (\d+) registers", line)
            if m:
                kernel = m.group(1)
            elif note:
                codes = notes.setdefault(note.group(2), {})
                codes[note.group(1)] = codes.get(note.group(1), 0) + 1
            elif "spill stores" in line:
                spill = line.strip()
            elif used:
                report.append((kernel, f"{used.group(1)} registers, {spill}"))
        names = subprocess.run(
            [str(demangle), "-p", *(k for k, _ in report)],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.splitlines()
        for label, (kernel, regs) in zip(names, report):
            label = label.replace("<unnamed>::", "")
            extra = (f"; ptxas notes {json.dumps(notes[kernel])}"
                     if kernel in notes else "")
            log(f"  {name} {label}: {regs}{extra}")


# (atol, rtol[, atol as a share of max|want|]) of each comparison, by
# kernel: the kernel against its plain version on the same inputs, fp32 and
# bf16, and the bf16 kernel against the plain version run in fp32 on the
# same bf16 inputs. In bf16 the plain versions round where the kernels round
# (the attention probabilities before P.V, dS before dS.K and dS^T.Q, every
# output), so a forward must agree within one bf16 ulp; against fp32 the
# bf16 roundings themselves are allowed for.
# - fused_mha_bwd fp32: 2e-4, as tests/test_fused_mha.py holds the TPU
#   kernel's gradients. bf16: the kernel sums dP in another order than the
#   plain version, so a dS near a rounding boundary can round the other way,
#   which moves one term of dQ or dK by 2^-8 |dS K|: two bf16 ulps (rtol
#   1.6e-2) plus 2^-7 of the largest |gradient|; against fp32 the roundings
#   of P, dS and the outputs, 2e-2 relative plus 2^-5 of the largest. In
#   bf16 also row by row ("rows": one query's dQ, one key's dK or dV of one
#   head; compare_rows), as the flash gradients and for their reasons: under
#   the causal mask the first keys' gradients are 100x the typical one's,
#   so the largest-value floor alone would let a fault through in most
#   rows; a dS rounded the other way moves one term of a row by an ulp of
#   it, under 1e-2 of the row: 1e-2 of the row's norm plus 1e-4 of the rms
#   row norm, 2e-2 against the fp32 plain version (the roundings of dS
#   themselves). The same (rel, floor) as the recompute rows below.
# - fused_mha_bwd_recompute: the same bounds and reasons; its P is fp32 on
#   both sides, rounded only for dV, where a flip moves one term by an ulp.
#   In bf16 also row by row, as the saved-P rows. bwd_teeth shows what a
#   wrong kernel reads.
# - fused_mha_fwd stats, each row's max scaled score and softmax sum: fp32
#   sums of up to 1,024 exponentials in another order than the plain
#   version's, rescaled once per key tile (128 keys on wgmma, 64 on
#   mma.sync), the wgmma kernel's on exp2: 1e-4 relative plus 1e-5.
# - fused_mha_fwd rows, the bf16 forward's output (and its dropout twin's)
#   row by row: each element within fused_mha_row_bound (ops/kernels/
#   fused_mha.py), one bf16 ulp of P on every term of its row, sum_j
#   ulp(P_ij) |v_jc|, plus one output ulp, since kernel and plain version
#   round P to bf16 from fp32 values that differ in their last bits and a P
#   that rounds the other way moves its term by an ulp of it (at p ~ 1/2
#   against |v| > 2 past the elementwise bound's 4e-3 + 8e-3 |out|, which
#   is kept beside it). The value here is the share of that bound allowed.
# - fused_mha_fwd P, the saved probabilities: relative, as P's typical
#   value is 1/S. fp32: 1e-5 (the scores' fp32 rounding, carried by exp)
#   plus 1e-7. bf16: both sides round the same fp32 softmax to bf16, so
#   where their fp32 values straddle a rounding boundary they differ by one
#   bf16 ulp, at most 2^-7 = 7.8e-3 of the value; against fp32 the rounding
#   itself, half an ulp. Both held to rtol 8e-3 plus 1e-6.
# - layer_norm_bwd: dx as the forward's output; dscale and dbias are fp32
#   sums over up to 29,568 rows in another order than the plain version's.
#   Their rounding error follows the partial sums, not the result, so a
#   column whose sum is near 0 can be off by ulps of its neighbours'
#   hundreds: 1e-4 absolute plus 2e-6 of the largest |sum| (~16 fp32 ulps
#   of it) plus 1e-5 relative.
# - flash_fwd fp32: 2e-5, as tests/test_flash_attention.py holds the TPU
#   kernel. bf16: the kernel rounds P per key tile (128 keys on wgmma at
#   D = 64 and 128, 64 on mma.sync) against the running max, the plain
#   version once against the row's max, so each term of P.V
#   can differ by one bf16 ulp of its P, with signs that do not line up:
#   2^-8 of the largest |out| plus one ulp of the output (rtol 8e-3).
# - flash_fwd lse: fp32 sums of up to 8,192 exponentials in another order:
#   1e-5 absolute plus 1e-5 relative.
# - flash_bwd_*: fp32 5e-5, as tests/test_flash_attention.py holds the TPU
#   kernels' gradients. bf16: dQ, dK and dV each row by row (one query's
#   dQ, one key's dK or dV), since under the causal mask the first keys'
#   gradients are 100x the typical one's, so a bound scaled by the largest
#   |value| would hide a fault in most rows: each row's error norm within
#   1e-2 of the row's norm plus 1e-4 of the rms row norm (compare_rows). A
#   dS or P rounded the other way moves one term of a row by an ulp of it,
#   an output rounded the other way one element by an ulp: at most 2^-7 of
#   the term or element, under 1e-2 of the row (at most 0.61 of the bound
#   measured, in dV; NVIDIA H100 80GB HBM3, 700.00 W). The floor takes rows
#   whose value is fp32 noise (the first query's dQ, dS = P (dP - delta)
#   with dP = delta). Against fp32, the roundings of P and dS themselves
#   (2^-9 each, random): 2e-2. The fused kernel's unordered fp32 adds into
#   dQ (TMA reduce-adds at D = 64 and 128, atomics at other D) move it by
#   fp32 ulps only. flash_bwd_teeth shows what a wrong kernel reads.
# - rms_norm_*: as layer_norm_*, whose kernels they are without the mean and
#   the bias (dscale the only column sum).
# - fused_ce_fwd loss and lse: the logits are fp32 sums of W exact products
#   (a bf16 product is exact in fp32) in another order than the plain
#   version's cuBLAS product, and the softmax sum of up to 50,304
#   exponentials is folded per 64-column partial: 1e-5 absolute plus 2e-5
#   relative. The bf16 kernel forms each exponential with the MUFU's
#   ex2.approx (2 ulps) of one FMA, logit log2(e) - m log2(e), whose
#   rounded argument moves a term by ln 2 ulps of the argument: under 3e-6
#   of the term for any term above 2^-64 of the row's largest, so inside
#   the same bound. The same for bf16 inputs and against the plain version
#   run in fp32 on them, whose logits are the same fp32 sums.
# - fused_ce_bwd fp32 (the CUDA-core kernel): dX sums V terms and dW T
#   terms, added with atomics per 64-row tile in an order that changes from
#   run to run: 1e-5 relative plus 5e-5 of the largest |value|. bf16 (the
#   wgmma products, deterministic): dX and dW^T row by row (one
#   token's dX, one vocabulary row's dW) as the flash gradients, 1e-2 of
#   the row's norm plus 1e-4 of the rms row: dlogits are rounded to bf16 on
#   both sides from fp32 logits summed in another order, so one can round
#   the other way (an ulp of one term), and each output is rounded once.
#   Against the plain version in fp32, which does not round dlogits, those
#   roundings themselves (2^-9 relative each, random): 2e-2.
#   fused_ce_teeth shows what a wrong kernel reads.
TOLERANCES = {
    "fused_mha_fwd": {"fp32": (2e-5, 0.0), "bf16": (4e-3, 8e-3),
                      "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "fused_mha_fwd P": {"fp32": (1e-7, 1e-5), "bf16": (1e-6, 8e-3),
                        "bf16_vs_fp32_plain": (1e-6, 8e-3)},
    "fused_mha_fwd stats": {"fp32": (1e-5, 1e-4), "bf16": (1e-5, 1e-4),
                            "bf16_vs_fp32_plain": (1e-5, 1e-4)},
    "fused_mha_fwd rows": {"bf16": 1.0},
    "fused_mha_bwd": {"fp32": (2e-4, 2e-4), "bf16": (0.0, 1.6e-2, 2 ** -7),
                      "bf16_vs_fp32_plain": (0.0, 2e-2, 2 ** -5)},
    # bf16 saved-P gradients: (rel, floor) of compare_rows
    "fused_mha_bwd rows": {"bf16": (1e-2, 1e-4),
                           "bf16_vs_fp32_plain": (2e-2, 1e-4)},
    "fused_mha_bwd_recompute": {
        "fp32": (2e-4, 2e-4), "bf16": (0.0, 1.6e-2, 2 ** -7),
        "bf16_vs_fp32_plain": (0.0, 2e-2, 2 ** -5)},
    # bf16 recompute gradients: (rel, floor) of compare_rows
    "fused_mha_bwd_recompute rows": {"bf16": (1e-2, 1e-4),
                                     "bf16_vs_fp32_plain": (2e-2, 1e-4)},
    "layer_norm_fwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                       "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "layer_norm_bwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                       "bf16_vs_fp32_plain": (2e-2, 2e-2),
                       "sums": (1e-4, 1e-5, 2e-6)},
    "flash_fwd": {"fp32": (2e-5, 2e-5), "bf16": (0.0, 8e-3, 2 ** -8),
                  "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "flash_fwd lse": {"fp32": (1e-5, 1e-5), "bf16": (1e-5, 1e-5),
                      "bf16_vs_fp32_plain": (1e-5, 1e-5)},
    # bf16 flash gradients: (rel, floor) of compare_rows
    **{name: {"fp32": (5e-5, 5e-5), "bf16": (1e-2, 1e-4),
              "bf16_vs_fp32_plain": (2e-2, 1e-4)}
       for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")},
    "rms_norm_fwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                     "bf16_vs_fp32_plain": (2e-2, 2e-2)},
    "rms_norm_bwd": {"fp32": (1e-5, 1e-5), "bf16": (4e-3, 8e-3),
                     "bf16_vs_fp32_plain": (2e-2, 2e-2),
                     "sums": (1e-4, 1e-5, 2e-6)},
    "fused_ce_fwd": {kind: (1e-5, 2e-5) for kind in (
        "fp32", "bf16", "bf16_vs_fp32_plain")},
    "fused_ce_fwd lse": {kind: (1e-5, 2e-5) for kind in (
        "fp32", "bf16", "bf16_vs_fp32_plain")},
    # fp32 (atol, rtol, atol as a share of max); bf16 (rel, floor) of
    # compare_rows
    "fused_ce_bwd": {"fp32": (0.0, 1e-5, 5e-5), "bf16": (1e-2, 1e-4),
                     "bf16_vs_fp32_plain": (2e-2, 1e-4)},
}
# The dropout kernels, against their plain versions fed the same Philox
# multipliers: the bounds of their rate-0 kernels, for the same reasons (a
# kept probability is scaled by a multiplier both sides hold exactly:
# fp32 1/(1 - rate) for flash, bf16(1/(1 - rate)) = 1.109375 for the fused
# route in bf16; a dropped one is 0 on both).
TOLERANCES.update({
    "flash_fwd_dropout": TOLERANCES["flash_fwd"],
    "flash_fwd_dropout lse": TOLERANCES["flash_fwd lse"],
    **{f"{name}_dropout": TOLERANCES[name]
       for name in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")},
    "fused_mha_dropout_fwd": TOLERANCES["fused_mha_fwd"],
    "fused_mha_dropout_fwd stats": TOLERANCES["fused_mha_fwd stats"],
    "fused_mha_dropout_fwd rows": TOLERANCES["fused_mha_fwd rows"],
    "fused_mha_dropout_bwd": TOLERANCES["fused_mha_bwd_recompute"],
    "fused_mha_dropout_bwd rows": TOLERANCES["fused_mha_bwd_recompute rows"],
})
KERNELS = tuple(TOLERANCES)


def check_kernel(errs: dict, name: str, label: str, got: torch.Tensor,
                 plain, dtype=None) -> None:
    """Hold `got` against plain(inputs in their dtype, `dtype`, by default
    got's) and, for bf16, also against plain(inputs in fp32); keep the
    worst error of each kind."""
    key = "bf16" if (dtype or got.dtype) == torch.bfloat16 else "fp32"
    checks = [(key, plain(got.dtype))]
    if key == "bf16":
        checks.append(("bf16_vs_fp32_plain", plain(torch.float32)))
    for kind, want in checks:
        e = compare(f"{name} {label} {kind}", got, want,
                    *TOLERANCES[name][kind])
        errs[name][kind] = max(errs[name].get(kind, 0.0), e)


def check_grads(errs: dict, name: str, label: str, got: tuple,
                plain) -> None:
    """The gradients `got` (dq; dk, dv; or dq, dk, dv) against plain(dtype):
    in fp32 as check_kernel, in bf16 each tensor row by row
    (compare_rows)."""
    if got[0].dtype == torch.float32:
        check_kernel(errs, name, label, torch.cat([g.flatten() for g in got]),
                     lambda dt: torch.cat([w.flatten() for w in plain(dt)]))
        return
    parts = {1: ("dq",), 2: ("dk", "dv"), 3: ("dq", "dk", "dv")}[len(got)]
    for kind, dt in (("bf16", torch.bfloat16),
                     ("bf16_vs_fp32_plain", torch.float32)):
        for part, g, w in zip(parts, got, plain(dt)):
            e = compare_rows(f"{name} {label} {kind} {part}", g, w,
                             *TOLERANCES[name][kind])
            errs[name][kind] = max(errs[name].get(kind, 0.0), e)


def mha_parts(dqkv: torch.Tensor, heads: int):
    """A packed gradient [B, S, 3*H*D] as (dq, dk, dv), each [B, S, H, D]:
    rows of one query's dQ, one key's dK or dV of one head."""
    b, s, w = dqkv.shape
    return dqkv.reshape(b, s, 3, heads, w // (3 * heads)).unbind(2)


def check_mha_rows(errs: dict, name: str, label: str, got: torch.Tensor,
                   plain, heads: int) -> None:
    """A bf16 packed gradient against plain(dtype) row by row
    (compare_rows, TOLERANCES[name + " rows"]), dq, dk and dv each."""
    key = f"{name} rows"
    for kind, dt in (("bf16", torch.bfloat16),
                     ("bf16_vs_fp32_plain", torch.float32)):
        for part, g, w in zip(("dq", "dk", "dv"), mha_parts(got, heads),
                              mha_parts(plain(dt), heads)):
            e = compare_rows(f"{name} {label} {kind} {part}", g, w,
                             *TOLERANCES[key][kind])
            errs[key][kind] = max(errs[key].get(kind, 0.0), e)


def fwd_rows_used(got: torch.Tensor, want: torch.Tensor,
                  bound: torch.Tensor) -> float:
    """The share of the forward's row bound (fused_mha_row_bound) that the
    worst element of `got` uses."""
    err = (got.float() - want.float()).abs()
    return float((err / bound).nan_to_num(nan=0.0, posinf=1e9).max())


def check_fwd_rows(errs: dict, name: str, label: str, got: torch.Tensor,
                   want: torch.Tensor, bound: torch.Tensor) -> None:
    """A bf16 forward's output against the plain version's `want` row by
    row: every element within `bound` (fused_mha_row_bound of the same
    inputs) times TOLERANCES[name + " rows"]."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {label}: non-finite values")
    key = f"{name} rows"
    used = fwd_rows_used(got, want, bound) / TOLERANCES[key]["bf16"]
    worst = float((got.float() - want.float()).abs().max())
    log(f"  {name} {label} bf16 rows: max_abs_err={worst:.3e} ({used:.3f} "
        "of the row bound)")
    if used > 1:
        raise AssertionError(f"{name} {label}: an output exceeds its row "
                             "bound")
    errs[key]["bf16"] = max(errs[key].get("bf16", 0.0), worst)


# where phase 3 also checks that the saved-P backward took the wgmma route,
# its bits on a second run and tc:: on the same P (saved_bwd_checks): the legs'
# vision towers and a causal D = 128 shape; (B, S, H, D, causal)
SAVED_BWD_SHAPES = ((64, 257, 16, 64, False), (24, 257, 16, 80, False),
                    (2, 1024, 2, 128, True))


def saved_bwd_checks(errs, mha, label, x, g, p, h, causal, got,
                     bwd_plain) -> None:
    """The bf16 saved-P backward past S = 128 (bf16, D = 64, 80 or 128:
    csrc/attn_bwd_sm90.cuh's wgmma kernels, P read by TMA): route 0
    takes the wgmma route, the one route that refuses the same P an
    element off its 16-byte alignment (the MCT_BWD_TILE_FAULT builds show
    which kernels that route runs); a second run's bits equal to the
    first's (no float atomics); and tc::'s pair (route 2) on the same P
    within the same row bound (logged: how many of its elements differ
    from the wgmma pair's)."""
    run = (lambda route="auto", pp=p: mha.fused_mha_bwd(
        x, g, pp, h, causal=causal, route=route))
    b, _, s, pitch = p.shape[0], p.shape[1], p.shape[2], p.stride(2)
    n = b * h * s * pitch
    p_off = torch.empty(n + 8, device="cuda", dtype=p.dtype)[1:1 + n].view(
        b, h, s, pitch)[..., :s].copy_(p)
    try:
        run(pp=p_off)
    except RuntimeError as e:
        if "launch failed" not in str(e):
            raise
    else:
        raise AssertionError(f"fused_mha_bwd {label}: route 0 took a P off "
                             "its 16-byte alignment, so it did not reach the "
                             "wgmma saved-P kernels")
    del p_off
    again = run()
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        raise AssertionError(f"fused_mha_bwd {label}: a second run gives "
                             "other bits")
    tc = run("tc")
    check_mha_rows(errs, "fused_mha_bwd", label + " tc", tc, bwd_plain, h)
    differ = int((tc.view(torch.int16) != got.view(torch.int16)).sum())
    log(f"  fused_mha_bwd {label}: the wgmma route (a misaligned P "
        f"refused), a second run the same bits; tc:: on the same P (pitch "
        f"{pitch}): {differ} of {got.numel()} elements differ")


# the one-pass forward's edges (csrc/attn_short_sm90.cuh: S <= 128, D = 64,
# a whole head per block): (B, H) and the lengths around its key counts of
# 64, 80 and 128, both masks; and the S = 77 paths' batches and heads
# (ViT-B/32's 384 and 256, ViT-L/14's 64, ViT-H/14's 24)
ONE_PASS_LENGTHS = (1, 7, 50, 64, 65, 77, 127, 128)
ONE_PASS_PATHS = ((TRAIN_BATCH, 8), (SERVE_BATCH, 8), (64, 12), (24, 16))


def recipe_shapes() -> tuple:
    """Phase 13's shapes, from RECIPE_MODEL's config: the attention's
    (tower, B, S, H, D, causal) in (a)'s blocks of RECIPE_BATCH /
    RECIPE_ACCUM rows (the vision tower under patch dropout; the cache
    pass runs the same shapes) and in (b)'s LIT_BATCH rows (the whole
    vision sequence); and the LayerNorms' (rows, width): each tower's
    B * S rows, and its B pooled rows (ln_post, ln_final at pool_type
    "last")."""
    from megatron_clip_tpu_torch.factory import (get_model_config,
                                                 parse_model_cfg)
    cfg = parse_model_cfg(get_model_config(RECIPE_MODEL))
    v, t = cfg.vision, cfg.text
    kept = 1 + max(1, int(v.grid ** 2 * (1 - RECIPE_PATCH_DROPOUT)))
    attention, norms = set(), set()
    for b, vision_seq in ((RECIPE_BATCH // RECIPE_ACCUM, kept),
                          (LIT_BATCH, v.seq_len)):
        for tower, s, h, w, causal in (
                ("vision", vision_seq, v.heads, v.width, False),
                ("text", t.context_length, t.heads, t.width,
                 not t.no_causal_mask)):
            attention.add((tower, b, s, h, w // h, causal))
            norms |= {(b * s, w), (b, w)}
    return sorted(attention), sorted(norms)


def recipe_one_pass() -> list:
    """Phase 13's attention shapes the one-pass kernels take (S <= 128,
    D = 64), as (B, S, H, causal)."""
    return [(b, s, h, causal) for _, b, s, h, d, causal in recipe_shapes()[0]
            if s <= 128 and d == 64]


def one_pass_checks(errs, gen, mha) -> None:
    """The one-pass forward (wgmma at S <= 64, mma.sync past it) asked for
    by its route, in each mode, against the plain version as phase 3 holds
    the routed kernels: the output elementwise and row by row, P, the
    statistics, and the three modes' outputs equal."""
    dt, d = torch.bfloat16, 64
    cases = [(2, 3, s, c) for s in ONE_PASS_LENGTHS for c in (False, True)]
    cases += [(b, h, 77, True) for b, h in ONE_PASS_PATHS]
    cases += [(b, h, s, c) for b, s, h, c in recipe_one_pass()]
    for b, h, s, causal in cases:
        x = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                        dtype=dt)

        def plain(dt, probs=False, stats=False):
            return mha.fused_mha_plain(x.to(dt), h, d ** -0.5, causal,
                                       with_probs=probs, with_stats=stats)
        label = f"B={b} S={s} H={h} D={d} causal={causal} one_pass"
        kw = dict(causal=causal, route="one_pass")
        out = mha.fused_mha_fwd(x, h, **kw)
        out_p, p = mha.fused_mha_fwd(x, h, with_probs=True, **kw)
        out_s, stats = mha.fused_mha_fwd(x, h, with_stats=True, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(out_p, out) and torch.equal(out_s, out)):
            raise AssertionError(f"fused_mha_fwd {label}: the modes' "
                                 "outputs differ")
        check_kernel(errs, "fused_mha_fwd", label, out, plain)
        check_fwd_rows(errs, "fused_mha_fwd", label, out, plain(dt),
                       mha.fused_mha_row_bound(x, h, causal))
        check_kernel(errs, "fused_mha_fwd P", label, p,
                     lambda dt: plain(dt, True)[1])
        check_kernel(errs, "fused_mha_fwd stats", label, stats,
                     lambda dt: plain(dt, stats=True)[1], dt)
        del x, out, out_p, out_s, p, stats
    torch.cuda.empty_cache()


# the one-pass backward's edges (csrc/attn_short_bwd_sm90.cuh: S <= 128,
# D = 64, a whole head per block) at B = 2, H = 3, both masks; and the
# S <= 128 paths' own shapes, (B, S, H, causal): ViT-B/32's towers (saved P
# on its path) and the ViT-L/14 and ViT-H/14 text towers (recompute)
ONE_PASS_BWD_LENGTHS = (1, 7, 50, 64, 65, 77, 128)
ONE_PASS_BWD_PATHS = ((TRAIN_BATCH, 50, 12, False), (TRAIN_BATCH, 77, 8, True),
                      (64, 77, 12, True), (24, 77, 16, True))


def one_pass_bwd_checks(errs, gen, mha) -> None:
    """Both backwards asked for by route, the one-pass kernel and tc::'s
    pair, on the same inputs: the saved-P backward from the plain forward's
    P, the recompute backward from the kernel forward's statistics, each
    held against its plain version as phase 3 holds the routed kernels
    (elementwise, row by row, and against the fp32 plain version); the
    one-pass kernel's second run, its run on the S-major view and (saved P)
    its run on a P whose first and last bytes lie off 16-byte boundaries
    must give its first run's bits."""
    dt, d = torch.bfloat16, 64
    scale = d ** -0.5
    cases = [(2, s, 3, c) for s in ONE_PASS_BWD_LENGTHS for c in (False, True)]
    for b, s, h, causal in cases + list(ONE_PASS_BWD_PATHS) + \
            recipe_one_pass():
        x = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                        dtype=dt)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        views = [t.transpose(0, 1).contiguous().transpose(0, 1)
                 for t in (x, g)]
        _, p = mha.fused_mha_plain(x, h, scale, causal, with_probs=True)
        # the same P an element into a larger buffer
        p_off = torch.empty(p.numel() + 8, device="cuda", dtype=dt)[
            1:1 + p.numel()].view_as(p).copy_(p)
        _, stats = mha.fused_mha_fwd(x, h, causal=causal, with_stats=True)
        modes = {
            "fused_mha_bwd": (
                lambda xx, gg, route: mha.fused_mha_bwd(
                    xx, gg, p, h, causal=causal, route=route),
                lambda dt: mha.fused_mha_bwd_plain(x.to(dt), g.to(dt),
                                                   p.to(dt), h, scale)),
            "fused_mha_bwd_recompute": (
                lambda xx, gg, route: mha.fused_mha_bwd_recompute(
                    xx, gg, stats, h, causal=causal, route=route),
                lambda dt: mha.fused_mha_bwd_recompute_plain(
                    x.to(dt), g.to(dt), h, scale, causal))}
        for name, (run, plain) in modes.items():
            plain = functools.lru_cache(None)(plain)
            for route in ("one_pass", "tc"):
                label = f"B={b} S={s} H={h} D={d} causal={causal} {route}"
                got = run(x, g, route)
                check_kernel(errs, name, label, got, plain)
                check_mha_rows(errs, name, label, got, plain, h)
                if route == "one_pass":
                    again, view = run(x, g, route), run(*views, route)
                    shifted = again if name != "fused_mha_bwd" else (
                        mha.fused_mha_bwd(x, g, p_off, h, causal=causal,
                                          route=route))
                    torch.cuda.synchronize()
                    if not (torch.equal(again, got) and
                            torch.equal(view, got) and
                            torch.equal(shifted, got)):
                        raise AssertionError(
                            f"{name} {label}: a second run, the S-major "
                            "view or P off its alignment differs from the "
                            "first run")
                del got
        del x, g, views, p, p_off, stats
    torch.cuda.empty_cache()


# the attention shapes of phase 8's legs: (leg, tower, B, S, H, D, causal)
LEG_ATTENTION = (("ViT-L/14", "vision", 64, 257, 16, 64, False),
                 ("ViT-L/14", "text", 64, 77, 12, 64, True),
                 ("ViT-H/14", "vision", 24, 257, 16, 80, False),
                 ("ViT-H/14", "text", 24, 77, 16, 64, True))


def smajor_views(mha, gen) -> None:
    """Every attention kernel on the [B, S, *] view of [S, B, *] storage,
    the layout of fused_mha_packed_sm, against the same kernel on the
    contiguous tensor: the arithmetic is the same, so the results must be
    equal, and the outputs come back S-major. The bf16 forwards and
    recompute backwards at S = 257, D = 64 and 80 and S = 512, D = 128 run
    on wgmma (csrc/attn_fwd_sm90.cuh, csrc/attn_bwd_sm90.cuh), the bf16
    forwards and backwards at S = 50 and 77, D = 64 on the one-pass kernels
    (csrc/attn_short_sm90.cuh, csrc/attn_short_bwd_sm90.cuh), the others on
    mma.sync."""
    for b, s, h, d, causal in [(8, 257, 16, 80, False), (8, 77, 16, 64, True),
                               (8, 50, 12, 64, False),
                               (3, 33, 2, 40, True), (8, 257, 16, 64, False),
                               (4, 512, 16, 128, True)]:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                              dtype=dtype)
            do = torch.randn(b, s, h * d, device="cuda", generator=gen,
                             dtype=dtype)
            qkv_v, do_v = (t.transpose(0, 1).contiguous().transpose(0, 1)
                           for t in (qkv, do))
            kw = {"causal": causal}
            out, p = mha.fused_mha_fwd(qkv, h, with_probs=True, **kw)
            _, stats = mha.fused_mha_fwd(qkv, h, with_stats=True, **kw)
            out_v, p_v = mha.fused_mha_fwd(qkv_v, h, with_probs=True, **kw)
            out_v2, stats_v = mha.fused_mha_fwd(qkv_v, h, with_stats=True,
                                                **kw)
            pairs = {
                "fwd": (mha.fused_mha_fwd(qkv_v, h, **kw), out),
                "fwd with P: out": (out_v, out), "fwd P": (p_v, p),
                "fwd with stats: out": (out_v2, out),
                "fwd stats": (stats_v, stats),
                "bwd": (mha.fused_mha_bwd(qkv_v, do_v, p, h, **kw),
                        mha.fused_mha_bwd(qkv, do, p, h, **kw)),
                "bwd_recompute": (
                    mha.fused_mha_bwd_recompute(qkv_v, do_v, stats, h, **kw),
                    mha.fused_mha_bwd_recompute(qkv, do, stats, h, **kw)),
            }
            torch.cuda.synchronize()
            for what, (got, want) in pairs.items():
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"S-major view B={b} S={s} H={h} D={d} {dtype} "
                        f"{what}: differs from the contiguous run")
            for what in ("fwd", "bwd", "bwd_recompute"):
                if pairs[what][0].stride(0) > pairs[what][0].stride(1):
                    raise AssertionError(f"S-major view: {what} output is "
                                         "not S-major")
            log(f"  S-major view B={b} S={s} H={h} D={d} causal={causal} "
                f"{dtype}: every kernel equal to its contiguous run")


# the flash kernels' checks (B, H, Sq, Sk, D, causal): GPT-345m's two
# shapes, both masks at S = 2048, the example GPT's batch 8 (phase 10),
# ragged lengths (1100, 4200: not multiples of the 64- or 128-row tiles;
# 4200 is also past the fused backward's reach), cross lengths, D = 128 at
# rate 0 (the pipeline GPT's heads; the fused backward's wgmma kernel as at
# D = 64), D = 40 (mma.sync, padded to 48) and D = 36 (CUDA cores in bf16
# too)
FLASH_SHAPES = ((6, 16, 2048, 2048, 64, True), (6, 16, 2048, 2048, 64, False),
                (8, 16, 2048, 2048, 64, True), (1, 16, 8192, 8192, 64, True),
                (2, 4, 1100, 1100, 64, True), (1, 4, 4200, 4200, 64, True),
                (2, 4, 1100, 700, 64, True), (2, 4, 700, 1100, 64, False),
                (2, 16, 2048, 2048, 128, True), (2, 4, 1100, 700, 128, False),
                (4, 16, 2048, 2048, 128, True),  # the ladder's 1.3b rung
                (1, 3, 333, 333, 40, True), (1, 2, 300, 300, 36, False))


def flash_checks(errs, gen) -> None:
    """Each flash kernel against its plain version at FLASH_SHAPES, fp32
    and bf16; the backward kernels on the plain forward's out and lse, so
    that each is compared alone."""
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    for b, h, sq, sk, d, causal in FLASH_SHAPES:
        base = [torch.randn(b, h, n, d, device="cuda", generator=gen)
                for n in (sq, sk, sk, sq)]
        label = f"B={b} H={h} Sq={sq} Sk={sk} D={d} causal={causal}"
        scale = d ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dtype) for t in base)

            def cast(dt, *ts):
                return [t.to(dt) for t in ts]
            out, lse = fa.flash_fwd(q, k, v, causal=causal)
            check_kernel(errs, "flash_fwd", label, out, lambda dt: (
                fa.flash_fwd_plain(*cast(dt, q, k, v), scale, causal)[0]))
            check_kernel(errs, "flash_fwd lse", label, lse, lambda dt: (
                fa.flash_fwd_plain(*cast(dt, q, k, v), scale, causal)[1]),
                dtype)
            p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
            delta = fa.flash_delta(do, p_out)
            check_grads(
                errs, "flash_bwd_dq", label,
                (fa.flash_bwd_dq(q, k, v, do, p_lse, delta, causal=causal),),
                lambda dt: (fa.flash_bwd_dq_plain(*cast(dt, q, k, v, do),
                                                  p_lse, delta, scale,
                                                  causal),))
            check_grads(
                errs, "flash_bwd_dkv", label,
                fa.flash_bwd_dkv(q, k, v, do, p_lse, delta, causal=causal),
                lambda dt: fa.flash_bwd_dkv_plain(
                    *cast(dt, q, k, v, do), p_lse, delta, scale, causal))
            check_grads(
                errs, "flash_bwd_fused", label,
                fa.flash_bwd_fused(q, k, v, p_out, p_lse, do, causal=causal),
                lambda dt: fa.flash_bwd_fused_plain(
                    *cast(dt, q, k, v, p_out), p_lse, do.to(dt), scale,
                    causal))
            if dtype == torch.bfloat16 and causal and (b, sq) in GPT_SHAPES:
                flash_bwd_teeth(fa, label, q, k, v, do, p_out, p_lse, scale)
        del base, q, k, v, do, out, lse, p_out, p_lse, delta
        torch.cuda.empty_cache()


def flash_bwd_teeth(fa, label, q, k, v, do, out, lse, scale) -> None:
    """Each bf16 backward kernel made wrong on purpose, as an off-by-one in
    a tile's bound would: the last row of every 64-row tile left out, in
    the whole sequence or only in its late half. For the dQ kernel that is
    a key of each key tile (its K row zeroed: its dS K term vanishes and no
    other key's P moves, as lse is given), for the dKV and fused kernels a
    query of each query tile (its dO and delta rows zeroed: its P dO and
    dS Q terms vanish). Held against the plain version on the true inputs,
    each must fail the row bound. Beside it is logged what a bound scaled
    by the tensor's largest |value| (2^-7 of it plus rtol 1.6e-2) reads
    for the same fault."""
    want = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_fused_plain(
        q, k, v, out, lse, do, scale, True)))
    delta = fa.flash_delta(do, out)
    s = q.shape[2]
    for where, rows in (("every tile", slice(63, None, 64)),
                        ("the late half", slice(s // 2 + 63, None, 64))):
        k_bad, do_bad = k.clone(), do.clone()
        k_bad[:, :, rows] = 0
        do_bad[:, :, rows] = 0
        delta_bad = fa.flash_delta(do_bad, out)
        wrong = {
            "flash_bwd_dq": dict(dq=fa.flash_bwd_dq(
                q, k_bad, v, do, lse, delta, causal=True)),
            "flash_bwd_dkv": dict(zip(("dk", "dv"), fa.flash_bwd_dkv(
                q, k, v, do_bad, lse, delta_bad, causal=True))),
            "flash_bwd_fused": dict(zip(("dq", "dk", "dv"), fa.flash_bwd_fused(
                q, k, v, out, lse, do_bad, causal=True)))}
        for name, got in wrong.items():
            for part, g in got.items():
                w = want[part].float()
                row = rows_used(g, w, *TOLERANCES[name]["bf16"])
                old = float(((g.float() - w).abs() / (
                    2 ** -7 * w.abs().max() + 1.6e-2 * w.abs())).max())
                log(f"  {name} {label} a row per tile left out in {where}, "
                    f"{part}: {row:.3f} of the row bound, {old:.3f} of the "
                    "largest-|value| bound")
                if row <= 1:
                    raise AssertionError(
                        f"{name} {label}: the row bound passes a kernel that "
                        f"leaves out a row per tile in {where}")


def flash_views(gen) -> None:
    """Each flash kernel on the head views of a packed [B, S, 3*H*D]
    projection, the GPT path's layout, against the same kernel on
    contiguous copies: the same arithmetic, so equal results, except the
    fused backward's dQ, summed by fp32 TMA reduce-adds or atomics in an
    order that changes from run to run (within 1e-6 relative in fp32; in
    bf16 its rounding can fall either way: two bf16 ulps, rtol 1.6e-2, as
    the other bf16 gradient bounds); the backward's gradients land in one
    packed [B, S, 3, H, D] buffer."""
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    for b, h, s, d, dtype in ((6, 16, 2048, 64, torch.bfloat16),
                              (6, 16, 2048, 64, torch.float32),
                              (8, 16, 2048, 64, torch.bfloat16),
                              (1, 16, 8192, 64, torch.bfloat16),
                              (2, 4, 1100, 64, torch.bfloat16)):
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dtype)
        do = torch.randn(b, s, h, d, device="cuda", generator=gen,
                         dtype=dtype).transpose(1, 2)
        views = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1, 4).unbind(0)
        copies = [t.contiguous() for t in views]
        out, lse = fa.flash_fwd(*copies, causal=True)
        out_v, lse_v = fa.flash_fwd(*views, causal=True)
        delta = fa.flash_delta(do, out)
        dq, dk, dv, packed = fa.flash_bwd(*views, out, lse, do, causal=True,
                                          scale=d ** -0.5)
        pairs = {
            "fwd out": (out_v, out), "fwd lse": (lse_v, lse),
            "bwd_dq": (fa.flash_bwd_dq(*views, do, lse, delta, causal=True),
                       fa.flash_bwd_dq(*copies, do, lse, delta, causal=True)),
            **{f"bwd_dkv {n}": pair for n, pair in zip("kv", zip(
                fa.flash_bwd_dkv(*views, do, lse, delta, causal=True),
                fa.flash_bwd_dkv(*copies, do, lse, delta, causal=True)))},
        }
        want = (fa.flash_bwd_fused(*copies, out, lse, do, causal=True)
                if fa.uses_fused_bwd(s) else
                (pairs["bwd_dq"][1], *(pairs[f"bwd_dkv {n}"][1]
                                        for n in "kv")))
        pairs.update({"bwd dk": (dk, want[1]), "bwd dv": (dv, want[2])})
        torch.cuda.synchronize()
        label = f"packed views B={b} S={s} H={h} D={d} {dtype}"
        for what, (got, ref) in pairs.items():
            if not torch.equal(got, ref):
                raise AssertionError(f"{label} {what}: differs from the "
                                     "contiguous run")
        compare(f"{label} bwd dq", dq, want[0], 1e-6,
                1e-6 if dtype == torch.float32 else 1.6e-2)
        if packed is None or not packed.is_contiguous() or \
                packed.shape != (b, s, 3, h, d) or \
                packed.data_ptr() != dq.data_ptr():
            raise AssertionError(f"{label}: the gradients are not one packed "
                                 "[B, S, 3, H, D] buffer")
        log(f"  {label}: every kernel equal to its contiguous run")
        del qkv, do, views, copies, packed, pairs, want
        torch.cuda.empty_cache()


# the fused-CE checks (T, W, V, tied head): full width and vocabulary at a
# few thousand tokens, tied (the GPT's [W, V] view of the [V, W]
# embedding) and untied ([W, V] storage); a ragged T over three groups of
# token tiles (16, 16 and 6 tiles of 128, the last of 77 tokens) with a
# vocabulary that is no tile multiple; W = 1000 (rows of 2000 bytes, whose
# last 64-deep K step is ragged)
CE_SHAPES = ((2048, 1024, 50304, True), (2048, 1024, 50304, False),
             (4813, 1024, 1000, True), (333, 1000, 1000, True))
# the paths' own shapes, bf16 only (fp32 runs on the CUDA cores at
# CE_FP32_TOKENS tokens whatever T): the example GPT's (phase 10: eight
# groups of token tiles) and the pipeline GPT's (phase 11: W = 2048, twice
# the W-chunks per recompute)
CE_PATH_SHAPES = ((EXAMPLE_RUN[0] * EXAMPLE_RUN[1], GPT_345M["hidden_size"],
                   GPT_345M["vocab_size"], True),
                  (PIPELINE_RUNS[0][0] * PIPELINE_RUNS[0][1],
                   PIPELINE_GPT["hidden_size"], PIPELINE_GPT["vocab_size"],
                   True))
CE_FP32_TOKENS = 512


def ce_inputs(gen, t: int, w: int, v: int, tied: bool, dtype):
    """x [T, W], the head [W, V] (tied: the transposed view of a [V, W]
    embedding), labels [T] over the whole vocabulary, dloss [T] > 0."""
    x = torch.randn(t, w, device="cuda", generator=gen).to(dtype)
    emb = (torch.randn(v, w, device="cuda", generator=gen) * 0.05).to(dtype)
    head = emb.t() if tied else emb.t().contiguous()
    labels = torch.randint(0, v, (t,), device="cuda", generator=gen)
    dloss = torch.rand(t, device="cuda", generator=gen) / t
    return x, head, labels, dloss


def fused_ce_checks(errs, gen) -> None:
    """The fused-CE forward (loss, lse) and backward (dX, dW) against their
    plain versions at CE_SHAPES, fp32 and bf16, and at CE_PATH_SHAPES in
    bf16; the backward on the plain
    forward's lse, so that each is compared alone; then fused_ce_teeth."""
    from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
    for t, w, v, tied in CE_SHAPES + CE_PATH_SHAPES:
        dtypes = (torch.float32, torch.bfloat16)
        for dtype in dtypes[(t, w, v, tied) in CE_PATH_SHAPES:]:
            tt = min(t, CE_FP32_TOKENS) if dtype == torch.float32 else t
            x, head, labels, dloss = ce_inputs(gen, tt, w, v, tied, dtype)
            label = (f"T={tt} W={w} V={v} {'tied' if tied else 'untied'} "
                     "head")

            def plain(dt, part):
                return ce.fused_ce_fwd_plain(x.to(dt), head.to(dt),
                                             labels)[part]
            loss, lse = ce.fused_ce_fwd(x, head, labels)
            check_kernel(errs, "fused_ce_fwd", label, loss,
                         lambda dt: plain(dt, 0), dtype)
            check_kernel(errs, "fused_ce_fwd lse", label, lse,
                         lambda dt: plain(dt, 1), dtype)
            p_lse = plain(dtype, 1)
            dx, dw = ce.fused_ce_bwd(x, head, labels, p_lse, dloss)
            if dw.shape != head.shape or dx.shape != x.shape:
                raise AssertionError(f"fused_ce_bwd {label}: shapes "
                                     f"{tuple(dx.shape)}, {tuple(dw.shape)}")
            check_ce_grads(errs, label, dx, dw, lambda dt: ce.fused_ce_bwd_plain(
                x.to(dt), head.to(dt), labels, p_lse, dloss))
            if dtype == torch.bfloat16 and (t, w, v, tied) == CE_SHAPES[0]:
                fused_ce_teeth(ce, label, x, head, labels, dloss)
            del x, head, labels, dloss, dx, dw
        torch.cuda.empty_cache()


def check_ce_grads(errs, label, dx, dw, plain) -> None:
    """dX and dW^T against plain(dtype): fp32 as check_kernel, bf16 row by
    row (one token's dX, one vocabulary row's dW)."""
    if dx.dtype == torch.float32:
        for i, (part, g) in enumerate((("dx", dx), ("dw", dw))):
            check_kernel(errs, "fused_ce_bwd", f"{label} {part}", g,
                         lambda dt: plain(dt)[i])
        return
    for kind, dt in (("bf16", torch.bfloat16),
                     ("bf16_vs_fp32_plain", torch.float32)):
        want_dx, want_dw = plain(dt)
        for part, g, want in (("dx", dx, want_dx), ("dw", dw.t(), want_dw.t())):
            e = compare_rows(f"fused_ce_bwd {label} {kind} {part}", g, want,
                             *TOLERANCES["fused_ce_bwd"][kind])
            errs["fused_ce_bwd"][kind] = max(
                errs["fused_ce_bwd"].get(kind, 0.0), e)


def fused_ce_teeth(ce, label, x, head, labels, dloss) -> None:
    """The kernels made wrong on purpose, as an off-by-one in the vocabulary
    loop would: run on the head without its last 128-column tile (dW's rows
    of that tile left at 0), a tenth of the labels moved into that tile.
    Held against the plain version on the true inputs, the loss and each
    gradient must fail their bounds."""
    v = head.shape[1]
    labels = labels.clone()
    labels[::10] = v - 1 - (labels[::10] % 128)
    loss, lse = ce.fused_ce_fwd_plain(x, head, labels)
    want_dx, want_dw = ce.fused_ce_bwd_plain(x, head, labels, lse, dloss)
    cut = head[:, :v - 128]
    bad_loss, _ = ce.fused_ce_fwd(x, cut, labels)
    bad_dx, bad_dw = ce.fused_ce_bwd(x, cut, labels, lse, dloss)
    bad_dw = torch.cat([bad_dw, torch.zeros_like(head[:, v - 128:])], 1)
    atol, rtol = TOLERANCES["fused_ce_fwd"]["bf16"]
    used = {"loss": float(((bad_loss - loss).abs() / (
        atol + rtol * loss.abs())).max())}
    rel, floor = TOLERANCES["fused_ce_bwd"]["bf16"]
    used["dx"] = rows_used(bad_dx, want_dx, rel, floor)
    used["dw"] = rows_used(bad_dw.t(), want_dw.t(), rel, floor)
    for part, u in used.items():
        log(f"  fused_ce {label} last vocabulary tile left out, {part}: "
            f"{u:.3f} of the bound")
        if u <= 1:
            raise AssertionError(f"fused_ce {label}: the {part} bound passes "
                                 "a kernel that leaves out the last tile")


def norm_param_checks(ln, kind: str, label: str, x: torch.Tensor,
                      dy: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor = None) -> None:
    """A bf16 scale (and bias), as the pure_bf16 paths pass them, read as it
    is: the forward and dx equal, bit for bit, the call on the same values
    in fp32 (bf16 -> fp32 is exact); dscale (and dbias) come back in bf16,
    that call's fp32 sums rounded once; two runs of the backward give the
    same bits (no atomics)."""
    fwd, bwd = getattr(ln, f"{kind}_fwd"), getattr(ln, f"{kind}_bwd")
    params = tuple(p.to(torch.bfloat16)
                   for p in ((scale,) if bias is None else (scale, bias)))
    wide = tuple(p.float() for p in params)
    got, again = bwd(x, params[0], dy), bwd(x, params[0], dy)
    ref = bwd(x, wide[0], dy)
    checks = {
        "forward": torch.equal(fwd(x, *params), fwd(x, *wide)),
        "dx": torch.equal(got[0], ref[0]),
        "sums rounded once": all(
            g.dtype == torch.bfloat16 and torch.equal(g, r.to(g.dtype))
            for g, r in zip(got[1:], ref[1:])),
        "two runs": all(torch.equal(a, b) for a, b in zip(got, again))}
    failed = [what for what, ok in checks.items() if not ok]
    log(f"  {kind} {label} {x.dtype} bf16 parameters: "
        f"{'failed ' + str(failed) if failed else 'bit-equal'} (forward, dx "
        "and the rounded sums against fp32 parameters; two runs)")
    if failed:
        raise AssertionError(f"{kind} {label} {x.dtype} with bf16 "
                             f"parameters: {failed}")


def rms_checks(errs, gen, ln) -> None:
    """The RMSNorm kernels against their plain versions at the example
    GPT's rows (batch 8 x 2048 at width 1024), GPT-345m's and odd shapes,
    and with a bf16 scale (norm_param_checks)."""
    for rows, w in [(8 * 2048, 1024), (6 * 2048, 1024), (1000, 768),
                    (5, 100), (3, 4100)]:
        x = torch.randn(rows, w, device="cuda", generator=gen) * 3 + 1
        dy = torch.randn(rows, w, device="cuda", generator=gen)
        scale = torch.randn(w, device="cuda", generator=gen)
        label = f"rows={rows} W={w}"
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), dy.to(dtype)
            check_kernel(errs, "rms_norm_fwd", label,
                         ln.rms_norm_fwd(xd, scale),
                         lambda dt: ln.rms_norm_plain(xd.to(dt), scale))
            dx, dscale = ln.rms_norm_bwd(xd, scale, gd)
            check_kernel(errs, "rms_norm_bwd", label + " dx", dx,
                         lambda dt: ln.rms_norm_bwd_plain(
                             xd.to(dt), scale, gd.to(dt))[0])
            e = compare(f"rms_norm_bwd {label} {dtype} dscale", dscale,
                        ln.rms_norm_bwd_plain(xd, scale, gd)[1],
                        *TOLERANCES["rms_norm_bwd"]["sums"])
            errs["rms_norm_bwd"]["sums"] = max(
                errs["rms_norm_bwd"].get("sums", 0.0), e)
            norm_param_checks(ln, "rms_norm", label, xd, gd, scale)


# the dropout kernels' checks: the fused route at the pipeline GPT's S =
# 512 heads (H = 16, D = 128: one head per cell), at its batch 32 there,
# at H = 12, D = 64 (two heads per cell in the JAX kernel) and at a ragged
# S = 333; flash at the pipeline GPT's heads at S = 2048, at a ragged S =
# 1100, and at the path's batch 8 x 2048 and 1 x 8192 (the split pair) on
# the head views of the packed projection, the gradients written into one
# packed buffer, as the train step runs them; and both routes placed as a
# rank of phase 17 launches them (`check_dropout`: 8 of 16 heads, rows
# from row 2 of the step); each (B, S, H, D, masks[, packed], placed)
FUSED_DROPOUT_SHAPES = ((2, 512, 16, 128, (True, False), False),
                        (32, 512, 16, 128, (True,), False),
                        (2, 512, 12, 64, (True, False), False),
                        (2, 333, 16, 128, (True, False), False),
                        (2, 512, 8, 128, (True,), True))
FLASH_DROPOUT_SHAPES = ((2, 2048, 16, 128, (True, False), False, False),
                        (2, 1100, 4, 128, (True, False), False, False),
                        (8, 2048, 16, 128, (True,), True, False),
                        (1, 8192, 16, 128, (True,), True, False),
                        (2, 2048, 8, 128, (True,), True, True))
DROPOUT_RATE, DROPOUT_CHECK_SEED = 0.1, 0x5EED0F1A55C0FFEE


def check_dropout(s: int, h: int, placed: bool):
    """The dropout of a check's launch of `h` heads a row: of the whole
    step, or `placed` as the tensor rank 1 of 2 (the launch's h heads the
    second half of each row's 2h) of a data rank whose rows start at row 2
    of the step, its heads drawing the step's bits (`Dropout::step_head`
    with the division a tensor rank's launch takes)."""
    from megatron_clip_tpu_torch.ops.dropout import RankSeed, attention_dropout
    seed = DROPOUT_CHECK_SEED
    if placed:
        seed = RankSeed(seed, row_base=2, tp=2, tp_rank=1, batch_rank=1)
    return attention_dropout(DROPOUT_RATE, seed, s + h, heads=h)


def mask_check(lib, label: str, bh: int, s: int, drop) -> float:
    """The bits `lib.dropout_mask` exports against `philox_keep`, a head
    at a time (the step's head of each, `drop.head`), bit for bit; returns
    the keep share, which must lie within 5 sigma of 1 - rate."""
    from megatron_clip_tpu_torch.ops.dropout import philox_keep
    kept = 0
    exported = lib.dropout_mask(bh, s, s, drop.rate, drop.seed, drop.offset,
                                "cuda", placement=drop[3:])
    for i in range(bh):
        want = philox_keep(drop.seed, drop.offset, drop.head(i), range(s),
                           range(s), drop.rate, "cuda")
        if not torch.equal(exported[i], want):
            raise AssertionError(f"{label}: head {i} of the exported mask "
                                 "differs from the plain Philox")
        kept += int(want.sum())
    n = bh * s * s
    share = kept / n
    sigma = (drop.rate * (1 - drop.rate) / n) ** 0.5
    log(f"  {label}: mask of {bh} x {s} x {s} bit for bit; keep share "
        f"{share:.6f} ({(share - 1 + drop.rate) / sigma:+.2f} sigma)")
    if abs(share - 1 + drop.rate) > 5 * sigma:
        raise AssertionError(f"{label}: keep share {share} outside 5 sigma")
    return share


def fused_dropout_checks(errs, gen, mha) -> None:
    """The fused-MHA dropout forward (out, row statistics) and backward
    against their plain versions fed the Philox multipliers, fp32 and
    bf16, both masks; the exported mask bit for bit."""
    for b, s, h, d, masks, placed in FUSED_DROPOUT_SHAPES:
        drop = check_dropout(s, h, placed)
        where = " placed" if placed else ""
        mask_check(mha, f"fused_mha dropout mask B={b} H={h} S={s}{where}",
                   b * h, s, drop)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        do = torch.randn(b, s, h * d, device="cuda", generator=gen)
        scale = d ** -0.5
        for causal in masks:
            label = f"B={b} S={s} H={h} D={d} causal={causal} rate=0.1{where}"
            for dtype in (torch.float32, torch.bfloat16):
                x, g = qkv.to(dtype), do.to(dtype)

                def keep(dt):
                    return drop.multipliers(b, h, s, s,
                                            mha.dropout_mult(drop.rate, dt),
                                            "cuda")

                def plain(dt, stats=False):
                    return mha.fused_mha_plain(x.to(dt), h, scale, causal,
                                               with_stats=stats,
                                               keep=keep(dt))
                out, stats = mha.fused_mha_dropout_fwd(x, h, drop,
                                                       causal=causal)
                check_kernel(errs, "fused_mha_dropout_fwd", label, out,
                             plain)
                if dtype == torch.bfloat16:
                    check_fwd_rows(errs, "fused_mha_dropout_fwd", label, out,
                                   plain(dtype), mha.fused_mha_row_bound(
                                       x, h, causal, keep(dtype)))
                check_kernel(errs, "fused_mha_dropout_fwd stats", label,
                             stats, lambda dt: plain(dt, True)[1], dtype)
                d_plain = functools.lru_cache(None)(
                    lambda dt: mha.fused_mha_bwd_recompute_plain(
                        x.to(dt), g.to(dt), h, scale, causal, keep(dt)))
                got = mha.fused_mha_dropout_bwd(x, g, stats, h, drop,
                                                causal=causal)
                check_kernel(errs, "fused_mha_dropout_bwd", label, got,
                             d_plain)
                if dtype == torch.bfloat16:
                    check_mha_rows(errs, "fused_mha_dropout_bwd", label, got,
                                   d_plain, h)
                del got, d_plain
        del qkv, do
        torch.cuda.empty_cache()


def flash_dropout_checks(errs, gen) -> None:
    """The four flash dropout kernels against their plain versions fed the
    Philox multipliers, fp32 and bf16: the forward (out, lse), and the
    fused, dQ and dKV backward on the plain forward's out and lse, bf16
    gradients row by row; the exported mask bit for bit. A packed shape
    runs on the head views of a [B, S, 3*H*D] projection with dO a view
    of [B, S, H, D], and also through `flash_bwd`, which writes the
    gradients into one packed buffer (the train step's calls)."""
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    for b, s, h, d, masks, packed, placed in FLASH_DROPOUT_SHAPES:
        drop = check_dropout(s, h, placed)
        where = " placed" if placed else ""
        mask_check(fa, f"flash dropout mask B={b} H={h} S={s}{where}", b * h,
                   s, drop)
        keep = drop.multipliers(b, h, s, s, fa.dropout_mult(drop.rate),
                                "cuda")
        if packed:
            base = (torch.randn(b, s, 3 * h * d, device="cuda",
                                generator=gen),
                    torch.randn(b, s, h, d, device="cuda", generator=gen))
        else:
            base = [torch.randn(b, h, s, d, device="cuda", generator=gen)
                    for _ in range(4)]
        scale = d ** -0.5
        for causal in masks:
            label = (f"B={b} H={h} S={s} D={d} causal={causal} rate=0.1"
                     + (" packed views" if packed else "") + where)
            for dtype in (torch.float32, torch.bfloat16):
                if packed:
                    q, k, v = base[0].to(dtype).unflatten(-1, (3, h, d)) \
                        .permute(2, 0, 3, 1, 4).unbind(0)
                    do = base[1].to(dtype).transpose(1, 2)
                else:
                    q, k, v, do = (t.to(dtype) for t in base)

                def cast(dt, *ts):
                    return [t.to(dt) for t in ts]
                out, lse = fa.flash_fwd_dropout(q, k, v, drop, causal=causal)
                check_kernel(errs, "flash_fwd_dropout", label, out,
                             lambda dt: fa.flash_fwd_plain(
                                 *cast(dt, q, k, v), scale, causal, keep)[0])
                check_kernel(errs, "flash_fwd_dropout lse", label, lse,
                             lambda dt: fa.flash_fwd_plain(
                                 *cast(dt, q, k, v), scale, causal, keep)[1],
                             dtype)
                p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, causal,
                                                  keep)
                delta = fa.flash_delta(do, p_out)
                check_grads(errs, "flash_bwd_dq_dropout", label,
                            (fa.flash_bwd_dq_dropout(q, k, v, do, p_lse,
                                                     delta, drop,
                                                     causal=causal),),
                            lambda dt: (fa.flash_bwd_dq_plain(
                                *cast(dt, q, k, v, do), p_lse, delta, scale,
                                causal, keep),))
                check_grads(errs, "flash_bwd_dkv_dropout", label,
                            fa.flash_bwd_dkv_dropout(q, k, v, do, p_lse,
                                                     delta, drop,
                                                     causal=causal),
                            lambda dt: fa.flash_bwd_dkv_plain(
                                *cast(dt, q, k, v, do), p_lse, delta, scale,
                                causal, keep))
                check_grads(errs, "flash_bwd_fused_dropout", label,
                            fa.flash_bwd_fused_dropout(q, k, v, p_out, p_lse,
                                                       do, drop,
                                                       causal=causal),
                            lambda dt: fa.flash_bwd_fused_plain(
                                *cast(dt, q, k, v, p_out), p_lse, do.to(dt),
                                scale, causal, keep))
                if packed:
                    packed_grads(errs, fa, label, q, k, v, p_out, p_lse, do,
                                 scale, causal, drop, keep)
                del out, lse, p_out, p_lse, delta
        del base, keep, q, k, v, do
        torch.cuda.empty_cache()


def packed_grads(errs, fa, label, q, k, v, out, lse, do, scale, causal,
                 drop, keep) -> None:
    """`flash_bwd` with dropout on the head views: the fused kernel, or
    the split pair past its reach, writing dQ, dK and dV into one packed
    [B, S, 3, H, D] buffer, against the plain backward."""
    dq, dk, dv, buf = fa.flash_bwd(q, k, v, out, lse, do, causal=causal,
                                   scale=scale, drop=drop)
    b, h, s, d = q.shape
    if buf is None or not buf.is_contiguous() or \
            buf.shape != (b, s, 3, h, d) or buf.data_ptr() != dq.data_ptr():
        raise AssertionError(f"flash_bwd {label}: the gradients are not one "
                             "packed [B, S, 3, H, D] buffer")

    def want(dt):
        return fa.flash_bwd_fused_plain(
            *(t.to(dt) for t in (q, k, v, out)), lse, do.to(dt), scale,
            causal, keep)
    label = f"{label} into the packed buffer"
    if fa.uses_fused_bwd(s):
        check_grads(errs, "flash_bwd_fused_dropout", label, (dq, dk, dv),
                    want)
    else:
        check_grads(errs, "flash_bwd_dq_dropout", label, (dq,),
                    lambda dt: want(dt)[:1])
        check_grads(errs, "flash_bwd_dkv_dropout", label, (dk, dv),
                    lambda dt: want(dt)[1:])


def bound_share(got: torch.Tensor, want: torch.Tensor, atol: float,
                rtol: float, atol_of_max: float = 0.0) -> float:
    """The share of the bound atol + atol_of_max*max|want| + rtol*|want|
    (compare's) that the worst element of `got` uses."""
    got, want = got.float(), want.float()
    tol = atol + atol_of_max * want.abs().max() + rtol * want.abs()
    return float(((got - want).abs() / tol).max())


def bf16_share(got: torch.Tensor, want: torch.Tensor, name: str) -> float:
    """The share of `name`'s bf16 bound (TOLERANCES: atol, rtol[, atol as a
    share of max|want|]) that the worst element of `got` uses."""
    return bound_share(got, want, *TOLERANCES[name]["bf16"])


def dropout_teeth(kernels_build, gen, mha) -> None:
    """The kernels built to draw a wrong mask (DROPOUT_FAULTS: per 64 x 64
    tile, or shifted a column), run through the same wrappers on the
    pipeline GPT's heads (bf16, causal) and held against the plain versions
    on the true mask: the exported mask must differ from the plain Philox,
    and the forward and the backward must each fail their bound."""
    from megatron_clip_tpu_torch.ops.dropout import (AttentionDropout,
                                                     philox_keep)
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    dt, h, d = torch.bfloat16, PIPELINE_HEADS, PIPELINE_HEAD_DIM
    scale = d ** -0.5
    b, s = 2, 2048
    drop = AttentionDropout(DROPOUT_RATE, DROPOUT_CHECK_SEED, 1)
    q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen,
                               dtype=dt) for _ in range(4))
    keep = drop.multipliers(b, h, s, s, fa.dropout_mult(drop.rate), "cuda")
    out, lse = fa.flash_fwd_plain(q, k, v, scale, True, keep)
    dq, dk, dv = fa.flash_bwd_fused_plain(q, k, v, out, lse, do, scale, True,
                                          keep)
    fs = 512
    qkv = torch.randn(b, fs, 3 * h * d, device="cuda", generator=gen,
                      dtype=dt)
    g = torch.randn(b, fs, h * d, device="cuda", generator=gen, dtype=dt)
    fkeep = drop.multipliers(b, h, fs, fs, mha.dropout_mult(drop.rate, dt),
                             "cuda")
    f_out, f_stats = mha.fused_mha_plain(qkv, h, scale, True,
                                         with_stats=True, keep=fkeep)
    f_grad = mha.fused_mha_bwd_recompute_plain(qkv, g, h, scale, True, fkeep)
    f_bound = mha.fused_mha_row_bound(qkv, h, True, fkeep)
    truth = philox_keep(drop.seed, drop.offset, 0, range(256), range(256),
                        drop.rate, "cuda")
    for fault in DROPOUT_FAULTS:
        with kernels_build.variant(fault):
            used = {}
            for lib in (fa, mha):
                bad = lib.dropout_mask(1, 256, 256, drop.rate, drop.seed,
                                       drop.offset, "cuda")[0]
                used[f"{lib.__name__.split('.')[-1]} mask: differing bits"] \
                    = int((bad != truth).sum())
            got, _ = fa.flash_fwd_dropout(q, k, v, drop, causal=True)
            used["flash_fwd_dropout"] = bf16_share(got, out,
                                                   "flash_fwd_dropout")
            grads = fa.flash_bwd_fused_dropout(q, k, v, out, lse, do, drop,
                                               causal=True)
            rel, floor = TOLERANCES["flash_bwd_fused_dropout"]["bf16"]
            used["flash_bwd_fused_dropout"] = max(
                rows_used(gr, w, rel, floor)
                for gr, w in zip(grads, (dq, dk, dv)))
            f_got, _ = mha.fused_mha_dropout_fwd(qkv, h, drop, causal=True)
            used["fused_mha_dropout_fwd"] = bf16_share(
                f_got, f_out, "fused_mha_dropout_fwd")
            used["fused_mha_dropout_fwd rows"] = fwd_rows_used(
                f_got, f_out, f_bound)
            bg = mha.fused_mha_dropout_bwd(qkv, g, f_stats, h, drop,
                                           causal=True)
            used["fused_mha_dropout_bwd"] = bf16_share(
                bg, f_grad, "fused_mha_dropout_bwd")
        log(f"  dropout kernels built with {fault}: {json.dumps(used)} "
            "(mask: bits that differ from the plain Philox; kernels: share "
            "of the bound used)")
        for what, u in used.items():
            if u <= (0 if "mask" in what else 1):
                raise AssertionError(f"{fault}: {what} passes the check of a "
                                     "right kernel")
    del q, k, v, do, keep, out, lse, dq, dk, dv, qkv, g, fkeep
    torch.cuda.empty_cache()


# the forward teeth: the fused MHA with row statistics at the pipeline
# GPT's heads (S = 512, D = 128, causal: K resident), ViT-L/14's vision
# tower (S = 257, D = 64) and ViT-H/14's at its own batch (B = 24, S = 257,
# D = 80); flash at GPT-345m's and the pipeline GPT's heads
# (S = 2048, D = 64 and 128, causal); each (B, S, H, D, causal)
FWD_TEETH_FUSED = ((2, 512, 16, 128, True), (4, 257, 16, 64, False),
                   (24, 257, 16, 80, False))
# the one-pass forward's (csrc/attn_short_sm90.cuh, S <= 128): ViT-L/14's
# text tower with row statistics (B = 64, S = 77, H = 12, causal) and
# ViT-B/32's vision tower with P (S = 50, H = 12), on the route fused_mha.cu
# takes; each (B, S, H, D, causal, mode)
FWD_TEETH_ONE_PASS = ((64, 77, 12, 64, True, "with_stats"),
                      (64, 50, 12, 64, False, "with_probs"))
FWD_TEETH_FLASH = ((2, 2048, 16, 64, True), (2, 2048, 16, 128, True))


def fwd_teeth(kernels_build, gen, mha) -> None:
    """The wgmma forwards built wrong on purpose (TILE_FAULTS), as an
    off-by-one at a key tile's bound would: the last key of every 128-key
    tile left out (masked, so its p is 0: its V row adds nothing and its
    exponential leaves the sum), in the whole sequence or in the tiles of
    its late half; and the one-pass forward at S <= 128, whose one key tile
    holds every key, built to leave out each row's last unmasked key (the
    diagonal when causal), in every row or in the rows of the late half.
    Run through the same wrappers and held against the plain version on the
    true inputs, each forward's output must fail the bf16 bounds that phase
    3 holds the right kernels to: TOLERANCES["fused_mha_fwd"] and the row
    bound (fused_mha_row_bound) for the fused forward, TOLERANCES
    ["flash_fwd"] for flash; the share of each and of the statistics' or
    lse's bound is logged."""
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    dt = torch.bfloat16
    cases = []
    fused = [(*shape, "with_stats") for shape in FWD_TEETH_FUSED]
    for b, s, h, d, causal, mode in fused + list(FWD_TEETH_ONE_PASS):
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        out, res = mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                       **{mode: True})
        cases.append((f"B={b} S={s} H={h} D={d} causal={causal} {mode}",
                      "fused_mha_fwd",
                      "fused_mha_fwd " + ("P" if mode == "with_probs"
                                          else "stats"),
                      lambda qkv=qkv, h=h, causal=causal, mode=mode:
                      mha.fused_mha_fwd(qkv, h, causal=causal,
                                        **{mode: True}),
                      (out, res), mha.fused_mha_row_bound(qkv, h, causal)))
    for b, s, h, d, causal in FWD_TEETH_FLASH:
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen,
                               dtype=dt) for _ in range(3))
        want = fa.flash_fwd_plain(q, k, v, d ** -0.5, causal)
        cases.append((f"B={b} S={s} H={h} D={d} causal={causal}",
                      "flash_fwd", "flash_fwd lse",
                      lambda q=q, k=k, v=v, causal=causal: fa.flash_fwd(
                          q, k, v, causal=causal), want, None))
    for faults in TILE_FAULTS:
        fault = faults[0]
        with kernels_build.variant(*faults):
            for label, name, residual, run, (want, want_res), bound in cases:
                got, got_res = run()
                out_used = bf16_share(got, want, name)
                res_used = bf16_share(got_res, want_res, residual)
                rows = ("" if bound is None else
                        f"{fwd_rows_used(got, want, bound):.3f} of the row "
                        "bound, ")
                log(f"  {name} {label} built with {fault}: {rows}"
                    f"{out_used:.3f} of the output's bound, {res_used:.3f} "
                    f"of the {residual.split()[-1]} bound")
                if out_used <= 1 or (bound is not None and
                                     fwd_rows_used(got, want, bound) <= 1):
                    raise AssertionError(
                        f"{name} {label}: the bound passes a forward built "
                        f"with {fault}")
    del cases
    torch.cuda.empty_cache()


# the backward teeth: the pipeline GPT's heads (S = 512, D = 128, causal,
# rate 0.1), ViT-L/14's vision tower (S = 257, D = 64) and ViT-H/14's at its
# own batch (B = 24, S = 257, D = 80); each (B, S, H, D, causal, rate)
BWD_TEETH = ((2, 512, 16, 128, True, DROPOUT_RATE),
             (4, 257, 16, 64, False, 0.0),
             (24, 257, 16, 80, False, 0.0))
# the saved-P backward's wgmma kernels (csrc/attn_bwd_sm90.cuh from saved
# P): ViT-L/14's and ViT-H/14's vision heads (batch 4 and 24) and a causal
# D = 128 shape; each (B, S, H, D, causal)
BWD_TEETH_SAVED = ((4, 257, 16, 64, False), (24, 257, 16, 80, False),
                   (2, 512, 16, 128, True))
# the one-pass backward's (csrc/attn_short_bwd_sm90.cuh, S <= 128):
# ViT-B/32's vision tower (S = 50, H = 12) and text tower (S = 77, H = 8,
# causal) from saved P, ViT-L/14's text tower (S = 77, H = 12, causal)
# recomputing P; each (B, S, H, D, causal, saved P)
BWD_TEETH_ONE_PASS = ((64, 50, 12, 64, False, True),
                      (64, 77, 8, 64, True, True),
                      (64, 77, 12, 64, True, False))
# the split flash pair's: GPT-345m's heads at S = 8192 (rate 0) and the
# pipeline GPT's (D = 128, rate 0.1), causal on the packed projection's head
# views; each (B, S, H, D, rate)
FLASH_SPLIT_TEETH = ((1, 8192, 16, 64, 0.0), (1, 8192, 16, 128, DROPOUT_RATE))


def bwd_teeth(kernels_build, gen, mha) -> None:
    """The wgmma backwards past S = 128 (recomputing P, and from saved P in
    the forward's padded layout), the one-pass backward at S <= 128 and
    the wgmma split flash pair built wrong on purpose (TILE_FAULTS), as an
    off-by-one at a tile's bound would: part 1 and the dQ kernel leave the
    last key of every key tile out of dQ (part 1 also of delta), part 2 and
    the dKV kernel the last query of every 64-query tile out of dK and dV,
    in the whole sequence or in the tiles of its late half; the one-pass
    kernel leaves each query row's last unmasked key out of its delta and
    dS and each key's last query out of its dK and dV, in every row or in
    the rows of the late half. Run through the same wrappers on the plain
    forward's statistics or P (flash: lse and delta) and held against the
    plain backward, each of dQ, dK and dV must fail the row bound that
    phase 3 holds the right kernels to; beside it is logged what a bound
    scaled by the largest |value| reads (the fused backwards' bf16 bounds
    of TOLERANCES; for flash, as flash_bwd_teeth, 2^-7 of it plus rtol
    1.6e-2)."""
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    dt = torch.bfloat16
    cases = []
    for b, s, h, d, causal, rate in BWD_TEETH:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        drop = (AttentionDropout(rate, DROPOUT_CHECK_SEED, 2) if rate
                else None)
        keep = None if drop is None else drop.multipliers(
            b, h, s, s, mha.dropout_mult(rate, dt), "cuda")
        _, stats = mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                       with_stats=True, keep=keep)
        want = mha.fused_mha_bwd_recompute_plain(qkv, g, h, d ** -0.5,
                                                 causal, keep)
        if drop is None:
            name = "fused_mha_bwd_recompute"
            run = (lambda qkv=qkv, g=g, stats=stats, h=h, causal=causal:
                   mha.fused_mha_bwd_recompute(qkv, g, stats, h,
                                               causal=causal))
        else:
            name = "fused_mha_dropout_bwd"
            run = (lambda qkv=qkv, g=g, stats=stats, h=h, causal=causal,
                   drop=drop: mha.fused_mha_dropout_bwd(
                       qkv, g, stats, h, drop, causal=causal))
        cases.append((f"B={b} S={s} H={h} D={d} causal={causal} "
                      f"rate={rate}", dict.fromkeys(("dq", "dk", "dv"), name),
                      lambda run=run, h=h: mha_parts(run(), h),
                      mha_parts(want, h)))
    for b, s, h, d, causal in BWD_TEETH_SAVED:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        p = mha.probs_buffer(b, h, s, d, dt, "cuda").copy_(
            mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                with_probs=True)[1])
        want = mha.fused_mha_bwd_plain(qkv, g, p, h, d ** -0.5)
        cases.append((f"B={b} S={s} H={h} D={d} causal={causal} saved P",
                      dict.fromkeys(("dq", "dk", "dv"), "fused_mha_bwd"),
                      lambda qkv=qkv, g=g, p=p, h=h, causal=causal: mha_parts(
                          mha.fused_mha_bwd(qkv, g, p, h, causal=causal), h),
                      mha_parts(want, h)))
    for b, s, h, d, causal, saved in BWD_TEETH_ONE_PASS:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        if saved:
            _, p = mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                       with_probs=True)
            name, want = "fused_mha_bwd", mha.fused_mha_bwd_plain(
                qkv, g, p, h, d ** -0.5)
            run = (lambda qkv=qkv, g=g, p=p, h=h, causal=causal:
                   mha.fused_mha_bwd(qkv, g, p, h, causal=causal))
        else:
            _, stats = mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                           with_stats=True)
            name, want = ("fused_mha_bwd_recompute",
                          mha.fused_mha_bwd_recompute_plain(
                              qkv, g, h, d ** -0.5, causal))
            run = (lambda qkv=qkv, g=g, stats=stats, h=h, causal=causal:
                   mha.fused_mha_bwd_recompute(qkv, g, stats, h,
                                               causal=causal))
        cases.append((f"B={b} S={s} H={h} D={d} causal={causal} one pass",
                      dict.fromkeys(("dq", "dk", "dv"), name),
                      lambda run=run, h=h: mha_parts(run(), h),
                      mha_parts(want, h)))
    for b, s, h, d, rate in FLASH_SPLIT_TEETH:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1, 4).unbind(0)
        do = torch.randn(b, s, h, d, device="cuda", generator=gen,
                         dtype=dt).transpose(1, 2)
        drop = (AttentionDropout(rate, DROPOUT_CHECK_SEED, 3) if rate
                else None)
        keep = None if drop is None else drop.multipliers(
            b, h, s, s, fa.dropout_mult(rate), "cuda")
        out, lse = fa.flash_fwd_plain(q, k, v, d ** -0.5, True, keep)
        delta = fa.flash_delta(do, out)
        want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, d ** -0.5,
                                      True, keep),
                *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, d ** -0.5,
                                        True, keep))
        del keep, out
        torch.cuda.empty_cache()
        tag = "" if drop is None else "_dropout"

        def run(q=q, k=k, v=v, do=do, lse=lse, delta=delta, drop=drop):
            kw = dict(causal=True)
            if drop is None:
                return (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                        *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
            return (fa.flash_bwd_dq_dropout(q, k, v, do, lse, delta, drop,
                                            **kw),
                    *fa.flash_bwd_dkv_dropout(q, k, v, do, lse, delta, drop,
                                              **kw))
        cases.append((f"B={b} S={s} H={h} D={d} causal=True rate={rate}",
                      {"dq": f"flash_bwd_dq{tag}",
                       "dk": f"flash_bwd_dkv{tag}",
                       "dv": f"flash_bwd_dkv{tag}"}, run, want))
    for faults in TILE_FAULTS:
        fault = faults[1]
        with kernels_build.variant(*faults):
            for label, names, run, want in cases:
                for part, gp, wp in zip(("dq", "dk", "dv"), run(), want):
                    name = names[part]
                    if name.startswith("flash"):
                        row = rows_used(gp, wp, *TOLERANCES[name]["bf16"])
                        w = wp.float()
                        old = float(((gp.float() - w).abs() / (
                            2 ** -7 * w.abs().max() + 1.6e-2 * w.abs())).max())
                    else:
                        row = rows_used(gp, wp,
                                        *TOLERANCES[f"{name} rows"]["bf16"])
                        old = bf16_share(gp, wp, name)
                    log(f"  {name} {label} built with {fault}, {part}: "
                        f"{row:.3f} of the row bound, {old:.3f} of the "
                        "largest-|value| bound")
                    if row <= 1:
                        raise AssertionError(
                            f"{name} {label}: the row bound passes a "
                            f"backward built with {fault} ({part})")
    del cases
    torch.cuda.empty_cache()


# the norm backward's teeth: bf16 rows with an fp32 scale (fp32 column
# sums) at ViT-B/32's vision rows (a row a warp) and text rows (a
# half-warp), the pipeline GPT's (two-warp rows) and the example GPT's
# RMSNorm rows; each (kernel, rows, W)
LN_TEETH = (("layer_norm", TRAIN_BATCH * 50, 768),
            ("layer_norm", TRAIN_BATCH * 77, 512),
            ("layer_norm", 8 * 2048, 2048),
            ("rms_norm", 8 * 2048, 1024))


def ln_bwd_teeth(kernels_build, gen, ln) -> None:
    """The norm backward built wrong on purpose (LN_BWD_FAULTS), run through
    the same wrappers and held against the plain version on the same
    inputs: with each row group's last row left out of the column sums,
    dscale (and dbias) must fail TOLERANCES[name]["sums"]; with the previous
    row's mean(g xhat) in each row's last register chunk, dx must fail the
    bf16 bound TOLERANCES[name]["bf16"]; each by LN_TEETH_FACTOR or more.
    Both shares are logged for both builds."""
    for kind, rows, w in LN_TEETH:
        name = f"{kind}_bwd"
        x = (torch.randn(rows, w, device="cuda", generator=gen) * 3
             + 1).to(torch.bfloat16)
        dy = torch.randn(rows, w, device="cuda",
                         generator=gen).to(torch.bfloat16)
        scale = torch.randn(w, device="cuda", generator=gen)
        want = getattr(ln, f"{name}_plain")(x, scale, dy)
        for fault, must in zip(LN_BWD_FAULTS, ("sums", "dx")):
            with kernels_build.variant(fault):
                got = getattr(ln, name)(x, scale, dy)
            used = {"dx": bf16_share(got[0], want[0], name),
                    "sums": max(bound_share(g, wg, *TOLERANCES[name]["sums"])
                                for g, wg in zip(got[1:], want[1:]))}
            log(f"  {name} rows={rows} W={w} built with {fault}: "
                f"{used['dx']:.3f} of the dx bound, {used['sums']:.3f} of "
                "the column sums' bound")
            if used[must] < LN_TEETH_FACTOR:
                raise AssertionError(
                    f"{name} rows={rows} W={w} built with {fault}: its "
                    f"{must} use {used[must]:.3f} of their bound, under "
                    f"{LN_TEETH_FACTOR}x")


def sm90_tile_checks(gen) -> None:
    """Each Hopper library's wgmma tile product (csrc/sm90.cuh) in every
    operand layout and (N, K) its kernels use, the tiles staged by TMA and by
    the threads' swizzled stores, against the fp32 product of the same bf16
    values: fp32 sums of 64 or 128 exact products in another order, within
    1e-5 relative plus 1e-4; a wrong descriptor or swizzle moves whole rows
    or columns, O(1) errors."""
    from megatron_clip_tpu_torch.ops.kernels import sm90
    a = torch.randn(64, 128, device="cuda", generator=gen).to(torch.bfloat16)
    b = torch.randn(128, 256, device="cuda", generator=gen).to(torch.bfloat16)
    major = ("K-major", "MN-major")
    for lib in sm90.LIBRARIES:
        for ta, tb, regs, n, k in sm90.LAYOUTS:
            ak, bn = a[:, :k], b[:k, :n]
            want = sm90.tile_product_plain(ak, bn)
            for tma in (0, 1):
                a_from = "registers" if regs else major[ta]
                label = (f"wgmma tile {lib}: N={n} K={k}, A {a_from}, B "
                         f"{major[tb]}, {'TMA' if tma else 'stores'}")
                compare(label, sm90.tile_product(lib, ak, bn, ta=ta, tb=tb,
                                                 a_regs=regs, via_tma=tma),
                        want, 1e-4, 1e-5)


def routed_mha_checks(errs, gen, mha, shapes) -> None:
    """The fused-MHA forwards and both backwards on the route fused_mha.cu
    picks, fp32 and bf16, at each (B, S, H, D, causal) of `shapes`, against
    their plain versions (bf16 row by row too); the saved-P backward's
    wgmma checks (`saved_bwd_checks`) where its shape is in
    SAVED_BWD_SHAPES or is phase 13's past S = 128."""
    saved = set(SAVED_BWD_SHAPES) | {
        shape[1:] for shape in recipe_shapes()[0] if shape[2] > 128}
    for b, s, h, d, causal in shapes:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen)
        do = torch.randn(b, s, h * d, device="cuda", generator=gen)
        scale = d ** -0.5
        label = f"B={b} S={s} H={h} D={d} causal={causal}"
        for dtype in (torch.float32, torch.bfloat16):
            x, g = qkv.to(dtype), do.to(dtype)

            def plain(dt, probs=False, stats=False):
                return mha.fused_mha_plain(x.to(dt), h, scale, causal,
                                           with_probs=probs, with_stats=stats)

            def rows(what, out):
                if dtype == torch.bfloat16:
                    check_fwd_rows(errs, "fused_mha_fwd", label + what, out,
                                   plain(dtype), mha.fused_mha_row_bound(
                                       x, h, causal))
            out = mha.fused_mha_fwd(x, h, causal=causal)
            check_kernel(errs, "fused_mha_fwd", label, out, plain)
            rows("", out)
            out, p = mha.fused_mha_fwd(x, h, causal=causal, with_probs=True)
            check_kernel(errs, "fused_mha_fwd", label + " with P: out", out,
                         plain)
            rows(" with P: out", out)
            check_kernel(errs, "fused_mha_fwd P", label, p,
                         lambda dt: plain(dt, True)[1])
            out, stats = mha.fused_mha_fwd(x, h, causal=causal,
                                           with_stats=True)
            check_kernel(errs, "fused_mha_fwd", label + " with stats: out",
                         out, plain)
            rows(" with stats: out", out)
            check_kernel(errs, "fused_mha_fwd stats", label, stats,
                         lambda dt: plain(dt, stats=True)[1], dtype)
            # the backward from the plain version's P in the forward's
            # layout, so that it alone is compared; the recompute from the
            # kernel's own statistics
            p = mha.probs_buffer(b, h, s, d, dtype, "cuda").copy_(
                plain(dtype, True)[1])
            bwd_plain = functools.lru_cache(None)(
                lambda dt: mha.fused_mha_bwd_plain(x.to(dt), g.to(dt),
                                                   p.to(dt), h, scale))
            got = mha.fused_mha_bwd(x, g, p, h, causal=causal)
            check_kernel(errs, "fused_mha_bwd", label, got, bwd_plain)
            if dtype == torch.bfloat16:
                check_mha_rows(errs, "fused_mha_bwd", label, got, bwd_plain,
                               h)
                if (b, s, h, d, causal) in saved:
                    saved_bwd_checks(errs, mha, label, x, g, p, h, causal,
                                     got, bwd_plain)
            del got, bwd_plain
            rc_plain = functools.lru_cache(None)(
                lambda dt: mha.fused_mha_bwd_recompute_plain(
                    x.to(dt), g.to(dt), h, scale, causal))
            got = mha.fused_mha_bwd_recompute(x, g, stats, h, causal=causal)
            check_kernel(errs, "fused_mha_bwd_recompute", label, got,
                         rc_plain)
            if dtype == torch.bfloat16:
                check_mha_rows(errs, "fused_mha_bwd_recompute", label, got,
                               rc_plain, h)
            del got, rc_plain


def layer_norm_checks(errs, gen, ln, shapes) -> None:
    """LayerNorm forward and backward, fp32 and bf16, at each (rows, width)
    of `shapes`, against their plain versions; a bf16 scale and bias too
    (`norm_param_checks`)."""
    for rows, w in shapes:
        x = torch.randn(rows, w, device="cuda", generator=gen) * 3 + 1
        dy = torch.randn(rows, w, device="cuda", generator=gen)
        scale = torch.randn(w, device="cuda", generator=gen)
        bias = torch.randn(w, device="cuda", generator=gen)
        label = f"rows={rows} W={w}"
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), dy.to(dtype)
            check_kernel(
                errs, "layer_norm_fwd", label,
                ln.layer_norm_fwd(xd, scale, bias),
                lambda dt: ln.layer_norm_plain(xd.to(dt), scale, bias))
            dx, dscale, dbias = ln.layer_norm_bwd(xd, scale, gd)
            check_kernel(
                errs, "layer_norm_bwd", label + " dx", dx,
                lambda dt: ln.layer_norm_bwd_plain(xd.to(dt), scale,
                                                   gd.to(dt))[0])
            _, want_scale, want_bias = ln.layer_norm_bwd_plain(xd, scale, gd)
            for part, got, want in (("dscale", dscale, want_scale),
                                    ("dbias", dbias, want_bias)):
                e = compare(f"layer_norm_bwd {label} {dtype} {part}", got,
                            want, *TOLERANCES["layer_norm_bwd"]["sums"])
                errs["layer_norm_bwd"]["sums"] = max(
                    errs["layer_norm_bwd"].get("sums", 0.0), e)
            norm_param_checks(ln, "layer_norm", label, xd, gd, scale, bias)


def gpt_eval_checks(errs, gen, ln) -> None:
    """Phase 15's eval forwards at its shapes, bf16: the whole global batch
    of examples/pretrain_gpt_dist.sh in one forward (64 x 2048 tokens at
    width 1024, 16 heads of 64, causal): the flash forward (the plain
    version run a slice of 8 sequences at a time, its scores being per
    sequence), the RMSNorm forward on its rows and the fused CE forward on
    its tokens, each against its plain version."""
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
    b, h, s, d = 64, 16, 2048, 64
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    label = f"eval B={b} H={h} S={s} D={d} causal"

    def sliced(dt):
        return torch.cat([fa.flash_fwd_plain(
            q[i:i + 8].to(dt), k[i:i + 8].to(dt), v[i:i + 8].to(dt),
            d ** -0.5, True)[0] for i in range(0, b, 8)])
    check_kernel(errs, "flash_fwd", label, fa.flash_fwd(q, k, v,
                                                        causal=True)[0],
                 sliced)
    del q, k, v
    rows, w, vocab = b * s, 1024, 50304
    x = (torch.randn(rows, w, device="cuda", generator=gen) * 3 + 1).bfloat16()
    scale = torch.randn(w, device="cuda", generator=gen)
    check_kernel(errs, "rms_norm_fwd", f"eval rows={rows} W={w}",
                 ln.rms_norm_fwd(x, scale),
                 lambda dt: ln.rms_norm_plain(x.to(dt), scale))
    del x
    x, head, labels, _ = ce_inputs(gen, rows, w, vocab, True, torch.bfloat16)
    loss, _ = ce.fused_ce_fwd(x, head, labels)
    check_kernel(errs, "fused_ce_fwd", f"eval T={rows} W={w} V={vocab} tied "
                 "head", loss, lambda dt: ce.fused_ce_fwd_plain(
                     x.to(dt), head.to(dt), labels)[0], torch.bfloat16)
    del x, head, labels, loss
    torch.cuda.empty_cache()


def phase_kernels(mha, ln):
    """Kernel vs plain version; returns the worst errors per kernel and
    kind of comparison."""
    log("[3] kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {name: {} for name in KERNELS}
    sm90_tile_checks(gen)
    recipe = recipe_shapes()
    routed_mha_checks(errs, gen, mha, [
        (TRAIN_BATCH, 50, 12, 64, False), (TRAIN_BATCH, 77, 8, 64, True),
        (SERVE_BATCH, 50, 12, 64, False), (SERVE_BATCH, 77, 8, 64, True),
        (4, 257, 16, 64, False),   # ViT-L vision
        (4, 257, 16, 80, False),   # ViT-H vision
        (4, 77, 16, 64, True),     # L/H text
        *(leg[2:] for leg in LEG_ATTENTION),
        (2, 1024, 2, 128, False), (2, 1024, 2, 128, True),
        (4, 197, 12, 64, False), (2, 300, 4, 64, True),
        (2, 257, 16, 80, False), (3, 33, 2, 40, True), (2, 45, 3, 36, True),
        *(shape[1:] for shape in recipe[0])])
    one_pass_checks(errs, gen, mha)
    one_pass_bwd_checks(errs, gen, mha)
    smajor_views(mha, gen)
    flash_checks(errs, gen)
    flash_views(gen)
    fused_ce_checks(errs, gen)
    fused_dropout_checks(errs, gen, mha)
    flash_dropout_checks(errs, gen)
    from megatron_clip_tpu_torch.ops.kernels import _build
    dropout_teeth(_build, gen, mha)
    fwd_teeth(_build, gen, mha)
    bwd_teeth(_build, gen, mha)
    # the legs' LayerNorms: rows B*S at the tower's width H*D; GPT-345m's
    # and the pipeline GPT's: rows B*S at their widths; phase 13's
    legs_ln = [(b * s, h * d) for _, _, b, s, h, d, _ in LEG_ATTENTION]
    pipeline_rows = sorted({b * s for b, s, *_ in PIPELINE_RUNS
                            + (PIPELINE_LONG,)})
    gpt_ln = [(b * s, GPT_345M["hidden_size"]) for b, s in GPT_SHAPES] + [
        (rows, PIPELINE_GPT["hidden_size"]) for rows in pipeline_rows]
    layer_norm_checks(errs, gen, ln, [
        (TRAIN_BATCH * 50, 768), (TRAIN_BATCH * 77, 512),
        (SERVE_BATCH * 50, 768), (SERVE_BATCH * 77, 512), *legs_ln, *gpt_ln,
        *recipe[1], (1000, 768), (5, 100), (3, 4100)])
    rms_checks(errs, gen, ln)
    gpt_eval_checks(errs, gen, ln)
    ln_bwd_teeth(_build, gen, ln)
    return errs


def phase_goldens(port):
    log("[4] goldens: ViT-B-32-quickgelu fp32 vs open_CLIP features")
    from megatron_clip_tpu_torch.bridge import params_from_openclip_state_dict
    from megatron_clip_tpu_torch.utils.det_weights import (det_images,
                                                           det_state_dict,
                                                           det_texts)
    z = np.load(REPO / "tests" / "goldens" / "full" / "vitb32.npz")
    manifest = json.loads(bytes(z["manifest"]).decode())
    model = port.create_model("ViT-B-32-quickgelu", precision="fp32")
    sd = det_state_dict("vitb32", [(k, tuple(s)) for k, s in manifest])
    model.load_state_dict(params_from_openclip_state_dict(sd, model.cfg))
    img = model.encode_image(det_images("vitb32", 4, 224))
    txt = model.encode_text(det_texts("vitb32", 4, 77, 49408, sot=49406,
                                      eot=49407, pad_tail=2))
    return {
        "image_features": compare("image_features", img,
                                  torch.from_numpy(z["image_features"]).cuda(),
                                  1e-4, 0.0),
        "text_features": compare("text_features", txt,
                                 torch.from_numpy(z["text_features"]).cuda(),
                                 1e-4, 0.0),
    }


def phase_serving(port, mha, ln, card: str):
    log("[5] serving: ViT-B-32 bf16 zero-shot, 1000 classes x 7 templates, "
        f"{SERVE_REQUESTS} requests of {SERVE_BATCH} images")
    from megatron_clip_tpu_torch.evaluation import zero_shot as zs
    model = port.create_model("ViT-B-32", precision="bf16", seed=0)
    tokenizer = port.get_tokenizer("ViT-B-32")
    classnames, _ = zs.load_imagenet_metadata()
    rng = np.random.default_rng(0)
    requests = [rng.standard_normal((SERVE_BATCH, 224, 224, 3),
                                    dtype=np.float32)
                for _ in range(SERVE_REQUESTS)]
    vlayers = model.cfg.vision.layers
    tlayers = model.cfg.text.layers

    zero_counts(mha, ln)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    classifier = zs.build_zero_shot_classifier(
        model, classnames, zs.SIMPLE_IMAGENET_TEMPLATES, tokenizer,
        batch_size=CLASSES_PER_TEXT_BATCH)
    torch.cuda.synchronize()
    classifier_s = time.perf_counter() - t0
    latencies, answers = [], []
    window0 = time.perf_counter()
    for images in requests:
        t0 = time.perf_counter()
        logits = zs.zero_shot_classification(model, classifier, images)
        top5 = logits.topk(5, dim=-1).indices.cpu()
        latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append((logits, top5))
    window_s = time.perf_counter() - window0
    counts = read_counts(mha, ln)
    n_mha, n_ln = counts["fused_mha_fwd"], counts["layer_norm_fwd"]

    text_fwd = math.ceil(len(classnames) / CLASSES_PER_TEXT_BATCH)
    image_fwd = SERVE_REQUESTS
    want_mha = vlayers * image_fwd + tlayers * text_fwd
    want_ln = (2 * vlayers + 2) * image_fwd + (2 * tlayers + 1) * text_fwd
    log(f"  launches: fused_mha_fwd {n_mha} (expected {want_mha} = "
        f"{vlayers}x{image_fwd} image + {tlayers}x{text_fwd} text forwards), "
        f"layer_norm_fwd {n_ln} (expected {want_ln} = "
        f"{2 * vlayers + 2}x{image_fwd} + {2 * tlayers + 1}x{text_fwd})")
    log(f"  backward launches: fused_mha_bwd {counts['fused_mha_bwd']}, "
        f"fused_mha_bwd_recompute {counts['fused_mha_bwd_recompute']}, "
        f"layer_norm_bwd {counts['layer_norm_bwd']} (expected 0)")
    if counts != dict(dict.fromkeys(counts, 0), fused_mha_fwd=want_mha,
                      layer_norm_fwd=want_ln):
        raise AssertionError("serving path launch counts differ from the "
                             "expected kernel launches")
    if classifier.shape != (model.cfg.embed_dim, len(classnames)):
        raise AssertionError(f"classifier shape {tuple(classifier.shape)}")
    if not torch.isfinite(classifier).all():
        raise AssertionError("classifier has non-finite values")
    for logits, top5 in answers:
        if logits.shape != (SERVE_BATCH, len(classnames)) or \
                not torch.isfinite(logits).all():
            raise AssertionError("bad logits")
        if top5.shape != (SERVE_BATCH, 5) or int(top5.min()) < 0 or \
                int(top5.max()) >= len(classnames):
            raise AssertionError("bad top-5 answers")

    fp32 = port.create_model("ViT-B-32", precision="fp32", seed=0)
    fp32.load_state_dict(model.state_dict())
    cos = (model.encode_image(requests[0])
           * fp32.encode_image(requests[0])).sum(-1)
    min_cos = float(cos.min())
    log(f"  bf16 vs fp32 image features: min per-row cosine {min_cos:.6f}")
    if min_cos < 0.999:
        raise AssertionError("bf16 features disagree with fp32 (cosine < "
                             "0.999)")

    on_card = torch.from_numpy(requests[0]).cuda()
    model_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zs.zero_shot_classification(model, classifier, on_card)
        torch.cuda.synchronize()
        model_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(latencies))
    result = {
        "card": card,
        "classifier_build_s": classifier_s,
        "request_latency_ms_median": median,
        "request_latency_ms": latencies,
        "window_s": window_s,
        "images_per_s": SERVE_REQUESTS * SERVE_BATCH / window_s,
        "on_card_batch_ms_median": float(np.median(model_ms)),
        "min_cosine_bf16_vs_fp32": min_cos,
        "launches": counts,
    }
    log(f"  serving: {json.dumps(result)}")
    return result


def timing_row(kernel: str, shape: str, fn, plain, library, cost,
               ops_dtype: torch.dtype, reps: int = 20) -> dict:
    nbytes, ops = cost
    bms, by = bound_ms(nbytes, ops, ops_dtype)
    warm = min(3, reps)
    row = {"kernel": kernel, "shape": shape, "ms": cuda_ms(fn, reps, warm),
           "plain_ms": cuda_ms(plain, reps, warm),
           "library_ms": (None if library is None
                          else cuda_ms(library, reps, warm)),
           "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}
    lib = "none" if library is None else f"{row['library_ms']:.4f} ms"
    log(f"  {kernel} {shape}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {lib}, bound {bms:.4f} ms "
        f"({by})")
    return row


def add_route_times(row: dict, fn, x, h: int) -> None:
    """At S <= 128, D = 64 (the one-pass kernels' shapes): the time of
    fn(route), a forward or a backward, on each kernel that can take the
    shape, in this call beside the row's own (the route fused_mha.cu
    picks): tc:: and the one-pass kernel. Kept in row["routes_ms"]."""
    s, d = x.shape[1], x.shape[2] // (3 * h)
    if s > 128 or d != 64:
        return
    row["routes_ms"] = {r: cuda_ms(lambda r=r: fn(r))
                        for r in ("tc", "one_pass")}
    log("    on each kernel: " + ", ".join(
        f"{r} {ms:.4f} ms" for r, ms in row["routes_ms"].items()))


def leg_attention_rows(mha, gen, leg, tower, b, s, h, d, causal) -> list:
    """bf16 rows of one leg's attention: the forward with row statistics
    and the recompute backward (at ViT-L/14 vision also on the S-major
    view), each beside SDPA's forward or backward on pre-split q, k, v; at
    the vision towers also the saved-P mode, the forward writing P and the
    backward reading it, the backward beside tc::'s pair on the same P
    (routes_ms) and three readings of SDPA's backward, which spread between
    readings (library_readings_ms)."""
    dt = torch.bfloat16
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen, dtype=dt)
    do = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
    q, k, v = (t.contiguous() for t in qkv.reshape(
        b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
    lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    ldo = do.reshape(b, s, h, d).transpose(1, 2).contiguous()

    def sdpa_bwd():
        return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    shape = f"{leg} {tower} B={b} S={s} H={h} D={d} causal={causal} bf16"
    views = [("", qkv, do)]
    if leg == "ViT-L/14" and tower == "vision":
        views.append((" S-major view", *(t.transpose(0, 1).contiguous()
                                         .transpose(0, 1) for t in (qkv, do))))
    rows = []
    for tag, x, g in views:
        _, stats = mha.fused_mha_fwd(x, h, causal=causal, with_stats=True)
        rows.append(timing_row(
            "fused_mha_fwd", shape + " with stats" + tag,
            lambda: mha.fused_mha_fwd(x, h, causal=causal, with_stats=True),
            lambda: mha.fused_mha_plain(x, h, d ** -0.5, causal,
                                        with_stats=True),
            sdpa_fwd, mha_cost(b, s, h, d, causal, 2, with_stats=True), dt))
        add_route_times(rows[-1], lambda r: mha.fused_mha_fwd(
            x, h, causal=causal, with_stats=True, route=r), x, h)
        rows.append(timing_row(
            "fused_mha_bwd_recompute", shape + tag,
            lambda: mha.fused_mha_bwd_recompute(x, g, stats, h,
                                                causal=causal),
            lambda: mha.fused_mha_bwd_recompute_plain(x, g, h, d ** -0.5,
                                                      causal),
            sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2, recompute=True),
            dt))
        add_route_times(rows[-1], lambda r: mha.fused_mha_bwd_recompute(
            x, g, stats, h, causal=causal, route=r), x, h)
        if tower == "vision" and not tag:
            rows.append(timing_row(
                "fused_mha_fwd", shape + " with P",
                lambda: mha.fused_mha_fwd(x, h, causal=causal,
                                          with_probs=True),
                lambda: mha.fused_mha_plain(x, h, d ** -0.5, causal,
                                            with_probs=True),
                sdpa_fwd, mha_cost(b, s, h, d, causal, 2, with_probs=True),
                dt))
            _, p = mha.fused_mha_fwd(x, h, causal=causal, with_probs=True)
            row = timing_row(
                "fused_mha_bwd", shape,
                lambda: mha.fused_mha_bwd(x, g, p, h, causal=causal),
                lambda: mha.fused_mha_bwd_plain(x, g, p, h, d ** -0.5),
                sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2), dt)
            row["routes_ms"] = {"tc": cuda_ms(lambda: mha.fused_mha_bwd(
                x, g, p, h, causal=causal, route="tc"))}
            row["library_readings_ms"] = [row["library_ms"]] + [
                cuda_ms(sdpa_bwd) for _ in range(2)]
            log(f"    on tc:: {row['routes_ms']['tc']:.4f} ms; SDPA's "
                "backward " + " / ".join(
                    f"{ms:.4f}" for ms in row["library_readings_ms"]) + " ms")
            rows.append(row)
            del p
    return rows


def siglip_attention_rows(mha, gen) -> list:
    """bf16 rows of phase 13's attention (`recipe_shapes`): the forward
    without P (the accumulation's cache pass), the forward with P and the
    saved-P backward (its blocks, and LiT's steps), each beside SDPA's
    forward or backward on pre-split q, k, v and, at the one-pass kernels'
    shapes, on tc:: and the one-pass kernel, in the same call."""
    dt = torch.bfloat16
    rows = []
    for tower, b, s, h, d, causal in recipe_shapes()[0]:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        do = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
        q, k, v = (t.contiguous() for t in qkv.reshape(
            b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        ldo = do.reshape(b, s, h, d).transpose(1, 2).contiguous()

        def sdpa_fwd():
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        def sdpa_bwd():
            return torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                       retain_graph=True)
        shape = (f"SigLIP {tower} B={b} S={s} H={h} D={d} causal={causal} "
                 "bf16")
        for probs in (False, True):
            rows.append(timing_row(
                "fused_mha_fwd", shape + (" with P" if probs else ""),
                lambda: mha.fused_mha_fwd(qkv, h, causal=causal,
                                          with_probs=probs),
                lambda: mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                            with_probs=probs),
                sdpa_fwd, mha_cost(b, s, h, d, causal, 2, with_probs=probs),
                dt))
            add_route_times(rows[-1], lambda r: mha.fused_mha_fwd(
                qkv, h, causal=causal, with_probs=probs, route=r), qkv, h)
        _, p = mha.fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
        rows.append(timing_row(
            "fused_mha_bwd", shape,
            lambda: mha.fused_mha_bwd(qkv, do, p, h, causal=causal),
            lambda: mha.fused_mha_bwd_plain(qkv, do, p, h, d ** -0.5),
            sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2), dt))
        add_route_times(rows[-1], lambda r: mha.fused_mha_bwd(
            qkv, do, p, h, causal=causal, route=r), qkv, h)
        del qkv, do, q, k, v, lq, lk, lv, lo, ldo, p
    return rows


def flash_rows(gen, b: int, s: int, h: int = 16, d: int = 64) -> list:
    """bf16 rows of GPT-345m's attention at batch b and length s, causal:
    each flash kernel on the packed projection's head views and dO in
    [B, S, H, D] storage (the train step's layouts), the backward kernels
    from the forward's out and lse. Library: SDPA's forward and, by
    autograd.grad, its backward (dq, dk and dv together) on contiguous
    q, k, v, beside the forward and the fused backward; no single PyTorch
    call computes dQ or dK, dV alone."""
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    dt = torch.bfloat16
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen, dtype=dt)
    do = torch.randn(b, s, h, d, device="cuda", generator=gen,
                     dtype=dt).transpose(1, 2)
    q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1, 4).unbind(0)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa.flash_delta(do, out)
    lq, lk, lv = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    ldo = do.contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(lq.detach(), lk.detach(),
                                              lv.detach(), is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(lo, (lq, lk, lv), ldo, retain_graph=True)
    shape = f"GPT-345m B={b} S={s} H={h} D={d} causal bf16"
    scale = d ** -0.5
    rows = [
        timing_row("flash_fwd", shape,
                   lambda: fa.flash_fwd(q, k, v, causal=True),
                   lambda: fa.flash_fwd_plain(q, k, v, scale, True),
                   sdpa_fwd, flash_cost(b, h, s, s, d, True, 2), dt),
        timing_row("flash_bwd_fused", shape,
                   lambda: fa.flash_bwd_fused(q, k, v, out, lse, do,
                                              causal=True),
                   lambda: fa.flash_bwd_fused_plain(q, k, v, out, lse, do,
                                                    scale, True),
                   sdpa_bwd, flash_bwd_cost("fused", b, h, s, s, d, True, 2),
                   dt),
        timing_row("flash_bwd_dq", shape,
                   lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                           causal=True),
                   lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 scale, True),
                   None, flash_bwd_cost("dq", b, h, s, s, d, True, 2), dt),
        timing_row("flash_bwd_dkv", shape,
                   lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                            causal=True),
                   lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  scale, True),
                   None, flash_bwd_cost("dkv", b, h, s, s, d, True, 2), dt),
    ]
    del lo, lq, lk, lv
    torch.cuda.empty_cache()
    return rows


# the fused CE's timed shapes (T, W, V): the example GPT's, then the
# pipeline GPT's W = 2048
CE_PATHS = ((8 * 2048, 1024, 50304), (8 * 2048, 2048, 50304))


def fused_ce_rows(gen) -> list:
    """bf16 rows of the fused CE at the example GPT's and the pipeline GPT's
    shapes, tied head: the forward and the backward (from the forward's
    lse). Library: two calls, F.cross_entropy(x @ w, labels,
    reduction="none"), and for the backward their autograd.grad to x and w
    on a kept graph; no one PyTorch call computes this function. 5 timed
    launches each (the plain versions take tens of ms)."""
    from megatron_clip_tpu_torch.ops.kernels import fused_ce as ce
    dt = torch.bfloat16
    rows = []
    for (t, w, v), name in zip(CE_PATHS, ("example GPT", "pipeline GPT")):
        x, head, labels, dloss = ce_inputs(gen, t, w, v, True, dt)
        _, lse = ce.fused_ce_fwd(x, head, labels)
        lx, lw = (a.detach().requires_grad_(True) for a in (x, head))
        ly = F.cross_entropy(lx @ lw, labels, reduction="none")
        dly = dloss.to(dt)

        def lib_fwd():
            return F.cross_entropy(x @ head, labels, reduction="none")

        def lib_bwd():
            return torch.autograd.grad(ly, (lx, lw), dly, retain_graph=True)
        shape = f"{name} T={t} W={w} V={v} tied bf16"
        rows += [
            timing_row("fused_ce_fwd", shape,
                       lambda: ce.fused_ce_fwd(x, head, labels),
                       lambda: ce.fused_ce_fwd_plain(x, head, labels),
                       lib_fwd, ce_cost(t, w, v, 2), dt, reps=5),
            timing_row("fused_ce_bwd", shape,
                       lambda: ce.fused_ce_bwd(x, head, labels, lse, dloss),
                       lambda: ce.fused_ce_bwd_plain(x, head, labels, lse,
                                                     dloss),
                       lib_bwd, ce_cost(t, w, v, 2, backward=True), dt,
                       reps=5),
        ]
        del ly, lx, lw, x, head, labels, dloss, lse
        torch.cuda.empty_cache()
    return rows


def rms_fwd_row(gen, ln) -> dict:
    """The bf16 row of the RMSNorm forward at the example GPT's rows (8 x
    2048 at width 1024, its fp32 scale). Library: F.rms_norm."""
    dt = torch.bfloat16
    n, w = 8 * 2048, 1024
    x = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
    scale = torch.randn(w, device="cuda", generator=gen)
    scale_bf = scale.to(dt)
    return timing_row("rms_norm_fwd", f"example GPT rows={n} W={w} bf16",
                      lambda: ln.rms_norm_fwd(x, scale),
                      lambda: ln.rms_norm_plain(x, scale),
                      lambda: F.rms_norm(x, (w,), scale_bf, 1e-6),
                      rms_cost(n, w, 2), torch.float32)


def norm_bwd_rows(gen, ln) -> list:
    """bf16 rows of the LayerNorm and RMSNorm backwards at every path's rows
    (tools/ab_backward.py's NORM_ROWS), the scale in the path's dtype (bf16
    on the pure_bf16 legs, fp32 for the GPTs on fp32 weights). Library:
    autograd.grad of F.layer_norm / F.rms_norm, on bf16 parameters."""
    from megatron_clip_tpu_torch.tools.ab_backward import NORM_ROWS
    dt = torch.bfloat16
    rows = []
    for path, kind, n, w, pdt in NORM_ROWS:
        x = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
        dy = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
        scale, bias = (torch.randn(w, device="cuda", generator=gen)
                       for _ in range(2))
        pdtype = dt if pdt == "bf16" else torch.float32
        scale = scale.to(pdtype)
        lx, ls, lb = (a.detach().to(dt).requires_grad_(True)
                      for a in (x, scale, bias))
        if kind == "layer_norm":
            ly, lib_in = F.layer_norm(lx, (w,), ls, lb, 1e-5), (lx, ls, lb)
            cost = ln_bwd_cost(n, w, 2, pdtype.itemsize)
        else:
            ly, lib_in = F.rms_norm(lx, (w,), ls, 1e-6), (lx, ls)
            cost = rms_bwd_cost(n, w, 2, pdtype.itemsize)
        fn = getattr(ln, f"{kind}_bwd")
        plain = getattr(ln, f"{kind}_bwd_plain")
        rows.append(timing_row(
            f"{kind}_bwd", f"{path} rows={n} W={w} bf16, scale {pdt}",
            lambda: fn(x, scale, dy), lambda: plain(x, scale, dy),
            lambda: torch.autograd.grad(ly, lib_in, dy, retain_graph=True),
            cost, torch.float32))
        del x, dy, lx, ly, lib_in
        torch.cuda.empty_cache()
    return rows


def dropout_rows(gen, mha) -> list:
    """bf16 rows of the dropout kernels at the pipeline GPT's attention
    (H = 16, D = 128, causal, rate 0.1), each beside its rate-0 kernel on
    the same inputs: flash at batch 8 x S = 2048 (forward, fused backward;
    the packed projection's head views, as the train step) and batch 1 x
    S = 8192 (the split dQ and dKV backward), the fused route at batch 32 x
    S = 512 (forward with row statistics, recompute backward). The plain
    versions are timed on the Philox multipliers drawn once. The bound is
    the rate-0 function's (Philox is not counted), so a dropout row's ratio
    to it shows what dropout costs. Library: SDPA with dropout_p = 0.1
    (its forward, and its backward by autograd.grad on a kept graph) and
    without dropout beside the rate-0 rows; none for dQ or dKV alone, so
    at S = 8192 the fused backward is timed too, beside SDPA's whole
    backward, the yardstick of the split pair's sum."""
    from megatron_clip_tpu_torch.ops.dropout import AttentionDropout
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    dt, h, d = torch.bfloat16, PIPELINE_HEADS, PIPELINE_HEAD_DIM
    scale = d ** -0.5
    rows = []

    def sdpa_pair(q, k, v, do, p):
        lq, lk, lv = (t.detach().contiguous().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                            dropout_p=p)
        ldo = do.contiguous()

        def fwd():
            return F.scaled_dot_product_attention(
                lq.detach(), lk.detach(), lv.detach(), is_causal=True,
                dropout_p=p)

        def bwd():
            return torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                       retain_graph=True)
        return fwd, bwd
    for b, s in ((8, 2048), (1, 8192)):
        drop = AttentionDropout(DROPOUT_RATE, PIPELINE_SEED, 1)
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=dt)
        do = torch.randn(b, s, h, d, device="cuda", generator=gen,
                         dtype=dt).transpose(1, 2)
        q, k, v = qkv.unflatten(-1, (3, h, d)).permute(2, 0, 3, 1, 4).unbind(0)
        keep = drop.multipliers(b, h, s, s, fa.dropout_mult(drop.rate),
                                "cuda")
        out, lse = fa.flash_fwd_dropout(q, k, v, drop, causal=True)
        delta = fa.flash_delta(do, out)
        shape = (f"pipeline GPT B={b} S={s} H={h} D={d} causal rate=0.1 "
                 "bf16")
        zero = f"pipeline GPT B={b} S={s} H={h} D={d} causal rate=0 bf16"
        fwd_cost = flash_cost(b, h, s, s, d, True, 2)
        if s == 2048:
            drop_fwd, drop_bwd = sdpa_pair(q, k, v, do, DROPOUT_RATE)
            zero_fwd, zero_bwd = sdpa_pair(q, k, v, do, 0.0)
            rows += [
                timing_row("flash_fwd_dropout", shape,
                           lambda: fa.flash_fwd_dropout(q, k, v, drop,
                                                        causal=True),
                           lambda: fa.flash_fwd_plain(q, k, v, scale, True,
                                                      keep),
                           drop_fwd, fwd_cost, dt, reps=10),
                timing_row("flash_fwd", zero,
                           lambda: fa.flash_fwd(q, k, v, causal=True),
                           lambda: fa.flash_fwd_plain(q, k, v, scale, True),
                           zero_fwd, fwd_cost, dt, reps=10),
                timing_row("flash_bwd_fused_dropout", shape,
                           lambda: fa.flash_bwd_fused_dropout(
                               q, k, v, out, lse, do, drop, causal=True),
                           lambda: fa.flash_bwd_fused_plain(
                               q, k, v, out, lse, do, scale, True, keep),
                           drop_bwd, flash_bwd_cost("fused", b, h, s, s, d,
                                                    True, 2), dt, reps=10),
                timing_row("flash_bwd_fused", zero,
                           lambda: fa.flash_bwd_fused(q, k, v, out, lse, do,
                                                      causal=True),
                           lambda: fa.flash_bwd_fused_plain(
                               q, k, v, out, lse, do, scale, True),
                           zero_bwd, flash_bwd_cost("fused", b, h, s, s, d,
                                                    True, 2), dt, reps=10)]
        else:
            drop_fwd, drop_bwd = sdpa_pair(q, k, v, do, DROPOUT_RATE)
            zero_fwd, zero_bwd = sdpa_pair(q, k, v, do, 0.0)
            rows += [
                timing_row("flash_bwd_dq_dropout", shape,
                           lambda: fa.flash_bwd_dq_dropout(
                               q, k, v, do, lse, delta, drop, causal=True),
                           lambda: fa.flash_bwd_dq_plain(
                               q, k, v, do, lse, delta, scale, True, keep),
                           None, flash_bwd_cost("dq", b, h, s, s, d, True, 2),
                           dt, reps=5),
                timing_row("flash_bwd_dq", zero,
                           lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                   causal=True),
                           lambda: fa.flash_bwd_dq_plain(
                               q, k, v, do, lse, delta, scale, True),
                           None, flash_bwd_cost("dq", b, h, s, s, d, True, 2),
                           dt, reps=5),
                timing_row("flash_bwd_dkv_dropout", shape,
                           lambda: fa.flash_bwd_dkv_dropout(
                               q, k, v, do, lse, delta, drop, causal=True),
                           lambda: fa.flash_bwd_dkv_plain(
                               q, k, v, do, lse, delta, scale, True, keep),
                           None, flash_bwd_cost("dkv", b, h, s, s, d, True,
                                                2), dt, reps=5),
                timing_row("flash_bwd_dkv", zero,
                           lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                    causal=True),
                           lambda: fa.flash_bwd_dkv_plain(
                               q, k, v, do, lse, delta, scale, True),
                           None, flash_bwd_cost("dkv", b, h, s, s, d, True,
                                                2), dt, reps=5),
                # the fused backward at the split pair's shape, for
                # comparison, beside SDPA's whole backward
                timing_row("flash_bwd_fused_dropout", shape,
                           lambda: fa.flash_bwd_fused_dropout(
                               q, k, v, out, lse, do, drop, causal=True),
                           lambda: fa.flash_bwd_fused_plain(
                               q, k, v, out, lse, do, scale, True, keep),
                           drop_bwd, flash_bwd_cost("fused", b, h, s, s, d,
                                                    True, 2), dt, reps=5),
                timing_row("flash_bwd_fused", zero,
                           lambda: fa.flash_bwd_fused(q, k, v, out, lse, do,
                                                      causal=True),
                           lambda: fa.flash_bwd_fused_plain(
                               q, k, v, out, lse, do, scale, True),
                           zero_bwd, flash_bwd_cost("fused", b, h, s, s, d,
                                                    True, 2), dt, reps=5)]
            del drop_fwd, drop_bwd, zero_fwd, zero_bwd
        del qkv, do, q, k, v, keep, out, lse, delta
        torch.cuda.empty_cache()
    b, s = 32, 512
    drop = AttentionDropout(DROPOUT_RATE, PIPELINE_SEED, 1)
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen, dtype=dt)
    g = torch.randn(b, s, h * d, device="cuda", generator=gen, dtype=dt)
    keep = drop.multipliers(b, h, s, s, mha.dropout_mult(drop.rate, dt),
                            "cuda")
    _, stats = mha.fused_mha_dropout_fwd(qkv, h, drop, causal=True)
    q, k, v = (t.contiguous() for t in qkv.reshape(
        b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
    ldo = g.reshape(b, s, h, d).transpose(1, 2)
    drop_fwd, drop_bwd = sdpa_pair(q, k, v, ldo, DROPOUT_RATE)
    zero_fwd, zero_bwd = sdpa_pair(q, k, v, ldo, 0.0)
    shape = f"pipeline GPT B={b} S={s} H={h} D={d} causal rate=0.1 bf16"
    zero = f"pipeline GPT B={b} S={s} H={h} D={d} causal rate=0 bf16"
    fwd_cost = mha_cost(b, s, h, d, True, 2, with_stats=True)
    bwd_cost = mha_bwd_cost(b, s, h, d, True, 2, recompute=True)
    rows += [
        timing_row("fused_mha_dropout_fwd", shape,
                   lambda: mha.fused_mha_dropout_fwd(qkv, h, drop,
                                                     causal=True),
                   lambda: mha.fused_mha_plain(qkv, h, scale, True,
                                               with_stats=True, keep=keep),
                   drop_fwd, fwd_cost, dt, reps=10),
        timing_row("fused_mha_fwd", zero + " with stats",
                   lambda: mha.fused_mha_fwd(qkv, h, causal=True,
                                             with_stats=True),
                   lambda: mha.fused_mha_plain(qkv, h, scale, True,
                                               with_stats=True),
                   zero_fwd, fwd_cost, dt, reps=10),
        timing_row("fused_mha_dropout_bwd", shape,
                   lambda: mha.fused_mha_dropout_bwd(qkv, g, stats, h, drop,
                                                     causal=True),
                   lambda: mha.fused_mha_bwd_recompute_plain(
                       qkv, g, h, scale, True, keep),
                   drop_bwd, bwd_cost, dt, reps=10),
        timing_row("fused_mha_bwd_recompute", zero,
                   lambda: mha.fused_mha_bwd_recompute(qkv, g, stats, h,
                                                       causal=True),
                   lambda: mha.fused_mha_bwd_recompute_plain(
                       qkv, g, h, scale, True),
                   zero_bwd, bwd_cost, dt, reps=10)]
    del qkv, g, keep, stats, q, k, v, ldo
    torch.cuda.empty_cache()
    return rows


def phase_timings(mha, ln):
    """bf16 timings at the serving (batch 256) and training (batch 384)
    shapes. The library calls are yardsticks the port never calls:
    F.scaled_dot_product_attention on pre-split q/k/v and its backward, and
    F.layer_norm and its backward, the backwards by torch.autograd.grad on a
    kept graph."""
    log(f"[6] timings at the ViT-B/32 batch-{SERVE_BATCH} serving and "
        f"batch-{TRAIN_BATCH} training shapes and the ViT-L/14 and ViT-H/14 "
        "legs' attention shapes, bf16")
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for tower, s, h, causal in (("vision", 50, 12, False),
                                ("text", 77, 8, True)):
        d = 64
        for b in (SERVE_BATCH, TRAIN_BATCH):
            train = b == TRAIN_BATCH
            qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                              dtype=dt)
            q, k, v = (t.contiguous() for t in qkv.reshape(
                b, s, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0))
            shape = f"{tower} B={b} S={s} H={h} D={d} causal={causal} bf16"
            rows.append(timing_row(
                "fused_mha_fwd", shape + (" with P" if train else ""),
                lambda: mha.fused_mha_fwd(qkv, h, causal=causal,
                                          with_probs=train),
                lambda: mha.fused_mha_plain(qkv, h, d ** -0.5, causal,
                                            with_probs=train),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=causal),
                mha_cost(b, s, h, d, causal, 2, with_probs=train), dt))
            add_route_times(rows[-1], lambda r: mha.fused_mha_fwd(
                qkv, h, causal=causal, with_probs=train, route=r), qkv, h)
            if not train:
                continue
            do = torch.randn(b, s, h * d, device="cuda", generator=gen,
                             dtype=dt)
            _, p = mha.fused_mha_fwd(qkv, h, causal=causal, with_probs=True)
            lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
            ldo = do.reshape(b, s, h, d).transpose(1, 2).contiguous()
            sdpa_bwd = (lambda: torch.autograd.grad(lo, (lq, lk, lv), ldo,
                                                    retain_graph=True))
            rows.append(timing_row(
                "fused_mha_bwd", shape,
                lambda: mha.fused_mha_bwd(qkv, do, p, h, causal=causal),
                lambda: mha.fused_mha_bwd_plain(qkv, do, p, h, d ** -0.5),
                sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2), dt))
            add_route_times(rows[-1], lambda r: mha.fused_mha_bwd(
                qkv, do, p, h, causal=causal, route=r), qkv, h)
            # the recompute backward at the same shape, for comparison
            _, stats = mha.fused_mha_fwd(qkv, h, causal=causal,
                                         with_stats=True)
            rows.append(timing_row(
                "fused_mha_bwd_recompute", shape,
                lambda: mha.fused_mha_bwd_recompute(qkv, do, stats, h,
                                                    causal=causal),
                lambda: mha.fused_mha_bwd_recompute_plain(
                    qkv, do, h, d ** -0.5, causal),
                sdpa_bwd, mha_bwd_cost(b, s, h, d, causal, 2,
                                       recompute=True), dt))
            add_route_times(rows[-1], lambda r: mha.fused_mha_bwd_recompute(
                qkv, do, stats, h, causal=causal, route=r), qkv, h)
    for leg, tower, b, s, h, d, causal in LEG_ATTENTION:
        rows.extend(leg_attention_rows(mha, gen, leg, tower, b, s, h, d,
                                       causal))
    rows.extend(siglip_attention_rows(mha, gen))
    for b, s in GPT_SHAPES:
        rows.extend(flash_rows(gen, b, s))
    for tower, s, w in (("vision", 50, 768), ("text", 77, 512)):
        for b in (SERVE_BATCH, TRAIN_BATCH):
            n = b * s
            x = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
            scale = torch.randn(w, device="cuda", generator=gen)
            bias = torch.randn(w, device="cuda", generator=gen)
            scale_bf, bias_bf = scale.to(dt), bias.to(dt)
            shape = f"{tower} rows={n} W={w} bf16"
            rows.append(timing_row(
                "layer_norm_fwd", shape,
                lambda: ln.layer_norm_fwd(x, scale, bias),
                lambda: ln.layer_norm_plain(x, scale, bias),
                lambda: F.layer_norm(x, (w,), scale_bf, bias_bf, 1e-5),
                ln_cost(n, w, 2), torch.float32))
    rows.extend(norm_bwd_rows(gen, ln))
    rows.append(rms_fwd_row(gen, ln))
    rows.extend(fused_ce_rows(gen))
    rows.extend(dropout_rows(gen, mha))
    return rows


# kernel -> (source, the TPU kernel it replaces, the TPU kernels its
# strided (S-major) launches also stand for, the shape of its headline row)
MHA_CU = "megatron_clip_tpu_torch/csrc/fused_mha.cu"
LN_CU = "megatron_clip_tpu_torch/csrc/layernorm.cu"
TPU_MHA = "megatron_clip_tpu/ops/pallas/fused_mha.py"
TPU_LN = "megatron_clip_tpu/ops/pallas/layernorm.py"
FLASH_CU = "megatron_clip_tpu_torch/csrc/flash_attention.cu"
TPU_FLASH = "megatron_clip_tpu/ops/pallas/flash_attention.py"
CE_CU = "megatron_clip_tpu_torch/csrc/fused_ce.cu"
TPU_CE = "megatron_clip_tpu/ops/pallas/fused_ce.py"
KERNEL_META = {
    "fused_mha_fwd": (MHA_CU, f"{TPU_MHA}:80", [f"{TPU_MHA}:149"],
                      f"B={TRAIN_BATCH} "),
    "fused_mha_bwd": (MHA_CU, f"{TPU_MHA}:118", [], f"B={TRAIN_BATCH} "),
    "fused_mha_bwd_recompute": (MHA_CU, f"{TPU_MHA}:131",
                                [f"{TPU_MHA}:171"],
                                "ViT-L/14 vision B=64 "),
    "layer_norm_fwd": (LN_CU, f"{TPU_LN}:25", [], f"rows={TRAIN_BATCH * 50} "),
    "layer_norm_bwd": (LN_CU, f"{TPU_LN}:82", [], f"rows={TRAIN_BATCH * 50} "),
    "flash_fwd": (FLASH_CU, f"{TPU_FLASH}:64", [], "B=6 S=2048 "),
    "flash_bwd_fused": (FLASH_CU, f"{TPU_FLASH}:283", [], "B=6 S=2048 "),
    "flash_bwd_dq": (FLASH_CU, f"{TPU_FLASH}:166", [], "B=1 S=8192 "),
    "flash_bwd_dkv": (FLASH_CU, f"{TPU_FLASH}:219", [], "B=1 S=8192 "),
    # fused_rms_norm (_ln_kernel with rms=True) and its rule _frms_bwd
    "rms_norm_fwd": (LN_CU, f"{TPU_LN}:104", [], "rows=16384 "),
    "rms_norm_bwd": (LN_CU, f"{TPU_LN}:112", [], "rows=16384 "),
    # one backward kernel forms both _dx_kernel's and _dw_kernel's outputs
    "fused_ce_fwd": (CE_CU, f"{TPU_CE}:50", [], "T=16384 "),
    "fused_ce_bwd": (CE_CU, f"{TPU_CE}:97", [f"{TPU_CE}:118"], "T=16384 "),
    # the dropout twins: each TPU kernel at rate > 0, with _drop_keep (:31)
    # inside it
    "flash_fwd_dropout": (FLASH_CU, f"{TPU_FLASH}:64", [f"{TPU_FLASH}:31"],
                          "B=8 S=2048 "),
    "flash_bwd_fused_dropout": (FLASH_CU, f"{TPU_FLASH}:283",
                                [f"{TPU_FLASH}:31"], "B=8 S=2048 "),
    "flash_bwd_dq_dropout": (FLASH_CU, f"{TPU_FLASH}:166",
                             [f"{TPU_FLASH}:31"], "B=1 S=8192 "),
    "flash_bwd_dkv_dropout": (FLASH_CU, f"{TPU_FLASH}:219",
                              [f"{TPU_FLASH}:31"], "B=1 S=8192 "),
    "fused_mha_dropout_fwd": (MHA_CU, f"{TPU_MHA}:361", [], "B=32 S=512 "),
    "fused_mha_dropout_bwd": (MHA_CU, f"{TPU_MHA}:385", [], "B=32 S=512 "),
}


# the device kernels behind a wrapper, by the shapes each takes (the
# routes of csrc/fused_mha.cu's mct_fused_mha_fwd, mct_fused_mha_bwd and
# mct_fused_mha_bwd_recompute and csrc/layernorm.cu's launch)
ROUTES = {
    "fused_mha_fwd": {
        "bf16, S <= 128, D = 64, no dropout": "attn_short::fwd, one pass, a "
        "head per persistent block (csrc/attn_short_sm90.cuh)",
        "bf16, S > 128, D = 64, 80, 128": "attn_fwd::fwd, two-pass wgmma "
        "(csrc/attn_fwd_sm90.cuh; P staged, in 16-byte stores)",
        "other bf16": "tc::fwd (mma.sync)", "fp32": "simt::fwd"},
    "fused_mha_bwd": {
        "bf16, S <= 128, D = 64": "attn_short_bwd::bwd, one pass, a head "
        "per persistent block (csrc/attn_short_bwd_sm90.cuh)",
        "bf16, S > 128, D = 64, 80, 128, P in 16-byte rows":
        "attn_bwd::bwd_dq + attn_bwd::bwd_dkdv from saved P, wgmma, P by "
        "TMA (csrc/attn_bwd_sm90.cuh)",
        "other bf16": "tc::bwd_dq + tc::bwd_dkdv (mma.sync)",
        "fp32": "simt::"},
    "fused_mha_bwd_recompute": {
        "bf16, S <= 128, D = 64": "attn_short_bwd::bwd, one pass, a head "
        "per persistent block (csrc/attn_short_bwd_sm90.cuh)",
        "bf16, S > 128, D = 64, 80, 128": "attn_bwd::bwd_dq + "
        "attn_bwd::bwd_dkdv, wgmma (csrc/attn_bwd_sm90.cuh)",
        "other bf16": "tc::bwd_dq_rc + tc::bwd_dkdv_rc (mma.sync)",
        "fp32": "simt::"},
    **{name: {"rows of 16-byte multiples up to 2048 bf16 / 1024 fp32":
              "ln_fwd, persistent, double-buffered registers, scale and "
              "bias read in their dtype (exact chunk counts at W = 512, "
              "768, 1024, 1280, 2048 in bf16)",
              "other rows": "ln_fwd_any"}
       for name in ("layer_norm_fwd", "rms_norm_fwd")},
    **{name: {"bf16 rows at W = 512, 768, 1024, 1280": "ln_bwd, "
              "persistent, the column sums in registers, scale read in its "
              "dtype, double-buffered registers (a half-warp a row at 512, "
              "a warp otherwise; exact chunk counts)",
              "bf16 rows at W = 2048": "ln_bwd on two-warp rows (their row "
              "sums added through shared memory)",
              "other rows of 16-byte multiples up to 2048 bf16 / 1024 fp32":
              "ln_bwd with guarded chunks",
              "other rows": "ln_bwd_any (column sums in shared memory)",
              "then, every row": "ln_bwd_sum: the blocks' partial rows "
              "added in a fixed order, written in scale's dtype"}
       for name in ("layer_norm_bwd", "rms_norm_bwd")},
}


def kernels_line(rows, launches_by_path, errs) -> list:
    """One entry per kernel: its launches on the main paths (the serving
    run, the ViT-B/32 train run, the ViT-L/14 and ViT-H/14 recompute runs
    and the two GPT-345m runs, each zeroed before and read after;
    `launches_by_path` splits them), the worst error of phase 3, and the
    timings of its headline row, every timed shape listed under
    `shapes`."""
    kernels = []
    for name, (source, replaces, also, headline) in KERNEL_META.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if headline in r["shape"])
        by_path = {path: counts[name]
                   for path, counts in launches_by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            **({"also_replaces": also} if also else {}),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name]["bf16"],
            "max_abs_err_fp32": errs[name]["fp32"],
            "max_abs_err_bf16_vs_fp32_plain":
                errs[name]["bf16_vs_fp32_plain"],
            **({"max_abs_err_column_sums": errs[name]["sums"]}
               if "sums" in errs[name] else {}),
            **{f"max_abs_err_{part}": errs[f"{name} {part}"]
               for part in ("P", "stats", "lse", "rows")
               if f"{name} {part}" in errs},
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms", "routes_ms",
                                          "library_readings_ms")
                        if k in r} for r in mine],
            **({"routes": ROUTES[name]} if name in ROUTES else {}),
        })
    return kernels


def clip_train_flops_per_image(cfg) -> float:
    """bench.py's count (clip_train_flops_per_image and
    transformer_flops_per_token): forward matmul FLOPs of both towers and
    the patch embed, times 3 for forward plus backward."""
    def per_token(layers, width, mlp_hidden, seq):
        proj = 2 * width * (3 * width) + 2 * width * width
        attn = 2 * seq * width * 2
        mlp = 2 * width * mlp_hidden * 2
        return layers * (proj + attn + mlp)
    v, t = cfg.vision, cfg.text
    sv, st = v.seq_len, t.context_length
    fv = per_token(v.layers, v.width, int(v.width * 4), sv) * sv
    fv += 2 * sv * (v.patch_size ** 2 * 3) * v.width
    ft = per_token(t.layers, t.width, int(t.width * 4), st) * st
    return 3 * (fv + ft)


def train_batch(cfg, batch: int, seed: int):
    """Images as bench.py makes them (standard normal NHWC) and token ids
    in [1, vocab - 2], from numpy with `seed`, on the card."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch, cfg.vision.image_size, cfg.vision.image_size, 3),
        dtype=np.float32)
    texts = rng.integers(1, cfg.text.vocab_size - 2,
                         (batch, cfg.text.context_length))
    return torch.from_numpy(images).cuda(), torch.from_numpy(texts).cuda()


def per_step_launches(cfg, save_probs: bool) -> dict:
    """Kernel launches of one train step: one attention forward and one
    backward (from P or recomputing) per layer, LayerNorm forward and
    backward 2 per block plus ln_pre, ln_post and ln_final."""
    layers = cfg.vision.layers + cfg.text.layers
    return dict(dict.fromkeys(KERNEL_META, 0), fused_mha_fwd=layers,
                fused_mha_bwd=layers if save_probs else 0,
                fused_mha_bwd_recompute=0 if save_probs else layers,
                layer_norm_fwd=2 * layers + 3,
                layer_norm_bwd=2 * layers + 3)


def stage_memory(model, opt, step, state, images, texts) -> dict:
    """One more step, with the allocator's peak taken per stage (GiB): the
    forward (to the model's output), the backward (to the optimizer's
    update) and the update; and what is allocated when the forward ends:
    weights, optimizer state and every tensor saved for the backward."""
    gib = 2 ** -30
    marks = {}

    def end_of_forward(*_):
        marks["forward_peak"] = torch.cuda.max_memory_allocated() * gib
        marks["after_forward"] = torch.cuda.memory_allocated() * gib
        torch.cuda.reset_peak_memory_stats()

    def start_of_update(*args, update=opt.update):
        marks["backward_peak"] = torch.cuda.max_memory_allocated() * gib
        torch.cuda.reset_peak_memory_stats()
        return update(*args)
    hook = model.register_forward_hook(end_of_forward)
    opt.update = start_of_update
    torch.cuda.synchronize()
    marks["before_step"] = torch.cuda.memory_allocated() * gib
    torch.cuda.reset_peak_memory_stats()
    step(state, images, texts)
    torch.cuda.synchronize()
    marks["update_peak"] = torch.cuda.max_memory_allocated() * gib
    hook.remove()
    del opt.update
    return marks


def train_run(port, mha, ln, card: str, name: str, batch: int, warmup: int,
              steps: int, save_probs: bool = True,
              with_stage_memory: bool = False, model=None) -> dict:
    """`warmup` + `steps` pure_bf16 steps of `name` in bench.py's recipe
    (AdamW b=(0.9, 0.98) eps 1e-6 wd 0.2, bf16 first moments,
    cosine_lr(1e-3, 100, 10000), clip 1.0) on one batch from numpy seed 0,
    random weights from seed 0. The counters are zeroed before the first
    step and read after every step, which must launch each kernel exactly
    as per_step_launches says; every loss must be finite. Step times are
    CUDA-event intervals between step starts; images/s is the timed steps'
    images over the window's wall time; peak memory is taken over the
    steps, the weights included, and over each step on its own.
    with_stage_memory: then stage_memory. model: the model to train (its
    weights as given), in place of a new one from seed 0."""
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    if model is None:
        model = port.create_model(name, precision="pure_bf16", seed=0)
    model.attn_save_probs = save_probs
    model.train()
    opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                         grad_clip_norm=1.0, moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    images, texts = train_batch(model.cfg, batch, seed=0)
    per_step = per_step_launches(model.cfg, save_probs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events, step_peaks = [], [], []
    zero_counts(mha, ln)
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            window0 = time.perf_counter()
        before = read_counts(mha, ln)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        state, metrics = step(state, images, texts)
        losses.append(metrics["loss"])
        step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        got = {k: v - before[k] for k, v in read_counts(mha, ln).items()}
        if got != per_step:
            raise AssertionError(f"{name} step {i}: launches {got}, "
                                 f"expected {per_step}")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    window_s = time.perf_counter() - window0
    launches = read_counts(mha, ln)
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warmup:-1],
                                                 events[warmup + 1:])]
    losses = torch.stack(losses).float().tolist()
    log(f"  {name} launches per step {per_step}; total {launches}")
    log(f"  {name} losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite training loss")
    ips = batch * steps / window_s
    flops = clip_train_flops_per_image(model.cfg)
    result = {
        "card": card, "model": name, "batch": batch,
        "precision": "pure_bf16",
        "attention_backward": "saved P" if save_probs else "recompute",
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_mean": float(np.mean(step_ms)),
        "step_ms_min": float(np.min(step_ms)), "step_ms": step_ms,
        "window_s": window_s, "images_per_s": ips,
        "flops_per_image": flops,
        "mfu": ips * flops / PEAK_OPS_PER_S[torch.bfloat16],
        "peak_memory_gib": max(step_peaks),
        "step_peak_memory_gib": step_peaks,
        "losses": losses, "launches": launches,
        "launches_per_step": per_step,
    }
    if with_stage_memory:
        result["stage_memory_gib"] = stage_memory(model, opt, step, state,
                                                  images, texts)
    del model, opt, state, step, metrics
    torch.cuda.empty_cache()
    return result


def phase_train(port, mha, ln, card: str):
    log(f"[7] train: ViT-B-32 pure_bf16, batch {TRAIN_BATCH}, "
        f"{TRAIN_WARMUP} warm-up + {TRAIN_STEPS} timed steps")
    result = train_run(port, mha, ln, card, "ViT-B-32", TRAIN_BATCH,
                       TRAIN_WARMUP, TRAIN_STEPS)
    result["parity"] = train_parity(port, "ViT-B-32", PARITY_BATCH)
    result["learning"] = train_learns(port)
    log(f"  train: {json.dumps(result)}")
    return result


def phase_legs(port, mha, ln, card: str) -> dict:
    log(f"[8] legs: {', '.join(f'{n} batch {b}' for n, b in LEGS)}, "
        f"pure_bf16, recompute attention backward, {LEG_WARMUP} warm-up + "
        f"{LEG_STEPS} timed steps; then each with saved probabilities, "
        f"{SAVED_P_WARMUP} + {SAVED_P_STEPS} steps")
    from megatron_clip_tpu_torch.factory import get_model_config
    runs, saved, spared = {}, {}, {}
    for name, batch in LEGS:
        # one model from seed 0 a leg: its weights kept on the host for the
        # saved-P run, which starts from them
        model = port.create_model(name, precision="pure_bf16", seed=0)
        first = {k: v.to("cpu", copy=True)
                 for k, v in model.state_dict().items()}
        stages = name == LEGS[0][0]
        runs[name] = train_run(port, mha, ln, card, name, batch, LEG_WARMUP,
                               LEG_STEPS, save_probs=False,
                               with_stage_memory=stages, model=model)
        model.load_state_dict(first)
        del first
        saved[name] = train_run(port, mha, ln, card, name, batch,
                                SAVED_P_WARMUP, SAVED_P_STEPS,
                                save_probs=True, with_stage_memory=stages,
                                model=model)
        del model
        rec, sav = runs[name], saved[name]
        spared[name] = sav["peak_memory_gib"] - rec["peak_memory_gib"]
        log(f"  {name} first loss: recompute {rec['losses'][0]!r}, saved P "
            f"{sav['losses'][0]!r}; peak memory recompute "
            f"{rec['peak_memory_gib']:.3f} GiB, saved P "
            f"{sav['peak_memory_gib']:.3f} GiB ({spared[name]:.3f} GiB "
            "apart)")
        if sav["losses"][0] != rec["losses"][0]:
            raise AssertionError(f"{name}: the first loss depends on the "
                                 "attention's backward mode")
        # Both runs peak early in the backward, when every tensor saved for
        # it is held (stage_memory), so their peaks must lie apart by what
        # the saved-P run saves beyond the recompute run: every layer's P
        # [B, H, S, S] in bf16 at the row pitch the forward writes
        # (fused_mha.probs_pitch, which csrc/fused_mha.cu decides: 264 at
        # the vision towers' S = 257, 77 at the text towers'), less the fp32 row statistics [2, B, H, S] that the
        # recompute run saves instead (3.15 GiB at ViT-L/14 batch 64). Within
        # 2%: the caching allocator counts a whole cached block when what
        # would be left of it is under 1 MiB, so equal requests can count a
        # little more in one run than in the other.
        cfg = get_model_config(name)
        p_bytes = sum(cfg[f"{tower}_cfg"]["layers"] * b * h * s
                      * (2 * mha.probs_pitch(s, d, torch.bfloat16) - 8)
                      for leg, tower, b, s, h, d, _ in LEG_ATTENTION
                      if leg.replace("/", "-") == name)
        log(f"  {name} memory by stage, recompute "
            f"{rec.get('stage_memory_gib')}, saved P "
            f"{sav.get('stage_memory_gib')}; P less the statistics "
            f"{p_bytes / 2 ** 30:.4f} GiB")
        if abs(spared[name] * 2 ** 30 - p_bytes) > 0.02 * p_bytes:
            raise AssertionError(
                f"{name}: the peaks lie {spared[name]:.3f} GiB apart, not "
                f"P's {p_bytes / 2 ** 30:.3f} GiB less the statistics")
    h = get_model_config("ViT-H-14")
    overrides = {tower: dict(h[tower], layers=H_PARITY_LAYERS)
                 for tower in ("vision_cfg", "text_cfg")}
    result = {"runs": runs, "saved_p": saved, "spared_gib": spared,
              "parity": train_parity(port, "ViT-H-14", H_PARITY_BATCH,
                                     save_probs=False, **overrides)}
    log(f"  legs: {json.dumps(result)}")
    return result


def card_vs_cpu(label: str, run, param_tol: float) -> dict:
    """`run(device)` takes one fp32 step on `device` from the same weights
    and batch and returns (loss, grad_norm, the gradients before the update
    and the parameters after it, on the CPU, the step's seconds). Loss and
    grad_norm within 1e-5 relative. Each parameter's gradient within
    GRAD_REL_TOL of its norm: sums in another order move a gradient by
    ~1e-6 of its norm, a leaf whose sum cancels by more, and a fault in one
    layer's backward by far more (Adam's first update, lr sign(g), cannot
    show it). Every parameter within `param_tol` absolute after the step,
    a share of the step's lr (1e-6, a tenth, for the CLIP steps at lr 1e-5):
    Adam moves an element by lr g/(|g| + eps), less than lr, so a leaf the
    card left as it was would sit just under lr away; gradients that differ
    by ~1e-6 relative move it by at most lr 1e-6 / 4, except where a
    gradient is rounding noise, whose update, g/eps lr, stays below the
    bound while the noise stays well below eps (see gpt_parity for a model
    where it does not)."""
    out = {device: run(device) for device in ("cuda", "cpu")}
    (lc, gc, dc, pc, tc), (lp, gp, dp, pp, tp) = out["cuda"], out["cpu"]
    grad_errs = {n: float((dc[n] - dp[n]).norm() / dp[n].norm())
                 for n in dp}
    worst_leaf = max(grad_errs, key=grad_errs.get)
    param_errs = {n: float((pc[n] - pp[n]).abs().max()) for n in pp}
    worst_param = max(param_errs, key=param_errs.get)
    worst = param_errs[worst_param]
    res = {"loss_cuda": lc, "loss_cpu": lp, "grad_norm_cuda": gc,
           "grad_norm_cpu": gp, "loss_rel_err": abs(lc - lp) / abs(lp),
           "grad_norm_rel_err": abs(gc - gp) / abs(gp),
           "grad_worst_leaf": worst_leaf,
           "grad_worst_leaf_rel_err": grad_errs[worst_leaf],
           "param_worst_leaf": worst_param, "param_max_abs_err": worst,
           "step_s_cuda": tc, "step_s_cpu": tp}
    log(f"  fp32 step of {label}, card vs CPU: {json.dumps(res)}")
    if res["loss_rel_err"] > 1e-5 or res["grad_norm_rel_err"] > 1e-5 \
            or grad_errs[worst_leaf] > GRAD_REL_TOL or worst > param_tol:
        raise AssertionError("the fp32 step on the card disagrees with the "
                             "CPU")
    torch.cuda.empty_cache()
    return res


def keep_grads(opt) -> dict:
    """Make `opt.update` keep a CPU copy of the gradients it is given;
    returns the dict they land in. The caller deletes `opt.update` after
    the step: opt.update -> keep -> update (bound to opt) is a reference
    cycle, and left to the garbage collector the card's model stays
    allocated into the next phase and lifts its peak memory."""
    grads, update = {}, opt.update

    def keep(state, g):
        grads.update({n: t.detach().cpu() for n, t in g.items()})
        return update(state, g)
    opt.update = keep
    return grads


def train_parity(port, name: str, batch: int, save_probs: bool = True,
                 **overrides) -> dict:
    """One fp32 step of `name` (full width; `overrides` may cut its depth)
    at `batch`, on the card (the kernels) and on the CPU (their plain
    versions), from the same weights and batch (`card_vs_cpu`)."""
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    data = []

    def run(device):
        model = port.create_model(name, precision="fp32", seed=0,
                                  device=device, attn_save_probs=save_probs,
                                  **overrides).train()
        if not data:
            data.extend(train_batch(model.cfg, batch, seed=1))
        opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                             grad_clip_norm=1.0)
        grads = keep_grads(opt)
        t0 = time.perf_counter()
        _, m = make_train_step(model, opt)(TrainState.create(model, opt),
                                           *(t.to(device) for t in data))
        took = time.perf_counter() - t0
        del opt.update
        return (float(m["loss"]), float(m["grad_norm"]), grads,
                {n: p.detach().cpu() for n, p in model.named_parameters()},
                took)
    return card_vs_cpu(f"{name} ({'saved P' if save_probs else 'recompute'})",
                       run, param_tol=1e-6)


def train_learns(port) -> dict:
    """LEARN_STEPS updates under `bf16` (fp32 master weights, bf16 compute
    and first moments) on phase 7's batch at cosine_lr(*LEARN_LR); the loss
    after them must be at most LEARN_MAX_RATIO of the first."""
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    model = port.create_model("ViT-B-32", precision="bf16", seed=0).train()
    opt = make_optimizer(model, cosine_lr(*LEARN_LR), grad_clip_norm=1.0,
                         moment_dtype=torch.bfloat16)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    images, texts = train_batch(model.cfg, TRAIN_BATCH, seed=0)
    losses = []
    for _ in range(LEARN_STEPS + 1):  # the last loss is after the updates
        state, m = step(state, images, texts)
        losses.append(m["loss"])
    losses = torch.stack(losses).float().tolist()
    res = {"lr": LEARN_LR, "losses": losses,
           "ratio": losses[-1] / losses[0]}
    log(f"  bf16 learning: {json.dumps(res)}")
    if not all(math.isfinite(v) for v in losses) or \
            res["ratio"] > LEARN_MAX_RATIO:
        raise AssertionError(f"bf16 loss did not fall to "
                             f"{LEARN_MAX_RATIO} of its first value")
    del model, opt, state, step
    torch.cuda.empty_cache()
    return res


def gpt_per_step(layers: int, seq: int, norm: str = "layernorm",
                 fused_ce: bool = False) -> dict:
    """Kernel launches of one GPT train step: the flash forward once per
    layer and its backward as the JAX package picks it at this length
    (fused through S = 4096, split dQ and dKV above), the norm's (LayerNorm
    or RMSNorm) forward and backward twice per block plus ln_f, and with
    `fused_ce` the fused CE forward and backward once."""
    from megatron_clip_tpu_torch.ops.kernels.flash_attention import (
        uses_fused_bwd)
    bwd = (("flash_bwd_fused",) if uses_fused_bwd(seq)
           else ("flash_bwd_dq", "flash_bwd_dkv"))
    kind = "rms_norm" if norm == "rmsnorm" else "layer_norm"
    return dict(dict.fromkeys(KERNEL_META, 0), flash_fwd=layers,
                **dict.fromkeys(bwd, layers),
                **dict.fromkeys((f"{kind}_fwd", f"{kind}_bwd"), 2 * layers + 1),
                **dict.fromkeys(("fused_ce_fwd", "fused_ce_bwd"),
                                int(fused_ce)))


def timed_steps(mha, ln, name: str, step, state, tokens, warmup: int,
                steps: int, per_step: dict):
    """`warmup` + `steps` calls of `step` on one batch: the counters are
    zeroed before the first step and read after every step, which must
    launch each kernel as `per_step` says; every loss must be finite and
    the last below the first. Returns (state, the run's numbers: step times
    as CUDA-event intervals between step starts, the timed window's wall
    time, losses, each step's peak memory, the launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, events, step_peaks = [], [], []
    zero_counts(mha, ln)
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            window0 = time.perf_counter()
        before = read_counts(mha, ln)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        state, metrics = step(state, tokens)
        losses.append(metrics["loss"])
        step_peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        got = {k: v - before[k] for k, v in read_counts(mha, ln).items()}
        if got != per_step:
            raise AssertionError(f"{name} step {i}: launches {got}, "
                                 f"expected {per_step}")
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    window_s = time.perf_counter() - window0
    launches = read_counts(mha, ln)
    events.append(end)
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warmup:-1],
                                                 events[warmup + 1:])]
    losses = torch.stack(losses).float().tolist()
    log(f"  {name} launches per step {per_step}; total {launches}")
    log(f"  {name} losses {losses}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite training loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall")
    return state, {"step_ms": step_ms, "window_s": window_s,
                   "losses": losses, "step_peaks": step_peaks,
                   "launches": launches}


def step_numbers(card, name, cfg, n_params, batch, seq, steps, run) -> dict:
    """The JSON of a timed GPT run: step ms (median, mean, fastest),
    tokens/s over the window's wall time, MFU and HFU bench.py's (6 N and
    6 N plus the attention and lm-head terms, per token, over 989 TFLOP/s),
    and the peak memory."""
    step_ms = run["step_ms"]
    toks = batch * seq * steps / run["window_s"]
    w, L, v = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    extra = 6 * w * v + 6 * seq * w * L + 2 * seq * w * L
    peak = PEAK_OPS_PER_S[torch.bfloat16]
    result = {
        "card": card, "model": name, "batch": batch, "seq": seq,
        "params": n_params,
        "step_ms_median": float(np.median(step_ms)),
        "step_ms_mean": float(np.mean(step_ms)),
        "step_ms_min": float(np.min(step_ms)), "step_ms": step_ms,
        "window_s": run["window_s"], "tokens_per_s": toks,
        "mfu": 6 * n_params * toks / peak,
        "hfu": (6 * n_params + extra) * toks / peak,
        "peak_memory_gib": max(run["step_peaks"]),
        "step_peak_memory_gib": run["step_peaks"],
        "losses": run["losses"], "launches": run["launches"],
    }
    log(f"  {name}: {n_params} parameters; step median "
        f"{result['step_ms_median']:.2f} ms, "
        f"mean {result['step_ms_mean']:.2f}, fastest "
        f"{result['step_ms_min']:.2f}; {toks:.0f} tokens/s, MFU "
        f"{result['mfu']:.4f}, HFU {result['hfu']:.4f}, peak "
        f"{result['peak_memory_gib']:.2f} GiB")
    return result


def gpt_run(mha, ln, card: str, batch: int, seq: int, warmup: int,
            steps: int, name: str = "GPT-345m", over=None,
            precision: str = "pure_bf16", fused_ce: bool = False) -> dict:
    """`warmup` + `steps` steps of bench.py's GPT-345m train step at
    `batch` x `seq`, or of its config with `over` (the example GPT's rope,
    swiglu and rmsnorm): `precision` weights from seed 0, clip 1.0 then
    AdamW(1e-4, b=(0.9, 0.95)) with bf16 first moments, loss chunks of
    1024 or (`fused_ce`) the fused lm-head cross entropy, one batch of token
    ids in [1, vocab - 1) from numpy seed 0 (`timed_steps`, each step
    launching each kernel as gpt_per_step says; `step_numbers`), N the
    model's parameters counted here."""
    from megatron_clip_tpu_torch.models.gpt import GPTCfg, create_gpt
    from megatron_clip_tpu_torch.training import (TrainState,
                                                  make_gpt_optimizer,
                                                  make_gpt_train_step)
    cfg = GPTCfg(**dict(GPT_345M, **(over or {})), seq_length=seq)
    model = create_gpt(cfg, precision=precision, seed=0).train()
    opt = make_gpt_optimizer(model)
    state = TrainState.create(model, opt)
    step = make_gpt_train_step(
        model, opt, loss_seq_chunk=0 if fused_ce else GPT_LOSS_CHUNK,
        fused_ce=fused_ce)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size - 1, (batch, seq + 1))).cuda()
    per_step = gpt_per_step(cfg.num_layers, seq, cfg.normalization, fused_ce)
    name = f"{name} S={seq}{' fused_ce' if fused_ce else ''}"
    state, run = timed_steps(mha, ln, name, step, state, tokens, warmup,
                             steps, per_step)
    n_params = sum(p.numel() for p in model.parameters())
    result = dict(
        step_numbers(card, name, cfg, n_params, batch, seq, steps, run),
        precision=precision,
        loss="fused_ce" if fused_ce else f"chunks of {GPT_LOSS_CHUNK}",
        attention_backward=("fused" if per_step["flash_bwd_fused"]
                            else "split dQ / dKV"),
        launches_per_step=per_step)
    del model, opt, state, step, tokens
    torch.cuda.empty_cache()
    return result


def gpt_parity(over=None, seq: int = GPT_PARITY_SEQ,
               fused_ce: bool = False, label: str = "GPT-345m",
               seed=None) -> dict:
    """One fp32 GPT step at GPT-345m's width (with `over`: the example
    GPT's options and grouped-query attention, or the pipeline GPT's width
    and dropout rates, the step seeded from `seed`), GPT_PARITY_LAYERS layers,
    batch 1 at S = `seq` (the flash path, fused backward), its loss in
    chunks or through the fused CE, on the card and on the CPU from the
    same weights and tokens (`card_vs_cpu`), at lr 1e-6. Adam's first step moves an element by lr g / (|g| + eps),
    and this model has gradients as small as eps (1e-8) that are fp32
    rounding noise: a wo element of 6.8e-9 on one side and 5.5e-9 on the
    other, which at phase 7's lr of 1e-5 moved the parameters 1.45e-6
    apart (NVIDIA H100 80GB HBM3, 700.00 W). At 1e-6 such an element moves
    them ~1.5e-7 apart (1.45e-7 measured), while a leaf left as it was sits
    just under lr away and a gradient of the wrong sign moves one ~2e-6
    apart: the parameter bound is half the lr, 5e-7."""
    from megatron_clip_tpu_torch.models.gpt import GPTCfg, create_gpt
    from megatron_clip_tpu_torch.training import (TrainState,
                                                  make_gpt_optimizer,
                                                  make_gpt_train_step)
    cfg = GPTCfg(**dict(GPT_345M, num_layers=GPT_PARITY_LAYERS,
                        **(over or {})), seq_length=seq)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size - 1, (1, seq + 1)))

    def run(device):
        model = create_gpt(cfg, precision="fp32", device=device,
                           seed=0).train()
        opt = make_gpt_optimizer(model, lr=GPT_PARITY_LR)
        grads = keep_grads(opt)
        t0 = time.perf_counter()
        _, m = make_gpt_train_step(
            model, opt, loss_seq_chunk=GPT_LOSS_CHUNK, fused_ce=fused_ce,
            seed=seed)(TrainState.create(model, opt), tokens.to(device))
        took = time.perf_counter() - t0
        del opt.update
        return (float(m["loss"]), float(m["grad_norm"]), grads,
                {n: p.detach().cpu() for n, p in model.named_parameters()},
                took)
    return card_vs_cpu(f"{label} width, {GPT_PARITY_LAYERS} layers, "
                       f"S={seq}{', fused_ce' if fused_ce else ''}", run,
                       param_tol=0.5 * GPT_PARITY_LR)


def phase_gpt(mha, ln, card: str) -> dict:
    log("[9] GPT-345m: " + ", ".join(
        f"batch {b} x S={s}, {w} warm-up + {n} timed steps"
        for b, s, w, n in GPT_RUNS) + "; pure_bf16, flash attention")
    result = {f"S={s}": gpt_run(mha, ln, card, b, s, w, n)
              for b, s, w, n in GPT_RUNS}
    result["parity"] = gpt_parity()
    log(f"  gpt: {json.dumps(result)}")
    return result


def phase_example(mha, ln, card: str, gpt: dict) -> dict:
    """The training path of examples/pretrain_gpt_dist.sh on one card:
    EXAMPLE_RUN steps of the rope/swiglu/rmsnorm GPT at full width and
    depth, bf16 compute on fp32 weights, the fused CE; the fp32 step with
    grouped-query attention, card against CPU; GPT-345m through the fused
    CE beside phase 9's chunked run of the same model and batch."""
    b, s, w, n = EXAMPLE_RUN
    log(f"[10] example GPT (examples/pretrain_gpt_dist.sh): 24 x 1024, rope, "
        f"swiglu, rmsnorm, --fused-ce, bf16, batch {b} x S={s}, {w} warm-up "
        f"+ {n} timed steps; GQA parity; GPT-345m fused CE vs chunked")
    run = gpt_run(mha, ln, card, b, s, w, n, name="example GPT",
                  over=EXAMPLE_GPT, precision="bf16", fused_ce=True)
    parity = gpt_parity(over=dict(EXAMPLE_GPT, kv_heads=GQA_KV_HEADS),
                        seq=GQA_PARITY_SEQ, fused_ce=True,
                        label=f"example GPT, kv_heads={GQA_KV_HEADS}")
    fb, fs, fw, fn = GPT_RUNS[0]
    fused = gpt_run(mha, ln, card, fb, fs, fw, FUSED_345M_STEPS,
                    fused_ce=True)
    chunked = gpt[f"S={fs}"]
    versus = {what: {k: r[k] for k in ("step_ms_median", "step_ms_mean",
                                        "step_ms_min", "tokens_per_s",
                                        "peak_memory_gib")}
              for what, r in (("chunked", chunked), ("fused_ce", fused))}
    log(f"  GPT-345m batch {fb} x S={fs}, chunked loss vs fused CE: "
        f"{json.dumps(versus)}")
    result = {"run": run, "parity": parity, "gpt345m_fused_ce": fused,
              "gpt345m_chunked_vs_fused_ce": versus}
    log(f"  example: {json.dumps(result)}")
    return result


def pipeline_per_step(layers: int, seq: int, remat: str) -> dict:
    """Kernel launches of one pipeline GPT step: the attention's dropout
    forward once per layer (twice under full recompute, which replays the
    block) and its backward, on the route the JAX gates pick at this length
    (the fused-MHA dropout kernels while `dropout_kernel_eligible` holds,
    else flash, fused backward through S = 4096 and split above), never a
    rate-0 attention kernel; LayerNorm's forward twice per block plus ln_f,
    and once more per block norm when the block is recomputed (selective
    recomputes ln_1 and ln_2, full the whole block), its backward twice per
    block plus ln_f; the fused CE forward and backward once."""
    from megatron_clip_tpu_torch.ops.kernels.flash_attention import (
        uses_fused_bwd)
    from megatron_clip_tpu_torch.ops.kernels.fused_mha import (
        MAX_FUSED_SEQ, dropout_kernel_eligible)
    if seq <= MAX_FUSED_SEQ and dropout_kernel_eligible(
            seq, PIPELINE_HEADS, PIPELINE_HEAD_DIM):
        fwd, bwd = "fused_mha_dropout_fwd", ("fused_mha_dropout_bwd",)
    else:
        fwd = "flash_fwd_dropout"
        bwd = (("flash_bwd_fused_dropout",) if uses_fused_bwd(seq)
               else ("flash_bwd_dq_dropout", "flash_bwd_dkv_dropout"))
    replays = 0 if remat == "none" else 2 * layers
    return dict(dict.fromkeys(KERNEL_META, 0),
                **{fwd: layers * (2 if remat == "full" else 1)},
                **dict.fromkeys(bwd, layers),
                layer_norm_fwd=2 * layers + 1 + replays,
                layer_norm_bwd=2 * layers + 1, fused_ce_fwd=1,
                fused_ce_bwd=1)


def pipeline_tokens(vocab: int, batch: int, seq: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(
        1, vocab - 1, (batch, seq + 1))).cuda()


def pipeline_run(mha, ln, card, model, opt, state, batch, seq, warmup,
                 steps, remat="selective"):
    """`timed_steps` of the pipeline GPT's step (fused CE, `remat`, dropout
    from PIPELINE_SEED) on one seeded batch; returns (state, numbers)."""
    from megatron_clip_tpu_torch.training import make_gpt_train_step
    cfg = model.cfg
    step = make_gpt_train_step(model, opt, fused_ce=True, remat=remat,
                               seed=PIPELINE_SEED)
    per_step = pipeline_per_step(cfg.num_layers, seq, remat)
    name = (f"pipeline GPT {cfg.num_layers} layers B={batch} S={seq} "
            f"{remat}")
    state, run = timed_steps(mha, ln, name, step, state,
                             pipeline_tokens(cfg.vocab_size, batch, seq),
                             warmup, steps, per_step)
    n_params = sum(p.numel() for p in model.parameters())
    return state, dict(step_numbers(card, name, cfg, n_params, batch, seq,
                                    steps, run),
                       precision="bf16", loss="fused_ce", remat=remat,
                       dropout=[cfg.attention_dropout, cfg.hidden_dropout],
                       launches_per_step=per_step)


def full_remat_step(mha, ln, card, model, opt, state, batch, seq) -> dict:
    """One step of the pipeline GPT under remat="full" from the weights and
    batch of the selective run: its time on the host clock (synchronised),
    its peak memory and its launches (the attention forward replayed)."""
    from megatron_clip_tpu_torch.training import make_gpt_train_step
    step = make_gpt_train_step(model, opt, fused_ce=True, remat="full",
                               seed=PIPELINE_SEED)
    per_step = pipeline_per_step(model.cfg.num_layers, seq, "full")
    tokens = pipeline_tokens(model.cfg.vocab_size, batch, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mha, ln)
    t0 = time.perf_counter()
    state, m = step(state, tokens)
    torch.cuda.synchronize()
    took = (time.perf_counter() - t0) * 1e3
    got = read_counts(mha, ln)
    if got != per_step:
        raise AssertionError(f"pipeline GPT full remat: launches {got}, "
                             f"expected {per_step}")
    loss = float(m["loss"])
    if not math.isfinite(loss):
        raise AssertionError("pipeline GPT full remat: non-finite loss")
    res = {"card": card, "batch": batch, "seq": seq, "remat": "full",
           "step_ms": took, "loss": loss,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": got}
    log(f"  pipeline GPT one full-remat step: {json.dumps(res)}")
    return state, res


def phase_pipeline(mha, ln, card: str) -> dict:
    """The training path of examples/pretrain_gpt_pipeline.sh on one card
    (PIPELINE_GPT; its PP/VPP/TP flags belong to a later slice): the
    selective-recompute runs of PIPELINE_RUNS on one model (S = 2048 on
    the flash dropout kernels, then S = 512 on the fused-MHA dropout
    kernels), with one full-recompute step from the S = 2048 run's weights
    and batch; PIPELINE_LONG (split flash backward with dropout); and the
    fp32 card-against-CPU steps of PIPELINE_PARITY_SEQS on the same Philox
    masks (`gpt_parity`'s bounds)."""
    from megatron_clip_tpu_torch.models.gpt import GPTCfg, create_gpt
    from megatron_clip_tpu_torch.training import (TrainState,
                                                  make_gpt_optimizer)
    log("[11] pipeline GPT (examples/pretrain_gpt_pipeline.sh): 32 x 2048, "
        "16 heads, learned positions, attention and hidden dropout 0.1, "
        "--fused-ce, bf16, selective recompute: " + ", ".join(
            f"batch {b} x S={s}, {w} + {n} steps"
            for b, s, w, n in PIPELINE_RUNS) + "; one full-recompute step; "
        f"S={PIPELINE_LONG[1]} at {PIPELINE_LONG[2]} layers; fp32 parity")
    result = {}
    cfg = GPTCfg(**PIPELINE_GPT, seq_length=PIPELINE_RUNS[0][1])
    model = create_gpt(cfg, precision="bf16", seed=0).train()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PIPELINE_PARAMS:
        raise AssertionError(f"pipeline GPT has {n_params} parameters, "
                             f"not {PIPELINE_PARAMS}")
    opt = make_gpt_optimizer(model)
    state = TrainState.create(model, opt)
    for b, s, w, n in PIPELINE_RUNS:
        state, result[f"S={s}"] = pipeline_run(mha, ln, card, model, opt,
                                               state, b, s, w, n)
        if s == PIPELINE_RUNS[0][1]:
            state, result[f"S={s} full"] = full_remat_step(
                mha, ln, card, model, opt, state, b, s)
    del model, opt, state
    torch.cuda.empty_cache()
    b, s, layers, w, n = PIPELINE_LONG
    cfg = GPTCfg(**dict(PIPELINE_GPT, num_layers=layers), seq_length=s)
    model = create_gpt(cfg, precision="bf16", seed=0).train()
    opt = make_gpt_optimizer(model)
    _, result[f"S={s}"] = pipeline_run(mha, ln, card, model, opt,
                                       TrainState.create(model, opt), b, s,
                                       w, n)
    del model, opt
    torch.cuda.empty_cache()
    over = {k: PIPELINE_GPT[k] for k in ("hidden_size", "num_heads",
                                         "attention_dropout")}
    result["parity"] = {
        f"S={s}": gpt_parity(over=dict(over, hidden_dropout=0.0), seq=s,
                             fused_ce=True, seed=PIPELINE_SEED,
                             label="pipeline GPT, attention dropout 0.1")
        for s in PIPELINE_PARITY_SEQS}
    log(f"  pipeline: {json.dumps(result)}")
    return result


class TrainerProbe:
    """Wraps the trainer's runner (`training/loop.py`) while one run lasts:
    each step's kernel launches, which must equal `per_step` (phase 7's
    step), its loss and the host clock at its start and end; the host ms of
    each batch's staging copy on the prefetch thread (`_Prefetch.stage`)
    and of each save (the host copy only, when the save writes in the
    background). The counters are zeroed on entry and read on exit into
    `launches`. `per_step` None checks no step's launches."""

    def __init__(self, loop, mha, ln, per_step: dict):
        self.loop, self.mha, self.ln = loop, mha, ln
        self.per_step = per_step
        self.losses, self.host, self.stage_ms, self.save_ms = [], [], [], []

    def __enter__(self):
        runner, staging = self.loop._JointRunner, self.loop._Prefetch
        self._saved = (runner.step, runner.save, staging.stage)
        step, save, stage = self._saved
        probe = self

        def probed_step(run, images, texts):
            before = read_counts(probe.mha, probe.ln)
            t0 = time.perf_counter()
            metrics = step(run, images, texts)
            probe.host.append((t0, time.perf_counter()))
            got = {k: v - before[k]
                   for k, v in read_counts(probe.mha, probe.ln).items()}
            if probe.per_step is not None and got != probe.per_step:
                raise AssertionError(f"trainer step {len(probe.host)}: "
                                     f"launches {got}, expected "
                                     f"{probe.per_step}")
            probe.losses.append(metrics["loss"])
            return metrics

        def probed_save(run, root, at, consumed, block=True, on_commit=None):
            t0 = time.perf_counter()
            save(run, root, at, consumed, block=block, on_commit=on_commit)
            probe.save_ms.append({"step": at, "background": not block,
                                  "ms": (time.perf_counter() - t0) * 1e3})

        def probed_stage(stg, i, arrays):
            t0 = time.perf_counter()
            out = stage(stg, i, arrays)
            probe.stage_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        runner.step, runner.save = probed_step, probed_save
        staging.stage = probed_stage
        zero_counts(self.mha, self.ln)
        self.entered = time.perf_counter()
        return self

    def __exit__(self, *exc):
        runner, staging = self.loop._JointRunner, self.loop._Prefetch
        runner.step, runner.save, staging.stage = self._saved
        self.launches = read_counts(self.mha, self.ln)
        return False

    def loss_values(self) -> list:
        return torch.stack(self.losses).float().tolist()


def png_bytes(pix: np.ndarray) -> bytes:
    """uint8 [H, W, 3] as an 8-bit RGB PNG whose row r is filtered with
    filter r % 5 (None, Sub, Up, Average, Paeth), deflated by zlib at
    level 1."""
    import zlib
    h, w, _ = pix.shape
    x = pix.reshape(h, w * 3).astype(np.int16)
    up = np.vstack([np.zeros((1, w * 3), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, 3), np.int16), x[:, :-3]])
    ul = np.hstack([np.zeros((h, 3), np.int16), up[:, :-3]])
    resid = x.copy()  # filter 0: the bytes as they are
    for f in range(1, 5):
        rows = slice(f, None, 5)
        a, b, c = left[rows], up[rows], ul[rows]
        if f == 4:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        else:
            pred = (a, b, (a + b) >> 1)[f - 1]
        resid[rows] -= pred
    filt = (np.arange(h) % 5).astype(np.uint8)[:, None]
    raw = np.hstack([filt, (resid & 255).astype(np.uint8)]).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))
    header = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
              + bytes([8, 2, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def trainer_images(n: int, size: int, seed: int):
    """n seeded RGB images (8 x 8 blocks of colour plus noise) as PNGs,
    with a caption each."""
    rng = np.random.default_rng(seed)
    words = ("red", "green", "blue", "striped", "dotted", "bright", "dark",
             "small", "large", "round")
    out = []
    for i in range(n):
        base = rng.integers(0, 256, (8, 8, 3), dtype=np.int16)
        pix = np.repeat(np.repeat(base, size // 8, 0), size // 8, 1)
        pix = np.clip(pix + rng.integers(-2, 3, pix.shape, dtype=np.int16),
                      0, 255)
        caption = (f"a {words[i % 10]} {words[(i // 10) % 10]} pattern "
                   f"number {i}")
        out.append((png_bytes(pix.astype(np.uint8)), caption))
    return out


def write_shards(root: Path, samples, shards: int, ext: str = "png") -> str:
    """`samples` (image bytes, caption) split over `shards` tars of
    {key}.{ext} and {key}.txt; returns the brace spec of their paths."""
    import io
    import tarfile
    per = len(samples) // shards
    for s in range(shards):
        with tarfile.open(root / f"shard-{s}.tar", "w") as tf:
            for i, (img, caption) in enumerate(samples[s * per:(s + 1) * per]):
                for ext_, data in ((ext, img), ("txt", caption.encode())):
                    info = tarfile.TarInfo(f"{s:02d}{i:05d}.{ext_}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return str(root / f"shard-{{0..{shards - 1}}}.tar")


def decode_rates(samples, image_size: int) -> dict:
    """One process's (a decode worker's) images per second on `samples`'
    PNGs: the decode alone, and the decode with the train transform."""
    from megatron_clip_tpu_torch.data.decode import decode_image
    from megatron_clip_tpu_torch.data.transforms import image_transform
    pngs = [png for png, _ in samples]
    decode_image(pngs[0])  # builds the PNG predictor table, once a process
    t0 = time.perf_counter()
    images = [decode_image(png) for png in pngs]
    decode_s = time.perf_counter() - t0
    transform = image_transform(image_size, is_train=True)
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        transform(img, i)
    transform_s = time.perf_counter() - t0
    return {"images": len(pngs),
            "decode_images_per_s": len(pngs) / decode_s,
            "decode_and_transform_images_per_s":
                len(pngs) / (decode_s + transform_s)}


def trainer_synthetic(main, loop, mha, ln, per_step, phase7) -> dict:
    """(a): phase 7's model, batch and optimizer recipe through
    `pretrain_clip.main` on synthetic data; the loop's samples/s over the
    timed steps (the host clock between the first and the last timed
    step's starts; the loop waits for each step's loss at --log-interval 1)
    beside phase 7's images/s, and where a step's host time goes: in the
    runner's step, between steps (the log line, the wait for the loss and
    for the next batch), and on the prefetch thread."""
    with TrainerProbe(loop, mha, ln, per_step) as probe:
        final = main(TRAINER_SYNTHETIC)
    losses = probe.loss_values()
    if len(losses) != TRAINER_WARMUP + TRAINER_STEPS or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"trainer synthetic: losses {losses}")
    starts = [a for a, _ in probe.host]
    timed = list(range(TRAINER_WARMUP, len(starts) - 1))
    sps = TRAIN_BATCH * len(timed) / (starts[timed[-1] + 1] - starts[timed[0]])
    in_step = [(probe.host[i][1] - probe.host[i][0]) * 1e3 for i in timed]
    between = [(starts[i + 1] - probe.host[i][1]) * 1e3 for i in timed]
    staging = probe.stage_ms[TRAINER_WARMUP:]
    result = {
        "samples_per_s": sps, "phase7_images_per_s": phase7["images_per_s"],
        "ratio": sps / phase7["images_per_s"],
        "step_interval_ms_median": float(np.median(
            [(starts[i + 1] - starts[i]) * 1e3 for i in timed])),
        "phase7_step_ms_median": phase7["step_ms_median"],
        "host_ms_in_step_median": float(np.median(in_step)),
        "host_ms_prefetch_copy_median": float(np.median(staging)),
        "host_ms_between_steps_median": float(np.median(between)),
        "losses": losses, "final": final, "launches": probe.launches}
    log(f"  trainer synthetic: {sps:.1f} samples/s against phase 7's "
        f"{phase7['images_per_s']:.1f} images/s (ratio "
        f"{result['ratio']:.4f}); step interval median "
        f"{result['step_interval_ms_median']:.2f} ms, of it in the runner's "
        f"step {result['host_ms_in_step_median']:.2f} and between steps "
        f"{result['host_ms_between_steps_median']:.2f}; the prefetch "
        f"thread's copy of a batch to pinned memory "
        f"{result['host_ms_prefetch_copy_median']:.2f}")
    return result


def trainer_webdataset(main, loop, mha, ln, per_step, work: Path) -> dict:
    """(b): 2 x 32 PNG samples in tars, 4 steps with --save-interval 2;
    then the run as if cut after step 3, before step 4's save committed
    (the tracker back at step 2, iter_0000004 gone), resumed with --resume
    latest: steps 3-4 must give the first run's losses, bit for bit."""
    t0 = time.perf_counter()
    samples = trainer_images(WDS_SHARDS * WDS_PER_SHARD, WDS_IMAGE, seed=1)
    spec = write_shards(work, samples, WDS_SHARDS)
    seconds = {"write_shards": time.perf_counter() - t0}
    rates = decode_rates(samples[:16], 224)
    argv = ["--model", "ViT-B-32", "--precision", "bf16", "--batch-size",
            str(WDS_BATCH), "--workers", str(WDS_WORKERS), "--train-data",
            spec, "--save", str(work / "ck"), "--name", "wds",
            "--save-interval", "2", "--log-interval", "1"]
    t0 = time.perf_counter()
    with TrainerProbe(loop, mha, ln, per_step) as first:
        main(argv)
    seconds["first_run"] = time.perf_counter() - t0
    run_dir = work / "ck" / "wds"
    (run_dir / "latest_checkpointed_iteration.txt").write_text("2")
    shutil.rmtree(run_dir / "iter_0000004")
    t0 = time.perf_counter()
    with TrainerProbe(loop, mha, ln, per_step) as second:
        main(argv + ["--resume", "latest"])
    seconds["resumed_run"] = time.perf_counter() - t0
    l1, l2 = first.loss_values(), second.loss_values()
    bit_equal = l2 == l1[2:]
    log(f"  trainer webdataset: losses {l1}; resumed at step 2: {l2}; "
        f"bit-equal: {bit_equal}; decode {rates['decode_images_per_s']:.1f} "
        f"images/s per worker ({rates['decode_and_transform_images_per_s']:.1f}"
        f" with the train transform); saves {first.save_ms + second.save_ms}")
    if len(l1) != 4 or not bit_equal or \
            not all(math.isfinite(v) for v in l1):
        raise AssertionError("trainer webdataset: the resumed steps 3-4 do "
                             "not reproduce the first run's")
    launches = {k: first.launches[k] + second.launches[k]
                for k in first.launches}
    return {"losses": l1, "resumed_losses": l2, "bit_equal": bit_equal,
            "decode": rates, "saves": first.save_ms + second.save_ms,
            "first_step_s": [run.host[0][0] - t for run, t in (
                (first, first.entered), (second, second.entered))],
            "parts_s": seconds, "launches": launches}


def trainer_csv(main, loop, mha, ln, per_step, work: Path) -> dict:
    """(c): a CSV of 32 PNG files, 2 steps and the val metrics on the same
    file at the epoch's end."""
    lines = ["filepath\ttitle"]
    for i, (png, caption) in enumerate(trainer_images(CSV_IMAGES, CSV_IMAGE,
                                                      seed=2)):
        (work / f"{i}.png").write_bytes(png)
        lines.append(f"{i}.png\t{caption}")
    csv = work / "data.csv"
    csv.write_text("\n".join(lines) + "\n")
    with TrainerProbe(loop, mha, ln, per_step) as probe:
        final = main(["--model", "ViT-B-32", "--precision", "bf16",
                      "--batch-size", str(CSV_BATCH), "--train-data",
                      str(csv), "--val-data", str(csv), "--log-interval",
                      "1"])
    val = {k: final[f"val_{k}"] for k in (
        "clip_val_loss", "num_samples", *(f"{d}_R@{k}" for d in
                                          ("image_to_text", "text_to_image")
                                          for k in (1, 5, 10)))}
    log(f"  trainer csv: losses {probe.loss_values()}; val {val}")
    if val["num_samples"] != CSV_IMAGES or \
            not math.isfinite(val["clip_val_loss"]):
        raise AssertionError(f"trainer csv: val metrics {val}")
    return {"losses": probe.loss_values(), "val": val,
            "launches": probe.launches}


def host_cpu() -> dict:
    """The host's CPU as the first processor of /proc/cpuinfo gives it:
    its "model name", else (where that is missing or "unknown", as in the
    hosts that hide it) its vendor, family and model numbers and clock,
    else "unknown"; its machine type and os.cpu_count(). Decode is paced
    by the host, so its rates stand beside these."""
    import platform
    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if not line.strip() and fields:
                break
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    cpu = fields.get("model name", "unknown")
    if cpu == "unknown":
        cpu = " ".join(f"{k} {fields[k]}" for k in (
            "vendor_id", "cpu family", "model", "cpu MHz") if fields.get(k))
    return {"cpu": cpu or "unknown", "machine": platform.machine(),
            "cpu_count": os.cpu_count()}


def jpeg_fixture_check() -> dict:
    """Every committed JPEG fixture, full and at each recorded draft size,
    through `decode_image` (the host library phase 2 built from
    csrc/jpeg_decode.c), against the digests of Pillow's decode that
    tests/torch_goldens/jpeg/digests.json holds."""
    from megatron_clip_tpu_torch.data.decode import decode_image
    from megatron_clip_tpu_torch.tools import jpeg_goldens
    t0 = time.perf_counter()
    result = jpeg_goldens.check(decode_image, JPEG_GOLDENS)
    result["seconds"] = time.perf_counter() - t0
    log(f"  jpeg fixtures: {result['checked']} decodes of "
        f"{len(jpeg_goldens.manifest(JPEG_GOLDENS)['fixtures'])} files against Pillow's "
        f"digests, {len(result['wrong'])} wrong, in "
        f"{result['seconds']:.2f} s")
    if result["wrong"]:
        raise AssertionError(f"JPEG decodes unlike Pillow's: "
                             f"{result['wrong']}")
    return result


def timed_window(fn, items: list) -> dict:
    """Calls `fn` on `items` in turn, from the first again when they run
    out, until JPEG_RATE_WINDOW_S seconds have passed and each was called
    once: the calls made and the seconds they took."""
    n, t0 = 0, time.perf_counter()
    while True:
        fn(items[n % len(items)])
        n += 1
        seconds = time.perf_counter() - t0
        if seconds >= JPEG_RATE_WINDOW_S and n >= len(items):
            return {"images": n, "seconds": seconds}


def jpeg_decode_rates(image_size: int) -> dict:
    """One process's (a decode worker's) JPEG images per second on the
    640 x 480 fixtures, whole and in draft at `image_size` (scale 2),
    alone and with the train transform: the three 4:2:0 q90 files, and all
    seven (4:2:0, 4:2:2, 4:4:4, progressive, grey). Each mode's decode is
    timed in JPEG_RATE_WINDOWS windows (their spread is the noise), the
    transform of its images in one; "with the transform" adds the two
    times an image."""
    from megatron_clip_tpu_torch.data.decode import decode_image
    from megatron_clip_tpu_torch.data.transforms import image_transform
    from megatron_clip_tpu_torch.tools import jpeg_goldens
    transform = image_transform(image_size, is_train=True)
    names = list(jpeg_goldens.PHOTOS)
    sets = {"420_q90": [n for n in names if n.startswith("photo_420_q90")],
            "mixed": names}
    rates = {}
    for label, chosen in sets.items():
        blobs = [jpeg_goldens.fixture_bytes(JPEG_GOLDENS, n) for n in chosen]
        for mode, draft in (("full", None), ("draft", image_size)):
            images = [decode_image(b, draft) for b in blobs]  # loads the lib
            windows = [timed_window(lambda b: decode_image(b, draft), blobs)
                       for _ in range(JPEG_RATE_WINDOWS)]
            seeds = iter(range(1 << 30))
            moved = timed_window(lambda img: transform(img, next(seeds)),
                                 images)
            decode_s = sum(w["seconds"] for w in windows) \
                / sum(w["images"] for w in windows)
            rates[f"{label}_{mode}"] = {
                "shape": list(images[0].shape), "decode_windows": windows,
                "transform_window": moved,
                "decode_images_per_s": 1 / decode_s,
                "decode_images_per_s_windows": [
                    w["images"] / w["seconds"] for w in windows],
                "decode_and_transform_images_per_s": 1 / (
                    decode_s + moved["seconds"] / moved["images"])}
    return rates


def trainer_jpeg(main, loop, mha, ln, per_step, work: Path) -> dict:
    """(d): 2 tars of 64 JPEG samples, each one of the seven 640 x 480
    fixtures (4:2:0 q90, 4:2:2, 4:4:4, progressive, grey) with a caption of
    its own that names its scene; ViT-B-32 at bf16, batch 32, 2 decode
    workers, draft decode on (the JAX loader's default: 224 -> scale 2),
    two epochs: the loss must fall."""
    from megatron_clip_tpu_torch.tools import jpeg_goldens
    words = ("red", "green", "blue", "striped", "dotted", "bright", "dark")
    names = list(jpeg_goldens.PHOTOS)
    samples = [(jpeg_goldens.fixture_bytes(JPEG_GOLDENS,
                                           names[i % len(names)]),
                f"a {words[i % len(names)]} scene, picture number {i}")
               for i in range(JPEG_SHARDS * JPEG_PER_SHARD)]
    t0 = time.perf_counter()
    spec = write_shards(work, samples, JPEG_SHARDS, ext="jpg")
    seconds = {"write_shards": time.perf_counter() - t0}
    if os.environ.get("MCT_JPEG_DRAFT", "1") == "0":
        raise AssertionError("trainer jpeg: MCT_JPEG_DRAFT=0 turns the draft "
                             "decode this part runs off")
    t0 = time.perf_counter()
    with TrainerProbe(loop, mha, ln, per_step) as probe:
        main(["--model", "ViT-B-32", "--precision", "bf16", "--batch-size",
              str(JPEG_BATCH), "--workers", str(WDS_WORKERS), "--train-data",
              spec, "--epochs", str(JPEG_EPOCHS), "--log-interval", "1",
              *JPEG_RECIPE])
    seconds["run"] = time.perf_counter() - t0
    losses = probe.loss_values()
    starts = [a for a, _ in probe.host]
    # the loop's samples/s from the first step's start to the last one's
    sps = JPEG_BATCH * (len(starts) - 1) / (starts[-1] - starts[0])
    steps = JPEG_EPOCHS * JPEG_SHARDS * JPEG_PER_SHARD // JPEG_BATCH
    falling = bool(len(losses) == steps
                   and all(math.isfinite(v) for v in losses)
                   and max(losses[-2:]) < losses[0])
    log(f"  trainer jpeg: losses {losses}; falling: {falling}; "
        f"{sps:.1f} samples/s after the first step, which began "
        f"{probe.host[0][0] - probe.entered:.2f} s in")
    if not falling:
        raise AssertionError(f"trainer jpeg: {len(losses)} steps (expected "
                             f"{steps}), the loss did not fall: {losses}")
    return {"losses": losses, "falling": falling, "samples_per_s": sps,
            "parts_s": seconds,
            "first_step_s": probe.host[0][0] - probe.entered,
            "launches": probe.launches}


def descendants(root: int = None) -> list:
    """(pid, command) of every live process below `root` (this process by
    default), from /proc."""
    parent, command = {}, {}
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
            command[int(entry.name)] = (entry / "cmdline").read_bytes() \
                .replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:  # exited while we read
            continue
        # the fields after the command's closing bracket: state, ppid, ...
        parent[int(entry.name)] = int(stat.rsplit(")", 1)[1].split()[1])
    found, frontier = [], [os.getpid() if root is None else root]
    while frontier:
        pid = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == pid]
        found += kids
        frontier += kids
    return [(pid, command.get(pid, "")) for pid in sorted(found)]


def kill_tree(root: int = None) -> None:
    """SIGKILL every process below `root` (this process by default), and
    `root` itself when it is given, then reap this process's children. The
    tree is read before the first signal: torchrun starts each worker in a
    session of its own, and a worker whose torchrun is killed first would
    pass to init, out of reach of a later walk."""
    tree = [pid for pid, _ in descendants(root)]
    for pid in tree + ([root] if root is not None else []):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in tree + ([root] if root is not None else []):
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:  # not this process's child
            pass


def check_no_processes_left() -> None:
    """Fails if a process this script started (a build, a decode worker,
    multiprocessing's forkserver or resource tracker) is still alive."""
    left = descendants()
    if left:
        raise AssertionError(f"processes still running: {left}")


def phase_parts(result: dict) -> str:
    """Where a phase's seconds went, its parts' as they recorded them, for
    the message of a phase over its limit."""
    return json.dumps({k: {n: v for n, v in part.items()
                           if n.endswith("seconds") or n.endswith("_s")}
                       for k, part in result.items()
                       if isinstance(part, dict)})


def phase_trainer(mha, ln, card: str, phase7: dict) -> dict:
    log(f"[12] trainer: pretrain_clip.main on the card: ViT-B-32 synthetic "
        f"(pure_bf16, batch {TRAIN_BATCH}, {TRAINER_WARMUP} + "
        f"{TRAINER_STEPS} steps), webdataset with a resume, csv with val, "
        f"JPEG webdataset in draft mode")
    t0 = time.perf_counter()
    from megatron_clip_tpu_torch.factory import (get_model_config,
                                                 parse_model_cfg)
    from megatron_clip_tpu_torch.data.webdataset import (stop_workers,
                                                         worker_context)
    from megatron_clip_tpu_torch.pretrain_clip import main
    from megatron_clip_tpu_torch.training import loop
    worker_context()  # the decode workers' server imports while (a) runs
    fixtures = jpeg_fixture_check()
    per_step = per_step_launches(parse_model_cfg(get_model_config(
        "ViT-B-32")), save_probs=True)
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    for part in ("wds", "csv", "jpeg"):
        (SMOKE_DIR / part).mkdir(parents=True)
    parts = {"synthetic": lambda: trainer_synthetic(
                 main, loop, mha, ln, per_step, phase7),
             "webdataset": lambda: trainer_webdataset(
                 main, loop, mha, ln, per_step, SMOKE_DIR / "wds"),
             "csv": lambda: trainer_csv(main, loop, mha, ln, per_step,
                                        SMOKE_DIR / "csv"),
             "jpeg": lambda: trainer_jpeg(main, loop, mha, ln, per_step,
                                          SMOKE_DIR / "jpeg")}
    result = {"card": card, "host": host_cpu(),
              "jpeg_fixtures": {k: v for k, v in fixtures.items()
                                if k != "wrong"}}
    try:
        result["jpeg_decode"] = jpeg_decode_rates(CSV_IMAGE)
        for name, part in parts.items():
            t_part = time.perf_counter()
            result[name] = part()
            result[name]["seconds"] = time.perf_counter() - t_part
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)
        stop_workers()
    result["seconds"] = time.perf_counter() - t0
    png = result["webdataset"]["decode"]
    log(f"  decode images/s a process on {result['host']['cpu']} "
        f"({result['host']['machine']}, {result['host']['cpu_count']} "
        f"CPUs), {card}: PNG 256 x 256 "
        f"{png['decode_images_per_s']:.1f} "
        f"({png['decode_and_transform_images_per_s']:.1f} with the train "
        f"transform); JPEG 640 x 480 " + "; ".join(
            f"{k} {v['decode_images_per_s']:.1f} (windows " + ", ".join(
                f"{w['images']} in {w['seconds']:.3f} s"
                for w in v["decode_windows"])
            + f"; {v['decode_and_transform_images_per_s']:.1f} with the "
            f"transform, {v['transform_window']['images']} in "
            f"{v['transform_window']['seconds']:.3f} s)"
            for k, v in result["jpeg_decode"].items()))
    log(f"  trainer: {json.dumps(result)}")
    if result["seconds"] > TRAINER_PHASE_LIMIT_S:
        raise AssertionError(
            f"phase 12 took {result['seconds']:.1f} s, over "
            f"{TRAINER_PHASE_LIMIT_S} s: " + phase_parts(result))
    return result


def recipe_per_step(cfg, microbatches: int) -> dict:
    """Kernel launches of one accumulated step (saved P): the cache pass's
    forwards without P and the blocks' forwards with P, M each, and the
    blocks' M backwards; one block's are `per_step_launches`'."""
    one = per_step_launches(cfg, save_probs=True)
    return {k: v * (2 * microbatches if k.endswith("_fwd") else microbatches)
            for k, v in one.items()}


def recipe_siglip(main, loop, mha, ln, cfg) -> dict:
    """(a): ViT-B-16-SigLIP, --siglip --accum-freq 2 --force-patch-dropout
    0.5, pure_bf16, synthetic data; the step's exact launches, finite
    losses falling from the first to the last, the step interval's median
    (host clock between step starts, the loop waiting for each loss) and
    samples/s over the timed steps."""
    per_step = recipe_per_step(cfg, RECIPE_ACCUM)
    with TrainerProbe(loop, mha, ln, per_step) as probe:
        final = main(RECIPE_SIGLIP)
    losses = probe.loss_values()
    if len(losses) != RECIPE_WARMUP + RECIPE_STEPS or \
            not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"recipe (a): losses {losses}")
    starts = [a for a, _ in probe.host]
    timed = list(range(RECIPE_WARMUP, len(starts) - 1))
    intervals = [(starts[i + 1] - starts[i]) * 1e3 for i in timed]
    result = {"batch": RECIPE_BATCH, "microbatches": RECIPE_ACCUM,
              "patch_dropout": RECIPE_PATCH_DROPOUT,
              "vision_seq": 1 + max(1, int(cfg.vision.grid ** 2
                                           * (1 - RECIPE_PATCH_DROPOUT))),
              "step_interval_ms_median": float(np.median(intervals)),
              "samples_per_s": RECIPE_BATCH * len(timed)
              / (starts[timed[-1] + 1] - starts[timed[0]]),
              "host_ms_in_step_median": float(np.median(
                  [(probe.host[i][1] - probe.host[i][0]) * 1e3
                   for i in timed])),
              "per_step_launches": per_step, "losses": losses,
              "final": final, "launches": probe.launches}
    log(f"  (a) SigLIP, accum {RECIPE_ACCUM}, patch dropout "
        f"{RECIPE_PATCH_DROPOUT}, batch {RECIPE_BATCH}: step interval "
        f"median {result['step_interval_ms_median']:.2f} ms, "
        f"{result['samples_per_s']:.1f} samples/s, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    return result


class ModelProbe:
    """Keeps the model `pretrain_clip.main` builds (the loop's
    factory.create_model wrapped while the run lasts) and a copy of its
    parameters as built."""

    def __init__(self, loop):
        self.factory = loop.factory

    def __enter__(self):
        self._create = create = self.factory.create_model
        probe = self

        def created(*args, **kw):
            probe.model = create(*args, **kw)
            probe.start = {n: p.detach().clone()
                           for n, p in probe.model.named_parameters()}
            return probe.model
        self.factory.create_model = created
        return self

    def __exit__(self, *exc):
        self.factory.create_model = self._create
        return False


def recipe_lit(main, loop, mha, ln, cfg, tower: str, unlocked: int,
               steps: int) -> dict:
    """(b): LiT on ViT-B-16-SigLIP (--lock-image --lock-image-unlocked-groups
    2, then --lock-text, bf16 on fp32 weights): the step's exact
    launches, finite losses, every locked parameter bit-equal to its
    start, every unlocked one moved but logit_bias, which stays at -10:
    the JAX step calls the loss without it, so its gradient is zero."""
    from megatron_clip_tpu_torch.training.optim import tower_lock_mask
    per_step = per_step_launches(cfg, save_probs=True)
    with ModelProbe(loop) as built, \
            TrainerProbe(loop, mha, ln, per_step) as probe:
        final = main(recipe_lit_argv(tower, unlocked, steps))
    losses = probe.loss_values()
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"recipe (b) {tower}: losses {losses}")
    model = built.model
    mask = tower_lock_mask(
        dict(model.named_parameters()), lock_image=tower == "image",
        image_unlocked_groups=unlocked, lock_text=tower == "text",
        text_unlocked_layers=unlocked)
    locked = sorted(n for n, m in mask.items() if m == 0.0)
    moved, still = [], []
    for n, p in model.named_parameters():
        (still if torch.equal(p.detach(), built.start[n]) else moved).append(n)
    wrong = sorted(set(locked) ^ (set(still) - {"logit_bias"}))
    bias = float(model.logit_bias.detach())
    result = {"tower": tower, "batch": LIT_BATCH, "unlocked": unlocked,
              "locked_parameters": len(locked),
              "locked_elements": sum(model.get_parameter(n).numel()
                                     for n in locked),
              "moved_parameters": len(moved), "logit_bias": bias,
              "losses": losses, "final": final, "launches": probe.launches}
    log(f"  (b) LiT, --lock-{tower} ({unlocked} unlocked): {len(locked)} "
        f"locked parameters ({result['locked_elements']} elements) "
        f"bit-equal, {len(moved)} moved, logit_bias {bias}, losses "
        f"{losses}")
    if wrong or bias != -10.0 or not locked:
        raise AssertionError(f"recipe (b) {tower}: locked but moved or "
                             f"unlocked but still: {wrong[:8]}; logit_bias "
                             f"{bias}")
    del model, built.model, built.start
    return result


def recipe_parity(port) -> dict:
    """(c): one fp32 --siglip --accum-freq 2 --force-patch-dropout 0.5
    step at RECIPE_PARITY_LAYERS a tower, card against CPU
    (`card_vs_cpu`); then on the card the summed block gradients of
    --accum-freq 2 against the --accum-freq 1 gradient of the same batch
    without patch dropout, each gradient within GRAD_REL_TOL of its norm
    (logit_bias's: 0 in both)."""
    from megatron_clip_tpu_torch.factory import get_model_config
    from megatron_clip_tpu_torch.losses import SigLipLoss
    from megatron_clip_tpu_torch.training import (TrainState, cosine_lr,
                                                  make_optimizer,
                                                  make_train_step)
    base = get_model_config(RECIPE_MODEL)
    over = {"vision_cfg": dict(base["vision_cfg"],
                               layers=RECIPE_PARITY_LAYERS),
            "text_cfg": dict(base["text_cfg"], layers=RECIPE_PARITY_LAYERS)}
    data = []

    def step(device, microbatches, rate):
        model = port.create_model(
            RECIPE_MODEL, precision="fp32", seed=0, device=device,
            **dict(over, vision_cfg=dict(over["vision_cfg"],
                                         patch_dropout=rate))).train()
        if not data:
            data.extend(train_batch(model.cfg, RECIPE_PARITY_BATCH, seed=1))
        opt = make_optimizer(model, cosine_lr(1e-3, 100, 10000),
                             grad_clip_norm=1.0)
        grads = keep_grads(opt)
        t0 = time.perf_counter()
        _, m = make_train_step(model, opt, loss_obj=SigLipLoss(),
                               microbatches=microbatches, seed=0)(
            TrainState.create(model, opt), *(t.to(device) for t in data))
        took = time.perf_counter() - t0
        del opt.update
        return (float(m["loss"]), float(m["grad_norm"]), grads,
                {n: p.detach().cpu() for n, p in model.named_parameters()},
                took)
    res = {"card_vs_cpu": card_vs_cpu(
        f"{RECIPE_MODEL} at {RECIPE_PARITY_LAYERS} layers a tower, siglip, "
        f"accum {RECIPE_ACCUM}, patch dropout {RECIPE_PATCH_DROPOUT}",
        lambda device: step(device, RECIPE_ACCUM, RECIPE_PATCH_DROPOUT),
        param_tol=1e-6)}
    whole = step("cuda", 1, 0.0)[2]
    acc = step("cuda", RECIPE_ACCUM, 0.0)[2]
    errs = {n: float((acc[n] - g).norm() / g.norm())
            for n, g in whole.items() if n != "logit_bias"}
    worst = max(errs, key=errs.get)
    res["accum_vs_whole"] = {"worst_leaf": worst,
                             "worst_rel_err": errs[worst],
                             "logit_bias_grads": [
                                 float(whole["logit_bias"]),
                                 float(acc["logit_bias"])]}
    log(f"  (c) accum {RECIPE_ACCUM} against the whole batch on the card: "
        f"{json.dumps(res['accum_vs_whole'])}")
    if errs[worst] > GRAD_REL_TOL or \
            res["accum_vs_whole"]["logit_bias_grads"] != [0.0, 0.0]:
        raise AssertionError("the accumulated gradient differs from the "
                             "whole batch's")
    torch.cuda.empty_cache()
    return res


def phase_recipes(mha, ln, card: str) -> dict:
    log(f"[13] recipes: pretrain_clip.main on the card, {RECIPE_MODEL}: (a) "
        f"--siglip --accum-freq {RECIPE_ACCUM} --force-patch-dropout "
        f"{RECIPE_PATCH_DROPOUT}, pure_bf16, batch {RECIPE_BATCH}, "
        f"{RECIPE_WARMUP} + {RECIPE_STEPS} steps; (b) --lock-image "
        f"--lock-image-unlocked-groups {LIT_UNLOCKED}, then --lock-text, "
        f"batch {LIT_BATCH}; (c) fp32 parity")
    t0 = time.perf_counter()
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.factory import (get_model_config,
                                                 parse_model_cfg)
    from megatron_clip_tpu_torch.pretrain_clip import main
    from megatron_clip_tpu_torch.training import loop
    cfg = parse_model_cfg(get_model_config(RECIPE_MODEL))
    result = {"card": card}
    parts = {"siglip": lambda: recipe_siglip(main, loop, mha, ln, cfg),
             **{f"lit_{tower}": functools.partial(
                 recipe_lit, main, loop, mha, ln, cfg, tower, unlocked, steps)
                for tower, unlocked, steps in LIT_RUNS},
             "parity": lambda: recipe_parity(port)}
    for name, part in parts.items():
        t_part = time.perf_counter()
        result[name] = part()
        result[name]["seconds"] = time.perf_counter() - t_part
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t0
    log(f"  recipes: {json.dumps(result)}")
    if result["seconds"] > RECIPE_PHASE_LIMIT_S:
        raise AssertionError(
            f"phase 13 took {result['seconds']:.1f} s, over "
            f"{RECIPE_PHASE_LIMIT_S} s: " + phase_parts(result))
    return result


def dp_worker(spec_path: str) -> int:
    """One rank of a phase 14 run (`chip_smoke.py --dp-worker SPEC` under
    torchrun). It waits for the file spec["go"] (the launch is made before
    phase 2, so that its processes start beside the build), then runs
    `pretrain_clip.main(spec["argv"])` with the model and the steps probed
    as phases 12 and 13 probe them (each step's launches held to phase 7's
    when spec["launches"]); with spec["gate"] its first step waits until
    that file exists too, so that its steps run alone on the card. It
    writes this rank's losses, step clock, launches and a digest of its
    parameters to OUT/rank{r}.json, and rank 0's parameters to
    OUT/params.pt when spec["params"]."""
    import hashlib
    from megatron_clip_tpu_torch.factory import (get_model_config,
                                                 parse_model_cfg)
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    from megatron_clip_tpu_torch.pretrain_clip import main as train_main
    from megatron_clip_tpu_torch.training import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    out, rank = Path(spec["out"]), int(os.environ.get("RANK", "0"))
    wait_for(Path(spec["go"]), DP_GO_TIMEOUT_S, spec["owner"])
    wall = time.time() - time.perf_counter()  # the host clock as wall time
    went = time.perf_counter()
    per_step = None
    if spec["launches"]:
        model = spec["argv"][spec["argv"].index("--model") + 1]
        per_step = per_step_launches(parse_model_cfg(get_model_config(
            model)), save_probs=True)
    step, gated, runners = loop._JointRunner.step, {}, []

    def gated_step(run, images, texts):
        runners[:] = [run]
        if spec["gate"]:
            gated.setdefault("at", time.perf_counter())
            wait_for(Path(spec["gate"]), DP_GO_TIMEOUT_S, spec["owner"])
            gated.setdefault("opened", time.perf_counter())
        return step(run, images, texts)
    loop._JointRunner.step = gated_step
    try:
        with ModelProbe(loop) as built, \
                TrainerProbe(loop, mha, ln, per_step) as probe:
            final = train_main(spec["argv"])
    finally:
        loop._JointRunner.step = step
    params = {n: p.detach().cpu() for n, p in
              built.model.named_parameters()}
    digest = hashlib.sha256()
    for n, p in params.items():
        digest.update(n.encode())
        digest.update(p.reshape(-1).view(torch.uint8).numpy().tobytes())
    if spec["params"] == "all":  # each rank's own (a sharded model's shards)
        torch.save(params, out / f"params{rank}.pt")
    elif spec["params"] and rank == 0:
        torch.save(params, out / "params.pt")
    waited = gated.get("opened", 0.0) - gated.get("at", 0.0)
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "world": int(os.environ.get("WORLD_SIZE", "1")),
        "state_bytes": state_bytes(built.model,
                                   runners[0].state.opt_state),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "losses": probe.loss_values(), "host": probe.host,
        "launches": probe.launches, "digest": digest.hexdigest(),
        "final": final, "wall": {
            "go": wall + went, "gate_wait": waited,
            "first_step": wall + probe.host[0][0] + waited,
            "last_step_end": wall + probe.host[-1][1],
            "returned": wall + time.perf_counter()}}))
    return 0


def state_bytes(model, opt_state) -> dict:
    """The bytes of a rank's parameters (a sharded model's shards) and of
    its optimizer's moments."""
    return {"params": sum(p.numel() * p.element_size()
                          for p in model.parameters()),
            "moments": sum(t.numel() * t.element_size()
                           for t in (*opt_state.mu.values(),
                                     *opt_state.nu.values()))}


def process_alive(pid: int) -> bool:
    """Whether `pid` runs: it exists in /proc and is no zombie."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def wait_for(path: Path, timeout: float, owner: int = None) -> None:
    """Return once `path` exists; raise after `timeout` seconds, or as soon
    as the process `owner` (the script that made the launch) has gone. The
    launches wait so through phases 2 to 13: a poll every 50 ms keeps their
    wake-ups out of the timed phases."""
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        if owner is not None and not process_alive(owner):
            raise RuntimeError(f"the launching process {owner} has gone")
        time.sleep(0.05)


class DataParallelLaunches:
    """Phase 14's torchrun launches, made before phase 2: (a) one rank over
    NCCL on phase 12's synthetic run, and (b) each run of DP_PARITY_RUNS on
    DP_RANKS ranks over gloo on the one card. Each `python -m
    torch.distributed.run --standalone` runs this script's --dp-worker in a
    session of its own, its output in its directory's log.txt, and waits
    for `go`; (a) also for `gate` at its first step. `stop` ends any still
    running; it runs at exit too."""

    root, worker_flag = DP_DIR, "--dp-worker"

    def __init__(self):
        shutil.rmtree(self.root, ignore_errors=True)
        self.root.mkdir(parents=True)
        self.go, self.gate = self.root / "go", self.root / "gate"
        at = TRAINER_SYNTHETIC.index("--train-num-samples")
        one_rank = TRAINER_SYNTHETIC[:at] + [
            "--train-num-samples", str(TRAIN_BATCH * (DP_WARMUP + DP_STEPS)),
            *TRAINER_SYNTHETIC[at + 2:], "--dist-backend", "nccl"]
        self.procs = {}
        self.dirs = {"one rank": DP_DIR / "a"}
        self.launch("one rank", one_rank, 1, launches=True, params=False,
                    gate=self.gate)
        common = ["--precision", "fp32", "--batch-size",
                  str(DP_PARITY_BATCH), "--dataset-type", "synthetic",
                  "--train-num-samples",
                  str(DP_PARITY_BATCH * DP_PARITY_STEPS), "--lr", "1e-4",
                  "--warmup", "2", "--grad-clip-norm", "1.0",
                  "--log-interval", "1"]
        self.parity = {name: common + flags
                       for name, flags in DP_PARITY_RUNS.items()}
        for i, (name, argv) in enumerate(self.parity.items()):
            self.dirs[name] = DP_DIR / f"b{i}"
            self.launch(name, argv + ["--device", "cuda:0", "--dist-backend",
                                      "gloo"], DP_RANKS, launches=False,
                        params=True, gate=None)
        atexit.register(self.stop)

    def launch(self, name: str, argv: list, ranks: int, launches: bool,
               params: bool, gate) -> None:
        work = self.dirs[name]
        work.mkdir()
        spec = work / "spec.json"
        spec.write_text(json.dumps({
            "argv": argv, "out": str(work), "launches": launches,
            "params": params, "go": str(self.go), "gate": gate and str(gate),
            "owner": os.getpid()}))
        self.start(name, ranks, spec)

    def start(self, name: str, ranks: int, spec: Path) -> None:
        """torchrun of `ranks` workers (this script with `worker_flag`) on
        `spec`, in a session of its own, its output in log.txt beside."""
        with open(spec.parent / "log.txt", "w") as log_file:
            self.procs[name] = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(ranks),
                 str(Path(__file__).resolve()), self.worker_flag,
                 str(spec)],
                cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT,
                start_new_session=True)

    def wait(self, name: str, ranks: int, timeout: float) -> list:
        """Each rank's JSON once launch `name` has exited 0; a launch that
        fails or outlasts `timeout` (its session killed) raises with its
        log's end. Rank 0's gets `wall_s`: where its run's wall time went,
        from `go` to its first step (less a gate's wait), the steps, the
        run after them, and from its return to torchrun's exit."""
        proc, work = self.procs[name], self.dirs[name]
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            kill_tree(proc.pid)
            proc.wait()
            rc = "timeout"
        exited = time.time()
        if rc != 0:
            tail = (work / "log.txt").read_text()[-4000:]
            raise AssertionError(f"torchrun of {name} ended with {rc}:\n"
                                 f"{tail}")
        got = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(ranks)]
        if not got or "wall" not in got[0]:
            return got
        w = got[0]["wall"]
        got[0]["wall_s"] = {
            "to_first_step": w["first_step"] - w["go"] - w["gate_wait"],
            "gate_wait": w["gate_wait"],
            "steps": w["last_step_end"] - w["first_step"],
            "after_steps": w["returned"] - w["last_step_end"],
            "to_exit": exited - w["returned"]}
        return got

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                kill_tree(proc.pid)  # torchrun and its ranks
                proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


def dp_one_rank(launches: DataParallelLaunches, phase12: dict) -> dict:
    """(a), its gate opened: the step's exact launches (held in the rank),
    the loop's samples/s over the timed steps (host clock between the first
    and the last timed step's starts) and the step interval's median beside
    phase 12's."""
    launches.gate.touch()
    got = launches.wait("one rank", 1, timeout=120)[0]
    losses = got["losses"]
    if len(losses) != DP_WARMUP + DP_STEPS or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"data parallel (a): losses {losses}")
    starts = [a for a, _ in got["host"]]
    timed = list(range(DP_WARMUP, len(starts) - 1))
    sps = TRAIN_BATCH * len(timed) / (starts[timed[-1] + 1]
                                      - starts[timed[0]])
    interval = float(np.median([(starts[i + 1] - starts[i]) * 1e3
                                for i in timed]))
    result = {"world": got["world"], "samples_per_s": sps,
              "phase12_samples_per_s": phase12["samples_per_s"],
              "ratio": sps / phase12["samples_per_s"],
              "step_interval_ms_median": interval,
              "phase12_step_interval_ms_median":
                  phase12["step_interval_ms_median"],
              "host_ms_in_step_median": float(np.median(
                  [(got["host"][i][1] - got["host"][i][0]) * 1e3
                   for i in timed])),
              "wall_s": got["wall_s"], "losses": losses,
              "launches": got["launches"]}
    log(f"  (a) one rank over NCCL: {sps:.1f} samples/s against phase 12's "
        f"{phase12['samples_per_s']:.1f} (ratio {result['ratio']:.4f}); "
        f"step interval median {interval:.2f} ms against "
        f"{phase12['step_interval_ms_median']:.2f}; wall s "
        f"{json.dumps(got['wall_s'])}")
    return result


def dp_parity(launches: DataParallelLaunches, mha, ln) -> dict:
    """(b): while the launches run, this process takes the same steps of
    each in one process on the card: the losses within DP_LOSS_RTOL
    relative, each parameter within DP_PARAM_RTOL of its norm, the ranks'
    parameters bit-equal (their digests)."""
    from megatron_clip_tpu_torch.pretrain_clip import main
    from megatron_clip_tpu_torch.training import loop
    result = {}
    for name, argv in launches.parity.items():
        t0 = time.perf_counter()
        with ModelProbe(loop) as built, \
                TrainerProbe(loop, mha, ln, None) as probe:
            main(argv)
        one = {n: p.detach().cpu() for n, p in
               built.model.named_parameters()}
        want = probe.loss_values()
        del built.model, built.start
        torch.cuda.empty_cache()
        one_s = time.perf_counter() - t0
        ranks = launches.wait(name, DP_RANKS, timeout=120)
        got = torch.load(launches.dirs[name] / "params.pt")
        rel = {n: float((got[n] - p).norm() / p.norm().clamp_min(1e-30))
               for n, p in one.items()}
        worst = max(rel, key=rel.get)
        loss_err = max(abs(g - w) / abs(w) for r in ranks
                       for g, w in zip(r["losses"], want))
        res = {"wall_s": ranks[0]["wall_s"], "losses_one_process": want,
               "losses_ranks": [r["losses"] for r in ranks],
               "loss_max_rel_err": loss_err, "param_worst_leaf": worst,
               "param_worst_rel_err": rel[worst],
               "ranks_bit_equal": len({r["digest"] for r in ranks}) == 1,
               "one_process_s": one_s}
        log(f"  (b) {name}, {DP_RANKS} ranks over gloo against one process: "
            f"{json.dumps(res)}")
        if len(want) != DP_PARITY_STEPS or \
                any(len(r["losses"]) != DP_PARITY_STEPS for r in ranks) \
                or loss_err > DP_LOSS_RTOL or rel[worst] > DP_PARAM_RTOL \
                or not res["ranks_bit_equal"]:
            raise AssertionError(f"data parallel (b) {name}: the ranks "
                                 "disagree with one process or with each "
                                 "other")
        result[name] = res
    return result


def phase_data_parallel(launches: DataParallelLaunches, mha, ln, card: str,
                        trainer: dict) -> dict:
    log(f"[14] data parallel: pretrain_clip under torch.distributed.run: (a) "
        f"one rank over NCCL, ViT-B-32 pure_bf16 batch {TRAIN_BATCH}, "
        f"{DP_WARMUP} + {DP_STEPS} steps; (b) {DP_RANKS} ranks on the card "
        f"over gloo, fp32, global batch {DP_PARITY_BATCH}, "
        f"{DP_PARITY_STEPS} steps, against one process: "
        f"{', '.join(DP_PARITY_RUNS)}")
    t0 = time.perf_counter()
    result = {"card": card}
    # every launch builds its model at once; (a) holds its first step
    # until (b) has ended, and then takes its steps alone on the card
    launches.go.touch()
    try:
        result["gloo_two_ranks"] = dp_parity(launches, mha, ln)
        result["gloo_two_ranks_seconds"] = time.perf_counter() - t0
        result["nccl_one_rank"] = dp_one_rank(launches, trainer["synthetic"])
    finally:
        launches.stop()
    result["seconds"] = time.perf_counter() - t0
    log(f"  data parallel ({card}): {json.dumps(result)}")
    if result["seconds"] > DP_PHASE_LIMIT_S:
        raise AssertionError(
            f"phase 14 took {result['seconds']:.1f} s, over "
            f"{DP_PHASE_LIMIT_S} s: " + phase_parts(result))
    return result


class WorkloadProbe:
    """Wraps the GPT runtime's runner (`training/workload.py`) while one
    run lasts: each step's kernel launches (which must equal `per_step`),
    loss, grad norm, device ms (CUDA events around the runner's step), host
    clock at its start and end and peak memory (reset before the step);
    each eval's launches (which must equal `per_eval`; None: either is not
    held); each save's host
    ms (the host copy alone, for a save in the background); the last
    runner, and with `keep_grads` each step's gradients on the host. The
    counters are zeroed on entry and read on exit into `launches`."""

    def __init__(self, workload, mha, ln, per_step: dict,
                 per_eval: dict = None, keep_grads: bool = False):
        self.workload, self.mha, self.ln = workload, mha, ln
        self.per_step, self.per_eval = per_step, per_eval
        self.keep_grads = keep_grads
        self.steps, self.evals, self.save_ms, self.grads = [], [], [], []
        self.runner = None

    def __enter__(self):
        wl = self.workload
        self._saved = (wl._Runner.step, wl._Runner.evaluate,
                       wl.save_checkpoint)
        step, evaluate, save = self._saved
        probe = self

        def probed_step(run, batch, i):
            probe.runner = run
            if probe.keep_grads and not hasattr(run.optimizer, "_kept"):
                update = run.optimizer.update

                def keep(state, g):
                    # a copy: on the CPU `.cpu()` would keep the gradient
                    # buckets' views, which the next step overwrites
                    probe.grads.append({n: t.detach().to(
                        "cpu", torch.float32, copy=True)
                        for n, t in g.items()})
                    return update(state, g)
                run.optimizer.update = run.optimizer._kept = keep
            before = read_counts(probe.mha, probe.ln)
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            metrics = step(run, batch, i)
            ev[1].record()
            t1 = time.perf_counter()
            got = {k: v - before[k]
                   for k, v in read_counts(probe.mha, probe.ln).items()}
            if probe.per_step is not None and got != probe.per_step:
                raise AssertionError(f"GPT trainer step {i}: launches {got}, "
                                     f"expected {probe.per_step}")
            ev[1].synchronize()
            probe.steps.append({
                "step": i, "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "device_ms": ev[0].elapsed_time(ev[1]), "host": (t0, t1),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
            return metrics

        def probed_evaluate(run, val_iter, iters):
            before = read_counts(probe.mha, probe.ln)
            v = evaluate(run, val_iter, iters)
            got = {k: v2 - before[k]
                   for k, v2 in read_counts(probe.mha, probe.ln).items()}
            want = got if probe.per_eval is None else {
                k: n * iters for k, n in probe.per_eval.items()}
            if got != want:
                raise AssertionError(f"GPT trainer eval: launches {got}, "
                                     f"expected {want}")
            probe.evals.append(v)
            return v

        def probed_save(root, at, state, metadata=None, block=True, **kw):
            t0 = time.perf_counter()
            out = save(root, at, state, metadata, block=block, **kw)
            probe.save_ms.append({"step": at, "background": not block,
                                  "ms": (time.perf_counter() - t0) * 1e3})
            return out
        wl._Runner.step, wl._Runner.evaluate = probed_step, probed_evaluate
        wl.save_checkpoint = probed_save
        zero_counts(self.mha, self.ln)
        return self

    def __exit__(self, *exc):
        wl = self.workload
        wl._Runner.step, wl._Runner.evaluate, wl.save_checkpoint = \
            self._saved
        self.launches = read_counts(self.mha, self.ln)
        return False

    def losses(self) -> list:
        return [s["loss"] for s in self.steps]


def gpt_trainer_per_step(cfg, seq: int, fused_ce: bool, remat: str,
                         microbatches: int = 1) -> dict:
    """Kernel launches of one GPT trainer step of `microbatches`
    microbatches: each microbatch's `gpt_per_step`, plus the norm's forward
    once more per block norm that the recompute replays (selective and mlp
    recompute ln_1 and ln_2)."""
    one = gpt_per_step(cfg.num_layers, seq, cfg.normalization, fused_ce)
    if remat in ("selective", "mlp"):
        kind = "rms_norm" if cfg.normalization == "rmsnorm" else "layer_norm"
        one[f"{kind}_fwd"] += 2 * cfg.num_layers
    return {k: v * microbatches for k, v in one.items()}


def gpt_trainer_per_eval(cfg, fused_ce: bool) -> dict:
    """Kernel launches of one eval batch: the forwards of a step's."""
    one = gpt_per_step(cfg.num_layers, cfg.seq_length, cfg.normalization,
                       fused_ce)
    return {k: (v if k.endswith("_fwd") else 0) for k, v in one.items()}


def corpus_vocab(rng) -> list:
    """The corpus's words: 4000 pseudo-words of 2-4 syllables drawn from
    `rng`, numbers and punctuation."""
    syll = ["ka", "ro", "mi", "te", "sun", "ar", "lo", "ve", "qui", "da",
            "ne", "po", "li", "sa", "tor", "en", "gu", "fi", "ba", "ze"]
    vocab = ["".join(rng.choice(syll, int(rng.integers(2, 5))))
             for _ in range(4000)]
    return vocab + [str(n) for n in range(100)] + [",", ".", "?", "!", ";"]


def corpus_prompts() -> list:
    """Phase 18 (b)'s prompts: 8 runs of the corpus's words (its
    vocabulary, drawn as `gpt_corpus` draws it), of 1 to 14 CLIP BPE
    tokens, text of the kind the served model was trained on."""
    from megatron_clip_tpu_torch.tokenizer import SimpleTokenizer
    tok, rng = SimpleTokenizer(), np.random.default_rng(18)
    vocab = corpus_vocab(np.random.default_rng(0))
    prompts = []
    for words in (4, 1, 3, 1, 2, 3, 1, 4):
        while True:
            text = " ".join(rng.choice(vocab, words))
            if len(tok.encode(text)) <= 14:
                prompts.append(text)
                break
    return prompts


def gpt_corpus(root: Path) -> dict:
    """(a)'s corpus: GPT_CORPUS_DOCS jsonl documents of seeded words (a
    vocabulary of 4000 pseudo-words of 2-4 syllables, numbers and
    punctuation), preprocessed by `python -m
    megatron_clip_tpu_torch.tools.preprocess_data --tokenizer clip-bpe
    --append-eod` with GPT_CORPUS_WORKERS workers; returns its prefix and
    the tool's docs, tokens and rate."""
    rng = np.random.default_rng(0)
    vocab = corpus_vocab(rng)
    jsonl = root / "corpus.jsonl"
    with open(jsonl, "w") as f:
        for _ in range(GPT_CORPUS_DOCS):
            n = int(rng.integers(*GPT_CORPUS_WORDS))
            words = rng.choice(vocab, n, p=None)
            f.write(json.dumps({"text": " ".join(words)}) + "\n")
    prefix = str(root / "corpus")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "megatron_clip_tpu_torch.tools.preprocess_data",
         "--input", str(jsonl), "--output-prefix", prefix, "--tokenizer",
         "clip-bpe", "--append-eod", "--workers", str(GPT_CORPUS_WORKERS)],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    took = time.perf_counter() - t0
    m = re.search(r"done: (\d+) docs, (\d+) tokens .* in ([\d.]+) s "
                  r"\((\d+) tokens/s from", out.stdout)
    if m is None:
        raise AssertionError(f"preprocess_data printed {out.stdout!r}")
    docs, tokens = int(m.group(1)), int(m.group(2))
    res = {"prefix": prefix, "docs": docs, "tokens": tokens,
           "tool_seconds": float(m.group(3)),
           "tokens_per_s": int(m.group(4)),
           "process_seconds": took}
    log(f"  corpus: {docs} documents, {tokens} tokens (clip-bpe, "
        f"{GPT_CORPUS_WORKERS} workers): {res['tokens_per_s']} tokens/s from "
        f"the first document on; the tool's {res['tool_seconds']:.2f} s, "
        f"{took:.2f} s with the process's start")
    return res


def step_rates(steps: list, batch: int, seq: int, timed: list) -> dict:
    """Samples/s and tokens/s over the `timed` steps (host clock from the
    first's start to the last's end, the loop waiting for each loss, saves
    included), each timed step's device ms (CUDA events around the
    runner's step) and the tokens a second of their median."""
    span = steps[timed[-1]]["host"][1] - steps[timed[0]]["host"][0]
    device = [steps[i]["device_ms"] for i in timed]
    return {"samples_per_s": batch * len(timed) / span,
            "tokens_per_s": batch * seq * len(timed) / span,
            "step_device_ms": device,
            "step_device_ms_median": float(np.median(device)),
            "tokens_per_s_device": batch * seq * 1e3 / float(np.median(
                device))}


def gpt_trainer_dist(main, workload, mha, ln, work: Path,
                     example_step_ms: float, corpus_dir: Path) -> dict:
    """(a): examples/pretrain_gpt_dist.sh on one card on the corpus:
    GPT_DIST_STEPS steps in microbatches of GPT_DIST_MICRO, a background
    save at GPT_DIST_SAVE_AT (the final save at the end), the eval; then
    the tracker put back at the save's step (as if the run had been cut
    before its last save committed) and a run loaded from it (--load)
    for the last step, whose loss must be the first run's bit for bit, its
    grad norm and val loss within GPT_RESUME_DRIFT. Exact launches every step and eval; the losses
    falling from about ln(50304); the step's device ms beside
    GPT_DIST_MICRO times phase 10's step median."""
    from megatron_clip_tpu_torch.checkpoints import io as ckpt_io
    from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                      parse_args)
    corpus = gpt_corpus(corpus_dir)
    root = str(work / "ckpt")
    argv = GPT_DIST + GPT_DIST_WARMUP + [
        "--micro-batch-size", str(GPT_DIST_MICRO), "--data-path",
        corpus["prefix"], "--train-steps", str(GPT_DIST_STEPS),
        "--eval-interval", str(GPT_DIST_STEPS), "--eval-iters",
        str(GPT_DIST_EVAL_ITERS), "--log-interval", "1"]
    cfg = gpt_cfg_from_args(parse_args(argv))
    batch = int(argv[argv.index("--batch-size") + 1])
    per_step = gpt_trainer_per_step(cfg, cfg.seq_length, True, "selective",
                                    batch // GPT_DIST_MICRO)
    per_eval = gpt_trainer_per_eval(cfg, True)
    with WorkloadProbe(workload, mha, ln, per_step, per_eval) as first:
        out = main(argv + ["--save", root, "--save-interval",
                           str(GPT_DIST_SAVE_AT)])
    first.runner = None
    torch.cuda.empty_cache()
    ckpt_io._write_tracker(root, GPT_DIST_SAVE_AT)
    with WorkloadProbe(workload, mha, ln, per_step, per_eval) as resumed:
        again = main(argv + ["--load", root])
    resumed.runner = None
    torch.cuda.empty_cache()
    losses = first.losses()
    tail = [(s["loss"], s["grad_norm"]) for s in resumed.steps]
    want = [(s["loss"], s["grad_norm"]) for s in first.steps][
        GPT_DIST_SAVE_AT:]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0] or abs(losses[0] - math.log(
                cfg.vocab_size)) > 1.0:
        raise AssertionError(f"(a): losses {losses}, from ln(vocab) "
                             f"{math.log(cfg.vocab_size):.3f}")
    # the resumed step's forward is the whole run's bit for bit; its
    # gradients (and so the val loss after its update) move by the flash
    # backward's unordered fp32 reduce-adds into dQ
    drift = max([abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(tail, want)]
                + [abs(a - b) / abs(b) for a, b in zip(resumed.evals,
                                                       first.evals)])
    if [t[0] for t in tail] != [w[0] for w in want] or \
            len(resumed.evals) != len(first.evals) or \
            drift > GPT_RESUME_DRIFT:
        raise AssertionError(f"(a): the resumed step {tail} and eval "
                             f"{resumed.evals} differ from the whole run's "
                             f"{want} and {first.evals}")
    rates = step_rates(first.steps, batch, cfg.seq_length,
                       list(range(1, GPT_DIST_STEPS)))
    starts = [s["host"][0] for s in first.steps]
    result = {
        "dropped_flags": GPT_DIST_DROPPED, "corpus": corpus,
        "microbatches": batch // GPT_DIST_MICRO, "batch": batch,
        "seq": cfg.seq_length, **rates,
        "step_interval_ms": [(b - a) * 1e3 for a, b in zip(starts,
                                                           starts[1:])],
        "step_interval_ms_median": float(np.median(
            [(b - a) * 1e3 for a, b in zip(starts, starts[1:])])),
        "example_step_ms_x_microbatches": example_step_ms
        * (batch // GPT_DIST_MICRO),
        "losses": losses, "resumed_losses": resumed.losses(),
        "val_loss": first.evals, "resumed_val_loss": resumed.evals,
        "saves": first.save_ms, "peak_memory_gib": max(
            s["peak_gib"] for s in first.steps),
        "per_step_launches": per_step, "per_eval_launches": per_eval,
        "final": {k: out[k] for k in ("loss", "last_step", "val_loss")},
        "resumed_final": {k: again[k] for k in ("loss", "last_step",
                                                "val_loss")},
        "launches": {k: first.launches[k] + resumed.launches[k]
                     for k in first.launches}}
    result["resume_grad_norm_and_val_rel_drift"] = drift
    result["device_ms_vs_example_x_micro"] = (
        result["step_device_ms_median"]
        / result["example_step_ms_x_microbatches"])
    log(f"  (a) examples/pretrain_gpt_dist.sh on one card (dropped "
        f"{' '.join(GPT_DIST_DROPPED)}: they need 4 cards; --sequence-"
        f"parallel changes nothing at tp 1), batch {batch} in "
        f"{batch // GPT_DIST_MICRO} microbatches of {GPT_DIST_MICRO}: "
        f"{rates['tokens_per_s']:.0f} tokens/s, {rates['samples_per_s']:.2f}"
        f" samples/s over steps 2-{GPT_DIST_STEPS} (the save at "
        f"{GPT_DIST_SAVE_AT} included); step device ms median "
        f"{rates['step_device_ms_median']:.1f} against {batch // GPT_DIST_MICRO}"
        f" x phase 10's {example_step_ms:.2f} = "
        f"{result['example_step_ms_x_microbatches']:.1f} (ratio "
        f"{result['device_ms_vs_example_x_micro']:.4f}); losses {losses}; "
        f"val {first.evals}; the resumed loss bit-equal (grad norm and val "
        f"loss {drift:.3g} apart); saves "
        f"{first.save_ms}")
    return result


def gpt_trainer_rung(main, workload, mha, ln) -> dict:
    """(b): examples/pretrain_gpt_ladder.sh's 1.3b rung (bf16 weights, bf16
    moments, remat mlp, loss chunks of 512) on synthetic data,
    GPT_RUNG_WARMUP + GPT_RUNG_STEPS steps with exact launches and finite
    losses about ln(vocab) (each step draws a fresh uniform batch, as the
    JAX entry's synthetic stream does); then one step of the same run (its model, optimizer state
    and the next batch) with selective recompute, whose peak memory must
    lie above the mlp steps'."""
    from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                      parse_args)
    steps = GPT_RUNG_WARMUP + GPT_RUNG_STEPS
    argv = GPT_RUNG + ["--train-steps", str(steps), "--log-interval", "1"]
    cfg = gpt_cfg_from_args(parse_args(argv))
    batch = int(argv[argv.index("--batch-size") + 1])
    per_step = gpt_trainer_per_step(cfg, cfg.seq_length, False, "mlp")
    with WorkloadProbe(workload, mha, ln, per_step) as probe:
        out = main(argv)
    losses = probe.losses()
    # a fresh uniform batch each step: the loss stays about ln(vocab)
    if not all(math.isfinite(v) and abs(v - math.log(cfg.vocab_size)) < 1.0
               for v in losses):
        raise AssertionError(f"(b): losses {losses}, ln(vocab) "
                             f"{math.log(cfg.vocab_size):.3f}")
    run = probe.runner
    probe.runner = None
    n_params = sum(p.numel() for p in run.model.parameters())
    run.model.cfg = dataclasses.replace(run.model.cfg, remat="selective")
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (batch, cfg.seq_length + 1)).astype(np.int32)
    with WorkloadProbe(workload, mha, ln, per_step) as selective:
        workload._Runner.step(run, tokens, steps + 1)
    selective.runner = None
    del run
    torch.cuda.empty_cache()
    timed = list(range(GPT_RUNG_WARMUP, steps))
    rates = step_rates(probe.steps, batch, cfg.seq_length, timed)
    peak = max(s["peak_gib"] for s in probe.steps)
    sel_peak = selective.steps[0]["peak_gib"]
    result = {"params": n_params, "batch": batch, "seq": cfg.seq_length,
              **rates, "losses": losses,
              "step_interval_ms_median": float(np.median(
                  [(probe.steps[i + 1]["host"][0] - probe.steps[i]["host"][0])
                   * 1e3 for i in timed[:-1]])),
              "peak_memory_gib_mlp": peak,
              "step_peak_memory_gib_mlp": [s["peak_gib"]
                                           for s in probe.steps],
              "peak_memory_gib_selective_step": sel_peak,
              "selective_step_device_ms": selective.steps[0]["device_ms"],
              "per_step_launches": per_step,
              "final": {k: out[k] for k in ("loss", "last_step")},
              "launches": probe.launches}
    log(f"  (b) the ladder's 1.3b rung ({n_params} parameters, bf16 weights "
        f"and moments, remat mlp, batch {batch} x {cfg.seq_length}): "
        f"{rates['tokens_per_s']:.0f} tokens/s, {rates['samples_per_s']:.2f}"
        f" samples/s, step device ms median "
        f"{rates['step_device_ms_median']:.1f}; losses {losses}; peak "
        f"{peak:.2f} GiB against {sel_peak:.2f} GiB for a selective step "
        f"({selective.steps[0]['device_ms']:.1f} ms)")
    if not peak < sel_peak:
        raise AssertionError(f"(b): remat mlp's peak {peak:.2f} GiB is not "
                             f"below selective's {sel_peak:.2f} GiB")
    return result


def gpt_trainer_parity(main, workload, mha, ln, corpus: str,
                       extra=(), param_rtol: float = DP_PARAM_RTOL) -> dict:
    """(c): GPT_TRAINER_PARITY on the corpus, on the card and on the CPU
    (the plain versions) from the same weights (`--seed`): each step's
    loss and grad norm within 1e-5 relative, each step's gradients within
    GRAD_REL_TOL of their norms, and every parameter after the steps within
    `param_rtol` (DP_PARAM_RTOL, 1e-4) of its norm. `extra`: flags added
    to the run's (phase 16's document flags)."""
    from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                      parse_args)
    argv = GPT_TRAINER_PARITY + list(extra) + ["--data-path", corpus]
    args = parse_args(argv)
    cfg = gpt_cfg_from_args(args)
    b, micro = args.batch_size, args.micro_batch_size
    runs = {}
    for device in ("cuda", "cpu"):
        count = (doc_per_step if "--reset-attention-mask" in extra
                 else functools.partial(gpt_trainer_per_step, seq=cfg.seq_length))
        per_step = (count(cfg, fused_ce=True, remat="none",
                          microbatches=b // micro) if device == "cuda"
                    else dict.fromkeys(KERNEL_META, 0))
        t0 = time.perf_counter()
        with WorkloadProbe(workload, mha, ln, per_step,
                           keep_grads=True) as probe:
            main(argv + ["--device", device])
        params = {n: p.detach().cpu() for n, p in
                  probe.runner.model.named_parameters()}
        probe.runner = None
        runs[device] = (probe, params, time.perf_counter() - t0)
    (pc, parc, tc), (pp, parp, tp) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a["loss"] - c["loss"]) / abs(c["loss"])
                   for a, c in zip(pc.steps, pp.steps))
    norm_err = max(abs(a["grad_norm"] - c["grad_norm"]) / abs(c["grad_norm"])
                   for a, c in zip(pc.steps, pp.steps))
    grad_errs = {(i, n): float((gc[n] - gp[n]).norm() / gp[n].norm())
                 for i, (gc, gp) in enumerate(zip(pc.grads, pp.grads))
                 for n in gp}
    param_errs = {n: float((parc[n] - parp[n]).norm() / parp[n].norm())
                  for n in parp}
    worst_g = max(grad_errs, key=grad_errs.get)
    worst_p = max(param_errs, key=param_errs.get)
    res = {"steps": len(pc.steps), "losses_cuda": pc.losses(),
           "losses_cpu": pp.losses(), "loss_rel_err": loss_err,
           "grad_norm_rel_err": norm_err,
           "grad_worst": [worst_g[0] + 1, worst_g[1], grad_errs[worst_g]],
           "param_worst": [worst_p, param_errs[worst_p]],
           "seconds_cuda": tc, "seconds_cpu": tp}
    log(f"  (c) fp32, 2 layers at full width, S={cfg.seq_length}, batch {b} "
        f"in microbatches of {micro}, the corpus{' '.join([''] + list(extra))}"
        f", card vs CPU: "
        f"{json.dumps(res)}")
    if loss_err > 1e-5 or norm_err > 1e-5 or \
            grad_errs[worst_g] > GRAD_REL_TOL or \
            param_errs[worst_p] > param_rtol:
        raise AssertionError("(c): the GPT trainer on the card disagrees "
                             "with the CPU")
    return res


def phase_gpt_trainer(mha, ln, card: str, example: dict,
                      corpus_dir: Path, keep_ckpt: Path = None) -> dict:
    """Phase 15; with `keep_ckpt`, (a)'s checkpoint is moved there at the
    end (phase 18 (b) serves it)."""
    log(f"[15] GPT trainer: pretrain_gpt.main on the card: (a) "
        f"examples/pretrain_gpt_dist.sh (24 x 1024, S=2048, batch 64 in "
        f"microbatches of {GPT_DIST_MICRO}) on an indexed corpus, "
        f"{GPT_DIST_STEPS} steps, a save and a resume; (b) the ladder's "
        f"1.3b rung, {GPT_RUNG_WARMUP} + {GPT_RUNG_STEPS} steps; (c) fp32 "
        f"card vs CPU")
    t0 = time.perf_counter()
    import unicodedata
    from megatron_clip_tpu_torch.pretrain_gpt import main
    from megatron_clip_tpu_torch.tokenizer import gpt2_classes
    from megatron_clip_tpu_torch.training import workload
    # the GPT-2 pre-tokenizer's \\p{L} and \\p{N} come from the committed
    # table, whatever Unicode this host's Python carries
    log(f"  GPT-2 pre-tokenizer classes: the table of {gpt2_classes.SOURCE}; "
        f"this host's unicodedata {unicodedata.unidata_version}")
    shutil.rmtree(GPT_SMOKE_DIR, ignore_errors=True)
    GPT_SMOKE_DIR.mkdir(parents=True)
    result = {"card": card}
    try:
        parts = {
            "dist": lambda: gpt_trainer_dist(
                main, workload, mha, ln, GPT_SMOKE_DIR,
                example["run"]["step_ms_median"], corpus_dir),
            "rung": lambda: gpt_trainer_rung(main, workload, mha, ln),
            "parity": lambda: gpt_trainer_parity(
                main, workload, mha, ln, result["dist"]["corpus"]["prefix"])}
        for name, part in parts.items():
            t_part = time.perf_counter()
            result[name] = part()
            result[name]["seconds"] = time.perf_counter() - t_part
            torch.cuda.empty_cache()
    finally:
        keep(keep_ckpt)
    result["seconds"] = time.perf_counter() - t0
    log(f"  GPT trainer: {json.dumps(result)}")
    if result["seconds"] > GPT_TRAINER_LIMIT_S:
        raise AssertionError(
            f"phase 15 took {result['seconds']:.1f} s, over "
            f"{GPT_TRAINER_LIMIT_S} s: " + phase_parts(result))
    return result


def keep(ckpt: Path = None) -> None:
    """Remove phase 15's scratch, its (a) checkpoint moved to `ckpt` first
    where one is given."""
    if ckpt is not None and (GPT_SMOKE_DIR / "ckpt").is_dir():
        shutil.move(str(GPT_SMOKE_DIR / "ckpt"), str(ckpt))
    shutil.rmtree(GPT_SMOKE_DIR, ignore_errors=True)


@contextlib.contextmanager
def planted(fault):
    """The TP_FAULTS fault `fault` planted in this rank's port while the
    block runs (nothing for None)."""
    from megatron_clip_tpu_torch.ops.dropout import RankSeed
    from megatron_clip_tpu_torch.ops.kernels import flash_attention as fa
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.training import optim, workload
    saved = [(m, n, getattr(m, n)) for m, n in (
        (fa, "attention_dropout"), (mha, "attention_dropout"),
        (workload, "reduction_plan"), (optim, "norm_weights"),
        (workload._Runner, "_reduced_grads"))]
    if fault == "fault_placement":
        draw = fa.attention_dropout

        def placed(rate, seed, offset, heads=0):
            drop = draw(rate, seed, offset, heads)
            if drop is not None and isinstance(seed, RankSeed):
                drop = drop._replace(bh_base=seed.row_base * drop.bh_stride)
            return drop
        fa.attention_dropout = mha.attention_dropout = placed
    elif fault == "fault_partial_sum":
        plan = workload.reduction_plan

        def unsummed(model):
            tensor = model.layout.tensor
            return {n: tuple(g for g in gs if g is not tensor)
                    for n, gs in plan(model).items()}
        workload.reduction_plan = unsummed
    elif fault == "fault_norm_weight":
        weights = optim.norm_weights

        def counted(model):
            w = weights(model)
            return w and {n: 1.0 if n.endswith("scale") else v
                          for n, v in w.items()}
        optim.norm_weights = counted
    elif fault == "fault_embed_twice":
        reduced = workload._Runner._reduced_grads

        def twice(run, *a):
            loss, grads = reduced(run, *a)
            grads["tok_embed"].mul_(2)
            return loss, grads
        workload._Runner._reduced_grads = twice
    elif fault is not None:
        raise ValueError(f"no planted fault {fault}")
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def gpt_dp_worker(spec_path: str) -> int:
    """One rank of a phase 16 launch (`chip_smoke.py --gpt-dp-worker SPEC`
    under torchrun). It warms up on the CPU (`gpt_warm_up`) and waits for
    spec["go"], then runs each job of
    spec["jobs"] in turn, `pretrain_gpt.run` on the job's argv with a group
    of its own (a `file://` store under OUT; the job's "backend", else nccl
    on the card), its steps probed by
    `WorkloadProbe` (exact launches where the job gives them); with
    "time_reduce" each step's `GradBuckets.all_reduce_mean` in device ms
    (CUDA events around it: the gradient all-reduce and its division by
    W); with "fault" that TP_FAULTS fault planted (`planted`); with
    "gate_at" the job's step of that number first waits for spec["gate"],
    and with "term_after" rank 1 sends itself SIGTERM after that step. It
    writes each job's losses, grad norms, step device ms and host clocks,
    peak memory, launches, the step it stopped at, its wall clock and,
    with "digest", a digest of its final parameters to OUT/rank{r}.json,
    and with "params" rank 0's parameters to OUT/{job}.pt (a sharded
    model's gathered whole at the run's end); each job's state bytes (the
    rank's parameters and optimizer moments)."""
    import hashlib
    from megatron_clip_tpu_torch import pretrain_gpt
    from megatron_clip_tpu_torch.parallel import mesh, sharding
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    from megatron_clip_tpu_torch.training import train_step, workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    out, rank = Path(spec["out"]), int(os.environ.get("RANK", "0"))
    gpt_warm_up()
    wait_for(Path(spec["go"]), DP_GO_TIMEOUT_S, spec["owner"])
    wall = time.time() - time.perf_counter()  # the host clock as wall time
    went = time.perf_counter()
    results = {}
    for job in spec["jobs"]:
        gated, started = {}, time.perf_counter()
        args = pretrain_gpt.parse_args(job["argv"])
        args.dist_url = "file://" + str(out / f"init-{job['name']}")
        args.dist_backend = job.get("backend")  # else nccl on the card
        with WorkloadProbe(workload, mha, ln, job.get("per_step"),
                           job.get("per_eval")) as probe:
            # around the probe's step, so that its clocks leave the gate
            # out
            probed = workload._Runner.step

            def job_step(run, batch, i, job=job, gated=gated):
                if i == job.get("gate_at"):
                    gated["at"] = time.perf_counter()
                    wait_for(Path(spec["gate"]), DP_GO_TIMEOUT_S,
                             spec["owner"])
                    gated["opened"] = time.perf_counter()
                m = probed(run, batch, i)
                if rank == 1 and i == job.get("term_after"):
                    os.kill(os.getpid(), signal.SIGTERM)
                return m
            workload._Runner.step = job_step
            reduce, reduce_ev = train_step.GradBuckets.all_reduce_mean, []

            def timed_reduce(buckets, group, reduce=reduce, evs=reduce_ev):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                reduce(buckets, group)
                ev[1].record()
                evs.append(ev)
            if job.get("time_reduce"):
                train_step.GradBuckets.all_reduce_mean = timed_reduce
            run_wl, whole = pretrain_gpt.run_workload, {}

            def gathered(model, *a, run_wl=run_wl, whole=whole, **kw):
                res = run_wl(model, *a, **kw)
                if getattr(model, "placements", None) is not None:
                    whole.update(sharding.gather_state(
                        {n: p.detach() for n, p in model.named_parameters()},
                        model.placements, mesh.layout()))
                return res
            pretrain_gpt.run_workload = gathered
            try:
                with planted(job.get("fault")):
                    final = pretrain_gpt.run(args)
            finally:
                workload._Runner.step = probed
                train_step.GradBuckets.all_reduce_mean = reduce
                pretrain_gpt.run_workload = run_wl
        torch.cuda.synchronize()
        reduce_ms = [a.elapsed_time(b) for a, b in reduce_ev]
        digest = None
        held = state_bytes(probe.runner.model, probe.runner.opt_state)
        if job.get("digest"):
            params = ({n: p.cpu() for n, p in whole.items()} or {
                n: p.detach().cpu() for n, p in
                probe.runner.model.named_parameters()})
            digest = hashlib.sha256()
            for n, p in params.items():
                digest.update(n.encode())
                digest.update(
                    p.reshape(-1).view(torch.uint8).numpy().tobytes())
            digest = digest.hexdigest()
            if job.get("params") and rank == 0:
                torch.save(params, out / f"{job['name']}.pt")
        probe.runner = None
        torch.cuda.empty_cache()
        results[job["name"]] = {
            "wall": {"go": wall + went, "started": wall + started,
                     "first_step": wall + (probe.steps[0]["host"][0]
                                           if probe.steps else started),
                     "last_step_end": wall + (probe.steps[-1]["host"][1]
                                              if probe.steps else started),
                     "returned": wall + time.perf_counter()},
            "losses": probe.losses(),
            "grad_norms": [s["grad_norm"] for s in probe.steps],
            "device_ms": [s["device_ms"] for s in probe.steps],
            "host": [s["host"] for s in probe.steps],
            "peak_gib": max([s["peak_gib"] for s in probe.steps] or [0.0]),
            "launches": probe.launches, "last_step": final["last_step"],
            "state_bytes": held,
            "digest": digest, "reduce_ms": reduce_ms,
            "gate_wait": gated.get("opened", 0.0) - gated.get("at", 0.0)}
    tmp = out / f"rank{rank}.json.tmp"
    tmp.write_text(json.dumps({
        "rank": rank, "world": int(os.environ.get("WORLD_SIZE", "1")),
        "jobs": results}))
    os.replace(tmp, out / f"rank{rank}.json")  # whole, for `results`
    return 0


def gpt_warm_up() -> None:
    """One step of a tiny GPT on the CPU with selective recompute and the
    fused CE: the process's first selective-recompute backward spends
    seconds of host time setting itself up (about 3 s on a CPU host),
    which a rank then pays while it waits for `go`, not in its first
    step on the card."""
    from megatron_clip_tpu_torch.models.gpt import GPTCfg, GPTModel, gpt_loss
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = GPTModel(GPTCfg(num_layers=1, hidden_size=64, num_heads=4,
                                vocab_size=128, seq_length=16,
                                position_embedding="rope", swiglu=True,
                                normalization="rmsnorm"))
        gpt_loss(model, torch.zeros(1, 17, dtype=torch.long),
                 remat="selective", fused_ce=True).backward()
    finally:
        torch.set_num_threads(threads)


def doc_per_step(cfg, fused_ce: bool, remat: str, microbatches: int) -> dict:
    """Kernel launches of a GPT trainer step with --reset-attention-mask:
    a step's (`gpt_trainer_per_step`) without the flash kernels, as the
    document mask sends every layer's attention to `sdpa_bshd` (plain
    PyTorch, the JAX package's jnp)."""
    one = gpt_trainer_per_step(cfg, cfg.seq_length, fused_ce, remat,
                               microbatches)
    return {k: 0 if k.startswith("flash_") else v for k, v in one.items()}


class GptDataParallelLaunches(DataParallelLaunches):
    """Phase 16's torchrun launches, made before phase 2 and waiting for
    `go`: (a) one NCCL rank of `pretrain_gpt` on GPT_DIST with phase 15's
    corpus (gated: its second step waits for `gate`); (b) DP_RANKS gloo
    ranks on the one card running GPT_DP_PARITY_JOBS in turn (plain, the
    document flags, the same cut by SIGTERM on rank 1 with --save, and
    resumed)."""

    root, worker_flag = GPT_DP_DIR, "--gpt-dp-worker"

    def __init__(self):
        shutil.rmtree(self.root, ignore_errors=True)
        self.corpus_dir = self.root / "corpus"
        self.corpus_dir.mkdir(parents=True)
        self.go, self.gate = self.root / "go", self.root / "gate"
        self.procs, self.dirs = {}, {"one rank": self.root / "a",
                                     "parity": self.root / "b"}
        from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                          parse_args)
        corpus = str(self.corpus_dir / "corpus")
        one = GPT_DIST + GPT_DIST_WARMUP + [
            "--micro-batch-size", str(GPT_DIST_MICRO), "--data-path", corpus,
            "--train-steps", str(GPT_DP_STEPS), "--log-interval", "1"]
        cfg = gpt_cfg_from_args(parse_args(one))
        self.one_rank_per_step = gpt_trainer_per_step(
            cfg, cfg.seq_length, True, "selective",
            GPT_DIST_BATCH // GPT_DIST_MICRO)
        # its first step (the process's cold one) runs beside (b); the
        # timed steps wait for the gate
        self.launch_jobs("one rank", 1, [{
            "name": "a", "argv": one, "gate_at": 2, "time_reduce": True,
            "per_step": self.one_rank_per_step}])
        save = ["--save", str(self.root / "ckpt")]
        self.parity = {
            "plain": GPT_DP_PARITY + ["--data-path", corpus],
            "doc": GPT_DP_PARITY + GPT_DOC_FLAGS + ["--data-path", corpus]}
        # NCCL takes one rank a card: two ranks on the one card over gloo
        on_card = ["--device", "cuda:0"]
        self.launch_jobs("parity", DP_RANKS, [
            {"name": "plain", "argv": self.parity["plain"] + on_card,
             "params": True, "digest": True, "backend": "gloo"},
            {"name": "doc", "argv": self.parity["doc"] + on_card,
             "params": True, "digest": True, "backend": "gloo"},
            {"name": "cut", "argv": self.parity["doc"] + on_card + save,
             "term_after": GPT_DP_TERM_AFTER, "backend": "gloo"},
            {"name": "resumed", "digest": True, "backend": "gloo",
             "argv": self.parity["doc"] + on_card + save + ["--resume"]}])
        atexit.register(self.stop)

    def results(self, name: str, ranks: int, timeout: float) -> list:
        """Each rank's JSON as soon as every rank has written it, without
        waiting for torchrun to exit (`finish` checks that it exited 0);
        a launch that ends first, or outlasts `timeout`, raises as `wait`
        does."""
        proc, work = self.procs[name], self.dirs[name]
        paths = [work / f"rank{r}.json" for r in range(ranks)]
        t0 = time.perf_counter()
        while not all(p.exists() for p in paths):
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > timeout:
                return self.wait(name, ranks, timeout=1)
            time.sleep(0.05)
        return [json.loads(p.read_text()) for p in paths]

    def finish(self, timeout: float) -> None:
        """Every launch exited 0 (killed and raising past `timeout`)."""
        for name, proc in self.procs.items():
            self.wait(name, 0, timeout=timeout)

    def launch_jobs(self, name: str, ranks: int, jobs: list) -> None:
        work = self.dirs[name]
        work.mkdir()
        spec = work / "spec.json"
        spec.write_text(json.dumps({
            "jobs": jobs, "out": str(work), "go": str(self.go),
            "gate": str(self.gate), "owner": os.getpid()}))
        self.start(name, ranks, spec)


def gpt_dp_one_rank(launches: GptDataParallelLaunches, dist: dict) -> dict:
    """(a), its gate opened: one NCCL rank's tokens/s over steps 2 on (host
    clock from the first timed step's start to the last's end) and its step
    device ms, beside phase 15 (a)'s in this call, and the device ms of
    the step's gradient all-reduce and division in the rank (what W = 1
    adds to phase 15's step on the device, but a scalar all-reduce of the
    loss); the step's launches exact (held in the rank)."""
    launches.gate.touch()
    opened = time.time()
    got = launches.results("one rank", 1, timeout=120)[0]["jobs"]["a"]
    w = got["wall"]
    # from `go` to the first step (the model built, the data placed), the
    # gate's wait (after the first step), from the gate to the last step's
    # end, and the run after it (torchrun's exit is waited for at the
    # phase's end)
    wall_s = {"to_first_step": w["first_step"] - w["go"],
              "gate_wait": got["gate_wait"],
              "gate_to_last_step_end": w["last_step_end"] - opened,
              "after_steps": w["returned"] - w["last_step_end"]}
    losses = got["losses"]
    if len(losses) != GPT_DP_STEPS or \
            not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"GPT data parallel (a): losses {losses}")
    timed = list(range(1, GPT_DP_STEPS))
    span = got["host"][timed[-1]][1] - got["host"][timed[0]][0]
    tokens = GPT_DIST_BATCH * 2048 * len(timed)
    device = [got["device_ms"][i] for i in timed]
    if len(got["reduce_ms"]) != GPT_DP_STEPS:
        raise AssertionError("GPT data parallel (a): all-reduces timed "
                             f"{got['reduce_ms']}, one a step expected")
    reduce = [got["reduce_ms"][i] for i in timed]
    res = {"tokens_per_s": tokens / span,
           "phase15_tokens_per_s": dist["tokens_per_s"],
           "step_device_ms": device,
           "step_device_ms_median": float(np.median(device)),
           "phase15_step_device_ms_median": dist["step_device_ms_median"],
           "device_ms_ratio": float(np.median(device))
           / dist["step_device_ms_median"],
           "all_reduce_mean_ms": reduce,
           "all_reduce_mean_ms_median": float(np.median(reduce)),
           "losses": losses, "phase15_losses": dist["losses"],
           "peak_memory_gib": got["peak_gib"], "wall_s": wall_s,
           "per_step_launches": launches.one_rank_per_step,
           "launches": got["launches"]}
    log(f"  (a) one NCCL rank of pretrain_gpt_dist.sh's model, batch "
        f"{GPT_DIST_BATCH} in microbatches of {GPT_DIST_MICRO}: "
        f"{res['tokens_per_s']:.0f} tokens/s against phase 15's "
        f"{dist['tokens_per_s']:.0f}; step device ms median "
        f"{res['step_device_ms_median']:.1f} against "
        f"{dist['step_device_ms_median']:.1f} (ratio "
        f"{res['device_ms_ratio']:.4f}), of which the gradient "
        f"all-reduce and division {res['all_reduce_mean_ms_median']:.3f} "
        f"ms (CUDA events, steps 2 on: {reduce}); losses {losses} (phase 15: "
        f"{dist['losses']}); wall s {json.dumps(wall_s)}")
    return res


def gpt_dp_references(launches: GptDataParallelLaunches, main, workload,
                      mha, ln) -> dict:
    """(b)'s one-process runs on the card while the ranks run: each
    name's (parameters, losses) and seconds."""
    one = {}
    for name in ("plain", "doc"):
        t0 = time.perf_counter()
        with WorkloadProbe(workload, mha, ln, None) as probe:
            main(launches.parity[name] + ["--device", "cuda"])
        one[name] = ({n: p.detach().cpu() for n, p in
                      probe.runner.model.named_parameters()}, probe.losses(),
                     time.perf_counter() - t0)
        probe.runner = None
        torch.cuda.empty_cache()
    return one


def gpt_dp_parity(launches: GptDataParallelLaunches, one: dict) -> dict:
    """(b): while the ranks run, this process takes the plain and the
    document-flag runs in one process on the card: each step's loss
    within DP_LOSS_RTOL relative, each parameter within DP_PARAM_RTOL of
    its norm, the ranks' parameters bit-equal. Then the run cut by SIGTERM
    on rank 1: both ranks stopped at GPT_DP_TERM_AFTER, and the resumed
    run's losses and final parameters those of the run left whole, bit for
    bit (the document mask's attention is plain PyTorch; RMSNorm's kernels
    and the chunked loss add in a fixed order). `one`:
    `gpt_dp_references`'."""
    result = {f"{name}_one_process_s": s for name, (_, _, s) in one.items()}
    ranks = launches.results("parity", DP_RANKS, timeout=120)
    jobs = [r["jobs"] for r in ranks]
    bad = []
    for name in ("plain", "doc"):
        params, want, _ = one[name]
        got = torch.load(launches.dirs["parity"] / f"{name}.pt")
        rel = {n: float((got[n] - p).norm() / p.norm().clamp_min(1e-30))
               for n, p in params.items()}
        worst = max(rel, key=rel.get)
        loss_err = max(abs(g - w) / abs(w) for j in jobs
                       for g, w in zip(j[name]["losses"], want))
        res = {"losses_one_process": want,
               "losses_ranks": [j[name]["losses"] for j in jobs],
               "loss_max_rel_err": loss_err, "param_worst_leaf": worst,
               "param_worst_rel_err": rel[worst],
               "ranks_bit_equal": len({j[name]["digest"]
                                       for j in jobs}) == 1}
        result[name] = res
        if any(len(j[name]["losses"]) != GPT_DP_PARITY_STEPS for j in jobs) \
                or loss_err > DP_LOSS_RTOL or rel[worst] > DP_PARAM_RTOL \
                or not res["ranks_bit_equal"]:
            bad.append(name)
    whole, cut, resumed = (jobs[0][k] for k in ("doc", "cut", "resumed"))
    res = {"cut_last_steps": [j["cut"]["last_step"] for j in jobs],
           "resumed_last_steps": [j["resumed"]["last_step"] for j in jobs],
           "cut_losses": cut["losses"], "resumed_losses": resumed["losses"],
           "whole_losses": whole["losses"],
           "resumed_bit_equal": resumed["losses"]
           == whole["losses"][GPT_DP_TERM_AFTER:] and all(
               j["resumed"]["digest"] == j["doc"]["digest"] for j in jobs)}
    result["sigterm_resume"] = res
    if res["cut_last_steps"] != [GPT_DP_TERM_AFTER] * DP_RANKS or \
            res["resumed_last_steps"] != [GPT_DP_PARITY_STEPS] * DP_RANKS \
            or not res["resumed_bit_equal"]:
        bad.append("sigterm_resume")
    log(f"  (b) {DP_RANKS} ranks over gloo on the card against one process: "
        f"{json.dumps(result)}")
    if bad:
        raise AssertionError(f"GPT data parallel (b): {bad} disagree")
    return result


def gpt_doc_attention_ms(qkv_shape, bias) -> dict:
    """The unfused route's device ms a layer (forward and backward of
    `attention_heads(route="sdpa")` with the document bias) beside the
    flash route's at the same shape, bf16, CUDA events, the median of
    three after one warm-up."""
    from megatron_clip_tpu_torch.ops.attention import attention_heads
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(qkv_shape, generator=g, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    do = torch.randn(qkv_shape[:2] + (qkv_shape[2] // 3,), generator=g,
                     device="cuda", dtype=torch.bfloat16)
    out = {}
    for route, b in (("sdpa", bias), ("flash", None)):
        times = []
        for _ in range(4):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            y = attention_heads(qkv, 16, route, causal=True, bias=b)
            torch.autograd.grad(y, qkv, do)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        out[f"{route}_fwd_bwd_ms"] = float(np.median(times[1:]))
    torch.cuda.empty_cache()
    return out


def gpt_doc_flags(main, workload, mha, ln, corpus: str) -> dict:
    """(c): the document flags on pretrain_gpt_dist.sh's model at full
    width and depth on one card, GPT_DOC_BATCH in microbatches of
    GPT_DOC_MICRO, GPT_DOC_STEPS steps: exact launches (no flash kernel:
    the document mask takes sdpa_bshd), the loss falling, the peak memory;
    the unfused route's device ms a layer. (Its fp32 run card against CPU
    runs while (b)'s ranks do, `phase_gpt_data_parallel`.)"""
    from megatron_clip_tpu_torch.models.gpt import (
        get_ltor_masks_and_position_ids)
    from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                      parse_args)
    argv = GPT_DIST + GPT_DIST_WARMUP + GPT_DOC_FLAGS + [
        "--batch-size", str(GPT_DOC_BATCH), "--micro-batch-size",
        str(GPT_DOC_MICRO), "--data-path", corpus, "--train-steps",
        str(GPT_DOC_STEPS), "--log-interval", "1"]
    cfg = gpt_cfg_from_args(parse_args(argv))
    per_step = doc_per_step(cfg, True, "selective",
                            GPT_DOC_BATCH // GPT_DOC_MICRO)
    with WorkloadProbe(workload, mha, ln, per_step) as probe:
        main(argv)
    probe.runner = None
    torch.cuda.empty_cache()
    losses = probe.losses()
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"GPT document flags (c): losses {losses}")
    from megatron_clip_tpu_torch.data.gpt_dataset import gpt_batch_iterator
    tokens = torch.from_numpy(next(gpt_batch_iterator(
        corpus, GPT_DOC_MICRO, cfg.seq_length, split="969,30,1"))[:, :-1])
    bias, _, _ = get_ltor_masks_and_position_ids(
        tokens.cuda().long(), CLIP_EOD, reset_attention_mask=True)
    docs = float((tokens == CLIP_EOD).sum(1).float().mean())
    attn_ms = gpt_doc_attention_ms(
        (GPT_DOC_MICRO, cfg.seq_length, 3 * cfg.hidden_size), bias)
    del bias
    res = {"batch": GPT_DOC_BATCH, "micro": GPT_DOC_MICRO,
           "losses": losses, "step_device_ms": [s["device_ms"]
                                                for s in probe.steps],
           "peak_memory_gib": max(s["peak_gib"] for s in probe.steps),
           "eods_per_row": docs, **attn_ms,
           "per_step_launches": per_step, "launches": probe.launches}
    log(f"  (c) the document flags on pretrain_gpt_dist.sh's model, batch "
        f"{GPT_DOC_BATCH} in microbatches of {GPT_DOC_MICRO}: losses "
        f"{losses}, step device ms {res['step_device_ms']}, peak "
        f"{res['peak_memory_gib']:.2f} GiB; a layer's attention forward and "
        f"backward {attn_ms['sdpa_fwd_bwd_ms']:.2f} ms unfused with the "
        f"document mask against {attn_ms['flash_fwd_bwd_ms']:.2f} ms flash "
        f"({docs:.1f} EODs a row)")
    return res


def phase_gpt_data_parallel(launches: GptDataParallelLaunches, mha, ln,
                            card: str, gpt_trainer: dict) -> dict:
    log(f"[16] GPT trainer data parallel and document flags: (a) one NCCL "
        f"rank of pretrain_gpt_dist.sh's model, {GPT_DP_STEPS} steps; (b) "
        f"{DP_RANKS} ranks on the card over gloo, fp32, 2 layers at full "
        f"width, plain and with the document flags, against one process, "
        f"and a SIGTERM on rank 1 with a resume; (c) the document flags at "
        f"full width, and fp32 card vs CPU")
    t0 = time.perf_counter()
    from megatron_clip_tpu_torch.pretrain_gpt import main
    from megatron_clip_tpu_torch.training import workload
    result = {"card": card}
    corpus = str(launches.corpus_dir / "corpus")
    launches.go.touch()

    def timed(name: str, part):
        t_part = time.perf_counter()
        result[name] = part()
        result[name]["seconds"] = time.perf_counter() - t_part
        log(f"  {name}: {result[name]['seconds']:.1f} s")
    try:
        # (b)'s ranks start at `go`; this process takes (b)'s references
        # and (c)'s card-against-CPU run while they step
        one = gpt_dp_references(launches, main, workload, mha, ln)
        # half the host's cores: the ranks beside it need the others
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 2))
        try:
            timed("doc_flags_card_vs_cpu", lambda: gpt_trainer_parity(
                main, workload, mha, ln, corpus, extra=GPT_DOC_PARITY,
                param_rtol=GPT_DOC_PARAM_RTOL))
        finally:
            torch.set_num_threads(threads)
        timed("gloo_two_ranks", lambda: gpt_dp_parity(launches, one))
        timed("nccl_one_rank", lambda: gpt_dp_one_rank(
            launches, gpt_trainer["dist"]))
        timed("doc_flags", lambda: gpt_doc_flags(main, workload, mha, ln,
                                                 corpus))
        launches.finish(timeout=60)
    finally:
        launches.stop()
    result["seconds"] = time.perf_counter() - t0
    log(f"  GPT data parallel ({card}): {json.dumps(result)}")
    if result["seconds"] > GPT_DP_LIMIT_S:
        raise AssertionError(
            f"phase 16 took {result['seconds']:.1f} s, over "
            f"{GPT_DP_LIMIT_S} s: " + phase_parts(result))
    return result


class ShardedLaunches(GptDataParallelLaunches):
    """Phase 17's torchrun launches, made before phase 2 and waiting for
    `go`: (a) TP_RANKS gloo ranks on the card running the GPT jobs
    (`gpt_dp_worker`: TP_GPT, and with attention dropout), (b)
    CLIP_FSDP_RANKS gloo ranks of `pretrain_clip` at fsdp 2 (`dp_worker`),
    its first step gated until (a) has ended. With `faults`, (a) also runs
    TP_FAULTS's jobs and (b) is not launched."""

    root = TP_DIR

    def __init__(self, faults: bool = False):
        shutil.rmtree(self.root, ignore_errors=True)
        self.root.mkdir(parents=True)
        self.go, self.gate = self.root / "go", self.root / "gate"
        self.procs = {}
        self.dirs = {"gpt": self.root / "a", "clip": self.root / "b"}
        on_card = ["--device", "cuda:0"]
        self.gpt = {"bf16": TP_GPT, "bf16 dropout": TP_GPT + [
            "--attention-dropout", "0.1", "--train-steps", "1"]}
        from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                          parse_args)
        cfg = gpt_cfg_from_args(parse_args(TP_GPT))
        # a rank runs one process's kernels, each at its shapes
        self.per_step = gpt_trainer_per_step(cfg, cfg.seq_length, True,
                                             "selective",
                                             TP_BATCH // TP_MICRO)
        self.worker_flag = "--gpt-dp-worker"
        self.faults = TP_FAULTS if faults else {}
        self.launch_jobs("gpt", TP_RANKS, [
            {"name": name, "argv": argv + on_card, "params": True,
             "digest": True, "backend": "gloo",
             "per_step": self.per_step if name == "bf16" else None}
            for name, argv in self.gpt.items()] + [
            {"name": name, "argv": self.gpt[job] + on_card, "params": True,
             "digest": True, "backend": "gloo", "fault": name}
            for name, (job, _) in self.faults.items()])
        atexit.register(self.stop)
        if faults:
            return
        self.worker_flag = "--dp-worker"
        self.launch("clip", CLIP_FSDP + ["--fsdp-parallel-size", "2",
                                         "--device", "cuda:0",
                                         "--dist-backend", "gloo"],
                    CLIP_FSDP_RANKS, launches=False, params="all",
                    gate=self.gate)


def one_process_argv(argv: list) -> list:
    """`argv` without the layout's flags (GPT_DIST_DROPPED)."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] in ("--tensor-model-parallel-size",
                       "--fsdp-parallel-size"):
            i += 2
            continue
        if argv[i] != "--sequence-parallel":
            out.append(argv[i])
        i += 1
    return out


def tp_references(launches: ShardedLaunches, main, workload, mha,
                  ln) -> dict:
    """(a)'s one-process runs on the card, while the ranks run: each job's
    initial and final parameters (on the host), losses, grad norms,
    launches, state bytes and peak memory."""
    from megatron_clip_tpu_torch.models.gpt import create_gpt
    from megatron_clip_tpu_torch.pretrain_gpt import (
        gpt_cfg_from_args, parse_args, precision_from_args)
    one = {}
    for name, argv in launches.gpt.items():
        argv = one_process_argv(argv)
        args = parse_args(argv)
        start = create_gpt(gpt_cfg_from_args(args), device="cpu",
                           precision=precision_from_args(args),
                           seed=args.seed)
        with WorkloadProbe(workload, mha, ln, None) as probe:
            main(argv + ["--device", "cuda"])
        one[name] = {
            "start": {n: p.detach().float() for n, p in
                      start.named_parameters()},
            "params": {n: p.detach().float().cpu() for n, p in
                       probe.runner.model.named_parameters()},
            "losses": probe.losses(),
            "grad_norms": [s["grad_norm"] for s in probe.steps],
            "launches": probe.launches,
            "peak_gib": max(s["peak_gib"] for s in probe.steps),
            "state_bytes": state_bytes(probe.runner.model,
                                       probe.runner.opt_state)}
        probe.runner = None
        torch.cuda.empty_cache()
    return one


def tp_readings(launches: ShardedLaunches, jobs: list, name: str,
                want: dict) -> dict:
    """Job `name` of (a)'s ranks (`jobs`, each rank's) against one
    process's run `want`."""
    got = torch.load(launches.dirs["gpt"] / f"{name}.pt")
    start, params = want["start"], want["params"]
    moved = sum(float((params[n] - start[n]).norm()) ** 2
                for n in params) ** 0.5
    off = sum(float((got[n].float() - params[n]).norm()) ** 2
              for n in params) ** 0.5
    worst = max(params, key=lambda n: float(
        (got[n].float() - params[n]).norm() / params[n].norm()))
    # elements the steps moved another way: more than the learning rate
    # apart (at Adam's first steps every element moves by about lr whatever
    # its gradient's size, so one whose gradient sits at bf16 rounding level
    # may move either way)
    argv = launches.gpt["bf16"]
    lr = float(argv[argv.index("--lr") + 1])
    far = sum(int(((got[n].float() - p).abs() > lr).sum())
              for n, p in params.items()) / sum(
        p.numel() for p in params.values())
    loss_err = max(abs(g - w) / abs(w) for j in jobs
                   for g, w in zip(j[name]["losses"], want["losses"]))
    norm_err = max(abs(g - w) / abs(w) for j in jobs
                   for g, w in zip(j[name]["grad_norms"],
                                   want["grad_norms"]))
    held = [j[name]["state_bytes"] for j in jobs]
    one_bytes = want["state_bytes"]
    share = max(max(h["params"] / one_bytes["params"],
                    h["moments"] / one_bytes["moments"]) for h in held)
    return {"losses_one_process": want["losses"],
            "losses_ranks": [j[name]["losses"] for j in jobs],
            "loss_max_rel_err": loss_err,
            "grad_norms_one_process": want["grad_norms"],
            "grad_norms_ranks": [j[name]["grad_norms"] for j in jobs],
            "grad_norm_max_rel_err": norm_err,
            "param_err_over_moved": off / moved,
            "param_worst_leaf": worst, "param_share_lr_apart": far,
            "ranks_bit_equal": len({j[name]["digest"] for j in jobs}) == 1,
            "steps_as_one_process": all(
                len(j[name]["losses"]) == len(want["losses"])
                for j in jobs),
            "state_bytes_one_process": one_bytes,
            "state_bytes_ranks": held, "state_share": share,
            "peak_gib_one_process": want["peak_gib"],
            "peak_gib_ranks": [j[name]["peak_gib"] for j in jobs],
            "step_device_ms_ranks": [j[name]["device_ms"] for j in jobs],
            "launches_one_process": want["launches"],
            "launches_ranks": [j[name]["launches"] for j in jobs]}


def tp_broken(res: dict) -> list:
    """The bounds of (a) that the readings `res` break."""
    return [bound for bound, broken in (
        ("steps", not res["steps_as_one_process"]),
        ("TP_LOSS_RTOL", res["loss_max_rel_err"] > TP_LOSS_RTOL),
        ("TP_NORM_RTOL", res["grad_norm_max_rel_err"] > TP_NORM_RTOL),
        ("TP_FAR_SHARE", res["param_share_lr_apart"] > TP_FAR_SHARE),
        ("ranks bit-equal", not res["ranks_bit_equal"]),
        ("TP_STATE_SHARE", res["state_share"] > TP_STATE_SHARE)) if broken]


def tp_parity(launches: ShardedLaunches, one: dict) -> dict:
    """(a): each job's ranks against its one process (see TP_RANKS's
    note); each planted fault's (`launches.faults`) against the one
    process of the job it spoils, with the bounds it breaks."""
    ranks = launches.results("gpt", TP_RANKS, timeout=120)
    jobs = [r["jobs"] for r in ranks]
    result, bad = {}, []
    for name, want in one.items():
        result[name] = tp_readings(launches, jobs, name, want)
        if tp_broken(result[name]):
            bad.append(name)
    for name, (job, what) in launches.faults.items():
        res = tp_readings(launches, jobs, name, one[job])
        result[name] = dict(res, fault=what, breaks=tp_broken(res))
    # every kernel of the path launched in the ranks, as in one process
    kernels = ("flash_fwd", "flash_bwd_fused", "rms_norm_fwd",
               "rms_norm_bwd", "fused_ce_fwd", "fused_ce_bwd")
    idle = [k for k in kernels for j in jobs
            if j["bf16"]["launches"][k] == 0]
    if idle:
        bad.append(f"idle kernels {sorted(set(idle))}")
    log(f"  (a) {TP_RANKS} ranks at tp2 x fsdp2 with sequence parallelism "
        f"on the card over gloo against one process: "
        f"{json.dumps(result)}")
    if bad:
        raise AssertionError(f"tensor parallel (a): {bad} disagree")
    return result


def clip_fsdp_reference(launches: ShardedLaunches, mha, ln) -> dict:
    """(b)'s one-process run on the card: its losses, final parameters
    (host), state bytes and peak memory."""
    from megatron_clip_tpu_torch.pretrain_clip import main as train_main
    from megatron_clip_tpu_torch.training import loop
    runners = []
    step = loop._JointRunner.step

    def kept(run, images, texts):
        runners[:] = [run]
        return step(run, images, texts)
    loop._JointRunner.step = kept
    torch.cuda.reset_peak_memory_stats()
    try:
        with ModelProbe(loop) as built, \
                TrainerProbe(loop, mha, ln, None) as probe:
            train_main(CLIP_FSDP + ["--device", "cuda"])
    finally:
        loop._JointRunner.step = step
    out = {"losses": probe.loss_values(),
           "params": {n: p.detach().cpu() for n, p in
                      built.model.named_parameters()},
           "state_bytes": state_bytes(built.model,
                                      runners[0].state.opt_state),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": probe.launches}
    runners.clear()
    built.model = None
    torch.cuda.empty_cache()
    return out


def clip_fsdp_parity(launches: ShardedLaunches, one: dict) -> dict:
    """(b): the two ranks against one process: losses within DP_LOSS_RTOL,
    each rank's shards within DP_PARAM_RTOL of the one process's split
    (relative to the leaf's norm), each rank's bytes at most
    CLIP_FSDP_SHARE of one process's."""
    from megatron_clip_tpu_torch import factory
    from megatron_clip_tpu_torch.parallel import sharding
    from megatron_clip_tpu_torch.parallel.mesh import Layout
    ranks = launches.wait("clip", CLIP_FSDP_RANKS, timeout=120)
    model = factory.create_model("ViT-B-16", precision="fp32", device="cpu")
    pls = sharding.placements(model, sharding.clip_param_specs(
        dict(model.named_parameters())), Layout(fsdp=2))
    del model
    worst, loss_err = 0.0, 0.0
    for r, got in enumerate(ranks):
        shards = torch.load(launches.dirs["clip"] / f"params{r}.pt")
        for n, p in one["params"].items():
            want = sharding.split_tensor(p, pls[n], Layout(fsdp=2, f=r))
            worst = max(worst, float((shards[n] - want).norm()
                                     / want.norm().clamp_min(1e-30)))
        loss_err = max([loss_err] + [abs(g - w) / abs(w) for g, w in
                                     zip(got["losses"], one["losses"])])
    share = max(max(r["state_bytes"]["params"]
                    / one["state_bytes"]["params"],
                    r["state_bytes"]["moments"]
                    / one["state_bytes"]["moments"]) for r in ranks)
    res = {"losses_one_process": one["losses"],
           "losses_ranks": [r["losses"] for r in ranks],
           "loss_max_rel_err": loss_err, "param_max_rel_err": worst,
           "state_bytes_one_process": one["state_bytes"],
           "state_bytes_ranks": [r["state_bytes"] for r in ranks],
           "state_share": share, "peak_gib_one_process": one["peak_gib"],
           "peak_gib_ranks": [r["peak_gib"] for r in ranks],
           "launches_one_process": one["launches"],
           "launches_ranks": [r["launches"] for r in ranks]}
    log(f"  (b) {CLIP_FSDP_RANKS} ranks of pretrain_clip at "
        f"--fsdp-parallel-size 2 on ViT-B-16 against one process: "
        f"{json.dumps(res)}")
    if any(len(r["losses"]) != CLIP_FSDP_STEPS for r in ranks) \
            or loss_err > DP_LOSS_RTOL or worst > DP_PARAM_RTOL \
            or share > CLIP_FSDP_SHARE:
        raise AssertionError("FSDP CLIP (b) disagrees")
    return res


def phase_sharded(launches: ShardedLaunches, mha, ln, card: str) -> dict:
    log(f"[17] tensor parallelism and FSDP: (a) {TP_RANKS} ranks on the "
        f"card over gloo at tp2 x fsdp2 with sequence parallelism, "
        f"pretrain_gpt_dist.sh's model at full width, {TP_LAYERS} layers, "
        f"plain and with attention dropout, against one process; "
        f"(b) {CLIP_FSDP_RANKS} ranks of pretrain_clip at fsdp 2 on "
        f"ViT-B-16 against one process")
    t0 = time.perf_counter()
    from megatron_clip_tpu_torch.pretrain_gpt import main
    from megatron_clip_tpu_torch.training import workload
    result = {"card": card}
    launches.go.touch()

    def timed(name: str, part):
        t_part = time.perf_counter()
        result[name] = part()
        result[name]["seconds"] = time.perf_counter() - t_part
        log(f"  {name}: {result[name]['seconds']:.1f} s")
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads // 2))
        try:
            one = tp_references(launches, main, workload, mha, ln)
        finally:
            torch.set_num_threads(threads)
        timed("gpt_tp2_fsdp2_sp", lambda: tp_parity(launches, one))
        launches.gate.touch()
        clip_one = clip_fsdp_reference(launches, mha, ln)
        timed("clip_fsdp2", lambda: clip_fsdp_parity(launches, clip_one))
        launches.finish(timeout=60)
    finally:
        launches.stop()
    result["seconds"] = time.perf_counter() - t0
    log(f"  tensor parallelism and FSDP ({card}): {json.dumps(result)}")
    if result["seconds"] > TP_LIMIT_S:
        raise AssertionError(
            f"phase 17 took {result['seconds']:.1f} s, over "
            f"{TP_LIMIT_S} s: " + phase_parts(result))
    return result


def serving_model(argv: list):
    """The GPT of the server flags `argv` on the CPU, weights from seed 0
    (`create_gpt`, fp32), with the vocabulary's padding rows past the CLIP
    BPE's 49408 ids held to a low logit: each row at GEN_PAD_ROW and the
    final LayerNorm's bias at 1 give them (h0 + 1) . row = GEN_PAD_ROW *
    W under LayerNorm (h0 sums to 0), -20.48 at W = 1024, as a trained
    model leaves the ids it never saw. The tokenizer has no text for them,
    and the server answers 400 when one is decoded (as the JAX server
    does), so random rows would end a sampled request at random."""
    from megatron_clip_tpu_torch.models.gpt import create_gpt
    from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                      parse_args)
    cfg = gpt_cfg_from_args(parse_args(argv))
    model = create_gpt(cfg, "fp32", device="cpu", seed=0)
    with torch.no_grad():
        model.tok_embed[CLIP_BPE_VOCAB:] = GEN_PAD_ROW
        model.ln_f["bias"].fill_(1.0)
    return model.eval()


def gpt_serve_worker(spec_path: str) -> int:
    """One server of phase 18 (`chip_smoke.py --gpt-serve-worker SPEC`, a
    process of its own, or each rank of a torchrun launch). It waits for
    spec["go"], then builds the service as the server tool does
    (`run_text_generation_server.build` on spec["argv"]; a launch's group
    through a `file://` store under OUT) and, on rank 0, serves it on a
    free port of 127.0.0.1, written to OUT/ready.json with the build's
    seconds. Its handler is the server's, plus GET /_probe, which returns
    (and clears) a record of each generation since the last probe: its
    inputs and options, its outputs, its host seconds (to the outputs on
    the host), its kernel launches (zeroed just before, read just after)
    and its peak memory, and GET /_stop, which releases the other ranks
    and ends the process. The other ranks follow rank 0."""
    import threading
    from http.server import ThreadingHTTPServer
    from megatron_clip_tpu_torch.inference import server as srv
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    from megatron_clip_tpu_torch.parallel import mesh
    from megatron_clip_tpu_torch.tools import run_text_generation_server \
        as tool
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    wait_for(Path(spec["go"]), GEN_GO_TIMEOUT_S, spec["owner"])
    t0 = time.perf_counter()
    parse = tool.parse_args

    def with_store(argv):
        args = parse(argv)
        args.dist_url = "file://" + str(out / "init")
        return args
    tool.parse_args = with_store
    service, _ = tool.build(spec["argv"])
    ready_s = time.perf_counter() - t0
    if not service.leader:
        try:
            service.follow()
        finally:
            mesh.destroy()
        return 0
    records, stop = [], threading.Event()

    def probed(fn, kind):
        def call(model, *args, **kw):
            zero_counts(mha, ln)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = fn(model, *args, **kw)
            host = [r.cpu() for r in res]
            seconds = time.perf_counter() - t
            records.append({
                "kind": kind, "seconds": seconds,
                "inputs": [a.tolist() for a in args],
                "options": {k: v for k, v in kw.items()
                            if k != "compute_dtype"},
                "out": [r.tolist() for r in host],
                "launches": read_counts(mha, ln),
                "peak_bytes": torch.cuda.max_memory_allocated()})
            return res
        return call
    srv.generate = probed(srv.generate, "generate")
    srv.beam_search = probed(srv.beam_search, "beam")

    class Probed(srv.make_handler(service)):
        def do_GET(self):
            if self.path == "/_probe":
                body = json.dumps(records).encode()
                records.clear()
                self._send(200, body, "application/json")
            elif self.path == "/_stop":
                self._send(200, b"{}", "application/json")
                stop.set()
            else:
                super().do_GET()
    server = ThreadingHTTPServer(("127.0.0.1", 0), Probed)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    model = service.model
    (out / "ready.json").write_text(json.dumps({
        "port": server.server_address[1], "ready_s": ready_s,
        "params": sum(p.numel() for p in model.parameters()),
        "model_bytes": torch.cuda.memory_allocated()}))
    try:
        while not stop.wait(1.0):
            if not process_alive(spec["owner"]):
                break
    finally:
        server.shutdown()
        service.stop()
        mesh.destroy()
    return 0


class ServingLaunches:
    """Phase 18's servers, made before phase 2: the checkpoints of (a)'s
    GPT-345m and (c)'s 2-layer fp32 model (`serving_model`, in the
    trainer's tree), and the servers of (a) (one process) and (d)
    (GEN_TP_RANKS gloo ranks on the one card, torchrun), each
    `gpt_serve_worker`, waiting for `go`; (b)'s server, on phase 15 (a)'s
    checkpoint, starts after phase 15 (`start_example`). `stop` ends any
    still running; it runs at exit too."""

    root = GEN_DIR
    worker = [str(Path(__file__).resolve()), "--gpt-serve-worker"]

    def __init__(self):
        from megatron_clip_tpu_torch.checkpoints.io import save_checkpoint
        shutil.rmtree(self.root, ignore_errors=True)
        self.root.mkdir(parents=True)
        self.go = self.root / "go"
        self.example_ckpt = self.root / "example_ckpt"
        self.procs, self.dirs, self.released = {}, {}, []
        self.models = {}
        for name, argv in (("gpt345m", GEN_345M), ("fp32", GEN_FP32)):
            self.models[name] = serving_model(argv)
            save_checkpoint(str(self.root / f"{name}_ckpt"), 0,
                            {"params": self.models[name].state_dict()})
        atexit.register(self.stop)
        self.launch("gpt345m", GEN_345M + ["--load", str(
            self.root / "gpt345m_ckpt")], 1)
        self.launch("tp2", GEN_FP32 + [
            "--load", str(self.root / "fp32_ckpt"),
            "--tensor-model-parallel-size", str(GEN_TP_RANKS),
            *GEN_TP_PLACE], GEN_TP_RANKS)

    def launch(self, name: str, argv: list, ranks: int) -> None:
        work = self.dirs[name] = self.root / name
        work.mkdir()
        spec = work / "spec.json"
        spec.write_text(json.dumps({
            "argv": argv + ["--port", "0"], "out": str(work),
            "go": str(self.go), "owner": os.getpid()}))
        me = self.worker + [str(spec)]
        cmd = ([sys.executable] + me if ranks == 1 else
               [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(ranks)] + me)
        with open(work / "log.txt", "w") as log_file:
            self.procs[name] = subprocess.Popen(
                cmd, cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT,
                start_new_session=True)

    def start_example(self) -> None:
        """(b)'s server, on the checkpoint phase 15 (a) left: its params,
        the vocabulary's padding rows past the CLIP BPE's ids set to 0
        (three steps on a corpus that never holds them leave them among a
        near-uniform distribution's top 40, and the tokenizer has no text
        for them: the server answers 400, as the JAX one does), written as
        a params-only checkpoint of the same step (`example_params` keeps
        them for the phase)."""
        from megatron_clip_tpu_torch.checkpoints import io as ckpt_io
        root = str(self.example_ckpt)
        step = ckpt_io.latest_checkpoint_step(root)
        state = torch.load(os.path.join(ckpt_io._iter_dir(root, step),
                                        ckpt_io.STATE_FILENAME),
                           map_location="cpu", weights_only=True, mmap=True)
        params = dict(state["params"])
        params["tok_embed"] = params["tok_embed"].clone()
        params["tok_embed"][CLIP_BPE_VOCAB:] = 0.0
        self.example_params, self.example_step = params, step
        served = self.root / "example_served_ckpt"
        ckpt_io.save_checkpoint(str(served), step, {"params": params})
        self.launch("example", GPT_DIST + ["--load", str(served)], 1)

    def _tail(self, name: str) -> str:
        return (self.dirs[name] / "log.txt").read_text()[-4000:]

    def url(self, name: str) -> tuple:
        """(the server's URL, its ready.json) once it serves; raises with
        its log's end if it exits first or outlasts GEN_READY_TIMEOUT_S."""
        ready, t0 = self.dirs[name] / "ready.json", time.perf_counter()
        while not ready.exists():
            if self.procs[name].poll() is not None:
                raise AssertionError(f"server {name} exited "
                                     f"{self.procs[name].returncode}:\n"
                                     + self._tail(name))
            if time.perf_counter() - t0 > GEN_READY_TIMEOUT_S:
                raise AssertionError(f"server {name} not ready after "
                                     f"{GEN_READY_TIMEOUT_S} s:\n"
                                     + self._tail(name))
            time.sleep(0.05)
        info = json.loads(ready.read_text())
        return f"http://127.0.0.1:{info['port']}", info

    def release(self, name: str, url: str) -> None:
        """Tell server `name` to stop (GET /_stop); `finish` waits for it."""
        http_get(url + "/_stop")
        self.released.append(name)

    def finish(self, timeout: float = 30.0) -> None:
        """Hold every released server's exit code to 0."""
        for name in self.released:
            self._exited(name, timeout)

    def _exited(self, name: str, timeout: float) -> None:
        try:
            rc = self.procs[name].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            kill_tree(self.procs[name].pid)
            self.procs[name].wait()
            rc = "timeout"
        if rc != 0:
            raise AssertionError(f"server {name} ended with {rc}:\n"
                                 + self._tail(name))

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                kill_tree(proc.pid)
                proc.wait()
        shutil.rmtree(self.root, ignore_errors=True)


def http_get(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=GEN_HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def http_put(url: str, request: dict) -> tuple:
    """PUT `request` to url/api: (the JSON answer, the seconds it took);
    a status other than 200 raises with the answer's message."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url + "/api", method="PUT",
                                 data=json.dumps(request).encode(),
                                 headers={"Content-Type": "application/json"})
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=GEN_HTTP_TIMEOUT_S) as r:
            body = json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise AssertionError(f"PUT {request} -> {e.code}: {e.read()!r}")
    return body, time.perf_counter() - t


def serve_requests(url: str, requests: dict) -> dict:
    """Each request of `requests` over HTTP, then the server's probe of
    it: {name: {"answer", "latency_s", "record"}}; each request must have
    made one generation."""
    got = {}
    for name, req in requests.items():
        answer, latency = http_put(url, req)
        records = http_get(url + "/_probe")
        if len(records) != 1:
            raise AssertionError(f"{name}: {len(records)} generations")
        got[name] = {"answer": answer, "latency_s": latency,
                     "record": records[0]}
    return got


def serve_launches(name: str, got: dict, layers: int, norm: str) -> dict:
    """Each request's launches, held exactly: the norm's forward kernel
    (2L + 1) times a forward, 1 + N forwards for a generation (the
    prefill, then N steps: the JAX scan's last step runs the forward too)
    and N for a beam search (the prefill, N - 1 steps); no other
    kernel. Returns them by path for the kernels line."""
    kernel = "rms_norm_fwd" if norm == "rmsnorm" else "layer_norm_fwd"
    paths = {}
    for req, res in got.items():
        rec = res["record"]
        n = rec["options"]["max_new_tokens"]
        forwards = 1 + n if rec["kind"] == "generate" else n
        want = {k: 0 for k in rec["launches"]}
        want[kernel] = (2 * layers + 1) * forwards
        if rec["launches"] != want:
            raise AssertionError(f"{name} {req}: launches {rec['launches']}"
                                 f", want {want}")
        paths[f"serve {name} {req}"] = rec["launches"]
    return paths


@torch.no_grad()
def teacher_forced(model, out: torch.Tensor, lens: torch.Tensor, p: int,
                   n: int, shift: int = 0) -> torch.Tensor:
    """The cached decode's logits [B, n, V] at each generated position of
    out [B, P + n], the port's `_forward_cached` fed the served tokens: the
    prefill's at lens - 1, then step i's, fed out[:, lens + i] at position
    lens + i (+ `shift`: a planted off-by-one)."""
    from megatron_clip_tpu_torch.inference import generation as gen
    dtype = gen.default_compute_dtype(out.device)
    params = gen.decode_params(model, dtype)
    b = out.shape[0]
    cache = gen.KVCache.create(model.cfg, b, p + n + shift,
                               device=out.device)
    rows = torch.arange(b, device=out.device)
    logits, cache = gen._forward_cached(params, out[:, :p], 0, cache,
                                        model.cfg, dtype)
    got = [logits[rows, lens - 1]]
    for i in range(n - 1):
        pos = lens + i
        step, cache = gen._forward_cached(params, out[rows, pos][:, None],
                                          pos + shift, cache, model.cfg,
                                          dtype)
        got.append(step[:, 0])
    return torch.stack(got, 1)


@torch.no_grad()
def serve_check(name: str, model, res: dict, teeth: bool = True) -> dict:
    """A greedy generation with log-probabilities, held against the port's
    `GPTModel` forward over the served tokens on the card: the cached
    decode's logits at each generated position (`teacher_forced`) within
    GEN_LOGIT_TOL of the forward's, and with `teeth`, with a planted
    off-by-one position not (a learned table's next row; with rotary
    positions only the offsets to the prompt move, and an unwritten cache
    slot joins, which a barely trained model's near-uniform attention
    hardly sees: 0.148 on (b)'s, so (b) plants none); each served token
    the forward's argmax wherever the forward's top-2 margin is above
    GEN_LOGIT_TOL (through its EOS); the answer's log-probabilities within
    GEN_LOGPROB_TOL of the forward's log_softmax at the served tokens."""
    rec, answer = res["record"], res["answer"]
    dev = model.tok_embed.device
    prompt, lens = (torch.tensor(x, device=dev) for x in rec["inputs"])
    out, n_gen = (torch.tensor(x, device=dev) for x in rec["out"][:2])
    b, p = prompt.shape
    n = rec["options"]["max_new_tokens"]
    fw = model(out)                                        # [B, P+n, V]
    rows = torch.arange(b, device=dev)
    at = lens[:, None] - 1 + torch.arange(n, device=dev)[None]
    want = fw[rows[:, None], at]                           # [B, n, V]
    got = teacher_forced(model, out, lens, p, n)
    logit_err = float((got - want).abs().max())
    del got
    off_err = None
    if teeth:
        t = min(GEN_TEETH_STEPS, n)
        off = teacher_forced(model, out, lens, p, t, shift=1)
        off_err = float((off[:, 1:] - want[:, 1:t]).abs().max())
        del off
    top2 = want.topk(2, dim=-1).values
    live = torch.arange(n, device=dev)[None] < n_gen[:, None]
    decided = live & (top2[..., 0] - top2[..., 1] > GEN_LOGIT_TOL)
    served = out[rows[:, None], at + 1]
    agree = served == want.argmax(-1)
    lsm = torch.log_softmax(fw, dim=-1)
    lp_err = 0.0
    for r, row in enumerate(answer["logprobs"]):
        k = len(row)
        ref = lsm[r, torch.arange(k, device=dev), out[r, 1:k + 1]]
        lp_err = max(lp_err, float((torch.tensor(row, device=dev)
                                    - ref).abs().max()))
    result = {"logit_max_abs_err": logit_err,
              "off_by_one_logit_max_abs_err": off_err,
              "logprob_max_abs_err": lp_err,
              "greedy_positions_decided": int(decided.sum()),
              "greedy_positions_live": int(live.sum()),
              "greedy_agree_where_decided": bool(agree[decided].all()),
              "greedy_agree_share": float(agree[live].float().mean())}
    log(f"  {name}: teacher-forced decode logits {logit_err:.4g} from the "
        f"forward's (tolerance {GEN_LOGIT_TOL}); off by one position "
        f"{'not planted' if off_err is None else f'{off_err:.4g}'}; "
        f"log-probabilities {lp_err:.4g} (tolerance "
        f"{GEN_LOGPROB_TOL}); greedy tokens the forward's argmax at "
        f"{result['greedy_agree_share']:.4f} of {int(live.sum())} "
        f"positions, at all {int(decided.sum())} whose top-2 margin is "
        f"above the tolerance")
    if logit_err > GEN_LOGIT_TOL or (teeth and off_err <= GEN_LOGIT_TOL) \
            or \
            lp_err > GEN_LOGPROB_TOL or not result[
                "greedy_agree_where_decided"]:
        per = (teacher_forced(model, out, lens, p, n) - want).abs().amax(-1)
        for r in range(b):
            bad = (per[r] > GEN_LOGIT_TOL).nonzero()
            alone = model(out[r:r + 1, :int(lens[r]) + n])[0, at[r]]
            log(f"  {name} row {r}: prompt {int(lens[r])} tokens, "
                f"{int(n_gen[r])} generated; decode against the batch's "
                f"forward {float(per[r].max()):.4g}, first past the "
                f"tolerance at step {int(bad[0]) if len(bad) else None}; the"
                f" row's forward alone against the batch's "
                f"{float((alone - want[r]).abs().max()):.4g}; tokens "
                f"{out[r, :int(lens[r]) + 12].tolist()}")
        raise AssertionError(f"{name}: {result}")
    return result


@torch.no_grad()
def top_k_check(name: str, model, res: dict) -> dict:
    """A top-k sample: each served token (through its EOS) among the k
    largest of the cached decode's logits fed the served tokens, within
    GEN_LOGIT_TOL of the k-th; no token past the CLIP BPE's vocabulary."""
    rec = res["record"]
    dev = model.tok_embed.device
    prompt, lens = (torch.tensor(x, device=dev) for x in rec["inputs"])
    out, n_gen = (torch.tensor(x, device=dev) for x in rec["out"][:2])
    b, p = prompt.shape
    opts = rec["options"]
    n, k = opts["max_new_tokens"], opts["top_k"]
    logits = teacher_forced(model, out, lens, p, n)
    rows = torch.arange(b, device=dev)
    at = lens[:, None] + torch.arange(n, device=dev)[None]
    served = out[rows[:, None], at]
    live = torch.arange(n, device=dev)[None] < n_gen[:, None]
    kth = logits.topk(k, dim=-1).values[..., -1]
    mine = logits.gather(-1, served[..., None])[..., 0]
    slack = float((kth - mine)[live].max())
    if slack > GEN_LOGIT_TOL or int(served[live].max()) >= CLIP_BPE_VOCAB:
        raise AssertionError(f"{name}: a sampled token {slack:.4g} below "
                             f"the {k}-th logit, or past the vocabulary")
    log(f"  {name}: every sampled token within the top {k} (the lowest "
        f"{0.0 - slack:.4g} above the {k}-th logit)")
    return {"top_k_slack": slack}


@torch.no_grad()
def decode_timings(model, prompt: torch.Tensor, lens: torch.Tensor,
                   reps: int = GEN_TIMED_STEPS) -> dict:
    """The decode step of `model` in the compute dtype at batch B: the
    time to the first token (host wall time from the call of `generate` to
    its first sampled token on the card, the first `_sample` synchronized;
    the second call's, the first meeting the shapes' first products),
    then `reps` steps (`_forward_cached` of one token a row at its own
    position, then the greedy `_sample`): the host's ms a step to enqueue
    them, each step's interval on the device clock (CUDA events between
    the steps: the card's launch queue holds about one step's ~900
    launches, so the host paces it), their median, and the steps' kernels
    in a profile (`step_profile`: the device's busy time a step)."""
    from megatron_clip_tpu_torch.inference import generation as gen
    first, sample = {}, gen._sample

    def timed_sample(*a, **kw):
        tok = sample(*a, **kw)
        if "s" not in first:
            torch.cuda.synchronize()
            first["s"] = time.perf_counter() - t0
        return tok
    gen._sample = timed_sample
    try:
        for _ in range(2):
            first.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.generate(model, prompt, lens, max_new_tokens=2,
                         temperature=0.0)
    finally:
        gen._sample = sample
    dtype = gen.default_compute_dtype(prompt.device)
    params = gen.decode_params(model, dtype)
    b, p = prompt.shape
    # positions for the warm-up, the two timed windows and the profile
    cache = gen.KVCache.create(model.cfg, b,
                               p + 3 + 2 * reps + GEN_PROFILED_STEPS,
                               device=prompt.device)
    logits, cache = gen._forward_cached(params, prompt, 0, cache, model.cfg,
                                        dtype)
    tok = logits[torch.arange(b, device=prompt.device), lens - 1].argmax(-1)
    i = 0

    def step():
        nonlocal tok, cache, i
        logits, cache = gen._forward_cached(params, tok[:, None], lens + i,
                                            cache, model.cfg, dtype)
        tok = gen._sample(logits[:, 0], 0.0, 0, None)
        i += 1
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        step()
    host_ms = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        step()
        e.record()
    events[-1].synchronize()
    per_step = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"ttft_ms": first["s"] * 1e3, "step_host_ms": host_ms,
            "step_interval_ms": per_step,
            "step_interval_ms_median": float(np.median(per_step)),
            "profile": step_profile(step)}


def step_profile(step, steps: int = GEN_PROFILED_STEPS,
                 top: int = 12) -> dict:
    """torch.profiler over `steps` calls of `step`: the device's kernel
    time and kernel count a step, and the `top` kernels by device time and
    host ops by their own host time, each a step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    def device_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) or 0)
    rows = prof.key_averages()
    kernels = sorted(((e.key[:120], e.count / steps, device_us(e) / steps)
                      for e in rows if device_us(e) > 0 and
                      e.self_cpu_time_total == 0),
                     key=lambda r: -r[2])
    host = sorted(((e.key[:120], e.count / steps,
                    e.self_cpu_time_total / steps)
                   for e in rows if e.self_cpu_time_total > 0),
                  key=lambda r: -r[2])
    return {"device_us": sum(k[2] for k in kernels),
            "kernels": sum(k[1] for k in kernels),
            "host_us": sum(h[2] for h in host),
            "top_device_us": kernels[:top], "top_host_us": host[:top]}


def serving_norm_checks(errs, rows, ln) -> dict:
    """The LayerNorm and RMSNorm forward kernels at the serving rows of
    phase 18 (B = 8 and 1 a decode step, B P = 128 and 16 at prefill, W =
    1024), bf16 (the decode's) and fp32 ((c)'s), against their plain
    versions; then their timings at B = 8 and B P = 128 in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    w = GPT_345M["hidden_size"]
    for n in GEN_NORM_ROWS:
        x = torch.randn(n, w, device="cuda", generator=gen) * 3 + 1
        scale = torch.randn(w, device="cuda", generator=gen)
        bias = torch.randn(w, device="cuda", generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            check_kernel(errs, "layer_norm_fwd", f"serving rows={n} W={w}",
                         ln.layer_norm_fwd(xd, scale, bias),
                         lambda dt: ln.layer_norm_plain(xd.to(dt), scale,
                                                        bias))
            check_kernel(errs, "rms_norm_fwd", f"serving rows={n} W={w}",
                         ln.rms_norm_fwd(xd, scale),
                         lambda dt: ln.rms_norm_plain(xd.to(dt), scale))
    dt = torch.bfloat16
    for n in GEN_NORM_ROWS[::2]:
        x = torch.randn(n, w, device="cuda", generator=gen, dtype=dt)
        scale = torch.randn(w, device="cuda", generator=gen)
        bias = torch.randn(w, device="cuda", generator=gen)
        scale_bf, bias_bf = scale.to(dt), bias.to(dt)
        rows.append(timing_row(
            "layer_norm_fwd", f"serving GPT-345m rows={n} W={w} bf16",
            lambda: ln.layer_norm_fwd(x, scale, bias),
            lambda: ln.layer_norm_plain(x, scale, bias),
            lambda: F.layer_norm(x, (w,), scale_bf, bias_bf, 1e-5),
            ln_cost(n, w, 2), torch.float32))
        rows.append(timing_row(
            "rms_norm_fwd", f"serving example GPT rows={n} W={w} bf16",
            lambda: ln.rms_norm_fwd(x, scale),
            lambda: ln.rms_norm_plain(x, scale),
            lambda: F.rms_norm(x, (w,), scale_bf, 1e-6),
            rms_cost(n, w, 2), torch.float32))
    return {"rows": list(GEN_NORM_ROWS), "width": w}


def rates(got: dict) -> dict:
    """Each request's batch, new tokens, HTTP latency, the generation's
    seconds in the server and tokens/s (B N over them), and its peak."""
    out = {}
    for req, res in got.items():
        rec = res["record"]
        b = len(rec["inputs"][0])
        n = rec["options"]["max_new_tokens"]
        out[req] = {"batch": b, "new_tokens": n,
                    "http_latency_s": res["latency_s"],
                    "generate_s": rec["seconds"],
                    "tokens_per_s": b * n / rec["seconds"],
                    "peak_memory_gib": rec["peak_bytes"] / 2 ** 30}
    return out


def serve_gpt345m(launches: ServingLaunches) -> tuple:
    """(a): GPT-345m at full width and depth behind the server tool."""
    url, info = launches.url("gpt345m")
    t0 = time.perf_counter()
    got = serve_requests(url, GEN_REQUESTS)
    launches.release("gpt345m", url)
    requests_s = time.perf_counter() - t0
    paths = serve_launches("GPT-345m", got, GPT_345M["num_layers"],
                           "layernorm")
    model = on_card(launches.models.pop("gpt345m"))
    result = {"server_ready_s": info["ready_s"], "params": info["params"],
              "server_model_bytes": info["model_bytes"],
              "requests": rates(got),
              "greedy": serve_check("(a) GPT-345m greedy", model,
                                    got["greedy8"]),
              "top_k": top_k_check("(a) GPT-345m top-k", model,
                                   got["top_k"])}
    beam = got["beam"]["record"]
    result["beam_score"] = got["beam"]["answer"]["scores"][0]
    result["beam_tokens"] = beam["out"][0][0]
    result["requests_s"] = requests_s
    result["checks_s"] = time.perf_counter() - t0 - requests_s
    rec = got["greedy8"]["record"]
    prompt, lens = (torch.tensor(x, device=model.tok_embed.device)
                    for x in rec["inputs"])
    result["timings_b8"] = decode_timings(model, prompt, lens)
    result["timings_b1"] = decode_timings(model, prompt[:1], lens[:1])
    bound = info["params"] * 2 / HBM_BYTES_PER_S * 1e3
    b8 = result["timings_b8"]
    busy = b8["profile"]["device_us"] / 1e3
    result.update(weight_stream_bound_ms=bound,
                  step_busy_vs_bound=busy / bound,
                  step_interval_vs_bound=b8["step_interval_ms_median"]
                  / bound, step_host_vs_busy=b8["step_host_ms"] / busy)
    del model
    torch.cuda.empty_cache()
    for b in ("b8", "b1"):
        t = result[f"timings_{b}"]
        prof = t["profile"]
        log(f"  (a) decode at {b.upper()}: time to first token "
            f"{t['ttft_ms']:.2f} ms; a step {t['step_host_ms']:.3f} host "
            f"ms to enqueue, {t['step_interval_ms_median']:.3f} ms apart on "
            f"the device clock (median of {len(t['step_interval_ms'])}, "
            f"CUDA events), its kernels busy {prof['device_us'] / 1e3:.3f} "
            f"ms ({prof['kernels']:.0f} kernels; profiled host ops "
            f"{prof['host_us'] / 1e3:.3f} ms); top kernels (name, a step, "
            f"us) {prof['top_device_us']}; top host ops "
            f"{prof['top_host_us']}")
    log(f"  (a) the step's kernels busy {result['step_busy_vs_bound']:.2f}x "
        f"the weight-streaming bound of {bound:.4f} ms ({info['params']} "
        f"parameters in bf16 at {HBM_BYTES_PER_S / 1e12:.2f} TB/s), its "
        f"interval {result['step_interval_vs_bound']:.2f}x; the host "
        f"{result['step_host_vs_busy']:.2f}x the kernels' time; server ready"
        f" {info['ready_s']:.1f} s after go; requests "
        f"{json.dumps(result['requests'])}")
    return result, paths


def serve_example(launches: ServingLaunches) -> tuple:
    """(b): examples/pretrain_gpt_dist.sh's model from phase 15 (a)'s
    checkpoint behind the server tool."""
    from megatron_clip_tpu_torch.pretrain_gpt import (gpt_cfg_from_args,
                                                      parse_args,
                                                      precision_from_args)
    from megatron_clip_tpu_torch.tools.run_text_generation_server import \
        build_model
    url, info = launches.url("example")
    prompts = corpus_prompts()
    got = serve_requests(url, {
        name: dict(req, prompts=prompts[:len(req["prompts"])])
        for name, req in GEN_EXAMPLE_REQUESTS.items()})
    launches.release("example", url)
    args = parse_args(GPT_DIST)
    cfg = gpt_cfg_from_args(args)
    paths = serve_launches("example GPT", got, cfg.num_layers, "rmsnorm")
    model = on_card(build_model(cfg, precision_from_args(args),
                                launches.example_params))
    result = {"server_ready_s": info["ready_s"],
              "checkpoint_step": launches.example_step,
              "requests": rates(got),
              "greedy": serve_check("(b) example GPT greedy", model,
                                    got["greedy8"], teeth=False),
              "top_k": top_k_check("(b) example GPT top-k", model,
                                   got["top_k"])}
    del model
    torch.cuda.empty_cache()
    log(f"  (b) requests {json.dumps(result['requests'])}")
    return result, paths


@contextlib.contextmanager
def fp32_cache():
    """`KVCache.create` making fp32 caches while the block runs (the port
    and the JAX package make bf16 ones on every device)."""
    from megatron_clip_tpu_torch.inference import generation as gen
    create = gen.KVCache.__dict__["create"]
    gen.KVCache.create = classmethod(
        lambda cls, *a, **kw: create.__func__(cls, *a,
                                              **dict(kw, dtype=torch.float32)))
    try:
        yield
    finally:
        gen.KVCache.create = create


def serve_fp32_and_tp(launches: ServingLaunches) -> dict:
    """(c) the 2-layer fp32 model's greedy request on the card against the
    CPU, in this process (`GenerationService` in fp32): the texts and
    segments equal, the log-probabilities within GEN_CPU_LOGPROB_TOL, and
    the same with fp32 caches (how far apart the bf16 cache's roundings put
    them); (d) the same request to the tensor-parallel server against the
    card's answer: texts and segments equal, log-probabilities within
    GEN_TP_LOGPROB_TOL."""
    from megatron_clip_tpu_torch.inference.server import GenerationService
    from megatron_clip_tpu_torch.tokenizer import SimpleTokenizer
    tok = SimpleTokenizer()
    req = GEN_FP32_REQUEST
    cpu_model = launches.models.pop("fp32")
    models = {"cuda": on_card(copy.deepcopy(cpu_model)), "cpu": cpu_model}
    answers = {}
    for cache in ("bf16", "fp32"):
        for where, model in models.items():
            service = GenerationService(model, tok, eos_id=tok.eot_token_id,
                                        compute_dtype=torch.float32)
            t = time.perf_counter()
            with (fp32_cache() if cache == "fp32"
                  else contextlib.nullcontext()):
                texts, segments, lps = service(
                    req["prompts"], req["tokens_to_generate"],
                    req["temperature"], return_logprobs=True)
            answers[where, cache] = {"text": texts, "segments": segments,
                                     "logprobs": lps,
                                     "seconds": time.perf_counter() - t}
    url, info = launches.url("tp2")
    tp, latency = http_put(url, req)
    launches.release("tp2", url)
    card = answers["cuda", "bf16"]

    def lp_err(a, b):
        return max(max(abs(x - y) for x, y in zip(ra, rb))
                   for ra, rb in zip(a["logprobs"], b["logprobs"]))
    result = {"cpu_logprob_max_abs_err": lp_err(card, answers["cpu", "bf16"]),
              "cpu_logprob_max_abs_err_fp32_cache": lp_err(
                  answers["cuda", "fp32"], answers["cpu", "fp32"]),
              "tp_logprob_max_abs_err": lp_err(tp, card),
              "card_s": card["seconds"],
              "cpu_s": answers["cpu", "bf16"]["seconds"],
              "tp_http_latency_s": latency,
              "tp_server_ready_s": info["ready_s"]}
    log(f"  (c) fp32 card vs CPU: log-probabilities "
        f"{result['cpu_logprob_max_abs_err']:.3g} apart (tolerance "
        f"{GEN_CPU_LOGPROB_TOL}), with fp32 caches "
        f"{result['cpu_logprob_max_abs_err_fp32_cache']:.3g}; (d) tp "
        f"{GEN_TP_RANKS} over gloo vs one process: "
        f"{result['tp_logprob_max_abs_err']:.3g} (tolerance "
        f"{GEN_TP_LOGPROB_TOL}); {json.dumps(result)}")
    for name, got, tol, key in (
            ("(c) card vs CPU", answers["cpu", "bf16"], GEN_CPU_LOGPROB_TOL,
             "cpu_logprob_max_abs_err"),
            ("(d) tp vs one process", tp, GEN_TP_LOGPROB_TOL,
             "tp_logprob_max_abs_err")):
        if got["text"] != card["text"] or \
                got["segments"] != card["segments"] or result[key] > tol:
            raise AssertionError(f"{name}: the answers differ: {result}")
    return result


def on_card(model):
    """`model` moved to the card (in place)."""
    return model.to("cuda").eval()


def phase_gpt_serving(launches: ServingLaunches, mha, ln, card: str, errs,
                      rows) -> tuple:
    log(f"[18] GPT text generation: the server tool over HTTP, (a) "
        f"GPT-345m at full width and depth, (b) examples/pretrain_gpt_dist"
        f".sh's model from phase 15's checkpoint, (c) fp32 card vs CPU, (d) "
        f"{GEN_TP_RANKS} gloo ranks at tp {GEN_TP_RANKS} vs one process")
    t0 = time.perf_counter()
    result, paths = {"card": card}, {}
    launches.go.touch()

    def timed(name: str, part):
        t_part = time.perf_counter()
        result[name] = part()
        if isinstance(result[name], tuple):
            result[name], more = result[name]
            paths.update(more)
        result[name]["seconds"] = time.perf_counter() - t_part
        log(f"  {name}: {result[name]['seconds']:.1f} s")
    try:
        timed("norms", lambda: serving_norm_checks(errs, rows, ln))
        timed("gpt345m", lambda: serve_gpt345m(launches))
        timed("example", lambda: serve_example(launches))
        timed("fp32_tp", lambda: serve_fp32_and_tp(launches))
        launches.finish()
    finally:
        launches.stop()
    result["seconds"] = time.perf_counter() - t0
    log(f"  GPT text generation ({card}): {json.dumps(result)}")
    if result["seconds"] > GEN_LIMIT_S:
        raise AssertionError(
            f"phase 18 took {result['seconds']:.1f} s, over "
            f"{GEN_LIMIT_S} s: " + phase_parts(result))
    return result, paths


def tp_fault_readings() -> int:
    """`python3 chip_smoke.py --tp-faults`: the dropout kernels against
    their plain versions as phase 3 holds them (every shape of
    FUSED_DROPOUT_SHAPES and FLASH_DROPOUT_SHAPES, the placed launches
    among them), then phase 17 (a) with TP_FAULTS's jobs beside its own:
    each job's readings against its one process, and of each fault the
    bounds it breaks, the readings that set TP_LOSS_RTOL and TP_NORM_RTOL.
    Its last two lines: the card's name and power limit, and the readings
    as one JSON object."""
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    from megatron_clip_tpu_torch.pretrain_gpt import main as gpt_main
    from megatron_clip_tpu_torch.training import workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    atexit.register(kill_tree)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    card = gpu_name_and_power_limit()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    launches = ShardedLaunches(faults=True)
    log("[2] build")
    took = _build.build(list(_build.SOURCES) + list(_build.HOST_SOURCES))
    log(f"  {json.dumps({k: round(v, 1) for k, v in took.items()})}")
    log("[3] the dropout kernels vs their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {name: {} for name in KERNELS}
    fused_dropout_checks(errs, gen, mha)
    flash_dropout_checks(errs, gen)
    log(f"  worst errors: {json.dumps({k: v for k, v in errs.items() if v})}")
    log("[17] (a) with the planted faults")
    t0 = time.perf_counter()
    launches.go.touch()
    try:
        one = tp_references(launches, gpt_main, workload, mha, ln)
        result = tp_parity(launches, one)
        launches.finish(timeout=60)
    finally:
        launches.stop()
    log(f"  {time.perf_counter() - t0:.1f} s")
    keys = ("loss_max_rel_err", "grad_norm_max_rel_err",
            "param_err_over_moved", "param_share_lr_apart", "breaks")
    check_no_processes_left()
    print(card)
    print(json.dumps({name: {k: res[k] for k in keys if k in res}
                      for name, res in result.items()}))
    return 0


def gpt_serving_only() -> int:
    """`python3 chip_smoke.py --gpt-serving`: phase 18 alone, after the
    phases it needs: 1, 2 (every kernel) and phase 15 (a), which writes
    (b)'s checkpoint. It prints the phase's lines, not the script's last
    three."""
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln
    from megatron_clip_tpu_torch.pretrain_gpt import main as gpt_main
    from megatron_clip_tpu_torch.training import workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    atexit.register(kill_tree)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    card = gpu_name_and_power_limit()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {card}")
    serving = ServingLaunches()
    phase_build(_build)
    log("[15] (a) alone: examples/pretrain_gpt_dist.sh's checkpoint")
    shutil.rmtree(GPT_SMOKE_DIR, ignore_errors=True)
    (GPT_SMOKE_DIR / "corpus").mkdir(parents=True)
    try:
        gpt_trainer_dist(gpt_main, workload, mha, ln, GPT_SMOKE_DIR,
                         float("nan"), GPT_SMOKE_DIR / "corpus")
    finally:
        keep(serving.example_ckpt)
    serving.start_example()
    errs, rows = {name: {} for name in KERNELS}, []
    phase_gpt_serving(serving, mha, ln, card, errs, rows)
    check_no_processes_left()
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--gpt-dp-worker"]:
        return gpt_dp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--tp-faults"]:
        return tp_fault_readings()
    if sys.argv[1:2] == ["--gpt-serve-worker"]:
        return gpt_serve_worker(sys.argv[2])
    if sys.argv[1:2] == ["--gpt-serving"]:
        return gpt_serving_only()
    import megatron_clip_tpu_torch as port
    from megatron_clip_tpu_torch.ops.kernels import _build
    from megatron_clip_tpu_torch.ops.kernels import fused_mha as mha
    from megatron_clip_tpu_torch.ops.kernels import layernorm as ln

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # on every way out, a failed phase's exception and SIGTERM included:
    # the cleanups registered later (the launches', the decode workers')
    # run first, then this kills whatever is still below the script
    atexit.register(kill_tree)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    t_start = time.perf_counter()
    card = gpu_name_and_power_limit()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    launches = DataParallelLaunches()
    gpt_launches = GptDataParallelLaunches()
    tp_launches = ShardedLaunches()
    gpt_serve = ServingLaunches()
    phase_build(_build)
    errs = phase_kernels(mha, ln)
    phase_goldens(port)
    serving = phase_serving(port, mha, ln, card)
    rows = phase_timings(mha, ln)
    train = phase_train(port, mha, ln, card)
    legs = phase_legs(port, mha, ln, card)
    gpt = phase_gpt(mha, ln, card)
    example = phase_example(mha, ln, card, gpt)
    pipeline = phase_pipeline(mha, ln, card)
    trainer = phase_trainer(mha, ln, card, train)
    recipes = phase_recipes(mha, ln, card)
    dp = phase_data_parallel(launches, mha, ln, card, trainer)
    gpt_trainer = phase_gpt_trainer(mha, ln, card, example,
                                    gpt_launches.corpus_dir,
                                    keep_ckpt=gpt_serve.example_ckpt)
    gpt_serve.start_example()
    gpt_dp = phase_gpt_data_parallel(gpt_launches, mha, ln, card,
                                     gpt_trainer)
    # phase 18's servers load their checkpoints and models beside phase
    # 17, so that the serving phase starts on servers that are ready
    gpt_serve.go.touch()
    sharded = phase_sharded(tp_launches, mha, ln, card)
    _, serving_paths = phase_gpt_serving(gpt_serve, mha, ln, card, errs,
                                         rows)
    paths = {"serving ViT-B-32": serving["launches"],
             "train ViT-B-32": train["launches"],
             **{f"train {name} recompute": run["launches"]
                for name, run in legs["runs"].items()},
             **{f"train {name} saved P": run["launches"]
                for name, run in legs["saved_p"].items()},
             **{f"train GPT-345m {key}": run["launches"]
                for key, run in gpt.items() if key != "parity"},
             "train example GPT": example["run"]["launches"],
             "train GPT-345m S=2048 fused_ce":
                 example["gpt345m_fused_ce"]["launches"],
             **{f"train pipeline GPT {key}": run["launches"]
                for key, run in pipeline.items() if key != "parity"},
             **{f"trainer ViT-B-32 {key}": trainer[key]["launches"]
                for key in ("synthetic", "webdataset", "csv", "jpeg")},
             f"trainer {RECIPE_MODEL} siglip accum patch dropout":
                 recipes["siglip"]["launches"],
             **{f"trainer {RECIPE_MODEL} LiT {tower}":
                recipes[f"lit_{tower}"]["launches"]
                for tower, _, _ in LIT_RUNS},
             "trainer ViT-B-32 torchrun 1 rank nccl":
                 dp["nccl_one_rank"]["launches"],
             "GPT trainer pretrain_gpt_dist.sh 1 card":
                 gpt_trainer["dist"]["launches"],
             "GPT trainer ladder 1.3b rung": gpt_trainer["rung"]["launches"],
             "GPT trainer torchrun 1 rank nccl":
                 gpt_dp["nccl_one_rank"]["launches"],
             "GPT trainer document flags 1 card":
                 gpt_dp["doc_flags"]["launches"],
             **{f"GPT trainer tp2 x fsdp2 sp rank {r}": got
                for r, got in enumerate(
                    sharded["gpt_tp2_fsdp2_sp"]["bf16"]["launches_ranks"])},
             **{f"GPT trainer tp2 x fsdp2 sp dropout rank {r}": got
                for r, got in enumerate(sharded["gpt_tp2_fsdp2_sp"][
                    "bf16 dropout"]["launches_ranks"])},
             **serving_paths}
    kernels = kernels_line(rows, paths, errs)
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels no main path launched: {idle}")
    check_no_processes_left()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
