#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (with ``t_s``, the seconds since the
start) and raising on failure (the script then exits non-zero and prints
no result):

1. device  — the card's name, count and power limit (nvidia-smi).
2. build   — seconds to build every kernel library from csrc/ with nvcc
             (sm_90a), one nvcc per source, all started together.
   ptxas   — the flash kernels' and row 7's register and spill lines
             as ptxas reported them (-Xptxas -v, kept beside each
             library), by library; rows 8's and 13's kernels' registers,
             spills and blocks an SM by registers, by kernel, and so the
             f32 flash forward's and backward's kernels by tile width.
   sass    — the SASS instructions a value of rows 8, 12 and 13 on their
             common paths (cuobjdump), and the card's top SM clock: the
             instruction floors of the kernel phases.
3. kernels — every ported kernel against its plain PyTorch version on
             the card, at the shapes the serving and training paths
             give it: the flash forward (serving prefill buckets and the
             GPT-1.3B trainer's packed shape; and the padded-prefix law
             at the kernel's own level: rows 0..299 of a causal S=512
             call whose positions past 300 are padding equal the S=300
             call bit for bit, bf16 and f32), the flash backward (the
             trainer's packed shape, separate [B, S, H, D] tensors, a
             ragged S, D=64 and D=256; two runs must give the same
             bits), each flash case with its achieved TFLOP/s beside the
             bound's, the plain version's and SDPA's, AdamW on the
             trainer's 2048x8192 and 50304x2048 leaves (p, m, v bit
             for bit, stochastic rounding on) and, through the list
             entry in one launch, on GPT-1.3B's 292 leaves (every leaf
             bit for bit against the per-leaf plain version, timed
             beside AdamW(fused=True) on the same list; the flagship's
             194 leaves without int8 moments timed alone) and on odd
             lengths and misaligned views, the int8 quantize
             kernels at every shape the flagship trainer and
             Int8Linear's decode path give them (row and column
             round-to-nearest, column stochastic rounding with and
             without gelu: codes and scales bit for bit, the SR laws
             on the card; row 8's route, a warp or a block a row, and
             its instructions a value from its SASS and the compute
             floor they set; row 12 in one read of x beside the
             two-pass pair on the same input, its instructions a value
             and floor likewise, and both of its routes bit for bit at
             the one-read row limit), the int8 GEMM (torch._int_mm, a
             library call) in the layouts the port hands it beside bf16
             matmuls, and the int8-moment AdamW (row 13) on every
             int8-moment leaf shape of GPT-1.3B (p, codes and scales bit
             for bit; timed on 2048x6144 and 50304x2048) and, through
             its list entry in one launch, on the flagship's 98
             int8-moment leaves (every leaf bit for bit against the
             per-leaf plain version, timed through a kept AdamW8Leaves
             table beside the summed bound and the instruction floor
             from its SASS, with the host ms of a call) and on odd
             leaves (C = 128, one row, 3-D, C = 16384).
             Kernel, plain and library (a yardstick only) device times
             from torch.profiler's CUDA trace (a trace without device
             time, or short of a whole number of events per call for
             some kernel, is taken again, PROFILE_TRIES times in all,
             then the time comes from CUDA events around the same
             calls), and the bound: the larger of bytes
             / 3.35 TB/s and the operations at their peak rates (H100
             SXM data sheet).
   kernels, rows 10 and 11 — LayerNorm + row quantize and the SR column
             quantize of LN(x) from its row statistics, bit for bit
             against their plain versions at the trainer's [6144, 2048]
             (LN1's and LN2's g and b) and on a constant row and a
             g = b = 0 column; row 11 under row 12's SR laws and equal
             to the two-pass pair; ms beside the bound, the plain
             version and the unfused pair each replaces; row 11's
             route (one read of x up to its row limit), one kernel
             event a call, the pair's ms, the instruction floor from
             its SASS and its ptxas line, both routes at the limit.
   kernels-attn — the flash kernels at head_dims off {64, 128, 256}
             (32, 80, 96, 64 and 160 in bf16 and 192 in f16, run at the
             next tile width) and
             in f32 (64, 128 and 256; forward and backward 3xTF32 on
             wgmma), causal and
             not, forward and backward against the plain versions (the
             backward the same bits twice); ms and TFLOP/s beside the
             bound (f32: three TF32 products a product, with the
             scalar-rate bound beside it), the plain version and
             PyTorch's SDPA (a yardstick); the f32 forward and backward
             on packed views (the backward through flash_qkv_packed_bwd,
             the same bits twice, beside SDPA's backward on the views).
   sdpa-f32 — the port's scaled_dot_product_attention on f32 tensors
             that require grad (D=128), then backward: the launch
             counts, set to 0 just before and read just after, show one
             forward and one f32 backward launch, torch.profiler's trace
             of the backward each f32 backward kernel once, and the
             gradients are within 1e-4 of the plain backward's.
   kernels, row 7 — int4_matmul against its plain version at Llama-1B's
             four linear shapes (down_proj at group 64), M in {1, 8, 16,
             512} and a ragged 300, within one bf16 step of the output's
             magnitude, an all-zero group at scale 1; ms beside the
             bound, the plain version, torch._weight_int4pack_mm (a
             yardstick the port never calls) and the bf16 linear, with
             GB/s, TFLOP/s, the share of the bound and the regime (decode
             M <= 16, prefill above). Checks at K 2048, N 2064 (a ragged
             column tile), group 64 and 128, bf16 and f32 x, M in {1, 2,
             8, 16, 17, 64, 300, 512}: within one bf16 step, the same bits
             twice, a row's bits not depending on M within a regime
             (1, 2, 8 vs 16; 17, 64, 300 vs 512), an all-zero group of
             every column, and exactly one kernel event per call under
             torch.profiler in both regimes.
   kernels-bn, row 15 — the four BatchNorm kernels (stats, apply, gsum,
             dx) against their plain versions at the 12 BN shapes of
             ResNet-50 at batch 256, bf16 with relu on and off, apply
             also f32: apply and dx bit for bit, the sums within
             BN_SUM_TOL, two runs the same bits; ms beside the bytes
             bound at every shape, the BN ms of a step at 53 layers;
             plain, torch.var_mean / torch.addcmul and cuDNN's
             F.batch_norm forward and backward (yardsticks) at the stem
             and layer4 shapes.
4. serve   — Llama ~1.1B at full width (vocab 32000, hidden 2048, FFN
             5504, 16 heads of 128, 16 layers, bf16; random weights
             from seed 0) served by ServingEngine(kv_layout="contiguous",
             max_slots=16, max_len=512, min_bucket=32): 16 greedy
             requests, prompt lengths cycling {24, 48, 96, 180, 300},
             output lengths cycling {4, 16, 64, 160}. The kernel launch
             counts are set to 0 just before the engine runs and read
             just after: flash_attention_fwd must have run 16 layers x
             16 prefills times, and no other kernel.
5. check   — every engine first token is the argmax of its own
             bucket-padded prefill logits, and those logits equal the
             unpadded prefill's (generate()'s route) within one bf16
             step, for every request; generate()'s first token is the
             argmax of its own prefill; one request's prefill logits
             through the kernel route against the plain masked-einsum
             route, within ROUTE_TOL.
6. profile — device time, busy share and top kernels of 8 decode steps
             over 16 slots and of one 512-bucket prefill, from
             torch.profiler (after the counted run, so it changes none
             of the numbers above).
6a. serve-paged — serve's 16 requests and traffic through
             ServingEngine(kv_layout="paged", page_size=128), its pool at
             capacity parity (65 pages): every greedy token equal to the
             serve phase's, bit for bit (the same flash prefill at the
             same S, then the contiguous decode's einsum over the pages
             gathered through the table); flash_attention_fwd exactly 16
             x 16 launches and no other port kernel; no leaked page
             (page_leak_violations) after the run; tokens/s, p50 / p99
             TTFT, kv_bytes() and device ms a decode step (8 steps of 16
             slots, as profile takes them), each beside the contiguous
             engine's.
6b. serve-paged-int8 — the same with kv_dtype="int8": greedy agreement
             with serve-paged >= 0.9 (the reference's measured-parity
             gate), every logit the engine sampled finite, int8 pools
             with f32 scales, no leak; kv_bytes() beside bf16's.
6c. serve-prefix — bench_serving_engine.py's --prefix-share recipe at its
             full-width settings: two 384-token system prompts, 192
             requests (system prompt i % 2 and a 16-token suffix), 32 new
             tokens, page 128, max_len 512, under one KV byte budget (the
             contiguous pool of 16 slots): the contiguous engine, the
             paged engine and the paged int8 engine (pages and slots from
             the budget), the system prompts warmed into the index first.
             Gates: every request finishes by length; prefix_hit_tokens
             and cow_copies equal what slot_cache.py's rules give for
             this trace (PREFIX_HITS, 0); each paged request's first
             token is the argmax of its own extend logits, and those are
             within ROUTE_TOL of the same prompt's contiguous prefill
             logits; int8's greedy agreement with the paged bf16 engine
             >= 0.9; no leak; each paged pool within the budget. Not
             gated: the shared path's tokens against the contiguous
             engine's (the reference asserts them identical, but here
             the contiguous prefill runs the flash kernel and the extend
             the einsum, so near-ties may split; the agreement is
             printed). Printed: peak concurrency beside the reference's
             bars (4x and 10x the contiguous pool's), the prefix hit
             rate, pages a live token, tokens/s.
6d. serve-spec — serve's 16 requests and traffic through
             ServingEngine(speculative=True, spec_k=4) with the n-gram
             proposer, on the contiguous, paged and paged int8 layouts,
             each held to the k=1 engine of its layout (serve, 6a, 6b)
             by the identity rule: the same tokens, or else, with the
             k=1 tokens fed to the verify as its drafts (teacher
             forcing), its argmax agrees at >= IDENTITY_AGREE_MIN of the
             positions and the k=1 token's logit lies within one bf16
             step of the maximum at every split, with the products whose
             bits differ between the verify's M = 64 and the decode's
             M = 16 named (verify_products, printed always);
             flash_attention_fwd exactly 16 x 16 and no other kernel;
             no draft fault, no leaked page, slot or proposer state;
             tokens/s, TTFT p50 / p99 and spec_stats() beside k=1's.
6e. serve-spec-ngram — bench_serving_engine.py --speculative at its
             full-width settings (:2031-2034): 64 periodic prompts of
             8-24 tokens (RandomState(0)), 64 new tokens, 16 slots, page
             128, k = 4, the k=1 and the speculative paged engine, each
             warmed on every prompt first; SPEC_DECODE's fields (without
             verify_compiles) and the reference's bars, printed, not
             gated; the identity rule; device and wall ms of 8 verify
             steps (spec_gate off) under the profiler beside 8 k=1 decode
             steps, with the host ms of reading the [16, 4, 32000] f32
             logits and its share of the step.
6f. serve-spec-draft — --spec-v2 at its full-width shape (:2042-2045)
             with the cuts SPEC_CUTS lists: 16 prompts of {6, 9, 14, 22}
             tokens, 48 new, through the k=1, n-gram, self-draft and
             tuned engines (the identity rule for each); SPEC_V2's
             fields (without the compile counts); a sampled band
             (temperature 0.8, top_k 8) through the self-draft
             spec_sampled engine against k=1, its TV beside that of two
             k=1 bands with disjoint seeds.
6g. serve-chunked — bench_serving_engine.py --chunked-prefill at its
             full-width settings (:1971-1975): 16 slots, max_len 512,
             min_bucket 32, chunk 64, page 128, prefix sharing off;
             short prompts of 24 and 48 tokens x 64 new, long prompts of
             420 and 480 tokens x 4 new arriving at step 3
             (RandomState(0), ids 1-99), every prompt to 2 tokens first
             (warm). The unchunked and the prefill_chunk=64 engine on the
             paged layout, the same pair on paged int8 and contiguous,
             and a paged prefill_chunk=64 engine with a
             ChunkBudgetController; each chunked run held to its layout's
             unchunked run by the identity rule (as 6d, teacher forcing
             through the sampler), every request by length, row 1
             exactly layers x monolithic prefills and never inside a
             chunk, no other kernel, nothing leaked. CHUNKED_PREFILL's
             fields (the compile counts replaced by the chunk lengths run
             beside prefill_buckets(32, 512)); the reference's >= 3x
             stall bar printed, not gated; a burst of 12 long prompts
             queued at once through a ChunkBudgetController engine,
             which must raise its budget and run several chunks a step,
             held by the identity rule to the burst through the chunk-64
             engine without one; one decode step, one step with a chunk
             and one with the whole 480-token prefill under the
             profiler.
6h. serve-recover — serve's 16 requests on the paged and the contiguous
             layout with serving.step.prefill injected at the 4th
             admission and serving.step.decode at the 21st decode step;
             serve's trace on the paged layout with serving.step.decode
             at the 151st decode step (150 decode forwards replayed);
             the prefix-share trace's first 16 prompts on the paged
             layout with prefix sharing and serve's two faults, where
             the second recover() finds the pages two requests shared
             gone with the requests that wrote them (reroutes [0, 2]
             gated); and the chunked trace on a paged prefill_chunk=64
             engine with serving.prefill.chunk at a mid-prompt chunk;
             recover() after each fault (no other exception caught).
             Each run: a
             ConservationLedger auditor, a FlightRecorder dumping into a
             temporary directory, ptpu_serving_recoveries_total equal to
             the faults fired and to the dumps holding a
             serving.step_error record, no ledger, engine or page
             violation, row 1 exactly layers x monolithic prefills
             (re-prefills included), and the identity rule against the
             fault-free run of the same layout (serve, 6a, 6g; the
             prefix trace's is run here); each recover report (recovered
             slots, replay mismatches, reroutes, the longest delivered
             output, latency) with the device memory before and the peak
             across it.
6i. serve-int4 — serve's 16 requests through ServingEngine(
             weight_only_int4(model, group=128)): int4_matmul exactly
             113 launches (16 layers x 7 linears + lm_head) per model
             call, one call per prefill and decode step; flash 16 x 16;
             tokens/s, TTFT, weight bytes against bf16's.
6j. check-int4 — as check, for the int4 engine; the int4 prefill logits
             through the kernel against the plain route within
             INT4_ROUTE_TOL; last-logit parity against bf16 (printed).
6k. decode — bench_llama_decode.py's phases: generate() at a 64-token
             prompt and 128 new tokens, batch 1 and 8, in bf16,
             weight_only_int8 and weight_only_int4, launches asserted
             (113 int4_matmul or 113 quantize_rows a model call), the
             int8 prefill logits equal through row 8's kernel and its
             plain version, and generate() profiled (5 new tokens less
             1) for device ms a decode step.
6l. serve-gpt* — GPT-1.3B (gpt_1p3b_config: vocab 50304, hidden 2048,
             24 layers, 16 heads of 128, tied head; random weights from
             seed 0), once the Llama model is freed, at serve's
             geometry and trace: serve-gpt-f32 (the model in f32, row 1
             in f32; tokens held by the identity rule to a full-context
             greedy forward, the reference GPT test's anchor) and
             serve-gpt (bf16, contiguous; the same anchor printed with
             its splits, the prefill logits through row 1 within
             ROUTE_TOL of the plain route; 8 decode steps profiled);
             serve-gpt-paged (the contiguous tokens bit for bit) and
             serve-gpt-paged-int8 (int8 KV's 0.9 gate, every split within
             INT8_GAP_STEPS); serve-gpt-prefix and, on the f32 model,
             serve-gpt-f32-prefix (16 requests after one 384-token system
             prompt, sharing on against off: 16 extends and no row-1
             launch shared, each first token the argmax of its extend
             logits, those within ROUTE_TOL of the whole prefill's; the
             identity rule held in f32, printed in bf16); serve-gpt-spec (paged,
             k = 4: the n-gram engine on the whole trace and a GPT
             self-draft on its first 16 tokens a request, each held to
             the paged k=1 tokens by the identity rule); serve-gpt-chunked
             (the chunked trace at chunk 64 against unchunked, paged);
             serve-gpt-recover (a decode fault, recover(), the identity
             rule against the fault-free paged run); serve-gpt-int4 and
             serve-gpt-int8 (weight_only_int4 / _int8: 96 launches of row
             7 or row 8 a model call; the prefill logits through the
             kernel within INT4_ROUTE_TOL of every quantized linear
             through its plain version, the tokens fed through the plain
             route and the last logits through both printed; int8 must
             give the same tokens and logits). The bf16 anchor, prefix
             and int4 pairs split exact and one-step ties of the tied
             head's bf16 logits at 1-2.5% of positions (PERF.md), so
             there the rule's agreement is printed. Row 1 exactly 24
             layers x monolithic prefills in each, no other kernel but
             the quantized runs' own. kernels-int4-gpt: row 7 at GPT's
             four linears, M 1, 16 and 512, beside its bound, plain
             version, torch._weight_int4pack_mm and the bf16 linear.
7. train-flagship — bench.py:build_flagship's whole recipe: GPTTrainer
             at GPT-3 1.3B width and depth (vocab 50304, hidden 2048,
             24 layers, 16 heads of 128, max_seq_len 1024, tied
             embeddings, bf16 masters with stochastic rounding, bf16
             moments, ce_chunks=1, quant8="wgrad" with gelu fused into
             the ffn2 quantize, moment8, remat="save_main"; random
             weights from seed 0) on one fixed batch of 6 x 1024 tokens
             from numpy.random.RandomState(0) (bench.py's): 2 warm-up
             steps, then 5 counted steps with the launch counts set to
             0 just before and read just after, each exactly as
             expected_launches derives it from the code (per step 24
             flash forward, 24 flash backward, 216 row, 72 column and
             144 SR column quantize, one int8-moment AdamW launch for the
             98 leaves with int8 moments and one AdamW launch for the
             other 194). Every loss is finite and step 7's is below step
             1's. Step ms, tokens/s, peak device memory.
8. train-flagship-profile — one step of it under torch.profiler: device
             ms, busy share, top kernels, and device ms by kernel
             family (flash forward and backward, both AdamW kernels,
             rows 10-11, the other quantize kernels and of them row 8's
             and row 12's, int8 and bf16 GEMMs, the rest).
9-10. train-flagship-ln, -profile — the same with fuse_ln_quant=True
             and fuse_bwd_colq=True: per step 168 row, 72 column, 96 SR
             column quantize, 48 row-10 and 48 row-11 launches; its
             losses within LN_TRACK_TOL of train-flagship's, step by
             step.
11-12. train, train-profile — the bf16 path (no int8, no int8 moments,
             no remat): 24 flash forward, 24 flash backward and one
             AdamW launch (all 292 leaves) per step.
13. train-guard — the drift guard at full width (quant8="wgrad",
             moment8, ce_int8, remat off, period 1, threshold 1e-9) for
             4 steps: it falls "wgrad" -> "dgrad" -> exact, each step's
             launches asserted (its tier's plus its probe's), ms per
             step beside the tier.
14. train-check-* — 2 layers of the trainer: one step's loss and every
             gradient through the kernels against the all-plain route
             (every quantize wrapper and the packed attention through
             their plain versions) on the card, within TRAIN_LOSS_TOL
             and TRAIN_GRAD_TOL, for the flagship recipe, the bf16 path,
             fuse_ln_quant with fuse_bwd_colq on and off,
             fuse_gelu_quant=False, ce_int8, quant8=True and "dgrad".

15. train-resnet50 — bench_resnet50.py:build_train_step's recipe:
             resnet50 (weights from seed 0), Momentum(lr 0.01),
             amp.decorate O2 bf16, TrainStep with CrossEntropyLoss, at
             batch 256 x 3x224x224 from numpy.random.RandomState(0): 2
             warm-up and 5 counted steps, exactly 53 launches of each BN
             kernel a step and no other port kernel, finite losses;
             img/s, step ms, peak memory.
16. train-resnet50-profile — one step under torch.profiler: device ms
             by family (cuDNN convolutions forward, dgrad, wgrad and
             their NCHW/NHWC layout passes, the BN kernels, GEMMs,
             elementwise, reductions, the rest), busy share, top
             kernels; the Momentum update alone in a second trace.
17. infer-resnet50 — the bench's inference phase: eval mode, fp32,
             batch 256, torch.inference_mode(), img/s (BN through
             kernel 2 in f32, 53 launches a forward); whether cuDNN ran
             the convolutions in TF32 (PyTorch's default) is printed.
18. train-check-resnet — ResNet-50 cut to one block a stage, batch 64,
             cuDNN deterministic without TF32: one step through the BN
             kernels twice (the same bits) and against the plain BN
             route, in f32 and under O2 (the loss, every gradient, the
             running statistics; tolerances at RESNET_F32_TOL).

Then the line {"phase": "profiler", ...} (how many traces came back
without device time, or short of events, and were taken again, and how
many kernel timings fell back to CUDA events), the
line {"kernels": [...]}
(launches from the train-flagship phase, int4_matmul's from
serve-int4, the BN kernels' from train-resnet50, the f32 flash
backward's from sdpa-f32, every path's beside them, the GPT serving
paths' included; ms and bounds at the trainer's shapes, int4_matmul's
at lm_head's decode shape with GPT-1.3B's four linears beside it, the
f32 flash backward's at D=128), the
nvidia-smi name/power-limit line, and last {"ok": true, "device":
{...}}. Needs a CUDA device and the repository checkout beside this
file; imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12        # dense tensor-core bf16, same source
INT8_OPS_PER_S = 1979e12         # dense tensor-core int8, same source
TF32_FLOPS_PER_S = 495e12        # dense tensor-core TF32, same source
# scalar float32 outside the tensor cores, same source; the quantize
# and AdamW kernels' integer operations (Philox) are counted at it too
SCALAR_OPS_PER_S = 67e12
OUT_TOL = 2e-2                   # kernel vs plain, bf16 out (atol=rtol)
LSE_TOL = 1e-3                   # kernel vs plain, f32 lse (atol)
# flash backward vs plain, bf16 dq/dk/dv (atol=rtol): P and dS rounded
# to bf16 at other places in another summation order
GRAD_TOL = 2e-2
# train-check, kernel route vs all-plain route at 2 layers: the loss
# (abs) and each gradient leaf's ||kernel - plain|| / ||plain||; the
# routes round P and dS to bf16 at other places
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2
# prefill logits, kernel route (bf16 q) vs plain route (f32 q, the
# reference's numerics): 16 layers of bf16 rounding at another place
ROUTE_TOL = 0.125

# torch.profiler on the card's machine now and then returns a CUDA
# trace with no device events (once or twice a run, twice in a row at
# most so far), and once returned one that read a kernel at half its
# time; such a trace, or one whose kernels did not each run a whole
# number of times per timed call, is taken again, its setup included,
# up to PROFILE_TRIES times in all (five short traces in a row were
# seen once, on a plain version's burst of small kernels); a kernel's
# device_ms then falls back to CUDA events around the same calls
PROFILE_TRIES = 5
EMPTY_TRACES = 0
SHORT_TRACES = 0
EVENT_TIMINGS = 0


class TraceError(RuntimeError):
    """torch.profiler returned no whole CUDA trace in PROFILE_TRIES."""

SLOTS, MAX_LEN, MIN_BUCKET = 16, 512, 32
PROMPT_LENS = (24, 48, 96, 180, 300)
NEW_TOKENS = (4, 16, 64, 160)

# the GPT-1.3B training step (bench.py:build_flagship's shape)
TRAIN_B, TRAIN_T, WARMUP, STEPS = 6, 1024, 2, 5


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's line also gets ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the serving engine's spans: torch.profiler ranges that the trace also
# reports on the device, around kernels it counts already
SPAN_NAMES = ("serving.step", "serving.prefill", "serving.chunk_prefill",
              "serving.decode", "serving.verify")


def device_events(prof):
    """The trace's kernels (and copies) on the device; CPU-side ops
    also carry the device time of what they launched, and user ranges
    (the engine's spans) the time of the kernels inside them, so
    summing them too would count it twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and e.key not in SPAN_NAMES]


def traced(torch, setup, with_cpu: bool = False, calls: int = 0):
    """Run ``setup()`` outside the window, then the function it returns
    under torch.profiler; returns (wall s, the trace's device events).
    A trace without device time, or (when ``calls`` names how many calls
    the function makes of a function that launches the same kernels
    each time) one in which some kernel ran a number of times that
    ``calls`` does not divide, is taken again, PROFILE_TRIES times in
    all, then raises: a host clock would time the launches, not the
    card."""
    global EMPTY_TRACES, SHORT_TRACES
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if with_cpu:
        activities.append(ProfilerActivity.CPU)
    for _ in range(PROFILE_TRIES):
        fn = setup()
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = device_events(prof)
        short = [(e.key[:60], e.count) for e in ev
                 if calls and e.count % calls]
        if ev and not short:
            return wall, ev
        if ev:
            SHORT_TRACES += 1
            why = f"kernels short of {calls} calls: {short}"
        else:
            EMPTY_TRACES += 1
            why = f"no CUDA device time ({len(prof.events())} events)"
        print(f"chip_smoke: torch.profiler traced {why}; tracing again",
              file=sys.stderr, flush=True)
    raise TraceError(f"torch.profiler traced no whole CUDA trace in "
                     f"{PROFILE_TRIES} traces")


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the sum of every kernel the call launches,
    from torch.profiler's CUDA trace of ``iters`` calls; when no whole
    trace comes back (TraceError), CUDA events around ``iters`` calls
    (the span on the device, gaps between kernels included), counted in
    the "profiler" line."""
    global EVENT_TIMINGS
    for _ in range(3):
        fn()

    def calls():
        for _ in range(iters):
            fn()
    try:
        _, ev = traced(torch, lambda: calls, calls=iters)
    except TraceError:
        EVENT_TIMINGS += 1
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        calls()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    return sum(e.self_device_time_total for e in ev) / 1e3 / iters


def bound(nbytes: float, flops: float, scalar_ops: float = 0.0,
          int8_ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes'
    time and the operations' time, bf16 tensor-core flops, int8
    tensor-core operations and scalar operations each at their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S + int8_ops / INT8_OPS_PER_S \
        + scalar_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def score_pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def flash_bound(B, S, H, D, causal, itemsize=2):
    """Least time for one forward: q, k, v read once, out written once
    (+ f32 lse), and 2 matmuls of 2 flops per multiply-add over the
    (causal) score pairs this input needs."""
    nbytes = 4 * B * S * H * D * itemsize + B * H * S * 4
    return bound(nbytes, 4 * B * H * score_pairs(S, causal) * D)


def flash_bwd_bound(B, S, H, D, causal, itemsize=2):
    """Least time for one backward: q, k, v, out, dO read once (out for
    delta), lse read, dq, dk, dv written once; five matmuls (S, dP, dV,
    dK, dQ) of 2 flops per multiply-add over the score pairs."""
    nbytes = 8 * B * S * H * D * itemsize + B * H * S * 4
    return bound(nbytes, 10 * B * H * score_pairs(S, causal) * D)


def adamw_bound(n: int):
    """Least time for one leaf of n bf16 parameters: read p, g, m, v and
    write p, m, v (14 bytes each), no matmul."""
    return bound(14 * n, 0)


# scalar operations per element, counted from csrc/quantize.cu and
# csrc/fused_adamw8.cu: the RTN code (|x|, max, divide, round, clip x2),
# the SR code (divide, add, floor, clip x2, the uniform's shift, or and
# subtract), the tanh-gelu (7 multiplies and adds and a tanh, counted as
# 10), and Philox4x32-10 (10 rounds of 2 multiplies and 4 xors/adds per
# 4 words: 15 per element)
RTN_OPS, SR_OPS, GELU_OPS, PHILOX_OPS = 6, 8, 10, 15


def quantize_bound(R, C, itemsize, gelu, sr):
    """Least time for one quantize of [R, C]: x read once, the int8
    codes written, one f32 scale per row or column; the scale math and
    the gelu counted once per element."""
    n = R * C
    nbytes = n * itemsize + n + 4 * max(R, C)
    ops = n * ((SR_OPS + PHILOX_OPS if sr else RTN_OPS)
               + GELU_OPS * bool(gelu))
    return bound(nbytes, 0, scalar_ops=ops)


def flash_flops(B, S, H, D, causal, backward: bool) -> float:
    """The products a call needs: 2 (forward) or 5 (backward) matmuls
    of 2 flops per multiply-add over the (causal) score pairs."""
    return (10 if backward else 4) * B * H * score_pairs(S, causal) * D


def with_rates(row: dict, flops: float) -> dict:
    """``row`` (ms, plain_ms, library_ms, bound_ms) with the achieved
    TFLOP/s of each beside it."""
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        if row.get(key):
            row[key.replace("ms", "tflops")] = flops / row[key] / 1e9
    return row


SASS_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


@functools.lru_cache(maxsize=None)
def sass_text(so) -> list:
    """The toolkit's ``cuobjdump -sass`` of the library ``so``, by line
    (one run a library: the quantize library's is ~18 MB)."""
    from paddle_tpu_torch.ops import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, timeout=300,
                          check=True).stdout.splitlines()


def sass_function(so, kernel: str) -> list:
    """(address, predicated, opcode with its modifiers, operands) of each
    instruction of the kernel whose mangled name contains ``kernel`` in
    the library ``so``, from its SASS (``sass_text``)."""
    ins, found = [], False
    for line in sass_text(so):
        if "Function : " in line:
            if found:
                break
            found = kernel in line
        elif found and (m := SASS_INSTR.search(line)):
            ins.append((int(m.group(1), 16), bool(m.group(2)), m.group(3),
                        m.group(4)))
    if not ins:
        raise AssertionError(f"no SASS for a kernel named *{kernel}* in "
                             f"{so.name}")
    return ins


def branch_target(args: str):
    t = re.search(r"0x([0-9a-f]+)", args)
    return int(t.group(1), 16) if t else None


def sass_loops(so, kernel: str) -> list:
    """The loops of the kernel whose mangled name contains ``kernel`` in
    the library ``so``: for each backward branch, the static
    instructions of its body (NOPs left out) by opcode with its
    modifiers, largest loop first."""
    ins = sass_function(so, kernel)
    loops = []
    for addr, _, op, args in ins:
        target = branch_target(args)
        if op.startswith("BRA") and target is not None and target < addr:
            body = [o for a, _, o, _ in ins
                    if target <= a <= addr and o != "NOP"]
            loops.append({"start": target, "end": addr,
                          "instructions": len(body),
                          "ops": dict(collections.Counter(body))})
    return sorted(loops, key=lambda lp: -lp["instructions"])


def hot_path(ins) -> dict:
    """The instructions a thread executes on a straight-line kernel's
    common path, from its SASS (``sass_function``): the subroutines (the
    CALLed slow paths of the correctly rounded division and square root,
    placed after the kernel's code), the branches to a shuffle's
    divergent fallback (BRA.DIV), the code a conditional branch skips
    around a CALL (the call's set-up), the code after an unconditional
    forward branch up to its target, loop bodies (the rare loops) and
    NOPs left out. Returns {"instructions", "path": their addresses,
    "regions": [(start, end, instructions on the path)] of the other
    forward conditional branches (the code a guard skips), "loops":
    [(start, end)]}."""
    calls = [branch_target(a) for _, _, o, a in ins if o.startswith("CALL")]
    end = min(calls) if calls else ins[-1][0] + 1
    # BRA.DIV leaves for a shuffle's fallback only when the warp has
    # diverged, never on the common path: neither a skip nor a guard
    main = [i for i in ins if i[0] < end and not i[2].startswith("BRA.DIV")]
    loops = [(branch_target(a), addr) for addr, _, o, a in main
             if o.startswith("BRA") and branch_target(a) is not None
             and branch_target(a) <= addr]
    forward = [(addr, branch_target(a), pred) for addr, pred, o, a in main
               if o.startswith("BRA") and branch_target(a) is not None
               and branch_target(a) > addr]
    # a call's set-up: a conditional branch around a CALL and no other
    # conditional branch
    slow = [(a, t) for a, t, pred in forward if pred and any(
        o.startswith("CALL") for x, _, o, _ in main if a < x < t)
        and not any(q and a < x < t for x, q, o, _ in main
                    if o.startswith("BRA"))]
    skipped = [(a + 1, t - 1) for a, t in slow]
    skipped += [(a + 1, t - 1) for a, t, pred in forward if not pred
                and not any(lo <= a <= hi for lo, hi in skipped)]
    skipped += loops

    def hot(a, op):
        return op != "NOP" and not any(lo <= a <= hi for lo, hi in skipped)
    path = [a for a, _, op, _ in main if hot(a, op)]
    regions = [(a, t, sum(a < x < t for x in path)) for a, t, pred in forward
               if pred and (a, t) not in slow
               and not any(a < lo < t for lo, _ in loops)]
    return {"instructions": len(path), "path": path, "regions": regions,
            "loops": loops}


def phase_ptxas(sos):
    """ptxas's report on the flash kernels and row 7's (-Xptxas -v, kept
    beside each library as lib<name>-<hash>.log): each kernel's register
    and spill lines and any wgmma serialisation note, in the order ptxas
    compiled the kernels, by library; and the register kernels of rows
    8 and 10, the one-read column kernel of rows 9, 11 and 12 and row
    13's kernel by name: registers, spills, blocks an SM (returned), and
    so the f32 flash forward and the f32 flash backward's two kernels
    (384 threads) at each tile width."""
    out = {}
    for so in sos:
        name = so.name.split("-")[0][3:]
        if name.startswith(("flash_attention", "int4_matmul")):
            out.setdefault(name, []).extend(
                ln.replace("ptxas info    :", "").strip()
                for ln in so.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln or "C75" in ln)
    kernels, f32, bwd32 = {}, {}, {}
    for so in sos:
        if so.name.startswith(("libfused_adamw8-", "libquantize-")):
            kernels.update(ptxas_kernels(so.with_suffix(".log"),
                                         ("adamw8_rows_kernel",
                                          "rowq_regs_kernel",
                                          "rowq_ln_regs_kernel",
                                          "col_cluster_kernel")))
        if so.name.startswith("libflash_attention_fwd-"):
            f32 = ptxas_kernels(so.with_suffix(".log"),
                                ("flash_fwd_f32_kernel",))
        if so.name.startswith("libflash_attention_bwd-"):
            bwd32 = ptxas_kernels(so.with_suffix(".log"),
                                  ("flash_bwd_dkdv_f32_kernel",
                                   "flash_bwd_dq_f32_kernel"), threads=384)
    emit({"phase": "ptxas", "lines": out, "rows_8_to_13": kernels,
          "flash_fwd_f32": f32, "flash_bwd_f32": bwd32})
    if len(bwd32) != 12:
        raise AssertionError(f"ptxas reported {len(bwd32)} of the f32 flash "
                             f"backward's 12 kernels (2 passes x 6 widths)")
    if not out.get("int4_matmul") or not kernels or not any(
            k.startswith("flash_attention") and v for k, v in out.items()):
        raise AssertionError("no -Xptxas -v report for the flash, int4, "
                             "quantize or row 13 kernels")
    return kernels


def ptxas_kernels(log, names, threads: int = 256) -> dict:
    """From a -Xptxas -v log, each kernel whose mangled name contains one
    of ``names``: its registers, spill bytes (stores + loads) and the
    ``threads``-thread blocks an SM holds by registers (65,536 a SM,
    allocated 8 a thread at a time). A kernel templated on one int (the
    flash kernels' tile width) is named ``name<width>``."""
    out, kernel = {}, None
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"'(\S+)'", ln)
            hit = [n for n in names if m and n in m.group(1)]
            # the kernel's name and template arguments, mangled
            kernel = m.group(1)[m.group(1).index(hit[0]):].split("EEEv")[0] \
                if hit else None
            width = kernel and re.fullmatch(r"(\w+?)ILi(\d+)", kernel)
            if width:
                kernel = f"{width.group(1)}<{width.group(2)}>"
        elif kernel and (m := re.search(r"(\d+) bytes spill stores, "
                                        r"(\d+) bytes spill loads", ln)):
            out.setdefault(kernel, {})["spill_bytes"] = \
                int(m.group(1)) + int(m.group(2))
        elif kernel and (m := re.search(r"Used (\d+) registers", ln)):
            regs = int(m.group(1))
            out.setdefault(kernel, {}).update(
                registers=regs,
                blocks_per_sm=min(8, 65536 // (-(-regs // 8) * 8 * threads)))
    return out


def qkv_views(torch, B, S, H, D, g):
    """q, k, v as the trainer hands them to the kernels: strided views
    of one packed [B, S, 3*H*D] projection."""
    qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=g)
    return qkv.bfloat16().view(B, S, 3, H, D).unbind(2)


def phase_kernels(torch, F):
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # (B, S, H, D, causal, packed): the serving prefill buckets and
    # ragged lengths at Llama-1B's heads, one non-causal, one D=64 and
    # one D=256 case, and the GPT-1.3B trainer's packed shape
    cases = [(1, s, 16, 128, True, False)
             for s in (24, 32, 64, 128, 256, 300, 512)]
    cases += [(1, 512, 16, 128, False, False), (1, 128, 16, 64, True, False),
              (1, 300, 8, 256, True, False),
              (TRAIN_B, TRAIN_T, 16, 128, True, True)]
    rows = []
    for B, S, H, D, causal, packed in cases:
        if packed:
            q, k, v = qkv_views(torch, B, S, H, D, g)
        else:
            q, k, v = (torch.randn(B, S, H, D, device=dev, generator=g)
                       .bfloat16() for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), atol=OUT_TOL,
                                   rtol=OUT_TOL)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound_ms, bound_by = flash_bound(B, S, H, D, causal)
        kern = lambda: flash_attention_fwd(q, k, v, causal=causal)
        plain = lambda: flash_attention_fwd_plain(q, k, v, causal=causal)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)
        rows.append(with_rates({
            "B": B, "S": S, "H": H, "D": D, "causal": causal,
            "packed": packed, "max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": device_ms(torch, kern, 20),
            "plain_ms": device_ms(torch, plain, 5),
            "library_ms": device_ms(torch, lib, 20),
            "bound_ms": bound_ms, "bound_by": bound_by},
            flash_flops(B, S, H, D, causal, False)))
    emit({"phase": "kernels", "name": "flash_attention_fwd",
          "tolerance": {"out_atol_rtol": OUT_TOL, "lse_atol": LSE_TOL},
          "cases": rows, "padded_prefix": padded_prefix(torch, g)})
    return rows


def padded_prefix(torch, g) -> list:
    """The law the serving engine's bucket padding relies on, at the
    kernel's own level: rows 0..299 of a causal S=512 call whose
    positions past 300 are padding (other random values) equal the
    S=300 call bit for bit, out and lse, at the wgmma kernel's widths
    128 (one and two consumer warpgroups) and 64 in bf16, and the f32
    kernel's 128."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    rows = []
    for B, H, D, dt in ((1, 16, 128, torch.bfloat16),
                        (4, 64, 128, torch.bfloat16),
                        (1, 8, 64, torch.bfloat16), (1, 8, 128, torch.float32)):
        q, k, v = (torch.randn(B, 512, H, D, device="cuda", generator=g)
                   .to(dt) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, causal=True,
                                       return_lse=True)
        cut = [t[:, :300].contiguous() for t in (q, k, v)]
        out3, lse3 = flash_attention_fwd(*cut, causal=True, return_lse=True)
        torch.cuda.synchronize()
        same = bool(torch.equal(out[:, :300], out3)
                    and torch.equal(lse[..., :300], lse3))
        rows.append({"B": B, "H": H, "D": D, "dtype": str(dt)[6:], "S": 512,
                     "prefix": 300, "bitwise": same})
        if not same:
            raise AssertionError(f"flash forward {B, H, D}: rows 0..299 of "
                                 f"the padded S=512 call differ from the "
                                 f"S=300 call")
    return rows


def phase_kernels_bwd(torch, F):
    """The flash backward against its plain version: the trainer's
    packed shape (q, k, v, dq, dk, dv all views of packed buffers),
    separate [B, S, H, D] tensors at that shape, a ragged S, D=64 and
    D=256. Two runs give the same bits (no atomics)."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [(TRAIN_B, TRAIN_T, 16, 128, True, True),
             (TRAIN_B, TRAIN_T, 16, 128, True, False),
             (1, 300, 16, 128, True, False), (2, 512, 16, 64, True, False),
             (1, 300, 8, 256, True, False)]
    rows = []
    for B, S, H, D, causal, packed in cases:
        if packed:
            q, k, v = qkv_views(torch, B, S, H, D, g)
            dqkv = torch.empty(B, S, 3 * H * D, device=dev,
                               dtype=torch.bfloat16)
            grads = dict(zip(("dq", "dk", "dv"),
                             dqkv.view(B, S, 3, H, D).unbind(2)))
        else:
            q, k, v = (torch.randn(B, S, H, D, device=dev, generator=g)
                       .bfloat16() for _ in range(3))
            grads = {}
        do = torch.randn(B, S, H, D, device=dev, generator=g).bfloat16()
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        kern = lambda: flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           **grads)
        first = [t.clone() for t in kern()]
        again = kern()
        plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(first, again))
        if not repeat:
            raise AssertionError(f"flash backward {B, S, H, D}: two runs "
                                 f"gave different bits")
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), first, plain):
            errs.append((a.float() - b.float()).abs().max().item())
            torch.testing.assert_close(a.float(), b.float(), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, msg=lambda m: (
                                           f"{name} {B, S, H, D}: {m}"))
        # the library's backward alone: SDPA's forward once, then its
        # autograd backward timed on the same dO
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        lib_do = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                          retain_graph=True)
        bound_ms, bound_by = flash_bwd_bound(B, S, H, D, causal)
        rows.append(with_rates({
            "B": B, "S": S, "H": H, "D": D, "causal": causal,
            "packed": packed, "max_abs_err": max(errs),
            "bitwise_repeatable": repeat,
            "ms": device_ms(torch, kern, 10),
            "plain_ms": device_ms(torch, lambda: flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal), 3),
            "library_ms": device_ms(torch, lib, 10),
            "bound_ms": bound_ms, "bound_by": bound_by},
            flash_flops(B, S, H, D, causal, True)))
        del first, again, plain, lib_out
    emit({"phase": "kernels", "name": "flash_attention_bwd",
          "tolerance": {"grad_atol_rtol": GRAD_TOL}, "cases": rows})
    return rows


def gpt_leaf_shapes() -> list:
    """The GPT-1.3B trainer's 292 leaves in its flatten order (the
    leaf_id order): (path, shape)."""
    from paddle_tpu_torch.models.gpt import (block_shapes, flatten_params,
                                             top_shapes)
    cfg = gpt_1p3b_config()
    tree = dict(top_shapes(cfg))
    tree["blocks"] = {f"layer_{i:03d}": block_shapes(cfg)
                      for i in range(cfg.num_layers)}
    return flatten_params(tree)


def adamw_leaf(torch, shape, gen):
    """bf16 p, g, m, v of a leaf, at the scales of a training run."""
    def normal(scale):
        return (scale * torch.randn(shape, device="cuda", generator=gen)
                ).bfloat16()
    return (normal(0.02), normal(1e-3), normal(1e-4),
            (1e-8 * torch.rand(shape, device="cuda", generator=gen)
             ).bfloat16())


def check_leaves_bitwise(torch, name, got, leaves, ids, sc, hp) -> float:
    """Each leaf's (p, m, v) from the list kernel against the per-leaf
    plain version run on the leaf's inputs. Returns the plain version's
    ms over the list: CUDA events around each leaf's call, summed."""
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update_plain
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    plain_ms = 0.0
    for (p, g, m, v), i, out in zip(leaves, ids, got):
        p, m, v = p.clone(), m.clone(), v.clone()
        start.record()
        want = fused_adamw_update_plain(p, g, m, v, sc, leaf_id=i, **hp)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        for part, a, b in zip("pmv", out, want):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{name}: leaf {i} {tuple(p.shape)} {part} differs from "
                    f"the plain version in {int((a != b).sum())} elements")
    return plain_ms


def list_update(torch, leaves, ids, sc, hp) -> list:
    """fused_adamw_update_leaves on copies of ``leaves``: each leaf's
    updated (p, m, v)."""
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update_leaves
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    ps, ms, vs = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    fused_adamw_update_leaves(ps, gs, ms, vs, sc, ids, **hp)
    torch.cuda.synchronize()
    return list(zip(ps, ms, vs))


def host_ms(torch, fn, calls: int = 20) -> float:
    """Host ms a call of ``fn``: the wall time of ``calls`` calls
    enqueued back to back (the card runs behind), before the sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def phase_kernels_adamw(torch):
    """AdamW on the trainer's 2048x8192 (win) and 50304x2048 (wte)
    leaves, bf16 p, g, m, v, stochastic rounding on: p, m, v bit for bit
    against the plain version; the yardstick is torch.optim.AdamW
    (fused=True) on the same leaf, which does no SR. Then the kernel's
    list entry: GPT-1.3B's 292 leaves in one launch, every leaf's p, m,
    v bit for bit against the per-leaf plain version, timed (through an
    AdamWLeaves table kept as the trainer keeps it) beside the per-leaf
    plain version, AdamW(fused=True) over the same list and the bound,
    with the host ms a call of the list entry and of the kept table;
    the flagship's
    194 leaves without int8 moments (its row-14 launch) timed alone; and
    a list with odd lengths and views whose bases are not 16-byte
    aligned, bit for bit."""
    from paddle_tpu_torch.ops.fused_adamw import (AdamWLeaves,
                                                  fused_adamw_update,
                                                  fused_adamw_update_leaves,
                                                  fused_adamw_update_plain,
                                                  moment8_eligible)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    hp = dict(lr=3e-4, wd=0.1, b1=0.9, b2=0.95, eps=1e-8, stoch_round=True,
              seed=3)
    sc = torch.tensor([0.5, 1 / (1 - 0.9 ** 3), 1 / (1 - 0.95 ** 3), 1.0],
                      device=dev)
    rows = []
    for shape in ((2048, 8192), (50304, 2048)):
        p, grad, m, v = adamw_leaf(torch, shape, g)
        ref = fused_adamw_update_plain(p.clone(), grad, m.clone(),
                                       v.clone(), sc, leaf_id=291, **hp)
        got = fused_adamw_update(p.clone(), grad, m.clone(), v.clone(), sc,
                                 leaf_id=291, **hp)
        torch.cuda.synchronize()
        for name, a, b in zip("pmv", got, ref):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"fused_adamw {shape}: {name} differs from the plain "
                    f"version in {int((a != b).sum())} elements")
        changed = (got[0] != p).float().mean().item()
        del got, ref
        lib_p = p.clone().requires_grad_()
        lib_p.grad = grad
        opt = torch.optim.AdamW([lib_p], lr=3e-4, betas=(0.9, 0.95),
                                weight_decay=0.1, eps=1e-8, fused=True)
        bound_ms, bound_by = adamw_bound(p.numel())
        rows.append({
            "shape": list(shape), "bitwise_equal": True, "max_abs_err": 0.0,
            "p_changed_share": changed,
            "ms": device_ms(torch, lambda: fused_adamw_update(
                p, grad, m, v, sc, leaf_id=291, **hp), 10),
            "plain_ms": device_ms(torch, lambda: fused_adamw_update_plain(
                p, grad, m, v, sc, leaf_id=291, **hp), 3),
            "library_ms": device_ms(torch, opt.step, 10),
            "bound_ms": bound_ms, "bound_by": bound_by})
        del opt, lib_p, p, grad, m, v
    torch.cuda.empty_cache()

    # the bf16 trainer's whole list, one launch
    shapes = [shape for _, shape in gpt_leaf_shapes()]
    leaves = [adamw_leaf(torch, shape, g) for shape in shapes]
    ids = list(range(len(leaves)))
    plain_ms = check_leaves_bitwise(
        torch, "fused_adamw, 292 leaves",
        list_update(torch, leaves, ids, sc, hp), leaves, ids, sc, hp)
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    n = sum(p.numel() for p in ps)
    small = [i for i, p in enumerate(ps) if not moment8_eligible(p)]
    lib_ps = [p.clone().requires_grad_() for p in ps]
    for p, grad in zip(lib_ps, gs):
        p.grad = grad
    opt = torch.optim.AdamW(lib_ps, lr=3e-4, betas=(0.9, 0.95),
                            weight_decay=0.1, eps=1e-8, fused=True)
    b_ms, b_by = adamw_bound(n)
    b_small = adamw_bound(sum(ps[i].numel() for i in small))
    kept = AdamWLeaves(ps, ms, vs, ids)        # the trainer's way
    whole = {
        "leaves": len(ps), "params": n, "bitwise_equal": True,
        "max_abs_err": 0.0,
        "ms": device_ms(torch, lambda: kept.update(gs, sc, **hp), 5),
        "library_ms": device_ms(torch, opt.step, 5),
        "bound_ms": b_ms, "bound_by": b_by,
        "host_ms": {
            "list_entry": host_ms(torch, lambda: fused_adamw_update_leaves(
                ps, gs, ms, vs, sc, ids, **hp)),
            "kept_table": host_ms(torch, lambda: kept.update(gs, sc, **hp))},
        "flagship_leaves": len(small),
        "flagship_params": sum(ps[i].numel() for i in small),
        "flagship_ms": device_ms(torch, lambda: fused_adamw_update_leaves(
            [ps[i] for i in small], [gs[i] for i in small],
            [ms[i] for i in small], [vs[i] for i in small], sc, small,
            **hp), 20),
        "flagship_bound_ms": b_small[0],
        # timed in the check above: on the H100, the first traces after
        # the plain version ran over the list back to back (~12,000
        # launches) came back short of kernel events, five in a row
        "plain_ms": plain_ms,
        "plain_timing": "cuda events around each leaf's call, summed"}
    del opt, lib_ps, leaves, ps, gs, ms, vs, kept
    torch.cuda.empty_cache()

    # odd lengths and misaligned views (a flat leaf less its first
    # element), one launch
    odd = [adamw_leaf(torch, (n_,), g) for n_ in (1, 7, 2049, 100003)]
    odd.append(tuple(t[1:] for t in adamw_leaf(torch, (65537,), g)))
    odd.append(tuple(t[3:] for t in adamw_leaf(torch, (12291,), g)))
    if not all(t.data_ptr() % 16 for leaf in odd[-2:] for t in leaf):
        raise AssertionError("fused_adamw odd case: a view meant to be "
                             "misaligned is 16-byte aligned")
    odd_ids = [5, 17, 200, 3, 99, 42]
    check_leaves_bitwise(torch, "fused_adamw, odd and misaligned leaves",
                         list_update(torch, odd, odd_ids, sc, hp), odd,
                         odd_ids, sc, hp)
    whole["odd_and_misaligned"] = {
        "leaves": [int(t[0].numel()) for t in odd],
        "misaligned": sum(bool(t[0].data_ptr() % 16) for t in odd),
        "bitwise_equal": True}
    emit({"phase": "kernels", "name": "fused_adamw", "cases": rows,
          "gpt_1p3b_list": whole})
    return rows, whole


# the GPT-1.3B trainer's quantize shapes (M = 6144 tokens, D = 2048,
# F = 8192): (rows, cols, gelu, what) per kernel
M_TOK, D_MODEL, F_FFN = TRAIN_B * TRAIN_T, 2048, 8192
ROWQ_CASES = [(M_TOK, D_MODEL, False, "activation (qkv, ffn1 fwd)"),
              (M_TOK, F_FFN, True, "ffn1_out, gelu fused (ffn2 fwd)"),
              (M_TOK, 3 * D_MODEL, False, "g of qkv (dgrad)"),
              (M_TOK, F_FFN, False, "g of ffn1 (dgrad)"),
              (M_TOK, D_MODEL, False, "g of ffn2 (dgrad)"),
              (D_MODEL, 3 * D_MODEL, False, "wqkv along axis 1 (dgrad)"),
              (D_MODEL, F_FFN, False, "win along axis 1 (dgrad)"),
              (F_FFN, D_MODEL, False, "wout along axis 1 (dgrad)")]
# and Int8Linear's dynamic quantize on the decode path (Llama-1B through
# weight_only_int8 and generate(), prompt 64, batch 1 and 8): prefill
# M = 64 and 512, decode steps M = 1 and 8; K = 2048 (the hidden width)
# and 5504 (down_proj's input)
ROWQ_CASES += [(M, K, False, f"Int8Linear x, decode path (M={M})")
               for M in (1, 8, 64, 512) for K in (2048, 5504)]
COLQ_CASES = [(D_MODEL, 3 * D_MODEL, False, "wqkv (fwd)"),
              (D_MODEL, F_FFN, False, "win (fwd)"),
              (F_FFN, D_MODEL, False, "wout (fwd)"),
              (50304, D_MODEL, False,
               "tied head chunk [V, D] (ce_int8 dx, ce_chunks=1)")]
SRQ_CASES = [(M_TOK, D_MODEL, False, "LN output (qkv, ffn1 wgrad)"),
             (M_TOK, F_FFN, True, "ffn1_out, gelu fused (ffn2 wgrad)"),
             (M_TOK, 3 * D_MODEL, False, "g of qkv (wgrad)"),
             (M_TOK, F_FFN, False, "g of ffn1 (wgrad)"),
             (M_TOK, D_MODEL, False, "g of ffn2 (wgrad)")]
SR_UNBIASED_SEEDS = 256


def quant_input(torch, R, C, gen, zero_col: bool):
    """bf16 test data of the trainer's kind: a normal with per-column
    spread over four decades (so the per-column scales differ), and one
    all-zero column (its scale must be 1/127, its codes 0)."""
    spread = torch.logspace(-4, 0, C, device="cuda")[
        torch.randperm(C, device="cuda", generator=gen)]
    x = (torch.randn(R, C, device="cuda", generator=gen) * spread).bfloat16()
    if zero_col:
        x[:, C // 3] = 0
    return x


def check_equal(torch, name, got, want) -> None:
    for part, a, b in zip(("codes", "scales"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name}: kernel {part} differ from the plain version in "
                f"{int((a != b).sum())} of {a.numel()} elements")


def sr_laws(torch, name, x, q, scale, act) -> dict:
    """Row 12's laws on the card: every code floor(v) or floor(v) + 1 for
    v = act(x) / scale (clipped to [-127, 127]), and an all-zero column at
    scale 1/127 with codes 0. floor(v) + 1 is ceil(v) but where v is an
    integer: there the f32 sum v + u (u <= 1 - 2^-23, the reference's
    uniform) can round up to v + 1, as it does in the reference's
    arithmetic; such codes are counted."""
    from paddle_tpu_torch.ops.quant_matmul import _apply_act
    v = _apply_act(x.float(), act) / scale
    qf = q.float()
    lo = torch.floor(v)
    ok = (qf == lo.clamp(-127, 127)) | (qf == (lo + 1).clamp(-127, 127))
    if not bool(ok.all()):
        bad = (~ok).nonzero()[:4].tolist()
        raise AssertionError(
            f"{name}: {int((~ok).sum())} SR codes are neither floor(v) nor "
            f"floor(v) + 1 of v = x / scale, e.g. at {bad}: v "
            f"{[v[i, j].item() for i, j in bad]}, codes "
            f"{[qf[i, j].item() for i, j in bad]}")
    up = int(((v == lo) & (qf == (lo + 1).clamp(-127, 127))
              & (qf != lo.clamp(-127, 127))).sum())
    zero = (x == 0).all(0)
    if bool(zero.any()) and not (
            bool((scale[0, zero] == 1.0 / 127.0).all())
            and bool((q[:, zero] == 0).all())):
        raise AssertionError(f"{name}: an all-zero column is not at scale "
                             f"1/127 with codes 0")
    return {"floor_or_ceil": True, "integer_quotients_rounded_up": up,
            "zero_columns": int(zero.sum())}


def sr_unbiased(torch, quantize, exact) -> dict:
    """An SR quantize's mean over SR_UNBIASED_SEEDS seeds equals the
    exact values within 4 standard errors; ``quantize(seed)`` returns
    (codes, scale) of ``exact``."""
    acc = torch.zeros_like(exact, dtype=torch.float64)
    for seed in range(SR_UNBIASED_SEEDS):
        q, scale = quantize(seed * 7919 + 1)
        acc += (q.float() * scale).double()
    mean = acc / SR_UNBIASED_SEEDS
    # one draw's error is uniform within one step (scale): sd <= scale/2
    se = scale.double() * 0.5 / math.sqrt(SR_UNBIASED_SEEDS)
    worst = ((mean - exact.double()).abs() / se).max().item()
    bias = ((mean - exact.double()) / scale.double()).mean().item()
    if worst > 4 * math.sqrt(2 * math.log(exact.numel())) or \
            abs(bias) > 4 * 0.5 / math.sqrt(SR_UNBIASED_SEEDS * exact.numel()):
        raise AssertionError(f"SR mean over seeds: worst {worst} standard "
                             f"errors, mean bias {bias} steps")
    return {"seeds": SR_UNBIASED_SEEDS, "worst_se": worst,
            "mean_bias_steps": bias}


def sr_unbiased_gelu(torch, gen) -> dict:
    """Row 12 unbiased: [1024, 256] bf16, gelu fused."""
    from paddle_tpu_torch.ops.quant_matmul import (_apply_act,
                                                   sr_quantize_colwise)
    x = quant_input(torch, 1024, 256, gen, zero_col=False)
    return sr_unbiased(torch, lambda seed: sr_quantize_colwise(
        x, seed, act="gelu"), _apply_act(x.float(), "gelu"))


def sm_clock_hz() -> float:
    """The card's top SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sr_instructions(torch, pro: int) -> dict:
    """The SR one-read kernel (bf16 x) from its SASS, with the prologue
    ``pro`` (0 none and 1 gelu: row 12; 2 LayerNorm: row 11): the
    instructions an element of the cast (the loop that casts one item, 4
    columns x 4 rows, Philox included, with LayerNorm h taken again:
    the loop with the wide multiplies and no call to __fdiv_rn's slow
    path) and of the maxima pass (the loop that reads 16-byte vectors of
    x, 8 values each, from shared memory; with gelu, act(x) too; with
    LayerNorm, h and the rows' statistics). The compute floor: those
    instructions at one warp instruction a clock on each of an SM's 4
    schedulers at the card's top clock."""
    from paddle_tpu_torch.ops import _build
    loops = sass_loops(_build.build(["quantize"])[0],
                       f"col_cluster_kernelI13__nv_bfloat16Li{pro}ELb1E")

    def n(loop, prefix):
        return sum(v for op, v in loop["ops"].items() if op.startswith(prefix))
    cast = max((lp for lp in loops if n(lp, "IMAD.WIDE") >= 40
                and n(lp, "CALL") == 0), key=lambda lp: lp["instructions"])
    pass1 = max((lp for lp in loops if n(lp, "LDS.128")
                 and n(lp, "IMAD.WIDE") < 8), key=lambda lp: n(lp, "LDS.128"))
    per = {"cast": cast["instructions"] / 16,
           "maxima": pass1["instructions"] / (8 * n(pass1, "LDS.128"))}
    return {"instructions_per_value": per,
            "philox_per_value": (n(cast, "IMAD.WIDE")
                                 + n(cast, "LOP3.LUT")) / 16,
            "per_value": per["cast"] + per["maxima"]}


def row8_route(M: int, K: int):
    """Row 8's kernel for [M, K] as csrc/quantize.cu launch_rows picks
    it from the shape: (a warp a row?, 16-value units a thread), or None
    for the rows staged in shared memory."""
    if K % 16:
        return None
    G, warp = (32, True) if K <= 2048 and M >= 1024 else (256, False)
    if K > 16 * 4 * G:
        return None
    units = K // 16
    return warp, 1 if units <= G else 2 if units <= 2 * G else 4


def rowq_instructions(torch, cases) -> dict:
    """Row 8's SASS instructions a value (bf16 x) on the common path of
    each register kernel ``cases`` take (no value out of the fast
    division's range), by (gelu, warp, units a thread): the kernel's
    instructions over its values a thread."""
    from paddle_tpu_torch.ops import _build
    so = _build.build(["quantize"])[0]
    out = {}
    for M, K, gelu, _ in cases:
        route = row8_route(M, K)
        if route is None or (gelu, *route) in out:
            continue
        warp, nu = route
        ins = sass_function(so, f"rowq_regs_kernelI13__nv_bfloat16Li"
                            f"{int(gelu)}ELi{nu}ELb{int(warp)}E")
        out[gelu, warp, nu] = hot_path(ins)["instructions"] / (16 * nu)
    return out


def colq_instructions(torch) -> dict:
    """Row 9's one-read kernel (bf16 x, RTN) from its SASS: the
    instructions a value of its three innermost loops, each counted over
    the values one pass of its body takes: the copies (cp.async of
    16-byte vectors, 8 values each), the maxima (16-byte vectors read
    back from shared memory) and the cast (an item of 4 columns x 16
    rows, 64 values, stored as 4 16-byte runs: the loop with the 16-byte
    global stores and no call to __fdiv_rn's slow path)."""
    from paddle_tpu_torch.ops import _build
    loops = sass_loops(_build.build(["quantize"])[0],
                       "col_cluster_kernelI13__nv_bfloat16Li0ELb0E")

    def n(loop, prefix):
        return sum(v for op, v in loop["ops"].items() if op.startswith(prefix))

    def innermost(lp):
        return not any(o is not lp and lp["start"] <= o["start"]
                       and o["end"] <= lp["end"] for o in loops)

    def pick(what, keep):
        found = [lp for lp in loops if innermost(lp) and keep(lp)]
        if not found:
            raise AssertionError(f"row 9 SASS: no {what} loop among "
                                 f"{[lp['ops'] for lp in loops]}")
        return max(found, key=lambda lp: lp["instructions"])
    copy = pick("copy", lambda lp: n(lp, "LDGSTS"))
    maxima = pick("maxima", lambda lp: n(lp, "LDS.128")
                  and not n(lp, "STG") and not n(lp, "LDGSTS"))
    cast = pick("cast", lambda lp: n(lp, "STG.E.128") >= 4
                and not n(lp, "CALL"))
    per = {"copy": copy["instructions"] / (8 * n(copy, "LDGSTS")),
           "maxima": maxima["instructions"] / (8 * n(maxima, "LDS.128")),
           "cast": cast["instructions"] / (64 * (n(cast, "STG.E.128") // 4))}
    return {"instructions_per_value": per, "per_value": sum(per.values())}


def rowln_instructions(torch) -> dict:
    """Row 10's kernel at the trainer's K = 2048 (a warp a row, 64 bf16
    values a lane) from its SASS: the common path of the loop that walks
    rows (``hot_path`` over its body: the CALLed slow paths of the
    correctly rounded divisions and square root and their set-up, and
    the loop that casts a unit again through __fdiv_rn, left out) over
    the 64 values a lane takes a row. The block's one load of g and b,
    before the loop, is left out."""
    from paddle_tpu_torch.ops import _build
    ins = sass_function(_build.build(["quantize"])[0],
                        "rowq_ln_regs_kernelI13__nv_bfloat16Li4ELb1E")
    loops = sass_loops(_build.build(["quantize"])[0],
                       "rowq_ln_regs_kernelI13__nv_bfloat16Li4ELb1E")
    rows = loops[0]                       # the largest: the row loop
    body = [i for i in ins if rows["start"] <= i[0] < rows["end"]]
    path = hot_path(body)
    return {"row_loop_instructions": rows["instructions"],
            "per_value": path["instructions"] / 64}


def adamw8_instructions(torch) -> dict:
    """Row 13's SASS instructions (bf16 p and g, SR) a thread executes on
    the common path, from its straight-line code: the leaf search (its
    loop body times ceil(log2 98)), the loads, the block steps it keeps
    (4) of 8 elements in each pass, the reduction of as many rows and
    the scales. A block of one row of C < 8192 runs ceil(C / 2048) steps
    and reduces one row: the guarded step regions past those, the
    reduction's guarded regions of the rows past the block's and the
    division set-ups of steps that start no row are left out.
    ``per_param(C)``: those instructions over the elements a thread
    takes, at that C."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops.fused_adamw import _lib8, _rows_per_block
    ins = sass_function(_build.build(["fused_adamw8"])[0],
                        "adamw8_rows_kernelI13__nv_bfloat16S1_Lb1E")
    block = _lib8().ptt_fused_adamw8_block_elements()
    kept = block // 2048                     # block steps a thread keeps
    path = hot_path(ins)
    ops = {a: op for a, _, op, _ in ins}
    hot = set(path["path"])
    steps = sorted(r for r in path["regions"] if r[2] >= 100)
    def small(*prefixes):
        return sorted(r for r in path["regions"] if r[2] < 100 and any(
            ops[a].startswith(prefixes) for a in hot if r[0] < a < r[1]))
    # the reduction's 4 rows: guarded shuffles, then guarded reads of the
    # warps' maxima; and the set-up of steps 1-3's divisions (a row's
    # first step)
    slots, divs = small("SHFL", "LDS"), small("MUFU.RCP")
    if len(steps) != 2 * kept:
        raise AssertionError(f"fused_adamw8 SASS: {len(steps)} guarded step "
                             f"regions, expected {kept} a pass: {steps}")
    search = min(path["loops"])
    body = sum(search[0] <= a <= search[1] and op != "NOP"
               for a, _, op, _ in ins)
    full = path["instructions"] + body * math.ceil(math.log2(98))
    pass1, pass2 = [r[2] for r in steps[:kept]], [r[2] for r in steps[kept:]]

    def per_param(C: int) -> float:
        rpb = _rows_per_block(C, block)
        ns = kept if rpb > 1 else -(-C // 2048)
        if ns > kept:
            raise ValueError(f"C={C}: past the steps a thread keeps")
        unused = sum(pass1[ns:]) + sum(pass2[ns:])
        if len(slots) == 2 * kept:  # rows rpb.. of those a block may hold
            unused += sum(r[2] for j, r in enumerate(slots)
                          if j % kept >= rpb)
        if len(divs) == kept - 1:   # steps 1.. that start no row
            unused += sum(r[2] for k, r in enumerate(divs, 1)
                          if (k * rpb) % kept)
        return (full - unused) / (8 * ns)
    return {"per_thread_all_steps": full, "pass1_step": pass1,
            "pass2_step": pass2, "leaf_search_loop": body,
            "reduction_row_regions": [r[2] for r in slots],
            "division_setup_regions": [r[2] for r in divs],
            "per_param_at": {C: per_param(C) for C in (2048, 6144, 8192)},
            "per_param": per_param}


def instruction_floor_ms(torch, per_value: float, values: int,
                         clock_hz: float) -> float:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return per_value * values / (sms * 4 * 32 * clock_hz) * 1e3


def colq_routes_check(torch, gen) -> list:
    """Both of row 9's routes against the plain version, bit for bit: R
    at the one-read limit and 16 rows past it (the two-pass pair), bf16
    x, 64 columns with an all-zero one."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    limit = qm.cols_one_read_max_rows(torch.bfloat16)
    out = []
    for R in (limit, limit + 16):
        x = quant_input(torch, R, 64, gen, zero_col=True)
        check_equal(torch, f"quantize_cols {R}x64", qm.quantize_cols(x),
                    qm.quantize_cols_plain(x))
        out.append({"rows": R, "route": colq_route(torch, R),
                    "bitwise_equal": True})
        del x
    return out


def colq_route(torch, R: int) -> str:
    """Row 9's route for R rows of bf16 x, as the wrapper picks it."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    return "one read" if R <= qm.cols_one_read_max_rows(torch.bfloat16) \
        else "two-pass"


def sr_routes_check(torch, gen) -> list:
    """Both of row 12's routes against the plain version, bit for bit:
    R at the one-read limit and 16 rows past it (the two-pass pair), bf16
    x without and with gelu, 64 columns with an all-zero one."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    out = []
    for gelu in (False, True):
        act = "gelu" if gelu else None
        limit = qm.sr_cols_one_read_max_rows(torch.bfloat16, act)
        for R in (limit, limit + 16):
            x = quant_input(torch, R, 64, gen, zero_col=True)
            check_equal(torch, f"sr_quantize_colwise {R}x64 gelu={gelu}",
                        qm.sr_quantize_colwise(x, 5, act),
                        qm.sr_quantize_colwise_plain(x, 5, act))
            out.append({"rows": R, "gelu": gelu,
                        "route": "one read" if R <= limit else "two-pass",
                        "bitwise_equal": True})
            del x
    return out


def phase_sass(torch) -> dict:
    """The SASS instructions rows 8 to 13 execute a value (the
    toolkit's cuobjdump over each library) and the card's top SM clock,
    for the instruction floors the kernel phases report. Run before any
    trace: on the card's machine, traces taken right after these
    subprocesses came back short of kernel records, again and again."""
    sass = {"clock_hz": sm_clock_hz(),
            "row11": sr_instructions(torch, 2),
            "row12": {gelu: sr_instructions(torch, int(gelu))
                      for gelu in (False, True)},
            "row8": rowq_instructions(torch, ROWQ_CASES),
            "row9": colq_instructions(torch),
            "row10": rowln_instructions(torch),
            "row13": adamw8_instructions(torch)}
    emit({"phase": "sass", "clock_mhz": sass["clock_hz"] / 1e6,
          "row8_per_value": {f"gelu={g} warp={w} units={u}": v
                             for (g, w, u), v in sass["row8"].items()},
          "row9": sass["row9"], "row10": sass["row10"],
          "row11": sass["row11"], "row12": sass["row12"],
          "row13": {k: v for k, v in sass["row13"].items()
                    if k != "per_param"}})
    return sass


def phase_kernels_quant(torch, sass):
    """Kernel rows 8, 9 and 12 at every trainer shape: codes and scales
    bit for bit against the plain versions (the SR kernel draws the
    plain version's Philox words), row 12's laws on the card, device
    ms of kernel and plain version, and the bound. Row 8 also: its route
    and the instructions a value from its SASS with the compute floor
    they set. Rows 9 and 12 (one launch, x read once, up to a row
    limit) also: the route, the two-pass pair's ms on the same input
    (the route an R past the limit takes), the instructions a value and
    their floor; both routes checked at the one-read limit. Row 9 also:
    the kernel events of 5 calls under the profiler (one a call). No
    single PyTorch call computes these functions: library_ms is null."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    gen = torch.Generator(device="cuda").manual_seed(3)
    clock, instr, instr8 = sass["clock_hz"], sass["row12"], sass["row8"]
    instr9 = sass["row9"]["per_value"]
    out = {}
    specs = [("quantize_rows", ROWQ_CASES, qm.quantize_rows,
              qm.quantize_rows_plain, False),
             ("quantize_cols", COLQ_CASES, qm.quantize_cols,
              qm.quantize_cols_plain, False),
             ("sr_quantize_colwise", SRQ_CASES, qm.sr_quantize_colwise,
              qm.sr_quantize_colwise_plain, True)]
    for name, cases, kern, plain, sr in specs:
        rows = []
        for i, (R, C, gelu, what) in enumerate(cases):
            x = quant_input(torch, R, C, gen, zero_col=True)
            act = "gelu" if gelu else None
            args = (x,) if name == "quantize_cols" else \
                (x, 1000 + i, act) if sr else (x, act)
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            check_equal(torch, f"{name} {R}x{C} {what}", got, want)
            row = {"shape": [R, C], "gelu": gelu, "operand": what,
                   "bitwise_equal": True, "max_abs_err": 0.0}
            if sr:
                row["laws"] = sr_laws(torch, name, x, *got, act)
            del got, want
            b_ms, b_by = quantize_bound(R, C, 2, gelu, sr)
            row.update({"ms": device_ms(torch, lambda: kern(*args), 10),
                        "plain_ms": device_ms(torch, lambda: plain(*args), 2),
                        "library_ms": None, "bound_ms": b_ms,
                        "bound_by": b_by})
            route = row8_route(R, C) if name == "quantize_rows" else None
            if route is not None:
                per = instr8[(gelu, *route)]
                row.update({
                    "route": f"{'warp' if route[0] else 'block'} a row, "
                             f"{16 * route[1]} values a thread",
                    "instructions_per_value": per,
                    "instruction_floor_ms": instruction_floor_ms(
                        torch, per, R * C, clock)})
            if sr:
                row.update({
                    "two_pass_ms": device_ms(
                        torch, lambda: qm._cols_two_pass(x, act, 1000 + i),
                        10),
                    "instructions_per_value": instr[gelu]["per_value"],
                    "instruction_floor_ms": instruction_floor_ms(
                        torch, instr[gelu]["per_value"], R * C, clock)})
            if name == "quantize_cols":
                route = colq_route(torch, R)
                events = kernel_events(torch, lambda: kern(x), 5)
                if route == "one read" and list(events.values()) != [5]:
                    raise AssertionError(f"quantize_cols {R}x{C}: 5 calls "
                                         f"ran kernels {events}")
                row.update({
                    "route": route,
                    "kernel_events_per_call": sum(events.values()) / 5,
                    "two_pass_ms": device_ms(
                        torch, lambda: qm._cols_two_pass(x, None, None), 10)})
                if route == "one read":
                    row.update({
                        "instructions_per_value": instr9,
                        "instruction_floor_ms": instruction_floor_ms(
                            torch, instr9, R * C, clock)})
            rows.append(row)
            del x
        result = {"phase": "kernels", "name": name, "cases": rows}
        if sr:
            result["unbiased"] = sr_unbiased_gelu(torch, gen)
            result["routes"] = sr_routes_check(torch, gen)
        if name == "quantize_cols":
            result["routes"] = colq_routes_check(torch, gen)
        emit(result)
        out[name] = rows
    return out


# rows 10 and 11 at the qkv and ffn1 sites of GPT-1.3B: x is the pre-LN
# residual stream [M_TOK, D_MODEL] bf16, g and b LN1's or LN2's; and a
# small case with a constant row (variance 0) and a column with g = b = 0
LN_CASES = [(M_TOK, D_MODEL, "qkv site: LN1 of the block input", False),
            (M_TOK, D_MODEL, "ffn1 site: LN2 of the attention residual",
             False),
            (256, D_MODEL, "a constant row and a g = b = 0 column", True)]
# scalar operations per element beyond the quantize's, from
# csrc/quantize.cu: row 10's two sums (add; subtract, multiply, add) and
# the affine map (subtract, 2 multiplies, add); row 11's affine map
LN10_OPS, LN11_OPS = 8, 4


def ln_input(torch, R, C, gen, edge: bool):
    """bf16 pre-LN activations of the trainer's kind (per-row offset and
    spread), gains near 1 and biases near 0; ``edge``: row 3 constant,
    column 5 with g = b = 0."""
    x = (torch.randn(R, C, device="cuda", generator=gen)
         * (0.5 + 2 * torch.rand(R, 1, device="cuda", generator=gen))
         + torch.randn(R, 1, device="cuda", generator=gen)).bfloat16()
    g = 1 + 0.1 * torch.randn(C, device="cuda", generator=gen)
    b = 0.1 * torch.randn(C, device="cuda", generator=gen)
    if edge:
        x[3] = 0.75
        g[5] = b[5] = 0
    return x, g, b


def row10_route_name(K: int) -> str:
    from paddle_tpu_torch.ops import quant_matmul as qm
    route = qm.row10_route(K)
    if route is None:
        return "staged in shared memory"
    G, nu = route
    return (f"{'warp' if G == 32 else f'block of {G} threads'} a row, "
            f"{16 * nu} values a thread")


def check_ln_equal(torch, name, got, want) -> None:
    for part, a, w in zip(("codes", "scales", "mean", "rstd"), got, want):
        if not torch.equal(a, w):
            raise AssertionError(
                f"{name}: kernel {part} differ from the plain version in "
                f"{int((a != w).sum())} of {a.numel()} elements")


def ln_routes_check(torch, gen) -> dict:
    """Row 10's routes against the plain version bit for bit: each
    register route at its K limit and one unit past it (K 2048 | 2064,
    16384 | 16400), 64 rows with a constant one and a g = b = 0 column;
    and, the order following K and not M, rows of the trainer's [6144,
    2048] quantized alone equal to their rows in the batch."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    routes = []
    for K in (2048, 2064, 16384, 16400):
        x, g, b = ln_input(torch, 64, K, gen, True)
        check_ln_equal(torch, f"ln_quantize_rowwise 64x{K}",
                       qm.ln_quantize_rowwise(x, g, b),
                       qm.ln_quantize_rowwise_plain(x, g, b))
        routes.append({"K": K, "route": row10_route_name(K),
                       "bitwise_equal": True})
    x, g, b = ln_input(torch, M_TOK, D_MODEL, gen, False)
    batch = qm.ln_quantize_rowwise(x, g, b)
    for i in (0, 1001, M_TOK - 1):
        check_ln_equal(torch, f"ln_quantize_rowwise row {i} alone",
                       qm.ln_quantize_rowwise(x[i:i + 1], g, b),
                       [t[i:i + 1] for t in batch])
    return {"routes": routes, "row_alone_equals_batch_row": True}


def row11_route(torch, R: int) -> str:
    """Row 11's route for R rows of bf16 x, as the wrapper picks it."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    return "one read" if R <= qm.sr_cols_one_read_max_rows(
        torch.bfloat16, ln=True) else "two-pass"


def row11_routes_check(torch, gen) -> list:
    """Both of row 11's routes bit for bit against the plain version and
    against each other (the two-pass pair called on the same input): R
    at the one-read limit and 16 rows past it, bf16 x, 64 columns with a
    constant row and a g = b = 0 column."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    out = []
    limit = qm.sr_cols_one_read_max_rows(torch.bfloat16, ln=True)
    for R in (limit, limit + 16):
        x, g, b = ln_input(torch, R, 64, gen, True)
        _, _, mean, rstd = qm.ln_quantize_rowwise(x, g, b)
        args = (x, mean, rstd, g, b, 7)
        got = qm.sr_quantize_colwise_ln(*args)
        check_equal(torch, f"sr_quantize_colwise_ln {R}x64", got,
                    qm.sr_quantize_colwise_ln_plain(*args))
        check_equal(torch, f"sr_quantize_colwise_ln {R}x64, the pair", got,
                    qm._cols_two_pass(x, None, 7, (mean, rstd, g, b)))
        out.append({"rows": R, "route": row11_route(torch, R),
                    "bitwise_equal": True, "pair_bitwise_equal": True})
        del x, got
    return out


def phase_kernels_ln(torch, sass):
    """Kernel rows 10 and 11 against their plain versions bit for bit
    (codes, scales and row 10's mean and rstd), row 11 under row 12's SR
    laws on the card, and, at the trainer's shape, device ms of kernel,
    plain version and the unfused pair each replaces (the port's
    LayerNorm, then row 8; LayerNorm's output from the statistics, then
    row 12: what fuse_ln_quant=False / fuse_bwd_colq=False run), beside
    the bound. Row 10 also: its route, the staged kernel's ms on the same
    input (the route K past 16384 takes, and every K before this
    design), the instructions a value from its SASS and their floor;
    its routes at their limits. Row 11 also: its route (one launch that
    reads x once up to a row limit), the kernel events of 5 calls (one
    a call), the two-pass pair's ms and codes on the same input (the
    route past the limit, and every R before this design), the
    instructions a value from its SASS and their floor, its ptxas line;
    both routes at the limit. No single PyTorch call computes either:
    library_ms null."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops.layer_norm import ln_apply, ln_fwd
    gen = torch.Generator(device="cuda").manual_seed(6)
    clock, instr10 = sass["clock_hz"], sass["row10"]["per_value"]
    instr11 = sass["row11"]["per_value"]
    ptxas11 = {k: v for k, v in sass["ptxas"].items()
               if k.startswith("col_cluster_kernelI13__nv_bfloat16Li2E")}
    rows10, rows11 = [], []
    for i, (R, C, what, edge) in enumerate(LN_CASES):
        x, g, b = ln_input(torch, R, C, gen, edge)
        got = qm.ln_quantize_rowwise(x, g, b)
        want = qm.ln_quantize_rowwise_plain(x, g, b)
        torch.cuda.synchronize()
        check_ln_equal(torch, f"ln_quantize_rowwise {R}x{C} {what}", got,
                       want)
        mean, rstd = want[2], want[3]
        seed = 2000 + i
        args11 = (x, mean, rstd, g, b, seed)
        got11 = qm.sr_quantize_colwise_ln(*args11)
        check_equal(torch, f"sr_quantize_colwise_ln {R}x{C} {what}", got11,
                    qm.sr_quantize_colwise_ln_plain(*args11))
        check_equal(torch, f"sr_quantize_colwise_ln {R}x{C} {what}, the "
                    f"pair", got11, qm._cols_two_pass(x, None, seed,
                                                      (mean, rstd, g, b)))
        h = ln_apply(x, mean, rstd, g, b)
        laws = sr_laws(torch, "sr_quantize_colwise_ln", h, *got11, None)
        r10 = {"shape": [R, C], "operand": what, "bitwise_equal": True,
               "max_abs_err": 0.0}
        r11 = dict(r10, laws=laws)
        if edge:                 # LN(x) = b on the constant row 3
            q, sc, m = got[:3]
            if not (m[3].item() == 0.75 and torch.equal(
                    q[3].float(), torch.round(b / sc[3]).clamp(-127, 127))
                    and not q[:, 5].any()):
                raise AssertionError("ln_quantize_rowwise: the constant "
                                     "row or the g = b = 0 column is off")
        else:
            n = R * C
            b10 = bound(n * 2 + n + 12 * R + 8 * C, 0,
                        scalar_ops=n * (RTN_OPS + LN10_OPS))
            b11 = bound(n * 2 + n + 8 * R + 12 * C, 0,
                        scalar_ops=n * (SR_OPS + PHILOX_OPS + LN11_OPS))
            r10.update({
                "ms": device_ms(torch, lambda: qm.ln_quantize_rowwise(
                    x, g, b), 10),
                "plain_ms": device_ms(torch, lambda: qm.
                                      ln_quantize_rowwise_plain(x, g, b), 2),
                "unfused_pair_ms": device_ms(torch, lambda: qm.quantize_rows(
                    ln_fwd(x, g, b)[0]), 10),
                "staged_ms": device_ms(torch, lambda: qm._rows_ln_cuda(
                    x, g, b, staged=True), 10),
                "route": row10_route_name(C),
                "instructions_per_value": instr10,
                "instruction_floor_ms": instruction_floor_ms(
                    torch, instr10, n, clock),
                "library_ms": None, "bound_ms": b10[0], "bound_by": b10[1]})
            events = kernel_events(
                torch, lambda: qm.sr_quantize_colwise_ln(*args11), 5)
            route = row11_route(torch, R)
            if route == "one read" and list(events.values()) != [5]:
                raise AssertionError(f"sr_quantize_colwise_ln {R}x{C}: 5 "
                                     f"calls ran kernels {events}")
            r11.update({
                "route": route,
                "kernel_events_per_call": sum(events.values()) / 5,
                "two_pass_ms": device_ms(torch, lambda: qm._cols_two_pass(
                    x, None, seed, (mean, rstd, g, b)), 10),
                "instructions_per_value": instr11,
                "instruction_floor_ms": instruction_floor_ms(
                    torch, instr11, n, clock),
                "ptxas": ptxas11,
                "ms": device_ms(torch, lambda: qm.sr_quantize_colwise_ln(
                    *args11), 10),
                "plain_ms": device_ms(torch, lambda: qm.
                                      sr_quantize_colwise_ln_plain(*args11), 2),
                "unfused_pair_ms": device_ms(
                    torch, lambda: qm.sr_quantize_colwise(
                        ln_apply(x, mean, rstd, g, b).to(x.dtype), seed), 10),
                "library_ms": None, "bound_ms": b11[0], "bound_by": b11[1]})
        rows10.append(r10)
        rows11.append(r11)
        del x, got, want, got11, h
    x, g, b = ln_input(torch, 1024, 256, gen, False)
    _, _, mean, rstd = qm.ln_quantize_rowwise(x, g, b)
    unbiased = sr_unbiased(
        torch, lambda seed: qm.sr_quantize_colwise_ln(x, mean, rstd, g, b,
                                                      seed),
        ln_apply(x, mean, rstd, g, b))
    emit({"phase": "kernels", "name": "ln_quantize_rowwise",
          "cases": rows10, **ln_routes_check(torch, gen)})
    emit({"phase": "kernels", "name": "sr_quantize_colwise_ln",
          "cases": rows11, "unbiased": unbiased,
          "routes": row11_routes_check(torch, gen)})
    return {"ln_quantize_rowwise": rows10, "sr_quantize_colwise_ln": rows11}


def phase_int_mm(torch):
    """The int8 GEMM of the all-int8 linears, torch._int_mm (an XLA
    dot_general in the reference, not a Pallas kernel), at each site's
    three orientations with the operand layouts the port hands it:
    forward xq[M,K] @ wq[K,N] (w's codes column-major from the column
    kernel), dgrad gq[M,N] @ wq[K,N].T (row-major codes of w,
    transposed), wgrad aq[M,K].T @ gq[M,N] (both column-major from the
    SR column kernel). Beside it a bf16 torch.matmul of the same shape.
    The int32 result is held exactly to a float64 product."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []

    def codes(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=gen,
                             dtype=torch.int8)

    def col_major(t):
        return t.t().contiguous().t()
    for K, N, site in ((D_MODEL, 3 * D_MODEL, "qkv"),
                       (D_MODEL, F_FFN, "ffn1"), (F_FFN, D_MODEL, "ffn2")):
        for orient, a, b in (
                ("fwd", codes(M_TOK, K), col_major(codes(K, N))),
                ("dgrad", codes(M_TOK, N), codes(K, N).t()),
                ("wgrad", col_major(codes(M_TOK, K)).t(),
                 col_major(codes(M_TOK, N)))):
            y = torch._int_mm(a, b)
            if not torch.equal(y.double(), a.double() @ b.double()):
                raise AssertionError(f"_int_mm {site} {orient} is not exact")
            m_, k_, n_ = a.shape[0], a.shape[1], b.shape[1]
            b_ms, b_by = bound(m_ * k_ + k_ * n_ + 4 * m_ * n_, 0,
                               int8_ops=2 * m_ * k_ * n_)
            af = torch.randn(a.shape, device="cuda", generator=gen).bfloat16()
            bf = torch.randn(b.shape, device="cuda", generator=gen).bfloat16()
            rows.append({
                "site": site, "orientation": orient, "shape": [m_, k_, n_],
                "a_row_major": a.is_contiguous(),
                "b_column_major": b.t().is_contiguous(),
                "ms": device_ms(torch, lambda: torch._int_mm(a, b), 10),
                "bf16_matmul_ms": device_ms(torch, lambda: af @ bf, 10),
                "bound_ms": b_ms, "bound_by": b_by})
            del y, af, bf
    emit({"phase": "kernels", "name": "int8_gemm (torch._int_mm)",
          "cases": rows})
    return rows


def adamw8_bound(R: int, C: int):
    """Least time for one leaf with int8 moments: read p, g (bf16) and
    the m and sqrt(v) codes, write p and the codes (10 bytes a
    parameter), read and write the two f32 row scales; the update,
    both requantizations and three Philox streams counted as scalar
    operations (~30 + 2 * (SR_OPS + PHILOX_OPS) a parameter)."""
    n = R * C
    return bound(10 * n + 16 * R, 0,
                 scalar_ops=n * (30 + 2 * (SR_OPS + PHILOX_OPS)))


def leaf_rows(shape):
    """(R, C) of a leaf's int8 moments: C the last dim."""
    return math.prod(shape) // shape[-1], shape[-1]


# GPT-1.3B's int8-moment leaves: wqkv, wproj, win, wout of each layer,
# wte and wpe; the first and the fifth are timed alone
ADAMW8_SHAPES = [(D_MODEL, 3 * D_MODEL), (D_MODEL, D_MODEL),
                 (D_MODEL, F_FFN), (F_FFN, D_MODEL), (50304, D_MODEL),
                 (TRAIN_T, D_MODEL)]
ADAMW8_TIMED = ((D_MODEL, 3 * D_MODEL), (50304, D_MODEL))
# odd leaves in one launch: C = 128, a leaf of one row, a 3-D leaf, and
# rows of 16384 (past the 8192 elements a block keeps in registers),
# with zeros and values below the fast division's range
ADAMW8_ODD = [(64, 128), (1, 2048), (3, 4, 256), (8, 16384)]


def adamw8_leaf(torch, shape, gen, zero_rows: float = 0.0,
                edges: bool = False):
    """bf16 p and g of a leaf and int8-moment state of the kind a few
    steps leave (codes over their range, per-row scales over two
    decades): ``(p, g, (m_q, m_scale), (v_q, v_scale))``. ``zero_rows``:
    the share of rows whose gradient is 0, as the embedding rows of the
    tokens a batch does not hold. ``edges``: every 7th element of a row
    with m2 = v2 = 0 and every 13th with a gradient of 1e-20 (values
    below the fast division's range: the kernel's rare path)."""
    R, C = leaf_rows(shape)
    kw = dict(device="cuda", generator=gen)
    p = (0.02 * torch.randn(shape, **kw)).bfloat16()
    g = 1e-3 * torch.randn((R, C), **kw)
    g[torch.rand(R, **kw) < zero_rows] = 0
    mq = torch.randint(-127, 128, (R, C), dtype=torch.int8, **kw)
    vq = torch.randint(0, 128, (R, C), dtype=torch.int8, **kw)
    if edges:
        g[:, ::7], mq[:, ::7], vq[:, ::7] = 0, 0, 0
        g[:, 5::13], mq[:, 5::13], vq[:, 5::13] = 1e-20, 0, 0

    def scales():
        return 10.0 ** (torch.rand((R, 1), **kw) * 2 - 6)
    return (p, g.bfloat16().reshape(shape), (mq, scales()), (vq, scales()))


def adamw8_copies(leaves) -> list:
    return [(p.clone(), g, tuple(t.clone() for t in m),
             tuple(t.clone() for t in v)) for p, g, m, v in leaves]


def check_leaves8_bitwise(torch, name, got, leaves, ids, sc, hp) -> float:
    """Each leaf's p, codes and scales from the list kernel (``got``,
    updated copies of ``leaves``) against the per-leaf plain version on
    the leaf's inputs. Returns the plain version's ms over the list:
    CUDA events around each leaf's call, summed."""
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update8_plain
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    plain_ms = 0.0
    for leaf, i, out in zip(leaves, ids, got):
        (p, g, m, v), = adamw8_copies([leaf])
        start.record()
        fused_adamw_update8_plain(p, g, *m, *v, sc, leaf_id=i, **hp)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        for part, a, b in zip(("p", "m_q", "m_scale", "v_q", "v_scale"),
                              (out[0], *out[2], *out[3]), (p, *m, *v)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{name}: leaf {i} {tuple(p.shape)} {part} differs from "
                    f"the plain version in {int((a != b).sum())} elements")
    return plain_ms


def list_update8(torch, leaves, ids, sc, hp) -> list:
    """fused_adamw_update8_leaves on copies of ``leaves``; returns the
    updated copies."""
    from paddle_tpu_torch.ops.fused_adamw import fused_adamw_update8_leaves
    got = adamw8_copies(leaves)
    fused_adamw_update8_leaves(*map(list, zip(*got)), sc, ids, **hp)
    torch.cuda.synchronize()
    return got


def phase_kernels_adamw8(torch, sass):
    """Kernel row 13. On every int8-moment leaf shape of the trainer,
    bf16 p and g, stochastic rounding on: p, the codes and the scales
    bit for bit against the plain version through the per-leaf entry (a
    list of one). Then GPT-1.3B's 98 int8-moment leaves in one launch
    (the trainer's step), every leaf bit for bit against the per-leaf
    plain version, timed through a kept AdamW8Leaves table beside the
    summed bound, the instruction floor (the kernel's SASS instructions a
    parameter at the card's top clock) and the plain version, with the
    host ms of a call; and a list of odd leaves, bit for bit. On wqkv and
    wte alone, ms against the bound and row 14's ms on the same leaf. No
    PyTorch call keeps int8 moments: library_ms is null."""
    from paddle_tpu_torch.ops.fused_adamw import (
        AdamW8Leaves, fused_adamw_update, fused_adamw_update8,
        fused_adamw_update8_leaves, fused_adamw_update8_plain,
        moment8_eligible)
    gen = torch.Generator(device="cuda").manual_seed(5)
    hp = dict(lr=3e-4, wd=0.1, b1=0.9, b2=0.95, eps=1e-8, stoch_round=True,
              seed=3)
    sc = torch.tensor([0.5, 1 / (1 - 0.9 ** 3), 1 / (1 - 0.95 ** 3), 1.0],
                      device="cuda")
    clock, instr = sass["clock_hz"], sass["row13"]
    rows = []
    for shape in ADAMW8_SHAPES:
        leaf = adamw8_leaf(torch, shape, gen, zero_rows=0.9 * (
            shape[0] == 50304))
        got = adamw8_copies([leaf])
        p, g, m, v = got[0]
        fused_adamw_update8(p, g, *m, *v, sc, leaf_id=7, **hp)
        check_leaves8_bitwise(torch, f"fused_adamw8 {shape}", got, [leaf],
                              [7], sc, dict(hp))
        row = {"shape": list(shape), "bitwise_equal": True,
               "max_abs_err": 0.0}
        rows.append(row)
        if shape in ADAMW8_TIMED:
            p, g, m, v = leaf
            m16 = (1e-4 * torch.randn(shape, device="cuda", generator=gen)
                   ).bfloat16()
            v16 = (1e-8 * torch.rand(shape, device="cuda", generator=gen)
                   ).bfloat16()
            b_ms, b_by = adamw8_bound(*leaf_rows(shape))
            row.update({
                "ms": device_ms(torch, lambda: fused_adamw_update8(
                    p, g, *m, *v, sc, leaf_id=7, **hp), 10),
                "plain_ms": device_ms(
                    torch, lambda: fused_adamw_update8_plain(
                        p, g, *m, *v, sc, leaf_id=7, **hp), 2),
                "adamw_bf16_moments_ms": device_ms(
                    torch, lambda: fused_adamw_update(p, g, m16, v16, sc,
                                                      leaf_id=7, **hp), 10),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "instruction_floor_ms": instruction_floor_ms(
                    torch, instr["per_param"](shape[-1]), math.prod(shape),
                    clock)})
            del m16, v16
        del leaf, got, p, g, m, v
    torch.cuda.empty_cache()

    # the flagship step's 98 int8-moment leaves, one launch
    named = [(i, shape) for i, (_, shape) in enumerate(gpt_leaf_shapes())
             if moment8_eligible(shape)]
    ids = [i for i, _ in named]
    leaves = [adamw8_leaf(torch, shape, gen, zero_rows=0.9 * (
        shape[0] == 50304)) for _, shape in named]
    plain_ms = check_leaves8_bitwise(
        torch, "fused_adamw8, 98 leaves",
        list_update8(torch, leaves, ids, sc, hp), leaves, ids, sc, hp)
    ps, gs, ms, vs = (list(t) for t in zip(*leaves))
    kept = AdamW8Leaves(ps, ms, vs, ids)        # the trainer's way
    before = fused_adamw_update8.launches
    kept.update(gs, sc, **hp)
    if fused_adamw_update8.launches != before + 1:
        raise AssertionError("fused_adamw8: the 98 leaves took "
                             f"{fused_adamw_update8.launches - before} "
                             f"launches, not one")
    shapes = [leaf_rows(shape) for _, shape in named]
    n = sum(R * C for R, C in shapes)
    b_ms, b_by = bound(sum(10 * R * C + 16 * R for R, C in shapes), 0,
                       scalar_ops=n * (30 + 2 * (SR_OPS + PHILOX_OPS)))
    whole = {
        "leaves": len(named), "params": n, "rows": sum(R for R, _ in shapes),
        "bitwise_equal": True, "max_abs_err": 0.0,
        "ms": device_ms(torch, lambda: kept.update(gs, sc, **hp), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "instruction_floor_ms": sum(instruction_floor_ms(
            torch, instr["per_param"](C), R * C, clock) for R, C in shapes),
        "host_ms": {
            "list_entry": host_ms(torch, lambda: fused_adamw_update8_leaves(
                ps, gs, ms, vs, sc, ids, **hp)),
            "kept_table": host_ms(torch, lambda: kept.update(gs, sc, **hp))},
        "plain_ms": plain_ms,
        "plain_timing": "cuda events around each leaf's call, summed"}
    del leaves, ps, gs, ms, vs, kept
    torch.cuda.empty_cache()

    odd = [adamw8_leaf(torch, shape, gen, zero_rows=0.25, edges=True)
           for shape in ADAMW8_ODD]
    odd_ids = [5, 17, 200, 3]
    check_leaves8_bitwise(torch, "fused_adamw8, odd leaves",
                          list_update8(torch, odd, odd_ids, sc, hp), odd,
                          odd_ids, sc, hp)
    whole["odd"] = {"shapes": [list(s) for s in ADAMW8_ODD],
                    "bitwise_equal": True}
    emit({"phase": "kernels", "name": "fused_adamw8", "cases": rows,
          "gpt_1p3b_list": whole})
    return rows, whole


def llama_1b_config():
    from paddle_tpu_torch.models.llama import LlamaConfig
    # benchmarks/bench_serving_engine.py's full-width serving shape
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=16,
                       num_attention_heads=16, max_position_embeddings=1024)


def served(model):
    """The serving engine's own view of ``model`` (a Llama or a GPT):
    its ``_ModelAdapter``, whose ``num_layers``, ``kv_heads``,
    ``head_dim``, ``call`` and ``head`` the serving phases read, so one
    helper serves either family."""
    from paddle_tpu_torch.serving.engine import _ModelAdapter
    return _ModelAdapter(model)


def phase_serve(torch, np, model, name="serve"):
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    from paddle_tpu_torch.serving import ServingEngine
    cfg = model.config
    layers = served(model).num_layers
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, (PROMPT_LENS[i % 5],))
               for i in range(SLOTS)]
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]
    # warm-up outside the counted window: cuBLAS handles, the kernel
    # library, the allocator
    warm = ServingEngine(model, kv_layout="contiguous", max_slots=2,
                         max_len=MAX_LEN, min_bucket=MIN_BUCKET)
    for p in prompts[:2]:
        warm.submit(p, max_new_tokens=2)
    warm.run()
    del warm
    engine = ServingEngine(model, kv_layout="contiguous", max_slots=SLOTS,
                           max_len=MAX_LEN, min_bucket=MIN_BUCKET)
    reqs = [engine.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches
    others = {k: v for k, v in read_launches().items()
              if k != "flash_attention_fwd" and v}
    if others:
        raise AssertionError(f"serving launched training kernels: {others}")
    for r, n in zip(reqs, news):
        if not (r.finished and r.finish_reason == "length"
                and len(r.output_ids) == n):
            raise AssertionError(
                f"request {r.rid}: {r.finish_reason}, "
                f"{len(r.output_ids)} of {n} tokens")
    prefills = len(reqs)
    want = layers * prefills
    if launches != want:
        raise AssertionError(
            f"{name}: flash_attention_fwd launched {launches} times in the "
            f"engine run; expected {layers} layers x {prefills} prefills "
            f"= {want}")
    m = engine.metrics.summary()
    emit({"phase": name, "requests": len(reqs),
          "tokens": m["total_tokens"], "wall_s": wall,
          "tokens_per_s": m["tokens_per_s"], "ttft_p50_s": m["ttft_p50_s"],
          "ttft_p99_s": m["ttft_p99_s"],
          "tok_latency_p50_s": m["tok_latency_p50_s"],
          "decode_steps": m["steps"], "prefills": prefills,
          "flash_launches": launches, "kv_bytes": engine.cache.kv_bytes(),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return prompts, reqs, {"flash_attention_fwd": launches}, dict(
        m, kv_bytes=engine.cache.kv_bytes())


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by the name the kernels line
    gives it; each counts its own launches."""
    from paddle_tpu_torch.ops import quant_matmul as qm
    from paddle_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                      flash_attention_fwd)
    from paddle_tpu_torch.ops.fused_adamw import (fused_adamw_update8,
                                                  fused_adamw_update_leaves)
    from paddle_tpu_torch.ops import batch_norm as bn
    from paddle_tpu_torch.ops.int4_matmul import int4_matmul
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "fused_adamw": fused_adamw_update_leaves,
            "quantize_rows": qm.quantize_rows,
            "quantize_cols": qm.quantize_cols,
            "sr_quantize_colwise": qm.sr_quantize_colwise,
            "ln_quantize_rowwise": qm.ln_quantize_rowwise,
            "sr_quantize_colwise_ln": qm.sr_quantize_colwise_ln,
            "fused_adamw8": fused_adamw_update8,
            "int4_matmul": int4_matmul,
            "bn_stats": bn.bn_stats, "bn_apply": bn.bn_apply,
            "bn_gsum": bn.bn_gsum, "bn_dx": bn.bn_dx}


def reset_launches() -> None:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["flash_attention_bwd"].f32_launches = 0


def no_launches() -> dict:
    """read_launches()'s names, each at 0."""
    return dict.fromkeys([*kernel_wrappers(), "flash_attention_bwd_f32"], 0)


def read_launches() -> dict:
    """Each wrapper's count, and the float32 launches of the flash
    backward (its own kernels) apart as flash_attention_bwd_f32."""
    wrappers = kernel_wrappers()
    counts = {k: fn.launches for k, fn in wrappers.items()}
    counts["flash_attention_bwd_f32"] = \
        wrappers["flash_attention_bwd"].f32_launches
    return counts


def profiled(torch, setup):
    """``traced`` with CPU + CUDA activities; returns (wall s, device s,
    top kernels by device time as (name, ms))."""
    wall, ev = traced(torch, setup, with_cpu=True)
    ev.sort(key=lambda e: -e.self_device_time_total)
    dev = sum(e.self_device_time_total for e in ev) / 1e6
    return wall, dev, [(e.key[:70], e.self_device_time_total / 1e3)
                       for e in ev[:6]]


def decode_profile(torch, model, prompts, steps: int = 8, new: int = 16,
                   **engine_kw):
    """8 decode steps over 16 busy slots under the profiler (the
    admissions run first, outside the window): wall and device ms a
    step, the busy share, the top kernels a step."""
    from paddle_tpu_torch.serving import ServingEngine

    def decode():
        engine = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                               min_bucket=MIN_BUCKET, **engine_kw)
        for p in prompts:
            engine.submit(p, max_new_tokens=new)
        engine.step()                   # admissions, outside the window
        return lambda: [engine.step() for _ in range(steps)]
    wall, dev, top = profiled(torch, decode)
    return {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step": dev / steps * 1e3,
            "device_busy_share": dev / wall,
            "top_kernels_ms_per_step": [(n, ms / steps) for n, ms in top]}


def phase_profile(torch, model, prompts):
    """Where a step's time goes: 8 decode steps over 16 busy slots, and
    one admission of the 300-token prompt (bucket 512), each under the
    profiler (so wall times here include its overhead)."""
    from paddle_tpu_torch.serving import ServingEngine

    def prefill():
        one = ServingEngine(model, kv_layout="contiguous", max_slots=1,
                            max_len=MAX_LEN, min_bucket=MIN_BUCKET)
        one.submit(prompts[PROMPT_LENS.index(300)], max_new_tokens=1)
        return one.step
    decode = decode_profile(torch, model, prompts, kv_layout="contiguous")
    pwall, pdev, ptop = profiled(torch, prefill)
    flash = sum(ms for name, ms in ptop if "flash_fwd_wgmma" in name)
    emit({"phase": "profile", "decode": decode,
          "prefill_512": {"wall_ms": pwall * 1e3, "device_ms": pdev * 1e3,
                          "device_busy_share": pdev / pwall,
                          "flash_kernel_ms": flash,
                          "top_kernels_ms": ptop}})
    return decode


def prefill_logits(torch, model, ids, per_row: bool, n=None):
    """Logits at token ``n - 1`` (default: the last) of one prompt run
    through the static-cache prefill at position 0: a scalar position
    takes the flash-attention branch, a per-row position tensor the
    plain masked einsum."""
    ad = served(model)
    dev = model.device
    n = len(ids) if n is None else n
    x = torch.as_tensor(ids, device=dev).long()[None]
    pos = torch.zeros(1, dtype=torch.long, device=dev) if per_row else 0
    shape = (1, x.shape[1], ad.kv_heads, ad.head_dim)
    caches = [(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
               torch.zeros(shape, dtype=torch.bfloat16, device=dev), pos)
              for _ in range(ad.num_layers)]
    with torch.inference_mode():
        h, _ = ad.call(x, caches)
        logits = ad.head(h[:, n - 1:n])[0, -1].float()
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    return logits


def bf16_step(x) -> float:
    """The spacing of bf16 values at the largest magnitude in ``x``."""
    return 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


def phase_check(torch, np, model, prompts, reqs):
    from paddle_tpu_torch.serving import bucket_for
    pad_diff = 0.0
    for p, r in zip(prompts, reqs):
        n = len(p)
        # the engine's route: the prompt padded to its bucket
        padded = np.zeros(bucket_for(n, MIN_BUCKET, MAX_LEN), np.int64)
        padded[:n] = p
        eng = prefill_logits(torch, model, padded, False, n)
        if int(eng.argmax()) != r.output_ids[0]:
            raise AssertionError(
                f"request {r.rid}: engine's first token "
                f"{r.output_ids[0]} is not the argmax of its own "
                f"bucket-padded prefill ({int(eng.argmax())})")
        # generate()'s route: the unpadded prompt. Tiles that do not
        # depend on S make a row's result depend only on its prefix.
        gen = prefill_logits(torch, model, p, False)
        diff = (gen - eng).abs().max().item()
        if diff > bf16_step(eng):
            raise AssertionError(
                f"request {r.rid}: padded and unpadded prefill logits "
                f"differ by {diff} (> one bf16 step, {bf16_step(eng)})")
        pad_diff = max(pad_diff, diff)
    first = model.generate(torch.as_tensor(prompts[0][None]),
                           max_new_tokens=1)[0, -1].item()
    if first != int(prefill_logits(torch, model, prompts[0],
                                   False).argmax()):
        raise AssertionError("generate() disagrees with its own prefill")
    ids = prompts[PROMPT_LENS.index(300)]
    kern = prefill_logits(torch, model, ids, per_row=False)
    plain = prefill_logits(torch, model, ids, per_row=True)
    diff = (kern - plain).abs().max().item()
    if diff > ROUTE_TOL:
        raise AssertionError(
            f"prefill logits, kernel vs plain route: max |diff| {diff} > "
            f"{ROUTE_TOL}")
    emit({"phase": "check", "first_tokens_exact": len(reqs),
          "pad_logits_max_abs_diff": pad_diff,
          "route_logits_max_abs_diff": diff, "route_tol": ROUTE_TOL,
          "route_argmax_equal": int(kern.argmax()) == int(plain.argmax())})


# -- the paged KV layout (serving's default) ---------------------------------
PAGE = 128                       # the engine's default page at max_len 512
AGREE_MIN = 0.9                  # int8 KV's measured-parity gate
# bench_serving_engine.py --prefix-share at full width (:1994-1999)
PREFIX_SYS_LENS, PREFIX_REQS, PREFIX_SUFFIX, PREFIX_NEW = (384, 384), 192, \
    16, 32
# what slot_cache.py's rules give for that trace: each of the 192
# prompts (400 tokens, 399 matchable) matches its system prompt's 3 full
# pages (384 tokens), which the warm-up registered; the 15 matchable
# suffix tokens find no indexed 4th page (no prompt has a full one), so
# no partial match and no COW. The two system prompts share no first
# token (seed 0), so the second warm-up matches nothing either; decode
# writes land in each request's own fresh 4th page.
PREFIX_HITS = PREFIX_REQS * 384
PREFIX_COW = 0
# peak concurrency bars of the reference's PAGED_KV line
# (tests/test_benchmarks_smoke.py:257-258)
PREFIX_BARS = {"paged": 4.0, "paged_int8": 10.0}


def serve_run(torch, engine, prompts, news, finite=None):
    """Submit every request, drain the engine with the launch counts set
    to 0 just before and read just after; the requests, the wall s and
    the counts. ``finite`` (a list) collects whether every logit the
    engine sampled from was finite (host arrays: no device work)."""
    import numpy as np
    from paddle_tpu_torch.serving import engine as engine_mod
    reqs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    sample = engine_mod.sample_token

    def checked(logits, params, rng):
        finite.append(bool(np.isfinite(logits).all()))
        return sample(logits, params, rng)
    if finite is not None:
        engine_mod.sample_token = checked
    try:
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        engine_mod.sample_token = sample
    for r, n in zip(reqs, news):
        if not (r.finished and r.finish_reason == "length"
                and len(r.output_ids) == n):
            raise AssertionError(
                f"request {r.rid}: {r.finish_reason}, "
                f"{len(r.output_ids)} of {n} tokens")
    return reqs, wall, launches


def forced_agreement(engine, prompts, ref_reqs, gaps=None) -> float:
    """Greedy agreement per step of ``engine`` with ``ref_reqs``: the
    engine serves the same prompts, but each step is fed the reference
    run's tokens (teacher forcing), and the share of steps whose argmax
    is the reference's token is returned. Free-running agreement counts
    every token after a first split as a disagreement too; this one
    counts what the KV storage changes at each step. ``gaps`` (a list)
    collects each split's ``split_gap``."""
    import numpy as np
    from paddle_tpu_torch.serving import engine as engine_mod
    reqs = [engine.submit(p, max_new_tokens=len(r.output_ids))
            for p, r in zip(prompts, ref_reqs)]
    # every request has its own SamplingParams: it names the request
    want = {id(r.sampling): (r, ref.output_ids)
            for r, ref in zip(reqs, ref_reqs)}
    hits = []
    sample = engine_mod.sample_token

    def forced(logits, params, rng):
        req, toks = want[id(params)]
        tok = toks[len(req.out_tokens)]
        hits.append(int(np.argmax(logits)) == tok)
        if gaps is not None and not hits[-1]:
            gaps.append(split_gap(logits, tok))
        return tok
    engine_mod.sample_token = forced
    try:
        engine.run()
    finally:
        engine_mod.sample_token = sample
    return sum(hits) / len(hits)


def agreement(a_reqs, b_reqs) -> float:
    """The share of greedy tokens two runs of one trace agree on."""
    pairs = [(x, y) for a, b in zip(a_reqs, b_reqs)
             for x, y in zip(a.output_ids, b.output_ids)]
    return sum(x == y for x, y in pairs) / len(pairs)


def no_leaks(engine, name: str) -> None:
    from paddle_tpu_torch.resilience import page_leak_violations
    leaks = page_leak_violations(engine)
    if leaks:
        raise AssertionError(f"{name}: leaked pages: {leaks}")


def flash_only(name, launches, want) -> int:
    """A serving run's launch counts: flash_attention_fwd exactly
    ``want`` times (layers x prefills) and no other kernel; returns the
    flash count."""
    flash = launches["flash_attention_fwd"]
    others = {k: v for k, v in launches.items()
              if k != "flash_attention_fwd" and v}
    if others:
        raise AssertionError(f"{name} launched other kernels: {others}")
    if flash != want:
        raise AssertionError(
            f"{name}: flash_attention_fwd launched {flash} times; expected "
            f"layers x prefills = {want}")
    return flash


def phase_serve_paged(torch, np, model, prompts, contig_reqs, contig,
                      contig_decode, kv_dtype=None, bf16_run=None,
                      prefix="serve", gap_steps=None):
    """serve's trace through the paged engine (capacity parity, page
    128), in the model dtype or with int8 KV (see the module
    docstring, 6a-6b); with ``gap_steps``, int8 KV's every split must
    also lie within that many bf16 steps of the bf16 run's token.
    Returns (requests, launches, kv bytes)."""
    from paddle_tpu_torch.serving import ServingEngine
    name = f"{prefix}-paged-int8" if kv_dtype else f"{prefix}-paged"
    layers = served(model).num_layers
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]

    def engine(slots):
        return ServingEngine(model, kv_layout="paged", max_slots=slots,
                             max_len=MAX_LEN, min_bucket=MIN_BUCKET,
                             page_size=PAGE, kv_dtype=kv_dtype)
    warm = engine(2)                    # the paged code paths, uncounted
    for p in prompts[:2]:
        warm.submit(p, max_new_tokens=2)
    warm.run()
    del warm
    eng = engine(SLOTS)
    finite = []
    reqs, wall, launches = serve_run(torch, eng, prompts, news, finite)
    flash = flash_only(name, launches, layers * len(reqs))
    no_leaks(eng, name)
    stats = eng.paged_stats()
    row = {"phase": name, "requests": len(reqs), "page_size": PAGE,
           "num_pages": eng.cache.num_pages,
           "flash_launches": flash, "prefix_hit_tokens":
           stats["prefix_hit_tokens"], "leaks": 0}
    if kv_dtype is None:
        for r, c in zip(reqs, contig_reqs):
            if r.output_ids != c.output_ids:
                raise AssertionError(
                    f"{name}: request {r.rid} tokens {r.output_ids} differ "
                    f"from the contiguous engine's {c.output_ids}")
        row["tokens_equal_contiguous"] = len(reqs)
    else:
        agree = agreement(reqs, bf16_run[0])
        gaps = []
        forced = forced_agreement(engine(SLOTS), prompts, bf16_run[0], gaps)
        steps = sorted(g / s for g, s in gaps)
        if forced < AGREE_MIN:
            raise AssertionError(
                f"{name}: greedy agreement a step with {prefix}-paged "
                f"{forced} < {AGREE_MIN}")
        if gap_steps is not None and steps and steps[-1] > gap_steps:
            raise AssertionError(
                f"{name}: a split {steps[-1]} bf16 steps from the bf16 "
                f"run's token (bound {gap_steps})")
        if not all(finite):
            raise AssertionError(f"{name}: non-finite logits sampled")
        c = eng.cache
        if any(p.dtype != torch.int8 for p in c.ks + c.vs) or any(
                p.dtype != torch.float32 for p in c.kss + c.vss):
            raise AssertionError(f"{name}: pools of {c.ks[0].dtype}, "
                                 f"scales of {c.kss[0].dtype}")
        row.update(greedy_agreement_vs_bf16=agree,
                   step_agreement_vs_bf16=forced, agree_min=AGREE_MIN,
                   split_gap_steps={
                       "splits": len(steps),
                       "p50": float(np.percentile(steps, 50)),
                       "p90": float(np.percentile(steps, 90)),
                       "max": steps[-1],
                       "within_int8_gap_steps": sum(
                           x <= INT8_GAP_STEPS for x in steps)}
                   if steps else None,
                   logits_finite=len(finite),
                   pool_dtype=str(eng.cache.ks[0].dtype),
                   scale_dtype=str(eng.cache.kss[0].dtype),
                   kv_bytes_bf16_paged=bf16_run[2],
                   kv_bytes_over_bf16=eng.cache.kv_bytes() / bf16_run[2])
        if gap_steps is not None:
            row.update(gap_bound_steps=gap_steps, identity_agree_min_met=(
                forced >= IDENTITY_AGREE_MIN))
    m = eng.metrics.summary()
    kv = eng.cache.kv_bytes()
    del eng
    dec = decode_profile(torch, model, prompts, kv_layout="paged",
                         page_size=PAGE, kv_dtype=kv_dtype)
    row.update({
        "wall_s": wall, "tokens": m["total_tokens"],
        "tokens_per_s": m["tokens_per_s"],
        "tokens_per_s_contiguous": contig["tokens_per_s"],
        "ttft_p50_s": m["ttft_p50_s"],
        "ttft_p50_s_contiguous": contig["ttft_p50_s"],
        "ttft_p99_s": m["ttft_p99_s"],
        "ttft_p99_s_contiguous": contig["ttft_p99_s"],
        "kv_bytes": kv, "kv_bytes_contiguous": contig["kv_bytes"],
        "decode_device_ms_per_step": dec["device_ms_per_step"],
        "decode_device_ms_per_step_contiguous":
            contig_decode["device_ms_per_step"],
        "decode_wall_ms_per_step": dec["wall_ms_per_step"],
        "decode_wall_ms_per_step_contiguous":
            contig_decode["wall_ms_per_step"],
        "decode_busy_share": dec["device_busy_share"],
        "decode_top_kernels_ms_per_step": dec["top_kernels_ms_per_step"]})
    emit(row)
    return reqs, {"flash_attention_fwd": flash}, kv, m


def prefix_trace(np):
    """bench_serving_engine.py:run_prefix_share's prompts (seed 0)."""
    rng = np.random.RandomState(0)
    systems = [rng.randint(1, 100, (n,)).astype(np.int64)
               for n in PREFIX_SYS_LENS]
    prompts = [np.concatenate([systems[i % len(systems)],
                               rng.randint(1, 100, (PREFIX_SUFFIX,))])
               .astype(np.int64) for i in range(PREFIX_REQS)]
    return systems, prompts


def prefix_burst(torch, np, engine, prompts, warm=()):
    """run_prefix_share's _run_burst: warm prompts to completion first,
    then the whole trace at once, drained; the requests, the peak of
    requests in flight, tokens/s, the mean pages a live token and the
    flash launches of the burst."""
    for p in warm:
        engine.submit(p, max_new_tokens=1)
    engine.run()
    reqs = [engine.submit(p, max_new_tokens=PREFIX_NEW) for p in prompts]
    peak, ratios = 0, []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    while engine.has_work():
        engine.step()
        active = engine.cache.active_slots()
        peak = max(peak, len(active))
        if engine.paged and active:
            live = sum(engine.cache.slots[s].next_pos for s in active)
            ratios.append(engine.cache.active_page_count() / max(1, live))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash = read_launches()["flash_attention_fwd"]
    for r in reqs:
        if r.finish_reason != "length":
            raise AssertionError(
                f"prefix request {r.rid} finished by {r.finish_reason}")
    toks = sum(len(r.output_ids) for r in reqs)
    return {"reqs": reqs, "peak": peak, "tokens_per_s": toks / wall,
            "wall_s": wall, "flash_launches": flash,
            "pages_per_token": float(np.mean(ratios)) if ratios else 0.0}


def phase_serve_prefix(torch, np, model):
    """bench_serving_engine.py --prefix-share at full width under one KV
    byte budget (module docstring, 6c). The shared path's tokens are not
    gated on the contiguous engine's: there the prefill runs the flash
    kernel and the extend the masked einsum, so a near-tie may split."""
    from paddle_tpu_torch.serving import ServingEngine
    systems, prompts = prefix_trace(np)
    prefill_logits = {}

    contig = ServingEngine(model, kv_layout="contiguous", max_slots=SLOTS,
                           max_len=MAX_LEN, min_bucket=MIN_BUCKET)
    raw = contig._prefill_raw

    def keep_raw(slot, ids, req, **kw):
        out = raw(slot, ids, req, **kw)
        prefill_logits[ids.tobytes()] = out
        return out
    contig._prefill_raw = keep_raw
    res = {"contiguous": prefix_burst(torch, np, contig, prompts)}
    budget = contig.cache.kv_bytes()
    del contig
    ad_layers = model.config.num_hidden_layers
    kvh, hd = model.config.kv_heads, model.config.head_dim
    itemsize = model.llama.embed_tokens.weight.element_size()
    rows = {}
    for name, quant in (("paged", None), ("paged_int8", "int8")):
        per_page = ad_layers * 2 * PAGE * kvh * hd * (1 if quant
                                                      else itemsize)
        if quant:
            per_page += ad_layers * 2 * PAGE * kvh * 4
        n_pages = max(budget // per_page, MAX_LEN // PAGE + 1)
        eng = ServingEngine(model, kv_layout="paged",
                            max_slots=min(PREFIX_REQS, n_pages),
                            max_len=MAX_LEN, min_bucket=MIN_BUCKET,
                            page_size=PAGE, num_pages=n_pages,
                            kv_dtype=quant, prefix_sharing=True)
        extend_logits = {}
        prefill = eng._prefill_raw

        def keep_paged(slot, ids, req, prefill=prefill, store=extend_logits,
                       **kw):
            out = prefill(slot, ids, req, **kw)
            store[req.rid] = out
            return out
        eng._prefill_raw = keep_paged
        extends = count_calls(eng, "_extend")
        run = prefix_burst(torch, np, eng, prompts,
                           warm=[np.concatenate([s, s[:1]])
                                 for s in systems])
        stats = eng.paged_stats()
        if eng.cache.kv_bytes() > budget:
            raise AssertionError(f"{name}: {eng.cache.kv_bytes()} KV bytes "
                                 f"over the budget {budget}")
        if (stats["prefix_hit_tokens"], stats["cow_copies"]) != (
                PREFIX_HITS, PREFIX_COW):
            raise AssertionError(
                f"{name}: prefix_hit_tokens {stats['prefix_hit_tokens']}, "
                f"cow_copies {stats['cow_copies']}; slot_cache.py's rules "
                f"give {PREFIX_HITS}, {PREFIX_COW}")
        if extends[0] != PREFIX_REQS:
            raise AssertionError(f"{name}: {extends[0]} extends for "
                                 f"{PREFIX_REQS} shared prompts")
        no_leaks(eng, name)
        diff = 0.0
        for r in run["reqs"]:
            got = extend_logits[r.rid]
            if int(np.argmax(got)) != r.output_ids[0]:
                raise AssertionError(
                    f"{name}: request {r.rid}'s first token "
                    f"{r.output_ids[0]} is not the argmax of its extend "
                    f"logits ({int(np.argmax(got))})")
            if quant is None:
                want = prefill_logits[np.asarray(r.prompt).tobytes()]
                diff = max(diff, float(np.abs(got - want).max()))
        if diff > ROUTE_TOL:
            raise AssertionError(
                f"{name}: extend logits differ from the contiguous "
                f"prefill's by {diff} > {ROUTE_TOL}")
        run.update(stats=stats, num_pages=n_pages,
                   max_slots=min(PREFIX_REQS, n_pages),
                   kv_bytes=eng.cache.kv_bytes(), extend_logits_diff=diff)
        res[name] = run
        del eng
    agree8 = agreement(res["paged_int8"]["reqs"], res["paged"]["reqs"])
    eng8 = ServingEngine(model, kv_layout="paged",
                         max_slots=res["paged_int8"]["max_slots"],
                         max_len=MAX_LEN, min_bucket=MIN_BUCKET,
                         page_size=PAGE,
                         num_pages=res["paged_int8"]["num_pages"],
                         kv_dtype="int8")
    for s in systems:
        eng8.submit(np.concatenate([s, s[:1]]), max_new_tokens=1)
    eng8.run()
    forced8 = forced_agreement(eng8, prompts, res["paged"]["reqs"])
    no_leaks(eng8, "serve-prefix int8, fed paged's tokens")
    del eng8
    if forced8 < AGREE_MIN:
        raise AssertionError(
            f"serve-prefix: int8 greedy agreement a step with the paged "
            f"engine {forced8} < {AGREE_MIN}")
    base = res["contiguous"]["peak"]
    for name, bar in PREFIX_BARS.items():
        rows[name] = {"peak_concurrency": res[name]["peak"],
                      "gain": res[name]["peak"] / base, "bar": bar,
                      "meets_bar": res[name]["peak"] / base >= bar,
                      "num_pages": res[name]["num_pages"],
                      "max_slots": res[name]["max_slots"],
                      "kv_bytes": res[name]["kv_bytes"],
                      "tokens_per_s": res[name]["tokens_per_s"],
                      "wall_s": res[name]["wall_s"],
                      "pages_per_token": res[name]["pages_per_token"],
                      "flash_launches": res[name]["flash_launches"],
                      "prefix_hit_rate":
                          res[name]["stats"]["prefix_hit_rate"],
                      "prefix_hit_tokens":
                          res[name]["stats"]["prefix_hit_tokens"],
                      "prefix_lookup_tokens":
                          res[name]["stats"]["prefix_lookup_tokens"],
                      "cow_copies": res[name]["stats"]["cow_copies"],
                      "pages_reclaimed":
                          res[name]["stats"]["pages_reclaimed"]}
    emit({"phase": "serve-prefix", "requests": PREFIX_REQS,
          "system_prompts": list(PREFIX_SYS_LENS), "suffix": PREFIX_SUFFIX,
          "new": PREFIX_NEW, "page_size": PAGE, "budget_bytes": budget,
          "contiguous": {"peak_concurrency": base, "max_slots": SLOTS,
                         "tokens_per_s": res["contiguous"]["tokens_per_s"],
                         "wall_s": res["contiguous"]["wall_s"],
                         "flash_launches":
                             res["contiguous"]["flash_launches"]},
          **rows, "prefix_hits_derived": PREFIX_HITS,
          "cow_copies_derived": PREFIX_COW,
          "extend_logits_max_abs_diff": res["paged"]["extend_logits_diff"],
          "route_tol": ROUTE_TOL,
          "int8_greedy_agreement_vs_paged": agree8,
          "int8_step_agreement_vs_paged": forced8, "agree_min": AGREE_MIN,
          "paged_greedy_agreement_vs_contiguous": agreement(
              res["paged"]["reqs"], res["contiguous"]["reqs"]),
          "leaks": 0})
    return {name: {"flash_attention_fwd": res[name]["flash_launches"]}
            for name in res}


# -- the identity rule (the speculative, chunked, recover and tier phases) ----
# a run whose tokens are not its base run's passes when, fed the base
# run's tokens (teacher forcing), its argmax picks them at this share of
# positions or more, and at every split the base token's logit lies
# within one bf16 step of the maximum
IDENTITY_AGREE_MIN = 0.99
# the split bound of two int8-KV runs whose routes differ in what attends
# over a shared prompt (serve-tier's int8 pair: row 1 over the prompt's
# unquantized k/v in one, the extend over its int8 pages in the other):
# int8 KV's own logit error, in bf16 steps at the row's largest logit.
# serve-paged-int8 prints the split gaps of int8 KV against bf16 KV
# (split_gap_steps); on the H100 its 33 splits lay within 2 steps
INT8_GAP_STEPS = 2


def split_gap(row, tok: int):
    """(the row's max logit less ``tok``'s, one bf16 step at the row's
    largest magnitude)."""
    import numpy as np
    step = 2.0 ** (math.floor(math.log2(float(np.abs(row).max()))) - 7)
    return float(row.max() - row[tok]), step


def identity_rule(name, reqs, base_reqs, forced, suffix="",
                  gap_steps: int = 1) -> dict:
    """The identity rule: ``reqs``' greedy tokens equal ``base_reqs``'
    (held by "tokens"), or else ``forced()`` (the run again, fed the base
    tokens, returning (agreement, [(gap, bf16 step)] at each split))
    gives an agreement >= IDENTITY_AGREE_MIN and every gap within
    ``gap_steps`` of its step (held by "near-ties"); raises otherwise.
    Returns the row printed, with which of the two held."""
    same = sum(a.output_ids == b.output_ids for a, b in zip(reqs, base_reqs))
    row = {"token_identical": same == len(reqs), "requests_identical": same,
           f"greedy_agreement{suffix}": agreement(reqs, base_reqs),
           "identity_held_by": "tokens"}
    if same == len(reqs):
        return row
    agree, gaps = forced()
    row.update({f"forced_agreement{suffix}": agree,
                "agree_min": IDENTITY_AGREE_MIN, "gap_steps": gap_steps,
                "split_gaps": gaps[:8], "splits": len(gaps),
                "identity_held_by": "near-ties"})
    if agree < IDENTITY_AGREE_MIN or any(g > gap_steps * s for g, s in gaps):
        raise AssertionError(
            f"{name}: {len(reqs) - same} requests' tokens differ from the "
            f"base run's; teacher-forced agreement {agree} (min "
            f"{IDENTITY_AGREE_MIN}), split gaps {gaps[:8]} (bound "
            f"{gap_steps} bf16 steps)")
    return row


class teacher_forcing:
    """While entered, the engine's sampler returns the base run's tokens
    (``base``: token lists in submission order; the driver calls
    ``track(req)`` on each request it submits, in that order) and records
    whether each position's argmax was that token, and at a split its
    gap (``split_gap``). Untracked requests sample as usual."""

    def __init__(self, base):
        self.base = [list(b) for b in base]
        self.want = {}
        self.hits, self.gaps = [], []

    def track(self, req) -> None:
        # every request has its own SamplingParams: it names the request
        self.want[id(req.sampling)] = (req, self.base[len(self.want)])

    def __enter__(self):
        from paddle_tpu_torch.serving import engine as engine_mod
        self._mod, self._sample = engine_mod, engine_mod.sample_token
        engine_mod.sample_token = self._forced
        return self

    def __exit__(self, *exc):
        self._mod.sample_token = self._sample

    def _forced(self, logits, params, rng):
        import numpy as np
        got = self.want.get(id(params))
        if got is None:
            return self._sample(logits, params, rng)
        req, toks = got
        tok = toks[len(req.out_tokens)]
        self.hits.append(int(np.argmax(logits)) == tok)
        if not self.hits[-1]:
            self.gaps.append(split_gap(logits, tok))
        return tok

    def result(self):
        return sum(self.hits) / len(self.hits), self.gaps


# -- speculative decoding (ServingEngine(speculative=True)) ------------------
SPEC_K = 4
# bench_serving_engine.py --speculative at full width (:2031-2034)
NGRAM_REQS, NGRAM_NEW = 64, 64
# --spec-v2 at full width (:2042-2045): 48 requests cut to 16 and the
# sampled band of 64 x 16 tokens to 16 x 16 (every drafted token is one
# eager model call, so a self-draft engine is host-bound)
DRAFT_LENS, DRAFT_REQS, DRAFT_NEW = (6, 9, 14, 22), 16, 48
SAMPLED_REQS, SAMPLED_NEW = 16, 16
SPEC_CUTS = ["serve-spec-draft: requests 48 -> 16",
             "serve-spec-draft: sampled band 64 x 16 -> 16 x 16 tokens"]


def verify_products(torch, model) -> dict:
    """Which products of a k=1 decode step ([16, 1] tokens) would give
    other bits in a [16, 4] block run whole: each linear of layer 0 and
    the LM head on 64 random rows in the model dtype against the same
    function of every fourth row alone (M = 64 vs M = 16), RMSNorm on
    [16, 4] against [16, 1], and the cache attention at 4 queries a row
    against 1. True = the same bits. The verify runs the norms, linears
    and head one position at a time (``per_position``), the attention
    whole."""
    from paddle_tpu_torch.models._decode_cache import _masked_attend
    dev, dt = model.device, model.llama.embed_tokens.weight.dtype
    g = torch.Generator(device=dev).manual_seed(1)
    layer = model.llama.layers[0]
    out = {}
    lin = {"q_proj": layer.self_attn.q_proj, "k_proj": layer.self_attn.k_proj,
           "v_proj": layer.self_attn.v_proj, "o_proj": layer.self_attn.o_proj,
           "gate_proj": layer.mlp.gate_proj, "up_proj": layer.mlp.up_proj,
           "down_proj": layer.mlp.down_proj, "lm_head": model.lm_head}
    with torch.inference_mode():
        for name, m in lin.items():
            x = torch.randn(SLOTS * SPEC_K, m.in_features, device=dev,
                            generator=g).to(dt)
            out[name] = torch.equal(m(x)[::SPEC_K], m(x[::SPEC_K]))
        x = torch.randn(SLOTS, SPEC_K, model.config.hidden_size, device=dev,
                        generator=g).to(dt)
        norm = layer.input_layernorm
        out["rms_norm"] = torch.equal(norm(x)[:, :1],
                                      norm(x[:, :1].contiguous()))
        cfg = model.config
        H, KV, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        q = torch.randn(SLOTS, SPEC_K, H, D, device=dev, generator=g)
        kc = torch.randn(SLOTS, MAX_LEN, KV, D, device=dev,
                         generator=g).to(dt)
        vc = torch.randn(SLOTS, MAX_LEN, KV, D, device=dev,
                         generator=g).to(dt)
        pos = torch.arange(SLOTS, device=dev) * 17 + 40
        qpos = pos[:, None] + torch.arange(SPEC_K, device=dev)[None]
        mask = torch.arange(MAX_LEN, device=dev)[None, None] \
            <= qpos[:, :, None]
        wide = _masked_attend(q, kc, vc, mask[:, None, None])
        one = _masked_attend(q[:, :1], kc, vc, mask[:, None, None, :1])
        out["cache_attention"] = torch.equal(
            wide.view(SLOTS, SPEC_K, -1)[:, :1], one)
    return out


def spec_forced(torch, np, model, prompts, base_reqs, **engine_kw):
    """Teacher forcing: an n-gram engine whose proposer drafts the k=1
    run's continuation and which emits the k=1 tokens whatever its
    argmax, so every verify position sees the k=1 run's tokens. Returns
    (agreement of the verify's argmax with the k=1 token, [(gap, bf16
    step)] at each split: the verify's max logit less the k=1 token's)."""
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        min_bucket=MIN_BUCKET, speculative=True,
                        spec_k=SPEC_K, spec_gate=False, **engine_kw)
    reqs = [eng.submit(p, max_new_tokens=len(b.output_ids))
            for p, b in zip(prompts, base_reqs)]
    want = {r.rid: b.output_ids for r, b in zip(reqs, base_reqs)}
    plen = {r.rid: r.prompt_len for r in reqs}
    drafted = {}

    def oracle(rid, ids, k):
        n = len(ids) - plen[rid]
        drafted[rid] = np.asarray(want[rid][n:n + k], np.int64)
        return drafted[rid]
    hits, gaps = [], []

    def forced(slot, req, greedy_row, acc, logits_row, draft=None,
               qs=None):
        ref = want[req.rid]
        n = len(req.out_tokens)
        for j in range(1 + len(drafted.pop(req.rid, ()))):
            tok = ref[n + j]
            hits.append(int(greedy_row[j]) == tok)
            if not hits[-1]:
                gaps.append(split_gap(logits_row[j], tok))
            req.out_tokens.append(tok)
            eng.metrics.on_token(req.rid)
            if eng._is_finished(req, tok):
                break
        return len(req.out_tokens) - n
    eng.proposer.propose = oracle
    eng._emit_verified = forced
    eng.run()
    no_leaks(eng, "teacher-forced verify")
    return sum(hits) / len(hits), gaps


def spec_identity(torch, np, model, name, prompts, base_reqs, reqs,
                  products, **engine_kw) -> dict:
    """The identity rule against the k=1 run of the same layout, teacher
    forcing through the verify's drafts (``spec_forced``); at a split,
    the products whose bits differ between the verify's M = 64 and the
    decode's M = 16 (``verify_products``) are named."""
    differ = [k for k, v in products.items() if not v]
    try:
        row = identity_rule(name, reqs, base_reqs, lambda: spec_forced(
            torch, np, model, prompts, base_reqs, **engine_kw),
            suffix="_vs_k1")
    except AssertionError as e:
        raise AssertionError(f"{e}; products whose bits differ at M=64 vs "
                             f"16: {differ}") from None
    if not row["token_identical"]:
        row["products_with_other_bits"] = differ
    return row


def spec_checked(name, engine) -> dict:
    """Gates every speculative phase shares: no draft fault (a broken
    draft path would pass as k=1 decoding), no leaked page, slot or
    proposer state. Returns spec_stats()."""
    from paddle_tpu_torch.resilience import engine_leak_violations
    st = engine.spec_stats()
    if st["draft_faults"]:
        raise AssertionError(f"{name}: {st['draft_faults']} draft faults")
    no_leaks(engine, name)
    leaks = engine_leak_violations(engine)
    if leaks:
        raise AssertionError(f"{name}: leaked engine state: {leaks}")
    return st


def spec_fields(st: dict) -> dict:
    return {k: st[k] for k in (
        "steps", "gated_steps", "rows", "emitted", "draft_tokens",
        "accepted_draft_tokens", "resamples", "draft_s", "acc_len_hist",
        "accepted_per_step", "draft_hit_rate")}


SPEC_LAYOUTS = {"contiguous": dict(kv_layout="contiguous"),
                "paged": dict(page_size=PAGE),
                "paged-int8": dict(page_size=PAGE, kv_dtype="int8")}


def phase_serve_spec(torch, np, model, prompts, k1_runs, products):
    """serve's trace through speculative=True, spec_k=4 n-gram engines on
    each layout, held to the k=1 engine of that layout (``k1_runs``:
    layout -> (requests, metrics summary)) by the identity rule."""
    from paddle_tpu_torch.serving import ServingEngine
    cfg = model.config
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]
    launches, rows = {}, {}
    for layout, kw in SPEC_LAYOUTS.items():
        name = f"serve-spec-{layout}"
        warm = ServingEngine(model, max_slots=2, max_len=MAX_LEN,
                             min_bucket=MIN_BUCKET, speculative=True,
                             spec_k=SPEC_K, **kw)
        for p in prompts[:2]:
            warm.submit(p, max_new_tokens=2)
        warm.run()
        del warm
        eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                            min_bucket=MIN_BUCKET, speculative=True,
                            spec_k=SPEC_K, **kw)
        reqs, wall, counts = serve_run(torch, eng, prompts, news)
        flash = flash_only(name, counts, cfg.num_hidden_layers * len(reqs))
        launches[layout] = {"flash_attention_fwd": flash}
        st = spec_checked(name, eng)
        m = eng.metrics.summary()
        base_reqs, base_m = k1_runs[layout]
        del eng
        ident = spec_identity(torch, np, model, name, prompts, base_reqs,
                              reqs, products, **kw)
        rows[layout] = {
            "wall_s": wall, "tokens": m["total_tokens"],
            "tokens_per_s": m["tokens_per_s"],
            "tokens_per_s_k1": base_m["tokens_per_s"],
            "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
            "ttft_p50_s_k1": base_m["ttft_p50_s"],
            "ttft_p99_s_k1": base_m["ttft_p99_s"],
            "engine_steps": m["steps"], "engine_steps_k1": base_m["steps"],
            "flash_launches": flash, "spec_stats": spec_fields(st),
            "spec_draft_s": m["spec_draft_s"], **ident}
    emit({"phase": "serve-spec", "requests": len(prompts), "k": SPEC_K,
          "proposer": "ngram", "verify_products_same_bits": products,
          **rows, "draft_faults": 0, "leaks": 0})
    return launches


def spec_drive(torch, np, model, prompts, news, **engine_kw):
    """bench_serving_engine.py's drive(): every prompt to 2 tokens first
    (every path warm), then the metrics and spec counters reset and the
    trace served by serve_run; steps from the fresh metrics."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.metrics import EngineMetrics
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        min_bucket=MIN_BUCKET, **engine_kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=2)
    eng.run()
    eng.metrics = EngineMetrics(SLOTS, time.perf_counter)
    if eng.speculative:
        eng._spec = {k: ([0] * len(v) if isinstance(v, list) else type(v)())
                     for k, v in eng._spec.items()}
    reqs, wall, counts = serve_run(torch, eng, prompts, news)
    m = eng.metrics.summary()
    return {"engine": eng, "reqs": reqs, "steps": m["steps"],
            "wall_s": wall, "tokens": m["total_tokens"],
            "tokens_per_s": m["total_tokens"] / wall, "metrics": m,
            "launches": counts}


def logits_read_ms(torch, np, model) -> float:
    """Host ms of one read of the verify's [16, 4, vocab] f32 logits to
    numpy (the median of 5 after one warm read)."""
    logits = torch.randn(SLOTS, SPEC_K, model.config.vocab_size,
                         device=model.device)
    reads = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits.cpu().numpy()
        reads.append(time.perf_counter() - t0)
    return float(np.median(reads[1:])) * 1e3


def ngram_trace(np):
    """run_speculative's periodic prompts (seed 0)."""
    rng = np.random.RandomState(0)
    prompts = []
    for _ in range(NGRAM_REQS):
        pat = rng.randint(1, 100, (int(rng.randint(1, 4)),)).astype(np.int64)
        L = int(rng.randint(8, 24))
        prompts.append(np.tile(pat, L // len(pat) + 1)[:L])
    return prompts


def phase_serve_spec_ngram(torch, np, model, products):
    """bench_serving_engine.py --speculative at its full-width settings:
    the k=1 and the speculative paged engine on the same 64 periodic
    prompts; SPEC_DECODE's fields (its bars printed, not gated: with
    random weights, whether greedy decode falls into the prompt's cycle
    is a finding), and 8 verify steps under the profiler beside 8 k=1
    decode steps."""
    cfg = model.config
    t0 = time.perf_counter()
    prompts = ngram_trace(np)
    news = [NGRAM_NEW] * len(prompts)
    base = spec_drive(torch, np, model, prompts, news, page_size=PAGE)
    spec = spec_drive(torch, np, model, prompts, news, page_size=PAGE,
                      speculative=True, spec_k=SPEC_K)
    want = cfg.num_hidden_layers * len(prompts)
    for run, name in ((base, "k1"), (spec, "speculative")):
        flash_only(f"serve-spec-ngram {name}", run["launches"], want)
    st = spec_checked("serve-spec-ngram", spec["engine"])
    no_leaks(base["engine"], "serve-spec-ngram k1")
    del base["engine"], spec["engine"]
    ident = spec_identity(torch, np, model, "serve-spec-ngram", prompts,
                          base["reqs"], spec["reqs"], products,
                          page_size=PAGE)
    reduction = 1.0 - spec["steps"] / max(1, base["steps"])
    summary = {
        "k": SPEC_K, "requests": len(prompts), "tokens": spec["tokens"],
        "steps_speculative": spec["steps"], "steps_k1": base["steps"],
        "step_reduction": reduction,
        "accepted_per_step": st["accepted_per_step"],
        "draft_hit_rate": st["draft_hit_rate"],
        "draft_tokens": st["draft_tokens"],
        "accepted_draft_tokens": st["accepted_draft_tokens"],
        "acc_len_hist": st["acc_len_hist"],
        "tok_latency_p50_s": spec["metrics"]["tok_latency_p50_s"],
        "tok_latency_p99_s": spec["metrics"]["tok_latency_p99_s"],
        "tok_latency_p50_s_k1": base["metrics"]["tok_latency_p50_s"],
        "tok_latency_p99_s_k1": base["metrics"]["tok_latency_p99_s"],
        "tokens_per_s_speculative": spec["tokens_per_s"],
        "tokens_per_s_k1": base["tokens_per_s"],
        "token_identical": ident["token_identical"]}
    bars = {"accepted_per_step > 1.5": st["accepted_per_step"] > 1.5,
            "step_reduction >= 0.25": reduction >= 0.25,
            "draft_hit_rate > 0.2": st["draft_hit_rate"] > 0.2}
    # 8 steps of 16 busy slots each; the verify with spec_gate off, so
    # every step is a verify step
    prof = {"verify": decode_profile(
                torch, model, prompts[:SLOTS], page_size=PAGE, new=NGRAM_NEW,
                speculative=True, spec_k=SPEC_K, spec_gate=False),
            "decode": decode_profile(torch, model, prompts[:SLOTS],
                                     page_size=PAGE, new=NGRAM_NEW)}
    read = logits_read_ms(torch, np, model)
    prof["verify"].update(
        logits_bytes=SLOTS * SPEC_K * cfg.vocab_size * 4,
        logits_read_host_ms=read,
        logits_read_share_of_step=read / prof["verify"]["wall_ms_per_step"])
    emit({"phase": "serve-spec-ngram", "page_size": PAGE, "slots": SLOTS,
          "max_len": MAX_LEN, "min_bucket": MIN_BUCKET,
          "spec_decode": summary, "reference_bars_cpu": bars, **ident,
          "wall_s_k1": base["wall_s"], "wall_s_speculative": spec["wall_s"],
          "gated_steps": st["gated_steps"],
          "flash_launches": spec["launches"]["flash_attention_fwd"],
          "profile": prof, "draft_faults": 0, "leaks": 0,
          "phase_s": time.perf_counter() - t0})
    return {"flash_attention_fwd": spec["launches"]["flash_attention_fwd"]}


def phase_serve_spec_draft(torch, np, model, products):
    """bench_serving_engine.py --spec-v2 at its full-width shape (cut as
    SPEC_CUTS lists): k=1, n-gram, self-draft and tuned engines on 16
    low-self-similarity prompts, SPEC_V2's fields, then the sampled band
    through the self-draft spec_sampled engine against k=1, beside the
    TV of two k=1 bands with disjoint seeds (the noise floor at a
    32000-token vocabulary; the reference's 0.2 bar is for 128 tokens,
    and is gated in the CPU test)."""
    from paddle_tpu_torch.serving import SamplingParams, ServingEngine
    cfg = model.config
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 100, (int(rng.choice(DRAFT_LENS)),))
               .astype(np.int64) for _ in range(DRAFT_REQS)]
    news = [DRAFT_NEW] * len(prompts)
    spec = dict(speculative=True, spec_k=SPEC_K)
    runs = {"k1": spec_drive(torch, np, model, prompts, news)}
    runs["ngram"] = spec_drive(torch, np, model, prompts, news, **spec)
    runs["draft"] = spec_drive(torch, np, model, prompts, news, **spec,
                               spec_proposer="draft", draft_model=model)
    runs["tuned"] = spec_drive(torch, np, model, prompts, news, **spec,
                               spec_proposer="draft", draft_model=model,
                               spec_tune=True)
    want = cfg.num_hidden_layers * len(prompts)
    stats, ident, seconds = {}, {}, {}
    for name, run in runs.items():
        flash_only(f"serve-spec-draft {name}", run["launches"], want)
        seconds[name] = run["wall_s"]
        if name != "k1":
            stats[name] = spec_checked(f"serve-spec-draft {name}",
                                       run["engine"])
        else:
            no_leaks(run["engine"], "serve-spec-draft k1")
    draft_s = runs["draft"]["metrics"]["spec_draft_s"]
    for run in runs.values():
        del run["engine"]
    for name in ("ngram", "draft", "tuned"):
        ident[name] = spec_identity(torch, np, model,
                                    f"serve-spec-draft {name}", prompts,
                                    runs["k1"]["reqs"], runs[name]["reqs"],
                                    products)
    vocab = cfg.vocab_size

    def band(seed0, **kw):
        eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                            min_bucket=MIN_BUCKET, **kw)
        reqs = [eng.submit(prompts[i % len(prompts)], SAMPLED_NEW,
                           sampling=SamplingParams(temperature=0.8, top_k=8,
                                                   seed=seed0 + i))
                for i in range(SAMPLED_REQS)]
        eng.run()
        if kw:
            stats["sampled"] = spec_checked("serve-spec-draft sampled", eng)
        toks = [t for r in reqs for t in r.output_ids]
        return np.bincount(toks, minlength=vocab).astype(np.float64)

    def tv(a, b):
        return 0.5 * float(np.abs(a / a.sum() - b / b.sum()).sum())
    h_base, h_floor = band(1000), band(2000)
    h_spec = band(1000, **spec, spec_proposer="draft", draft_model=model,
                  spec_sampled=True)
    st_n, st_d, st_t = stats["ngram"], stats["draft"], stats["tuned"]
    summary = {
        "k": SPEC_K, "requests": len(prompts),
        "accepted_per_step_ngram": st_n["accepted_per_step"],
        "accepted_per_step_draft": st_d["accepted_per_step"],
        "accepted_per_step_tuned": st_t["accepted_per_step"],
        "draft_vs_ngram": st_d["accepted_per_step"]
        / max(1e-9, st_n["accepted_per_step"]),
        "draft_overhead_frac": draft_s / runs["draft"]["wall_s"],
        "draft_hit_rate_ngram": st_n["draft_hit_rate"],
        "draft_hit_rate_draft": st_d["draft_hit_rate"],
        "tuner_k": st_t["tuner"]["classes"]["greedy"]["k"],
        "tuner_kind": st_t["tuner"]["classes"]["greedy"]["kind"],
        "tuner_flips": st_t["tuner"]["flips"],
        "token_identical": all(i["token_identical"] for i in ident.values()),
        "sampled_requests": SAMPLED_REQS,
        "sampled_tokens": int(h_spec.sum()),
        "sampled_parity_tv": tv(h_base, h_spec),
        "sampled_parity_ok": tv(h_base, h_spec) < 0.2,
        "steps_k1": runs["k1"]["steps"], "steps_ngram": runs["ngram"]["steps"],
        "steps_draft": runs["draft"]["steps"]}
    emit({"phase": "serve-spec-draft", "spec_v2": summary,
          "sampled_parity_tv_k1_vs_k1": tv(h_base, h_floor),
          "sampled_resamples": stats["sampled"]["resamples"],
          "sampled_accepted_draft_tokens":
              stats["sampled"]["accepted_draft_tokens"],
          "identity": ident, "wall_s": seconds,
          "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
          "spec_draft_s": draft_s,
          "flash_launches": {k: r["launches"]["flash_attention_fwd"]
                             for k, r in runs.items()},
          "cuts": SPEC_CUTS, "draft_faults": 0, "leaks": 0,
          "phase_s": time.perf_counter() - t0})
    return {k: {"flash_attention_fwd": r["launches"]["flash_attention_fwd"]}
            for k, r in runs.items()}


def count_calls(engine, method: str) -> list:
    """Wrap ``engine.<method>`` on the instance; returns a one-item list
    that counts its calls."""
    n = [0]
    fn = getattr(engine, method)

    def counted(*a, **kw):
        n[0] += 1
        return fn(*a, **kw)
    setattr(engine, method, counted)
    return n


def served_by_length(name, reqs, news) -> None:
    for r, n in zip(reqs, news):
        if not (r.finished and r.finish_reason == "length"
                and len(r.output_ids) == n):
            raise AssertionError(
                f"{name}: request {r.rid}: {r.finish_reason}, "
                f"{len(r.output_ids)} of {n} tokens")


def quiesced(name, engine, ledger=None) -> None:
    """No leaked slot, queue entry, chunk or proposer state, no leaked
    page, and (with an auditor) every request delivered exactly once."""
    from paddle_tpu_torch.resilience import engine_leak_violations
    bad = engine_leak_violations(engine)
    if ledger is not None:
        bad += ledger.violations()
    if bad:
        raise AssertionError(f"{name}: {bad}")
    no_leaks(engine, name)


# -- chunked prefill (ServingEngine(prefill_chunk=...)) ----------------------
# bench_serving_engine.py --chunked-prefill at full width (:1971-1975):
# 16 slots, max_len 512, min_bucket 32, chunk 64, page 128; short
# prompts of 24 and 48 tokens x 64 new, long prompts of 420 and 480
# tokens x 4 new arriving at step 3; prefix sharing off
CP_CHUNK = 64
CP_SHORT_LENS, CP_SHORT_NEW = (24, 48), 64
CP_LONG_LENS, CP_LONG_NEW = (420, 480), 4
CP_ARRIVAL = 3
CP_STALL_BAR = 3.0               # the reference's bar, printed, not gated
CP_LAYOUTS = {"paged": {}, "paged-int8": dict(kv_dtype="int8"),
              "contiguous": dict(kv_layout="contiguous")}


def cp_trace(np):
    """run_chunked_prefill's prompts (RandomState(0), ids 1-99)."""
    rng = np.random.RandomState(0)
    shorts = [rng.randint(1, 100, (L,)).astype(np.int64)
              for L in CP_SHORT_LENS]
    longs = [rng.randint(1, 100, (L,)).astype(np.int64)
             for L in CP_LONG_LENS]
    return shorts, longs


def cp_engine(model, **kw):
    """An engine of the chunked trace's shape, with its own registry."""
    from paddle_tpu_torch.observability import MetricRegistry
    from paddle_tpu_torch.serving import ServingEngine
    if kw.get("kv_layout") != "contiguous":
        kw = dict(page_size=PAGE, prefix_sharing=False, **kw)
    kw.setdefault("registry", MetricRegistry())
    return ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                         min_bucket=MIN_BUCKET, **kw)


def cp_drive(torch, model, shorts, longs, tf=None, **engine_kw):
    """run_chunked_prefill's drive(): every prompt to 2 tokens first
    (every path warm), then the shorts, the longs at step CP_ARRIVAL, on
    the clock of the step calls (each step ends reading its logits to
    the host); the max and p99 inter-token gap of the shorts. The launch
    counts are set to 0 just before the trace and read just after; the
    monolithic prefills (``_full_prefill``, the flash route) and the
    chunks run are counted and timed (each ends reading its logits to
    the host), with the flash launches inside chunks."""
    from paddle_tpu_torch.ops.flash_attention import flash_attention_fwd
    eng = cp_engine(model, **engine_kw)
    for p in shorts + longs:
        eng.submit(p, max_new_tokens=2)
    eng.run()
    chunk_lens, chunk_flash, chunk_s, full_s = [], [0], [], []
    run_chunk, full_prefill = eng._run_chunk, eng._full_prefill

    def spied(slot, padded, pos, t):
        f0 = flash_attention_fwd.launches
        t0 = time.perf_counter()
        out = run_chunk(slot, padded, pos, t)
        chunk_s.append(time.perf_counter() - t0)
        chunk_flash[0] += flash_attention_fwd.launches - f0
        chunk_lens.append(int(padded.shape[1]))
        return out

    def timed(slot, padded, n):
        t0 = time.perf_counter()
        out = full_prefill(slot, padded, n)
        full_s.append((int(padded.shape[1]), time.perf_counter() - t0))
        return out
    eng._run_chunk, eng._full_prefill = spied, timed

    def submit(prompts, new):
        reqs = [eng.submit(p, max_new_tokens=new) for p in prompts]
        for r in reqs if tf is not None else ():
            tf.track(r)
        return reqs
    torch.cuda.synchronize()
    reset_launches()
    s_reqs = submit(shorts, CP_SHORT_NEW)
    l_reqs = []
    clock, steps, gaps = 0.0, 0, []
    seen = {r.rid: (0, None) for r in s_reqs}
    while eng.has_work():
        if steps == CP_ARRIVAL:
            l_reqs = submit(longs, CP_LONG_NEW)
        w0 = time.perf_counter()
        eng.step()
        clock += time.perf_counter() - w0
        steps += 1
        for r in s_reqs:
            n, t_last = seen[r.rid]
            if len(r.out_tokens) > n:
                if t_last is not None:
                    gaps.append(clock - t_last)
                seen[r.rid] = (len(r.out_tokens), clock)
    torch.cuda.synchronize()
    return {"engine": eng, "reqs": s_reqs + l_reqs, "steps": steps,
            "gaps": gaps, "wall_s": clock, "launches": read_launches(),
            "full_prefills": len(full_s), "chunk_steps": len(chunk_lens),
            "chunk_lengths": sorted(set(chunk_lens)),
            "chunk_flash": chunk_flash[0],
            "chunk_ms_mean": 1e3 * sum(chunk_s) / max(1, len(chunk_s)),
            "prefill_512_ms": [1e3 * t for b, t in full_s if b == MAX_LEN]}


def cp_checked(name, run, layers) -> int:
    """The chunked trace's gates: every request by length, row 1 exactly
    layers x monolithic prefills and never inside a chunk, no other
    kernel, nothing leaked. Returns the flash launches."""
    served_by_length(name, run["reqs"],
                     [CP_SHORT_NEW] * len(CP_SHORT_LENS)
                     + [CP_LONG_NEW] * len(CP_LONG_LENS))
    if run["chunk_flash"]:
        raise AssertionError(f"{name}: {run['chunk_flash']} flash launches "
                             f"inside chunk steps")
    quiesced(name, run["engine"])
    return flash_only(name, run["launches"], layers * run["full_prefills"])


def cp_forced(torch, model, shorts, longs, base_reqs, **engine_kw):
    """The chunked trace again, fed the base run's tokens."""
    with teacher_forcing([r.output_ids for r in base_reqs]) as tf:
        run = cp_drive(torch, model, shorts, longs, tf=tf, **engine_kw)
    quiesced("teacher-forced chunked run", run["engine"])
    return tf.result()


# a burst of long prompts, all queued at once (CP_BURST of 420 and 480
# tokens in turn x 4 new, RandomState(1), ids 1-99): 12 in the chunk FIFO
# pass the ChunkBudgetController's raise_depth (6), so after its dwell
# (8 steps) it raises the budget to 2 and then 4 chunks a step; held to
# the same burst through the chunk-64 engine without a controller (the
# same chunks, one a step)
CP_BURST = 12


def cp_burst(torch, model, prompts, tf=None, **engine_kw):
    """Queue ``prompts`` at once on a paged prefill_chunk=64 engine and
    serve them to the end; the chunks each step ran, and the launches."""
    eng = cp_engine(model, prefill_chunk=CP_CHUNK, **engine_kw)
    ran = count_calls(eng, "_run_chunk")
    torch.cuda.synchronize()
    reset_launches()
    reqs = [eng.submit(p, max_new_tokens=CP_LONG_NEW) for p in prompts]
    for r in reqs if tf is not None else ():
        tf.track(r)
    per_step = []
    t0 = time.perf_counter()
    while eng.has_work():
        before = ran[0]
        eng.step()
        per_step.append(ran[0] - before)
    torch.cuda.synchronize()
    return {"engine": eng, "reqs": reqs, "steps": len(per_step),
            "chunk_steps": ran[0], "most_chunks_a_step": max(per_step),
            "wall_s": time.perf_counter() - t0, "launches": read_launches()}


def cp_burst_checked(torch, np, model) -> dict:
    """The controller's raised budget on the card: the burst through a
    ChunkBudgetController engine, which must adapt and run more than one
    chunk in a step, held by the identity rule to the burst without one;
    every request by length, no monolithic prefill (row 1 never
    launched), nothing leaked."""
    from paddle_tpu_torch.observability import MetricRegistry
    from paddle_tpu_torch.serving import ChunkBudgetController
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 100, (CP_LONG_LENS[i % 2],)).astype(np.int64)
               for i in range(CP_BURST)]

    def ctl():
        return ChunkBudgetController(registry=MetricRegistry())
    runs = {"one_chunk": cp_burst(torch, model, prompts),
            "controller": cp_burst(torch, model, prompts,
                                   chunk_control=ctl())}
    row = {}
    for name, run in runs.items():
        full = f"serve-chunked-burst {name}"
        served_by_length(full, run["reqs"], [CP_LONG_NEW] * CP_BURST)
        quiesced(full, run["engine"])
        flash_only(full, run["launches"], 0)
        row[name] = {k: run[k] for k in ("steps", "chunk_steps",
                                         "most_chunks_a_step", "wall_s")}
    snap = runs["controller"]["engine"].chunk_control.snapshot()
    row["controller"]["controller"] = snap
    if snap["adaptations"] < 1 or runs["controller"]["most_chunks_a_step"] < 2:
        raise AssertionError(
            f"serve-chunked-burst: the controller never raised the budget "
            f"({snap}, at most {runs['controller']['most_chunks_a_step']} "
            f"chunks a step)")

    def forced():
        with teacher_forcing([r.output_ids
                              for r in runs["one_chunk"]["reqs"]]) as tf:
            run = cp_burst(torch, model, prompts, tf=tf, chunk_control=ctl())
        quiesced("teacher-forced burst", run["engine"])
        return tf.result()
    row.update(identity_rule("serve-chunked-burst",
                             runs["controller"]["reqs"],
                             runs["one_chunk"]["reqs"], forced))
    row["requests"] = CP_BURST
    return row


CP_PROFILE_STEPS = 4


def cp_profile(torch, model, shorts, longs) -> dict:
    """Steps of each kind under the profiler, the shorts decoding in all
    three: CP_PROFILE_STEPS plain decode steps, CP_PROFILE_STEPS steps
    that each run one 64-token chunk of the 480-token prompt beside the
    decode, and (unchunked) the one step that runs its whole prefill
    beside the decode; ms a step."""
    def busy(chunked):
        eng = cp_engine(model, **(dict(prefill_chunk=CP_CHUNK)
                                  if chunked else {}))
        for p in shorts:
            eng.submit(p, max_new_tokens=CP_SHORT_NEW)
        while eng._chunk_fifo or not all(
                r.out_tokens for r in eng.cache.slots if r is not None):
            eng.step()
        eng.step()
        return eng

    def steps(eng, n):
        return lambda: [eng.step() for _ in range(n)]

    def decode():
        return steps(busy(True), CP_PROFILE_STEPS)

    def chunk():
        eng = busy(True)
        eng.submit(longs[-1], max_new_tokens=CP_LONG_NEW)
        eng.step()                      # admission and the first chunk
        return steps(eng, CP_PROFILE_STEPS)   # a chunk and the decode each

    def prefill():
        eng = busy(False)
        eng.submit(longs[-1], max_new_tokens=CP_LONG_NEW)
        return steps(eng, 1)
    out = {}
    for name, setup, n in (("decode_step", decode, CP_PROFILE_STEPS),
                           ("chunk_step", chunk, CP_PROFILE_STEPS),
                           ("prefill_480_step", prefill, 1)):
        wall, dev, top = profiled(torch, setup)
        out[name] = {"steps": n, "wall_ms": wall * 1e3 / n,
                     "device_ms": dev * 1e3 / n,
                     "device_busy_share": dev / wall,
                     "top_kernels_ms": [(k, ms / n) for k, ms in top[:4]]}
    return out


def phase_serve_chunked(torch, np, model):
    """bench_serving_engine.py --chunked-prefill at full width: the
    unchunked and the prefill_chunk=64 engine on the paged layout
    (CHUNKED_PREFILL's fields), the same pair on paged int8 and
    contiguous and a fifth, paged engine with a ChunkBudgetController,
    each chunked run held to its layout's unchunked run by the identity
    rule; a burst of long prompts through a controller engine, whose
    raised budget runs several chunks a step; one decode, chunk and
    whole-prefill step profiled."""
    from paddle_tpu_torch.observability import MetricRegistry
    from paddle_tpu_torch.serving import ChunkBudgetController, \
        prefill_buckets
    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    shorts, longs = cp_trace(np)
    rows, launches, paged = {}, {}, {}
    for layout, kw in CP_LAYOUTS.items():
        name = f"serve-chunked-{layout}"
        base = cp_drive(torch, model, shorts, longs, **kw)
        ck = cp_drive(torch, model, shorts, longs, prefill_chunk=CP_CHUNK,
                      **kw)
        flash = {k: cp_checked(f"{name} {k}", r, layers)
                 for k, r in (("unchunked", base), ("chunked", ck))}
        del base["engine"], ck["engine"]
        ident = identity_rule(name, ck["reqs"], base["reqs"], lambda: cp_forced(
            torch, model, shorts, longs, base["reqs"],
            prefill_chunk=CP_CHUNK, **kw))
        launches[layout] = {"flash_attention_fwd": flash["chunked"]}
        rows[layout] = {"flash_launches": flash, **ident,
                        "max_decode_stall_s": {"unchunked": max(base["gaps"]),
                                               "chunked": max(ck["gaps"])}}
        if layout == "paged":
            paged = {"base": base, "ck": ck}
    base, ck = paged["base"], paged["ck"]
    ctl_run = cp_drive(torch, model, shorts, longs, prefill_chunk=CP_CHUNK,
                       chunk_control=ChunkBudgetController(
                           registry=MetricRegistry()))
    ctl = ctl_run["engine"].chunk_control.snapshot()
    flash = cp_checked("serve-chunked-controller", ctl_run, layers)
    del ctl_run["engine"]
    launches["controller"] = {"flash_attention_fwd": flash}
    rows["controller"] = {
        "flash_launches": flash, "controller": ctl,
        "max_decode_stall_s": max(ctl_run["gaps"]),
        "steps": ctl_run["steps"], "chunk_steps": ctl_run["chunk_steps"],
        **identity_rule("serve-chunked-controller", ctl_run["reqs"],
                        base["reqs"], lambda: cp_forced(
                            torch, model, shorts, longs, base["reqs"],
                            prefill_chunk=CP_CHUNK,
                            chunk_control=ChunkBudgetController(
                                registry=MetricRegistry())))}
    rows["burst"] = cp_burst_checked(torch, np, model)
    launches["burst"] = {"flash_attention_fwd": 0}
    stall_base, stall_ck = max(base["gaps"]), max(ck["gaps"])
    reduction = stall_base / stall_ck
    summary = {   # CHUNKED_PREFILL's fields, without the compile counts
        "chunk": CP_CHUNK, "requests_short": len(shorts),
        "requests_long": len(longs),
        "long_prompt_lens": [int(p.shape[0]) for p in longs],
        "max_decode_stall_s_unchunked": stall_base,
        "max_decode_stall_s_chunked": stall_ck,
        "stall_reduction": reduction,
        "tok_latency_p99_s_unchunked": float(np.percentile(base["gaps"], 99)),
        "tok_latency_p99_s_chunked": float(np.percentile(ck["gaps"], 99)),
        "steps_unchunked": base["steps"], "steps_chunked": ck["steps"],
        "chunk_steps": ck["chunk_steps"],
        "token_identical": rows["paged"]["token_identical"],
        "chunk_lengths_run": ck["chunk_lengths"],
        "prefill_buckets": prefill_buckets(MIN_BUCKET, MAX_LEN)}
    if not set(ck["chunk_lengths"]) <= set(summary["prefill_buckets"]):
        raise AssertionError(f"serve-chunked: chunk lengths "
                             f"{ck['chunk_lengths']} outside the buckets")
    emit({"phase": "serve-chunked", "slots": SLOTS, "max_len": MAX_LEN,
          "min_bucket": MIN_BUCKET, "page_size": PAGE,
          "chunked_prefill": summary,
          "reference_bar_cpu": {f"stall_reduction >= {CP_STALL_BAR}":
                                reduction >= CP_STALL_BAR},
          "wall_s": {"unchunked": base["wall_s"], "chunked": ck["wall_s"]},
          "monolithic_prefills": {"unchunked": base["full_prefills"],
                                  "chunked": ck["full_prefills"]},
          "chunk_ms_mean": ck["chunk_ms_mean"],
          "prefill_512_ms_unchunked": base["prefill_512_ms"],
          **{f"layout_{k}": v for k, v in rows.items()},
          "profile": cp_profile(torch, model, shorts, longs), "leaks": 0,
          "phase_s": time.perf_counter() - t0})
    return launches, ck["reqs"]


# -- resilience: faults and recover() ----------------------------------------
# serve's trace on each layout: serving.step.prefill at the 4th admission
# of step 0 (3 requests in slots, 13 requeued) and serving.step.decode at
# the 21st decode step, each followed by recover(); the chunked trace on
# a paged prefill_chunk=64 engine: serving.prefill.chunk at its 5th chunk
# (the 420-token prompt's 4th, at position 192)
RC_SERVE_FAULTS = (("serving.step.prefill", 3), ("serving.step.decode", 20))
RC_CHUNK_FAULTS = (("serving.prefill.chunk", 4),)
# serve's trace on the paged layout with serving.step.decode at its 151st
# decode step, where the four 160-token requests have delivered 151
# tokens: recover() replays 150 decode forwards (its latency grows with
# the longest delivered output)
RC_LATE_FAULTS = (("serving.step.decode", 150),)
# the prefix-share trace's first 16 prompts (prefix_trace: two 384-token
# system prompts in turn, + 16 tokens) on the paged layout with prefix
# sharing (the default), outputs 4, 4, then 16 and 32 in turn, and
# serve's two faults: the prefill fault leaves requests 0-2 in slots
# (2 sharing 0's three pages), which recover() writes again in admission
# order, 2 matching 0 again (no reroute); at the decode fault (step 9)
# requests 0 and 1, whose prefills wrote every shared page, have
# finished, so 2 and 3 run their prompts whole (2 reroutes) and the
# later requests share their pages again
RC_PREFIX_NEWS = (4, 4) + (16, 32) * 7
RC_PREFIX_FAULTS = (("serving.step.prefill", 3), ("serving.step.decode", 8))
RC_PREFIX_REROUTES = [0, 2]


def rc_drive(torch, model, arrivals, faults_at, tf=None, **engine_kw):
    """Serve ``arrivals`` (step -> [(prompt, new tokens)]) with each of
    ``faults_at`` ((point, hits to skip)) armed to fire once, calling
    recover() after each injected fault, and nothing else caught. A
    ConservationLedger audits the engine and a FlightRecorder dumps into
    a temporary directory. Returns the requests, the recover reports
    (with the peak device memory across each), the flash launches and
    monolithic prefills, and the gates' numbers."""
    import gc
    import shutil
    import tempfile
    from paddle_tpu_torch.observability import FlightRecorder, MetricRegistry
    from paddle_tpu_torch.resilience import ConservationLedger, faults
    from paddle_tpu_torch.serving import ServingEngine
    # earlier runs' engines sit in reference cycles (count_calls wraps a
    # bound method on its own instance): free their pools first, so the
    # memory before a recover is this engine's
    gc.collect()
    dump_dir = tempfile.mkdtemp(prefix="ptpu_flight_")
    led = ConservationLedger()
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        min_bucket=MIN_BUCKET, registry=MetricRegistry(),
                        flight_recorder=FlightRecorder(dump_dir=dump_dir),
                        auditor=led, **engine_kw)
    full = count_calls(eng, "_full_prefill")
    reqs, reports = [], []
    faults.clear()
    faults.reset_counts()
    try:
        for point, after in faults_at:
            faults.inject(point, times=1, after=after)
        torch.cuda.synchronize()
        reset_launches()
        for steps in itertools.count():
            for p, n in arrivals.get(steps, ()):
                reqs.append(eng.submit(p, max_new_tokens=n))
                if tf is not None:
                    tf.track(reqs[-1])
            if not eng.has_work():
                if steps >= max(arrivals):
                    break
                continue
            try:
                eng.step()
            except faults.InjectedFault:
                longest = max((len(r.out_tokens) for r in eng.cache.slots
                               if r is not None and not r.finished),
                              default=0)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                rep = eng.recover()
                torch.cuda.synchronize()
                reports.append({
                    "reason": rep["reason"],
                    "recovered_slots": rep["recovered_slots"],
                    "replay_mismatches": rep["replay_mismatches"],
                    "reroutes": rep["reroutes"],
                    "handed_back": len(rep["finished"]),
                    "longest_delivered": longest,
                    "latency_s": rep["latency_s"],
                    "mem_before_gib": before / 2**30,
                    "peak_mem_gib": torch.cuda.max_memory_allocated()
                    / 2**30})
        torch.cuda.synchronize()
        launches = read_launches()
        fired = sum(faults.fired().values())
    finally:
        faults.clear()
    dumps = sorted(os.listdir(dump_dir))
    errors = sum(any(r["kind"] == "serving.step_error" for r in json.load(
        open(os.path.join(dump_dir, d)))["records"]) for d in dumps)
    shutil.rmtree(dump_dir)
    recoveries = eng.registry.get("ptpu_serving_recoveries_total").value
    news = [r.max_new_tokens for r in reqs]
    served_by_length("serve-recover", reqs, news)
    quiesced("serve-recover", eng, led)
    if not (fired == len(faults_at) == len(reports) == recoveries
            == len(dumps) == errors):
        raise AssertionError(
            f"serve-recover: {len(faults_at)} faults armed, {fired} fired, "
            f"{len(reports)} recovered, ptpu_serving_recoveries_total "
            f"{recoveries}, {len(dumps)} flight-recorder dumps, {errors} "
            f"with a serving.step_error record")
    return {"reqs": reqs, "reports": reports, "launches": launches,
            "full_prefills": full[0], "faults": fired,
            "recoveries_total": recoveries, "dumps": len(dumps),
            "kv_bytes": eng.cache.kv_bytes(), "ledger_violations": 0}


def phase_serve_recover(torch, np, model, prompts, base_runs, chunked_base):
    """serve's trace on the paged and contiguous layouts with a prefill
    and a decode fault, and on the paged layout with a late decode fault;
    the prefix-share trace's first 16 prompts with serve's two faults;
    the chunked trace with a mid-prompt chunk fault; each recovered and
    held to its fault-free run by the identity rule (``base_runs``:
    layout -> serve's requests there; ``chunked_base``: serve-chunked's
    paged chunk-64 requests; the prefix trace's is run here)."""
    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]
    serve = {0: list(zip(prompts, news))}
    shorts, longs = cp_trace(np)
    chunked = {0: [(p, CP_SHORT_NEW) for p in shorts],
               CP_ARRIVAL: [(p, CP_LONG_NEW) for p in longs]}
    prefix = {0: list(zip(prefix_trace(np)[1][:SLOTS], RC_PREFIX_NEWS))}
    prefix_base = rc_drive(torch, model, prefix, (), page_size=PAGE)
    runs = {
        "paged": (serve, RC_SERVE_FAULTS, dict(page_size=PAGE),
                  base_runs["paged"]),
        "contiguous": (serve, RC_SERVE_FAULTS,
                       dict(kv_layout="contiguous"), base_runs["contiguous"]),
        "paged-late": (serve, RC_LATE_FAULTS, dict(page_size=PAGE),
                       base_runs["paged"]),
        "paged-prefix": (prefix, RC_PREFIX_FAULTS, dict(page_size=PAGE),
                         prefix_base["reqs"]),
        "paged-chunked": (chunked, RC_CHUNK_FAULTS, dict(
            page_size=PAGE, prefix_sharing=False, prefill_chunk=CP_CHUNK),
            chunked_base)}
    rows, launches = {}, {}
    for name, (arrivals, faults_at, kw, base_reqs) in runs.items():
        run = rc_drive(torch, model, arrivals, faults_at, **kw)
        flash = flash_only(f"serve-recover-{name}", run["launches"],
                           layers * run["full_prefills"])
        reroutes = [r["reroutes"] for r in run["reports"]]
        if reroutes != (RC_PREFIX_REROUTES if name == "paged-prefix"
                        else [0] * len(faults_at)):
            raise AssertionError(f"serve-recover-{name}: reroutes "
                                 f"{reroutes}")

        def forced():
            with teacher_forcing([r.output_ids for r in base_reqs]) as tf:
                rc_drive(torch, model, arrivals, faults_at, tf=tf, **kw)
            return tf.result()
        ident = identity_rule(f"serve-recover-{name}", run["reqs"],
                              base_reqs, forced)
        launches[name] = {"flash_attention_fwd": flash}
        rows[name] = {
            "faults": [p for p, _ in faults_at], "reports": run["reports"],
            "recoveries_total": run["recoveries_total"],
            "flight_recorder_dumps": run["dumps"],
            "monolithic_prefills": run["full_prefills"],
            "flash_launches": flash, "kv_bytes": run["kv_bytes"],
            "ledger_violations": 0, **ident}
    emit({"phase": "serve-recover", "slots": SLOTS, "max_len": MAX_LEN,
          **rows, "leaks": 0, "phase_s": time.perf_counter() - t0})
    return launches


# -- the KV host tier (ServingEngine(kv_host_tier=True)) ---------------------
# bench_serving_engine.py --kv-tiering at full width (:2007-2013): 8 slots,
# max_len 512, min_bucket 32, page 128, two 384-token system prompts, 16-token
# tails, 32 new tokens, 6 waves of 8 alternating between the prompts. The
# recipe's 40 device pages never reclaim at this width (a warm wave
# allocates 8 tail pages of 39 usable), so the run takes 12: 11 usable pages
# hold one prompt's 3 pages and a wave's 8 tails, and each flip demotes the
# other prompt's three pages (the CPU recipe's regime, :2010-2013)
KT_SLOTS, KT_PAGES, KT_SYS, KT_TAIL, KT_NEW = 8, 12, 384, 16, 32
KT_WAVES, KT_WIDTH = 6, 8
KT_CUTS = ["serve-tier: num_pages 40 -> 12 (40 never reclaims at full "
           "width: a warm wave allocates 8 of 39 usable pages)"]
# a second pool between 12 and 15 (15 holds both prompts and a wave's
# tails, so from there no flip demotes): at 14 pages each flip demotes
# one page of the other prompt, and the tier runs with room to spare
KT_MID_PAGES = 14
# the tiered recover: a persistent-store engine over the first three
# waves with one decode fault mid-way through the first, whose prompt's
# pages were never demoted (so park_in_tier copies them to the host and
# the store), held to the fault-free persistent run's first 24 requests;
# after the recover, 7 of the wave's 8 requests write their prompts by a
# promotion from the tier and the extend
KT_RECOVER_WAVES, KT_RECOVER_FAULT = 3, ("serving.step.decode", 15)


def kt_trace(np):
    """The waves: each a list of KT_WIDTH prompts, a system prompt (the
    two alternate) and a tail; the bench's draws (seed 0, tokens 1-99)."""
    rng = np.random.RandomState(0)
    systems = [rng.randint(1, 100, (KT_SYS,)).astype(np.int64)
               for _ in range(2)]
    tails = [rng.randint(1, 100, (KT_TAIL,)).astype(np.int64)
             for _ in range(KT_WAVES * KT_WIDTH)]
    return [[np.concatenate([systems[w % 2], tails[w * KT_WIDTH + j]])
             for j in range(KT_WIDTH)] for w in range(KT_WAVES)]


def kt_drive(torch, model, waves, tf=None, num_pages=KT_PAGES, fault=None,
             **kw):
    """Serve ``waves`` one after another on a fresh engine of
    ``num_pages`` device pages (each wave drained before the next), the
    launch counts set to 0 just before and read just after. ``fault``:
    (point, hits to skip) armed to fire once; the failed step's engine is
    recovered (kt_recover). Returns the engine and a dict: requests,
    tokens/s, launches, monolithic prefills, the ms of each demotion (its
    D2H copy included: the payload copy completes before _demote goes
    on), the recover reports."""
    import shutil
    import tempfile
    from paddle_tpu_torch.observability import FlightRecorder, MetricRegistry
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import ServingEngine
    # the failed step dumps the flight recorder: into a directory the run
    # removes
    dump_dir = tempfile.mkdtemp(prefix="ptpu_flight_")
    eng = ServingEngine(model, max_slots=KT_SLOTS, max_len=MAX_LEN,
                        min_bucket=MIN_BUCKET, page_size=PAGE,
                        num_pages=num_pages, registry=MetricRegistry(),
                        flight_recorder=FlightRecorder(dump_dir=dump_dir),
                        **kw)
    full = count_calls(eng, "_full_prefill")
    demote_ms = []
    demote = eng.cache._demote

    def timed(victim):
        t0 = time.perf_counter()
        ok = demote(victim)
        demote_ms.append((time.perf_counter() - t0) * 1e3)
        return ok
    eng.cache._demote = timed
    reqs, reports = [], []
    faults.clear()
    faults.reset_counts()
    try:
        if fault is not None:
            faults.inject(fault[0], times=1, after=fault[1])
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        for w, wave in enumerate(waves):
            for p in wave:
                reqs.append(eng.submit(p, max_new_tokens=KT_NEW))
                if tf is not None:
                    tf.track(reqs[-1])
            while eng.has_work():
                try:
                    eng.step()
                except faults.InjectedFault:
                    reports.append(dict(kt_recover(torch, eng, kw), wave=w))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        fired = sum(faults.fired().values())
    finally:
        faults.clear()
        shutil.rmtree(dump_dir, ignore_errors=True)
    if fired != len(reports) or (fault is not None and fired != 1):
        raise AssertionError(f"serve-tier: {fired} faults fired, "
                             f"{len(reports)} recovered")
    served_by_length("serve-tier", reqs, [KT_NEW] * len(reqs))
    quiesced("serve-tier", eng)
    return eng, {"reqs": reqs, "tokens_per_s": len(reqs) * KT_NEW / wall,
                 "launches": launches, "full_prefills": full[0],
                 "demote_ms": demote_ms, "recover": reports}


def store_files(path) -> int:
    """The chunk files of a prefix store directory (meta.json aside)."""
    return sum(f.startswith("chunk-") for f in os.listdir(path))


def kt_recover(torch, eng, kw) -> dict:
    """recover() on a tiered engine after a failed step: its report's
    latency, the wall s across it (the card synchronized on both sides),
    the ms park_in_tier takes and the pages it parks, the tier's RAM
    pages and (with a store) the store's chunk files before and after."""
    store = kw.get("prefix_store_dir")
    tier = eng._kv_tier
    park = eng.cache.park_in_tier
    parked = {}

    def timed():
        t0 = time.perf_counter()
        parked["pages"] = park()
        parked["ms"] = (time.perf_counter() - t0) * 1e3
        return parked["pages"]
    eng.cache.park_in_tier = timed
    in_flight = sum(r is not None for r in eng.cache.slots)
    before = {"host_pages": tier.host_page_count(),
              "store_files": store_files(store) if store else None}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.recover()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"reason": rep["reason"], "in_flight": in_flight,
            "recovered_slots": rep["recovered_slots"],
            "replay_mismatches": rep["replay_mismatches"],
            "reroutes": rep["reroutes"], "latency_s": rep["latency_s"],
            "wall_s": wall, "park_ms": parked.get("ms"),
            "parked_pages": parked.get("pages"),
            "host_pages_before": before["host_pages"],
            "host_pages_after": tier.host_page_count(),
            "store_files_before": before["store_files"],
            "store_files_after": store_files(store) if store else None}


def copy_rates(torch, eng) -> dict:
    """D2H and H2D GB/s of one page payload's k stack (every layer),
    pinned host memory, timed by CUDA events over 10 copies each."""
    c = eng.cache
    src = torch.stack([p[1] for p in c.ks])
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    dst = torch.empty_like(src)
    out = {"bytes": src.numel() * src.element_size()}
    for name, (a, b) in (("d2h", (host, src)), ("h2d", (dst, host))):
        a.copy_(b, non_blocking=True)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(10):
            a.copy_(b, non_blocking=True)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 10
        out[f"{name}_ms"] = ms
        out[f"{name}_gbps"] = out["bytes"] / ms / 1e6
    return out


def phase_serve_tier(torch, np, model):
    """--kv-tiering at full width (KT_CUTS): untiered, host tier,
    persistent store over a temporary directory and an engine restarted
    over the same directory (its first wave), a tiered int8-KV engine
    beside an untiered one, the untiered and tiered pair again at
    KT_MID_PAGES, and a persistent-store engine recovered after a decode
    fault (KT_RECOVER_FAULT); the reference bars
    (tests/test_benchmarks_smoke.py:295-310: tiered hit rate >= untiered,
    demotions and promotions, a warm restart from disk), each tiered run
    held to its untiered run and the recovered run to the fault-free
    persistent run by the identity rule (the int8 pair with splits
    within INT8_GAP_STEPS), row 1 exactly layers x monolithic prefills,
    every RAM payload page-locked, no leaked page or pin. Prints
    KV_TIERING's fields (flash launches in place of the compile count),
    the promotion wait's p50/p99, ms per demoted page, the copies' GB/s,
    host pages and bytes, tokens/s at both pool sizes, the recover's
    latency, parking ms and store files."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    waves = kt_trace(np)
    store = tempfile.mkdtemp(prefix="ptpu_kv_store_")
    restart_store = tempfile.mkdtemp(prefix="ptpu_kv_store_")
    recover_store = tempfile.mkdtemp(prefix="ptpu_kv_store_")
    runs, engines = {}, {}
    try:
        plan = {"untiered": (waves, {}),
                "tiered": (waves, dict(kv_host_tier=True)),
                "persistent": (waves, dict(prefix_store_dir=store)),
                "restart": (waves[:1], dict(prefix_store_dir=store)),
                "untiered-int8": (waves, dict(kv_dtype="int8")),
                "tiered-int8": (waves, dict(kv_host_tier=True,
                                            kv_dtype="int8")),
                f"untiered-{KT_MID_PAGES}": (waves, dict(
                    num_pages=KT_MID_PAGES)),
                f"tiered-{KT_MID_PAGES}": (waves, dict(
                    num_pages=KT_MID_PAGES, kv_host_tier=True)),
                "tiered-recover": (waves[:KT_RECOVER_WAVES], dict(
                    prefix_store_dir=recover_store, fault=KT_RECOVER_FAULT))}
        for name, (w, kw) in plan.items():
            eng, run = kt_drive(torch, model, w, **kw)
            run["flash"] = flash_only(f"serve-tier-{name}", run["launches"],
                                      layers * run["full_prefills"])
            runs[name], engines[name] = run, eng
            if name == "persistent":
                # the restart's forced run reopens a copy of the store as
                # the restart found it
                shutil.rmtree(restart_store)
                shutil.copytree(store, restart_store)
        rows, failed = {}, []
        for name, base in (("tiered", "untiered"), ("persistent", "untiered"),
                           ("restart", "untiered"),
                           ("tiered-int8", "untiered-int8"),
                           ("tiered-recover", "persistent")):
            w, kw = plan[name]
            base_reqs = runs[base]["reqs"][:len(runs[name]["reqs"])]

            def forced(w=w, kw=kw, base_reqs=base_reqs, name=name):
                # the restart reopens the store as it found it; another
                # run with a store starts from an empty one
                fresh = None
                if name == "restart":
                    kw = dict(prefix_store_dir=restart_store)
                elif "prefix_store_dir" in kw:
                    fresh = tempfile.mkdtemp(prefix="ptpu_kv_store_")
                    kw = dict(kw, prefix_store_dir=fresh)
                try:
                    with teacher_forcing(
                            [r.output_ids for r in base_reqs]) as tf:
                        kt_drive(torch, model, w, tf=tf, **kw)
                finally:
                    if fresh:
                        shutil.rmtree(fresh, ignore_errors=True)
                return tf.result()
            try:
                rows[name] = identity_rule(
                    f"serve-tier-{name}", runs[name]["reqs"], base_reqs,
                    forced, gap_steps=INT8_GAP_STEPS
                    if name.endswith("int8") else 1)
            except AssertionError as e:
                rows[name] = {"failed": str(e)}
                failed.append(name)
        st = {n: e.paged_stats() for n, e in engines.items()}
        tier = engines["tiered"]._kv_tier
        pinned = [t.is_pinned() for p in tier._ram.values()
                  for t in p.values() if t.numel()]
        waits = engines["tiered"].metrics.snapshot_windows()["promotion_wait"]
        demote_ms = runs["tiered"]["demote_ms"]
        tps = {n: r["tokens_per_s"] for n, r in runs.items()}
        mid_u, mid_t = (f"untiered-{KT_MID_PAGES}", f"tiered-{KT_MID_PAGES}")
        line = {
            "device_pages": st["untiered"]["num_pages"], "page_size": PAGE,
            "prefix_hit_rate_untiered": st["untiered"]["prefix_hit_rate"],
            "prefix_hit_rate_tiered": st["tiered"]["prefix_hit_rate"],
            "prefix_hit_rate_persistent": st["persistent"]["prefix_hit_rate"],
            "restart_prefix_hit_rate": st["restart"]["prefix_hit_rate"],
            "hit_tokens_host": st["tiered"]["prefix_hit_tokens_host"],
            "hit_tokens_disk": st["restart"]["prefix_hit_tokens_disk"],
            "demotions": st["tiered"]["demotions"],
            "promotions": st["tiered"]["promotions"],
            "promotion_wait_p99_s": float(np.percentile(waits, 99))
            if waits else 0.0,
            "token_identical": all(r.get("token_identical")
                                   for r in rows.values()),
            "tokens_per_s_untiered": tps["untiered"],
            "tokens_per_s_tiered": tps["tiered"],
            "flash_launches": {n: r["flash"] for n, r in runs.items()}}
        recover = runs["tiered-recover"]["recover"]
        bars = {
            "tiered_hit_rate_ge_untiered": line["prefix_hit_rate_tiered"]
            >= line["prefix_hit_rate_untiered"],
            "demotions_and_promotions": line["demotions"] > 0
            and line["promotions"] > 0,
            "restart_warm": line["restart_prefix_hit_rate"] > 0
            and line["hit_tokens_disk"] > 0,
            "int8_tiered": st["tiered-int8"]["demotions"] > 0
            and st["tiered-int8"]["promotions"] > 0,
            "pinned": bool(pinned) and all(pinned),
            "tiered_recover": len(recover) == 1
            and recover[0]["recovered_slots"] > 0
            and recover[0]["replay_mismatches"] == 0}
        emit({"phase": "serve-tier", "slots": KT_SLOTS, "max_len": MAX_LEN,
              "cuts": KT_CUTS, "KV_TIERING": line, "bars": bars,
              "identity": rows,
              "promotion_wait_p50_s": float(np.percentile(waits, 50))
              if waits else 0.0,
              "promotion_waits": len(waits),
              "pages_per_promotion": line["promotions"] / max(1, len(waits)),
              "ms_per_demoted_page": {
                  "mean": float(np.mean(demote_ms)),
                  "p50": float(np.percentile(demote_ms, 50)),
                  "max": float(np.max(demote_ms)),
                  "first_3": demote_ms[:3], "last_3": demote_ms[-3:]}
              if demote_ms else None,
              "copies": copy_rates(torch, engines["tiered"]),
              "host_pages": tier.host_page_count(),
              "host_bytes": tier.host_bytes(), "pinned": all(pinned),
              "int8": {k: st["tiered-int8"][k] for k in (
                  "demotions", "promotions", "prefix_hit_rate",
                  "prefix_hit_tokens_host")},
              "int8_untiered_hit_rate": st["untiered-int8"]["prefix_hit_rate"],
              "tokens_per_s": tps,
              "tiered_over_untiered": {
                  KT_PAGES: tps["tiered"] / tps["untiered"],
                  KT_MID_PAGES: tps[mid_t] / tps[mid_u]},
              f"pool_{KT_MID_PAGES}": {
                  "device_pages": st[mid_u]["num_pages"],
                  "prefix_hit_rate_untiered": st[mid_u]["prefix_hit_rate"],
                  "prefix_hit_rate_tiered": st[mid_t]["prefix_hit_rate"],
                  "demotions": st[mid_t]["demotions"],
                  "promotions": st[mid_t]["promotions"],
                  "requests_identical_untiered": sum(
                      a.output_ids == b.output_ids for a, b in zip(
                          runs[mid_t]["reqs"], runs[mid_u]["reqs"]))},
              "tiered_recover": {"fault": list(KT_RECOVER_FAULT),
                                 "waves": KT_RECOVER_WAVES,
                                 "reports": recover},
              "leaks": 0, "phase_s": time.perf_counter() - t0})
        bad = [k for k, v in bars.items() if not v] + failed
        if bad:
            raise AssertionError(f"serve-tier: failed: {bad}: {line}")
    finally:
        for d in (store, restart_store, recover_store):
            shutil.rmtree(d, ignore_errors=True)
    return {n: {"flash_attention_fwd": r["flash"]} for n, r in runs.items()}


# -- the watchtower (observability.Watchtower over the engine) ---------------
# bench_serving_engine.py --watchtower at full width (:2020-2024): 16 slots,
# max_len 512, min_bucket 32, 48 requests of 4-20 tokens, 32 new, a stall
# budget of 5 s; the engine's clock is virtual, advanced by each step's wall
# time, and the stalled run freezes the engine for 20 virtual seconds
WT_REQS, WT_NEW, WT_STALL_S = 48, 32, 5.0


def wt_drive(torch, np, model, prompts, inject_stall: bool):
    from paddle_tpu_torch.observability import (MetricRegistry, SLOObjective,
                                                Watchtower)
    from paddle_tpu_torch.serving import ServingEngine
    clock = {"t": 0.0}
    reg = MetricRegistry()
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        min_bucket=MIN_BUCKET, registry=reg,
                        time_fn=lambda: clock["t"])
    wt = Watchtower(
        registry=reg, time_fn=lambda: clock["t"],
        objectives=(SLOObjective(name="ttft_p99", threshold_s=120.0,
                                 objective=0.5,
                                 family="ptpu_serving_ttft_seconds"),
                    SLOObjective(name="queue_wait_p95", threshold_s=120.0,
                                 objective=0.5,
                                 family="ptpu_serving_queue_wait_seconds")),
        eval_interval_s=0.5, stall_after_s=WT_STALL_S,
        anomaly_streams=False).attach_engine(eng)
    wt.flush()
    full = count_calls(eng, "_full_prefill")
    torch.cuda.synchronize()
    reset_launches()
    reqs = [eng.submit(p, WT_NEW) for p in prompts]
    steps = 0
    stall_at = max(2, (WT_NEW * len(prompts) // SLOTS) // 2)
    while eng.has_work():
        w0 = time.perf_counter()
        eng.step()
        clock["t"] += time.perf_counter() - w0
        steps += 1
        if inject_stall and steps == stall_at:
            for _ in range(int(WT_STALL_S * 4)):
                clock["t"] += 1.0
                wt.poll()
        wt.poll()
    torch.cuda.synchronize()
    launches = read_launches()
    wt.flush()
    served_by_length("serve-watchtower", reqs, [WT_NEW] * len(reqs))
    quiesced("serve-watchtower", eng)
    if wt._steps != steps:
        raise AssertionError(f"serve-watchtower: {steps} steps, the "
                             f"watchtower counted {wt._steps}")
    return {"reqs": reqs, "steps": steps, "wt": wt, "launches": launches,
            "full_prefills": full[0],
            "kinds": sorted({(i.kind, i.phase) for i in wt.incidents()})}


def phase_serve_watchtower(torch, np, model):
    """--watchtower at full width: a clean run raises no incident and
    healthz stays green; the stalled run raises ('stall', 'decode') and
    turns it red; the two runs' tokens are identical (detection reads
    only); row 1 exactly layers x prefills; the ns one observe_step()
    costs (one counter increment)."""
    from paddle_tpu_torch.observability import MetricRegistry, Watchtower
    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 100, (int(rng.choice([4, 7, 12, 20])),))
               .astype(np.int64) for _ in range(WT_REQS)]
    clean = wt_drive(torch, np, model, prompts, False)
    stalled = wt_drive(torch, np, model, prompts, True)
    launches = {}
    for name, run in (("clean", clean), ("stalled", stalled)):
        launches[name] = {"flash_attention_fwd": flash_only(
            f"serve-watchtower-{name}", run["launches"],
            layers * run["full_prefills"])}
    wt = Watchtower(registry=MetricRegistry())
    n = 1_000_000
    t1 = time.perf_counter()
    for _ in range(n):
        wt.observe_step()
    ns = (time.perf_counter() - t1) / n * 1e9
    identical = [r.output_ids for r in clean["reqs"]] \
        == [r.output_ids for r in stalled["reqs"]]
    row = {"requests": WT_REQS, "steps": clean["steps"],
           "stall_after_s": WT_STALL_S,
           "incidents_clean": len(clean["wt"].incidents()),
           "incidents_stalled": len(stalled["wt"].incidents()),
           "incident_kinds_stalled": [list(k) for k in stalled["kinds"]],
           "healthz_ok_clean": clean["wt"].healthz()["ok"],
           "healthz_ok_stalled": stalled["wt"].healthz()["ok"],
           "token_identical": identical,
           "observe_step_ns": ns, "diagnosis": stalled["wt"].diagnose()}
    emit({"phase": "serve-watchtower", "slots": SLOTS, "WATCHTOWER": row,
          "flash_launches": launches, "leaks": 0,
          "phase_s": time.perf_counter() - t0})
    if not (row["incidents_clean"] == 0 and row["healthz_ok_clean"]
            and ["stall", "decode"] in row["incident_kinds_stalled"]
            and not row["healthz_ok_stalled"] and identical):
        raise AssertionError(f"serve-watchtower: bars failed: {row}")
    return launches


# -- the serving chaos soak (resilience.chaos) on CUDA pools -----------------
CHAOS_SEEDS = range(13)


def chaos_f32_check(torch, F, heads, head_dim, lengths) -> list:
    """Row 1 in f32 at the shapes the chaos episodes give it (B=1, S each
    of ``lengths``, the tiny Llama's heads and head_dim, causal) against
    the plain version at F32_TOL (lse at LSE_TOL); ms beside the bound,
    the plain version and SDPA."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_plain)
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for S in lengths:
        q, k, v = (torch.randn(1, S, heads, head_dim, device="cuda",
                               generator=g) for _ in range(3))
        out, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=True)
        torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL,
                                   msg=lambda m: f"chaos f32 S={S}: {m}")
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0,
                                   msg=lambda m: f"chaos f32 S={S} lse: {m}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        fb, fby, *_ = attn_bound(1, S, heads, head_dim, True, 4, False)
        rows.append({
            "B": 1, "S": S, "H": heads, "D": head_dim, "dtype": "float32",
            "causal": True,
            "max_abs_err": (out - ref).abs().max().item(),
            "lse_max_abs_err": (lse - ref_lse).abs().max().item(),
            "ms": device_ms(torch, lambda: flash_attention_fwd(
                q, k, v, causal=True), 10),
            "plain_ms": device_ms(torch, lambda: flash_attention_fwd_plain(
                q, k, v, causal=True), 10),
            "library_ms": device_ms(torch, lambda: (
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
                10),
            "bound_ms": fb, "bound_by": fby})
    return rows


def phase_chaos_serving(torch, F):
    """The port's serving episode over seeds 0-12 on the card (its tiny
    f32 Llamas from seeds 0 and 7, CUDA pools, a watchtower attached):
    every episode holds every law; row 1 exactly layers x the monolithic
    prefills of every engine the episodes build (recoveries included);
    row 1 at those prefills' shapes against its plain version
    (chaos_f32_check); the tallies printed."""
    import shutil
    import tempfile
    from paddle_tpu_torch.resilience import chaos
    from paddle_tpu_torch.serving import ServingEngine
    t0 = time.perf_counter()
    chaos.set_serving_models(device="cuda")
    chaos._reference_outputs()
    cfg = chaos._serving_model().config
    tally = collections.Counter()
    bad = {}
    # every engine the episodes build: each monolithic prefill by bucket
    buckets = collections.Counter()
    full_prefill = ServingEngine._full_prefill

    def counted(self, slot, padded, n):
        buckets[int(padded.shape[1])] += 1
        return full_prefill(self, slot, padded, n)
    # every failed step dumps the flight recorder: into a directory the
    # phase removes
    dumps = tempfile.mkdtemp(prefix="ptpu_flight_")
    flight_dir = os.environ.get("PTPU_FLIGHT_DIR")
    os.environ["PTPU_FLIGHT_DIR"] = dumps
    ServingEngine._full_prefill = counted
    torch.cuda.synchronize()
    reset_launches()
    try:
        results = [chaos.run_serving_episode(seed, watchtower=True)
                   for seed in CHAOS_SEEDS]
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        ServingEngine._full_prefill = full_prefill
        if flight_dir is None:
            os.environ.pop("PTPU_FLIGHT_DIR", None)
        else:
            os.environ["PTPU_FLIGHT_DIR"] = flight_dir
        shutil.rmtree(dumps)
    for seed, res in zip(CHAOS_SEEDS, results):
        st = res.stats
        if not res.ok:
            bad[seed] = res.violations[:4]
        tally.update({"episodes": 1, "recoveries": st["recoveries"],
                      "speculative": int(st["speculative"]),
                      "accepted_drafts": st["spec_accepted_drafts"],
                      "draft_proposed": int(st["spec_proposer"] == "draft"),
                      "chunked": int(bool(st["prefill_chunk"])),
                      "tiered": int(st["kv_tiered"]),
                      "demotions": st["demotions"],
                      "promotions": st["promotions"],
                      "incidents": st["incidents"],
                      **{f"fired:{k}": v for k, v in res.fired.items()}})
    prefills = sum(buckets.values())
    err = None
    try:
        flash = flash_only("chaos-serving", launches,
                           cfg.num_hidden_layers * prefills)
    except AssertionError as e:
        flash, err = launches["flash_attention_fwd"], str(e)
    f32 = chaos_f32_check(torch, F, cfg.num_attention_heads, cfg.head_dim,
                          sorted(set(buckets) | {8, 16, 32}))
    emit({"phase": "chaos-serving", "seeds": list(CHAOS_SEEDS),
          "ok": not bad and err is None, "red": bad, "tally": dict(tally),
          "flash_launches": flash, "layers": cfg.num_hidden_layers,
          "monolithic_prefills": prefills,
          "prefills_by_bucket": dict(sorted(buckets.items())),
          "f32_check": f32, "f32_atol_rtol": F32_TOL, "lse_atol": LSE_TOL,
          "phase_s": time.perf_counter() - t0})
    if bad or err:
        raise AssertionError(f"chaos-serving: red seeds {bad}; {err}")
    return {"flash_attention_fwd": flash}


# -- weight-only int4 and int8 serving (Llama-1B, kernel row 7) -------------
INT4_GROUP = 128                 # bench_llama_decode.py's weight_only_int4
# Llama-1B's linears: (K, N, the group Int4Linear gives them, which)
INT4_SHAPES = [(2048, 2048, 128, "q/k/v/o_proj"),
               (2048, 5504, 128, "gate/up_proj"),
               (5504, 2048, 64, "down_proj (K/2 = 2752: group 128 -> 64)"),
               (2048, 32000, 128, "lm_head")]
INT4_MS = (1, 8, 16, 512)         # decode batches 1 and 8, 16 slots, prefill
INT4_RAGGED = (300, 5504, 2048, 64)
# the card tests' cases: both regimes, a column tile the kernels must cut
INT4_CHECK_MS = (1, 2, 8, 16, 17, 64, 300, 512)
INT4_CHECK_KN = (2048, 2064)
# the linears of one Llama-1B model call: 7 a layer and lm_head
LINEARS_PER_LAYER = 7
# prefill logits of the int4 model, kernel route vs plain route (every
# int4_matmul through int4_matmul_plain): one bf16 step per linear in
# another summation order, over 16 layers, as ROUTE_TOL
INT4_ROUTE_TOL = 0.125
DECODE_PROMPT, DECODE_NEW, DECODE_BATCHES = 64, 128, (1, 8)
DECODE_WARM, DECODE_PROFILE_STEPS = 4, 4


def int4_operands(torch, M, K, N, group, gen, zero_rows=False):
    """bf16 x [M, K] and the codes and scales of an f32 weight [K, N] of
    Llama's init scale, with one all-zero group (column 5, group 1; every
    column with ``zero_rows``)."""
    from paddle_tpu_torch.ops.int4_matmul import (pack_rows_int4,
                                                  quantize_int4_rows)
    w = torch.randn(K, N, device="cuda", generator=gen) \
        * math.sqrt(2.0 / (K + N))
    w[group:2 * group, slice(None) if zero_rows else 5] = 0
    q, s = quantize_int4_rows(w, group)
    x = torch.randn(M, K, device="cuda", generator=gen).bfloat16()
    return x, pack_rows_int4(q), s, q, w.bfloat16()


def int4pack_operands(torch, q, s, group):
    """The same weight in torch._weight_int4pack_mm's layout (codes + 8 in
    natural K order, two to a byte along K; bf16 scales, zero points 0)."""
    u = q.t().to(torch.int32) + 8                        # [N, K]
    packed = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)
    sz = torch.zeros(*s.shape, 2, dtype=torch.bfloat16, device=s.device)
    sz[..., 0] = s
    return packed, sz


def int4_regime(M: int) -> str:
    """Which of row 7's kernels a call of M rows runs."""
    return "decode" if M <= 16 else "prefill"


def kernel_names(events: dict) -> dict:
    """kernel_events' keys cut to the kernel's name (no template
    arguments or signature)."""
    return {k.split("<")[0].split("(")[0].replace("void ", ""): n
            for k, n in events.items()}


def kernel_events(torch, fn, calls: int) -> dict:
    """{kernel name: launches} of ``calls`` calls of ``fn`` under the
    profiler."""
    _, ev = traced(torch, lambda: lambda: [fn() for _ in range(calls)],
                   calls=calls)
    return {e.key: e.count for e in ev}


def phase_int4_checks(torch, gen) -> dict:
    """Row 7's laws on the card (the card tests' cases): at K 2048 and N
    2064 (not a multiple of the column tile), group 64 and 128, bf16 and
    f32 x, M in INT4_CHECK_MS: within one bf16 step of the plain version,
    the same bits twice, a row's bits not depending on M within a regime;
    an all-zero group of every column; one kernel event per call."""
    from paddle_tpu_torch.ops.int4_matmul import (int4_matmul,
                                                  int4_matmul_plain)
    K, N = INT4_CHECK_KN
    worst, cases = 0.0, 0
    for group in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            xs, p, s, _, _ = int4_operands(torch, max(INT4_CHECK_MS), K, N,
                                           group, gen)
            xs = xs.to(dtype)
            ys = {}
            for M in INT4_CHECK_MS:
                x = xs[:M].contiguous()
                got = int4_matmul(x, p, s, group)
                again = int4_matmul(x, p, s, group)
                want = int4_matmul_plain(x, p, s, group)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                where = f"int4 check M {M} group {group} {dtype}"
                if err > bf16_step(want.float()) or got.dtype != x.dtype:
                    raise AssertionError(f"{where}: max |kernel - plain| "
                                         f"{err}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{where}: two runs differ")
                worst, cases = max(worst, err), cases + 1
                ys[M] = got
            for ref, ms in ((16, (1, 2, 8)), (512, (17, 64, 300))):
                for M in ms:
                    if not torch.equal(ys[M], ys[ref][:M]):
                        raise AssertionError(
                            f"int4 {int4_regime(M)} rows of M {M} differ "
                            f"from those of M {ref} (group {group}, "
                            f"{dtype})")
    for M in (1, 512):
        x, p, s, q, _ = int4_operands(torch, M, K, N, 128, gen,
                                      zero_rows=True)
        got = int4_matmul(x, p, s, 128)
        want = int4_matmul_plain(x, p, s, 128)
        if not (s[1] == 1.0).all() or q[128:256].any() or \
                (got.float() - want.float()).abs().max().item() \
                > bf16_step(want.float()):
            raise AssertionError(f"int4 all-zero group, M {M}")
    events = {}
    for M in (1, 16, 17, 512):
        x, p, s, _, _ = int4_operands(torch, M, 2048, 2048, 128, gen)
        ev = kernel_events(torch, lambda: int4_matmul(x, p, s, 128), 10)
        if len(ev) != 1 or next(iter(ev.values())) != 10 or \
                "int4_mm_" not in next(iter(ev)):
            raise AssertionError(f"int4 M {M}: 10 calls gave kernel events "
                                 f"{ev}, expected 10 of one int4 kernel")
        events[M] = next(iter(ev))[:60]
    return {"shape": [K, N], "ms": list(INT4_CHECK_MS), "cases": cases,
            "max_abs_err": worst, "bits_repeat": True,
            "rows_independent_of_m_within_regime": True,
            "zero_group": True, "one_event_per_call": events}


def int4_case(torch, gen, M, K, N, group, what) -> dict:
    """Row 7 at one shape against its plain version (within one bf16
    step of the output's largest magnitude, the same bits twice, the
    zero group at scale 1 with codes 0), with the device ms of kernel,
    plain version, the library's int4 GEMM and the bf16 linear beside the
    bound (see phase_kernels_int4)."""
    from paddle_tpu_torch.ops.int4_matmul import (int4_matmul,
                                                  int4_matmul_plain)
    x, p, s, q, wb = int4_operands(torch, M, K, N, group, gen)
    got = int4_matmul(x, p, s, group)
    again = int4_matmul(x, p, s, group)
    want = int4_matmul_plain(x, p, s, group)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = bf16_step(want.float())
    if err > tol:
        raise AssertionError(f"int4_matmul {M}x{K}x{N} ({what}): max "
                             f"|kernel - plain| {err} > {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"int4_matmul {M}x{K}x{N}: two runs differ")
    if not (s[1, 5].item() == 1.0 and not q[group:2 * group, 5].any()):
        raise AssertionError("int4: the all-zero group is not at scale "
                             "1 with codes 0")
    packed, sz = int4pack_operands(torch, q, s, group)
    lib = lambda: torch._weight_int4pack_mm(x, packed, group, sz)
    lib_err = (lib().float() - want.float()).abs().max().item()
    nbytes = M * K * 2 + K // 2 * N + K // group * N * 4 + M * N * 2
    flops = 2 * M * K * N
    b_ms, b_by = bound(nbytes, flops)
    events = EVENT_TIMINGS
    row = {
        "M": M, "K": K, "N": N, "group": group, "linear": what,
        "regime": int4_regime(M),
        "max_abs_err": err, "tolerance": tol,
        "ms": device_ms(torch, lambda: int4_matmul(x, p, s, group), 20),
        "plain_ms": device_ms(torch, lambda: int4_matmul_plain(
            x, p, s, group), 3),
        "library_ms": device_ms(torch, lib, 20),
        "library_max_abs_err": lib_err,
        "bf16_linear_ms": device_ms(torch, lambda: x @ wb, 20),
        "bound_ms": b_ms, "bound_by": b_by}
    # timings that fell back to CUDA events (host launch gaps included)
    row["event_timings"] = EVENT_TIMINGS - events
    for key in ("ms", "plain_ms", "library_ms", "bf16_linear_ms"):
        row[key.replace("ms", "gbps")] = nbytes / row[key] / 1e6
        row[key.replace("ms", "tflops")] = flops / row[key] / 1e9
    row["bound_share"] = b_ms / row["ms"]
    return row


def phase_kernels_int4(torch):
    """Kernel row 7 against its plain version on the card at Llama-1B's
    four linear shapes, M in INT4_MS and one ragged M, within one bf16
    step of the output's largest magnitude; the zero group at scale 1
    with codes 0. Device ms of kernel, plain version, the library's
    int4 GEMM (torch._weight_int4pack_mm on the same codes, bf16 scales,
    zero points 0: a yardstick the port never calls) and the bf16 linear
    the unquantized model runs (x @ W in bf16), beside the bound, with
    the GB/s and TFLOP/s each reaches and the kernel's share of the
    bound; then phase_int4_checks."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(M, K, N, g, what) for K, N, g, what in INT4_SHAPES
             for M in INT4_MS]
    cases.append(INT4_RAGGED + ("down_proj, ragged M",))
    rows = [int4_case(torch, gen, *case) for case in cases]
    checks = phase_int4_checks(torch, gen)
    emit({"phase": "kernels", "name": "int4_matmul",
          "library": "torch._weight_int4pack_mm",
          "tolerance": "one bf16 step of the output's largest magnitude",
          "cases": rows, "checks": checks})
    return rows


def weight_bytes(model) -> int:
    """Bytes of the model's parameters and persistent buffers."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


# the kernel a weight-only linear launches once a call, by precision
QUANT_KERNEL = {"int4": "int4_matmul", "int8": "quantize_rows"}


def quantized(model, precision: str):
    """A weight-only copy of ``model`` and its swapped layers' count."""
    from paddle_tpu_torch.quantization import (Int4Linear, Int8Linear,
                                               weight_only_int4,
                                               weight_only_int8)
    if precision == "int4":
        q = weight_only_int4(model, group=INT4_GROUP, inplace=False)
    else:
        q = weight_only_int8(model, inplace=False)
    layer = Int4Linear if precision == "int4" else Int8Linear
    return q, sum(isinstance(m, layer) for m in q.modules())


def phase_serve_int4(torch, np, model, prompts, precision="int4",
                     name="serve-int4", per_call=None):
    """serve's 16 requests through ServingEngine(weight_only_int4(model,
    group=128)) (or weight_only_int8 with ``precision="int8"``): every
    request's token count; the precision's kernel (row 7, or row 8's
    dynamic quantize) exactly ``per_call`` launches per model call (for
    Llama-1B 113: 16 layers x 7 linears + lm_head; the model must have
    swapped that many linears), one call per prefill and per decode step,
    and flash_attention_fwd layers x 16 prefills."""
    from paddle_tpu_torch.serving import ServingEngine
    qmodel, swapped = quantized(model, precision)
    layers = served(model).num_layers
    if per_call is None:
        per_call = layers * LINEARS_PER_LAYER + 1
    if swapped != per_call:
        raise AssertionError(f"{name}: {swapped} linears swapped, expected "
                             f"{per_call}")
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]
    warm = ServingEngine(qmodel, kv_layout="contiguous", max_slots=2,
                         max_len=MAX_LEN, min_bucket=MIN_BUCKET)
    for p in prompts[:2]:
        warm.submit(p, max_new_tokens=2)
    warm.run()
    del warm
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(qmodel, kv_layout="contiguous", max_slots=SLOTS,
                           max_len=MAX_LEN, min_bucket=MIN_BUCKET)
    reqs, wall, counts = serve_run(torch, engine, prompts, news)
    m = engine.metrics.summary()
    # all 16 requests are admitted in the first step; the decode runs
    # until the longest has its tokens (its first came from its prefill)
    decode_steps = max(news) - 1
    if m["steps"] != decode_steps:
        raise AssertionError(f"{name}: {m['steps']} engine steps, "
                             f"expected {decode_steps}")
    want = no_launches()
    want.update({"flash_attention_fwd": layers * len(reqs),
                 QUANT_KERNEL[precision]:
                     per_call * (len(reqs) + decode_steps)})
    if counts != want:
        raise AssertionError(f"{name} launches {counts}, expected {want}")
    emit({"phase": name, "group": INT4_GROUP if precision == "int4"
          else None, "requests": len(reqs), "tokens": m["total_tokens"],
          "wall_s": wall, "tokens_per_s": m["tokens_per_s"],
          "ttft_p50_s": m["ttft_p50_s"], "ttft_p99_s": m["ttft_p99_s"],
          "tok_latency_p50_s": m["tok_latency_p50_s"],
          "decode_steps": decode_steps, "prefills": len(reqs),
          f"{precision}_launches_per_model_call": per_call,
          "launches": {k: v for k, v in counts.items() if v},
          "weight_gb": weight_bytes(qmodel) / 1e9,
          "bf16_weight_gb": weight_bytes(model) / 1e9,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return qmodel, reqs, counts


class module_plain_route:
    """Within the block ``module.<name>`` is ``plain``: every layer of
    ``module`` that calls the kernel's wrapper by that name computes
    through its plain version instead."""

    def __init__(self, module, name: str, plain):
        self.mod, self.name, self.plain = module, name, plain

    def __enter__(self):
        self.old = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.plain)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.old)
        return False


def int4_plain_route():
    """Every Int4Linear through int4_matmul_plain."""
    from paddle_tpu_torch.ops.int4_matmul import int4_matmul_plain
    from paddle_tpu_torch.quantization import int4_layers
    return module_plain_route(int4_layers, "int4_matmul", int4_matmul_plain)


def int8_plain_route():
    """Every Int8Linear's dynamic quantize through quantize_rows_plain."""
    from paddle_tpu_torch.ops.quant_matmul import quantize_rows_plain
    from paddle_tpu_torch.quantization import int8_layers
    return module_plain_route(int8_layers, "quantize_rows", quantize_rows_plain)


def last_logit_parity(torch, np, ref_model, model):
    """_decode_phase.py:60-67's parity: the last-token logits of a
    64-token prompt from RandomState(0), max |diff| / max |ref| against
    the bf16 model, and whether the argmax agrees (printed, not gated:
    random weights leave near-tied logits)."""
    cfg = model.config
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, DECODE_PROMPT)), device=model.device)
    with torch.inference_mode():
        lb = ref_model(ids)[0, -1].double()
        li = model(ids)[0, -1].double()
    rel = ((lb - li).abs().max() / lb.abs().max().clamp_min(1e-9)).item()
    return {"last_logit_rel_err": rel,
            "argmax_same": int(lb.argmax()) == int(li.argmax())}


def phase_check_int4(torch, np, model, qmodel, prompts, reqs):
    """The int4 engine's first tokens against its own bucket-padded
    prefill, padded against unpadded prefill logits within one bf16 step,
    one prompt's prefill logits through the kernel against the plain
    route within INT4_ROUTE_TOL; the parity against bf16, printed."""
    from paddle_tpu_torch.serving import bucket_for
    pad_diff = 0.0
    for p, r in zip(prompts, reqs):
        n = len(p)
        padded = np.zeros(bucket_for(n, MIN_BUCKET, MAX_LEN), np.int64)
        padded[:n] = p
        eng = prefill_logits(torch, qmodel, padded, False, n)
        if int(eng.argmax()) != r.output_ids[0]:
            raise AssertionError(
                f"serve-int4 request {r.rid}: first token "
                f"{r.output_ids[0]} is not the argmax of its own "
                f"bucket-padded prefill ({int(eng.argmax())})")
        diff = (prefill_logits(torch, qmodel, p, False) - eng).abs().max() \
            .item()
        if diff > bf16_step(eng):
            raise AssertionError(
                f"serve-int4 request {r.rid}: padded and unpadded prefill "
                f"logits differ by {diff} (> one bf16 step, "
                f"{bf16_step(eng)})")
        pad_diff = max(pad_diff, diff)
    ids = prompts[PROMPT_LENS.index(300)]
    kern = prefill_logits(torch, qmodel, ids, False)
    with int4_plain_route():
        plain = prefill_logits(torch, qmodel, ids, False)
    diff = (kern - plain).abs().max().item()
    if diff > INT4_ROUTE_TOL:
        raise AssertionError(f"int4 prefill logits, kernel vs plain route: "
                             f"max |diff| {diff} > {INT4_ROUTE_TOL}")
    emit({"phase": "check-int4", "first_tokens_exact": len(reqs),
          "pad_logits_max_abs_diff": pad_diff,
          "route_logits_max_abs_diff": diff, "route_tol": INT4_ROUTE_TOL,
          "route_argmax_equal": int(kern.argmax()) == int(plain.argmax()),
          "vs_bf16": last_logit_parity(torch, np, model, qmodel)})


def decode_step_trace(torch, m, ids):
    """Device ms by kernel, and wall s, of DECODE_PROFILE_STEPS decode
    steps of the entry point itself: a profiled ``generate()`` of 1 +
    DECODE_PROFILE_STEPS new tokens less a profiled ``generate()`` of one
    (the prefill and the first token). Every kernel of a decode step runs
    once a step, so a kernel whose count the two traces put apart by a
    number DECODE_PROFILE_STEPS does not divide marks a trace short of
    events: both are taken again, PROFILE_TRIES times in all, then
    raises."""
    global SHORT_TRACES
    steps = DECODE_PROFILE_STEPS
    for _ in range(PROFILE_TRIES):
        runs = []
        for new in (1 + steps, 1):
            wall, ev = traced(torch, lambda new=new: lambda: m.generate(
                ids, max_new_tokens=new), with_cpu=True)
            runs.append((wall, {e.key: (e.count, e.self_device_time_total)
                                for e in ev}))
        (wall, full), (wall1, first) = runs
        short = [(k[:60], c - first.get(k, (0, 0))[0])
                 for k, (c, _) in full.items()
                 if (c - first.get(k, (0, 0))[0]) % steps]
        short += [(k[:60], -c) for k, (c, _) in first.items()
                  if k not in full]
        if not short:
            ms = {k: (t - first.get(k, (0, 0))[1]) / 1e3
                  for k, (_, t) in full.items()}
            return wall - wall1, ms
        SHORT_TRACES += 1
        print(f"chip_smoke: decode traces short of {steps} steps: "
              f"{short}; tracing again", file=sys.stderr, flush=True)
    raise RuntimeError(f"torch.profiler traced no whole decode steps in "
                       f"{PROFILE_TRIES} pairs of traces")


def decode_share(by_kernel: dict) -> dict:
    """Device ms of decode steps by part: the int4 kernel, or the int8
    path's quantize kernel and int8 GEMMs, or the bf16 GEMMs."""
    parts = {"int4_matmul_ms": 0.0, "quantize_rows_ms": 0.0,
             "int8_gemm_ms": 0.0, "bf16_gemm_ms": 0.0}
    for k, ms in by_kernel.items():
        low = k.lower()
        if "int4_mm_" in k:
            parts["int4_matmul_ms"] += ms
        elif "rowq_kernel" in k:
            parts["quantize_rows_ms"] += ms
        elif any(n in low for n in GEMM_NAMES):
            part = "int8_gemm_ms" if any(n in low for n in INT8_NAMES) \
                else "bf16_gemm_ms"
            parts[part] += ms
    return parts


def int8_route_check(torch, np, m) -> bool:
    """A 64-token prompt's prefill logits of the int8 model with every
    dynamic quantize through row 8's kernel, and through its plain
    version: the codes and scales agree bit for bit (kernels phase), and
    the int8 product and dequant that follow are the same calls, so the
    logits must be equal."""
    ids = np.random.RandomState(1).randint(0, m.config.vocab_size,
                                           DECODE_PROMPT)
    kern = prefill_logits(torch, m, ids, False)
    with int8_plain_route():
        plain = prefill_logits(torch, m, ids, False)
    if not torch.equal(kern, plain):
        raise AssertionError(
            f"int8 prefill logits, row 8's kernel vs its plain version: "
            f"max |diff| {(kern - plain).abs().max().item()}, expected 0")
    return True


def phase_decode(torch, np, model):
    """bench_llama_decode.py's phases: generate() at a 64-token prompt and
    128 new tokens, batch 1 and 8, for bf16, weight_only_int8 and
    weight_only_int4(group=128); a short warm-up, then one counted run
    (tokens/s, launches exactly as derived: per model call 113 int4_matmul
    or 113 quantize_rows launches, and 16 flash launches for the
    prefill); then DECODE_PROFILE_STEPS decode steps of generate() under
    the profiler (device ms per step, busy share, the quantized path's
    share). The int8 model's prefill logits through row 8's kernel must
    equal those through its plain version bit for bit."""
    from paddle_tpu_torch.quantization import (weight_only_int4,
                                               weight_only_int8)
    cfg = model.config
    L = cfg.num_hidden_layers
    per_call = L * LINEARS_PER_LAYER + 1
    rng = np.random.RandomState(0)
    total = no_launches()
    out = {}
    for precision in ("bf16", "int8", "int4"):
        m = model if precision == "bf16" else \
            weight_only_int8(model, inplace=False) if precision == "int8" \
            else weight_only_int4(model, group=INT4_GROUP, inplace=False)
        res = {"weight_gb": weight_bytes(m) / 1e9}
        if precision != "bf16":
            res.update(last_logit_parity(torch, np, model, m))
        if precision == "int8":
            res["route_logits_equal"] = int8_route_check(torch, np, m)
        for bs in DECODE_BATCHES:
            ids = torch.as_tensor(rng.randint(
                0, cfg.vocab_size, (bs, DECODE_PROMPT)), device=model.device)
            m.generate(ids, max_new_tokens=DECODE_WARM)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            toks = m.generate(ids, max_new_tokens=DECODE_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_launches()
            want = no_launches()
            want["flash_attention_fwd"] = L
            if precision == "int4":
                want["int4_matmul"] = per_call * DECODE_NEW
            elif precision == "int8":
                want["quantize_rows"] = per_call * DECODE_NEW
            if counts != want:
                raise AssertionError(f"decode {precision} bs {bs}: launches "
                                     f"{counts}, expected {want}")
            if toks.shape != (bs, DECODE_PROMPT + DECODE_NEW):
                raise AssertionError(f"decode {precision}: {toks.shape}")
            for k, v in counts.items():
                total[k] += v
            pwall, by_kernel = decode_step_trace(torch, m, ids)
            dev = sum(by_kernel.values())
            res[f"bs{bs}"] = {
                "tokens_per_s": bs * DECODE_NEW / wall, "wall_s": wall,
                "device_ms_per_step": dev / DECODE_PROFILE_STEPS,
                "wall_ms_per_step_profiled": pwall * 1e3
                / DECODE_PROFILE_STEPS,
                "device_busy_share": dev / (pwall * 1e3),
                "ms_per_step_by_part": {
                    k: v / DECODE_PROFILE_STEPS
                    for k, v in decode_share(by_kernel).items()}}
        out[precision] = res
        if m is not model:
            del m
        torch.cuda.empty_cache()
    emit({"phase": "decode", "prompt": DECODE_PROMPT, "new": DECODE_NEW,
          "int4_group": INT4_GROUP, **out})
    return total


def gpt_1p3b_config(num_layers: int = 24):
    from paddle_tpu_torch.models.gpt import GPTConfig
    # bench.py:build_flagship's GPT-3 1.3B shape
    return GPTConfig(vocab_size=50304, hidden_size=2048,
                     num_layers=num_layers, num_heads=16, max_seq_len=1024,
                     dtype="bfloat16")


FLAGSHIP = dict(quant8="wgrad", moment8=True, remat="save_main")
# the trainer's recipes by phase: build_flagship's; it with LayerNorm
# fused into the qkv and ffn1 quantizes (rows 10, 11); the bf16 path;
# and the drift guard's ladder, walked at a threshold every probe
# exceeds (remat off: the ladder's lower tiers have no save_main yet)
RECIPES = {
    "train-flagship": FLAGSHIP,
    "train-flagship-ln": dict(FLAGSHIP, fuse_ln_quant=True,
                              fuse_bwd_colq=True),
    "train": dict(remat=False),
    "train-guard": dict(quant8="wgrad", moment8=True, ce_int8=True,
                        remat=False, int8_guard_period=1,
                        int8_guard_threshold=1e-9)}
# 2-layer kernel-vs-plain checks: the recipes above, and the int8 tiers
# and switches each on its own
CHECKS = {
    "train-check-flagship": FLAGSHIP,
    "train-check": dict(remat=False),
    "train-check-flagship-ln": RECIPES["train-flagship-ln"],
    "train-check-flagship-ln-colq-off": dict(FLAGSHIP, fuse_ln_quant=True,
                                             fuse_bwd_colq=False),
    "train-check-gelu-unfused": dict(FLAGSHIP, fuse_gelu_quant=False),
    "train-check-ce-int8": dict(FLAGSHIP, ce_int8=True),
    "train-check-quant8-true": dict(quant8=True, remat=False),
    "train-check-quant8-dgrad": dict(quant8="dgrad", remat=False)}
# train-flagship-ln's losses against train-flagship's, step by step: the
# fused sites quantize LN(x) in f32 where the unfused round it to bf16
# first (tests/test_fuse_ln_modes.py holds the modes to the same bar)
LN_TRACK_TOL = 0.05


def gpt_trainer(torch, recipe: dict, num_layers: int = 24):
    """build_flagship's trainer with ``recipe``'s switches: bf16 masters
    with SR, bf16 moments, the fused AdamW on every leaf, unchunked CE;
    lr 3e-4, wd 0.1, betas (0.9, 0.95), clip 1.0; weights from seed 0."""
    from paddle_tpu_torch.models.gpt import GPTTrainer
    gen = torch.Generator(device="cuda").manual_seed(0)
    return GPTTrainer(gpt_1p3b_config(num_layers), microbatches=1,
                      master_dtype="bfloat16", moment_dtype="bfloat16",
                      ce_chunks=1, layer_unroll="full", generator=gen,
                      **recipe)


def train_batch(np):
    rng = np.random.RandomState(0)        # bench.py:83-85
    ids = rng.randint(0, 50304, (TRAIN_B, TRAIN_T)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def expected_launches(tr) -> dict:
    """Kernel launches per training step of ``tr`` at its current tier,
    counted from the code: one flash forward and backward per layer; one
    int8-moment AdamW launch for all the leaves with int8 moments
    (moment8) and one AdamW launch for all the other leaves; per layer
    and int8 site (qkv, ffn1, ffn2):
    - quant8="wgrad": forward a row quantize of the activation (row 10
      with LayerNorm fused at the qkv / ffn1 site) and a column quantize
      of w; dgrad row quantizes of g and w; wgrad SR column quantizes of
      the activation (row 11 at a fused site with fuse_bwd_colq) and g;
    - "dgrad": forward as above, unfused; dgrad as above; wgrad exact;
    - True: the forward only.
    ce_int8 (``ce_chunks`` C): the forward a row quantize of x and, per
    chunk, the chunk quantized per vocab entry (rows of a tied [V, D]
    head, columns of a [D, V] one); the backward x again and per chunk
    that quantize again (logits recomputed), dlg's rows and the chunk
    quantized per model column (columns of the tied head, rows of the
    other)."""
    L = tr.cfg.num_layers
    # row 14: one launch for each (p, g, m/v) dtype combination of the
    # leaves without int8 moments (the gradient has p's dtype); row 13 one
    # for each (p, g) dtype pair of the leaves with int8 moments
    groups = {(p.dtype, m.dtype) for p, m in zip(tr._leaves,
                                                 tr.opt_state["m"])
              if not isinstance(m, tuple)}
    groups8 = {p.dtype for p, m in zip(tr._leaves, tr.opt_state["m"])
               if isinstance(m, tuple)}
    n = no_launches()
    n.update(flash_attention_fwd=L, flash_attention_bwd=L,
             fused_adamw=len(groups), fused_adamw8=len(groups8))
    if tr.quant8:
        fused = sum(tr.fuse_ln_quant in (True, site)
                    for site in ("qkv", "ffn1")) * (tr.quant8 == "wgrad")
        n["ln_quantize_rowwise"] = fused * L
        n["quantize_rows"] = (3 - fused) * L \
            + 6 * L * (tr.quant8 in ("wgrad", "dgrad"))
        n["quantize_cols"] = 3 * L
        if tr.quant8 == "wgrad":
            colq_ln = fused * tr.fuse_bwd_colq
            n["sr_quantize_colwise_ln"] = colq_ln * L
            n["sr_quantize_colwise"] = (6 - colq_ln) * L
    if tr.ce_int8:
        C = tr.ce_chunks
        n["quantize_rows"] += 2 + C * (3 if tr.cfg.tie_embeddings else 2)
        n["quantize_cols"] += C * (1 if tr.cfg.tie_embeddings else 2)
    return n


def guard_probe_launches(quant8) -> dict:
    """The drift probe's launches (``GPTTrainer._probe``): row quantizes
    of the cotangent and of wqkv; in "wgrad" mode SR column quantizes of
    LN1's output and of the cotangent."""
    n = no_launches()
    n["quantize_rows"] = 2
    n["sr_quantize_colwise"] = 2 * (quant8 == "wgrad")
    return n


def phase_train(torch, np, tr, name: str, track=None):
    """2 warm-up and STEPS counted steps at GPT-1.3B: launches exactly
    as expected, finite losses, the last below the first; ``track``:
    another recipe's losses on the same batch to stay within
    LN_TRACK_TOL of, step by step. Returns (launches, losses)."""
    ids, labels = train_batch(np)
    losses = [tr.train_step(ids, labels) for _ in range(WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses += [tr.train_step(ids, labels) for _ in range(STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    want = {k: v * STEPS for k, v in expected_launches(tr).items()}
    if counts != want:
        raise AssertionError(f"{name} launches {counts}, expected {want} "
                             f"over {STEPS} steps")
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    result = {}
    if track is not None:
        diff = max(abs(a - b) for a, b in zip(losses, track))
        if diff > LN_TRACK_TOL:
            raise AssertionError(f"{name} losses {losses} leave the tracked "
                                 f"{track} by {diff} > {LN_TRACK_TOL}")
        result = {"tracked_losses": track, "track_max_abs_diff": diff,
                  "track_tol": LN_TRACK_TOL}
    tokens = TRAIN_B * TRAIN_T * STEPS
    emit({"phase": name, "params": tr.n_params(), "batch": TRAIN_B,
          "seq": TRAIN_T, "recipe": RECIPES[name],
          "steps": STEPS, "losses": losses, **result,
          "step_ms": wall / STEPS * 1e3, "tokens_per_s": tokens / wall,
          "launches_per_step": {k: v / STEPS for k, v in counts.items()},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return counts, losses


GUARD_STEPS = 4


def phase_train_guard(torch, np):
    """The drift guard at GPT-1.3B full width (quant8="wgrad", moment8,
    ce_int8, remat off), period 1, threshold 1e-9: the guard runs before
    each step it guards, so step 1 trains at "dgrad" after the "wgrad"
    probe, step 2 exact after the "dgrad" probe, steps 3-4 exact with
    only ce_int8's quantizes. Each step's launches are asserted: its
    tier's (expected_launches) plus its probe's."""
    tr = gpt_trainer(torch, RECIPES["train-guard"])
    ids, labels = train_batch(np)
    steps = []
    for i in range(GUARD_STEPS):
        before = tr.quant8
        probe = guard_probe_launches(before) if before else \
            no_launches()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        loss = float(tr.train_step(ids, labels))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_launches()
        want = {k: v + probe[k] for k, v in expected_launches(tr).items()}
        if counts != want:
            raise AssertionError(f"train-guard step {i + 1} (tier "
                                 f"{tr.quant8!r}) launches {counts}, "
                                 f"expected {want}")
        if not math.isfinite(loss):
            raise AssertionError(f"train-guard step {i + 1}: loss {loss}")
        steps.append({"step": i + 1, "probed_tier": before,
                      "tier": tr.quant8, "loss": loss, "ms": ms,
                      "launches": {k: v for k, v in counts.items() if v}})
    events = [(e["from"], e["to"]) for e in tr.guard_events()]
    if events != [("wgrad", "dgrad"), ("dgrad", False)]:
        raise AssertionError(f"train-guard events {tr.guard_events()}")
    emit({"phase": "train-guard", "recipe": RECIPES["train-guard"],
          "events": tr.guard_events(), "steps": steps,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    del tr
    torch.cuda.empty_cache()


# kernel families of a training step's trace, by name: the port's
# kernels, then cuBLAS's GEMMs (int8 ones carry an int8 type in their
# names), the rest elementwise, reductions and copies
PROFILE_PARTS = {
    # the wgmma kernels and the backward's delta pass
    "flash_fwd_ms": ("flash_fwd_wgmma_kernel",),
    "flash_bwd_ms": ("flash_bwd_dkdv_wgmma_kernel",
                     "flash_bwd_dq_wgmma_kernel", "flash_bwd_delta_kernel"),
    "adamw_ms": ("adamw_leaves_kernel",),
    "adamw8_ms": ("adamw8_rows_kernel",),
    # rows 10 and 11: the row kernels with LayerNorm (in registers,
    # staged), and the column kernels with the LayerNorm prologue
    # (template argument kLn = 2: the one-read kernel and the pair)
    "ln_quantize_ms": ("rowq_ln_regs_kernel", "rowq_ln_kernel",
                       "_kernel<__nv_bfloat16, 2"),
    "quantize_ms": ("rowq_regs_kernel", "rowq_kernel", "col_amax_kernel",
                    "col_cast_kernel", "col_cluster_kernel"),
}
# of quantize_ms, row 8's kernels (the row in registers, and the long
# rows through shared memory), row 9's one-read kernel (RTN, template
# argument SR false) with its two-pass cast, row 12's one-read kernel
# (SR, with and without gelu); of ln_quantize_ms, row 10's kernels and
# row 11's (the one-read kernel, and the pair past its row limit)
ROW8_NAMES = ("rowq_regs_kernel", "rowq_kernel")
ROW9_NAMES = ("col_cluster_kernel<__nv_bfloat16, 0, false>",
              "col_cast_kernel<__nv_bfloat16, 0, false>")
ROW10_NAMES = ("rowq_ln_regs_kernel", "rowq_ln_kernel")
ROW11_NAMES = ("col_cluster_kernel<__nv_bfloat16, 2, true>",
               "col_amax_kernel<__nv_bfloat16, 2>",
               "col_cast_kernel<__nv_bfloat16, 2, true>")
ROW12_NAMES = ("col_cluster_kernel<__nv_bfloat16, 0, true>",
               "col_cluster_kernel<__nv_bfloat16, 1, true>")
GEMM_NAMES = ("nvjet", "gemm", "cutlass", "xmma", "sm90_", "sm80_")
INT8_NAMES = ("i8", "s8", "imma", "int8", "integer")


def phase_train_profile(torch, np, tr, name: str):
    """One step under torch.profiler (wall time includes its overhead):
    device ms by kernel family, busy share, top kernels."""
    ids, labels = train_batch(np)
    wall, ev = traced(torch, lambda: lambda: tr.train_step(ids, labels),
                      with_cpu=True)
    ev.sort(key=lambda e: -e.self_device_time_total)
    ms = {e.key: e.self_device_time_total / 1e3 for e in ev}
    dev = sum(ms.values())
    parts = dict.fromkeys(PROFILE_PARTS, 0.0)
    parts.update(int8_gemm_ms=0.0, bf16_gemm_ms=0.0, other_ms=0.0)
    for k, v in ms.items():
        low = k.lower()
        part = next((p for p, names in PROFILE_PARTS.items()
                     if any(n in k for n in names)), None)
        if part is None and any(n in low for n in GEMM_NAMES):
            part = "int8_gemm_ms" if any(n in low for n in INT8_NAMES) \
                else "bf16_gemm_ms"
        parts[part or "other_ms"] += v
    named = (("row8_ms", ROW8_NAMES), ("row9_ms", ROW9_NAMES),
             ("row10_ms", ROW10_NAMES), ("row11_ms", ROW11_NAMES),
             ("row12_ms", ROW12_NAMES))
    for part, names in named:
        parts[part] = sum(v for k, v in ms.items()
                          if any(n in k for n in names))
    parts["launches"] = {e.key[:100]: e.count for e in ev if any(
        n in e.key for n in PROFILE_PARTS["adamw_ms"]
        + PROFILE_PARTS["adamw8_ms"] + sum((n for _, n in named), ()))}
    emit({"phase": name, "wall_ms": wall * 1e3, "device_ms": dev,
          "device_busy_share": dev / (wall * 1e3), **parts,
          "top_kernels_ms": [(k[:100], v) for k, v in list(ms.items())[:14]]})


class plain_route:
    """Within the block every kernel of the training step runs its plain
    PyTorch version on the card: the quantize wrappers of
    ops/quant_matmul.py (and the int8 CE head's), and the attention (through
    flash_attention_fwd_plain under autograd on the bf16 path, and the
    plain packed forward and backward in the int8 block)."""

    def __enter__(self):
        import torch
        from paddle_tpu_torch.models import gpt as gpt_mod
        from paddle_tpu_torch.ops import fused_ce
        from paddle_tpu_torch.ops import quant_matmul as qm
        from paddle_tpu_torch.ops.flash_attention import (
            flash_attention_bwd_plain, flash_attention_fwd_plain)

        def unpack(qkv, H):
            B, S, _ = qkv.shape
            return qkv.view(B, S, 3, H, -1).unbind(2)

        def attention(qkv, num_heads, causal=False, scale=None):
            B, S, _ = qkv.shape
            return flash_attention_fwd_plain(*unpack(qkv, num_heads), causal,
                                             scale)[0].reshape(B, S, -1)

        def packed_fwd(qkv, H, causal, scale):
            return flash_attention_fwd_plain(*unpack(qkv, H), causal, scale)

        def packed_bwd(qkv, out, lse, dout, H, causal, scale):
            grads = flash_attention_bwd_plain(*unpack(qkv, H), out, lse,
                                              dout.reshape(out.shape),
                                              causal, scale)
            return torch.stack(grads, dim=2).reshape(qkv.shape)
        self.saved = [(gpt_mod, "flash_attention_qkv_fused", attention),
                      (gpt_mod, "flash_qkv_packed_fwd", packed_fwd),
                      (gpt_mod, "flash_qkv_packed_bwd", packed_bwd),
                      (qm, "quantize_rows", qm.quantize_rows_plain),
                      (qm, "quantize_cols", qm.quantize_cols_plain),
                      (qm, "sr_quantize_colwise",
                       qm.sr_quantize_colwise_plain),
                      (qm, "ln_quantize_rowwise",
                       qm.ln_quantize_rowwise_plain),
                      (qm, "sr_quantize_colwise_ln",
                       qm.sr_quantize_colwise_ln_plain),
                      (fused_ce, "quantize_rows", qm.quantize_rows_plain),
                      (fused_ce, "quantize_cols", qm.quantize_cols_plain)]
        self.saved = [(mod, attr, getattr(mod, attr), new)
                      for mod, attr, new in self.saved]
        for mod, attr, _, new in self.saved:
            setattr(mod, attr, new)
        return self

    def __exit__(self, *exc):
        for mod, attr, old, _ in self.saved:
            setattr(mod, attr, old)
        return False


def phase_train_check(torch, np, name: str, recipe: dict):
    """2 layers of the trainer with ``recipe``: one step's loss and every
    gradient through the kernels against the all-plain route on the card
    (the quantize kernels equal their plain versions bit for bit, SR
    noise included, so the two routes differ only where the attention
    rounds P and dS to bf16), within TRAIN_LOSS_TOL and TRAIN_GRAD_TOL."""
    from paddle_tpu_torch.models.gpt import flatten_params
    tr = gpt_trainer(torch, recipe, num_layers=2)
    ids, labels = train_batch(np)
    loss, grads = tr.loss_and_grads(ids, labels)
    with plain_route():
        ploss, pgrads = tr.loss_and_grads(ids, labels)
    loss_diff = abs(float(loss) - float(ploss))
    worst, worst_name = 0.0, ""
    for (path, _), a, b in zip(flatten_params(tr.params), grads, pgrads):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite gradient {path}")
        rel = ((a.float() - b.float()).norm()
               / b.float().norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, path
    if loss_diff > TRAIN_LOSS_TOL or worst > TRAIN_GRAD_TOL:
        raise AssertionError(
            f"{name}: loss |diff| {loss_diff} (tol {TRAIN_LOSS_TOL}),"
            f" worst gradient {worst_name} rel {worst} (tol "
            f"{TRAIN_GRAD_TOL})")
    emit({"phase": name, "recipe": recipe, "layers": 2,
          "loss": float(loss), "plain_loss": float(ploss),
          "loss_abs_diff": loss_diff, "worst_grad_rel_diff": worst,
          "worst_grad": worst_name,
          "tolerance": {"loss_abs": TRAIN_LOSS_TOL,
                        "grad_rel_norm": TRAIN_GRAD_TOL}})
    del tr, grads, pgrads
    torch.cuda.empty_cache()


# ---- Part A: flash attention at every head_dim and in f32 ----

# (D, dtype, causal) at B=4, S=512, H=8: head_dims off the reference
# kernel's {64, 128, 256} in bf16 and f16 (tile widths 32, 96, 96, 64,
# 192 and 192: width 192 has its own 32-column panels and, in the
# backward, output columns split across three panels a warpgroup), and
# f32 (forward and backward 3xTF32 on wgmma) at 64, 128 and 256
ATTN_CASES = [(32, "bfloat16", True), (80, "bfloat16", True),
              (96, "bfloat16", False), (64, "bfloat16", False),
              (160, "bfloat16", True), (192, "float16", False),
              (64, "float32", True), (128, "float32", False),
              (256, "float32", True)]
ATTN_SHAPE = (4, 512, 8)
F32_TOL = 1e-4                   # f32 kernels vs plain (atol=rtol)


def attn_bound(B, S, H, D, causal, itemsize, backward: bool):
    """flash_bound / flash_bwd_bound at the rate of the design each
    kernel uses: bf16/f16 products on the tensor cores; f32 products,
    forward and backward, as three TF32 products each (3xTF32) at the
    TF32 rate. With f32, also ``scalar_bound_ms``: every f32 product at
    the scalar rate, the bound of a kernel that uses no tensor cores."""
    n_bytes = (8 if backward else 4) * B * S * H * D * itemsize \
        + B * H * S * 4
    flops = (10 if backward else 4) * B * H * score_pairs(S, causal) * D
    if itemsize != 4:
        return bound(n_bytes, flops)
    scalar = bound(n_bytes, 0, scalar_ops=flops)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 3 * flops / TF32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"scalar_bound_ms": scalar[0]})


def phase_kernels_attn(torch, F):
    """Part A of the flash kernels: head_dim 32, 80, 96, 64 and 160 in
    bf16, 192 in f16 and f32 at 64, 128 and 256, causal and not, forward
    and backward, against
    the plain versions (bf16 at OUT_TOL / GRAD_TOL, f32 at F32_TOL); the
    backward gives the same bits twice; ms beside the bound, the plain
    version and PyTorch's SDPA (a yardstick); then the f32 kernels on
    packed views (attn_f32_packed). Returns (the cases, the packed row)."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    B, S, H = ATTN_SHAPE
    rows = []
    for D, dt, causal in ATTN_CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(B, S, H, D, device=dev, generator=g)
                       .to(dtype) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       return_lse=True)
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
        grads = flash_attention_bwd(q, k, v, out, lse, do, causal)
        again = flash_attention_bwd(q, k, v, out, lse, do, causal)
        plain = flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise AssertionError(f"flash backward D={D} {dt}: two runs "
                                 f"gave different bits")
        otol = F32_TOL if dt == "float32" else OUT_TOL
        gtol = F32_TOL if dt == "float32" else GRAD_TOL
        torch.testing.assert_close(out.float(), ref.float(), atol=otol,
                                   rtol=otol)
        torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
        for name, a, b in zip(("dq", "dk", "dv"), grads, plain):
            torch.testing.assert_close(
                a.float(), b.float(), atol=gtol, rtol=gtol,
                msg=lambda m: f"{name} D={D} {dt}: {m}")
        qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)
        lib_do = do.transpose(1, 2)
        item = q.element_size()
        fb, fby, *fx = attn_bound(B, S, H, D, causal, item, False)
        bb, bby, *bx = attn_bound(B, S, H, D, causal, item, True)
        rows.append({
            "B": B, "S": S, "H": H, "D": D, "dtype": dt, "causal": causal,
            "fwd": with_rates({
                    "max_abs_err": (out.float() - ref.float()).abs().max()
                    .item(),
                    "ms": device_ms(torch, lambda: flash_attention_fwd(
                        q, k, v, causal=causal), 10),
                    "plain_ms": device_ms(torch, lambda: (
                        flash_attention_fwd_plain(q, k, v, causal)), 3),
                    "library_ms": device_ms(torch, lambda: (
                        F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=causal)), 10),
                    "bound_ms": fb, "bound_by": fby, **(fx[0] if fx else {})},
                flash_flops(B, S, H, D, causal, False)),
            "bwd": with_rates({
                    "max_abs_err": max(
                        (a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, plain)),
                    "bitwise_repeatable": True,
                    "ms": device_ms(torch, lambda: flash_attention_bwd(
                        q, k, v, out, lse, do, causal), 5),
                    "plain_ms": device_ms(torch, lambda: (
                        flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                  causal)), 3),
                    "library_ms": device_ms(torch, lambda: (
                        torch.autograd.grad(lib_out, (qt, kt, vt), lib_do,
                                            retain_graph=True)), 5),
                    "bound_ms": bb, "bound_by": bby, **(bx[0] if bx else {})},
                flash_flops(B, S, H, D, causal, True))})
        del grads, again, plain, lib_out
    packed = attn_f32_packed(torch, F, g)
    emit({"phase": "kernels-attn",
          "tolerance": {"bf16_out_atol_rtol": OUT_TOL,
                        "bf16_grad_atol_rtol": GRAD_TOL,
                        "f32_atol_rtol": F32_TOL, "lse_atol": LSE_TOL},
          "cases": rows, "f32_packed": packed})
    return rows, packed


def attn_f32_packed(torch, F, g) -> dict:
    """The f32 kernels on the packed route: q, k, v strided views of one
    [B, S, 3 H D] projection (ATTN_SHAPE, D=128, causal). The forward
    against the plain version at F32_TOL; the backward through
    ``flash_qkv_packed_bwd`` (dq, dk, dv written into the views of one
    gradient buffer) against the plain backward at F32_TOL, the same bits
    twice; ms of each beside the bound, the plain version and SDPA (its
    forward, and its backward on the same views)."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain, flash_qkv_packed_bwd)
    B, S, H = ATTN_SHAPE
    D, causal = 128, True
    scale = 1.0 / math.sqrt(D)
    qkv = torch.randn(B, S, 3 * H * D, device="cuda", generator=g)
    q, k, v = qkv.view(B, S, 3, H, D).unbind(2)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL, rtol=0)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    fb, fby, fx = attn_bound(B, S, H, D, causal, 4, False)
    row = with_rates({
        "B": B, "S": S, "H": H, "D": D, "causal": causal,
        "max_abs_err": (out - ref).abs().max().item(),
        "ms": device_ms(torch, lambda: flash_attention_fwd(
            q, k, v, causal=causal), 10),
        "plain_ms": device_ms(torch, lambda: flash_attention_fwd_plain(
            q, k, v, causal), 3),
        "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10),
        "bound_ms": fb, "bound_by": fby, **fx},
        flash_flops(B, S, H, D, causal, False))

    do = torch.randn(B, S, H * D, device="cuda", generator=g)
    bwd = lambda: flash_qkv_packed_bwd(qkv, out, lse, do, H, causal, scale)
    first, again = bwd(), bwd()
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do.view(out.shape),
                                      causal)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("f32 packed backward: two runs gave different "
                             "bits")
    errs = []
    for name, a, b in zip(("dq", "dk", "dv"),
                          first.view(B, S, 3, H, D).unbind(2), plain):
        errs.append((a - b).abs().max().item())
        torch.testing.assert_close(a, b, atol=F32_TOL, rtol=F32_TOL,
                                   msg=lambda m: f"packed f32 {name}: {m}")
    # SDPA's backward alone on the same views: its forward once, then its
    # autograd backward into the packed projection, timed on the same dO
    leaf = qkv.detach().requires_grad_()
    lt = [t.transpose(1, 2) for t in leaf.view(B, S, 3, H, D).unbind(2)]
    lib_out = F.scaled_dot_product_attention(*lt, is_causal=causal)
    lib_do = do.view(B, S, H, D).transpose(1, 2)
    bb, bby, bx = attn_bound(B, S, H, D, causal, 4, True)
    row["bwd"] = with_rates({
        "max_abs_err": max(errs), "bitwise_repeatable": True,
        "ms": device_ms(torch, bwd, 10),
        "plain_ms": device_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, out, lse, do.view(out.shape), causal), 3),
        "library_ms": device_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaf, lib_do, retain_graph=True), 10),
        "bound_ms": bb, "bound_by": bby, **bx},
        flash_flops(B, S, H, D, causal, True))
    del first, again, plain, lib_out
    return row


F32_BWD_KERNELS = ("flash_bwd_dkdv_f32_kernel", "flash_bwd_dq_f32_kernel")


def phase_sdpa_f32(torch) -> dict:
    """The f32 backward on the path a user takes: the port's
    ``nn.functional.scaled_dot_product_attention`` on f32 q, k, v that
    require grad (ATTN_SHAPE, D=128, not causal), then ``backward``. The
    launch counts are set to 0 just before the forward and read just
    after the backward (one forward and one f32 backward launch), and
    torch.profiler's CUDA trace of the backward holds each f32 backward
    kernel exactly once (a trace that lost a kernel's event is taken
    again, PROFILE_TRIES times in all); the gradients are finite and
    within F32_TOL of the plain backward's."""
    from paddle_tpu_torch.nn.functional.attention import (
        scaled_dot_product_attention)
    from paddle_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)
    B, S, H = ATTN_SHAPE
    D = 128
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=g)
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def setup():
        for t in leaves:
            t.grad = None
        reset_launches()
        out = scaled_dot_product_attention(*leaves)
        return lambda: out.backward(do)
    for _ in range(PROFILE_TRIES):
        _, ev = traced(torch, setup)
        launches = read_launches()
        events = {n: sum(e.count for e in ev if n in e.key)
                  for n in F32_BWD_KERNELS}
        if all(events.values()):
            break
    if any(n != 1 for n in events.values()):
        raise AssertionError(f"f32 SDPA backward: kernel events {events}, "
                             f"one of each expected")
    want = {"flash_attention_fwd": 1, "flash_attention_bwd": 1,
            "flash_attention_bwd_f32": 1}
    if any(launches[k] != n for k, n in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"f32 SDPA forward + backward launched "
                             f"{launches}, expected {want}")
    out, lse = flash_attention_fwd_plain(q, k, v)
    plain = flash_attention_bwd_plain(q, k, v, out, lse, do)
    errs = []
    for name, t, b in zip(("dq", "dk", "dv"), leaves, plain):
        if not torch.isfinite(t.grad).all():
            raise AssertionError(f"f32 SDPA backward: {name} not finite")
        errs.append((t.grad - b).abs().max().item())
        torch.testing.assert_close(t.grad, b, atol=F32_TOL, rtol=F32_TOL,
                                   msg=lambda m: f"f32 SDPA {name}: {m}")
    emit({"phase": "sdpa-f32", "B": B, "S": S, "H": H, "D": D,
          "causal": False, "launches": launches, "kernel_events": events,
          "max_abs_err": max(errs), "f32_atol_rtol": F32_TOL})
    return launches


# ---- row 15: the BatchNorm kernels ----

RESNET_B, RESNET_HW = 256, 224
# (C, S) of ResNet-50's 53 BatchNorms at 224x224, with how many layers
# have each shape: the stem; layer1-4's bn1/bn2/bn3 and downsample BNs
# (a stage's first bn1 sees the previous stage's resolution): 2.845 G
# values a step at batch 256
BN_SHAPES = [(64, 12544, 1), (64, 3136, 6), (128, 3136, 1), (256, 3136, 4),
             (128, 784, 7), (256, 784, 1), (512, 784, 5), (256, 196, 11),
             (512, 196, 1), (1024, 196, 7), (512, 49, 5), (2048, 49, 4)]
BN_LAYERS = 53
BN_SUM_TOL = 1e-5               # kernel vs plain sums, relative to max|.|
BN_TIMED = ((64, 12544), (2048, 49))   # plain and library timed here


def bn_bytes(kernel: str, n: int, C: int, item: int) -> int:
    """Bytes the kernel must move for n values: stats reads x; apply
    reads x and writes y; gsum reads dy and x; dx reads dy and x and
    writes dx; plus its [C] f32 vectors (2 in or out each)."""
    per = {"bn_stats": 1, "bn_apply": 2, "bn_gsum": 2, "bn_dx": 3}[kernel]
    vecs = {"bn_stats": 2, "bn_apply": 2, "bn_gsum": 4, "bn_dx": 5}[kernel]
    return per * n * item + vecs * C * 4


def check_sums(torch, name, got, want) -> float:
    err = 0.0
    for a, b in zip(got, want):
        scale = b.abs().max().clamp_min(1.0)
        e = ((a - b).abs().max() / scale).item()
        if e > BN_SUM_TOL:
            raise AssertionError(f"{name}: sums off by {e} of their max "
                                 f"(tol {BN_SUM_TOL})")
        err = max(err, (a - b).abs().max().item())
    return err


def phase_kernels_bn(torch, F):
    """Each BN kernel against its plain version at the 12 BN shapes of
    ResNet-50 at batch 256 ([256, C, S]), bf16 with relu on and off (the
    training step), kernel 2 also f32 (the eval phase): apply and dx bit
    for bit (the same rounded operations), the sums within BN_SUM_TOL of
    their largest magnitude (the same terms in another order); two runs
    give the same bits. ms beside the bytes bound at every shape; the
    plain versions and library calls (torch.var_mean for stats,
    torch.addcmul for apply; cuDNN's F.batch_norm(training=True) forward
    and backward as a yardstick for each pair) at the stem and layer4
    shapes. Returns {kernel: rows}."""
    from paddle_tpu_torch.ops import batch_norm as bn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = {k: [] for k in ("bn_stats", "bn_apply", "bn_gsum", "bn_dx")}
    per_step = dict.fromkeys(rows, 0.0)
    bound_step = dict.fromkeys(rows, 0.0)
    cudnn = []
    for C, S, layers in BN_SHAPES:
        N = RESNET_B
        x = (torch.randn(N, C, S, device=dev, generator=g) * 2 + 0.3) \
            .bfloat16()
        dy = torch.randn(N, C, S, device=dev, generator=g).bfloat16()
        scale = torch.rand(C, device=dev, generator=g) + 0.5
        shift = torch.randn(C, device=dev, generator=g)
        A, B, D = (torch.randn(C, device=dev, generator=g) for _ in range(3))
        x32 = x.float()
        timed = (C, S) in BN_TIMED
        for relu in (True, False):
            rf = (scale, shift) if relu else None
            runs = [(bn.bn_stats(x), bn.bn_apply(x, scale, shift, relu),
                     bn.bn_gsum(dy, x, rf), bn.bn_dx(dy, x, A, B, D, rf))
                    for _ in range(2)]
            torch.cuda.synchronize()
            (s, y, gs, dx), (s2, y2, gs2, dx2) = runs
            if not all(torch.equal(a, b) for a, b in
                       zip((*s, y, *gs, dx), (*s2, y2, *gs2, dx2))):
                raise AssertionError(f"BN kernels [{N}, {C}, {S}] relu="
                                     f"{relu}: two runs gave other bits")
            if not torch.equal(y, bn.bn_apply_plain(x, scale, shift, relu)):
                raise AssertionError(f"bn_apply [{N}, {C}, {S}] relu={relu}"
                                     f" differs from its plain version")
            if not torch.equal(dx, bn.bn_dx_plain(dy, x, A, B, D, rf)):
                raise AssertionError(f"bn_dx [{N}, {C}, {S}] relu={relu} "
                                     f"differs from its plain version")
            errs = {"bn_stats": check_sums(torch, "bn_stats", s,
                                           bn.bn_stats_plain(x)),
                    "bn_apply": 0.0, "bn_dx": 0.0,
                    "bn_gsum": check_sums(torch, "bn_gsum", gs,
                                          bn.bn_gsum_plain(dy, x, rf))}
            if relu:
                calls = {
                    "bn_stats": (lambda: bn.bn_stats(x),
                                 lambda: bn.bn_stats_plain(x),
                                 lambda: torch.var_mean(x, dim=(0, 2))),
                    "bn_apply": (lambda: bn.bn_apply(x, scale, shift, True),
                                 lambda: bn.bn_apply_plain(x, scale, shift,
                                                           True),
                                 lambda: torch.addcmul(
                                     shift.view(1, -1, 1), x,
                                     scale.view(1, -1, 1))),
                    "bn_gsum": (lambda: bn.bn_gsum(dy, x, (scale, shift)),
                                lambda: bn.bn_gsum_plain(dy, x,
                                                         (scale, shift)),
                                None),
                    "bn_dx": (lambda: bn.bn_dx(dy, x, A, B, D,
                                               (scale, shift)),
                              lambda: bn.bn_dx_plain(dy, x, A, B, D,
                                                     (scale, shift)),
                              None)}
                for k, (kern, plain, lib) in calls.items():
                    b_ms, b_by = bound(bn_bytes(k, N * C * S, C, 2), 0)
                    ms = device_ms(torch, kern, 10)
                    per_step[k] += ms * layers
                    bound_step[k] += b_ms * layers
                    rows[k].append({
                        "shape": [N, C, S], "dtype": "bfloat16",
                        "relu": True, "layers": layers,
                        "max_abs_err": errs[k], "bitwise_repeatable": True,
                        "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                        "plain_ms": device_ms(torch, plain, 3)
                        if timed else None,
                        "library_ms": device_ms(torch, lib, 10)
                        if timed and lib is not None else None})
            else:
                for k in rows:
                    rows[k][-1]["relu_off_max_abs_err"] = errs[k]
        # kernel 2 in f32, as the eval phase runs it
        y32 = bn.bn_apply(x32, scale, shift, True)
        if not torch.equal(y32, bn.bn_apply_plain(x32, scale, shift, True)):
            raise AssertionError(f"bn_apply f32 [{N}, {C}, {S}] differs")
        rows["bn_apply"][-1]["f32_ms"] = device_ms(
            torch, lambda: bn.bn_apply(x32, scale, shift, True), 10)
        if timed:
            w = torch.ones(C, device=dev, requires_grad=True)
            b = torch.zeros(C, device=dev, requires_grad=True)
            x4 = x.view(N, C, S, 1).detach().requires_grad_()
            out = F.batch_norm(x4, None, None, w.bfloat16(), b.bfloat16(),
                               training=True)
            # cuDNN's mixed route: bf16 x with f32 weight and bias, as
            # the ResNet's O2 BN layers keep them (the bf16-affine call
            # above is kept beside it for the earlier rows)
            out32 = F.batch_norm(x4, None, None, w, b, training=True)
            cudnn.append({"shape": [N, C, S],
                          "fwd_ms": device_ms(torch, lambda: F.batch_norm(
                              x4, None, None, w.bfloat16(), b.bfloat16(),
                              training=True), 10),
                          "bwd_ms": device_ms(torch, lambda: (
                              torch.autograd.grad(out, (x4,),
                                                  dy.view_as(out),
                                                  retain_graph=True)), 10),
                          "f32_affine_fwd_ms": device_ms(
                              torch, lambda: F.batch_norm(
                                  x4, None, None, w, b, training=True), 10),
                          "f32_affine_bwd_ms": device_ms(torch, lambda: (
                              torch.autograd.grad(out32, (x4,),
                                                  dy.view_as(out32),
                                                  retain_graph=True)), 10),
                          "f32_affine_fwd_kernels": kernel_names(
                              kernel_events(torch, lambda: F.batch_norm(
                                  x4, None, None, w, b, training=True), 2)),
                          "bf16_affine_fwd_kernels": kernel_names(
                              kernel_events(torch, lambda: F.batch_norm(
                                  x4, None, None, w.bfloat16(),
                                  b.bfloat16(), training=True), 2)),
                          "bytes_bound_fwd_ms": bound(
                              3 * N * C * S * 2, 0)[0]})
            del out, out32, x4
        del x, dy, x32, y32, runs
    emit({"phase": "kernels-bn", "tolerance": {"sums_rel_max": BN_SUM_TOL,
                                               "apply_dx": "bitwise"},
          "rows": rows, "cudnn_batch_norm_yardstick": cudnn,
          "ms_per_step_at_53_layers": per_step,
          "bound_ms_per_step": bound_step,
          "bn_ms_per_step": sum(per_step.values()),
          "bn_bound_ms_per_step": sum(bound_step.values())})
    return rows


# ---- ResNet-50: AMP-O2 training and fp32 inference ----

RESNET_WARMUP, RESNET_STEPS = 2, 5


def resnet_data(np, torch, batch: int = RESNET_B, hw: int = RESNET_HW):
    """bench_resnet50.py's data (np.random.rand images in [0, 1) and
    randint labels), seeded here: the bench draws unseeded."""
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 3, hw, hw).astype(np.float32)
    y = rng.randint(0, 1000, (batch,)).astype(np.int64)
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def resnet_train_step(torch, model=None):
    """bench_resnet50.py:build_train_step's recipe on the port: resnet50
    (weights from seed 0), Momentum(lr 0.01), amp.decorate O2 bf16,
    TrainStep with CrossEntropyLoss; returns (step, model, opt) where
    step(x, y) runs under auto_cast O2."""
    from paddle_tpu_torch import amp, jit, nn, optimizer
    from paddle_tpu_torch.vision.models import resnet50
    if model is None:
        model = resnet50(generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    model.train()
    opt = optimizer.Momentum(learning_rate=0.01,
                             parameters=model.parameters())
    model, opt = amp.decorate(models=model, optimizers=opt, level="O2",
                              dtype="bfloat16")
    train = jit.TrainStep(model, opt, nn.CrossEntropyLoss())

    def step(x, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return train(x, y)
    return step, model, opt


BN_KERNELS = ("bn_stats", "bn_apply", "bn_gsum", "bn_dx")


def phase_train_resnet(torch, np):
    """ResNet-50 AMP-O2 at batch 256, 3x224x224: 2 warm-up and 5 counted
    steps, the launch counts set to 0 just before and read just after:
    exactly 53 of each BN kernel a step and no other port kernel; every
    loss finite. img/s, step ms, peak memory."""
    step, model, opt = resnet_train_step(torch)
    x, y = resnet_data(np, torch)
    losses = [step(x, y) for _ in range(RESNET_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    want = no_launches()
    want.update({k: BN_LAYERS * RESNET_STEPS for k in BN_KERNELS})
    if counts != want:
        raise AssertionError(f"train-resnet50 launches {counts}, expected "
                             f"{want} over {RESNET_STEPS} steps")
    losses = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train-resnet50: non-finite loss {losses}")
    emit({"phase": "train-resnet50", "batch": RESNET_B,
          "image": [3, RESNET_HW, RESNET_HW], "recipe": "AMP-O2 bf16, "
          "Momentum(lr 0.01, 0.9), CrossEntropyLoss, TrainStep",
          "params": sum(p.numel() for p in model.parameters()),
          "steps": RESNET_STEPS, "losses": losses,
          "step_ms": wall / RESNET_STEPS * 1e3,
          "img_per_s": RESNET_B * RESNET_STEPS / wall,
          "launches_per_step": {k: v / RESNET_STEPS
                                for k, v in counts.items()},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "reductions": ["data from numpy.random.RandomState(0): the bench "
                         "draws unseeded", "weights random from seed 0"]})
    return counts, step, model, opt, (x, y)


# kernel families of the ResNet step's trace by name
RESNET_PARTS = (
    ("bn_stats_ms", ("bn_partial_kernel<__nv_bfloat16, 8, false>",
                     "bn_partial_kernel<__nv_bfloat16, 4, false>",
                     "bn_partial_kernel<__nv_bfloat16, 2, false>",
                     "bn_partial_kernel<__nv_bfloat16, 1, false>")),
    ("bn_gsum_ms", ("bn_partial_kernel",)),
    ("bn_sum_partials_ms", ("bn_sum_partials_kernel",)),
    ("bn_apply_ms", ("bn_apply_kernel",)),
    ("bn_dx_ms", ("bn_dx_kernel",)),
    ("conv_dgrad_ms", ("dgrad",)),
    ("conv_wgrad_ms", ("wgrad",)),
    ("conv_fwd_ms", ("fprop", "implicit_convolve", "conv2d_grouped",
                     "convolve")),
    ("conv_layout_ms", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("gemm_ms", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("elementwise_ms", ("elementwise", "copy", "fill")),
    ("reduce_ms", ("reduce", "softmax", "pool", "nll")),
)


def phase_train_resnet_profile(torch, step, opt, data):
    """One step under torch.profiler: device ms by kernel family (each
    BN kernel, stats and gsum by their kGrad template argument, and the
    second pass they share; cuDNN convolutions forward, dgrad, wgrad and
    their layout passes; elementwise, reductions, the rest), busy share,
    top kernels; the optimizer's update alone in a second trace."""
    x, y = data
    wall, ev = traced(torch, lambda: lambda: step(x, y), with_cpu=True)
    ev.sort(key=lambda e: -e.self_device_time_total)
    ms = {e.key: e.self_device_time_total / 1e3 for e in ev}
    dev = sum(ms.values())
    parts = {name: 0.0 for name, _ in RESNET_PARTS}
    parts["other_ms"] = 0.0
    for k, v in ms.items():
        low = k.lower()
        part = next((p for p, names in RESNET_PARTS
                     if any(n.lower() in low for n in names)), "other_ms")
        parts[part] += v
    parts["bn_ms"] = sum(v for k, v in parts.items() if k.startswith("bn_"))
    _, oev = traced(torch, lambda: opt.step, with_cpu=True)
    emit({"phase": "train-resnet50-profile", "wall_ms": wall * 1e3,
          "device_ms": dev, "device_busy_share": dev / (wall * 1e3),
          **parts, "optimizer_step_device_ms": sum(
              e.self_device_time_total for e in oev) / 1e3,
          "top_kernels_ms": [(k[:100], v)
                             for k, v in list(ms.items())[:16]]})


def phase_infer_resnet(torch, np):
    """bench_resnet50.py's inference phase (:48-61): eval mode, fp32,
    batch 256, 224x224, in torch.inference_mode(): 2 warm-up and 10
    timed forwards; BN runs kernel 2 in f32 (53 launches a forward).
    cuDNN's fp32 convolutions run in TF32 when
    torch.backends.cudnn.allow_tf32 (PyTorch's default), printed."""
    from paddle_tpu_torch.ops import batch_norm as bn
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(generator=torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    x, _ = resnet_data(np, torch)
    steps = 10
    with torch.inference_mode():
        for _ in range(2):
            out = model(x)
        torch.cuda.synchronize()
        before = bn.bn_apply.launches
        t0 = time.perf_counter()
        for _ in range(steps):
            out = model(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (bn.bn_apply.launches - before) / steps
    if launches != BN_LAYERS or out.shape != (RESNET_B, 1000) \
            or out.dtype != torch.float32 or not torch.isfinite(out).all():
        raise AssertionError(f"infer-resnet50: {launches} bn_apply "
                             f"launches a forward, out {out.dtype}"
                             f"{tuple(out.shape)}")
    emit({"phase": "infer-resnet50", "batch": RESNET_B, "dtype": "float32",
          "img_per_s": RESNET_B * steps / wall,
          "forward_ms": wall / steps * 1e3,
          "bn_apply_launches_per_forward": launches,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    del model, out


class bn_plain_route:
    """Within the block the four BN wrappers run their plain versions on
    the card."""

    def __enter__(self):
        from paddle_tpu_torch.ops import batch_norm as bn
        self.saved = {k: getattr(bn, k) for k in BN_KERNELS}
        for k in BN_KERNELS:
            setattr(bn, k, getattr(bn, k + "_plain"))
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import batch_norm as bn
        for k, fn in self.saved.items():
            setattr(bn, k, fn)
        return False


RESNET_CHECK_B = 64
# train-check-resnet tolerances, kernel route vs plain route (cuDNN
# deterministic, no TF32). In f32 the routes differ only in the order of
# the BN kernels' f32 sums: the loss and the running statistics to
# RESNET_F32_TOL of their magnitude; the gradients to RESNET_F32_GRAD_TOL
# of each one's norm, since the backward's per-channel sums of dy nearly
# cancel (0.4% measured at seed 0, by this phase). Under O2 a bf16 y
# also rounds the other way now and then, and each BN backward magnifies
# such a change (dx = A dy + B x + D nearly cancels): 9% of the global
# norm and up to 19% of one gradient's, measured by this phase, where
# the reference's own O2 gradients differ from a float64 evaluation by
# 25-30% (tests/test_torch_resnet.py): the loss within TRAIN_LOSS_TOL,
# the global norm within RESNET_O2_GRAD_TOL, each gradient within
# RESNET_O2_EACH_GRAD_TOL, the running statistics within RESNET_STAT_TOL
RESNET_F32_TOL = 1e-5
RESNET_F32_GRAD_TOL = 1e-2
RESNET_O2_GRAD_TOL = 0.25
RESNET_O2_EACH_GRAD_TOL = 0.5
RESNET_STAT_TOL = 1e-3


def resnet_check_run(torch, np, base, plain: bool, o2: bool):
    """One TrainStep of a copy of ``base`` (kernel or plain BN route):
    (loss, {name: gradient}, {name: running statistic}, BN param names)."""
    import copy
    from paddle_tpu_torch import jit, nn, optimizer
    model = copy.deepcopy(base)
    if o2:
        step, model, opt = resnet_train_step(torch, model)
    else:
        opt = optimizer.Momentum(learning_rate=0.01,
                                 parameters=model.parameters())
        step = jit.TrainStep(model, opt, nn.CrossEntropyLoss())
    x, y = resnet_data(np, torch, RESNET_CHECK_B)
    with (bn_plain_route() if plain else contextlib.nullcontext()):
        loss = float(step(x, y))
    grads = {n: opt._accumulators[p]["velocity"].float().clone()
             for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    bn_params = {n for n, p in model.named_parameters() if p.dim() == 1
                 and not n.startswith("fc")}
    return loss, grads, stats, bn_params


class cudnn_exact:
    """Within the block cuDNN picks deterministic algorithms and no TF32,
    so two runs of one route give the same bits and the routes differ
    only where the BN kernels and their plain versions do."""

    def __enter__(self):
        import torch
        b = torch.backends.cudnn
        self.saved = (b.deterministic, b.benchmark, b.allow_tf32)
        b.deterministic, b.benchmark, b.allow_tf32 = True, False, False
        return self

    def __exit__(self, *exc):
        import torch
        b = torch.backends.cudnn
        b.deterministic, b.benchmark, b.allow_tf32 = self.saved
        return False


def phase_train_check_resnet(torch, np):
    """ResNet-50 cut to the first block of each stage, batch 64 at
    224x224, weights from seed 0, cuDNN deterministic without TF32: one
    TrainStep through the BN kernels twice (the same bits) and against
    the same step with the four BN wrappers on their plain versions, in
    f32 and under AMP O2 (the tolerances above)."""
    from paddle_tpu_torch.vision.models import resnet50
    base = resnet50(generator=torch.Generator(device="cuda").manual_seed(0))
    for name in ("layer1", "layer2", "layer3", "layer4"):
        setattr(base, name, getattr(base, name)[0:1])
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    out = {}
    for o2 in (False, True):
        with cudnn_exact():
            (loss, grads, stats, bn_params), (loss2, grads2, _, _), \
                (ploss, pgrads, pstats, _) = (
                    resnet_check_run(torch, np, base, plain, o2)
                    for plain in (False, False, True))
        if loss2 != loss or not all(torch.equal(grads[n], grads2[n])
                                    for n in grads):
            raise AssertionError(f"train-check-resnet (o2={o2}): two runs "
                                 f"of the kernel route gave other bits")
        if not all(torch.isfinite(t).all() for t in grads.values()):
            raise AssertionError("train-check-resnet: non-finite gradient")
        diffs = {n: rel(grads[n], pgrads[n]) for n in grads}
        glob = (sum((grads[n] - pgrads[n]).norm() ** 2 for n in grads)
                / sum(pgrads[n].norm() ** 2 for n in grads)).sqrt().item()
        bn_worst = max((diffs[n], n) for n in bn_params)
        other_worst = max((d, n) for n, d in diffs.items()
                          if n not in bn_params)
        stat_worst = max((rel(stats[n], pstats[n]), n) for n in stats)
        key = "o2" if o2 else "f32"
        out[key] = {"loss": loss, "plain_loss": ploss,
                    "loss_abs_diff": abs(loss - ploss),
                    "grad_global_rel_diff": glob,
                    "worst_bn_param_grad": bn_worst,
                    "worst_other_grad": other_worst,
                    "worst_stat": stat_worst,
                    "grad_rel_diffs": sorted(
                        ((round(d, 6), n) for n, d in diffs.items()),
                        reverse=True)[:12]}
        if o2:
            ok = (abs(loss - ploss) <= TRAIN_LOSS_TOL
                  and glob <= RESNET_O2_GRAD_TOL
                  and max(diffs.values()) <= RESNET_O2_EACH_GRAD_TOL
                  and stat_worst[0] <= RESNET_STAT_TOL)
        else:
            ok = (abs(loss - ploss) <= RESNET_F32_TOL * abs(ploss)
                  and max(diffs.values()) <= RESNET_F32_GRAD_TOL
                  and stat_worst[0] <= RESNET_F32_TOL)
        out[key]["ok"] = ok
    if not all(v["ok"] for v in out.values()):
        raise AssertionError(f"train-check-resnet: {out}")
    emit({"phase": "train-check-resnet", "blocks_per_stage": 1,
          "batch": RESNET_CHECK_B, "cudnn": "deterministic, no TF32",
          **out,
          "tolerance": {"f32_loss_stat_rel": RESNET_F32_TOL,
                        "f32_grad_rel_norm": RESNET_F32_GRAD_TOL,
                        "o2_loss_abs": TRAIN_LOSS_TOL,
                        "o2_grad_global_rel_norm": RESNET_O2_GRAD_TOL,
                        "o2_grad_rel_norm": RESNET_O2_EACH_GRAD_TOL,
                        "o2_stat_rel_norm": RESNET_STAT_TOL}})
    del base
    torch.cuda.empty_cache()

# -- GPT serving (GPTForCausalLM on every engine path) -----------------------
# GPT-1.3B (gpt_1p3b_config) served at serve's geometry; its phases run
# after the Llama phases, once that model is freed. A block swaps four
# linears (qkv, proj, fc1, fc2) under weight_only_int4 / _int8; the tied
# head is a matmul against wte and stays bf16
GPT_LINEARS_PER_BLOCK = 4
# serve-gpt-prefix: one 384-token system prompt and 16 requests after it
# (a 16-token tail each, 32 new tokens), paged with sharing on, against
# the same prompts unshared
GPT_PREFIX_SYS, GPT_PREFIX_TAIL, GPT_PREFIX_NEW = 384, 16, 32
# serve-gpt-spec's self-draft engine: serve's 16 prompts at 16 new
# tokens each (every drafted token is one eager model call of 24
# layers), held to the first 16 tokens of the paged k=1 run
GPT_DRAFT_NEW = 16
# serve-gpt-recover: serve's trace on the paged layout, a decode fault at
# its 21st decode step
GPT_RC_FAULTS = (("serving.step.decode", 20),)
# row 7 at GPT-1.3B's four linears ([K, N], group 128)
GPT_INT4_SHAPES = [(2048, 6144, 128, "qkv"), (2048, 2048, 128, "proj"),
                   (2048, 8192, 128, "fc1"), (8192, 2048, 128, "fc2")]
GPT_INT4_MS = (1, 16, 512)


def gpt_model(torch, dtype="bfloat16"):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    gen = torch.Generator(device="cuda").manual_seed(0)
    return GPTForCausalLM(gpt_1p3b_config(), dtype=dtype, generator=gen)


def split_stats(gaps) -> dict:
    """How many splits, how many of them exact ties (the two logits equal
    in bf16), the widest in bf16 steps, and the first eight (gap, step)."""
    return {"splits": len(gaps), "exact_ties": sum(g == 0.0 for g, _ in gaps),
            "max_gap_bf16_steps": max((g / s for g, s in gaps), default=0.0),
            "split_gaps": gaps[:8]}


def full_forward_rule(torch, np, name, model, prompts, reqs,
                      gate: bool = True) -> dict:
    """The identity rule against the reference GPT test's anchor, a
    full-context greedy recompute (tests/test_serving_engine.py:135):
    one uncached forward over each prompt and its served tokens gives at
    each position the logits the greedy loop sees once it has chosen the
    served tokens before it, so no split there means the loop yields
    exactly the served tokens ("tokens"); otherwise the agreement must
    reach IDENTITY_AGREE_MIN with every split within one bf16 step
    ("near-ties"). The uncached forward takes row 1 over the whole
    sequence; the engine's decode, the cache's einsum. ``gate=False``
    prints the agreement and the splits (an exact tie counted apart)
    without holding them: bf16 logits of random weights tie often
    enough that the two attention routes split them (see PERF.md)."""
    hits, gaps = [], []
    with torch.inference_mode():
        for p, r in zip(prompts, reqs):
            seq = np.concatenate([p, r.output_ids[:-1]]).astype(np.int64)
            ids = torch.as_tensor(seq, device=model.device)[None]
            rows = model(ids)[0, len(p) - 1:].float().cpu().numpy()
            if not np.isfinite(rows).all():
                raise AssertionError(f"{name}: non-finite logits")
            for row, tok in zip(rows, r.output_ids):
                hits.append(int(row.argmax()) == tok)
                if not hits[-1]:
                    gaps.append(split_gap(row, tok))
    agree = sum(hits) / len(hits)
    if gate and (agree < IDENTITY_AGREE_MIN
                 or any(g > s for g, s in gaps)):
        raise AssertionError(
            f"{name}: the full-context greedy forward agrees with the "
            f"served tokens at {agree} of positions (min "
            f"{IDENTITY_AGREE_MIN}), split gaps {gaps[:8]} (bound one "
            f"bf16 step)")
    return {"full_forward_agreement": agree, **split_stats(gaps),
            "held": gate,
            "identity_held_by": "tokens" if not gaps else "near-ties"}


def forced_run(torch, base_reqs, prompts, engine, route=None):
    """``engine`` serves ``prompts`` fed the base run's tokens (teacher
    forcing), under ``route`` (a plain_route context) when given: the
    (agreement, gaps) the identity rule reads."""
    with (route() if route else contextlib.nullcontext()), \
            teacher_forcing([r.output_ids for r in base_reqs]) as tf:
        for p, b in zip(prompts, base_reqs):
            tf.track(engine.submit(p, max_new_tokens=len(b.output_ids)))
        engine.run()
    if engine.paged:
        no_leaks(engine, "teacher-forced run")
    return tf.result()


def route_parity(torch, np, model, route) -> dict:
    """The last-token logits of a 64-token prompt (RandomState(0))
    through the kernels and through ``route``'s plain versions: max
    |diff| / max |plain| and whether the argmax agrees."""
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, model.config.vocab_size, (1, DECODE_PROMPT)), device=model.device)
    with torch.inference_mode():
        kern = model(ids)[0, -1].double()
        with route():
            plain = model(ids)[0, -1].double()
    rel = ((kern - plain).abs().max()
           / plain.abs().max().clamp_min(1e-9)).item()
    return {"last_logit_rel_err_vs_plain": rel,
            "argmax_same": int(kern.argmax()) == int(plain.argmax())}


def gpt_serve_prefix(torch, np, model, name, hold: bool) -> dict:
    """16 requests over one shared 384-token system prompt through the
    paged engine with prefix sharing (the prompt warmed first: every
    request extends over its 3 pages, learned positions from 384 on, no
    row-1 launch) against the same prompts unshared (16 whole prefills,
    row 1): each request's first token the argmax of its own extend
    logits, those within ROUTE_TOL of its whole prefill's (as
    serve-prefix holds Llama's), and with ``hold`` (the f32 model) the
    tokens held by the identity rule; at bf16 the rule's agreement is
    printed (its exact ties split by the two routes, see PERF.md)."""
    from paddle_tpu_torch.serving import ServingEngine
    rng = np.random.RandomState(2)
    system = rng.randint(1, 100, (GPT_PREFIX_SYS,)).astype(np.int64)
    prompts = [np.concatenate([system, rng.randint(1, 100, (
        GPT_PREFIX_TAIL,))]).astype(np.int64) for _ in range(SLOTS)]
    news = [GPT_PREFIX_NEW] * SLOTS
    layers = served(model).num_layers

    def engine(share, first_logits=None):
        eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                            min_bucket=MIN_BUCKET, page_size=PAGE,
                            prefix_sharing=share)
        if share:                   # the system prompt's pages indexed
            eng.submit(np.concatenate([system, system[:1]]),
                       max_new_tokens=1)
            eng.run()
        if first_logits is not None:
            raw = eng._prefill_raw

            def keep(slot, ids, req, **kw):
                first_logits[req.rid] = raw(slot, ids, req, **kw)
                return first_logits[req.rid]
            eng._prefill_raw = keep
        return eng
    base_first, first = {}, {}
    base = engine(False, base_first)
    base_reqs, base_wall, counts = serve_run(torch, base, prompts, news)
    flash_unshared = flash_only(f"{name} unshared", counts, layers * SLOTS)
    no_leaks(base, f"{name} unshared")
    del base
    eng = engine(True, first)
    extends = count_calls(eng, "_extend")
    reqs, wall, counts = serve_run(torch, eng, prompts, news)
    flash_shared = flash_only(f"{name} shared", counts, 0)
    st = eng.paged_stats()
    if extends[0] != SLOTS or st["prefix_hit_tokens"] != SLOTS * GPT_PREFIX_SYS:
        raise AssertionError(
            f"{name}: {extends[0]} extends, prefix_hit_tokens "
            f"{st['prefix_hit_tokens']}; expected {SLOTS} and "
            f"{SLOTS * GPT_PREFIX_SYS}")
    no_leaks(eng, f"{name} shared")
    diff = 0.0
    for r, b in zip(reqs, base_reqs):
        got = first[r.rid]
        if int(np.argmax(got)) != r.output_ids[0]:
            raise AssertionError(
                f"{name}: request {r.rid}'s first token {r.output_ids[0]} "
                f"is not the argmax of its extend logits")
        diff = max(diff, float(np.abs(got - base_first[b.rid]).max()))
    if diff > ROUTE_TOL:
        raise AssertionError(f"{name}: extend logits differ from the whole "
                             f"prefill's by {diff} > {ROUTE_TOL}")

    def forced():
        return forced_run(torch, base_reqs, prompts, engine(True))
    if hold:
        ident = identity_rule(name, reqs, base_reqs, forced)
    else:
        agree, gaps = forced()
        ident = {"greedy_agreement": agreement(reqs, base_reqs),
                 "forced_agreement": agree, **split_stats(gaps),
                 "held": False}
    emit({"phase": name, "requests": SLOTS,
          "system_prompt": GPT_PREFIX_SYS, "tail": GPT_PREFIX_TAIL,
          "new": GPT_PREFIX_NEW, "page_size": PAGE,
          "flash_launches": {"unshared": flash_unshared,
                             "shared": flash_shared},
          "extends": extends[0], "prefix_hit_tokens": st["prefix_hit_tokens"],
          "prefix_hit_rate": st["prefix_hit_rate"],
          "extend_logits_max_abs_diff": diff, "route_tol": ROUTE_TOL,
          "tokens_per_s": {"unshared": sum(len(r.output_ids)
                                           for r in base_reqs) / base_wall,
                           "shared": sum(len(r.output_ids)
                                         for r in reqs) / wall},
          **ident, "leaks": 0})
    return {"flash_attention_fwd": flash_shared}


def gpt_serve_spec(torch, np, model, prompts, k1_reqs, k1_m) -> dict:
    """serve's trace through paged speculative engines at k = 4: the
    n-gram proposer over the whole trace, and a GPT self-draft
    (draft_model=model) over its first GPT_DRAFT_NEW tokens a request;
    each held to the paged k=1 run's tokens by the identity rule,
    teacher-forcing through the verify (spec_forced). Prefix sharing is
    off: spec_drive's warm-up serves every prompt once first, and a
    shared prompt would then extend instead of running the k=1 run's
    whole prefill."""
    import types
    layers = served(model).num_layers
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]
    runs = {"ngram": ({}, news),
            "self-draft": (dict(spec_proposer="draft", draft_model=model),
                           [min(n, GPT_DRAFT_NEW) for n in news])}
    rows, launches = {}, {}
    for name, (kw, n_new) in runs.items():
        base = [types.SimpleNamespace(output_ids=r.output_ids[:n])
                for r, n in zip(k1_reqs, n_new)]
        run = spec_drive(torch, np, model, prompts, n_new, page_size=PAGE,
                         prefix_sharing=False, speculative=True,
                         spec_k=SPEC_K, **kw)
        eng = run["engine"]
        flash = flash_only(f"serve-gpt-spec-{name}", run["launches"],
                           layers * len(prompts))
        st = spec_checked(f"serve-gpt-spec-{name}", eng)
        del run["engine"], eng
        ident = identity_rule(f"serve-gpt-spec-{name}", run["reqs"], base,
                              lambda: spec_forced(torch, np, model, prompts,
                                                  base, page_size=PAGE,
                                                  prefix_sharing=False),
                              suffix="_vs_k1")
        launches[name] = {"flash_attention_fwd": flash}
        rows[name] = {"tokens": run["tokens"], "wall_s": run["wall_s"],
                      "tokens_per_s": run["tokens_per_s"],
                      "engine_steps": run["steps"], "flash_launches": flash,
                      "spec_stats": spec_fields(st), **ident}
    emit({"phase": "serve-gpt-spec", "k": SPEC_K, "page_size": PAGE,
          "requests": len(prompts), "tokens_per_s_k1": k1_m["tokens_per_s"],
          "engine_steps_k1": k1_m["steps"],
          "self_draft_new_cut": f"{max(news)} -> {GPT_DRAFT_NEW}",
          **rows, "draft_faults": 0, "leaks": 0})
    return launches


def gpt_serve_chunked(torch, np, model) -> dict:
    """The chunked trace (cp_trace) through the paged engine unchunked
    and at prefill_chunk=64: row 1 exactly layers x monolithic prefills
    and none inside a chunk, the chunked tokens held to the unchunked by
    the identity rule, the max decode stalls."""
    layers = served(model).num_layers
    shorts, longs = cp_trace(np)
    base = cp_drive(torch, model, shorts, longs)
    ck = cp_drive(torch, model, shorts, longs, prefill_chunk=CP_CHUNK)
    flash = {k: cp_checked(f"serve-gpt-chunked {k}", r, layers)
             for k, r in (("unchunked", base), ("chunked", ck))}
    del base["engine"], ck["engine"]
    ident = identity_rule("serve-gpt-chunked", ck["reqs"], base["reqs"],
                          lambda: cp_forced(torch, model, shorts, longs,
                                            base["reqs"],
                                            prefill_chunk=CP_CHUNK))
    emit({"phase": "serve-gpt-chunked", "chunk": CP_CHUNK,
          "page_size": PAGE, "flash_launches": flash,
          "monolithic_prefills": {"unchunked": base["full_prefills"],
                                  "chunked": ck["full_prefills"]},
          "chunk_steps": ck["chunk_steps"],
          "max_decode_stall_s": {"unchunked": max(base["gaps"]),
                                 "chunked": max(ck["gaps"])},
          "tok_latency_p99_s": {
              "unchunked": float(np.percentile(base["gaps"], 99)),
              "chunked": float(np.percentile(ck["gaps"], 99))},
          "chunk_ms_mean": ck["chunk_ms_mean"],
          "prefill_512_ms_unchunked": base["prefill_512_ms"], **ident,
          "leaks": 0})
    return {"flash_attention_fwd": flash["chunked"]}


def gpt_serve_recover(torch, np, model, prompts, base_reqs) -> dict:
    """serve's trace on the paged layout with a decode fault, recover()ed
    (rc_drive: ledger, audits and flight-recorder dumps), held to the
    fault-free paged run by the identity rule."""
    layers = served(model).num_layers
    news = [NEW_TOKENS[i % 4] for i in range(SLOTS)]
    arrivals = {0: list(zip(prompts, news))}
    run = rc_drive(torch, model, arrivals, GPT_RC_FAULTS, page_size=PAGE)
    flash = flash_only("serve-gpt-recover", run["launches"],
                       layers * run["full_prefills"])

    def forced():
        with teacher_forcing([r.output_ids for r in base_reqs]) as tf:
            rc_drive(torch, model, arrivals, GPT_RC_FAULTS, tf=tf,
                     page_size=PAGE)
        return tf.result()
    ident = identity_rule("serve-gpt-recover", run["reqs"], base_reqs, forced)
    emit({"phase": "serve-gpt-recover", "faults": [p for p, _ in
                                                   GPT_RC_FAULTS],
          "reports": run["reports"], "recoveries_total":
          run["recoveries_total"], "flight_recorder_dumps": run["dumps"],
          "monolithic_prefills": run["full_prefills"],
          "flash_launches": flash, "ledger_violations": 0, **ident,
          "leaks": 0})
    return {"flash_attention_fwd": flash}


def gpt_serve_quant(torch, np, model, prompts, precision: str) -> dict:
    """serve's trace through weight_only_int4 / _int8 GPT-1.3B
    (phase_serve_int4: 96 swapped linears, one launch of row 7 or row 8
    each a model call); the 300-token prompt's prefill logits through
    the kernel and through every quantized linear's plain version
    within INT4_ROUTE_TOL (as check-int4 holds Llama's), and the tokens
    of the same engine fed the kernel run's tokens through the plain
    route (the identity rule's agreement and splits) with the last
    logits through both. int8, whose row 8 is bit for bit its plain
    version, must give the same tokens and the same logits; int4's
    tokens are printed (its routes sum in other orders)."""
    from paddle_tpu_torch.serving import ServingEngine
    name = f"serve-gpt-{precision}"
    per_call = served(model).num_layers * GPT_LINEARS_PER_BLOCK
    qmodel, reqs, counts = phase_serve_int4(torch, np, model, prompts,
                                            precision, name, per_call)
    route = int4_plain_route if precision == "int4" else int8_plain_route
    ids = prompts[PROMPT_LENS.index(300)]
    kern = prefill_logits(torch, qmodel, ids, False)
    with route():
        plain = prefill_logits(torch, qmodel, ids, False)
    diff = (kern - plain).abs().max().item()
    if diff > INT4_ROUTE_TOL:
        raise AssertionError(f"{name}: prefill logits, kernel vs plain "
                             f"route: max |diff| {diff} > {INT4_ROUTE_TOL}")
    eng = ServingEngine(qmodel, kv_layout="contiguous", max_slots=SLOTS,
                        max_len=MAX_LEN, min_bucket=MIN_BUCKET)
    agree, gaps = forced_run(torch, reqs, prompts, eng, route)
    row = {"route_logits_max_abs_diff": diff, "route_tol": INT4_ROUTE_TOL,
           "forced_agreement_vs_plain": agree, **split_stats(gaps),
           **route_parity(torch, np, qmodel, route)}
    if precision == "int8":
        if gaps or diff:
            raise AssertionError(f"{name}: {len(gaps)} splits and logits "
                                 f"{diff} apart through row 8's plain "
                                 f"version")
        row["route_logits_equal"] = int8_route_check(torch, np, qmodel)
    emit({"phase": name + "-check", **row})
    del qmodel, eng
    torch.cuda.empty_cache()
    return {k: v for k, v in counts.items() if v}


def gpt_route_check(torch, np, model, prompts) -> dict:
    """The GPT engine's first tokens against the argmax of its own
    bucket-padded prefill (the cache route), and the 300-token prompt's
    prefill logits through row 1 against the plain masked einsum within
    ROUTE_TOL (printed with the gap to it)."""
    ids = prompts[PROMPT_LENS.index(300)]
    kern = prefill_logits(torch, model, ids, per_row=False)
    plain = prefill_logits(torch, model, ids, per_row=True)
    diff = (kern - plain).abs().max().item()
    if diff > ROUTE_TOL:
        raise AssertionError(f"serve-gpt: prefill logits, kernel vs plain "
                             f"route: max |diff| {diff} > {ROUTE_TOL}")
    return {"route_logits_max_abs_diff": diff, "route_tol": ROUTE_TOL,
            "route_argmax_equal": int(kern.argmax()) == int(plain.argmax()),
            "logit_bf16_step": bf16_step(kern)}


def phase_serve_gpt(torch, np) -> dict:
    """GPT-1.3B (random weights from seed 0) on every engine path at
    serve's geometry. In f32: contiguous, held to a full-context greedy
    forward, and the shared-prefix extend held to unshared, both by the
    identity rule. In bf16: contiguous (the same anchor printed), paged
    (the contiguous tokens bit for bit) and paged int8 (int8 KV's gate
    and its split bound), the shared-prefix extend, the speculative
    verify (n-gram and a self-draft), chunked prefill and recover()
    after a decode fault (the identity rule), and weight-only int4 /
    int8; each with its exact launch counts. Returns the launches by
    path."""
    t0 = time.perf_counter()
    launches = {}
    # the anchor in f32 (row 1 in f32 in the prefills and the full
    # forwards): held by the identity rule
    model = gpt_model(torch, "float32")
    prompts, reqs, launches["serve-gpt-f32"], _ = phase_serve(
        torch, np, model, name="serve-gpt-f32")
    emit({"phase": "serve-gpt-f32-check", **full_forward_rule(
        torch, np, "serve-gpt-f32", model, prompts, reqs)})
    launches["serve-gpt-f32-prefix"] = gpt_serve_prefix(
        torch, np, model, "serve-gpt-f32-prefix", hold=True)
    del model, reqs
    torch.cuda.empty_cache()
    model = gpt_model(torch)
    prompts, reqs, launches["serve-gpt"], m = phase_serve(
        torch, np, model, name="serve-gpt")
    emit({"phase": "serve-gpt-check",
          **full_forward_rule(torch, np, "serve-gpt", model, prompts, reqs,
                              gate=False),
          **gpt_route_check(torch, np, model, prompts)})
    decode = decode_profile(torch, model, prompts, kv_layout="contiguous")
    emit({"phase": "serve-gpt-profile", "decode": decode})
    paged = phase_serve_paged(torch, np, model, prompts, reqs, m, decode,
                              prefix="serve-gpt")
    launches["serve-gpt-paged"] = paged[1]
    paged8 = phase_serve_paged(torch, np, model, prompts, reqs, m, decode,
                               kv_dtype="int8", bf16_run=paged,
                               prefix="serve-gpt", gap_steps=INT8_GAP_STEPS)
    launches["serve-gpt-paged-int8"] = paged8[1]
    del paged8
    launches["serve-gpt-prefix"] = gpt_serve_prefix(
        torch, np, model, "serve-gpt-prefix", hold=False)
    for name, counts in gpt_serve_spec(torch, np, model, prompts, paged[0],
                                       paged[3]).items():
        launches["serve-gpt-spec-" + name] = counts
    launches["serve-gpt-chunked"] = gpt_serve_chunked(torch, np, model)
    launches["serve-gpt-recover"] = gpt_serve_recover(torch, np, model,
                                                      prompts, paged[0])
    del paged
    for precision in ("int4", "int8"):
        launches[f"serve-gpt-{precision}"] = gpt_serve_quant(
            torch, np, model, prompts, precision)
    del model
    torch.cuda.empty_cache()
    emit({"phase": "serve-gpt-done", "phase_s": time.perf_counter() - t0})
    return launches


def phase_kernels_int4_gpt(torch) -> list:
    """Row 7 against its plain version at GPT-1.3B's four linears, M in
    GPT_INT4_MS (int4_case: ms beside the bytes bound, the plain version,
    torch._weight_int4pack_mm and the bf16 linear)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = [int4_case(torch, gen, M, K, N, g, what)
            for K, N, g, what in GPT_INT4_SHAPES for M in GPT_INT4_MS]
    emit({"phase": "kernels-int4-gpt", "name": "int4_matmul",
          "library": "torch._weight_int4pack_mm",
          "tolerance": "one bf16 step of the output's largest magnitude",
          "cases": rows})
    return rows


def main() -> int:
    # keep CUPTI set up between traces: torch.profiler's default tears it
    # down after each one, and on the card's machine traces then came
    # back short of kernel records, or with a former trace's, again and
    # again after a burst of launches
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import numpy as np
    import torch.nn.functional as F
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import _build

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sos = _build.build()
    emit({"phase": "build", "kernels": list(_build.KERNELS),
          "seconds": time.perf_counter() - t0})
    ptxas = phase_ptxas(sos)
    sass = dict(phase_sass(torch), ptxas=ptxas)

    fwd_rows = phase_kernels(torch, F)
    bwd_rows = phase_kernels_bwd(torch, F)
    attn_rows, attn_packed = phase_kernels_attn(torch, F)
    launches = {"sdpa-f32": phase_sdpa_f32(torch)}
    adamw_rows, adamw_list = phase_kernels_adamw(torch)
    quant_rows = phase_kernels_quant(torch, sass)
    quant_rows.update(phase_kernels_ln(torch, sass))
    phase_int_mm(torch)
    adamw8_rows, adamw8_list = phase_kernels_adamw8(torch, sass)
    int4_rows = phase_kernels_int4(torch)
    bn_rows = phase_kernels_bn(torch, F)

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlamaForCausalLM(llama_1b_config(), dtype="bfloat16",
                             generator=gen)
    prompts, reqs, serve_launches, served = phase_serve(torch, np, model)
    phase_check(torch, np, model, prompts, reqs)
    contig_decode = phase_profile(torch, model, prompts)
    launches["serve"] = serve_launches
    paged = phase_serve_paged(torch, np, model, prompts, reqs, served,
                              contig_decode)
    launches["serve-paged"] = paged[1]
    paged8 = phase_serve_paged(
        torch, np, model, prompts, reqs, served, contig_decode,
        kv_dtype="int8", bf16_run=paged)
    launches["serve-paged-int8"] = paged8[1]
    for name, counts in phase_serve_prefix(torch, np, model).items():
        launches["serve-prefix-" + name] = counts
    products = verify_products(torch, model)
    for name, counts in phase_serve_spec(
            torch, np, model, prompts,
            {"contiguous": (reqs, served), "paged": (paged[0], paged[3]),
             "paged-int8": (paged8[0], paged8[3])}, products).items():
        launches["serve-spec-" + name] = counts
    launches["serve-spec-ngram"] = phase_serve_spec_ngram(
        torch, np, model, products)
    for name, counts in phase_serve_spec_draft(
            torch, np, model, products).items():
        launches["serve-spec-draft-" + name] = counts
    chunked, chunked_reqs = phase_serve_chunked(torch, np, model)
    for name, counts in chunked.items():
        launches["serve-chunked-" + name] = counts
    for name, counts in phase_serve_recover(
            torch, np, model, prompts,
            {"contiguous": reqs, "paged": paged[0]}, chunked_reqs).items():
        launches["serve-recover-" + name] = counts
    for name, counts in phase_serve_tier(torch, np, model).items():
        launches["serve-tier-" + name] = counts
    for name, counts in phase_serve_watchtower(torch, np, model).items():
        launches["serve-watchtower-" + name] = counts
    launches["chaos-serving"] = phase_chaos_serving(torch, F)
    del paged, paged8
    torch.cuda.empty_cache()
    qmodel, qreqs, launches["serve-int4"] = phase_serve_int4(
        torch, np, model, prompts)
    phase_check_int4(torch, np, model, qmodel, prompts, qreqs)
    del qmodel, qreqs
    launches["decode"] = phase_decode(torch, np, model)
    del model, reqs
    torch.cuda.empty_cache()
    launches.update(phase_serve_gpt(torch, np))
    gpt_int4_rows = phase_kernels_int4_gpt(torch)

    losses = {}
    for path in ("train-flagship", "train-flagship-ln", "train"):
        tr = gpt_trainer(torch, RECIPES[path])
        launches[path], losses[path] = phase_train(
            torch, np, tr, path, track=losses.get("train-flagship")
            if path == "train-flagship-ln" else None)
        phase_train_profile(torch, np, tr, path + "-profile")
        del tr
        torch.cuda.empty_cache()
    phase_train_guard(torch, np)
    for name, recipe in CHECKS.items():
        phase_train_check(torch, np, name, recipe)

    launches["train-resnet50"], step, model, opt, data = \
        phase_train_resnet(torch, np)
    phase_train_resnet_profile(torch, step, opt, data)
    del step, model, opt, data
    torch.cuda.empty_cache()
    phase_infer_resnet(torch, np)
    phase_train_check_resnet(torch, np)

    def entry(kernel, source, replaces, rows, main, path="train-flagship",
              **extra):
        return {"name": kernel, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": launches[path][kernel],
                "launches_from": path,
                "launches_by_path": {p: counts.get(kernel, 0)
                                     for p, counts in launches.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], **extra}

    def largest(rows):
        return max(rows, key=lambda r: (r["shape"][0] * r["shape"][1],
                                        r.get("gelu", False)))
    emit({"phase": "profiler", "empty_traces_taken_again": EMPTY_TRACES,
          "short_traces_taken_again": SHORT_TRACES,
          "timings_by_cuda_events": EVENT_TIMINGS})
    emit({"kernels": [
        entry("flash_attention_fwd", "flash_attention_fwd.cu",
              "paddle_tpu/ops/pallas_ops.py:152,645", fwd_rows,
              next(r for r in fwd_rows if r["packed"])),
        entry("flash_attention_bwd", "flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas_ops.py:277,304,585,612", bwd_rows,
              next(r for r in bwd_rows if r["packed"])),
        # the f32 kernels of the same wrapper: no traced step runs f32,
        # an f32 SDPA backward launches them once; timed at D=128
        entry("flash_attention_bwd_f32", "flash_attention_bwd.cu",
              "paddle_tpu/ops/pallas_ops.py:277,304,585,612",
              [r["bwd"] for r in attn_rows if r["dtype"] == "float32"]
              + [attn_packed["bwd"]],
              next(r["bwd"] for r in attn_rows
                   if r["dtype"] == "float32" and r["D"] == 128),
              "sdpa-f32"),
        # the bf16 step's one launch over its 292 leaves; a flagship
        # step's launch takes its 194 small leaves
        entry("fused_adamw", "fused_adamw.cu",
              "paddle_tpu/ops/fused_adamw.py:281", adamw_rows + [adamw_list],
              adamw_list, "train", ms_by_path={
                  "train": adamw_list["ms"],
                  "train-flagship": adamw_list["flagship_ms"],
                  "train-flagship-ln": adamw_list["flagship_ms"]}),
        entry("quantize_rows", "quantize.cu",
              "paddle_tpu/ops/quant_matmul.py:114", quant_rows[
                  "quantize_rows"], largest(quant_rows["quantize_rows"])),
        # the weights' one-read route; the tied head's [50304, 2048] (ce_int8
        # only) takes the two-pass pair
        entry("quantize_cols", "quantize.cu",
              "paddle_tpu/ops/quant_matmul.py:129", quant_rows[
                  "quantize_cols"], largest(
                      r for r in quant_rows["quantize_cols"]
                      if r["route"] == "one read")),
        entry("ln_quantize_rowwise", "quantize.cu",
              "paddle_tpu/ops/quant_matmul.py:215",
              quant_rows["ln_quantize_rowwise"],
              quant_rows["ln_quantize_rowwise"][0], "train-flagship-ln"),
        entry("sr_quantize_colwise_ln", "quantize.cu",
              "paddle_tpu/ops/quant_matmul.py:296",
              quant_rows["sr_quantize_colwise_ln"],
              quant_rows["sr_quantize_colwise_ln"][0], "train-flagship-ln"),
        entry("sr_quantize_colwise", "quantize.cu",
              "paddle_tpu/ops/quant_matmul.py:447",
              quant_rows["sr_quantize_colwise"],
              largest(quant_rows["sr_quantize_colwise"])),
        # a flagship step's one launch over its 98 int8-moment leaves
        entry("fused_adamw8", "fused_adamw8.cu",
              "paddle_tpu/ops/fused_adamw.py:222",
              adamw8_rows + [adamw8_list], adamw8_list),
        # with GPT-1.3B's four linears beside Llama-1B's (gpt_cases)
        entry("int4_matmul", "int4_matmul.cu",
              "paddle_tpu/ops/int4_matmul.py:118", int4_rows + gpt_int4_rows,
              next(r for r in int4_rows if r["M"] == SLOTS
                   and r["N"] == 32000), "serve-int4", gpt_cases=[
                  {k: r[k] for k in ("M", "K", "N", "linear", "max_abs_err",
                                     "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
                  for r in gpt_int4_rows]),
        *(entry(k, "batch_norm.cu", f"paddle_tpu/ops/bn_pallas.py:{line}",
                bn_rows[k], bn_rows[k][0], "train-resnet50")
          for k, line in zip(BN_KERNELS, (117, 136, 149, 162)))]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
