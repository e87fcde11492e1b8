"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  0. [reprolint] the port's static analysis, `python -m
     repro_torch.analysis --strict`, in a subprocess on this host's
     Python (no card, no torch): its summary line and any stale entry of
     `reprolint-torch-baseline.json` printed, a non-zero exit a failure;
  1. build every kernel of the port from its source, one `nvcc` per
     source, all started together: the checksum kernels (K1 tile digests,
     K2 whole-leaf digest, K3 dirty-tile gather) from
     `src/repro_torch/kernels/checksum/csrc`, the flash-attention kernel
     F1 from `src/repro_torch/kernels/flash_attention/csrc` and the
     selective-scan kernel S1 from `src/repro_torch/kernels/mamba_scan/csrc`;
     then read the SASS (`cuobjdump -sass`): F1's bf16 kernel must run on
     the tensor cores (HGMMA, or HMMA), and every S1 kernel must hold its
     exps (MUFU.EX2) and the shuffles that sum y over a channel's lanes
     (SHFL.BFLY); print S1's registers a thread, resident warps an SM
     and SASS instructions a state and step;
  2. hold each checksum kernel bit for bit against its plain PyTorch
     version at the main path's shapes (the paper-demo embedding table
     (32768, 768) fp32, a bf16 leaf, an odd-length leaf, a bool leaf, the
     runtime worker's float64 x at dim 4096, a 5 %-dirty tile set), and
     time kernel, plain version and, for K3,
     `torch.index_select`: event time, host issue time and the profiler's
     device time (a kernel faster than its wrapper's host cost is clocked
     by the host in event time, not by the card);
  3. [flash] hold F1 against its plain version at the prefill shapes of
     the serving paths (qwen2-7b at S 512, 384 and the odd 77; paper-demo
     at S 4 and 6; zamba2-7b's shared block at S 512, 384 and 77, head
     dim 112; olmoe-1b-7b at S 512, 384 and 77, 16 heads = 16 KV heads of
     128; seamless-m4t-medium's encoder at S_enc 1024, its decoder's
     self-attention at S 512 and 77 and its cross-attention of S 512 and
     77 queries over the 1024 encoder rows, 16 heads of 64;
     llava-next-34b at S 3072, GQA 56/8 of 128) and at two extra cases (a
     query suffix Sq < Sk, and paper-demo at S 512) in bf16 (the
     tensor-core kernel) and fp32 (the FMA kernel), each shape with the
     mask its path gives it (`FLASH_MASKS`: the encoder and the
     cross-attention non-causal, the rest causal, qwen2-7b's S 512 both),
     bf16 to min(2e-2, 2e-2 x max|want|) in all and, row by row (one
     query of one head), to 2e-2 of the row's own max|want|
     (`max_row_rel_err`), so that rows spread over many keys (1024
     non-causal keys, the late rows of a causal S 3072), whose outputs are
     far below 1, are each held in their own scale; fp32 to 2e-5; each
     bound printed beside its reading; check that a row's bits do not
     depend on the batch and that the model layout, read by strides,
     gives the flattened layout's bits; time F1, its plain version and
     `scaled_dot_product_attention` (event, host issue and device time)
     with the shape's mask, at qwen2-7b's, zamba2-7b's and olmoe-1b-7b's
     S 512, seamless-m4t-medium's encoder and S 512 cross-attention and
     llava-next-34b's S 3072 among others;
  3b. [scan] hold S1 (y and h_final) against its plain version to 1e-4
     at the prefill shapes of the falcon-mamba-7b serving path (B 4,
     S 512, 384 and 77, d_inner 8192, ds 16), at odd shapes (S 1, S 3,
     S 130, a d_inner no block divides) and at the reference's test
     shapes; check that a lane's bits do not depend on the batch and that
     two launches agree; time S1, its plain version and the port's
     chunked torch scan (a yardstick: no single PyTorch call computes a
     selective scan), beside two bounds: the bytes at 3.35 TB/s (the
     kernels line's `bound_ms`) and the exps at the SFU's rate
     (`exp_bound_ms`: 16 MUFU.EX2 a clock per SM at the SM clock that
     `nvidia-smi --query-gpu=clocks.max.sm` reads), and the issue floor
     of S1's code (its SASS instructions a state and step, one warp
     instruction a clock per scheduler); S1's device time is printed as a
     ratio of each;
  4. the training path at full width: `repro_torch.launch.train --arch
     paper-demo` (batch 8, seq 256) twice with a fault and twice without —
     full saves + a process fault under reinit, and delta saves
     (--ckpt-delta-every 4) + a node fault under cr, which reloads from
     files — each faulted run's final state bit-identical to its twin's;
     after the reinit twin, `models.layers.chunked_unembed_xent` on the
     card with its trained embedding table (32768, 768) float32, on
     seeded hidden states (8, 256, 768) and labels drawn from a
     torch.Generator, held within 1e-5 relative to `cross_entropy` of
     the full logits and to the trainer's `masked_chunked_xent`;
  4b. [train] the trainer's elastic and gray paths at the same width,
     through the API: the shrink strategy with no spare and a node fault
     (full saves, K2), and a slow rank drained by mitigation — each
     bit-identical to its fault-free twin;
  4c. [sharded-train] phase 4's reinit run through the API, once without
     a mesh and twice under a device mesh: a world-1 NCCL group, a (1,)
     `data` mesh and ShardingRules(batch="data", embed="data"), so the
     state is DTensors placed by the rules, each step runs in a constraint
     scope and the file tier gathers each leaf before K2 digests it;
     fault-free and with the same process failure, all three ending on
     the unsharded reinit run's digests bit for bit, each run's median
     step time printed (one card holds one NCCL rank: the multi-rank ring
     of shards is tested on the CPU, tests/test_torch_sharding.py);
  4d. [train-families] the trainer through the API on the moe, ssm,
     hybrid and vlm families at batch 8 x seq 256, bf16 compute, float32
     parameters and AdamW moments, full saves (K2): olmoe-1b-7b (2 of 16
     layers) under reinit with a process fault (the buddy memory
     restore), falcon-mamba-7b (2 of 64) under cr with a node fault (the
     reload from files), zamba2-7b (7 of 81: one group of 6 Mamba2 layers
     with its shared attention block, and one tail layer) under reinit
     with a process fault, all three at published width, vocabulary and
     heads; llava-next-34b reduced (one layer at published width is 17.7
     GB of state, and a save holds five copies) under reinit with a
     process fault, through the trainer's zero gradient for its unreached
     `frontend_proj` (ROADMAP C12). 5 steps, one save (step 3), the fault
     at the top of step 4: each fault run rolls back to step 3 and ends
     on its fault-free twin's final state bit for bit. Each run prints its
     parameters and state bytes, the disk free before it (a run the disk
     cannot hold fails), `max_memory_allocated`, its median step, each
     save's seconds and each recovery's phases;
  4e. [train-strategies] phase 4's paper-demo run (the same fault draw)
     through the API under ulfm and replica, each with a process and a
     node fault: each resumes at the fail step (replica by promoting its
     warm shadow) and ends on phase 4's reinit twin's final state bit for
     bit (fault-free training does not depend on the strategy); the same
     readings per run;
  5. a sparse-dirt checkpoint: FileCheckpointer(delta_every=4) on the
     full paper-demo train state with a 5 % window of every leaf changed
     between saves, so the delta save gathers dirty tiles on the card;
  5b. [runtime] the real-process runtime of `repro_torch.runtime` on the
     card at the root's default deployment (2 nodes x 4 ranks + 1 spare
     node, 20 steps, dim 4096: each worker holds w = 0.999·I, 128 MiB of
     float64, and x on the card, and digests every step's frame with K1):
     fault-free, reinit and cr under a process and a node failure, and
     the `shrink-then-growback` and `replica-promote` catalog cells at
     dim 4096, all through `run_real`. Each fault run must give the
     oracle's resume steps and its fault-free twin's per-rank checksums
     bit for bit, and K1 must have launched in every worker (the counts
     come back in each worker's DONE message). Prints each run's
     `mpi_recovery_s` and `total_s`, the reinit/cr ratios, a re-spawned
     worker's start-up (import, CUDA context, w, kernel library, warm
     step) and the
     card's memory in use (`nvidia-smi --query-gpu=memory.used`) before
     and at its peak during the runs;
  6. [serve] the serving path at the full published width and depth of
     qwen2-7b: `repro_torch.launch.serve` with `--attn-impl pallas` (F1
     must launch once per layer and prefill); then, through the API, the
     same requests served once straight through and once with a
     snapshot/restore in the middle (bit-identical transcripts and state),
     a profiled decode step and prefill call (host and device time, the
     top kernels), and prefill logits of `pallas` against `chunked`;
  6b. [sharded-serve] the same model, parameters and requests through
     the sharded engine: a world-1 NCCL group, a (1, 1) (data, model)
     mesh and the pod_serve rules, so the parameters and the KV cache are
     DTensors (the cache's placements printed) and F1 runs through
     `sharding.partition.local_call` on each rank's lanes and heads. The
     transcripts must be phase 6's token for token, straight and through
     a snapshot/restore, with F1 launched once per layer and prefill
     call (84); prints TTFT, decode tokens/s and a decode step's host and
     device time beside the unsharded engine's at the same point;
  7. [serve-cluster] the `fast` cells of the serving catalog under both
     reinit and replica at paper-demo full width, each lossless against
     its fault-free run;
  8. [serve-ssm] the serving path at the full published width and depth
     of falcon-mamba-7b (Mamba1, 64 layers, 29.1 GB of float32 parameters
     drawn on the card once qwen2-7b's are freed): the serve CLI with
     `--attn-impl pallas` and the qwen2-7b phase's requests (S1 must
     launch exactly 64 layers x 3 prefill calls = 192 times); through the
     API a straight run, a profiled decode step, a mid-run snapshot/restore
     (bit-identical transcripts and {h, conv} state), and prefill logits of
     `pallas` against `chunked` in float32 compute within 1e-3 of the
     largest logit (`held_to_chunked` and `LOGIT_TOL_F32`, one check for
     every family held in float32, 8 to 8e), with each prefill call's wall
     time;
  8b. [serve-hybrid] the same at the full published width and depth of
     zamba2-7b (the hybrid family: 81 Mamba2 layers in 13 groups of 6,
     each group followed by one weight-shared attention block of head
     dim 112, and a tail of 3; 6,636,442,832 float32 parameters, drawn
     once falcon-mamba-7b's are freed): F1 must launch exactly 13 groups x
     3 prefill calls = 39 times on the serve CLI's run; the Mamba2 layers
     run the chunked SSD (torch ops, no kernel of the port); the mid-run
     snapshot/restore must give every leaf of the nested state bit for
     bit, and `pallas` is held to `chunked` in float32 compute, the served
     bf16 difference printed beside it;
  8c. [serve-moe] the same at the full published width and depth of
     olmoe-1b-7b (the moe family: 16 layers of MHA attention, 16 heads of
     128, and 64 experts of d_ff 1024, top-8, routed in groups of 256
     tokens with capacity factor 1.25; 6,816,073,728 float32 parameters,
     drawn once zamba2-7b's are freed): F1 must launch exactly 16 layers x
     3 prefill calls = 48 times on the serve CLI's run; the experts are
     torch products (the reference computes them outside Pallas); prints,
     for each prefill call as the engine makes it, the expert assignments
     capacity dropped and the tokens whose 8th and 9th router
     probabilities tie; one prefill call made twice must give the same
     logits and KV bit for bit; `pallas` is held to `chunked` in float32
     compute, the served bf16 difference printed beside it;
  8d. [serve-encdec] seamless-m4t-medium at its full published width and
     depth (12 encoder and 12 decoder layers, 16 heads of 64, vocab
     256,206, enc_seq_len 1024; drawn once olmoe-1b-7b's parameters are
     freed): the serve CLI must refuse it with the named error of ROADMAP
     C8 (the engine prefills from tokens alone); then through the API,
     `Model.prefill` with a seeded bf16 `enc_emb` (4, 1024, 1024) and 32
     greedy `decode_step`s, for the prompt groups S 512 x 4 and S 77 x 4:
     F1 must launch exactly (12 encoder + 12 self + 12 cross) x 2 = 72
     times on that run (decode runs no kernel); prints TTFT and decode
     tokens/s; one prefill call made twice must give the same logits and
     all four state leaves (k, v, cross_k, cross_v) bit for bit; `pallas`
     is held to `chunked` in float32 compute, bf16 printed beside it; a
     profiled prefill call and decode step;
  8e. [serve-vlm] llava-next-34b at its published width (d_model 7168,
     GQA 56/8 of 128, d_ff 20480, vocab 64,000, 2880 frontend rows) with
     its depth cut to 16 of 60 layers (37.7 GB of float32 parameters; 60
     would not fit): two prefill calls of S 3072 x 2 (2880 rows of a
     seeded bf16 `frontend_emb`, A then B, and 192 text tokens), each
     followed by 32 decode steps: F1 must launch exactly 16 x 2 = 32 times
     on that run; the frontend must change the logits; a repeated prefill
     must give the same logits and KV caches bit for bit; `pallas` is held
     to `chunked` in float32 compute; TTFT, decode tokens/s and the
     profiles as in 8d (both phases run one skeleton, `phase_serve_api`);
  8f. [dryrun] the dry run (`repro_torch.launch.dryrun`) on this host's
     torch: qwen2-7b x decode_32k and seamless-m4t-medium x train_4k (4
     microbatches, the buddy ring fused) traced on fake tensors under a
     fake world of 256 (16x16 `pod`), each printed (trace seconds, one
     device's memory, collectives and FLOPs, the analytic FLOPs) and
     failing on zero collective bytes, argument bytes or analytic FLOPs;
     then qwen2-7b's prefill S 512 x 4 in bf16 with F1, traced at world
     1 and run on the card under FlopCounterMode: equal FLOPs (F1 by its
     formula in both), F1 once a layer, traced argument bytes equal to
     the parameters' and tokens', the traced peak printed beside the
     real call's; then every earlier path's launches, every serving
     path's transcripts (`transcript_digest`) and the encdec and vlm
     first tokens as pinned on an H100 before F1 and S1 became torch
     operators, and F1's and S1's host issue time through the operators
     beside their wrappers';
  9. the kernel report. Launches are counted per path: the counts are
     set to 0 just before each path is driven and read just after it.
     K2 must launch on the full-save runs (the shrink, gray and sharded
     runs, every [train-families] and [train-strategies] run included),
     K1 on the delta-cadence runs and in every runtime run,
     K3 (which training never reaches: AdamW dirties every tile) on the
     sparse-dirt saves, F1 on both dense serving paths and the sharded
     one, the zamba2-7b,
     olmoe-1b-7b, seamless-m4t-medium and llava-next-34b ones and
     [dryrun]'s real prefill, and S1 on the falcon-mamba-7b one; every
     shape, dtype and mask F1 was given must be one that phase 3 checked, and every shape S1 was given one
     that phase 3b checked. F1's entry on the kernels line carries, beside
     its main row, the rows of head dim 112, MHA head dim 128, the hd-64
     non-causal encoder and cross shapes and llava-next-34b's S 3072, and
     `launches_by_path` gives each path's launches, `sharded-train` and
     `sharded-serve` included.

A `[time]` line gives each phase's seconds, and the script's in all.
The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}. Without a CUDA card, or without the
repository around it, the script fails before printing any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK = os.path.join(HERE, "build", "chip_smoke")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
INT32_OPS_PER_S = 67e12       # the guide's non-tensor 32-bit rate (fp32)
EX2_PER_CLOCK_PER_SM = 16     # sm_90's SFU: MUFU.EX2 lanes a clock per SM
FLOPS_PER_S = {"bfloat16": 989e12,   # dense bf16 tensor-core peak
               "float32": 67e12}     # fp32 outside the tensor cores
STEPS = 6

# F1's shapes, (B, Sq, Sk, H, Hkv, hd). First the prefills of the driven
# serving paths (every prefill group is lane-padded to B 4): the serve
# CLI's qwen2-7b and zamba2-7b groups and the serving cells' paper-demo
# prompts (the load generator's lengths 4 and 6). Every shape F1 is given
# on those paths must be among them (checked after the paths ran). Then
# extra cases that no driven path gives F1.
FLASH_SHAPES = {
    "qwen2-7b prefill S 512": (4, 512, 512, 28, 4, 128),
    "qwen2-7b prefill S 384": (4, 384, 384, 28, 4, 128),
    "qwen2-7b prefill odd S 77": (4, 77, 77, 28, 4, 128),
    "paper-demo prefill S 4": (4, 4, 4, 12, 12, 64),
    "paper-demo prefill S 6": (4, 6, 6, 12, 12, 64),
    "zamba2-7b prefill S 512": (4, 512, 512, 32, 32, 112),
    "zamba2-7b prefill S 384": (4, 384, 384, 32, 32, 112),
    "zamba2-7b prefill odd S 77": (4, 77, 77, 32, 32, 112),
    "olmoe-1b-7b prefill S 512": (4, 512, 512, 16, 16, 128),
    "olmoe-1b-7b prefill S 384": (4, 384, 384, 16, 16, 128),
    "olmoe-1b-7b prefill odd S 77": (4, 77, 77, 16, 16, 128),
    "seamless-m4t-medium encoder S_enc 1024": (4, 1024, 1024, 16, 16, 64),
    "seamless-m4t-medium prefill S 512": (4, 512, 512, 16, 16, 64),
    "seamless-m4t-medium prefill odd S 77": (4, 77, 77, 16, 16, 64),
    "seamless-m4t-medium cross S 512": (4, 512, 1024, 16, 16, 64),
    "seamless-m4t-medium cross odd S 77": (4, 77, 1024, 16, 16, 64),
    "llava-next-34b prefill S 3072": (2, 3072, 3072, 56, 8, 128),
    "extra: qwen2-7b suffix Sq<Sk": (4, 128, 640, 28, 4, 128),
    "extra: paper-demo S 512": (4, 512, 512, 12, 12, 64),
}
# the masks each shape is checked with (causal unless named here): the
# main shape both ways, and the encdec path's bidirectional encoder and
# its cross-attention (queries against all 1024 encoder rows) non-causal,
# as that path gives them to F1
FLASH_MASKS = {
    "qwen2-7b prefill S 512": (True, False),
    "seamless-m4t-medium encoder S_enc 1024": (False,),
    "seamless-m4t-medium cross S 512": (False,),
    "seamless-m4t-medium cross odd S 77": (False,),
}
# the shape that stands for F1 on the kernels line, and F1 at head dim 112
# (zamba2-7b's shared block) and at MHA with head dim 128 (olmoe-1b-7b),
# timed beside it
FLASH_MAIN = "qwen2-7b prefill S 512"
FLASH_HD112 = "zamba2-7b prefill S 512"
FLASH_MHA = "olmoe-1b-7b prefill S 512"
# and F1 at head dim 64 non-causal (seamless-m4t-medium's encoder and its
# cross-attention at S 512) and at llava-next-34b's GQA 56/8 at S 3072
FLASH_ENC = "seamless-m4t-medium encoder S_enc 1024"
FLASH_CROSS = "seamless-m4t-medium cross S 512"
FLASH_VLM = "llava-next-34b prefill S 3072"
# rows of the kernels line beside F1's main one: key -> shape name
FLASH_SIDE_ROWS = {"hd112": FLASH_HD112, "mha_hd128": FLASH_MHA,
                   "hd64_encoder": FLASH_ENC, "hd64_cross": FLASH_CROSS,
                   "vlm_gqa_s3072": FLASH_VLM}
# F1 against its plain version: fp32 within 2e-5, bf16 within
# min(2e-2, 2e-2 x max|want|) (`flash_tol`) and each output row within
# FLASH_ROW_TOL of that row's largest magnitude (`max_row_rel_err`). A
# softmax spread over many keys (a non-causal row of 1024 keys, the late
# rows of a causal S 3072) gives outputs far below 1, and one bound on
# the whole output would there be a large share of a typical value; a
# bf16 rounding is 2^-8 of its value, so one ulp of a row's largest
# element reads at most 2^-7 of it
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
FLASH_ROW_TOL = 2e-2


def flash_tol(dname: str, top: float) -> float:
    """F1's bound in `dname` for an output whose largest magnitude is
    `top`: bf16's scales with the output below 1, fp32's is absolute."""
    if dname == "bfloat16":
        return min(FLASH_TOL[dname], FLASH_TOL[dname] * top)
    return FLASH_TOL[dname]
# the serve CLI's request set: two prefill groups (512, 384) and a 77
SERVE_PROMPTS = (512, 512, 512, 512, 384, 384, 384, 77)
SERVE_FLAGS = ["--arch", "qwen2-7b", "--attn-impl", "pallas", "--slots",
               "4", "--max-len", "1024", "--max-new", "32", "--requests",
               str(len(SERVE_PROMPTS)), "--prompt-len",
               ",".join(map(str, SERVE_PROMPTS))]
# pallas vs chunked prefill logits of bf16 qwen2-7b: within this share of
# the largest logit (28 layers of bf16 activations, rounded at points
# that differ once the attention sums differ in order)
LOGIT_TOL = 5e-2
# S1's shapes, (b, S, di, ds), all float32 as the prefill passes them.
# First the prefills of the falcon-mamba-7b serving path (lane-padded to
# B 4); every shape S1 is given on that path must be among them (checked
# after the path ran). Then odd shapes and the reference's test shapes
# (`tests/test_kernels.py`).
SCAN_SHAPES = {
    "falcon-mamba-7b prefill S 512": (4, 512, 8192, 16),
    "falcon-mamba-7b prefill S 384": (4, 384, 8192, 16),
    "falcon-mamba-7b prefill odd S 77": (4, 77, 8192, 16),
    "odd: S 1": (2, 1, 8192, 16),
    "odd: S 3": (1, 3, 8192, 16),
    "odd: S 130, di 1000": (2, 130, 1000, 16),
    "reference test (2, 64, 32, 8)": (2, 64, 32, 8),
    "reference test (1, 256, 128, 16)": (1, 256, 128, 16),
    "reference test (2, 128, 64, 16)": (2, 128, 64, 16),
    "reference test (1, 128, 256, 32)": (1, 128, 256, 32),
}
# the shape that stands for S1 on the kernels line
SCAN_MAIN = "falcon-mamba-7b prefill S 512"
SCAN_TOL = 1e-4            # the reference's own for A5, atol and rtol
SCAN_CHUNK = 128           # falcon-mamba-7b's ssm_chunk
SSM_FLAGS = ["--arch", "falcon-mamba-7b", *SERVE_FLAGS[2:]]
# pallas vs chunked prefill logits in float32 compute, where only the
# kernels' order of summation differs (S1 against the chunked scan,
# F1's FMA kernel against the chunked torch attention): within this share
# of the largest logit, for every family held in float32 (`held_to_chunked`:
# falcon-mamba-7b's 64 layers, zamba2-7b's 13 shared-block attentions,
# olmoe-1b-7b's 16 attentions, seamless-m4t-medium and llava-next-34b). A
# random deep stack in bf16 amplifies that order far past any tight bound
# (for Mamba1 so does the chunked route against itself at another chunk
# length, printed beside it), and a bf16 MoE router sends a token to
# another expert at a near tie once an attention sum differs; a float32
# stack amplifies an fp32 rounding far less. The served (bf16) difference
# is printed beside it, with no bound
LOGIT_TOL_F32 = 1e-3
# the random models' embedding table is drawn at scale 1.0 and tied to the
# unembedding, so greedy decode repeats the last prompt token whatever the
# attention computes; the API checks scale it so transcripts depend on it
TABLE_SCALE = 0.05


T_START = time.monotonic()


@contextlib.contextmanager
def phase_time(name: str):
    """Print the seconds the block took, as `[time] name: N s`."""
    t0 = time.monotonic()
    yield
    print(f"[time] {name}: {time.monotonic() - t0:.1f} s")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


#: each serving path's transcripts, as `transcript_digest`s, and the
#: first tokens of the model-API paths, filled as the paths run
TRANSCRIPTS: dict = {}
FIRST_TOKENS: dict = {}


def transcript_digest(obj) -> str:
    """A short digest of a path's transcripts (a JSON-able tree of token
    ids)."""
    import hashlib
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str)
                          .encode()).hexdigest()[:16]


def timed(fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """Mean milliseconds per call of back-to-back calls: on the card, by
    CUDA events, and on the host, to issue them. Where the two are close
    the host's per-call cost, not the kernel, sets the event time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


# (label, row, key, fn): device times to take once every event and host
# time is taken, so that no profiler session precedes a host-clock reading
DEVICE_JOBS: list = []


def device_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, list]:
    """Mean device milliseconds per call from a `torch.profiler` trace of
    `iters` back-to-back calls: the summed self time of every kernel and
    copy the calls ran on the card, without the gaps in which the card
    waited for the host. Returns it with the names of those kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a session now and then records no kernel at all (on the H100, for
    # K3's 3.5 us launches): take another, up to three in all
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            return total / 1e3 / iters, sorted(e.key for e in events)
        print(f"[device] profiler session {attempt + 1} of 3 recorded no "
              "device time")
    fail("the profiler saw no device time")


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels.checksum import ops
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    ops.reset_launches()
    fa.reset_launches()
    ms.reset_launches()


def launch_counts() -> dict:
    """{kernel name: launches since the last reset} of every kernel."""
    from repro_torch.kernels.checksum import ops
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    return {**ops.LAUNCHES, **fa.LAUNCHES, **ms.LAUNCHES}


@contextlib.contextmanager
def recording(module, name: str, case, seen: set):
    """While the block runs, add `case(*args)` of every call of the
    kernel wrapper `module.name` to `seen`."""
    inner = getattr(module, name)

    def record(*args, **kw):
        seen.add(case(*args, **kw))
        return inner(*args, **kw)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, inner)


def recording_flash_shapes(seen: set):
    """((B, Sq, Sk, H, Hkv, hd), dtype, causal) of every F1 launch in the
    model layout."""
    from repro_torch.kernels.flash_attention import ops as fa
    return recording(fa, "flash_attention_kernel", lambda q, k, v, *, causal: (
        (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
         q.shape[3]), str(q.dtype).removeprefix("torch."), causal), seen)


def recording_scan_shapes(seen: set):
    """((b, S, di, ds), dtype) of every S1 launch."""
    from repro_torch.kernels.mamba_scan import ops as ms
    return recording(ms, "selective_scan_kernel", lambda x, dt, B, C, A: (
        tuple(x.shape) + (B.shape[-1],), str(x.dtype).removeprefix("torch.")),
        seen)


def max_abs_err(a, b) -> int:
    """Largest difference of two int32 tensors read as uint32 values."""
    m = 0xFFFFFFFF
    d = (a.to("cpu").long() & m) - (b.to("cpu").long() & m)
    return int(d.abs().max()) if d.numel() else 0


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, ops):
    """Phase 2: every kernel against its plain version; timings."""
    from repro_torch.kernels.checksum.ref import TILE_WORDS, n_tiles
    g = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((32768, 768), generator=g, device="cuda")
    leaves = {
        "embedding table (32768, 768) float32": table,
        "bf16 leaf (8, 768, 3072)": torch.randn(
            (8, 768, 3072), generator=g, device="cuda").to(torch.bfloat16),
        "odd-length float16 (769769,)": torch.randn(
            769769, generator=g, device="cuda").to(torch.float16),
        "bool (4096003,)": torch.rand(4096003, generator=g,
                                      device="cuda") > 0.5,
        # a runtime worker's frame: x, float64 (dim,), 8 tiles at dim 4096
        f"runtime worker's x ({RT_DIM},) float64": torch.randn(
            RT_DIM, generator=g, dtype=torch.float64, device="cuda"),
    }
    for name, x in leaves.items():
        b = ops.byte_stream(x)
        nt = n_tiles(b.numel())
        errs = [
            max_abs_err(ops.tile_checksums_kernel(b),
                        ops.tile_checksums_plain(b)),
            max_abs_err(ops.checksum_words_kernel(b),
                        ops.checksum_words_plain(b)),
        ]
        idx = torch.arange(0, nt, 7, dtype=torch.int32, device="cuda")
        errs.append(max_abs_err(ops.gather_tiles_kernel(b, idx),
                                ops.gather_tiles_plain(b, idx)))
        torch.cuda.synchronize()
        print(f"[kernels] {name}: max_abs_err K1 {errs[0]} K2 {errs[1]} "
              f"K3 {errs[2]}")
        if any(errs):
            fail(f"kernel disagrees with its plain version on {name}")

    # timings at the main path's largest leaf, the embedding table
    b = ops.byte_stream(table)
    n_words = b.numel() // 4
    nt = n_tiles(b.numel())
    perm = torch.randperm(nt, generator=g, device="cuda")
    idx = perm[:nt // 20].sort().values.to(torch.int32)      # 5 % dirty
    tiles2d = b.view(torch.int32).reshape(nt, TILE_WORDS)
    idx_long = idx.long()
    k = idx.numel()
    rows = {}
    for name, kern, plain, nbytes, n_ops, lib in (
            ("tile_checksums", lambda: ops.tile_checksums_kernel(b),
             lambda: ops.tile_checksums_plain(b),
             4 * n_words + 12 * nt, 9 * n_words, None),
            ("checksum_words", lambda: ops.checksum_words_kernel(b),
             lambda: ops.checksum_words_plain(b),
             4 * n_words + 8, 6 * n_words, None),
            ("gather_tiles", lambda: ops.gather_tiles_kernel(b, idx),
             lambda: ops.gather_tiles_plain(b, idx),
             2 * k * 4 * TILE_WORDS + 4 * k, 0,
             lambda: torch.index_select(tiles2d, 0, idx_long))):
        err = max_abs_err(kern(), plain())
        if err:
            fail(f"{name} disagrees with its plain version")
        ms, host_ms = timed(kern)
        plain_ms = timed(plain, iters=5, warmup=1)[0]
        lib_ms = timed(lib)[0] if lib is not None else None
        bms, by = bound_ms(nbytes, n_ops)
        rows[name] = {"max_abs_err": err, "ms": ms, "host_ms": host_ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": lib_ms}
        DEVICE_JOBS.append((name, rows[name], "device_ms", kern))
        if lib is not None:
            DEVICE_JOBS.append((f"{name}: index_select", rows[name],
                                "library_device_ms", lib))
        print(f"[kernels] {name} at {tuple(table.shape)} float32"
              + (f", {k} of {nt} tiles" if name == "gather_tiles" else "")
              + f": {ms:.4f} ms event, host issue {host_ms:.4f} ms/call; "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms by {by}"
              + (f"; index_select {lib_ms:.4f} ms event" if lib is not None
                 else ""))
    return rows


def attention_work(B, Sq, Sk, H, Hkv, hd, causal, itemsize):
    """(FLOPs, bytes) of one attention forward on these inputs: 4*hd
    FLOPs per unmasked (query, key) pair; q, k, v read once, o written
    once."""
    if causal:    # query i sits at key position i + Sk - Sq
        pairs = sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return (4 * B * H * hd * pairs,
            itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd))


def flash_bound_ms(flops: int, nbytes: int, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_calls(torch, fa, q, k, v, H, causal):
    """Calls bound to these inputs: F1 on the model layout, F1 alone on
    the flattened layout it also takes, (B*H, S, hd), and SDPA."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    qf, kf, vf = (t.reshape(-1, *t.shape[2:]).contiguous()
                  for t in (qt, kt, vt))
    return (lambda: fa.flash_attention_kernel(q, k, v, causal=causal),
            lambda: fa.flash_attention_bhsd_kernel(qf, kf, vf, causal=causal,
                                                   n_q_heads=H),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))


def phase_flash(torch) -> tuple[dict, set]:
    """Phase 3: F1 against its plain version; lane independence; times.
    Returns F1's row of the kernels line and the (shape, dtype, causal)
    cases checked."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         max_row_rel_err)
    g = torch.Generator(device="cuda").manual_seed(2)

    def inputs(shape, dtype):
        B, Sq, Sk, H, Hkv, hd = shape
        return [torch.randn(s, generator=g, device="cuda").to(dtype)
                for s in ((B, Sq, H, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]

    errs = {}
    for name, shape in FLASH_SHAPES.items():
        for dname in ("bfloat16", "float32"):
            q, k, v = inputs(shape, getattr(torch, dname))
            for causal in FLASH_MASKS.get(name, (True,)):
                got = fa.flash_attention_kernel(q, k, v, causal=causal)
                want = flash_attention_ref(q, k, v, causal=causal)
                err = float((got.float() - want.float()).abs().max())
                finite = bool(torch.isfinite(got).all())
                errs[(name, dname, causal)] = err
                top = float(want.float().abs().max())
                tol = flash_tol(dname, top)
                row = max_row_rel_err(got, want)
                row_ok = dname != "bfloat16" or row <= FLASH_ROW_TOL
                row_tol = FLASH_ROW_TOL if dname == "bfloat16" else "none"
                print(f"[flash] {name} {shape} {dname} "
                      f"{'causal' if causal else 'non-causal'}: "
                      f"max_abs_err {err:.3g} (tol {tol:.3g}; max|want| "
                      f"{top:.3g}); per-row err/max|want| {row:.3g} (tol "
                      f"{row_tol})")
                if not finite or err > tol or not row_ok:
                    fail(f"F1 disagrees with its plain version: {name} "
                         f"{dname} causal={causal}")

    for name in (FLASH_MAIN, FLASH_HD112, FLASH_MHA):
        q, k, v = inputs(FLASH_SHAPES[name], torch.bfloat16)
        whole = fa.flash_attention_kernel(q, k, v, causal=True)
        for b in range(q.shape[0]):
            alone = fa.flash_attention_kernel(q[b:b + 1], k[b:b + 1],
                                              v[b:b + 1], causal=True)
            if not torch.equal(whole[b:b + 1], alone):
                fail(f"F1 lane {b} of {name} differs from the same row "
                     "launched alone")
        print(f"[flash] lane independence: each lane of the B=4 {name} "
              "bf16 launch is bitwise equal to that row launched alone")
    shape = FLASH_SHAPES[FLASH_MAIN]
    for dname in ("bfloat16", "float32"):
        q, k, v = inputs(shape, getattr(torch, dname))
        for causal in (True, False):
            model = fa.flash_attention_kernel(q, k, v, causal=causal)
            flat = fa.flash_attention_bhsd_kernel(
                *(t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
                  for t in (q, k, v)), causal=causal, n_q_heads=shape[3])
            if not torch.equal(model, flat.view(
                    shape[0], shape[3], shape[1], -1).transpose(1, 2)):
                fail(f"F1's model-layout route differs from its flattened "
                     f"route ({dname}, causal={causal})")
    print("[flash] the model layout read by strides gives the flattened "
          "layout's bits (qwen2-7b S 512, bf16 and fp32, causal and not)")

    rows = {}
    for name in (FLASH_MAIN, *FLASH_SIDE_ROWS.values(),
                 "paper-demo prefill S 6", "extra: paper-demo S 512"):
        shape = FLASH_SHAPES[name]
        causal = FLASH_MASKS.get(name, (True,))[0]
        q, k, v = inputs(shape, torch.bfloat16)
        kern, bhsd, sdpa = flash_calls(torch, fa, q, k, v, shape[3], causal)
        ms, host_ms = timed(kern)
        flat_ms, flat_host_ms = timed(bhsd)
        plain_ms = timed(lambda: flash_attention_ref(q, k, v, causal=causal),
                         iters=5, warmup=1)[0]
        # a yardstick only, never called by the port; where causal, Sq ==
        # Sk, and its top-left causal alignment agrees with the reference's
        lib_ms = nondeterministic(torch, lambda: timed(sdpa)[0])
        sdpa_diff = float((nondeterministic(torch, sdpa).transpose(1, 2)
                           .float() - kern().float()).abs().max())
        flops, nbytes = attention_work(*shape, causal, 2)
        bms, by = flash_bound_ms(flops, nbytes, "bfloat16")
        mask = "causal" if causal else "non-causal"
        print(f"[flash] {name} {shape} bf16 {mask}, model layout: F1 "
              f"{ms:.4f} ms event, host issue {host_ms:.4f} ms/call; "
              f"flattened layout {flat_ms:.4f} ms event, host issue "
              f"{flat_host_ms:.4f} ms/call; plain {plain_ms:.4f} ms; sdpa "
              f"{lib_ms:.4f} ms event (max diff to F1 {sdpa_diff:.3g}); "
              f"bound {bms:.4f} ms by {by}")
        rows[name] = {"max_abs_err": errs[(name, "bfloat16", causal)],
                      "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
                      "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
                      "flops": flops}
        DEVICE_JOBS.append((f"flash_attention {name}", rows[name],
                            "device_ms", kern))
        DEVICE_JOBS.append((f"flash_attention {name}: sdpa", rows[name],
                            "library_device_ms",
                            lambda sdpa=sdpa: nondeterministic(torch, sdpa)))
    checked = {(FLASH_SHAPES[name], dname, causal)
               for name, dname, causal in errs}
    # the kernels line carries the side rows beside the main one (their
    # device times are filled in place by phase_device_times)
    for key, name in FLASH_SIDE_ROWS.items():
        rows[FLASH_MAIN][key] = rows[name]
    return rows[FLASH_MAIN], checked


def nondeterministic(torch, fn):
    """Call `fn` with deterministic algorithms off (SDPA has none)."""
    torch.use_deterministic_algorithms(False)
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(True)


def phase_device_times(torch, ops) -> None:
    """Every queued device time, by the profiler, after the host-clock
    readings; then K3's host issue time once more, to show what a profiler
    session leaves behind on the host path."""
    for label, row, key, fn in DEVICE_JOBS:
        row[key], names = device_ms(fn)
        print(f"[device] {label}: {row[key]:.4f} ms device a call "
              f"({'; '.join(n[:90] for n in names)})")
        if key == "library_device_ms" and "flops" in row:
            print(f"[device] {label[:-6]}: F1 "
                  f"{row.pop('flops') / row['device_ms'] / 1e9:.1f} TFLOP/s; "
                  f"F1 / sdpa device time "
                  f"{row['device_ms'] / row['library_device_ms']:.2f}x")
        if "exp_bound_ms" in row:
            print(f"[device] {label}: device time {row['device_ms']:.4f} ms "
                  f"= {row['device_ms'] / row['bound_ms']:.2f}x the bytes "
                  f"bound ({row['bound_ms']:.4f} ms), "
                  f"{row['device_ms'] / row['exp_bound_ms']:.2f}x the exp "
                  f"bound ({row['exp_bound_ms']:.4f} ms), "
                  f"{row['device_ms'] / row['issue_floor_ms']:.2f}x the "
                  f"issue floor of its code ({row['issue_floor_ms']:.4f} ms)")
    k3 = next(fn for label, _, _, fn in DEVICE_JOBS
              if label == "gather_tiles")
    ms, host_ms = timed(k3)
    print(f"[device] gather_tiles once more after the profiler sessions: "
          f"{ms:.4f} ms event, host issue {host_ms:.4f} ms/call")
    DEVICE_JOBS.clear()


def scan_work(b, S, di, ds) -> tuple[int, int, int]:
    """(operations, bytes, exps) of one selective scan on these inputs:
    per state and step an exp and 6 FLOPs (dt*A, h*dA + dt*x*B, y += h*C),
    per channel and step one more (dt*x); x, dt, B, C, A read once, y and
    h_final written once, all float32. The exps, b * S * di * ds (one
    MUFU.EX2 each, 268,435,456 at falcon-mamba-7b's prefill), run on the
    SFU, not the FP32 pipes: `exp_bound_ms` times them."""
    ops = b * S * di * (7 * ds + 1)
    nbytes = 4 * (3 * b * S * di + 2 * b * S * ds + di * ds + b * di * ds)
    return ops, nbytes, b * S * di * ds


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as `nvidia-smi` reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return float(out.splitlines()[0].split()[0]) * 1e6


def exp_bound_ms(torch, exps: int) -> float:
    """The least time the SFUs of every SM take for `exps` MUFU.EX2."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (EX2_PER_CLOCK_PER_SM * sms * sm_clock_hz()) * 1e3


def issue_floor_ms(torch, exps: int, per_exp: float) -> float:
    """The least time for `exps` state-steps of S1 at `per_exp` SASS
    instructions each (its step loop's count), issued at one warp
    instruction a clock by each of an SM's 4 schedulers: a floor of this
    code, not of the function."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps * per_exp / 32 / (4 * sms * sm_clock_hz()) * 1e3


def scan_inputs(torch, g, shape, model_like: bool):
    """float32 (x, dt, B, C, A) on the card. `model_like`: as falcon-mamba's
    prefill gives them (dt = softplus(N(0,1)), A = -(1..ds) from its A_log
    init); else as the reference's tests draw them (dt = |N| * 0.1, A =
    -|N| - 0.1)."""
    b, S, di, ds = shape
    n = lambda *sz: torch.randn(sz, generator=g, device="cuda")
    if model_like:
        dt = torch.nn.functional.softplus(n(b, S, di))
        A = -torch.arange(1, ds + 1, dtype=torch.float32,
                          device="cuda").expand(di, ds).contiguous()
        return n(b, S, di), dt, n(b, S, ds), n(b, S, ds), A
    return (n(b, S, di) * 0.5, n(b, S, di).abs() * 0.1, n(b, S, ds),
            n(b, S, ds), -n(di, ds).abs() - 0.1)


def phase_scan(torch, per_exp: float) -> tuple[dict, set]:
    """Phase 3b: S1 against its plain version; lane independence; times
    beside the bytes and exp bounds and the issue floor of S1's code at
    `per_exp` SASS instructions a state and step. Returns S1's row of the
    kernels line and the (shape, dtype) cases checked."""
    from repro_torch.kernels.mamba_scan import ops as ms
    from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
    from repro_torch.models.mamba import _chunked_scan
    g = torch.Generator(device="cuda").manual_seed(3)
    rows, checked = {}, set()
    for name, shape in SCAN_SHAPES.items():
        b, S, di, ds = shape
        args = scan_inputs(torch, g, shape, name.startswith("falcon"))
        y, h = ms.selective_scan_kernel(*args)
        want_y, want_h = selective_scan_ref(*args)
        err = max(float((y - want_y).abs().max()),
                  float((h - want_h).abs().max()))
        ok = (torch.allclose(y, want_y, atol=SCAN_TOL, rtol=SCAN_TOL)
              and torch.allclose(h, want_h, atol=SCAN_TOL, rtol=SCAN_TOL))
        checked.add((shape, "float32"))
        ms_, host_ms = timed(lambda: ms.selective_scan_kernel(*args))
        plain_ms = timed(lambda: selective_scan_ref(*args), iters=3,
                         warmup=1)[0]
        c = min(SCAN_CHUNK, S)
        chunked_ms = timed(lambda: _chunked_scan(*args[:4], args[4], c,
                                                 torch.float32),
                           iters=5, warmup=1)[0] if S % c == 0 else None
        n_ops, nbytes, exps = scan_work(*shape)
        bms, by = bound_ms(nbytes, n_ops)
        ems = exp_bound_ms(torch, exps)
        ims = issue_floor_ms(torch, exps, per_exp)
        print(f"[scan] {name} {shape} float32: max_abs_err {err:.3g} (tol "
              f"{SCAN_TOL}, y and h_final); S1 {ms_:.4f} ms event, "
              f"host issue {host_ms:.4f} ms/call; "
              f"bound {bms:.4f} ms by {by}, exp bound {ems:.4f} ms "
              f"({exps} MUFU.EX2), issue floor {ims:.4f} ms, plain "
              f"{plain_ms:.4f} ms, chunked torch scan "
              + (f"{chunked_ms:.4f} ms" if chunked_ms is not None
                 else f"n/a (S % {c} != 0, ROADMAP C4)"))
        if not ok or not (torch.isfinite(y).all() and torch.isfinite(h).all()):
            fail(f"S1 disagrees with its plain version at {name}")
        rows[name] = {"max_abs_err": err, "ms": ms_, "host_ms": host_ms,
                      "plain_ms": plain_ms,
                      "bound_ms": bms, "bound_by": by, "library_ms": None,
                      "exp_bound_ms": ems, "issue_floor_ms": ims,
                      "chunked_torch_ms": chunked_ms}

    args = scan_inputs(torch, g, SCAN_SHAPES[SCAN_MAIN], True)
    y, h = ms.selective_scan_kernel(*args)
    y2, h2 = ms.selective_scan_kernel(*args)
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        fail("two S1 launches on the same inputs differ")
    for b in range(args[0].shape[0]):
        yb, hb = ms.selective_scan_kernel(
            *(t[b:b + 1] for t in args[:4]), args[4])
        if not (torch.equal(y[b:b + 1], yb) and torch.equal(h[b:b + 1], hb)):
            fail(f"S1 lane {b} differs from the same row launched alone")
    DEVICE_JOBS.append((f"selective_scan {SCAN_MAIN}", rows[SCAN_MAIN],
                        "device_ms",
                        lambda: ms.selective_scan_kernel(*args)))
    print("[scan] lane independence: each lane of the B=4 falcon-mamba-7b "
          "S 512 launch is bitwise equal to that row launched alone, and two "
          "launches agree bit for bit")
    return rows[SCAN_MAIN], checked


def state_shapes(state) -> dict:
    """{key path: shape} of every leaf of a (nested) decode state."""
    if isinstance(state, dict):
        return {f"{k}/{p}" if p else k: v for k in sorted(state)
                for p, v in state_shapes(state[k]).items()}
    return {"": tuple(state.shape)}


def _serve_prompts(vocab: int, seed: int = 0) -> list:
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, vocab, n)]
            for n in SERVE_PROMPTS]


def kernel_layers(cfg) -> int:
    """The layers of `cfg` that launch the serving path's kernel once a
    prefill call: every layer, but in a hybrid model only the shared
    attention block, once a group of `attn_every` Mamba2 layers."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" \
        else cfg.n_layers


def print_profile(torch, tag: str, what: str, unit: str, n: int, fn) -> None:
    """Run `fn` `n` times under the profiler and print the host-clock and
    device time a call, the device's busy share of the host time, and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t1) * 1e3 / n
    events = [e for e in prof.key_averages()      # kernels, not host ops
              if e.device_type == DeviceType.CUDA]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    launches = sum(e.count for e in events) // n
    print(f"[{tag}] profile of {what}: {host_ms:.1f} ms a {unit} on the "
          f"host clock, {dev_ms:.1f} ms of device time a {unit} (the card "
          f"busy {dev_ms / host_ms:.0%} of it), {launches} device kernels "
          f"and copies a {unit}; top kernels by device time a {unit}:")
    for e in events[:6]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3 / n:8.2f} ms "
              f"x{e.count // n:<5d} {e.key[:90]}")


def moe_routing(torch, model, params, prompts, tag: str) -> None:
    """The MoE model's prefill calls as the engine makes them (each group
    of equal-length prompts lane-padded to 4 with copies of its first):
    print, summed over the layers, the expert assignments that capacity
    dropped and the tokens whose k-th and (k+1)-th router probabilities
    tie exactly. Then the S 512 x 4 call, made twice on the same input,
    must give the same logits and KV caches bit for bit (the routing's
    sort, cumsum and scatter are deterministic on the card)."""
    from repro_torch.models import moe
    inner, k = moe._top_k_routing, model.cfg.experts_per_token
    seen = []

    def record(logits, n_top, capacity):
        out = inner(logits, n_top, capacity)
        top = torch.sort(torch.softmax(logits.float(), -1), -1,
                         descending=True).values
        seen.append((tuple(logits.shape), capacity,
                     logits.shape[0] * logits.shape[1] * n_top,
                     int(out[0].sum()),
                     int((top[..., n_top - 1] == top[..., n_top]).sum())))
        return out

    for rows in (prompts[:4], prompts[4:7], prompts[7:]):
        toks = torch.tensor(rows + rows[:1] * (4 - len(rows)), device="cuda")
        seen.clear()
        moe._top_k_routing = record
        try:
            with torch.no_grad():
                model.prefill(params, {"tokens": toks}, max_len=1024)
        finally:
            moe._top_k_routing = inner
        (G, g, _), C = seen[0][0], seen[0][1]
        total = sum(s[2] for s in seen)
        dropped = total - sum(s[3] for s in seen)
        ties = sum(s[4] for s in seen)
        print(f"[{tag}] routing of the prefill call S {len(rows[0])} x "
              f"{len(rows)} (lane-padded to 4): {G} groups of {g} tokens, "
              f"capacity {C}; over {len(seen)} layers {dropped} of {total} "
              f"expert assignments dropped ({dropped / total:.4%}); "
              f"{ties} token-layers whose {k}th and {k + 1}th router "
              f"probabilities tie")
    toks = torch.tensor(prompts[:4], device="cuda")
    with torch.no_grad():
        a = model.prefill(params, {"tokens": toks}, max_len=1024)
        b = model.prefill(params, {"tokens": toks}, max_len=1024)
    if not (torch.equal(a[0], b[0]) and all(
            torch.equal(a[1][n], b[1][n]) for n in ("k", "v"))):
        fail("two prefill calls on the same input gave different bits")
    print(f"[{tag}] the S 512 x 4 prefill call made twice: logits and both "
          f"KV caches {tuple(a[1]['k'].shape)} bit-identical")


def straight_run(tag: str, engine):
    """Serve `engine(sink)`'s requests straight through and print the
    time to first token and the decode rate: (the engine, {rid: out})."""
    # token delivery times (the sink runs after each step's argmax has
    # come back to the host, so they are the card's times too)
    first_at, n_tok = {}, [0]

    def sink(rid, idx, tok):
        n_tok[0] += 1
        first_at.setdefault(rid, time.monotonic() - t0)

    t0 = time.monotonic()
    eng = engine(sink)
    out = {r.rid: r.out for r in eng.run_until_drained()}
    wall = time.monotonic() - t0
    ttft = sorted(first_at.values())
    print(f"[{tag}] straight run: {len(out)} requests, {n_tok[0]} tokens "
          f"in {wall:.2f} s; time to first token {ttft[0]:.3f} s (first "
          f"request) to {ttft[-1]:.3f} s (last, queued behind the first "
          f"wave); {(n_tok[0] - len(out)) / (wall - ttft[0]):.1f} decode "
          f"tokens/s after the first token")
    return eng, out


def phase_serve(torch, arch: str, kernel: str, recording, tag: str,
                then=None) -> dict:
    """Phases 6, 8, 8b and 8c: `arch` at full width and depth, served with
    `--attn-impl pallas`, where `kernel` must launch once per layer (per
    group, in a hybrid model) and prefill call. Returns the launches of
    the serve CLI's run; `recording` records the kernel's cases on it.
    `then(model, params, prompts, transcripts)` runs on the API's model
    and parameters before they are freed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    if cfg.family == "ssm":
        print(f"[{tag}] {arch}: {cfg.n_layers} Mamba1 layers, d_model "
              f"{cfg.d_model}, d_inner {cfg.d_inner}, ds {cfg.ssm_state}, "
              f"conv {cfg.ssm_conv}, vocab {cfg.vocab_size}; depth not cut")
    elif cfg.family == "hybrid":
        G, tail = divmod(cfg.n_layers, cfg.attn_every)
        print(f"[{tag}] {arch}: {cfg.n_layers} Mamba2 layers ({G} groups of "
              f"{cfg.attn_every}, each followed by the shared attention "
              f"block, and a tail of {tail}), d_model {cfg.d_model}, d_inner "
              f"{cfg.d_inner}, {cfg.n_ssm_heads} ssm heads of "
              f"{cfg.ssm_head_dim}, ds {cfg.ssm_state}, ssm_chunk "
              f"{cfg.ssm_chunk}; shared block {cfg.n_heads}/"
              f"{cfg.n_kv_heads} heads, hd {cfg.head_dim}, d_ff {cfg.d_ff}; "
              f"vocab {cfg.vocab_size}; depth not cut")
    elif cfg.family == "moe":
        print(f"[{tag}] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, "
              f"{cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
              f"{cfg.experts_per_token}, capacity factor "
              f"{cfg.capacity_factor}, routing groups of "
              f"{ExecConfig().moe_group} tokens; vocab {cfg.vocab_size}; "
              f"depth not cut")
    else:
        print(f"[{tag}] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, "
              f"vocab {cfg.vocab_size}, qkv_bias {cfg.qkv_bias}; depth not "
              f"cut")
    flags = ["--arch", arch, *SERVE_FLAGS[2:]]
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf), recording:
        rc = serve_main(flags)
    torch.cuda.synchronize()
    launches = launch_counts()
    if rc != 0:
        fail(f"{arch} serve CLI failed")
    out = json.loads(buf.getvalue())
    print(f"[{tag}] CLI {' '.join(flags)}: {json.dumps(out)}")
    n = kernel_layers(cfg)
    want = n * out["prefill_calls"]
    if out["completed"] != len(SERVE_PROMPTS):
        fail(f"{arch} serve CLI did not complete every request")
    if launches[kernel] != want or want == 0:
        fail(f"{kernel} launched {launches[kernel]} times on the {arch} "
             f"serve path, expected {n} "
             f"{'groups' if cfg.family == 'hybrid' else 'layers'} x "
             f"{out['prefill_calls']} prefills = {want}")
    print(f"[{tag}] launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()

    # through the API: params drawn once, on the card
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, ExecConfig(attn_impl="pallas"))
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[{tag}] {arch} init: {n_params} float32 parameters drawn on "
          f"the card in {time.monotonic() - t0:.2f} s")
    params["embedding"]["table"].mul_(TABLE_SCALE)
    prompts = _serve_prompts(cfg.vocab_size)

    def engine(sink=None):
        eng = ServeEngine(model, params, n_slots=4, max_len=1024, sink=sink)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=32))
        return eng

    straight, want = straight_run(tag, engine)
    TRANSCRIPTS[tag] = transcript_digest(want)
    first = engine()
    for _ in range(8):
        first.step()
    snap = first.snapshot()
    # keep decoding (the live state moves on in place), under the
    # profiler: where a decode step's time goes on the card
    print_profile(torch, tag, "4 decode steps (4 slots)", "step", 4,
                  first.step)
    second = ServeEngine(model, params, n_slots=4, max_len=1024)
    second.restore(snap)
    got = {r.rid: r.out for r in second.run_until_drained()}
    if got != want:
        fail(f"{arch}: a snapshot/restore in the middle changed the "
             "transcripts")
    # leaf by leaf: a hybrid's state is nested ({mamba, tail, attn})
    leaves = tree_leaves(straight.state)
    if state_shapes(second.state) != state_shapes(straight.state) or not all(
            torch.equal(a, b)
            for a, b in zip(leaves, tree_leaves(second.state))):
        fail(f"{arch}: a snapshot/restore in the middle changed the final "
             f"decode state {state_shapes(straight.state)}")
    print(f"[{tag}] snapshot at step 8, 4 more steps, restore into a new "
          f"engine: transcripts of {len(got)} requests and all "
          f"{len(leaves)} leaves of the final decode state "
          f"{state_shapes(straight.state)} bit-identical to the straight "
          f"run; {len({tuple(v) for v in want.values()})} distinct "
          f"transcripts")
    del straight, first, second, snap
    if then is not None:
        then(model, params, prompts, want)

    def prefill(m, toks):
        """(last logits, wall ms of the second of two calls: the first
        pays cuBLAS's choice of algorithms for a new shape)."""
        with torch.no_grad():
            m.prefill(params, {"tokens": toks}, max_len=1024)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, _ = m.prefill(params, {"tokens": toks}, max_len=1024)
            torch.cuda.synchronize()
        return logits[:, -1].float(), (time.perf_counter() - t) * 1e3

    chunked = Model(cfg, ExecConfig(attn_impl="chunked"))
    ssm = cfg.family == "ssm"
    # the ssm, hybrid and moe models are held in float32 compute
    # (LOGIT_TOL_F32); dense qwen2-7b in its served bf16 (LOGIT_TOL)
    in_f32 = cfg.family in ("ssm", "hybrid", "moe")
    for rows in (prompts[:4], prompts[4:7], prompts[7:]):
        n = len(rows[0])
        toks = torch.tensor(rows, device="cuda")
        lp, p_ms = prefill(model, toks)
        lc, c_ms = prefill(chunked, toks)
        print(f"[{tag}] prefill S {n} x {len(rows)}: wall {p_ms:.1f} ms "
              f"pallas, {c_ms:.1f} ms chunked ({cfg.compute_dtype}, the "
              f"served dtype)")
        if in_f32:
            held_to_chunked(torch, cfg, params, {"tokens": toks}, tag,
                            f"S {n} x {len(rows)}")
            continue
        rel = float((lp - lc).abs().max()) / float(lc.abs().max())
        same = first_tokens_held(lp, lc, LOGIT_TOL, f"{tag} prompt {n}")
        print(f"[{tag}] prefill S {n} x {len(rows)}: pallas vs chunked "
              f"logits max diff {rel:.3g} of the largest (tol {LOGIT_TOL}); "
              f"first tokens equal on {same} of {len(rows)} lanes")
        if rel > LOGIT_TOL:
            fail(f"pallas and chunked prefill logits differ at S {n}")
    if cfg.family == "moe":
        moe_routing(torch, model, params, prompts, tag)
    toks = torch.tensor(prompts[:4], device="cuda")
    with torch.no_grad():
        print_profile(torch, tag, f"a prefill call (S 512 x 4, pallas, "
                      f"{cfg.compute_dtype})", "call", 1,
                      lambda: model.prefill(params, {"tokens": toks},
                                            max_len=1024))
    if ssm:
        for c in (cfg, cfg.replace(compute_dtype="float32")):
            lc = prefill(Model(c, ExecConfig(attn_impl="chunked")), toks)[0]
            l64 = prefill(Model(c.replace(ssm_chunk=64),
                                ExecConfig(attn_impl="chunked")), toks)[0]
            rel = float((l64 - lc).abs().max()) / float(lc.abs().max())
            print(f"[{tag}] yardstick, {c.compute_dtype}: the chunked route "
                  f"at ssm_chunk 64 against 128, S 512 x 4: logits max diff "
                  f"{rel:.3g} of the largest; first tokens equal on "
                  f"{int((l64.argmax(-1) == lc.argmax(-1)).sum())} of 4 "
                  f"lanes")
    print(f"[{tag}] peak device memory of the API checks "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_sharded_serve(torch, model, params, prompts, want: dict,
                        recording) -> dict:
    """Phase 6b [sharded-serve]: [serve]'s model, parameters and requests
    served by the sharded engine: a world-1 NCCL group, a (1, 1) (data,
    model) mesh and the pod_serve rules, so the parameters and the KV
    cache are DTensors and F1 runs through `local_call` in the prefill.
    The transcripts must be [serve]'s (`want`) token for token, with F1
    launched once per layer and prefill call, and again after a
    snapshot/restore in the middle. Prints the cache's placements, the
    time to first token and decode rate, and a decode step's host and
    device time beside the unsharded engine's at the same point. Returns
    the straight run's kernel launches."""
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding.rules import PRESETS
    tag = "sharded-serve"
    with process_group():
        mesh = make_host_mesh((1, 1), ("data", "model"))

        def engine(sink=None, sharded=True):
            eng = ServeEngine(model, params, n_slots=4, max_len=1024,
                              sink=sink,
                              **(dict(mesh=mesh, rules=PRESETS["pod_serve"])
                                 if sharded else {}))
            for rid, p in enumerate(prompts):
                eng.submit(Request(rid=rid, prompt=p, max_new_tokens=32))
            return eng

        reset_launches()
        with recording:
            eng, got = straight_run(tag, engine)
        torch.cuda.synchronize()
        launches = launch_counts()
        k = eng.state["k"]
        print(f"[{tag}] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              f"pod_serve: KV cache {tuple(k.shape)} {k.dtype} placed "
              f"{k.placements}; embedding table placed "
              f"{eng.params['embedding']['table'].placements}; "
              f"{eng.prefill_calls} prefill calls; launches {launches}")
        want_f1 = kernel_layers(model.cfg) * eng.prefill_calls
        if got != want:
            fail(f"{tag}: the sharded engine's transcripts differ from "
                 f"[serve]'s")
        if launches["flash_attention"] != want_f1:
            fail(f"{tag}: F1 launched {launches['flash_attention']} times, "
                 f"expected {want_f1}")
        first = engine()
        for _ in range(8):
            first.step()
        second = engine()
        second.restore(first.snapshot())
        if {r.rid: r.out for r in second.run_until_drained()} != want:
            fail(f"{tag}: a snapshot/restore in the middle changed the "
                 f"transcripts")
        print(f"[{tag}] transcripts of {len(got)} requests equal [serve]'s "
              f"token for token, straight and through a snapshot/restore "
              f"at step 8; F1 launched {want_f1} times, each through "
              f"local_call")
        for name, sharded in (("unsharded", False), ("sharded", True)):
            e = engine(sharded=sharded)
            for _ in range(8):
                e.step()
            print_profile(torch, tag, f"4 decode steps (4 slots), "
                          f"{name} engine", "step", 4, e.step)
            del e
        del eng, first, second
    return launches


# the encdec and vlm phases: 32 greedy decode steps after each prefill
FRONTEND_DECODE_STEPS = 32
# seamless-m4t-medium's prompt groups (B, S): an even and an odd length
ENCDEC_GROUPS = ((4, 512), (4, 77))
# llava-next-34b: the depth kept of its 60 layers (all 60 are 135.9 GB of
# float32 parameters; 16 are 37.7 GB), its batch and prompt (the frontend's
# 2880 rows, then 192 text tokens)
VLM_LAYERS = 16
VLM_BATCH, VLM_SEQ = 2, 3072


def greedy_decode(torch, model, params, logits, state, S: int, steps: int):
    """`steps` greedy decode steps after a prefill to S tokens: (the
    tokens, wall seconds of the steps, the final logits)."""
    toks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(steps):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(nxt)
            logits, state = model.decode_step(params, nxt, state, S + i)
        toks = torch.cat(toks, 1).cpu()
    return toks, time.perf_counter() - t0, logits


def first_tokens_held(lp, lc, tol: float, what: str) -> int:
    """Fail where pallas's greedy first token (logits `lp`) is more than
    `tol` of the largest logit below chunked's (`lc`) in chunked's logits;
    returns the count of lanes whose first tokens are equal."""
    scale = float(lc.abs().max())
    tp, tc = lp.argmax(-1), lc.argmax(-1)
    for b in range(lp.shape[0]):
        gap = float(lc[b, tc[b]] - lc[b, tp[b]])
        if gap > tol * scale:
            fail(f"{what}: pallas's first token {int(tp[b])} is {gap:.3g} "
                 f"below chunked's {int(tc[b])}")
    return int((tp == tc).sum())


def held_to_chunked(torch, cfg, params, batch, tag: str, what: str) -> None:
    """Prefill logits of `pallas` against `chunked` on `batch`: bounded in
    float32 compute, where only the attention sums' order differs; the
    served dtype's difference printed beside it, with the chunked route in
    the served dtype against itself in float32 as its yardstick."""
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    out = {}
    for dtype in (cfg.compute_dtype, "float32"):
        for impl in ("pallas", "chunked"):
            m = Model(cfg.replace(compute_dtype=dtype),
                      ExecConfig(attn_impl=impl))
            with torch.no_grad():
                out[dtype, impl] = m.prefill(params, batch, max_len=1024)[
                    0][:, -1].float()
    lc = out["float32", "chunked"]
    scale = float(lc.abs().max())
    rel = {k: float((v - lc).abs().max()) / scale for k, v in out.items()}
    served = out[cfg.compute_dtype, "chunked"]
    rel16 = float((out[cfg.compute_dtype, "pallas"] - served).abs().max()) \
        / float(served.abs().max())
    same = first_tokens_held(out["float32", "pallas"], lc, LOGIT_TOL_F32,
                             f"{tag} {what}")
    print(f"[{tag}] prefill {what}: pallas vs chunked logits, float32 "
          f"compute, max diff {rel['float32', 'pallas']:.3g} of the largest "
          f"(tol {LOGIT_TOL_F32}), first tokens equal on {same} of "
          f"{lc.shape[0]} lanes; in {cfg.compute_dtype} (served, not "
          f"bounded) {rel16:.3g}; yardstick: chunked {cfg.compute_dtype} vs "
          f"chunked float32 {rel[cfg.compute_dtype, 'chunked']:.3g}")
    if rel["float32", "pallas"] > LOGIT_TOL_F32:
        fail(f"{tag}: pallas and chunked prefill logits differ ({what})")


def phase_serve_api(torch, tag: str, cfg, batches: list, max_len: int,
                    want_f1: int, seen: set):
    """Serve `cfg` (random parameters, drawn on the card) through the model
    API with `attn_impl="pallas"`: for each (label, batch) of `batches`, a
    `Model.prefill` then FRONTEND_DECODE_STEPS greedy `decode_step`s, F1's
    launches counted over that run and held to `want_f1`. Then: the first
    batch's prefill made twice must give the logits and every state leaf
    bit for bit, each batch's prefill is held to `chunked`, and a prefill
    call and 4 decode steps are profiled.
    Returns (F1's launches on the counted run, each batch's last prefill
    logits in float32); `seen` gets F1's cases in it."""
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.tree import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, ExecConfig(attn_impl="pallas"))
    t0 = time.monotonic()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[{tag}] init: {n_params} float32 parameters drawn on the card "
          f"in {time.monotonic() - t0:.2f} s")
    params["embedding"]["table"].mul_(TABLE_SCALE)

    # warm: cuBLAS picks its algorithms for each new shape on a first call
    with torch.no_grad():
        for _, batch in batches:
            model.prefill(params, batch, max_len=max_len)
    torch.cuda.synchronize()
    reset_launches()
    firsts, transcripts = [], []
    with recording_flash_shapes(seen):
        for label, batch in batches:
            nb, S = batch["tokens"].shape
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, state = model.prefill(params, batch, max_len=max_len)
                first = logits[:, -1].argmax(-1).cpu()
            ttft = time.perf_counter() - t0
            toks, wall, last = greedy_decode(torch, model, params, logits,
                                             state, S, FRONTEND_DECODE_STEPS)
            if not (torch.isfinite(logits).all() and torch.isfinite(last)
                    .all()):
                fail(f"{tag}: non-finite logits at S {S} ({label})")
            firsts.append(logits[:, -1].float())
            transcripts.append(toks.tolist())
            FIRST_TOKENS.setdefault(tag, []).append(first.tolist())
            print(f"[{tag}] prefill S {S} x {nb} ({label}): time to first "
                  f"token {ttft:.3f} s; {FRONTEND_DECODE_STEPS} decode steps "
                  f"in {wall:.3f} s, "
                  f"{nb * FRONTEND_DECODE_STEPS / wall:.1f} decode tokens/s; "
                  f"state {state_shapes(state)}; first tokens "
                  f"{first.tolist()}, "
                  f"{len({tuple(r) for r in toks.tolist()})} distinct "
                  f"transcripts")
    torch.cuda.synchronize()
    launches = launch_counts()
    TRANSCRIPTS[tag] = transcript_digest(transcripts)
    if launches["flash_attention"] != want_f1:
        fail(f"F1 launched {launches['flash_attention']} times on the "
             f"{cfg.name} path, expected {want_f1}")
    print(f"[{tag}] launches {launches}")

    label, batch = batches[0]
    S = batch["tokens"].shape[1]
    with torch.no_grad():
        a = model.prefill(params, batch, max_len=max_len)
        b = model.prefill(params, batch, max_len=max_len)
    if not torch.equal(a[0], b[0]) or sorted(a[1]) != sorted(b[1]) or not \
            all(torch.equal(a[1][n], b[1][n]) for n in a[1]):
        fail(f"{tag}: two prefill calls on the same input gave different "
             "bits")
    print(f"[{tag}] the S {S} ({label}) prefill call made twice: logits and "
          f"all {len(a[1])} state leaves {state_shapes(a[1])} bit-identical")
    for label_i, batch_i in batches:
        nb_i, S_i = batch_i["tokens"].shape
        held_to_chunked(torch, cfg, params, batch_i, tag,
                        f"S {S_i} x {nb_i} ({label_i})")
    state = a[1]
    with torch.no_grad():
        print_profile(torch, tag, f"a prefill call (S {S} x "
                      f"{batch['tokens'].shape[0]}, pallas, "
                      f"{cfg.compute_dtype})", "call", 1,
                      lambda: model.prefill(params, batch, max_len=max_len))
        tok = a[0][:, -1].argmax(-1, keepdim=True)
        pos = iter(range(S, max_len))
        print_profile(torch, tag, f"4 decode steps "
                      f"({batch['tokens'].shape[0]} lanes)", "step", 4,
                      lambda: model.decode_step(params, tok, state,
                                                next(pos)))
    print(f"[{tag}] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del params, a, b, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, firsts


def phase_serve_encdec(torch, seen: set) -> dict:
    """Phase 8d: seamless-m4t-medium at full published width and depth
    through the model API with the encoder's input (the serving engine
    refuses encdec: ROADMAP C8, checked on the serve CLI first). Returns
    F1's launches on the counted run (the two prompt groups' prefill and
    decode); `seen` gets F1's cases in it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    tag = "serve-encdec"
    cfg = get_config("seamless-m4t-medium")
    print(f"[{tag}] {cfg.name}: {cfg.n_enc_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, enc_seq_len "
          f"{cfg.enc_seq_len}, frontend {cfg.frontend!r}; depth not cut")
    flags = ["--arch", cfg.name, *SERVE_FLAGS[2:]]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve_main(flags)
    except ValueError as e:
        if "ROADMAP C8" not in str(e):
            raise
        print(f"[{tag}] CLI {' '.join(flags)}: refused as it must be: "
              f"ValueError: {e}")
    else:
        fail(f"the serve CLI served the encdec model {cfg.name}; the engine "
             "prefills from tokens alone (ROADMAP C8)")
    gc.collect()
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(5)
    enc = torch.randn((ENCDEC_GROUPS[0][0], cfg.enc_seq_len, cfg.d_model),
                      generator=g, device="cuda").to(torch.bfloat16)
    batches = [(f"enc_emb {tuple(enc.shape)}",
                {"tokens": torch.randint(2, cfg.vocab_size, (b, S),
                                         generator=g, device="cuda"),
                 "enc_emb": enc}) for b, S in ENCDEC_GROUPS]
    want = (cfg.n_enc_layers + 2 * cfg.n_layers) * len(batches)
    print(f"[{tag}] F1 must launch ({cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} self + {cfg.n_layers} cross) x {len(batches)} "
          f"prefills = {want} times")
    launches, _ = phase_serve_api(torch, tag, cfg, batches, 1024, want, seen)
    return launches


def phase_serve_vlm(torch, seen: set) -> dict:
    """Phase 8e: llava-next-34b at its published width, depth cut to
    VLM_LAYERS of 60, through the model API with two frontend inputs, A
    and B, on the same tokens; the frontend must change the logits.
    Returns F1's launches on the counted run (each input's prefill and
    decode); `seen` gets F1's cases in it."""
    from repro_torch.configs import get_config
    tag = "serve-vlm"
    full = get_config("llava-next-34b")
    cfg = full.replace(n_layers=VLM_LAYERS)
    nf = cfg.n_frontend_tokens
    print(f"[{tag}] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, hd {cfg.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {nf} frontend rows; depth CUT to "
          f"{cfg.n_layers} of {full.n_layers} layers (all {full.n_layers} "
          f"in float32 would not fit in the card's 80 GB)")
    g = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(2, cfg.vocab_size, (VLM_BATCH, VLM_SEQ),
                         generator=g, device="cuda")
    batches = [(f"frontend {name}: {nf} rows + {VLM_SEQ - nf} text tokens",
                {"tokens": toks, "frontend_emb": torch.randn(
                    (VLM_BATCH, nf, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)}) for name in "AB"]
    want = cfg.n_layers * len(batches)
    print(f"[{tag}] F1 must launch {cfg.n_layers} layers x {len(batches)} "
          f"prefills = {want} times")
    launches, (la, lb) = phase_serve_api(torch, tag, cfg, batches,
                                         VLM_SEQ + 64, want, seen)
    diff = float((la - lb).abs().max()) / float(la.abs().max())
    if diff == 0.0:
        fail(f"{tag}: the frontend input did not change the logits")
    print(f"[{tag}] the frontend changes the logits: A vs B max diff "
          f"{diff:.3g} of the largest")
    return launches


def phase_serve_cluster(torch, seen: set) -> dict:
    """Phase 7: the fast serving cells under reinit and replica at
    paper-demo full width. Returns the launches of the whole phase and
    adds F1's cases in it to `seen`."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.scenarios.catalog import SERVE_CATALOG
    from repro_torch.serve import LoadGen, ServeCluster

    model = Model(get_config("paper-demo"), ExecConfig(attn_impl="pallas"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    params["embedding"]["table"].mul_(TABLE_SCALE)

    def load(sc):
        return LoadGen(world=sc.world, rounds=sc.rounds,
                       per_round=sc.per_round, max_new=sc.max_new_tokens,
                       seed=sc.seed)

    refs = {}
    reset_launches()
    with recording_flash_shapes(seen):
        for cell in (s for s in SERVE_CATALOG if "fast" in s.tags):
            key = (cell.world, cell.n_slots, cell.max_len, cell.rounds,
                   cell.per_round, cell.max_new_tokens, cell.seed)
            if key not in refs:
                c = ServeCluster(model, params, world=cell.world,
                                 n_slots=cell.n_slots, max_len=cell.max_len)
                m = c.run(load(cell), rounds=cell.rounds)
                if m["requests_dropped"]:
                    fail(f"{cell.name}: the fault-free run dropped requests")
                refs[key] = c.transcripts()
            for strategy in ("reinit", "replica"):
                sc = dataclasses.replace(cell, strategy=strategy)
                t0 = time.monotonic()
                c = ServeCluster(model, params, world=sc.world,
                                 n_slots=sc.n_slots, max_len=sc.max_len,
                                 strategy=sc.strategy,
                                 publish_every=sc.publish_every,
                                 respawn_delay=sc.respawn_delay)
                m = c.run(load(sc), rounds=sc.rounds, fault=sc.fault())
                wall = time.monotonic() - t0
                if not m["kills"] or m["requests_dropped"]:
                    fail(f"{sc.name} {strategy}: kills {m['kills']}, dropped "
                         f"{m['dropped_rids']}")
                if c.transcripts() != refs[key]:
                    fail(f"{sc.name} {strategy}: transcripts differ from the "
                         "fault-free run")
                k = m["kills"][0]
                print(f"[serve-cluster] {sc.name} under {strategy}: lossless, "
                      f"{m['tokens_delivered']} tokens, rounds down "
                      f"{k['rounds_down']}, replayed {k['replayed_tokens']}, "
                      f"tokens to first recovered token "
                      f"{k['tokens_to_first_recovered_token']}, {wall:.2f} s")
    torch.cuda.synchronize()
    launches = launch_counts()
    TRANSCRIPTS["serve-cluster"] = transcript_digest(
        {str(k): v for k, v in refs.items()})
    print(f"[serve-cluster] launches {launches}")
    return launches


def final_digests(ckpt_dir: str) -> dict:
    """Leaf digests of the newest checkpoint, after a verified load (the
    host-side numpy digest re-checks what the kernels wrote)."""
    from repro_torch.checkpoint import FileCheckpointer
    ck = FileCheckpointer(ckpt_dir)
    man, _ = ck.load(ck.steps()[-1], verify=True)
    return {"step": man.step,
            "digests": {k: m["digest"] for k, m in man.leaves.items()}}


XENT_RTOL = 1e-5


def phase_xent(torch, ckpt_dir: str) -> None:
    """The chunked unembedding cross-entropy on the card with the trained
    paper-demo table, held to the full logits' and the trainer's."""
    from repro_torch.checkpoint import FileCheckpointer
    from repro_torch.models.layers import (chunked_unembed_xent,
                                           cross_entropy, unembed)
    from repro_torch.models.model import masked_chunked_xent
    ck = FileCheckpointer(ckpt_dir)
    _, state = ck.load(ck.steps()[-1], verify=True)
    emb = {"table": torch.from_numpy(
        state["params"]["embedding"]["table"].copy()).to("cuda")}
    V, D = emb["table"].shape
    # not the train CLI's seed 0: that generator drew the table first, so
    # its first draws here would be the table's own rows
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((8, 256, D), generator=g, device="cuda")
    labels = torch.randint(0, V, (8, 256), generator=g, device="cuda")
    routes = {
        "chunked_unembed_xent": lambda: chunked_unembed_xent(
            emb, x, labels, torch.float32),
        "cross_entropy(unembed)": lambda: cross_entropy(
            unembed(emb, x, torch.float32), labels),
        "masked_chunked_xent": lambda: masked_chunked_xent(
            emb["table"], x, labels, torch.float32),
    }
    vals = {k: float(fn()) for k, fn in routes.items()}
    ms = {k: timed(fn, iters=5, warmup=1)[0] for k, fn in routes.items()}
    got = vals["chunked_unembed_xent"]
    rel = max(abs(got - v) / abs(v) for v in vals.values())
    print(f"[train] xent: table {tuple(emb['table'].shape)} "
          f"{emb['table'].dtype}, x {tuple(x.shape)}: " + ", ".join(
              f"{k} {v:.7f} ({ms[k]:.3f} ms)" for k, v in vals.items())
          + f"; max relative difference {rel:.3g} (bound {XENT_RTOL:g})")
    if not all(v == v and abs(v) != float("inf") for v in vals.values()):
        fail(f"the cross-entropy routes gave non-finite values: {vals}")
    if rel > XENT_RTOL:
        fail(f"chunked_unembed_xent differs from the full logits' or the "
             f"trainer's cross-entropy by {rel:.3g} relative")


def phase_train(torch, ops) -> tuple[dict, dict]:
    """Phase 3: the main path at full width, each fault run vs its twin.
    Returns ({run name: kernel launches over its fault and twin runs},
    {run name: the fault-free twin's final checkpoint digests})."""
    from repro_torch.launch.train import main
    runs = {   # name: (checkpoint and strategy flags, fault flags)
        "reinit-process-full": (["--strategy", "reinit"],
                                ["--fail-kind", "process"]),
        "cr-node-delta4": (["--strategy", "cr", "--ckpt-delta-every", "4"],
                           ["--fail-kind", "node"]),
    }
    launches, finals = {}, {}
    for name, (flags, fault) in runs.items():
        out = {}
        launches[name] = {k: 0 for k in launch_counts()}
        for twin in (False, True):
            tag = f"{name}-{'twin' if twin else 'fault'}"
            d = os.path.join(WORK, tag)
            args = ["--arch", "paper-demo", "--steps", str(STEPS),
                    "--ckpt-dir", d, "--report", d + ".json", "--seed", "0",
                    *flags, *([] if twin else fault)]
            t0 = time.monotonic()
            reset_launches()
            if main(args) != 0:
                fail(f"{tag}: train CLI failed")
            torch.cuda.synchronize()
            for k, n in launch_counts().items():
                launches[name][k] += n
            wall = time.monotonic() - t0
            with open(d + ".json") as f:
                summary = json.load(f)
            out[twin] = final_digests(d)
            print(f"[train] {tag}: {wall:.1f} s, first_loss "
                  f"{summary['first_loss']:.4f} last_loss "
                  f"{summary['last_loss']:.4f} recoveries "
                  f"{summary['recoveries']}")
            if summary["final_step"] != STEPS:
                fail(f"{tag}: final_step {summary['final_step']}")
            if not twin and len(summary["recoveries"]) != 1:
                fail(f"{tag}: expected one recovery")
            if twin and name == "reinit-process-full":
                phase_xent(torch, d)
            shutil.rmtree(d)
        if out[False] != out[True]:
            fail(f"{name}: final state differs from the fault-free twin")
        finals[name] = out[True]
        print(f"[train] {name}: final state bit-identical to its twin "
              f"({len(out[True]['digests'])} leaves); launches "
              f"{launches[name]}")
    return launches, finals


def phase_sharded_train(torch, plain: dict) -> dict:
    """Phase 4c [sharded-train]: the reinit run of phase 4 through the
    API, once without a mesh and twice under a device mesh: a world-1
    NCCL group, a (1,) `data` mesh and ShardingRules(batch="data",
    embed="data"), so the state is DTensors placed by the rules, each
    step runs in a constraint scope and the file tier gathers every leaf
    before K2 digests it. Under the mesh fault-free and with the same
    process failure; all three final states must be the unsharded CLI
    run's (`plain`) bit for bit. Prints each run's median step time.
    Returns the kernel launches of the two sharded runs."""
    from repro_torch.configs import get_config
    from repro_torch.core import FailureType, FaultInjector
    from repro_torch.launch.mesh import make_host_mesh, process_group
    from repro_torch.models.model import Model
    from repro_torch.sharding.rules import ShardingRules
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)
    cfg = get_config("paper-demo")
    rules = ShardingRules(batch="data", embed="data")
    launches = {k: 0 for k in launch_counts()}
    with process_group():
        mesh = make_host_mesh((1,), ("data",))
        for tag, sharded, fault in (("unsharded", False, False),
                                    ("sharded", True, False),
                                    ("sharded-fault", True, True)):
            d = os.path.join(WORK, f"sharded-train-{tag}")
            inj = FaultInjector(n_ranks=8, n_steps=STEPS,
                                kind=FailureType.PROCESS, seed=0) \
                if fault else None
            tr = Trainer(
                Model(cfg), TokenPipeline(cfg.vocab_size, 8, 256, seed=0),
                AdamWConfig(total_steps=STEPS,
                            warmup_steps=max(STEPS // 10, 1)),
                TrainConfig(total_steps=STEPS, ckpt_dir=d, strategy="reinit",
                            seed=0, log_every=10),
                **(dict(mesh=mesh, rules=rules) if sharded else {}),
                injector=inj)
            t0 = time.monotonic()
            reset_launches()
            res = tr.run()
            torch.cuda.synchronize()
            if sharded:
                for k, n in launch_counts().items():
                    launches[k] += n
            wall = time.monotonic() - t0
            rollbacks = [r.rollback_step for r in res["reports"]]
            steps = sorted(l.seconds for l in tr.logs)
            table = tr.state["params"]["embedding"]["table"]
            where = (f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
                     f"embedding table placed {table.placements}"
                     if sharded else "no mesh")
            print(f"[sharded-train] {tag}: {wall:.1f} s, {where}, median "
                  f"step {steps[len(steps) // 2] * 1e3:.1f} ms (min "
                  f"{steps[0] * 1e3:.1f}), first_loss {res['losses'][0]:.4f} "
                  f"last_loss {res['losses'][-1]:.4f}, rollbacks "
                  f"{rollbacks}")
            if res["final_step"] != STEPS:
                fail(f"sharded-train {tag}: final_step {res['final_step']}")
            if rollbacks != ([inj.fail_step] if fault else []):
                fail(f"sharded-train {tag}: rollbacks {rollbacks}")
            got = final_digests(d)
            shutil.rmtree(d)
            if got != plain:
                diff = sorted(k for k in plain["digests"]
                              if plain["digests"][k] != got["digests"].get(k))
                fail(f"sharded-train {tag}: the final state differs from "
                     f"the unsharded [train] reinit run's in {diff}")
    print(f"[sharded-train] final state of all three runs bit-identical to "
          f"the unsharded [train] reinit run's ({len(plain['digests'])} "
          f"leaves); launches of the sharded runs {launches}")
    return launches


def phase_train_elastic(torch, device: str = "cuda", batch: int = 8,
                        seq: int = 256) -> dict:
    """Phase 4b: the trainer's elastic and gray paths at full width,
    through the API (the CLI has no scenario flag): a node loss with no
    spare (shrink, full saves), and a slow rank drained by mitigation.
    Each must end bit-identical to its fault-free twin. Returns
    {run name: kernel launches over its fault and twin runs}."""
    from repro_torch.configs import get_config
    from repro_torch.core import ScenarioInjector
    from repro_torch.models.model import Model
    from repro_torch.scenarios import Fault, Scenario, Topology
    from repro_torch.scenarios.schema import gray_drain_cut
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)
    cfg = get_config("paper-demo")
    slow = Fault("rank", 1, 2, how="slow", factor=6.0)
    runs = {   # name: (faults, mitigate, [(world_after, rollback_step)])
        "shrink-node-full": ((Fault("node", 2, 3),), False, [(4, 3)]),
        "gray-slow-drain": ((slow,), True, [(7, gray_drain_cut(slow))]),
    }
    launches = {}
    for name, (faults, mitigate, want) in runs.items():
        sc = Scenario(name=name, steps=STEPS,
                      topology=Topology(nodes=2, ranks_per_node=4, spares=0),
                      faults=faults, mitigate=mitigate,
                      strategies=("shrink",), expect_bit_identical=False)
        out = {}
        launches[name] = {k: 0 for k in launch_counts()}
        for twin in (False, True):
            tag = f"{name}-{'twin' if twin else 'fault'}"
            d = os.path.join(WORK, tag)
            tr = Trainer(
                Model(cfg), TokenPipeline(cfg.vocab_size, batch, seq, seed=0,
                                          device=device),
                AdamWConfig(total_steps=STEPS,
                            warmup_steps=max(STEPS // 10, 1)),
                TrainConfig(total_steps=STEPS, ckpt_dir=d, strategy="shrink",
                            n_nodes=2, ranks_per_node=4, spare_nodes=0,
                            mitigate=mitigate, seed=0, device=device),
                injector=None if twin else ScenarioInjector(sc))
            t0 = time.monotonic()
            reset_launches()
            res = tr.run()
            if device == "cuda":
                torch.cuda.synchronize()
            for k, n in launch_counts().items():
                launches[name][k] += n
            wall = time.monotonic() - t0
            got = [(r.world_after, r.rollback_step) for r in res["reports"]]
            print(f"[train] {tag}: {wall:.1f} s, world {tr.n_ranks}, "
                  f"reports (world_after, rollback_step) {got}, stragglers "
                  f"by rank {sorted(res['stragglers_by_rank'])}, recovery "
                  f"total_s {[round(r.total_s, 4) for r in res['reports']]}")
            if res["final_step"] != STEPS:
                fail(f"{tag}: final_step {res['final_step']}")
            if got != ([] if twin else want):
                fail(f"{tag}: reports {got}, expected {want}")
            if not twin and mitigate and set(res["stragglers_by_rank"]) != {1}:
                fail(f"{tag}: stragglers {res['stragglers_by_rank']}")
            out[twin] = final_digests(d)
            shutil.rmtree(d)
        if out[False] != out[True]:
            fail(f"{name}: final state differs from the fault-free twin")
        print(f"[train] {name}: final state bit-identical to its twin "
              f"({len(out[True]['digests'])} leaves); launches "
              f"{launches[name]}")
    return launches


#: [train-families]: (path, arch, depth, strategy, fault). Published
#: width, vocabulary and heads with only the depth cut (None: `reduced`)
TRAIN_FAMILIES = (
    ("train-olmoe-1b-7b", "olmoe-1b-7b", 2, "reinit", "process"),
    ("train-falcon-mamba-7b", "falcon-mamba-7b", 2, "cr", "node"),
    ("train-zamba2-7b", "zamba2-7b", 7, "reinit", "process"),
    ("train-llava-next-34b", "llava-next-34b", None, "reinit", "process"),
)
#: a run of 5 steps with a save every 3 writes one save (step 3): a save
#: of several GB is most of a run's time. The fault at the top of step 4
#: rolls back to step 3's save, and step 4 is done again
FAMILY_STEPS, FAMILY_CKPT_EVERY, FAMILY_FAIL_STEP = 5, 3, 4
#: [train-strategies]: (strategy, fault kind) on [train]'s paper-demo run
TRAIN_STRATEGIES = (("ulfm", "process"), ("ulfm", "node"),
                    ("replica", "process"), ("replica", "node"))


def state_digests(state) -> dict:
    """Leaf digests of a state in memory: `final_digests`' of a save of
    it (the same keys and wordsum digests, K2's on the card)."""
    from repro_torch.checkpoint.manifest import flatten_leaves, leaf_digest
    return {"step": int(state["step"]),
            "digests": {k: leaf_digest(v)
                        for k, v in flatten_leaves(state).items()}}


def train_run(torch, phase: str, tag: str, trainer) -> dict:
    """Draw `trainer`'s state, check that the disk holds the run's saves
    (fails if not), run it timing each save, remove its checkpoint
    directory; print and return what the run measured, with the final
    state's digests (taken after the launches are read)."""
    from repro_torch.tree import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    trainer.state = trainer.init_state()
    tc = trainer.tc
    nparams = sum(t.numel() for t in tree_leaves(trainer.state["params"]))
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(trainer.state))
    free = shutil.disk_usage(WORK).free
    # the newest `keep` saves stay, and one more until the next is written
    need = min(tc.total_steps // tc.ckpt_every,
               trainer.file_ckpt.keep + 1) * nbytes
    if free < need:
        fail(f"{tag}: {free} bytes free on the disk, the run's saves need "
             f"{need}")
    saves = []
    save = trainer._save_ckpt

    def timed_save(step):
        t0 = time.monotonic()
        save(step)
        torch.cuda.synchronize()
        saves.append(time.monotonic() - t0)

    trainer._save_ckpt = timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    reset_launches()
    try:
        res = trainer.run()
    finally:
        del trainer._save_ckpt          # no cycle keeps the state alive
    torch.cuda.synchronize()
    launches = launch_counts()
    wall = time.monotonic() - t0
    steps = sorted(l.seconds for l in trainer.logs)
    reps = [{"detect_s": r.detect_s, "mpi_recovery_s": r.mpi_recovery_s,
             "ckpt_read_s": r.ckpt_read_s, "total_s": r.total_s,
             "rollback_step": r.rollback_step} for r in res["reports"]]
    print(f"[{phase}] {tag}: {wall:.1f} s; {nparams} parameters, state "
          f"{nbytes} B; disk free before {free} B; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; median step "
          f"{steps[len(steps) // 2] * 1e3:.1f} ms (min {steps[0] * 1e3:.1f},"
          f" {len(steps)} steps); saves {[round(s, 3) for s in saves]} s; "
          f"first_loss {res['losses'][0]:.4f} last_loss "
          f"{res['losses'][-1]:.4f}; recoveries {reps}")
    out = {"final_step": res["final_step"], "last_loss": res["losses"][-1],
           "rollbacks": [r["rollback_step"] for r in reps],
           "launches": launches, "digests": state_digests(trainer.state)}
    shutil.rmtree(tc.ckpt_dir)
    return out


def phase_train_families(torch) -> dict:
    """Phase 4d [train-families]: the trainer through the API on the moe,
    ssm, hybrid and vlm families (TRAIN_FAMILIES): olmoe-1b-7b,
    falcon-mamba-7b and zamba2-7b at published width with the depth cut,
    llava-next-34b reduced; batch 8 x seq 256, bf16 compute, float32
    parameters, full saves (K2). Each model's fault run must roll back to
    the save before the fault and end on its fault-free twin's final
    state bit for bit (every leaf's digest) and loss. Returns {path:
    kernel launches over its two runs}."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import ScenarioInjector
    from repro_torch.models.model import Model
    from repro_torch.scenarios import Fault, Scenario, Topology
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)
    phase = "train-families"
    print(f"[{phase}] depth cut: olmoe-1b-7b 2 of 16 layers, falcon-mamba-7b "
          f"2 of 64, zamba2-7b 7 of 81 (one group of 6 Mamba2 layers with "
          f"its shared attention block, and one tail layer), so that five "
          f"copies of the float32 state (parameters and AdamW moments: the "
          f"live state, the memory checkpoint's pair and a save's two new "
          f"clones) fit the card's 80 GB; llava-next-34b reduced (d_model "
          f"64): one of its layers at published width is 1.475 B "
          f"parameters, 17.7 GB of state, 88 GB in five copies. "
          f"{FAMILY_STEPS} steps, a save every {FAMILY_CKPT_EVERY} (one "
          f"save a run), the fault at the top of step {FAMILY_FAIL_STEP}")
    launches = {}
    for path, arch, depth, strategy, kind in TRAIN_FAMILIES:
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=depth) if depth else reduced(cfg)
        sc = Scenario(name=path, steps=FAMILY_STEPS,
                      topology=Topology(nodes=2, ranks_per_node=4, spares=1),
                      faults=(Fault("node" if kind == "node" else "rank", 3,
                                    FAMILY_FAIL_STEP),),
                      strategies=(strategy,))
        print(f"[{phase}] {path}: {cfg.name}, {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, param_count "
              f"{cfg.param_count()}; {strategy}, a {kind} fault")
        runs = {}
        for twin in (False, True):
            tag = f"{path}-{'twin' if twin else 'fault'}"
            runs[twin] = train_run(torch, phase, tag, Trainer(
                Model(cfg), TokenPipeline(cfg.vocab_size, 8, 256, seed=0),
                AdamWConfig(total_steps=FAMILY_STEPS, warmup_steps=1),
                TrainConfig(total_steps=FAMILY_STEPS,
                            ckpt_dir=os.path.join(WORK, tag),
                            ckpt_every=FAMILY_CKPT_EVERY, strategy=strategy,
                            seed=0),
                injector=None if twin else ScenarioInjector(sc)))
        fault, twin = runs[False], runs[True]
        if {fault["final_step"], twin["final_step"]} != {FAMILY_STEPS}:
            fail(f"{path}: final steps {fault['final_step']}, "
                 f"{twin['final_step']}")
        want = FAMILY_FAIL_STEP - FAMILY_FAIL_STEP % FAMILY_CKPT_EVERY
        if fault["rollbacks"] != [want] or twin["rollbacks"]:
            fail(f"{path}: rollbacks {fault['rollbacks']} and "
                 f"{twin['rollbacks']}, expected [{want}] and []")
        if fault["digests"] != twin["digests"] \
                or fault["last_loss"] != twin["last_loss"]:
            diff = sorted(k for k, v in twin["digests"]["digests"].items()
                          if fault["digests"]["digests"].get(k) != v)
            fail(f"{path}: the final state differs from the fault-free "
                 f"twin's in {diff}, last losses {fault['last_loss']} and "
                 f"{twin['last_loss']}")
        launches[path] = {k: fault["launches"][k] + twin["launches"][k]
                          for k in fault["launches"]}
        print(f"[{phase}] {path}: final state bit-identical to its twin "
              f"({len(twin['digests']['digests'])} leaves); launches "
              f"{launches[path]}")
    return launches


def phase_train_strategies(torch, twin: dict) -> dict:
    """Phase 4e [train-strategies]: [train]'s paper-demo run (full width,
    batch 8 x seq 256, STEPS steps, a full save every step, the fault
    drawn by FaultInjector seed 0) through the API under ulfm and replica,
    each with a process and a node fault. Fault-free training does not
    depend on the strategy (tests/test_torch_train_families.py), so each
    final state is held bit for bit to `twin`, the digests of [train]'s
    reinit twin's last save; each must resume at the fail step (replica
    by promoting its warm shadow). Returns {path: kernel launches}."""
    from repro_torch.configs import get_config
    from repro_torch.core import FailureType, FaultInjector
    from repro_torch.models.model import Model
    from repro_torch.train import (AdamWConfig, TokenPipeline, TrainConfig,
                                   Trainer)
    phase = "train-strategies"
    cfg = get_config("paper-demo")
    launches = {}
    for strategy, kind in TRAIN_STRATEGIES:
        path = f"train-{strategy}-{kind}"
        inj = FaultInjector(n_ranks=8, n_steps=STEPS, seed=0,
                            kind=FailureType.NODE if kind == "node"
                            else FailureType.PROCESS)
        out = train_run(torch, phase, path, Trainer(
            Model(cfg), TokenPipeline(cfg.vocab_size, 8, 256, seed=0),
            AdamWConfig(total_steps=STEPS, warmup_steps=max(STEPS // 10, 1)),
            TrainConfig(total_steps=STEPS, ckpt_dir=os.path.join(WORK, path),
                        strategy=strategy, seed=0),
            injector=inj))
        if out["final_step"] != STEPS:
            fail(f"{path}: final_step {out['final_step']}")
        if out["rollbacks"] != [inj.fail_step]:
            fail(f"{path}: rollbacks {out['rollbacks']}, expected "
                 f"[{inj.fail_step}] (the fail step)")
        if out["digests"] != twin:
            diff = sorted(k for k, v in twin["digests"].items()
                          if out["digests"]["digests"].get(k) != v)
            fail(f"{path}: the final state differs from [train]'s reinit "
                 f"twin's in {diff}")
        launches[path] = out["launches"]
        print(f"[{phase}] {path}: fail step {inj.fail_step}, final state "
              f"bit-identical to [train]'s reinit twin "
              f"({len(twin['digests'])} leaves); launches {out['launches']}")
    return launches


# the runtime's deployment: the reference root's defaults (2 nodes x 4
# ranks + 1 spare node, 20 steps, dim 4096: w is 128 MiB of float64)
RT_TOPOLOGY = (2, 4, 1)
RT_STEPS = 20
RT_DIM = 4096
RT_FAIL_RANK = 1           # on node0; fenced at step steps // 2


class MemoryUsed:
    """Samples the card's memory in use (`nvidia-smi --query-gpu=
    memory.used`, MiB) in a thread: the first sample and the largest."""

    def __init__(self, period: float = 1.0):
        self.base_used = self.peak_used = 0
        self._stop = threading.Event()
        self._period = period
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            used = int(subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split()[0])
            if not self.base_used:
                self.base_used = used          # before any worker started
            self.peak_used = max(self.peak_used, used)
            self._stop.wait(self._period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def phase_runtime(device: str = "cuda", topology=RT_TOPOLOGY,
                  steps: int = RT_STEPS, dim: int = RT_DIM) -> dict:
    """Phase 5b: the port's real-process runtime (root, daemons and
    worker processes, each worker's state on the card), through
    `run_real`: fault-free, reinit and cr under a process and a node
    failure at the root's default deployment, then one shrink and one
    replica catalog cell at the same dim. Each fault run must give the
    oracle's resume steps and its fault-free twin's per-rank checksums
    bit for bit, and every worker must have launched K1. Returns
    {run name: K1-K3 launches summed over the run's workers}."""
    from repro_torch.scenarios import Fault, Scenario, Topology
    from repro_torch.scenarios.catalog import BY_NAME, fault_free
    from repro_torch.scenarios.engine import run_real

    nodes, rpn, spares = topology
    topo = Topology(nodes=nodes, ranks_per_node=rpn, spares=spares)
    rank, step = RT_FAIL_RANK, steps // 2
    deployed = {f"{strategy}-{target}": (Scenario(
        name=f"{strategy}-{target}", topology=topo, steps=steps, dim=dim,
        faults=(Fault("node" if target == "node" else "rank", rank, step),),
        strategies=(strategy,)), strategy)
        for strategy in ("reinit", "cr") for target in ("process", "node")}
    cells = {name: (dataclasses.replace(BY_NAME[name], dim=dim), strategy)
             for name, strategy in (("shrink-then-growback", "shrink"),
                                    ("replica-promote", "replica"))}
    ff_cache: dict = {}
    launches, rec = {}, {}

    def run(name, sc, strategy):
        t0 = time.monotonic()
        out = run_real(sc, strategy, os.path.join(WORK, "runtime", name),
                       timeout=600, device=device)
        wall = time.monotonic() - t0
        workers = out.detail["report"].get("workers", {})
        lc = {k: 0 for k in launch_counts()}
        for w in workers.values():
            for k, n in w["launches"].items():
                lc[k] = lc.get(k, 0) + n
        starts = {r: w["startup"] for r, w in workers.items()}
        fresh = [w["startup"] for w in workers.values() if w["restarted"]]
        ev = out.detail["events"]
        print(f"[runtime] {name} ({strategy}): {wall:.1f} s wall, total_s "
              f"{out.total_s:.3f}, resume steps {out.resume_steps}, events "
              + json.dumps([{k: e[k] for k in (
                  "kind", "detected_by", "mpi_recovery_s", "join_release_s",
                  "rejoin_barrier_s", "promote_complete_s", "world_after")
                  if k in e} for e in ev]))
        k1 = {r: w["launches"]["tile_checksums"]
              for r, w in sorted(workers.items())}
        parts = ("import_s", "context_s", "state_s", "kernel_lib_s",
                 "warm_s", "ready_s")
        up = {r: [round(v[k], 3) for k in parts]
              for r, v in sorted(starts.items())}
        print(f"[runtime] {name}: K1 launches by rank {k1}; start-up s "
              f"(import, context, w, kernel lib, warm step, ready) by rank "
              f"{up}")
        if len(workers) != len(out.checksums) or not workers:
            fail(f"runtime {name}: {len(workers)} workers reported for "
                 f"{len(out.checksums)} checksums")
        idle = sorted(r for r, w in workers.items()
                      if w["launches"]["tile_checksums"] <= 0)
        if device == "cuda" and idle:
            fail(f"runtime {name}: K1 never launched in ranks {idle}")
        want = [e for e in out.expected_resume if e is not None]
        if out.resume_steps != want or not out.resume_consistent:
            fail(f"runtime {name}: resume {out.resume_steps}, oracle "
                 f"{out.expected_resume}")
        launches[f"runtime-{name}"] = lc
        rec[name] = {"mpi_recovery_s": [e.get("mpi_recovery_s") for e in ev],
                     "total_s": out.total_s, "fresh": fresh}
        return out

    def twin(sc):
        key = (sc.topology, sc.steps, sc.dim)
        if key not in ff_cache:
            ff = fault_free(sc.topology, steps=sc.steps, dim=sc.dim)
            out = run(f"fault-free-{sc.topology.nodes}x"
                      f"{sc.topology.ranks_per_node}+"
                      f"{sc.topology.spares}-{sc.steps}", ff, "reinit")
            if out.n_recoveries:
                fail("runtime: the fault-free run recovered")
            ff_cache[key] = out.checksums
        return ff_cache[key]

    mem = MemoryUsed()
    with mem if device == "cuda" else contextlib.nullcontext():
        for name, (sc, strategy) in {**deployed, **cells}.items():
            ff = twin(sc)
            out = run(name, sc, strategy)
            if out.n_recoveries < 1:
                fail(f"runtime {name}: no recovery happened")
            if out.checksums != ff:
                fail(f"runtime {name}: per-rank checksums differ from the "
                     "fault-free run's")
            print(f"[runtime] {name}: {len(ff)} per-rank checksums "
                  "bit-identical to the fault-free run")
    shutil.rmtree(os.path.join(WORK, "runtime"), ignore_errors=True)
    for kind in ("process", "node"):
        r = rec[f"reinit-{kind}"]["mpi_recovery_s"][0]
        c = rec[f"cr-{kind}"]["mpi_recovery_s"][0]
        print(f"[runtime] {kind} failure: mpi_recovery_s reinit {r:.3f}, cr "
              f"{c:.3f}, reinit/cr {r / c:.2f}, cr/reinit {c / r:.2f}x; "
              f"total_s reinit "
              f"{rec[f'reinit-{kind}']['total_s']:.3f}, cr "
              f"{rec[f'cr-{kind}']['total_s']:.3f}")
    fresh = rec["reinit-process"]["fresh"]
    if fresh:
        f = fresh[0]
        print(f"[runtime] a re-spawned worker (reinit, process failure): "
              f"import {f['import_s']:.3f} s, CUDA context "
              f"{f['context_s']:.3f} s, w on the card {f['state_s']:.3f} s, "
              f"kernel library {f['kernel_lib_s']:.3f} s, warm step "
              f"{f['warm_s']:.3f} s, ready to register {f['ready_s']:.3f} s "
              f"after its module started; allocator reserve "
              f"{f.get('reserved_mib', 0):.0f} MiB")
    if device == "cuda":
        print(f"[runtime] device memory: the card's memory.used "
              f"{mem.base_used} MiB before the runs, {mem.peak_used} MiB "
              f"at its peak")
    return launches


def phase_sparse_dirt(torch, ops) -> dict:
    """Phase 4: delta saves of the full train state with 5 % dirt.
    Returns the kernel launches of the three saves."""
    from repro_torch.checkpoint import FileCheckpointer, flatten_leaves
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import adamw_init
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = Model(get_config("paper-demo")).init(gen)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    state_bytes = sum(v.nbytes for v in flatten_leaves(state).values())

    def mutate(tree, step, frac=0.05):
        if isinstance(tree, dict):
            return {k: mutate(v, step, frac) for k, v in tree.items()}
        flat = tree.reshape(-1).clone()
        n = flat.numel()
        if n < 2 or not flat.is_floating_point():
            return tree
        w = max(1, int(n * frac))
        start = (step * w) % max(1, n - w)
        flat[start:start + w] += 1.0
        return flat.reshape(tree.shape)

    d = os.path.join(WORK, "sparse")
    ck = FileCheckpointer(d, n_shards=4, delta_every=4, keep=4)
    launches = {k: 0 for k in launch_counts()}
    for step in (1, 2, 3):
        if step > 1:
            state = mutate(state, step)
        t0 = time.monotonic()
        reset_launches()
        ck.save(step, state)
        torch.cuda.synchronize()
        for k, n in launch_counts().items():
            launches[k] += n
        w = ck.last_write
        print(f"[sparse] save {step}: {w['kind']}, {time.monotonic() - t0:.2f}"
              f" s, d2h_bytes / state_bytes = "
              f"{w['d2h_bytes'] / state_bytes:.4f}")
        if step > 1 and w["kind"] != "delta":
            fail("a 5 %-dirty save did not write a delta")
    man, loaded = ck.load(3, verify=True)
    flat = flatten_leaves(state)
    got = flatten_leaves(loaded)
    for k, v in flat.items():
        if not torch.equal(torch.from_numpy(got[k].copy()).to("cuda"), v):
            fail(f"sparse-dirt chain restored {k} wrong")
    print(f"[sparse] chain full+2 deltas loaded and verified "
          f"({len(flat)} leaves, {state_bytes} bytes)")
    ck.close()
    shutil.rmtree(d)
    print(f"[sparse] launches {launches}")
    return launches


def sass_functions(so: str) -> dict:
    """{kernel function: [its instructions, as "OPCODE.MODS operands"]}
    of the built library's SASS (`cuobjdump -sass`), predicates dropped."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    fns: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            fns[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(.*?)\s*;", line)
        if m and fn is not None:
            fns[fn].append(m[1])
    return fns


def sass_counts(instructions: list, ops: tuple) -> dict:
    """{instruction: count} of the instructions that are one of `ops` (as
    "HGMMA", "MUFU.EX2") with any modifiers."""
    counts: dict = {}
    for ins in instructions:
        name = ins.split()[0]
        if any(name == op or name.startswith(op + ".") for op in ops):
            counts[name] = counts.get(name, 0) + 1
    return counts


def check_tensor_cores(so: str) -> None:
    """F1's bf16 kernel must run on the tensor cores: count its warpgroup
    (HGMMA) and warp (HMMA) matrix instructions in the built library's
    SASS, and fail if there are none."""
    counts: dict = {}
    for instructions in sass_functions(so).values():
        for name, n in sass_counts(instructions, ("HGMMA", "HMMA")).items():
            counts[name] = counts.get(name, 0) + n
    print(f"[build] flash_attention SASS: tensor-core instructions {counts}")
    if not counts:
        fail("F1's library holds no HGMMA or HMMA instruction")


def check_scan_build(kernels) -> float:
    """Every S1 kernel (one per state size and copy width) must hold
    MUFU.EX2 (its exps) and SHFL.BFLY (the xor tree that sums y over a
    channel's lanes) in its SASS. Print each one's registers a thread,
    resident warps an SM (as the runtime reports them) and SASS
    instructions per exp in its step loop (from the first MUFU.EX2 to the
    last: the unrolled steps of a whole and of a last chunk, one exp per
    state and step). Return that count for the main path's kernel (ds 16,
    16 B copies)."""
    fns = {}
    for fn, instructions in sass_functions(kernels.info["path"]).items():
        m = re.search(r"selective_scan_fwdILi(\d+)ELb([01])E", fn)
        if m:
            fns[(int(m[1]), int(m[2]))] = instructions
    if len(fns) != 6:
        fail(f"S1's library holds {len(fns)} scan kernels, not 6")
    lib = kernels.lib()
    per_exp = {}
    for (ds, vec), instructions in sorted(fns.items()):
        by_op = sass_counts(instructions, ("MUFU.EX2", "SHFL.BFLY"))
        if not by_op.get("MUFU.EX2") or not by_op.get("SHFL.BFLY"):
            fail(f"S1 (ds {ds}) lacks MUFU.EX2 or SHFL.BFLY in its SASS")
        exps = [i for i, ins in enumerate(instructions)
                if ins.startswith("MUFU.EX2")]
        per_exp[(ds, vec)] = (exps[-1] - exps[0] + 1) / len(exps)
        regs, warps = ctypes.c_int(), ctypes.c_int()
        kernels.check(lib.rt_selective_scan_occupancy(
            ds, vec, ctypes.byref(regs), ctypes.byref(warps)),
            "selective_scan occupancy")
        print(f"[build] selective_scan ds {ds}, {16 if vec else 4} B copies: "
              f"{regs.value} registers a thread, {warps.value} resident "
              f"warps an SM; SASS {by_op}, {len(instructions)} instructions, "
              f"{per_exp[(ds, vec)]:.2f} a state and step in the step loop")
    return per_exp[(16, 1)]


# [dryrun]: the production cells traced on the card's host, and the
# world-1 prefill held against the same prefill run on the card
DRYRUN_CELLS = (("qwen2-7b", "decode_32k", {}),
                ("seamless-m4t-medium", "train_4k",
                 {"microbatches": 4, "with_buddy": True}))
DRYRUN_PREFILL = ("qwen2-7b", 512, 4)      # arch, S, B
#: each kernel's launches on each path as recorded on an NVIDIA H100
#: before F1 and S1 became torch operators (zeros left out; the runtime
#: paths are the nine runs of `phase_runtime`): the bindings change none
PINNED_LAUNCHES = {
    "tile_checksums": {"cr-node-delta4": 420, "sparse-dirt": 105,
                       "runtime-fault-free-2x4+1-20": 160,
                       "runtime-reinit-process": 150,
                       "runtime-reinit-node": 120,
                       "runtime-cr-process": 80, "runtime-cr-node": 80,
                       "runtime-fault-free-2x2+0-7": 28,
                       "runtime-shrink-then-growback": 28,
                       "runtime-fault-free-2x2+1-6": 24,
                       "runtime-replica-promote": 21},
    "checksum_words": {"reinit-process-full": 420, "sharded-train": 420,
                       "shrink-node-full": 420, "gray-slow-drain": 420},
    "gather_tiles": {"sparse-dirt": 66},
    "flash_attention": {"sharded-serve": 84, "serve-qwen2-7b": 84,
                        "serve-cluster-paper-demo": 480,
                        "serve-zamba2-7b": 39, "serve-olmoe-1b-7b": 48,
                        "serve-seamless-m4t-medium": 72,
                        "serve-llava-next-34b": 32},
    "selective_scan": {"serve-falcon-mamba-7b": 192},
}
PINNED_PATHS = (
    "reinit-process-full", "cr-node-delta4", "sharded-train",
    "shrink-node-full", "gray-slow-drain", "sparse-dirt",
    "runtime-fault-free-2x4+1-20", "runtime-reinit-process",
    "runtime-reinit-node", "runtime-cr-process", "runtime-cr-node",
    "runtime-fault-free-2x2+0-7", "runtime-shrink-then-growback",
    "runtime-fault-free-2x2+1-6", "runtime-replica-promote",
    "sharded-serve", "serve-qwen2-7b", "serve-cluster-paper-demo",
    "serve-falcon-mamba-7b", "serve-zamba2-7b", "serve-olmoe-1b-7b",
    "serve-seamless-m4t-medium", "serve-llava-next-34b")
#: the first tokens [serve-encdec] and [serve-vlm] printed on an NVIDIA
#: H100 before the bindings, per prompt group
PINNED_FIRST_TOKENS = {
    "serve-encdec": [[120936, 34337, 120040, 11750],
                     [135284, 13464, 12183, 252193]],
    "serve-vlm": [[29432, 39708], [10027, 10666]],
}
#: `transcript_digest` of each serving path's transcripts on an NVIDIA
#: H100 under the code before the bindings (run beside this code in one
#: call)
PINNED_TRANSCRIPTS = {
    "serve": "f7f3a138282ea285", "serve-cluster": "222582601d861807",
    "serve-encdec": "13eb30ea04d62719", "serve-hybrid": "e26bbc247672e362",
    "serve-moe": "ab13dadebb44092e", "serve-ssm": "02d569a65e8ddcd0",
    "serve-vlm": "ba921a9b5cd84222"}
#: F1's and S1's host issue ms a call through their wrappers alone, as
#: read before the bindings (PERF.md section 6)
WRAPPER_HOST_MS = {"flash_attention": 0.0359, "selective_scan": 0.0308}


def phase_dryrun(torch, rows: dict, by_path: dict, seen: set) -> dict:
    """Phase 10 [dryrun]: (1) `launch.dryrun.run_cell` traces the
    production cells of DRYRUN_CELLS on fake tensors under a fake world of
    256 on this host (torch's own version; no card touched by the trace),
    each failing if it raises or reads zero collective bytes, argument
    bytes or analytic FLOPs; (2) qwen2-7b's prefill of S 512 x 4 is traced
    at world 1 (a (1, 1) mesh, bf16 parameters, pallas) and run for real
    on the card under `FlopCounterMode`: the FLOPs must be equal (F1 by its
    formula in both), F1 must launch once a layer, and the traced argument
    bytes must be the real parameters' and tokens' bytes; the traced peak
    (argument + temp) is printed beside the real call's peak memory; (3)
    the bindings: every earlier path's launches and every serving path's
    transcripts as pinned before the bindings, and F1's and S1's host issue
    time through their torch operators beside the wrapper's. Returns the
    real prefill's launches; `seen` gets F1's cases in it."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ExecConfig
    from repro_torch.tree import tree_leaves
    tag = "dryrun"

    def show(r):
        mem, coll, an = r["memory"], r["collective_bytes"], r["analytic"]
        print(f"[{tag}] {r['arch']} x {r['shape']} x {r['mesh']} "
              f"({r['chips']} chips, tensors on {r['device']}): trace "
              f"{r['trace_s']:.1f} s; memory a device {json.dumps(mem)}; "
              f"collectives a device {json.dumps(coll)}; FLOPs a device "
              f"{r['cost_analysis']['flops_per_device']:.4g}, bytes a "
              f"device {r['cost_analysis']['bytes_per_device']:.4g}; "
              f"analytic FLOPs {an['flops_total']:.4g} in all "
              f"({an['flops_total'] / r['chips']:.4g} a chip), model "
              f"FLOPs {an['model_flops']:.4g}")

    for arch, shape, kw in DRYRUN_CELLS:
        ec = ExecConfig(microbatches=kw.get("microbatches", 4))
        r = run_cell(arch, shape, False, ec=ec,
                     with_buddy=kw.get("with_buddy", False))
        show(r)
        if not (r["collective_bytes"]["total"] and r["memory"][
                "argument_bytes"] and r["analytic"]["flops_total"]):
            fail(f"{arch} x {shape}: the dry run read zero collective "
                 f"bytes, argument bytes or analytic FLOPs")

    arch, S, B = DRYRUN_PREFILL
    ec = ExecConfig(attn_impl="pallas")
    r = run_cell(arch, ShapeConfig("chip_prefill", S, B, "prefill"), False,
                 ec=ec, mesh_shape=(1, 1))
    show(r)
    cfg = get_config(arch).replace(param_dtype="bfloat16")
    model = Model(cfg, ec)
    params = model.init(torch.Generator(device="cuda").manual_seed(7))
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         generator=torch.Generator(device="cuda")
                         .manual_seed(8), device="cuda")
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(params)) + toks.numel() * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with FlopCounterMode(display=False) as fc, torch.no_grad(), \
            recording_flash_shapes(seen):
        logits, _ = model.prefill(params, {"tokens": toks}, max_len=S)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    real = fc.get_total_flops()
    traced = r["cost_analysis"]["flops_per_device"]
    mem = r["memory"]
    traced_peak = mem["argument_bytes"] + mem["temp_bytes"]
    print(f"[{tag}] {arch} prefill S {S} x {B} at world 1: traced FLOPs "
          f"{traced}, the real run's (FlopCounterMode) {real}; F1 launched "
          f"{launches['flash_attention']} times; argument bytes traced "
          f"{mem['argument_bytes']}, real parameters and tokens {nbytes}; "
          f"traced peak (argument + temp) {traced_peak} B, the real call's "
          f"max_memory_allocated {peak} B, traced / real "
          f"{traced_peak / peak:.4f}")
    if not torch.isfinite(logits).all():
        fail(f"{tag}: the real prefill gave non-finite logits")
    if traced != real or real == 0:
        fail(f"{tag}: traced FLOPs {traced} differ from the real run's "
             f"{real}")
    if launches["flash_attention"] != cfg.n_layers:
        fail(f"{tag}: F1 launched {launches['flash_attention']} times, "
             f"expected {cfg.n_layers}")
    if mem["argument_bytes"] != nbytes:
        fail(f"{tag}: traced argument bytes {mem['argument_bytes']} differ "
             f"from the real {nbytes}")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()

    for path in PINNED_PATHS:
        want = {k: PINNED_LAUNCHES[k].get(path, 0) for k in PINNED_LAUNCHES}
        got = {k: by_path[path][k] for k in PINNED_LAUNCHES}
        if got != want:
            fail(f"{tag}: launches on {path} {got}, pinned {want}")
    print(f"[{tag}] launches on all {len(PINNED_PATHS)} earlier paths as "
          f"pinned")
    if FIRST_TOKENS != PINNED_FIRST_TOKENS:
        fail(f"{tag}: first tokens {FIRST_TOKENS}, pinned "
             f"{PINNED_FIRST_TOKENS}")
    print(f"[{tag}] transcripts {json.dumps(TRANSCRIPTS, sort_keys=True)}; "
          f"first tokens of the model-API paths as pinned")
    if TRANSCRIPTS != PINNED_TRANSCRIPTS:
        fail(f"{tag}: transcripts {TRANSCRIPTS}, pinned "
             f"{PINNED_TRANSCRIPTS}")
    op_host_ms(torch, rows)
    return launches


def op_host_ms(torch, rows: dict) -> None:
    """F1's and S1's host issue time a call through their torch operators
    (the model's entry points) beside their wrappers' in the same call,
    at the main shapes; added to their rows of the kernels line."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as ms
    g = torch.Generator(device="cuda").manual_seed(9)
    B, Sq, Sk, H, Hkv, hd = FLASH_SHAPES[FLASH_MAIN]
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, Sk, Hkv, hd), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    b, S, di, ds = SCAN_SHAPES[SCAN_MAIN]
    x = torch.randn((b, S, di), generator=g, device="cuda")
    dt = torch.rand((b, S, di), generator=g, device="cuda") * 0.1
    Bm, Cm = (torch.randn((b, S, ds), generator=g, device="cuda")
              for _ in range(2))
    A = -torch.rand((di, ds), generator=g, device="cuda")
    for name, wrapper, op in (
            ("flash_attention",
             lambda: fa.flash_attention_kernel(q, k, v, causal=True),
             lambda: fa.flash_attention(q, k, v, causal=True)),
            ("selective_scan",
             lambda: ms.selective_scan_kernel(x, dt, Bm, Cm, A),
             lambda: ms.mamba_scan(x, dt, Bm, Cm, A))):
        with torch.no_grad():
            w_ms = timed(wrapper)[1]
            o_ms = timed(op)[1]
            if not all(torch.equal(a, c) for a, c in zip(
                    torch.utils._pytree.tree_leaves(wrapper()),
                    torch.utils._pytree.tree_leaves(op()))):
                fail(f"{name}: the torch operator's output differs from "
                     f"the wrapper's")
        rows[name]["op_host_ms"] = o_ms
        print(f"[dryrun] {name}: host issue {o_ms:.4f} ms a call through "
              f"torch.ops.repro_torch.{name}, {w_ms:.4f} ms through the "
              f"wrapper alone (pinned: {WRAPPER_HOST_MS[name]} ms); "
              f"outputs bit-identical")


def phase_reprolint() -> None:
    """Phase 0: the port's reprolint, `--strict`, on this host's Python."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict"],
        cwd=HERE, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    for line in (proc.stdout + proc.stderr).splitlines():
        if line.startswith("reprolint:"):
            print(f"[reprolint] {line}")
    print(f"[reprolint] exit {proc.returncode} in "
          f"{time.monotonic() - t0:.2f} s")
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        fail("python -m repro_torch.analysis --strict failed")


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.device import set_deterministic
    set_deterministic()              # before CUDA initialises
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.kernels.checksum import _build as cs_build, ops
    from repro_torch.kernels.flash_attention import _build as fa_build
    from repro_torch.kernels.mamba_scan import _build as ms_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[card] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    with phase_time("reprolint"):
        phase_reprolint()

    t0 = time.monotonic()
    builds = {"checksum": cs_build.KERNELS,
              "flash_attention": fa_build.KERNELS,
              "selective_scan": ms_build.KERNELS}
    with ThreadPoolExecutor(len(builds)) as ex:   # one nvcc per source
        list(ex.map(lambda kl: kl.lib(), builds.values()))
    print(f"[build] all kernels in {time.monotonic() - t0:.1f} s")
    for name, kl in builds.items():
        print(f"[build] {name}: {kl.info['seconds']:.1f} s "
              f"({kl.info['path']})")
        for line in kl.info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                print(f"[build] {line.strip()}")

    check_tensor_cores(fa_build.KERNELS.info["path"])
    per_exp = check_scan_build(ms_build.KERNELS)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    with phase_time("kernels"):
        rows = phase_kernels(torch, ops)
    with phase_time("flash"):
        rows["flash_attention"], flash_checked = phase_flash(torch)
    with phase_time("scan"):
        rows["selective_scan"], scan_checked = phase_scan(torch, per_exp)
    with phase_time("device"):
        phase_device_times(torch, ops)

    with phase_time("train"):
        by_path, finals = phase_train(torch, ops)
    with phase_time("sharded-train"):
        by_path["sharded-train"] = phase_sharded_train(
            torch, finals["reinit-process-full"])
    with phase_time("train elastic"):
        by_path.update(phase_train_elastic(torch))
    with phase_time("train-families"):
        by_path.update(phase_train_families(torch))
    with phase_time("train-strategies"):
        by_path.update(phase_train_strategies(
            torch, finals["reinit-process-full"]))
    with phase_time("sparse"):
        by_path["sparse-dirt"] = phase_sparse_dirt(torch, ops)
    gc.collect()
    torch.cuda.empty_cache()         # the workers' memory stands out
    with phase_time("runtime"):
        runtime = phase_runtime()
    by_path.update(runtime)
    shutil.rmtree(WORK, ignore_errors=True)
    flash_seen: set = set()

    def sharded_serve(*args):
        by_path["sharded-serve"] = phase_sharded_serve(
            torch, *args, recording_flash_shapes(flash_seen))

    with phase_time("serve and sharded-serve"):
        by_path["serve-qwen2-7b"] = phase_serve(
            torch, "qwen2-7b", "flash_attention",
            recording_flash_shapes(flash_seen), "serve", then=sharded_serve)
    with phase_time("serve-cluster"):
        by_path["serve-cluster-paper-demo"] = phase_serve_cluster(
            torch, flash_seen)
    scan_seen: set = set()
    with phase_time("serve-ssm"):
        by_path["serve-falcon-mamba-7b"] = phase_serve(
            torch, "falcon-mamba-7b", "selective_scan",
            recording_scan_shapes(scan_seen), "serve-ssm")
    with phase_time("serve-hybrid"):
        by_path["serve-zamba2-7b"] = phase_serve(
            torch, "zamba2-7b", "flash_attention",
            recording_flash_shapes(flash_seen), "serve-hybrid")
    with phase_time("serve-moe"):
        by_path["serve-olmoe-1b-7b"] = phase_serve(
            torch, "olmoe-1b-7b", "flash_attention",
            recording_flash_shapes(flash_seen), "serve-moe")
    with phase_time("serve-encdec"):
        by_path["serve-seamless-m4t-medium"] = phase_serve_encdec(
            torch, flash_seen)
    with phase_time("serve-vlm"):
        by_path["serve-llava-next-34b"] = phase_serve_vlm(torch, flash_seen)
    with phase_time("dryrun"):
        by_path["dryrun-qwen2-7b-prefill"] = phase_dryrun(
            torch, rows, by_path, flash_seen)
    unchecked = sorted(flash_seen - flash_checked)
    if unchecked:
        fail(f"the serving paths gave F1 cases that [flash] did not hold "
             f"against its plain version: {unchecked}")
    print(f"[flash] every case F1 ran on the serving paths was checked: "
          f"{sorted(flash_seen)}")
    unchecked = sorted(scan_seen - scan_checked)
    if unchecked:
        fail(f"the serving path gave S1 cases that [scan] did not hold "
             f"against its plain version: {unchecked}")
    print(f"[scan] every case S1 ran on the serving path was checked: "
          f"{sorted(scan_seen)}")
    # the path each kernel must launch on
    required = {"checksum_words": ["reinit-process-full", "sharded-train",
                                   "shrink-node-full", "gray-slow-drain",
                                   *(p for p, *_ in TRAIN_FAMILIES),
                                   *(f"train-{s}-{k}"
                                     for s, k in TRAIN_STRATEGIES)],
                "tile_checksums": ["cr-node-delta4", *runtime],
                "gather_tiles": ["sparse-dirt"],
                "flash_attention": ["serve-qwen2-7b", "sharded-serve",
                                    "serve-cluster-paper-demo",
                                    "serve-zamba2-7b", "serve-olmoe-1b-7b",
                                    "serve-seamless-m4t-medium",
                                    "serve-llava-next-34b",
                                    "dryrun-qwen2-7b-prefill"],
                "selective_scan": ["serve-falcon-mamba-7b"]}
    for name, paths in required.items():
        for path in paths:
            if by_path[path][name] <= 0:
                fail(f"kernel {name} never launched on the {path} path")

    sources = {"checksum": "src/repro_torch/kernels/checksum/csrc/checksum.cu",
               "flash": "src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
               "scan": "src/repro_torch/kernels/mamba_scan/csrc/"
                       "selective_scan.cu"}
    kernels = {  # name: (source, the TPU kernel it replaces)
        "tile_checksums": (sources["checksum"],
                           "src/repro/kernels/checksum/kernel.py:79"),
        "checksum_words": (sources["checksum"],
                           "src/repro/kernels/checksum/kernel.py:142"),
        "gather_tiles": (sources["checksum"],
                         "src/repro/kernels/checksum/kernel.py:121"),
        "flash_attention": (sources["flash"],
                            "src/repro/kernels/flash_attention/kernel.py:118"),
        "selective_scan": (sources["scan"],
                           "src/repro/kernels/mamba_scan/kernel.py:79"),
    }
    report = [{"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": sum(c[name] for c in by_path.values()),
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               **rows[name]} for name, (src, replaces) in kernels.items()]
    print(f"[time] chip_smoke.py in all: "
          f"{time.monotonic() - T_START:.1f} s")
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
