"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  (a) device: a CUDA device must be present; prints the card's name and
      power limit as nvidia-smi reports them, and the build stamp
      (obs/build.py: torch, CUDA, driver, device);
  (b) build: compiles the six CUDA sources from kubeflow_tpu_torch/csrc
      (one nvcc per source, in parallel) and prints the seconds; for K1,
      K2, K3 (slab and paged), B1, B2 and B3 the registers and spills of
      each kernel from ptxas -v (no spill allowed) and the tensor-core
      instructions in their SASS, where cuobjdump is present (K1, K3, B1,
      B2, B3: wgmma's HGMMA and no mma.sync HMMA; K2 runs on mma.sync);
  (c) kernels: each serving kernel against its plain PyTorch version on
      the card at the Llama-3-8B serving shapes, with the error, the kernel's, the
      plain version's and one PyTorch library call's time (CUDA events,
      after warm-up, weights rotated through copies larger than the L2
      cache), and the bound (bytes at 3.35 TB/s or operations at
      989 TFLOP/s, whichever is larger); K1 at m = 1, 8, 13, 32 and 128;
      K2 also at S_v = 8, at span 200, with every length 0 and with one
      slot far past the others in a longer slab; K3 also at the engine's
      1024-token wave, at 1, 2, 3 and 8 query heads per kv head (hd 64),
      and as a ragged int8 continuation in a longer slab; every K1, K2
      and K3 case launched twice for the same bits; K2's paged mode
      (K2-paged) at B=8, S_v 1 and 4, span 1024 and 2048, block_tokens
      16, 64 and 128, int8 and bf16, over a shuffled table into a pool
      larger than the batch needs with finite junk in block 0: against
      its plain version, launched twice for the same bits, and against
      the slab kernel on the same keys gathered into a slab (the same
      bits), with K2-slab's time at the same shape; K3's paged mode
      (K3-paged) the same way at the serving profiler's prefill probe
      (B=8, S=32, q_offset 2016, 2048 keys) and at the 1024-token wave
      (B=3, q_offset 0, a 2048-key table naming block 0 past the keys
      the rows see), block_tokens 16, 64, 128 and 256, int8 and bf16,
      with K3-slab's time on the gathered keys;
  (d) reference: a small int8 model's prefill, chunked prefill (128
      tokens continued against the first 128 rows dequantized from the
      int8 cache, K3 at q_offset 128), decode and verify logits through
      the kernels against the same functions on the CPU;
  (e) engine: LLMEngine at full Llama-3-8B width (32 layers, random int8
      weights from --seed, int8 KV, 8 slots x 2048, buckets 128/512/1024,
      decode_chunk 8, pipelined decode, every decode chunk a CUDA graph
      replay) warms up (its decode graphs captured, timed) and serves 8
      prompts of 30..1000 tokens x 32 greedy tokens, twice: TTFT, decode
      tokens/s, determinism, no capture in live traffic, and the launch
      count of every kernel during the run (each must be > 0; a graph's
      launches count once per replay);
  (e2) paged engine: PagedLLMEngine over the same weights and settings
      (block_tokens 128 = the gcd of the buckets), warmed up, the same
      burst, twice: with the default pool (the slab's memory, 128 blocks)
      and with 24 blocks, fewer than the burst's 32; each run's greedy
      tokens must equal the slab engine's request by request, the small
      pool must hold at least one prefill, and K2-paged must launch while
      K2-slab does not; TTFT, decode tokens/s, held prefills and the
      pool's peak used blocks;
  (e3) flagship engine: the ISVC configuration (16 slots x 2048, int8
      weights and KV, buckets 128/512/1024, decode_chunk 8, pipelined,
      logprobs_topk 5) over (e)'s weights, a slab LLMEngine and a
      PagedLLMEngine of 128 blocks, each warmed up (seconds and the graph
      pool's memory printed); a burst of 16 prompts (14 of 30..1000
      tokens, and 1500 and 1900 tokens, chunked) with greedy rows,
      seeded-sampled rows (temperature 0.7, top_p 0.9), two penalized
      rows, two rows with a stop sequence taken from a first run's
      output, and one row cancelled once it has 8 tokens, with a chunk in
      flight. It holds: tokens equal row by row between pipelined and
      unpipelined decode and between the slab and the paged engine;
      seeded rows equal across runs and engines; the stop rows cut where
      their sequence first ends the output; the cancelled row a prefix of
      the others, "cancelled"; every logprob finite and <= 0, and a
      greedy row's the top-1 alternative's; graph replays > 0, no capture
      after warmup, K1, K2, K2-paged and K3 launched (K3 at the chunked
      continuation's q_offset 1024 among them); and one chunk's graph
      replay bit for bit the eager body (rows, slot state, KV cache, both
      variants). Prints TTFT mean/max (the chunked rows' too) and decode
      tokens/s; then K3 against its plain version at each continuation
      shape those runs launched it at;
  (f) engine shapes: every kernel again against its plain version, at
      each argument shape the wrappers recorded in (e) (prefill waves,
      decode spans, lm_head rows, the paged engine's K2-paged launches),
      with its times as in (c); then one decode step (slab and paged) as
      a replay of the engine's captured 8-step chunk beside the eager body
      of the same chunk, each with its wall time, the card's busy time by
      kernel family, the replay's span by CUDA events and the idle share,
      and one B=3 x 1024 prefill wave's wall time against the card's busy
      time by kernel family;
  (f2) serving breakdown: training/profiling.py serving_decode_breakdown
      (steps 8, iters 5, span 2048; its chunks are replays of the
      engine's decode graphs) on the slab engine of (e) and on the paged
      engine of (e2), whose slot tables are first filled with a shuffled
      permutation of its pool blocks: the bucket partition, K3-slab
      launched in the slab call and K3-paged (not K3-slab, not K2-slab)
      in the paged call, 32 launches a probe run, and each engine's greedy
      tokens for the burst unchanged after it; both dicts and, from a
      second call under torch.profiler, each kernel family's card-busy
      time beside the probe buckets; the chunk wall, device step,
      host_dispatch_per_step and host fetch/replay of the same traffic
      and breakdown with the eager body beside the graphs'; then K3-paged
      against its plain version at each shape the paged call launched it
      at;
  (g) server: three concurrent /openai/v1/completions requests against
      the port's HTTP server over that engine;
  (h) training kernels: flash-attention forward (B1), dq (B2) and dk/dv
      (B3) against their plain versions at B=2 H=32 D=128 — S=4096
      causal, S=4000 causal with two documents per row, S=1024
      non-causal — the worst row's error over its largest value, a
      repeat launch bit for bit, and kernel, plain, SDPA and bound
      times; then B1 alone: the forward-only q_offset path, D=64, and
      Sq=200 (not a multiple of its 128-row tile), causal and not; then
      B2 and B3 at the edges of their tiles: D=64, S=200 causal and not,
      S=320 causal (a partial 128-key block), each against its plain
      version and launched twice for the same bits;
  (i) train reference: a small bf16 Llama's loss and every grad through
      the kernels on the card against the same function on the CPU;
  (j) trainer: Llama-3-8B width cut to 4 layers, B=2 x S=4096, AdamW,
      6 steps, twice from --seed: loss and grad_norm per step, tokens/s,
      MFU, peak memory, launches of B1-B3 per step (each at least one per
      layer, at the shape (h) timed), the two runs' losses, and one
      step's wall time against the card's busy time;
  (j2) trainer profile window: (j)'s trainer again with profile_dir
      (steps 2 and 3 of 6): PROFILE_DONE and one trace file, and each
      step's time inside and outside the window.
Each phase prints its seconds. The line before the last is
{"kernels": [...]}, each kernel timed at a shape its path launched it at
(the 8B engine run for the serving kernels, the paged engine's run for
K2-paged, the paged serving breakdown for K3-paged, the trainer for
B1-B3); the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --ab OTHER_TREE

compares this tree with another checkout (an unpacked `git archive` of
the parent commit, say) on one card in one call: K1's decode step (the
224 m=8 matmuls and the lm_head of (c)), K2 at B=8 S_v=1 span 1024 int8,
the 8B engine's decode-step breakdown at span 2048 (twice) and its
prefill-wave breakdown, B1-B3 at the trainer's shape, K3 at the engine's
1024-token wave and phase (j), with each tree's own code, in turns
(other, this, this, other), one process each. It prints no result
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs.build import build_stamp
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.ops import flash_decode as fd
from kubeflow_tpu_torch.ops import flash_prefill as fp
from kubeflow_tpu_torch.ops import quant
from kubeflow_tpu_torch.ops import quant_matmul as qm
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.server import CompletionServer
from kubeflow_tpu_torch.training import data as train_data
from kubeflow_tpu_torch.training import mfu
from kubeflow_tpu_torch.training import trainer as train
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
L2_ROTATE_BYTES = 120e6       # working set past the 50 MB L2
SLEEP_CYCLES_PER_CALL = 1_000_000   # ~0.5 ms of card time per queued call
DEV = "cuda"

# K1 shapes of one 8B decode step: (d, o) -> matmuls per layer, plus the
# lm_head once per step with f32 output
K1_LAYER = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2,
            (14336, 4096): 1}
K1_HEAD = (4096, 128256)

SERVING_KERNELS = ("quant_matmul", "flash_decode", "flash_prefill")
PAGED_KERNELS = ("quant_matmul", "flash_decode_paged", "flash_prefill")
TRAINING_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv")

REPLACES = {
    "quant_matmul": "kubeflow_tpu/ops/quant_matmul.py:68",
    "flash_decode": "kubeflow_tpu/ops/flash_decode.py:125",
    "flash_decode_paged": "kubeflow_tpu/ops/flash_decode.py:125",
    "flash_prefill": "kubeflow_tpu/ops/flash_prefill.py:134",
    "flash_prefill_paged": "kubeflow_tpu/ops/flash_prefill.py:134",
    "flash_attn_fwd": "kubeflow_tpu/ops/flash_pallas.py:77",
    "flash_attn_dq": "kubeflow_tpu/ops/flash_pallas.py:229",
    "flash_attn_dkv": "kubeflow_tpu/ops/flash_pallas.py:284",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fns, iters: int) -> float:
    """Device ms per call of fns run round-robin (distinct copies of the
    inputs keep the weights out of L2), after one warm-up pass. A sleep
    kernel holds the card while the host enqueues every call, so the
    events time the card's work, not Python's launch rate."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def n_copies(nbytes: float) -> int:
    return max(1, math.ceil(L2_ROTATE_BYTES / nbytes))


# -- (b) build report -------------------------------------------------------

# the kernels whose build (b) holds to no spill and to wgmma (HGMMA
# present, no mma.sync HMMA); B1 is built on K3's mainloop
WGMMA_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                 "quant_matmul", "flash_prefill")
# ... and those held to no spill alone (K2 runs on mma.sync)
SPILL_KERNELS = WGMMA_KERNELS + ("flash_decode",)
# template arguments in a mangled name: a type by its length-prefixed name
# or one of these codes, or an integer literal
_MANGLED_TYPES = {"a": "int8_t", "f": "float"}
_MANGLED_BOOLS = {"Lb0E": "false", "Lb1E": "true"}


def kernel_name(mangled: str) -> str:
    """`dq_kernel<128>` or `decode_kernel<signed char, 128, 8>` from a
    mangled `..._kernelI...E...` name: the identifier is the one whose
    length prefix matches it."""
    m = re.search(r"_kernelI", mangled)
    if not m:
        return mangled
    end = m.start() + len("_kernel")
    name = None
    for n in range(len("_kernel"), end):
        ident = mangled[end - n:end]
        if mangled[:end - n].endswith(str(n)) and ident[0].isalpha():
            name = ident
            break
    if name is None:
        return mangled
    args, rest = [], mangled[end + 1:]
    while rest and rest[0] != "E":
        lit = re.match(r"Li(\d+)E", rest)
        typ = re.match(r"(\d+)", rest)
        if lit:
            args.append(lit.group(1))
            rest = rest[lit.end():]
        elif rest[:4] in _MANGLED_BOOLS:
            args.append(_MANGLED_BOOLS[rest[:4]])
            rest = rest[4:]
        elif typ:
            n = int(typ.group(1))
            start = typ.end()
            args.append(rest[start:start + n])
            rest = rest[start + n:]
        elif rest[0] in _MANGLED_TYPES:
            args.append(_MANGLED_TYPES[rest[0]])
            rest = rest[1:]
        else:
            return mangled
    return f"{name}<{', '.join(args)}>"


def ptxas_kernels(log: str) -> list[dict]:
    """Each entry function of a -Xptxas -v log: name, registers, spill
    bytes stored and loaded."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append({"name": kernel_name(m.group(1)), "registers": None,
                        "spill_stores": None, "spill_loads": None})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out


def build_report(built: dict) -> None:
    """For B1, B2, B3, K1, K2 and K3 (slab and paged): registers and
    spills of each kernel from the build log (a spill fails the run),
    ptxas's wgmma warnings, and the count of wgmma (HGMMA) and mma.sync
    (HMMA) instructions in the built SASS (for B1, B2, B3, K1 and K3 an
    HMMA, or no HGMMA, fails the run)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in SPILL_KERNELS:
        if name not in built:
            print(f"{name}: library was already built, no ptxas log",
                  flush=True)
        else:
            log = built[name][1]
            for k in ptxas_kernels(log):
                print(f"ptxas {name} {k['name']}: {k['registers']} "
                      f"registers, spill stores {k['spill_stores']} B, "
                      f"spill loads {k['spill_loads']} B", flush=True)
                check(k["spill_stores"] == 0 and k["spill_loads"] == 0,
                      f"{name} {k['name']}: ptxas spilled registers")
            for line in log.splitlines():
                if "wgmma" in line.lower():
                    print(f"ptxas {name}: {line.strip()}", flush=True)
        try:
            sass = subprocess.run([cuobjdump, "-sass",
                                   str(_build._lib_path(name))],
                                  capture_output=True, text=True,
                                  check=True).stdout
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"{name}: no SASS listing ({e})", flush=True)
            continue
        hgmma = len(re.findall(r"\bHGMMA\.", sass))
        hmma = len(re.findall(r"\bHMMA\.", sass))
        print(f"sass {name}: {hgmma} HGMMA, {hmma} HMMA", flush=True)
        if name in WGMMA_KERNELS:
            check(hgmma > 0 and hmma == 0,
                  f"{name}: SASS has {hgmma} HGMMA and {hmma} HMMA")


# -- (c) kernels against their plain versions --------------------------------


def k1_case(gen, m, d, o, out_dtype):
    x = torch.randn(m, d, device=DEV, generator=gen).to(torch.bfloat16)
    w = quant.quantize_int8(torch.randn(d, o, device=DEV, generator=gen)
                            / d ** 0.5)
    got = qm.dequant_matmul(x, w["q"], w["s"], out_dtype)
    again = qm.dequant_matmul(x, w["q"], w["s"], out_dtype)
    ref = qm.dequant_matmul_plain(x, w["q"], w["s"], out_dtype)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K1 m={m} d={d} o={o} {out_dtype}: a "
                                   "second launch gave other bits")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # bf16 output: half an ulp of the largest value per rounding, sums in
    # another order; f32 output: f32 rounding of a d-long sum
    tol = (2 ** -7 if out_dtype == torch.bfloat16 else 1e-5) * scale
    check(math.isfinite(err) and err <= tol,
          f"K1 m={m} d={d} o={o} {out_dtype}: err {err} > {tol}")
    k = n_copies(d * o)
    qs = [w["q"].clone() for _ in range(k)]
    ss = [w["s"].clone() for _ in range(k)]
    wd = [(q.to(torch.bfloat16) * s.to(torch.bfloat16)) for q, s in
          zip(qs, ss)][:n_copies(2 * d * o)]
    ms = time_ms([lambda q=q, s=s: qm.dequant_matmul(x, q, s, out_dtype)
                  for q, s in zip(qs, ss)], 30)
    plain = time_ms([lambda q=q, s=s: qm.dequant_matmul_plain(
        x, q, s, out_dtype) for q, s in zip(qs, ss)], 10)
    lib = time_ms([lambda w=w_: torch.matmul(x, w) for w_ in wd], 30)
    ob = 4 if out_dtype == torch.float32 else 2
    b, by = bound_ms(m * d * 2 + d * o + o * 4 + m * o * ob, 2.0 * m * d * o)
    return dict(err=err, tol=tol, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b, bound_by=by)


def kv_inputs(gen, b, t, nkv, hd, int8, slot_stride=None):
    """K, V (and scales) [b, t, nkv, hd] as views of a slab whose slots are
    slot_stride elements apart, as the engine's cache hands them over."""
    rows = (slot_stride or t * nkv * hd) // (nkv * hd)
    kf = torch.randn(b, rows, nkv, hd, device=DEV, generator=gen)
    vf = torch.randn(b, rows, nkv, hd, device=DEV, generator=gen)
    if int8:
        kq, ks = llama.quantize_kv(kf)
        vq, vs = llama.quantize_kv(vf)
        return kq[:, :t], vq[:, :t], ks[:, :t], vs[:, :t]
    return (kf.to(torch.bfloat16)[:, :t], vf.to(torch.bfloat16)[:, :t],
            None, None)


def slab_copy(x):
    """A copy of a slab view that keeps its strides."""
    if x is None:
        return None
    base = x.new_empty(x.shape[0], x.stride(0) // x[0, 0].numel(),
                       *x.shape[2:])
    out = base[:, :x.shape[1]]
    out.copy_(x)
    return out


def dequant(x, s):
    return x if s is None else (x.float() * s[..., None]).to(torch.bfloat16)


# Attention errors are held per output row (one query position of one
# head) against that row's largest value: bf16 probabilities and output,
# rounded at other places in the two versions, stay within a few bf16 ulps
# of it.
ATTN_ROW_TOL = 2 ** -6
# K3 with int8 K/V: the plain version (the JAX mha path) also rounds the
# dequantized K and V to bf16 before the products, where the kernel keeps
# the scales in f32 as the TPU kernel does; on a row that sees few keys
# the softmax amplifies that rounding past the limit above.
ATTN_ROW_TOL_K3_INT8 = 2 ** -5


def attn_err(got, ref, name, row_tol, grad=False):
    """The max abs error, and the worst row's error over the row's largest
    value, which must be at most row_tol. For a gradient (grad=True) the
    row's largest value is floored at the median row's: a row whose exact
    gradient cancels to about 0 (dq of the first causal row, where dp
    equals delta) holds only rounding residue in both versions."""
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    if grad:
        scale = scale.clamp_min(scale.median())
    err = diff.max().item()
    worst = (diff / scale.clamp_min(1e-30)).max().item()
    check(math.isfinite(err) and worst <= row_tol,
          f"{name}: a row's err is {worst:.4g} of its largest value "
          f"> {row_tol:.4g}")
    return err, worst


def k2_case(gen, s_v, span, int8, b=8, nh=32, nkv=8, hd=128,
            slot_stride=None, lengths="ragged"):
    """K2 against its plain version, a repeat launch bit for bit, and its
    times. lengths: "ragged" (random, the first slot reaching the end of
    the span), "zero" (every slot at position 0) or "one_long" (the first
    slot at the end, the others in its first 100 positions)."""
    q = torch.randn(b, s_v, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    k, v, ks, vs = kv_inputs(gen, b, span, nkv, hd, int8, slot_stride)
    top = {"ragged": span - s_v + 1, "zero": 1, "one_long": 100}[lengths]
    mode = lengths
    lengths = torch.randint(0, top, (b,), device=DEV, generator=gen,
                            dtype=torch.int32)
    if mode != "zero":
        lengths[0] = span - s_v
    kw = dict(k_scale=ks, v_scale=vs)
    got = fd.flash_decode_attention(q, k, v, lengths, **kw)
    again = fd.flash_decode_attention(q, k, v, lengths, **kw)
    ref = fd.flash_decode_plain(q, k, v, lengths, **kw)
    name = f"K2 B={b} S_v={s_v} span={span} int8={int8} lengths={mode}"
    err, worst = attn_err(got, ref, name, ATTN_ROW_TOL)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    elem = 1 if int8 else 2
    kv_bytes = k.numel() * elem * 2 + (ks.numel() * 8 if int8 else 0)
    copies = [tuple(slab_copy(x) for x in (k, v, ks, vs))
              for _ in range(n_copies(kv_bytes))]
    ms = time_ms([lambda c=c: fd.flash_decode_attention(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3])
        for c in copies], 50)
    plain = time_ms([lambda c=c: fd.flash_decode_plain(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3])
        for c in copies], 10)
    # library yardstick: SDPA on the dequantized bf16 cache, [B, kv, T, hd]
    pos = lengths.long()[:, None] + torch.arange(s_v, device=DEV)
    mask = (torch.arange(span, device=DEV)[None, None, None, :]
            <= pos[:, None, :, None])
    qt = q.transpose(1, 2)
    lib_kv = [(dequant(c[0], c[2]).transpose(1, 2).contiguous(),
               dequant(c[1], c[3]).transpose(1, 2).contiguous())
              for c in copies[:n_copies(k.numel() * 4)]]
    lib = time_ms([lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in lib_kv],
        50)
    live = torch.clamp(lengths.long() + s_v, max=span).sum().item()
    nbytes = (live * nkv * hd * elem * 2 + (live * nkv * 8 if int8 else 0)
              + q.numel() * 4 + b * 4)
    b_ms, by = bound_ms(nbytes, 4.0 * live * (nh // nkv) * nkv * s_v * hd)
    return dict(err=err, worst_row=worst, row_tol=ATTN_ROW_TOL, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)


def paged_inputs(gen, b, span, bt, nkv, hd, int8, n_pool=None,
                 lengths=None, s_v=1):
    """A pool of n_pool blocks (by default half again what the batch
    needs) with large finite junk in block 0, ragged lengths (the first
    slot at the end of the span) unless given, and tables [b, span // bt]
    that name a shuffled set of blocks for each slot's live keys and
    block 0 past them, as the engine leaves them."""
    nb = span // bt
    n_pool = n_pool or b * nb * 3 // 2 + 1
    if lengths is None:
        lengths = torch.randint(0, span - s_v + 1, (b,), device=DEV,
                                generator=gen, dtype=torch.int32)
        lengths[0] = span - s_v
    kf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    vf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    kf[0] *= 1e4
    vf[0] *= 1e4
    if int8:
        k, ks = llama.quantize_kv(kf)
        v, vs = llama.quantize_kv(vf)
        ks[0] = vs[0] = 1e4
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    perm = torch.randperm(n_pool - 1, device=DEV, generator=gen) + 1
    live = (lengths.long() + s_v + bt - 1) // bt
    tables = torch.zeros(b, nb, dtype=torch.int32, device=DEV)
    start = 0
    for i, n in enumerate(live.tolist()):
        check(start + n <= n_pool - 1, "paged inputs: pool too small")
        tables[i, :n] = perm[start:start + n].to(torch.int32)
        start += n
    return lengths, k, v, ks, vs, tables


def k2_paged_case(gen, s_v, span, bt, int8, b=8, nh=32, nkv=8, hd=128,
                  n_pool=None):
    """K2-paged against its plain version, a repeat launch bit for bit,
    the slab kernel on the same keys gathered into a slab bit for bit, and
    its times beside K2-slab's on that slab. The library yardstick is
    SDPA on KV already gathered and dequantized: the gather is not
    counted."""
    q = torch.randn(b, s_v, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    lengths, k, v, ks, vs, tables = paged_inputs(gen, b, span, bt, nkv, hd,
                                                 int8, n_pool, s_v=s_v)
    kw = dict(k_scale=ks, v_scale=vs)
    got = fd.flash_decode_attention(q, k, v, lengths, tables=tables, **kw)
    again = fd.flash_decode_attention(q, k, v, lengths, tables=tables, **kw)
    ref = fd.flash_decode_plain(q, k, v, lengths, tables=tables, **kw)
    sk, sv, sks, svs = fd.gather_pages(tables, k, v, ks, vs)
    slab = fd.flash_decode_attention(q, sk, sv, lengths, k_scale=sks,
                                     v_scale=svs)
    name = (f"K2-paged B={b} S_v={s_v} span={span} bt={bt} int8={int8} "
            f"pool={k.shape[0]}")
    err, worst = attn_err(got, ref, name, ATTN_ROW_TOL)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    check(torch.equal(got, slab), f"{name}: other bits than the slab "
                                  "kernel on the same keys")
    elem = 1 if int8 else 2
    pool_bytes = k.numel() * elem * 2 + (ks.numel() * 8 if int8 else 0)
    copies = [tuple(None if x is None else x.clone() for x in (k, v, ks, vs))
              for _ in range(n_copies(pool_bytes))]
    ms = time_ms([lambda c=c: fd.flash_decode_attention(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3], tables=tables)
        for c in copies], 50)
    plain = time_ms([lambda c=c: fd.flash_decode_plain(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3], tables=tables)
        for c in copies], 10)
    slab_bytes = sk.numel() * elem * 2 + (sks.numel() * 8 if int8 else 0)
    slabs = [tuple(None if x is None else x.clone()
                   for x in (sk, sv, sks, svs))
             for _ in range(n_copies(slab_bytes))]
    slab_ms = time_ms([lambda c=c: fd.flash_decode_attention(
        q, c[0], c[1], lengths, k_scale=c[2], v_scale=c[3])
        for c in slabs], 50)
    pos = lengths.long()[:, None] + torch.arange(s_v, device=DEV)
    mask = (torch.arange(span, device=DEV)[None, None, None, :]
            <= pos[:, None, :, None])
    qt = q.transpose(1, 2)
    lib_kv = [(dequant(c[0], c[2]).transpose(1, 2).contiguous(),
               dequant(c[1], c[3]).transpose(1, 2).contiguous())
              for c in slabs[:n_copies(sk.numel() * 4)]]
    lib = time_ms([lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in lib_kv],
        50)
    live = torch.clamp(lengths.long() + s_v, max=span)
    n_live = live.sum().item()
    table_bytes = ((live + bt - 1) // bt).sum().item() * 4
    nbytes = (n_live * nkv * hd * elem * 2 + (n_live * nkv * 8 if int8 else 0)
              + q.numel() * 4 + b * 4 + table_bytes)
    b_ms, by = bound_ms(nbytes, 4.0 * n_live * nh * s_v * hd)
    return dict(err=err, worst_row=worst, row_tol=ATTN_ROW_TOL, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                slab_ms=slab_ms)


def k3_case(gen, s, q_offset, int8, b=2, nh=32, nkv=8, hd=128, t=None,
            slot_stride=None):
    t = q_offset + s if t is None else t
    q = torch.randn(b, s, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    k, v, ks, vs = kv_inputs(gen, b, t, nkv, hd, int8, slot_stride)
    kw = dict(q_offset=q_offset, k_scale=ks, v_scale=vs)
    got = fp.flash_prefill_attention(q, k, v, **kw)
    again = fp.flash_prefill_attention(q, k, v, **kw)
    ref = fp.flash_prefill_plain(q, k, v, **kw)
    row_tol = ATTN_ROW_TOL_K3_INT8 if int8 else ATTN_ROW_TOL
    name = (f"K3 B={b} S={s} H={nh} kv={nkv} hd={hd} q_offset={q_offset} "
            f"int8={int8}")
    err, worst = attn_err(got, ref, name, row_tol)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    ms = time_ms([lambda: fp.flash_prefill_attention(q, k, v, **kw)], 20)
    plain = time_ms([lambda: fp.flash_prefill_plain(q, k, v, **kw)], 5)
    mask = (torch.arange(t, device=DEV)[None, :]
            <= q_offset + torch.arange(s, device=DEV)[:, None])
    kk = dequant(k, ks).transpose(1, 2).contiguous()
    vv = dequant(v, vs).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2)
    lib = time_ms([lambda: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True)], 20)
    elem = 1 if int8 else 2
    # keys summed over rows: row i sees min(t, q_offset + i + 1)
    visible = sum(min(t, q_offset + i + 1) for i in range(s))
    nbytes = (2 * q.numel() * 2 + k.numel() * elem * 2
              + (ks.numel() * 8 if int8 else 0))
    b_ms, by = bound_ms(nbytes, 4.0 * b * nh * hd * visible)
    return dict(err=err, worst_row=worst, row_tol=row_tol, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by)


def k3_paged_case(gen, b, s, q_offset, bt, int8, nb, nh=32, nkv=8, hd=128,
                  n_pool=None):
    """K3-paged against its plain version, a repeat launch bit for bit, the
    slab kernel on the same keys gathered into a slab bit for bit, and its
    times beside K3-slab's on that slab. The pool holds n_pool blocks (by
    default half again what the batch needs) with large finite junk in
    block 0; each slot's table names a shuffled set of blocks for the keys
    its rows can see and block 0 past them, as an engine leaves them. The
    library yardstick is SDPA on KV already gathered and dequantized: the
    gather is not counted."""
    t = nb * bt
    n_keys = min(t, q_offset + s)          # keys the deepest row sees
    live = -(-n_keys // bt)
    n_pool = n_pool or b * nb * 3 // 2 + 1
    q = torch.randn(b, s, nh, hd, device=DEV, generator=gen).to(
        torch.bfloat16)
    kf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    vf = torch.randn(n_pool, bt, nkv, hd, device=DEV, generator=gen)
    kf[0] *= 1e4
    vf[0] *= 1e4
    if int8:
        k, ks = llama.quantize_kv(kf)
        v, vs = llama.quantize_kv(vf)
        ks[0] = vs[0] = 1e4
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    del kf, vf
    check(b * live <= n_pool - 1, "K3-paged inputs: pool too small")
    perm = torch.randperm(n_pool - 1, device=DEV, generator=gen) + 1
    tables = torch.zeros(b, nb, dtype=torch.int32, device=DEV)
    tables[:, :live] = perm[:b * live].reshape(b, live).to(torch.int32)
    kw = dict(q_offset=q_offset, k_scale=ks, v_scale=vs)
    got = fp.flash_prefill_attention(q, k, v, tables=tables, **kw)
    again = fp.flash_prefill_attention(q, k, v, tables=tables, **kw)
    ref = fp.flash_prefill_plain(q, k, v, tables=tables, **kw)
    sk, sv, sks, svs = fd.gather_pages(tables, k, v, ks, vs)
    skw = dict(q_offset=q_offset, k_scale=sks, v_scale=svs)
    slab = fp.flash_prefill_attention(q, sk, sv, **skw)
    row_tol = ATTN_ROW_TOL_K3_INT8 if int8 else ATTN_ROW_TOL
    name = (f"K3-paged B={b} S={s} H={nh} kv={nkv} hd={hd} "
            f"q_offset={q_offset} bt={bt} nb={nb} int8={int8} pool={n_pool}")
    err, worst = attn_err(got, ref, name, row_tol)
    check(torch.equal(got, again), f"{name}: a second launch gave other "
                                   "bits")
    check(torch.equal(got, slab), f"{name}: other bits than the slab "
                                  "kernel on the same keys")
    elem = 1 if int8 else 2
    pool_bytes = k.numel() * elem * 2 + (ks.numel() * 8 if int8 else 0)
    copies = [tuple(None if x is None else x.clone() for x in (k, v, ks, vs))
              for _ in range(n_copies(pool_bytes))]
    ms = time_ms([lambda c=c: fp.flash_prefill_attention(
        q, c[0], c[1], q_offset=q_offset, k_scale=c[2], v_scale=c[3],
        tables=tables) for c in copies], 20)
    plain = time_ms([lambda c=c: fp.flash_prefill_plain(
        q, c[0], c[1], q_offset=q_offset, k_scale=c[2], v_scale=c[3],
        tables=tables) for c in copies[:1]], 5)
    slab_bytes = sk.numel() * elem * 2 + (sks.numel() * 8 if int8 else 0)
    slabs = [tuple(None if x is None else x.clone()
                   for x in (sk, sv, sks, svs))
             for _ in range(n_copies(slab_bytes))]
    slab_ms = time_ms([lambda c=c: fp.flash_prefill_attention(
        q, c[0], c[1], q_offset=q_offset, k_scale=c[2], v_scale=c[3])
        for c in slabs], 20)
    mask = (torch.arange(t, device=DEV)[None, :]
            <= q_offset + torch.arange(s, device=DEV)[:, None])
    qt = q.transpose(1, 2)
    lib_kv = [(dequant(c[0], c[2]).transpose(1, 2).contiguous(),
               dequant(c[1], c[3]).transpose(1, 2).contiguous())
              for c in slabs[:n_copies(sk.numel() * 4)]]
    lib = time_ms([lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qt, kk, vv, attn_mask=mask, enable_gqa=True) for kk, vv in lib_kv],
        20)
    del copies, slabs, lib_kv
    # each row sees min(t, q_offset + i + 1) keys; the bytes are the keys
    # the deepest row sees (and their scales and table entries), q and out
    visible = sum(min(t, q_offset + i + 1) for i in range(s))
    nbytes = (2 * q.numel() * 2 + b * n_keys * nkv * hd * elem * 2
              + (b * n_keys * nkv * 8 if int8 else 0) + b * live * 4)
    b_ms, by = bound_ms(nbytes, 4.0 * b * nh * hd * visible)
    return dict(err=err, worst_row=worst, row_tol=row_tol, ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=by,
                slab_ms=slab_ms)


# K3-paged in (c): the serving profiler's prefill probe on the 8B paged
# engine (B=8 slots, a 32-row chunk at the end of a 2048-key span), and
# the engine's 1024-token wave (B=3) in a 2048-key table whose entries
# past the keys it sees name block 0; each at four block sizes
K3_PAGED_CASES = (
    [dict(b=8, s=32, q_offset=2016, bt=bt, nb=2048 // bt, int8=int8)
     for bt in (16, 64, 128, 256) for int8 in (True, False)]
    + [dict(b=3, s=1024, q_offset=0, bt=bt, nb=2048 // bt, int8=int8)
       for bt in (16, 64, 128, 256) for int8 in (True, False)])


def fmt(case: dict) -> str:
    tol = (f"worst row {case['worst_row']:.3g} of its max, tol "
           f"{case['row_tol']:.3g}" if "row_tol" in case
           else f"tol {case['tol']:.3g}")
    return (f"max_abs_err={case['err']:.3g} ({tol}) "
            f"ms={case['ms']:.4f} plain_ms={case['plain_ms']:.4f} "
            f"library_ms={case['library_ms']:.4f} "
            f"bound_ms={case['bound_ms']:.4f} ({case['bound_by']})"
            + (f" slab_ms={case['slab_ms']:.4f}" if "slab_ms" in case
               else ""))


def kernel_phase(gen) -> dict:
    """Every case of (c); returns K1's entry for the kernels line, one 8B
    decode step (the engine's decode shapes, m = 8 slots)."""
    k1_step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "err": 0.0}
    bytes_step = ops_step = 0.0
    # m = 13 and 128: the kernel's activation tile edge (13 rounds up to
    # 16) and the gate's top
    for m in (1, 8, 13, 32, 128):
        for (d, o) in list(K1_LAYER) + [K1_HEAD]:
            for od in (torch.bfloat16, torch.float32):
                c = k1_case(gen, m, d, o, od)
                print(f"K1 m={m} d={d} o={o} out={od}: {fmt(c)}",
                      flush=True)
                main = (m == 8 and (((d, o) == K1_HEAD
                                     and od == torch.float32)
                                    or ((d, o) in K1_LAYER
                                        and od == torch.bfloat16)))
                if main:   # one 8B decode step at 8 slots
                    mult = 1 if (d, o) == K1_HEAD else 32 * K1_LAYER[d, o]
                    for key in ("ms", "plain_ms", "library_ms"):
                        k1_step[key] += mult * c[key]
                    k1_step["err"] = max(k1_step["err"], c["err"])
                    ob = 4 if od == torch.float32 else 2
                    bytes_step += mult * (m * d * 2 + d * o + o * 4
                                          + m * o * ob)
                    ops_step += mult * 2.0 * m * d * o
    k1_step["bound_ms"], k1_step["bound_by"] = bound_ms(bytes_step,
                                                        ops_step)
    print(f"K1 one decode step (8 slots, 32 layers + lm_head): "
          f"ms={k1_step['ms']:.4f} plain_ms={k1_step['plain_ms']:.4f} "
          f"library_ms={k1_step['library_ms']:.4f} "
          f"bound_ms={k1_step['bound_ms']:.4f}", flush=True)
    for s_v in (1, 4):
        for span in (128, 2048):
            for int8 in (True, False):
                c = k2_case(gen, s_v, span, int8)
                print(f"K2 B=8 S_v={s_v} span={span} int8={int8}: "
                      f"{fmt(c)}", flush=True)
    # S_v = 8 (32 rows a kv head, the kernel's limit); span 200 (a partial
    # 64-key tile); every length 0 (each block's share one tile or none);
    # one slot far past the others in a slab longer than the span
    k2_more = [dict(s_v=8, span=2048, int8=True),
               dict(s_v=8, span=2048, int8=False),
               dict(s_v=1, span=200, int8=True),
               dict(s_v=4, span=200, int8=False),
               dict(s_v=1, span=1024, int8=True, lengths="zero"),
               dict(s_v=4, span=1024, int8=False, lengths="zero"),
               dict(s_v=1, span=600, int8=True, lengths="one_long",
                    slot_stride=2048 * 8 * 128)]
    for kw in k2_more:
        c = k2_case(gen, **kw)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"K2 B=8 {desc}: {fmt(c)}", flush=True)
    for s_v in (1, 4):
        for span in (1024, 2048):
            for bt in (16, 64, 128):
                for int8 in (True, False):
                    c = k2_paged_case(gen, s_v, span, bt, int8)
                    print(f"K2-paged B=8 S_v={s_v} span={span} bt={bt} "
                          f"int8={int8}: {fmt(c)}", flush=True)
    for s in (128, 512):
        for q_offset in (0, 512):
            for int8 in (False, True):
                c = k3_case(gen, s, q_offset, int8)
                print(f"K3 B=2 S={s} q_offset={q_offset} int8={int8}: "
                      f"{fmt(c)}", flush=True)
    # the engine's 1024-token wave; the group sizes 1, 2, 8 (and 3) at hd 64;
    # a ragged int8 continuation in a slab longer than its keys (tile
    # edges of the mask, the slot stride of the 4-D TMA map)
    k3_more = [dict(b=3, s=1024, q_offset=0, int8=False)]
    k3_more += [dict(b=2, s=512, q_offset=q_offset, int8=int8, nh=8 * g,
                     nkv=8, hd=64)
                for g in (1, 2, 8) for q_offset, int8 in ((0, False),
                                                          (256, True))]
    k3_more.append(dict(b=2, s=200, q_offset=300, int8=True,
                        slot_stride=2048 * 8 * 128))
    # g = 3 does not divide the 128-row tile: 2 pad rows per block
    k3_more.append(dict(b=2, s=100, q_offset=37, int8=True, nh=24, nkv=8,
                        hd=64))
    for kw in k3_more:
        c = k3_case(gen, **kw)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"K3 {desc}: {fmt(c)}", flush=True)
    for kw in K3_PAGED_CASES:
        c = k3_paged_case(gen, **kw)
        desc = " ".join(f"{k}={v}" for k, v in kw.items())
        print(f"K3-paged {desc}: {fmt(c)}", flush=True)
        torch.cuda.empty_cache()
    return dict(k1_step, shape="one 8B decode step: 224 int8 matmuls at "
                "m=8 + lm_head")


# -- (d) small-model reference ------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def reference_phase(seed: int) -> None:
    """Prefill, chunked prefill (a continuation link), decode and verify
    logits of a small int8 model (widths that pass every kernel gate) on
    the card against the CPU run of the same functions, which takes the
    plain versions."""
    cfg = llama.LlamaConfig(vocab_size=1024, d_model=512, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=1024,
                            dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = llama.init(cfg, seed=seed, device=DEV, quantize="int8")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen)
    lengths = torch.tensor([100, 128], dtype=torch.int32)
    outs = {}
    for side, dev, p in (("card", DEV, params),
                         ("cpu", "cpu", _to(params, "cpu"))):
        tok = tokens.to(dev)
        logits, ks, vs = llama.prefill(p, tok[:, :128], cfg)
        cache = llama.init_cache(cfg, 2, 256, "int8", device=dev)
        prefix = []
        for name, val in (("k", ks), ("v", vs)):
            q8, sc = llama.quantize_kv(val)
            cache[name][:, :, :128] = q8
            cache[name + "_s"][:, :, :128] = sc
            prefix.append(llama.dequantize_kv(q8, sc, cfg.dtype))
        # a chunked prefill's next link, as the engine runs it: the next
        # 128 tokens against the first 128 rows dequantized from the int8
        # cache (K3 at q_offset 128 on the card)
        chunk = llama.prefill_continue(p, tok[:, 128:], *prefix, cfg)[0]
        dec = llama.decode_step(p, tok[:, 127], cache, lengths.to(dev), cfg)
        ver = llama.verify_step(p, tok[:, :4], cache, lengths.to(dev) + 1,
                                cfg)
        outs[side] = [x.float().cpu() for x in (logits, chunk, dec, ver)]
    for name, got, ref in zip(("prefill", "chunked prefill", "decode",
                               "verify"), outs["card"], outs["cpu"]):
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"reference {name}: bad shape or non-finite logits")
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        # bf16 model, two layers, KV re-quantized from slightly different
        # prefill values on each side: 5% of the logit range
        check(err <= 0.05 * scale, f"reference {name}: err {err} > "
                                   f"{0.05 * scale}")
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"reference {name}: logits {tuple(got.shape)} "
              f"max_abs_err={err:.4g} (tol {0.05 * scale:.4g}) "
              f"argmax agreement {agree:.3f}", flush=True)


# -- (h) training attention kernels against their plain versions ------------


def two_documents(b: int, s: int) -> torch.Tensor:
    """[b, s] int32 segment ids, two documents per row, the boundary of
    row i at s // 2 + 17 * (i + 1): inside a 64-row tile of every
    kernel."""
    seg = torch.zeros(b, s, dtype=torch.int32, device=DEV)
    for i in range(b):
        seg[i, s // 2 + 17 * (i + 1):] = 1
    return seg


def visible_pairs(b: int, s: int, causal: bool, seg) -> int:
    """(query row, key) pairs visible in this input, summed over the
    batch: the work the attention kernels must do for it."""
    total = 0
    for i in range(b):
        lens = ([s] if seg is None else
                torch.unique_consecutive(seg[i], return_counts=True)[1]
                .tolist())
        total += sum(n * (n + 1) // 2 if causal else n * n for n in lens)
    return total


def train_attn_case(gen, b, s, causal, segments, h=32, d=128):
    """B1, B2 and B3 at one shape against their plain versions (run per
    batch row, to hold the [H, S, S] f32 scores of one row at a time),
    repeat-launch bitwise equality, and each kernel's, plain and SDPA
    times with its bound. Returns {kernel: case}."""
    def mk():
        return torch.randn(b, s, h, d, device=DEV, generator=gen).to(
            torch.bfloat16)

    q, k, v, do = mk(), mk(), mk(), mk()
    seg = two_documents(b, s) if segments else None
    kw = dict(causal=causal, segment_ids=seg)
    _build.reset_launches()
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.row_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    shape_key = {name: next(iter(_build.SHAPES[name]))
                 for name in TRAINING_KERNELS}
    again = (*fa.flash_fwd(q, k, v, **kw),
             fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in
              zip((o, lse, dq, dk, dv), again)),
          f"B1-B3 B={b} S={s}: a second launch gave other bits")

    def rows(i):
        sl = slice(i, i + 1)
        return dict(causal=causal,
                    segment_ids=None if seg is None else seg[sl]), sl

    def plain_fwd_all():
        outs = []
        for i in range(b):
            kwi, sl = rows(i)
            outs.append(fa.plain_fwd(q[sl], k[sl], v[sl], **kwi))
        return [torch.cat(x) for x in zip(*outs)]

    def plain_dq_all():
        outs = []
        for i in range(b):
            kwi, sl = rows(i)
            outs.append(fa.plain_bwd_dq(q[sl], k[sl], v[sl], do[sl],
                                        lse[sl], delta[sl], **kwi))
        return torch.cat(outs)

    def plain_dkv_all():
        outs = []
        for i in range(b):
            kwi, sl = rows(i)
            outs.append(fa.plain_bwd_dkv(q[sl], k[sl], v[sl], do[sl],
                                         lse[sl], delta[sl], **kwi))
        return [torch.cat(x) for x in zip(*outs)]

    name = f"B={b} S={s} causal={causal} segments={segments}"
    ro, rlse = plain_fwd_all()
    errs = {"o": attn_err(o, ro, f"B1 {name} o", ATTN_ROW_TOL),
            "lse": attn_err(lse, rlse, f"B1 {name} lse", ATTN_ROW_TOL)}
    del ro, rlse
    errs["dq"] = attn_err(dq, plain_dq_all(), f"B2 {name} dq", ATTN_ROW_TOL,
                          grad=True)
    rdk, rdv = plain_dkv_all()
    errs["dk"] = attn_err(dk, rdk, f"B3 {name} dk", ATTN_ROW_TOL, grad=True)
    errs["dv"] = attn_err(dv, rdv, f"B3 {name} dv", ATTN_ROW_TOL, grad=True)
    del rdk, rdv
    torch.cuda.empty_cache()

    ms = {"fwd": time_ms([lambda: fa.flash_fwd(q, k, v, **kw)], 10),
          "dq": time_ms([lambda: fa.flash_bwd_dq(
              q, k, v, do, lse, delta, **kw)], 10),
          "dkv": time_ms([lambda: fa.flash_bwd_dkv(
              q, k, v, do, lse, delta, **kw)], 10)}
    plain = {"fwd": time_ms([plain_fwd_all], 2),
             "dq": time_ms([plain_dq_all], 2),
             "dkv": time_ms([plain_dkv_all], 2)}
    torch.cuda.empty_cache()
    # library yardstick: SDPA forward, and its backward (dq, dk and dv in
    # one autograd call) as forward+backward less the forward
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = None
    if seg is not None:
        mask = seg[:, None, :, None] == seg[:, None, None, :]
        if causal:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device=DEV).tril()
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None)
    dot = do.transpose(1, 2)
    with torch.no_grad():
        lib_fwd = time_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_kw)], 10)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    lib_fb = time_ms([sdpa_fwd_bwd], 10)
    del qt, kt, vt, mask
    pairs = h * visible_pairs(b, s, causal, seg)
    x = b * s * h * d * 2           # one bf16 [B, S, H, D] tensor
    rowv = b * h * s * 4            # one f32 [B, H, S] vector
    segb = 0 if seg is None else b * s * 4
    bounds = {"fwd": bound_ms(4 * x + rowv + segb, 4.0 * d * pairs),
              "dq": bound_ms(5 * x + 2 * rowv + segb, 6.0 * d * pairs),
              "dkv": bound_ms(6 * x + 2 * rowv + segb, 8.0 * d * pairs)}
    lib = {"fwd": lib_fwd, "dq": lib_fb - lib_fwd, "dkv": lib_fb - lib_fwd}
    out = {}
    for kern, part, outs in (("flash_attn_fwd", "fwd", ("o", "lse")),
                             ("flash_attn_dq", "dq", ("dq",)),
                             ("flash_attn_dkv", "dkv", ("dk", "dv"))):
        worst = max(errs[n][1] for n in outs)
        out[kern] = dict(
            err=max(errs[n][0] for n in outs), worst_row=worst,
            row_tol=ATTN_ROW_TOL, ms=ms[part], plain_ms=plain[part],
            library_ms=lib[part], bound_ms=bounds[part][0],
            bound_by=bounds[part][1],
            errs={n: errs[n] for n in outs}, shape_key=shape_key[kern],
            shape=f"one launch at {name} H={h} D={d}")
    return out


def train_attn_phase(gen) -> dict:
    """(h): the three training-attention kernels at the training shapes,
    plus B1's forward-only q_offset path. Returns the kernels-line
    entries from the trainer's shape (B=2, S=4096, causal)."""
    entries = None
    for b, s, causal, segments in ((2, 4096, True, False),
                                   (2, 4000, True, True),
                                   (2, 1024, False, False)):
        case = train_attn_case(gen, b, s, causal, segments)
        for kern, c in case.items():
            errs = " ".join(f"{n} worst row {w:.3g}" for n, (_, w) in
                            c["errs"].items())
            print(f"{kern} B={b} S={s} causal={causal} "
                  f"segments={segments}: {errs}; {fmt(c)}", flush=True)
        entries = entries or case
        torch.cuda.empty_cache()
    # B1 alone: the continuation prefill (forward only, rows at q_offset
    # 512 of 812 keys, with segments), head dim 64, and 200 rows (not a
    # multiple of the 128-row tile), causal and not
    for kw in (dict(b=1, sq=300, sk=812, q_offset=512, segments=True),
               dict(b=2, sq=1024, sk=1024, d=64),
               dict(b=2, sq=1024, sk=1024, d=64, causal=False,
                    segments=True),
               dict(b=2, sq=200, sk=200),
               dict(b=2, sq=200, sk=200, causal=False)):
        b1_case(gen, **kw)
    # B2 and B3 at the edges of their tiles: head dim 64; 200 rows (not a
    # multiple of 64 or 128), causal and not; 320 causal, whose last key
    # block holds 64 keys and whose last 128-row block 64 rows
    for kw in (dict(b=2, s=1024, d=64),
               dict(b=2, s=1024, d=64, causal=False, segments=True),
               dict(b=2, s=200),
               dict(b=2, s=200, causal=False),
               dict(b=2, s=200, segments=True),
               dict(b=2, s=320)):
        bwd_case(gen, **kw)
    return entries


def b1_case(gen, b, sq, sk, h=32, d=128, causal=True, q_offset=0,
            segments=False):
    """B1 against its plain version (o and lse), and a repeat launch bit
    for bit."""
    q = torch.randn(b, sq, h, d, device=DEV, generator=gen).to(
        torch.bfloat16)
    k, v = (torch.randn(b, sk, h, d, device=DEV, generator=gen).to(
        torch.bfloat16) for _ in range(2))
    seg = two_documents(b, sk) if segments else None
    kw = dict(causal=causal, q_offset=q_offset, segment_ids=seg)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o2, lse2 = fa.flash_fwd(q, k, v, **kw)
    ro, rlse = fa.plain_fwd(q, k, v, **kw)
    name = (f"flash_attn_fwd B={b} Sq={sq} Sk={sk} H={h} D={d} "
            f"causal={causal} q_offset={q_offset} segments={segments}")
    e_o = attn_err(o, ro, f"{name} o", ATTN_ROW_TOL)
    e_l = attn_err(lse, rlse, f"{name} lse", ATTN_ROW_TOL)
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          f"{name}: a second launch gave other bits")
    print(f"{name}: o worst row {e_o[1]:.3g}, lse worst row {e_l[1]:.3g} "
          f"(tol {ATTN_ROW_TOL:.3g})", flush=True)


def bwd_case(gen, b, s, h=32, d=128, causal=True, segments=False):
    """B2 and B3 against their plain versions (dq, dk, dv), from B1's lse,
    and a repeat launch bit for bit."""
    q, k, v, do = (torch.randn(b, s, h, d, device=DEV, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    seg = two_documents(b, s) if segments else None
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.row_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    name = f"B2/B3 B={b} S={s} H={h} D={d} causal={causal} " \
           f"segments={segments}"
    check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
          and torch.equal(dv, dv2), f"{name}: a second launch gave other "
                                    "bits")
    rdq = fa.plain_bwd_dq(q, k, v, do, lse, delta, **kw)
    rdk, rdv = fa.plain_bwd_dkv(q, k, v, do, lse, delta, **kw)
    worst = {n: attn_err(g, r, f"{name} {n}", ATTN_ROW_TOL, grad=True)[1]
             for n, g, r in (("dq", dq, rdq), ("dk", dk, rdk),
                             ("dv", dv, rdv))}
    print(f"{name}: " + ", ".join(f"{n} worst row {w:.3g}" for n, w in
                                  worst.items())
          + f" (tol {ATTN_ROW_TOL:.3g}); same bits twice", flush=True)


# -- (i) small model: training loss and grads, card against CPU -------------


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device).requires_grad_(True)


# bf16 model, two layers: a grad leaf on the card is held within 2^-4 of
# the leaf's largest value of the CPU run (bf16 rounds at other places in
# the kernels and the GEMMs); the loss within 1% of the CPU loss
GRAD_LEAF_TOL = 2 ** -4
LOSS_RTOL = 1e-2


def train_reference_phase(seed: int) -> None:
    """(i): loss_fn and every grad of a small bf16 Llama (2 layers, d 512,
    hd 128, GQA 4/2, vocab 4096, seq 256, two documents per row and a
    loss mask) through the kernels on the card against the same function
    on the CPU, which takes the plain versions."""
    cfg = llama.LlamaConfig(vocab_size=4096, d_model=512, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=1024,
                            max_seq_len=256)
    params = llama.init(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    b, s = 2, 256
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, dtype=torch.int32),
             "segment_ids": torch.zeros(b, s, dtype=torch.int32),
             "loss_mask": (torch.rand(b, s, generator=gen) < 0.7).float()}
    batch["segment_ids"][0, 100:] = 1
    batch["segment_ids"][1, 150:] = 1
    out = {}
    _build.reset_launches()
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        p = tree_to(params, dev)
        loss, aux = llama.loss_fn(p, {k: v.to(dev) for k, v in
                                      batch.items()}, cfg)
        grads = torch.autograd.grad(loss, train.leaves(p))
        out[side] = (loss.item(), aux["tokens"].item(),
                     [g.float().cpu() for g in grads])
    for name in TRAINING_KERNELS:
        check(_build.LAUNCHES[name] > 0,
              f"train reference: {name} was not launched on the card")
    (cl, ct, cg), (rl, rt, rg) = out["card"], out["cpu"]
    check(math.isfinite(cl) and ct == rt, "train reference: bad loss")
    check(abs(cl - rl) <= LOSS_RTOL * abs(rl),
          f"train reference: loss {cl} vs CPU {rl}")
    worst, worst_name = 0.0, ""
    names = [".".join(k) for k in leaf_names(params)]
    for name, g, r in zip(names, cg, rg):
        check(bool(torch.isfinite(g).all()), f"train reference: {name} "
                                             "grad not finite")
        rel = ((g - r).abs().max() / r.abs().max().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= GRAD_LEAF_TOL, f"train reference: grad {worst_name} "
                                  f"off by {worst:.4g} of its max")
    print(f"train reference: loss card {cl:.6f} cpu {rl:.6f} (tol "
          f"{LOSS_RTOL:.0%}); worst grad leaf {worst_name} {worst:.4g} of "
          f"its max (tol {GRAD_LEAF_TOL:.4g}); kernel launches "
          f"{json.dumps({k: _build.LAUNCHES[k] for k in TRAINING_KERNELS})}",
          flush=True)


def leaf_names(tree, prefix=()):
    """Key paths of a nested dict in train.leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            prefix + (k,))]
    return [prefix]


# -- (j) the trainer at Llama-3-8B width -------------------------------------


TRAIN_STEPS = 6
# the two runs' losses: the same seed and data; the embedding gradient's
# scatter-add on the card may sum in another order from run to run
TRAIN_LOSS_RTOL = 1e-3


def train_config(seed: int) -> train.TrainerConfig:
    """Llama-3-8B width with the depth cut to 4 layers, B=2 x S=4096,
    AdamW with 2 warmup steps of 100, remat "minimal" (the defaults)."""
    base = llama.LlamaConfig.llama3_8b()
    overrides = {f: getattr(base, f) for f in (
        "vocab_size", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "rope_theta")}
    overrides.update(n_layers=4, max_seq_len=4096)
    return train.TrainerConfig(
        model="llama", model_overrides=overrides, batch_size=2,
        optimizer=train.OptimizerConfig(warmup_steps=2, total_steps=100),
        dataset=train_data.DatasetConfig(seq_len=4096), seed=seed,
        log_every=1)


def train_run(cfg: train.TrainerConfig):
    """One trainer run of TRAIN_STEPS; returns (trainer, state, per-step
    metrics, cumulative launches after each step)."""
    trainer = train.Trainer(cfg, device=DEV,
                            metrics=MetricsWriter(echo=False))
    state = trainer.init_state()
    data = train_data.make_dataset(cfg.dataset, cfg.model,
                                   trainer.model_cfg, cfg.batch_size,
                                   fallback_seed=cfg.seed)
    log, counts = [], []

    def on_step(step, scalars):
        log.append(scalars)
        counts.append({k: _build.LAUNCHES[k] for k in TRAINING_KERNELS})

    trainer.train(data, TRAIN_STEPS, state, step_callback=on_step)
    return trainer, state, log, counts, data


def step_profile(trainer, state, batch) -> dict:
    """One training step's wall time against the card's busy time from the
    profiler's kernel events, by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    trainer.train_step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    busy = {"flash_attn_fwd": 0.0, "flash_attn_dq": 0.0,
            "flash_attn_dkv": 0.0, "gemm": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
        key = evt.key.lower()
        if "fwd_kernel" in key:
            busy["flash_attn_fwd"] += ms
        elif "dq_kernel" in key:
            busy["flash_attn_dq"] += ms
        elif "dkv_kernel" in key:
            busy["flash_attn_dkv"] += ms
        elif any(w in key for w in ("gemm", "nvjet", "xmma", "cutlass")):
            busy["gemm"] += ms
        else:
            busy["other"] += ms
    device_ms = sum(busy.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": device_ms,
            "busy_ms_by_kernel": busy,
            "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
            "top_kernels_ms": {k[:90]: round(v, 3) for k, v in top}}


def trainer_phase(seed: int, attn_shape: dict) -> tuple[dict, dict]:
    """(j): the trainer at the Llama-3-8B-width config, twice from the same
    seed; each kernel must have run at the shape (h) timed it at
    (attn_shape, its _build.SHAPES key). Returns the training kernels'
    launches in run 1 and run 1's stats."""
    cfg = train_config(seed)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    trainer, state, log, counts, data = train_run(cfg)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: _build.LAUNCHES[k] for k in TRAINING_KERNELS}
    shapes = {k: dict(_build.SHAPES[k]) for k in TRAINING_KERNELS}
    mcfg = trainer.model_cfg
    tokens = cfg.batch_size * cfg.dataset.seq_len
    flops = llama.flops_per_token(mcfg, cfg.dataset.seq_len) * tokens
    for i, m in enumerate(log):
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"trainer: step {i + 1} loss/grad_norm not finite")
        print(f"trainer step {i + 1}: loss={m['loss']:.6f} "
              f"grad_norm={m['grad_norm']:.6f} "
              f"step_time_s={m['step_time_s']:.4f}"
              + (" (includes the first launches)" if i == 0 else ""),
              flush=True)
    per_step = [{k: c[k] - (counts[i - 1][k] if i else 0) for k in c}
                for i, c in enumerate(counts)]
    for name in TRAINING_KERNELS:
        check(all(p[name] >= mcfg.n_layers for p in per_step),
              f"trainer: {name} launched fewer than once per layer in a "
              f"step: {[p[name] for p in per_step]}")
        check(attn_shape[name] in shapes[name],
              f"trainer: {name} never ran at the shape phase (h) timed")
    steady = sorted(m["step_time_s"] for m in log[1:])
    step_s = steady[len(steady) // 2]
    stats = {"step_time_s_median": step_s,
             "tokens_per_s": tokens / step_s,
             "mfu": mfu.mfu(flops, step_s, 1),
             "flops_per_step": flops, "peak_memory_gb": peak_gb,
             "launches_per_step": per_step[-1],
             "params": sum(p.numel() for p in train.leaves(state["params"]))}
    print(f"trainer: Llama-3-8B width, {mcfg.n_layers} layers, B="
          f"{cfg.batch_size} S={cfg.dataset.seq_len}: {json.dumps(stats)}",
          flush=True)
    profile_batch = trainer.to_device(next(data))
    del trainer, state
    torch.cuda.empty_cache()
    trainer2, state2, log2, _, _ = train_run(cfg)
    for i, (a, b) in enumerate(zip(log, log2)):
        check(abs(a["loss"] - b["loss"]) <= TRAIN_LOSS_RTOL * abs(a["loss"]),
              f"trainer: run 2 step {i + 1} loss {b['loss']} vs "
              f"{a['loss']}")
    diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(log, log2))
    print(f"trainer: run 2 losses {[round(m['loss'], 6) for m in log2]}; "
          f"max |loss diff| vs run 1 {diff:.3g} (tol "
          f"{TRAIN_LOSS_RTOL:g} relative)", flush=True)
    prof = step_profile(trainer2, state2, profile_batch)
    print(f"train step breakdown: {json.dumps(prof)}", flush=True)
    del trainer2, state2
    torch.cuda.empty_cache()
    return launches, stats


def trainer_profile_phase(seed: int, base_step_s: float) -> None:
    """(j2): the trainer of (j) once more with profile_dir set (window at
    steps 2 and 3 of 6): PROFILE_DONE must name that window and one trace
    file must be written; prints each step's time, inside and outside the
    window, beside (j)'s median step. The trace goes to a temporary
    directory, removed after."""
    import tempfile

    logdir = tempfile.mkdtemp(prefix="kft_profile_")
    try:
        cfg = dataclasses.replace(train_config(seed), profile_dir=logdir,
                                  profile_start_step=2, profile_num_steps=2)
        trainer, state, log, _, _ = train_run(cfg)
        del trainer, state
        torch.cuda.empty_cache()
        with open(os.path.join(logdir, "PROFILE_DONE")) as f:
            done = f.read()
        check(done == "steps 2..3\n",
              f"trainer profile: PROFILE_DONE says {done!r}")
        traces = [f for f in os.listdir(logdir) if ".pt.trace.json" in f]
        check(len(traces) == 1, f"trainer profile: trace files {traces}")
        size = os.path.getsize(os.path.join(logdir, traces[0]))
        times = [m["step_time_s"] for m in log]
        check(all(math.isfinite(m["loss"]) for m in log),
              "trainer profile: loss not finite")
        outside = sorted(times[3:])[len(times[3:]) // 2]
        print(f"trainer profile window: step times {json.dumps(times)} "
              f"(steps 2-3 profiled; step 3 also writes the trace, "
              f"{size} bytes); median outside the window {outside:.4f} s, "
              f"(j)'s median {base_step_s:.4f} s", flush=True)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


# -- (e) engine at full 8B width, (f) engine shapes, (g) server --------------


def warm(engine, label) -> float:
    """engine.warmup(), timed; prints the decode menu it captured."""
    t = time.monotonic()
    engine.warmup()
    torch.cuda.synchronize()
    sec = time.monotonic() - t
    g = engine.graph_stats()
    print(f"{label}: warmup {sec:.2f} s, {g['captures']} decode graphs "
          f"captured, graph pool {g['pool_bytes'] / 1e6:.1f} MB; keys "
          f"{g['keys']}", flush=True)
    check(g["captures"] == len(g["keys"]) > 0,
          f"{label}: warmup captured no decode graph")
    return sec


def run_batch(engine, prompts, max_new, kws=None, on_step=None,
              cancel_row=None):
    """Submit a burst at once (per-request keywords `kws`) and step the
    engine until idle; cancel row `cancel_row` once it has E3_CANCEL_AT
    tokens (with a chunk in flight under pipelining). Returns each row's
    tokens, finish reason, logprobs, top logprobs and TTFT, and the run's
    stats: TTFT mean and max, and decode tokens/s from the moment every
    request has its first token."""
    t0 = time.monotonic()
    kws = kws or [{}] * len(prompts)
    rids = [engine.submit(p, max_new, **kw) for p, kw in zip(prompts, kws)]
    t_first = None
    cancel_in_flight = None
    while engine.step():
        if on_step is not None:
            on_step()
        if cancel_row is not None and cancel_in_flight is None:
            r = rids[cancel_row]
            if (len(engine.partial_result(r)) >= E3_CANCEL_AT
                    and (engine._pending is not None
                         or not engine.pipeline_decode)):
                cancel_in_flight = engine._pending is not None
                check(engine.cancel(r), "cancel of a running request "
                                        "returned False")
        if t_first is None and all(engine.ttft_seconds(r) is not None
                                   for r in rids):
            torch.cuda.synchronize()
            t_first = time.monotonic()
    torch.cuda.synchronize()
    t_end = time.monotonic()
    rows = [dict(tokens=engine.result(r), reason=engine.finish_reason(r),
                 logprobs=engine.result_logprobs(r),
                 top=(engine.result_top_logprobs(r) if engine.logprobs_topk
                      else None),
                 ttft=engine.ttft_seconds(r)) for r in rids]
    for r in rids:
        engine.release(r)
    ttft = [row["ttft"] for row in rows]
    n = sum(len(row["tokens"]) for row in rows)
    stats = dict(ttft_mean_s=sum(ttft) / len(ttft), ttft_max_s=max(ttft),
                 decode_tok_s=(n - len(prompts)) / (t_end - t_first),
                 wall_s=t_end - t0)
    if cancel_row is not None:
        stats.update(tokens=n, cancel_with_chunk_in_flight=cancel_in_flight)
    return rows, stats


def tokens_of(rows):
    return [row["tokens"] for row in rows]


class IdTokenizer:
    """Text in as UTF-8 bytes, ids out as decimal text: random weights
    have no vocabulary, so the completion text shows the ids."""

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def engine_phase(seed: int):
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              param_dtype=torch.bfloat16)
    t = time.monotonic()
    params = llama.init(cfg, seed=seed, device=DEV, quantize="int8")
    engine = LLMEngine(params, cfg, n_slots=8, max_len=2048,
                       buckets=(128, 512, 1024), decode_chunk=8,
                       kv_quantize="int8", device=DEV)
    torch.cuda.synchronize()
    print(f"engine: Llama-3-8B, {cfg.n_layers} layers, int8 weights + int8 "
          f"KV, 8 slots x 2048; init {time.monotonic() - t:.2f} s; "
          f"resident {torch.cuda.memory_allocated() / 1e9:.3f} GB",
          flush=True)
    warmup_s = warm(engine, "engine")
    gen = torch.Generator().manual_seed(seed)
    plens = (30, 75, 130, 260, 400, 600, 800, 1000)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in plens]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    captures = engine.graph_stats()["captures"]
    first, stats1 = run_batch(engine, prompts, 32)
    first = tokens_of(first)
    launches = {name: _build.LAUNCHES[name] for name in SERVING_KERNELS}
    shapes = {name: dict(_build.SHAPES[name]) for name in SERVING_KERNELS}
    second, stats2 = run_batch(engine, prompts, 32)
    second = tokens_of(second)
    check(engine.graph_stats()["captures"] == captures,
          "engine: a decode graph was captured in live traffic")
    print(f"engine run 1 (after a {warmup_s:.2f} s warmup): "
          f"{json.dumps(stats1)}", flush=True)
    print(f"engine run 2: {json.dumps(stats2)}", flush=True)
    print(f"engine launches in run 1: {json.dumps(launches)}; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    check(all(len(t) == 32 for t in first), "engine: wrong token counts")
    check(all(0 <= x < cfg.vocab_size for t in first for x in t),
          "engine: token outside the vocabulary")
    check(first == second, "engine: the same prompts gave other tokens")
    for name, n in launches.items():
        check(n > 0, f"engine: kernel {name} was never launched")
    print("engine: determinism ok (two runs, identical tokens)", flush=True)
    return engine, launches, shapes, prompts, first


# the oversubscribed pool of (e2): the burst's requests need 1, 1, 2, 3,
# 4, 5, 7 and 9 blocks of 128 tokens (prompt + 32 new tokens), 32 in all
PAGED_SMALL_POOL = 24


def paged_engine_phase(engine, prompts, want):
    """(e2): PagedLLMEngine over the slab engine's weights and settings,
    the same burst, with the default pool and with PAGED_SMALL_POOL
    blocks. Returns the kernels' launches and shapes of the default-pool
    run, the paged engine with the default pool, and each run's stats."""
    runs = {}
    for label, pool_blocks in (("default pool", None),
                               ("small pool", PAGED_SMALL_POOL)):
        paged = PagedLLMEngine(engine.params, engine.cfg, n_slots=8,
                               max_len=2048, buckets=(128, 512, 1024),
                               decode_chunk=8, kv_quantize="int8",
                               pool_blocks=pool_blocks, device=DEV)
        warm(paged, f"paged engine ({label})")
        seen = {"held": 0, "used": 0}

        def note(paged=paged, seen=seen):
            m = paged.metrics()
            seen["held"] = max(seen["held"], m["held_prefills"])
            seen["used"] = max(seen["used"], m["kv_pool"]["used_blocks"])

        _build.reset_launches()
        toks, stats = run_batch(paged, prompts, 32, on_step=note)
        toks = tokens_of(toks)
        launches = {name: _build.LAUNCHES[name] for name in _build.KERNELS}
        shapes = {name: dict(_build.SHAPES[name]) for name in PAGED_KERNELS}
        pool = paged.metrics()["kv_pool"]
        stats.update(held_prefills_max=seen["held"],
                     pool_peak_used_blocks=seen["used"],
                     pool_blocks=pool["pool_blocks"],
                     alloc_failures=pool["alloc_failures"])
        print(f"paged engine ({label}): {json.dumps(stats)}; launches "
              f"{json.dumps(launches)}", flush=True)
        for i, (got, ref) in enumerate(zip(toks, want)):
            step = next((j for j, (a, b) in enumerate(zip(got, ref))
                         if a != b), min(len(got), len(ref)))
            check(got == ref, f"paged engine ({label}): request {i} "
                              f"differs from the slab engine's tokens "
                              f"first at step {step}")
        for name in PAGED_KERNELS:
            check(launches[name] > 0,
                  f"paged engine ({label}): {name} was never launched")
        check(launches["flash_decode"] == 0,
              f"paged engine ({label}): the slab K2 was launched")
        check(pool["free_blocks"] == pool["pool_blocks"],
              f"paged engine ({label}): blocks still held after the burst")
        if pool_blocks is not None:
            check(seen["held"] > 0,
                  f"paged engine ({label}): no prefill was held")
        runs[label] = (paged, launches, shapes, stats)
    print("paged engine: greedy tokens equal the slab engine's in both "
          "runs", flush=True)
    paged, launches, shapes, _ = runs["default pool"]
    del runs["small pool"]
    return launches, shapes, paged


# (e3): the flagship ISVC engine (examples/llama-8b-serving-isvc.yaml
# without the prefix cache, speculation and streaming) and its burst: 14
# prompts of 30..1000 tokens and two chunked ones (1500: 1024 + a 476
# tail in bucket 512; 1900: 1024 + an 876 tail in bucket 1024)
FLAGSHIP = dict(n_slots=16, max_len=2048, buckets=(128, 512, 1024),
                decode_chunk=8, kv_quantize="int8", logprobs_topk=5)
E3_PLENS = (30, 60, 90, 130, 200, 260, 330, 400, 480, 560, 640, 720, 850,
            1000, 1500, 1900)
E3_NEW = 48
E3_SEEDED = (1, 5, 9, 13, 15)              # temperature 0.7, top_p 0.9
E3_PENALIZED = {2: dict(presence_penalty=0.6),
                6: dict(frequency_penalty=0.8)}
E3_STOP = (3, 10)                          # greedy rows given a stop
E3_CANCEL = 7                              # greedy, cancelled mid-decode
E3_CANCEL_AT = 8                           # ... once it has this many tokens
E3_POOL_BLOCKS = 128


def e3_kwargs(stops=None) -> list[dict]:
    kws = []
    for i in range(len(E3_PLENS)):
        kw = dict(E3_PENALIZED.get(i, {}))
        if i in E3_SEEDED:
            kw.update(temperature=0.7, top_p=0.9, seed=1000 + i)
        if stops and i in stops:
            kw["stop"] = [stops[i]]
        kws.append(kw)
    return kws


def stop_cut(tokens, stop):
    """The result a stop sequence leaves of `tokens`: cut before the first
    place where the output so far ends with it."""
    for j in range(len(stop), len(tokens) + 1):
        if tokens[j - len(stop):j] == stop:
            return tokens[:j - len(stop)]
    return None


def graph_equals_eager(engine, seed) -> None:
    """One chunk (8 steps, span 2048, both variants) from equal state: the
    replay of its captured graph bit for bit the eager body, in the output
    rows, the slot state and the KV cache."""
    n, v = engine.n_slots, engine.cfg.vocab_size
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lengths = torch.randint(100, 1900, (n,), generator=gen, device=DEV,
                            dtype=torch.int32)
    tokens = torch.randint(0, v, (n,), generator=gen, device=DEV)
    samp = torch.zeros(n, 6, device=DEV)
    samp[:, 5] = -1
    samp[1::4, 0], samp[1::4, 2], samp[1::4, 5] = 0.7, 0.9, 77
    samp[2::4, 0], samp[2::4, 1] = 1.0, 20
    samp[3::4, 3], samp[3::4, 4] = 0.6, 0.3
    cnt = torch.randint(0, 2, (n, v), generator=gen, device=DEV,
                        dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool, device=DEV)
    active[n // 2] = False
    kv = {k: t.clone() for k, t in engine.cache.items()}
    for sample in (True, False):
        outs = []
        for run in ("graph", "eager"):
            engine.lengths.copy_(lengths)
            engine.last_tokens.copy_(tokens)
            engine.samp.copy_(samp)
            engine._cnt.copy_(cnt)
            engine._draws.fill_(5)
            for k, t in kv.items():
                engine.cache[k].copy_(t)
            engine._active_dev.copy_(active)
            if run == "graph":
                replays = engine.graph_stats()["replays"]
                out = engine._decode_chunk(8, 2048, active, sample).clone()
                check(engine.graph_stats()["replays"] == replays + 1,
                      "e3: the chunk was not a graph replay")
            else:
                out = engine._decode_body(8, 2048, sample)
            outs.append([out, *(t.clone() for t in engine._chunk_state()),
                         *(engine.cache[k].clone() for k in kv)])
        same = [torch.equal(a, b) for a, b in zip(*outs)]
        check(all(same), f"e3: graph replay differs from the eager body "
                         f"(sample={sample}): {same}")
    del kv, outs
    engine.lengths.zero_()
    engine.last_tokens.zero_()
    engine._cnt.zero_()
    engine._samp_host[:] = engine._samp_reset()
    engine.samp.copy_(torch.from_numpy(engine._samp_host))
    engine._active_host = None
    print("e3: one chunk's graph replay is bit for bit the eager body "
          "(rows, slot state, KV cache; sampled and greedy variants)",
          flush=True)


def flagship_phase(engine, seed: int):
    """(e3): the flagship engine at full Llama-3-8B width over (e)'s int8
    weights: a slab LLMEngine and a PagedLLMEngine (128 blocks), warmed
    up, serve the E3 burst of greedy, seeded-sampled, penalized, stopped
    and cancelled rows; see the module docstring for what it holds.
    Returns the K3 shapes of the slab runs (the chunked continuation
    among them) and each kernel's launches."""
    cfg = engine.cfg
    gen = torch.Generator().manual_seed(seed + 3)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in E3_PLENS]
    slab = LLMEngine(engine.params, cfg, device=DEV, **FLAGSHIP)
    warmup_s = warm(slab, "e3 slab")
    pool_mb = slab.graph_stats()["pool_bytes"] / 1e6
    captures = slab.graph_stats()["captures"]
    replays = slab.graph_stats()["replays"]
    _build.reset_launches()
    runs = {}
    runs["A"] = run_batch(slab, prompts, E3_NEW, e3_kwargs(),
                          cancel_row=E3_CANCEL)
    stops = {i: runs["A"][0][i]["tokens"][j:j + n]
             for i, j, n in ((E3_STOP[0], 10, 2), (E3_STOP[1], 6, 3))}
    kws = e3_kwargs(stops)
    runs["B"] = run_batch(slab, prompts, E3_NEW, kws, cancel_row=E3_CANCEL)
    slab.pipeline_decode = False
    runs["C"] = run_batch(slab, prompts, E3_NEW, kws, cancel_row=E3_CANCEL)
    slab.pipeline_decode = True
    launches = dict(_build.LAUNCHES)
    k3_shapes = dict(_build.SHAPES["flash_prefill"])
    check(slab.graph_stats()["captures"] == captures,
          "e3: a decode graph was captured after warmup")
    slab_replays = slab.graph_stats()["replays"] - replays
    graph_equals_eager(slab, seed)
    del slab
    gc.collect()
    paged = PagedLLMEngine(engine.params, cfg, device=DEV,
                           pool_blocks=E3_POOL_BLOCKS, **FLAGSHIP)
    warm(paged, "e3 paged")
    captures = paged.graph_stats()["captures"]
    _build.reset_launches()
    runs["D"] = run_batch(paged, prompts, E3_NEW, kws, cancel_row=E3_CANCEL)
    check(paged.graph_stats()["captures"] == captures,
          "e3 paged: a decode graph was captured after warmup")
    p_launches = dict(_build.LAUNCHES)
    pool = paged.metrics()["kv_pool"]
    check(pool["free_blocks"] == pool["pool_blocks"],
          "e3 paged: blocks still held after the burst")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    for label, (_, stats) in runs.items():
        print(f"e3 run {label}: {json.dumps(stats)}", flush=True)
    a, b, c, d = (runs[k][0] for k in "ABCD")
    for i in range(len(E3_PLENS)):
        if i == E3_CANCEL:
            toks = [x[i]["tokens"] for x in (a, b, c, d)]
            longest = max(toks, key=len)
            check(all(t == longest[:len(t)] and len(t) >= E3_CANCEL_AT
                      and x[i]["reason"] == "cancelled"
                      for t, x in zip(toks, (a, b, c, d))),
                  f"e3: cancelled row {i}: {[len(t) for t in toks]} tokens")
            continue
        want = b[i]["tokens"]
        check(c[i]["tokens"] == want, f"e3: row {i} differs between "
                                      "pipelined and unpipelined decode")
        check(d[i]["tokens"] == want, f"e3: row {i} differs between the "
                                      "slab and the paged engine")
        if i in stops:
            check(want == stop_cut(a[i]["tokens"], stops[i])
                  and b[i]["reason"] == "stop",
                  f"e3: stop row {i} was not cut as its stop sequence says")
        else:
            check(a[i]["tokens"] == want and len(want) == E3_NEW,
                  f"e3: row {i} differs between two runs")
    for x in (a, b, c, d):
        for i, row in enumerate(x):
            lps = row["logprobs"]
            check(len(lps) == len(row["tokens"]) == len(row["top"])
                  and all(math.isfinite(lp) and lp <= 0 for lp in lps),
                  f"e3: row {i}: bad logprobs")
            if i in E3_SEEDED or i in E3_PENALIZED:
                continue
            for tok, lp, top in zip(row["tokens"], lps, row["top"]):
                check(len(top) == 5 and max(top, key=top.get) == tok
                      and top[tok] == lp,
                      f"e3: greedy row {i}: logprob {lp} of {tok} is not "
                      f"the top-1 alternative's ({top})")
    check(any(a[i]["tokens"] != c[i]["tokens"] for i in E3_STOP),
          "e3: no stop sequence cut a row")
    check(slab_replays > 0, "e3: no decode graph was replayed")
    for name in SERVING_KERNELS:
        check(launches[name] > 0, f"e3: {name} never launched")
    check(p_launches["flash_decode_paged"] > 0
          and p_launches["flash_decode"] == 0,
          "e3 paged: K2-paged not launched, or K2-slab launched")
    check(any(dict(key)["q_offset"] == 1024 for key in k3_shapes),
          "e3: K3 never ran a chunked continuation at q_offset 1024")
    stats = runs["B"][1]
    print(f"e3 flagship: warmup {warmup_s:.2f} s, graph pool {pool_mb:.1f} "
          f"MB, {slab_replays} graph replays in three slab runs; TTFT mean "
          f"{stats['ttft_mean_s']:.4f} s max {stats['ttft_max_s']:.4f} s "
          f"(chunked rows {[row['ttft'] for row in b[-2:]]}); decode "
          f"{stats['decode_tok_s']:.1f} tok/s; launches {json.dumps(launches)}"
          f"; paged {json.dumps(p_launches)}", flush=True)
    print("e3: tokens equal pipelined/unpipelined and slab/paged, seeded "
          "rows reproduce, stop rows cut, the cancelled row stopped, greedy "
          "logprobs are the top-1's", flush=True)
    return k3_shapes, launches


def engine_shape_phase(gen, shapes) -> dict[str, dict]:
    """(f): every kernel against its plain version at each argument shape
    the engine run launched it at. Returns the attention kernels' entries
    for the kernels line: the shape launched most often, and of those the
    one with the most work."""
    best: dict[str, tuple] = {}
    for name, by_shape in shapes.items():
        for key, n in sorted(by_shape.items(), key=str):
            a = dict(key)
            desc = " ".join(f"{k}={v}" for k, v in key)
            if name == "quant_matmul":
                c = k1_case(gen, a["m"], a["d"], a["o"], a["out_dtype"])
                work = 0        # its kernels-line entry is the decode step
            elif name == "flash_decode":
                c = k2_case(gen, a["s_v"], a["t"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=a["hd"],
                            slot_stride=a["slot_stride"])
                work = a["b"] * a["s_v"] * a["t"]
            elif name == "flash_decode_paged":
                span = a["nb"] * a["bt"]
                c = k2_paged_case(gen, a["s_v"], span, a["bt"], a["int8"],
                                  b=a["b"], nh=a["nh"], nkv=a["nkv"],
                                  hd=a["hd"], n_pool=a["n_pool"])
                work = a["b"] * a["s_v"] * span
            else:
                c = k3_case(gen, a["s"], a["q_offset"], a["int8"], b=a["b"],
                            nh=a["nh"], nkv=a["nkv"], hd=a["hd"], t=a["t"],
                            slot_stride=a["slot_stride"])
                work = a["b"] * a["s"] * a["t"]
            print(f"engine shape {name} {desc} launches={n}: {fmt(c)}",
                  flush=True)
            if work and (n, work) > best.get(name, ((0, 0),))[0]:
                best[name] = ((n, work), dict(
                    c, shape=f"one launch at the engine's {desc}"))
    return {name: entry for name, (_, entry) in best.items()}


def continuation_shape_phase(gen, shapes) -> None:
    """K3 against its plain version, with its times, at each chunked
    continuation shape (q_offset > 0) the flagship runs launched it at."""
    seen = 0
    for key, n in sorted(shapes.items(), key=str):
        a = dict(key)
        if a["q_offset"] == 0:
            continue
        c = k3_case(gen, a["s"], a["q_offset"], a["int8"], b=a["b"],
                    nh=a["nh"], nkv=a["nkv"], hd=a["hd"], t=a["t"],
                    slot_stride=a["slot_stride"])
        desc = " ".join(f"{k}={v}" for k, v in key)
        print(f"e3 shape flash_prefill {desc} launches={n}: {fmt(c)}",
              flush=True)
        seen += 1
    check(seen > 0, "e3: no chunked continuation shape recorded")


def fill_tables(engine, seed: int = 5) -> None:
    """A paged engine's slot tables filled with a shuffled permutation of
    its pool blocks (an idle engine leaves every row at block 0), in place:
    the decode graphs read that very table."""
    n_pool = engine.cache["k"].shape[1]
    ids = torch.randperm(n_pool - 1, generator=torch.Generator()
                         .manual_seed(seed)) + 1
    check(ids.numel() >= engine._tbl_host.size,
          "the pool cannot fill every slot's table")
    engine._tbl_host[:] = ids[:engine._tbl_host.size].reshape(
        engine._tbl_host.shape).numpy()
    engine._tbl_sync()


def clear_tables(engine) -> None:
    engine._tbl_host[:] = 0
    engine._tbl_sync()


def step_breakdown(engine, steps: int = 8) -> dict:
    """One 8B decode step (every slot at position 1000, span 2048) as the
    engine runs it, one replay of its captured decode chunk (`steps`
    steps, the greedy variant), beside the eager body of the same chunk
    in the same call, and the replay of the sampled variant (penalties
    and the draw, on greedy rows): the wall time per step, the card's
    busy time per step from the profiler's kernel events by kernel
    family, the run's span on the card by CUDA events, and the idle
    share. A paged engine's slot tables are filled with its shuffled pool
    blocks first and zeroed after; the slot state is reset after."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_slots, iters = engine.n_slots, 3
    active = torch.ones(n_slots, dtype=torch.bool, device=DEV)
    paged = "tbl" in engine.cache
    if paged:
        fill_tables(engine)

    def graph():
        engine._decode_chunk(steps, 2048, active, sample=False)

    def eager():
        engine._active_dev.copy_(active)
        engine._decode_body(steps, 2048, False)

    def sampled():
        engine._decode_chunk(steps, 2048, active, sample=True)

    out = {}
    for label, run in (("graph", graph), ("eager", eager),
                       ("graph_sampled", sampled)):
        engine.lengths.fill_(1000)
        run()   # first use: the graph's capture, if the menu lacks it
        walls, events = [], []
        for _ in range(iters):
            engine.lengths.fill_(1000)
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            t0.record()
            run()
            t1.record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            events.append(t0.elapsed_time(t1))
        engine.lengths.fill_(1000)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = {"quant_matmul": 0.0, "flash_decode": 0.0, "other": 0.0}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            ms = evt.self_device_time_total / 1e3 / steps
            if "dequant_kernel" in evt.key:
                busy["quant_matmul"] += ms
            elif "decode_kernel" in evt.key:
                busy["flash_decode"] += ms
            else:
                busy["other"] += ms
        wall_ms = sorted(walls)[iters // 2] / steps * 1e3
        device_ms = sum(busy.values())
        out[label] = {"wall_ms": wall_ms, "device_busy_ms": device_ms,
                      "event_ms": sorted(events)[iters // 2] / steps,
                      "busy_ms_by_kernel": busy,
                      "device_idle_share": max(0.0, 1 - device_ms / wall_ms)}
    if paged:
        clear_tables(engine)
    engine.lengths.zero_()
    engine.last_tokens.zero_()
    engine._cnt.zero_()
    engine._active_host = None
    print(f"decode step breakdown ({type(engine).__name__}, per step of a "
          f"{steps}-step chunk): {json.dumps(out)}", flush=True)
    if out["graph"]["device_busy_ms"] == 0:
        print("decode step breakdown: the profiler saw no kernel inside the "
              "graph replay; its card time is event_ms", flush=True)
    return out


def prefill_breakdown(engine, seed: int) -> dict:
    """One prefill wave of the 8B engine: three 1000-token prompts (bucket
    1024, B=3 x 1024, the largest wave of (e)) submitted with one new
    token each, so the engine step that runs the wave finishes them. Its
    wall time, and the card's busy time in it from the profiler's kernel
    events by family (K3, K1, cuBLAS GEMMs, other). The wave runs once
    before either timing, so neither holds first-use costs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(seed + 1)
    prompts = [torch.randint(0, engine.cfg.vocab_size, (1000,),
                             generator=gen).tolist() for _ in range(3)]

    def wave():
        rids = [engine.submit(p, 1) for p in prompts]
        engine.step()
        torch.cuda.synchronize()
        check(all(engine.is_done(r) for r in rids),
              "prefill breakdown: one step did not finish the wave")
        for r in rids:
            engine.release(r)

    wave()
    t = time.perf_counter()
    wave()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wave()
    busy = {"flash_prefill": 0.0, "quant_matmul": 0.0, "gemm": 0.0,
            "other": 0.0}
    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = evt.self_device_time_total / 1e3
        by_name[evt.key] = by_name.get(evt.key, 0.0) + ms
        key = evt.key.lower()
        if "prefill_kernel" in key:
            busy["flash_prefill"] += ms
        elif "dequant_kernel" in key:
            busy["quant_matmul"] += ms
        elif any(w in key for w in ("gemm", "nvjet", "xmma", "cutlass")):
            busy["gemm"] += ms
        else:
            busy["other"] += ms
    device_ms = sum(busy.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": device_ms,
           "busy_ms_by_kernel": busy,
           "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
           "top_kernels_ms": {k[:90]: round(v, 3) for k, v in top}}
    print(f"prefill wave breakdown: {json.dumps(out)}", flush=True)
    return out


def probe_busy(eng, bd) -> dict:
    """The card-busy time of one run of the breakdown's two attention
    probes: the same per-layer calls (K2 over the live span at S_v=1, K3 on
    a 32-row chunk at its end, through the slot tables on a paged engine)
    on the engine's cache, at the lengths the breakdown's decode runs left,
    each under torch.profiler; ms and launches by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg, cache, n = eng.cfg, eng.cache, eng.n_slots
    span = bd["span"]
    paged = "tbl" in cache
    if paged:
        bt = cache["k"].shape[2]
        nb = min(span // bt, cache["tbl"].shape[1])
        tbl, span_p = cache["tbl"][:, :nb], nb * bt
    else:
        tbl, span_p = None, span

    def kv(li):
        return [None if name not in cache else
                cache[name][li] if paged else cache[name][li][:, :span]
                for name in ("k", "v", "k_s", "v_s")]

    gen = torch.Generator(device=DEV).manual_seed(7)
    q1 = torch.randn(n, 1, cfg.n_heads, cfg.head_dim, device=DEV,
                     generator=gen).to(cfg.dtype)
    qp = torch.randn(n, 32, cfg.n_heads, cfg.head_dim, device=DEV,
                     generator=gen).to(cfg.dtype)
    lengths = torch.full((n,), bd["fill_len"] + bd["steps"]
                         * (2 + 2 * bd["iters"]), dtype=torch.int32,
                         device=DEV)
    probes = {
        "attn_kernel": lambda li: llama.decode_attention(
            cfg, q1, *kv(li), lengths, tbl),
        "prefill_attn": lambda li: llama.prefill_attention(
            cfg, qp, *kv(li), q_offset=span_p - 32, tables=tbl)}
    fam = {"flash_decode": "decode_kernel", "flash_prefill": "prefill_kernel"}
    out = {}
    for name, call in probes.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for li in range(cfg.n_layers):
                call(li)
            torch.cuda.synchronize()
        busy = {f: {"ms": 0.0, "launches": 0} for f in (*fam, "other")}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            f = next((f for f, w in fam.items() if w in evt.key), "other")
            busy[f]["ms"] += evt.self_device_time_total / 1e3
            busy[f]["launches"] += evt.count
        out[name] = busy
    return out


def eager_breakdown(eng, label, prompts, bd) -> None:
    """The same traffic and breakdown with the decode programs run as the
    eager body (only here, for the comparison: the engine never does on
    the card), printed beside the graphs' numbers of `bd`."""
    from kubeflow_tpu_torch.training import profiling

    def eager_fn(steps, span, sample=True):
        return functools.partial(eng._decode_body, steps, span, sample)

    eng._decode_fn = eager_fn
    try:
        eng.perf_counters(reset=True)
        run_batch(eng, prompts[:2], 16)
        if "tbl" in eng.cache:
            fill_tables(eng)
        ebd = profiling.serving_decode_breakdown(eng)
        if "tbl" in eng.cache:
            clear_tables(eng)
    finally:
        del eng._decode_fn
    keys = ("chunk_wall_ms", "device_step_ms", "host_dispatch_per_step_ms")
    side = {k: {"graph": bd[k], "eager": ebd[k]} for k in keys}
    side["host_fetch_replay_per_step"] = {
        "graph": bd["buckets_ms"]["host_fetch_replay_per_step"],
        "eager": ebd["buckets_ms"]["host_fetch_replay_per_step"]}
    print(f"serving breakdown ({label}), graphs against the eager body: "
          f"{json.dumps(side)}", flush=True)


def serving_breakdown_phase(engine, paged, prompts, want):
    """The serving profiler (training/profiling.py serving_decode_breakdown,
    default steps, iters and fill_len) on the 8B slab engine of (e) and on
    the paged engine of (e2). The paged engine's slot tables are first
    filled with a shuffled permutation of its pool blocks (an idle engine
    leaves every row at block 0), and zeroed again after. Checks the
    launches (K3-slab in the slab call, K3-paged and no slab K2 or K3 in
    the paged call), the bucket partition, and that each engine's greedy
    tokens for the burst are unchanged after it; a second call under
    torch.profiler gives the card-busy time of each kernel family beside
    the buckets. Returns the paged call's K3-paged launches and shapes."""
    from kubeflow_tpu_torch.training import profiling

    out = {}
    for label, eng in (("slab", engine), ("paged", paged)):
        eng.perf_counters(reset=True)
        run_batch(eng, prompts[:2], 16)   # the host counters' traffic
        if label == "paged":
            fill_tables(eng)
        _build.reset_launches()
        bd = profiling.serving_decode_breakdown(
            eng, hbm_gbps=HBM_BYTES_PER_S / 1e9)
        launches = dict(_build.LAUNCHES)
        shapes = dict(_build.SHAPES["flash_prefill_paged"])
        busy = probe_busy(eng, bd)
        if label == "paged":
            clear_tables(eng)
        b = bd["buckets_ms"]
        print(f"serving breakdown ({label}): {json.dumps(bd)}", flush=True)
        eager_breakdown(eng, label, prompts, bd)
        print(f"serving breakdown ({label}) launches: {json.dumps(launches)}"
              f"; card busy of one probe run by kernel family: "
              f"{json.dumps(busy)}", flush=True)
        n_layers = eng.cfg.n_layers
        runs = 1 + bd["iters"]   # each probe: one untimed + iters timed
        for name, fam in (("attn_kernel", "flash_decode"),
                          ("prefill_attn", "flash_prefill")):
            wall = b[name]
            kern = busy[name][fam]
            # the profiler may miss the first kernel of a session: the
            # per-launch mean times the probe's launches (one a layer)
            card = kern["ms"] / max(kern["launches"], 1) * n_layers
            lead = "the host" if wall > 2 * card else "the card"
            print(f"serving breakdown ({label}) {name}: bucket {wall:.4f} ms"
                  f" wall a probe; {fam} card busy {card:.4f} ms a probe "
                  f"({kern['launches']} of its {n_layers} launches seen by "
                  f"the profiler); {lead} leads", flush=True)
        for name, val in b.items():
            check(val is None or val >= 0, f"breakdown ({label}): bucket "
                                           f"{name} = {val}")
        part = b["weight_read"] + b["attention_kv_update"] + \
            b["sampling_penalties"]
        check(abs(part - bd["device_step_ms"])
              <= 0.02 * bd["device_step_ms"],
              f"breakdown ({label}): buckets sum to {part}, device step "
              f"{bd['device_step_ms']}")
        check(b["kv_handoff"] is None and b["pipeline_bubble"] is None,
              f"breakdown ({label}): kv_handoff/pipeline_bubble not None")
        check(b["prefill_attn"] is not None and b["attn_kernel"] is not None
              and b["attn_dequant"] is not None,
              f"breakdown ({label}): a probe bucket is None")
        kernel = "flash_prefill_paged" if label == "paged" else \
            "flash_prefill"
        other = "flash_prefill" if label == "paged" else \
            "flash_prefill_paged"
        check(launches[kernel] == n_layers * runs and launches[other] == 0,
              f"breakdown ({label}): {kernel} launched {launches[kernel]} "
              f"times (want {n_layers * runs}), {other} "
              f"{launches[other]}")
        if label == "paged":
            check(isinstance(b["kv_gather"], float),
                  "breakdown (paged): kv_gather is not a number")
            check(launches["flash_decode_paged"] > 0
                  and launches["flash_decode"] == 0,
                  "breakdown (paged): K2-paged not launched, or K2-slab "
                  "launched")
        else:
            check(b["kv_gather"] is None, "breakdown (slab): kv_gather set")
        toks, stats = run_batch(eng, prompts, 32)
        toks = tokens_of(toks)
        check(toks == want, f"breakdown ({label}): the burst's greedy "
                            "tokens changed after profiling")
        print(f"serving breakdown ({label}): the burst's tokens are "
              f"unchanged after it ({json.dumps(stats)})", flush=True)
        out[label] = (launches, shapes)
    return out["paged"]


def paged_prefill_shape_phase(gen, shapes) -> dict:
    """K3-paged against its plain version at each argument shape the paged
    breakdown launched it at. Returns its kernels-line entry: the shape
    launched most often."""
    best = None
    for key, n in sorted(shapes.items(), key=str):
        a = dict(key)
        c = k3_paged_case(gen, a["b"], a["s"], a["q_offset"], a["bt"],
                          a["int8"], a["nb"], nh=a["nh"], nkv=a["nkv"],
                          hd=a["hd"], n_pool=a["n_pool"])
        desc = " ".join(f"{k}={v}" for k, v in key)
        print(f"breakdown shape flash_prefill_paged {desc} launches={n}: "
              f"{fmt(c)}", flush=True)
        if best is None or n > best[0]:
            best = (n, dict(c, shape="one launch at the paged serving "
                            f"breakdown's {desc}"))
    check(best is not None, "breakdown: no K3-paged shape recorded")
    return best[1]


def server_phase(engine) -> None:
    server = CompletionServer(engine, model="llama3-8b",
                              tokenizer=IdTokenizer()).start()
    results: list = [None] * 3
    try:
        def post(i):
            req = urllib.request.Request(
                server.url + "/openai/v1/completions",
                data=json.dumps({"model": "llama3-8b",
                                 "prompt": f"request {i}: " + "x" * 40 * i,
                                 "max_tokens": 16}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                results[i] = (r.status, json.loads(r.read()))

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads),
              "server: request threads did not finish")
    finally:
        server.stop()
    ok = 0
    for res in results:
        check(res is not None, "server: a request got no answer")
        status, body = res
        check(status == 200 and body["choices"][0]["text"]
              and body["usage"]["completion_tokens"] == 16,
              f"server: bad completion {body}")
        ok += 1
    print(f"server: {ok}/3 completions ok", flush=True)


# One tree's side of --ab: its own chip_smoke's functions on its own code
# (only functions that the parent tree's chip_smoke has too).
AB_RUN = """
import dataclasses, gc, os, sys
root, label, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, root)
os.chdir(root)
import torch
import chip_smoke as cs
from kubeflow_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(f"[{label}] {root}", flush=True)
_build.build_all()
gen = torch.Generator(device=cs.DEV).manual_seed(seed)
# K1: one 8B decode step (8 slots: 224 matmuls + the f32 lm_head)
step = {"ms": 0.0, "library_ms": 0.0}
for (d, o), n in list(cs.K1_LAYER.items()) + [(cs.K1_HEAD, None)]:
    od = torch.float32 if n is None else torch.bfloat16
    c = cs.k1_case(gen, 8, d, o, od)
    for key in step:
        step[key] += (1 if n is None else 32 * n) * c[key]
    print(f"[{label}] quant_matmul m=8 d={d} o={o}: {cs.fmt(c)}", flush=True)
print(f"[{label}] quant_matmul decode step: ms={step['ms']:.4f} "
      f"library_ms={step['library_ms']:.4f}", flush=True)
c = cs.k2_case(gen, 1, 1024, True)
print(f"[{label}] flash_decode B=8 S_v=1 span=1024 int8: {cs.fmt(c)}",
      flush=True)
# the 8B engine (no requests): one decode step and one prefill wave
cfg = dataclasses.replace(cs.llama.LlamaConfig.llama3_8b(),
                          param_dtype=torch.bfloat16)
engine = cs.LLMEngine(cs.llama.init(cfg, seed=seed, device=cs.DEV,
                                    quantize="int8"),
                      cfg, n_slots=8, max_len=2048, buckets=(128, 512, 1024),
                      decode_chunk=8, kv_quantize="int8", device=cs.DEV)
for i in range(2):
    cs.step_breakdown(engine)
cs.prefill_breakdown(engine, seed)
del engine
gc.collect()
torch.cuda.empty_cache()
case = cs.train_attn_case(gen, 2, 4096, True, False)
for kern, c in case.items():
    print(f"[{label}] {kern} B=2 S=4096 H=32 D=128 causal: {cs.fmt(c)}",
          flush=True)
torch.cuda.empty_cache()
c = cs.k3_case(gen, 1024, 0, False, b=3)
print(f"[{label}] flash_prefill B=3 S=1024 wave: {cs.fmt(c)}", flush=True)
torch.cuda.empty_cache()
cs.trainer_phase(seed, {n: case[n]["shape_key"] for n in
                        cs.TRAINING_KERNELS})
"""


def ab_main(other: str, seed: int) -> int:
    """--ab: the other tree and this one in turns, each in its own
    process; stops at the first run that fails."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    check(os.path.isfile(os.path.join(other, "chip_smoke.py")),
          f"--ab: no chip_smoke.py in {other}")
    for root, label in ((other, "other"), (here, "this"), (here, "this"),
                        (other, "other")):
        rc = subprocess.run([sys.executable, "-c", AB_RUN, root, label,
                             str(seed)]).returncode
        if rc != 0:
            print(f"chip_smoke --ab: the {label} run failed ({rc})",
                  file=sys.stderr)
            return rc
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="OTHER_TREE",
                    help="compare K1's decode step, K2, the decode step, "
                         "the prefill wave, the training kernels, K3 and "
                         "the trainer with another checkout instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.ab:
        return ab_main(args.ab, args.seed)
    # f32 references run in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "allow_tf32 matmul=False cudnn=False", flush=True)
    print(f"build stamp: {json.dumps(build_stamp())}", flush=True)
    t = time.monotonic()
    built = _build.build_all()
    print(f"build: {time.monotonic() - t:.2f} s for {len(built)} kernels; "
          "seconds each: " + json.dumps({name: round(sec, 2) for name, (sec, _)
                                          in built.items()}), flush=True)
    build_report(built)
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    seconds = {}

    def phase(name, fn, *a):
        t0 = time.monotonic()
        out = fn(*a)
        seconds[name] = round(time.monotonic() - t0, 2)
        print(f"phase {name}: {seconds[name]} s", flush=True)
        return out

    k1_step = phase("c kernels", kernel_phase, gen)
    phase("d reference", reference_phase, args.seed)
    engine, launches, shapes, prompts, tokens = phase(
        "e engine", engine_phase, args.seed)
    p_launches, p_shapes, paged = phase("e2 paged engine",
                                        paged_engine_phase, engine, prompts,
                                        tokens)
    launches["flash_decode_paged"] = p_launches["flash_decode_paged"]
    shapes["flash_decode_paged"] = p_shapes["flash_decode_paged"]
    e3_k3_shapes, _ = phase("e3 flagship engine", flagship_phase, engine,
                            args.seed)
    phase("e3 K3 shapes", continuation_shape_phase, gen, e3_k3_shapes)
    cases = {"quant_matmul": k1_step,
             **phase("f engine shapes", engine_shape_phase, gen, shapes)}
    phase("f step breakdown", step_breakdown, engine)
    phase("f paged step breakdown", step_breakdown, paged)
    phase("f prefill breakdown", prefill_breakdown, engine, args.seed)
    bd_launches, bd_shapes = phase("f2 serving breakdown",
                                   serving_breakdown_phase, engine, paged,
                                   prompts, tokens)
    del paged
    launches["flash_prefill_paged"] = bd_launches["flash_prefill_paged"]
    cases["flash_prefill_paged"] = phase(
        "f2 breakdown shapes", paged_prefill_shape_phase, gen, bd_shapes)
    phase("g server", server_phase, engine)
    del engine   # the engine holds reference cycles: collect it now, so
    gc.collect()   # the trainer's peak memory is the trainer's own
    torch.cuda.empty_cache()
    print(f"after serving: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          "still allocated", flush=True)
    train_cases = phase("h training kernels", train_attn_phase, gen)
    cases.update(train_cases)
    phase("i train reference", train_reference_phase, args.seed)
    train_launches, train_stats = phase(
        "j trainer", trainer_phase, args.seed,
        {name: train_cases[name]["shape_key"] for name in TRAINING_KERNELS})
    launches.update(train_launches)
    phase("j2 trainer profile window", trainer_profile_phase, args.seed,
          train_stats["step_time_s_median"])
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)
    kernels = []
    for name in _build.KERNELS:
        c = cases[name]
        source = name.removesuffix("_paged")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/csrc/{source}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": c["err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": c["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
