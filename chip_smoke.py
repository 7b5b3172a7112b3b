#!/usr/bin/env python3
"""End-to-end check of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

Phases:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the build: ``nvcc`` compiles the kernels of ``mxnet_tpu_torch/ops/csrc``
   into ``build/kernels/``, one process per source, all at once (timed;
   each source's largest register count and every function that spills,
   by name, with its registers and spilled bytes, from the compiler's
   report);
3. every kernel against its plain PyTorch version on the card, at the
   shapes the 124M LM's serving and training paths and ResNet-50 give it
   and at small ragged shapes, in every mode, each to a stated tolerance:
   the serving kernels (int8/int4 weights, float/int8 KV, C = 1/5/64/256,
   GQA, rope on/off, f32 and bf16; ``quant_matmul`` and
   ``fused_decode_attention`` also held batch-invariant, bitwise: rows of
   x[:1], x[:7], x[:32], x[:256] against the same rows of the 256-row
   product at every 124M shape, int8 and int4, and slot subsets at S = 1,
   5 and 32 of a 124M step, 12 and 4 kv heads; ``paged_attention``'s
   decode entry at
   C = 1/2/4/15 with pos on its split edges, GQA 12->3 and 12->4, head_dim
   16-128 and NaN past the live rows, its chunk entry at
   C = 16/64/100/128/256, pos 0, 512 and L-C, one and three slots, GQA,
   and with NaN in the dead cache rows, each case asserted on the entry
   its route picks; the int8 cache at the chunk entry's breadth with NaN
   in the row scales past the live keys; the scalar entry at an f32 q over
   an f32 cache at C = 64 and 256, bf16 at head_dim 100, and the int8
   cache under an f32 q); ``flash_attention`` forward, dQ and
   dK/dV (B=8 T=1024 12 heads of 64 causal bf16; T=100 and T=1000,
   non-causal, window 33, f32 and bf16, head_dim 8-128; two runs of the
   bf16 backward give the same bits) and through
   ``MultiHeadAttention`` with GQA, rope and a window against the host;
   ``fused_linear`` (M=8192 K=768 N=3072 bf16 relu, and in f32; the SP
   path's M=2048 f32 relu; M=100 K=70 N=130 in f32 and bf16 with every
   activation, with and without the folded-BN ``scale``; f32 at M=129
   N=65 with K = 3, 5, 767 and from a misaligned view); ``matmul_stats``
   (each 1x1 conv of ResNet-50 at the main path's B=256, ragged M, K and
   N in f32 and bf16; the column sums to a stated share of their sums of
   magnitudes); ``fused_conv_bn_act`` (each conv of ResNet-50 at B=256 in
   f32 from an NCHW and a channels-last x and in bf16, small ragged convs
   with stride, pad, dilation and a non-square kernel, relu and linear,
   f32 and bf16, NCHW and channels-last; the Winograd path's ragged edges
   and the 3x3 convs its rule leaves to the implicit GEMM, each with its
   path); ``striped_pair_attention``
   forward, dQ and dK/dV (every ring position pair of the SP path's hop,
   [24, 1024, 64] at n=4, f32 and bf16; n=1, also held against flash
   causal; n=3 at a ragged C=100; head_dim 32-128, and 8 and 16 in f32; a
   random g_o and a nonzero g_lse). Then each
   kernel's time (CUDA
   events, median of 25 launches with the 50 MB L2 flushed before each and
   the host's launch overhead kept out) beside its plain version's, its
   bound, and one PyTorch library call computing the same function where
   there is one (``quant_matmul`` at every 124M product at M = 32 and
   256, also beside ``F.linear`` on the weight dequantized to bf16;
   ``fused_linear`` at the LM's bf16 ffn1, with the SP
   path's f32 ffn1 beside it; flash's f32 backward at B=1;
   ``fused_conv_bn_act`` in f32, the eval forward's path, at the stride-1
   3x3 convs of stages 1-4 (Winograd; the bound also from the direct
   product), the stem and a 1x1 stride-2 projection, with the bf16 row
   beside them; the striped hop's forward and backward beside the
   efficient-attention calls; the paged chunk at C =
   64/128/256 in bf16 and at the int8-KV prefill's C = 256 with the int8
   cache, and the decode entry at C = 1 (bf16 beside SDPA with a mask,
   and int8) and C = 4, each beside the scalar paged entry on the same
   inputs, in turns; the scalar entry's own row at an f32 C = 256 chunk,
   which no path runs);
4. the serving main path: the 124M LM (12 layers, E=768, 12 heads, vocab
   32000, seeded random weights) saved with ``save_checkpoint`` and served
   by ``InferenceEngine.from_checkpoint`` with paged attention, int8
   weights and the fused decode kernel (max_len 1024, 32 slots, buckets
   64/128/256, 8 steps per round, bf16), 9 waves of the same 24 staggered
   greedy requests; the launch counters are zeroed just before the first
   wave and read just after the last; every wave's streams equal the
   first's, two requests' streams equal the offline ``Decoder.generate``,
   each prefill chunk goes through ``paged_attention_chunk`` (12 launches
   a prefill, none of the scalar entry), and the same 124M LM rebuilt on
   the host (plain versions) agrees with the card's logits and tokens to
   a stated bf16 tolerance. The engine runs compiled programs (CUDA
   graphs): its ``compile_counts`` must be the JAX contract (one decode
   program, one prefill program per bucket); the same wave run uncaptured
   (``Program._run_eager``) must give the same 24 streams; one sampled
   request alone and inside a busy wave, captured and uncaptured, must
   give one stream. Then a window of decode rounds with every slot busy,
   captured and uncaptured (wall time and the card's time per step by
   CUDA events and by the profiler, the idle share, the host calls per
   round, the kernels by device time, peak memory; the trace goes to
   ``chiprun_out/``); one 256-token prefill's wall and card time through
   the (uncaptured) decoder and through the engine's captured bucket
   program; then the same checkpoint
   served by the engine's default configuration (float weights, dense
   products: ``paged_attention_decode`` for every decode step's read) and
   with the int8 KV cache (the decode entry for decode steps,
   ``paged_attention_chunk`` for prefills, no launch of the scalar
   entry), one wave each, counters zeroed just before and read just
   after, exact launches, two streams equal to ``Decoder.generate``, the
   JAX compile contract, the default one's decode profile and the int8
   one's 256-token prefill timed (decoder and engine); then small
   LMs in the decoder's other modes (int4 weights, the int8 KV cache
   through the C=1 paged read, float weights, rope, GQA) are held against
   the plain path on the host;
5. the training main path: the same 124M LM (``impl="flash"``) trained by
   ``ParallelTrainer(device=None)`` in bf16 with SGD (lr 1e-3, momentum
   0.9) at B=8, T=1024 on a repeated seeded batch, as ``bench.py``'s
   ``bench_transformer_lm`` trains it: 3 warm-up steps, then 12 timed
   steps with the launch counters zeroed just before and read just after
   (12 launches of each of flash forward, dQ, dK/dV and ``fused_linear``
   per step, asserted exactly); tokens/s (median, min-max), ms per step,
   peak memory and MFU; the loss must fall; a profiled window of 2 steps
   (busy share, host calls, kernels by device time, trace to
   ``chiprun_out/``); the same step uncaptured (``Program._run_eager``),
   timed and profiled; one captured step equal bitwise to one uncaptured
   step from the same parameters, ``multi_step(batch, 3)`` equal bitwise
   to 3 captured steps, the cost of ``step()``'s output copy, and 12
   steps as one ``multi_step``; then
   one f32 step of the same LM at B=1, T=128 from the same seeded weights
   on the card and on the host, whose parameter deltas must agree;
6. the conv-net path: ResNet-50 (``get_resnet(1000, 50)``) trained by
   ``ParallelTrainer(device=None)`` as ``bench.py``'s ``bench_resnet50``
   trains it (B=256, 224 x 224, bf16 over f32 master weights, SGD lr 0.1
   momentum 0.9 wd 1e-4, default init, a device-resident seeded batch)
   with ``MXNET_PALLAS_CONVBN_TRAIN=1``: 3 warm-up and 12 timed steps with
   exactly 33 ``matmul_stats`` launches per step and a falling loss, img/s,
   ms per step, MFU, peak memory and a 2-step profile (its trace beside
   the others); the same 12 steps with the gate unset, by a trainer built
   with it unset (the step program reads the gate when it is built; no
   launch);
   ``trainer.forward()`` at B=256 (f32, as the JAX package's eval runs on
   the master parameters) with exactly 53 ``fused_conv_bn_act`` launches
   per forward, and timed again with no chain fused; then ResNet-50 in f32
   at B=2 on the card and on the host from the same weights: the eval
   log-probabilities and top-1, and one train step's parameter deltas,
   must agree;
7. the sequence-parallel path: ``striped_ring_attention`` on a 4-rank mesh
   over one card (``[cuda:0] * 4``) against dense causal attention; the
   124M LM (``impl="ring_striped"``) trained by
   ``SequenceParallelTrainer`` on the mesh {dp: 1, sp: 4} at B=2, T=4096
   in f32 (SGD lr 1e-3 momentum 0.9): 3 warm-up and 12 timed steps with
   exactly 192 launches of each ``striped_pair`` entry and 48 of
   ``fused_linear`` per step, a falling loss, tokens/s, a 2-step profile;
   then one f32 step of it at B=1, T=1024 against
   ``ParallelTrainer(impl="flash")`` from the same weights, whose
   parameter deltas must agree;
8. the ``{"kernels": [...]}`` line (every C entry), the card's line, and
   the result line ``{"ok": true, "device": {...}}`` last.

Any failure raises, so the script exits non-zero and prints no result. It
needs a CUDA card and the rest of the repository beside it.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM figures used for the bound (NVIDIA's data sheet, dense rates
# at the 700 W limit): 3.35 TB/s of device memory, 989 TFLOP/s bf16 on
# the tensor cores, 67 TFLOP/s f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# |kernel - plain| <= ATOL + RTOL * |plain|, per output dtype: f32 sums
# run in another order; bf16 outputs may round one unit apart (2^-8)
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}

TIMING_RUNS = 25

# C entries no main path launches: the kernels line reports 0 for them
OFF_PATH = ("paged_attention",)


def log(*a):
    print(*a, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------

class Timer:
    """Median device time of ``fn`` over TIMING_RUNS launches, each timed
    by CUDA events after the L2 is flushed by a 64 MB write. The card
    first spins (~50 ms) while the host queues every run behind the spin,
    so the events time the card's work and none of the host's launch
    overhead."""

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        self.spin_cycles = 100_000_000
        a, b = self._events(1)[0]
        a.record()
        torch.cuda._sleep(self.spin_cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = self.spin_cycles / a.elapsed_time(b)

    @staticmethod
    def _events(n):
        return [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(n)]

    def __call__(self, fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = self._events(TIMING_RUNS)
        torch.cuda._sleep(self.spin_cycles)
        t0 = time.perf_counter()
        for a, b in events:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < 0.8 * self.spin_cycles / self.cycles_per_ms:
            return statistics.median(a.elapsed_time(b) for a, b in events)
        # fn waited on the card (a host read of a device value), so the
        # spin could not hide the queueing: time each run on its own; its
        # time then includes that wait, as the caller of fn sees it
        times = []
        for a, b in events:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes, flops, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for the inputs' type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def compare(name, got, want):
    """Max |got - want|, raising past the dtype's tolerance."""
    atol, rtol = TOL[want.dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if not torch.isfinite(g).all() or bad.any():
        raise AssertionError(
            "%s: kernel disagrees with the plain version: max |err| %.3g "
            "(atol %g, rtol %g), %d of %d outside" % (
                name, err.max().item(), atol, rtol, int(bad.sum()),
                bad.numel()))
    return err.max().item()


# -- phase 3: kernels against their plain versions ------------------------

def _rand(gen, shape, dtype=torch.float32, scale=1.0):
    """Seeded normal values, drawn where ``gen`` lives (a generator on the
    card draws the ResNet-50 shapes' gigabytes without the host)."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


def _weights(gen, f, e, bits, group, dev):
    from mxnet_tpu_torch.serving.quant import quantize_tensor
    w = (torch.rand((f, e), generator=gen) - 0.5) * 0.1   # U(-0.05, 0.05)
    qt = quantize_tensor(w, bits=bits, group=group)
    return qt.q.to(dev), qt.scale.to(dev)


def _cache(gen, s, l_, kv, d, kind, dev):
    """k, v (and row scales for int8) on the card."""
    if kind == "int8":
        k = torch.randint(-127, 128, (s, l_, kv, d), generator=gen,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (s, l_, kv, d), generator=gen,
                          dtype=torch.int8)
        ks = torch.rand((s, l_, kv), generator=gen) * 0.02 + 1e-3
        vs = torch.rand((s, l_, kv), generator=gen) * 0.02 + 1e-3
        return k.to(dev), v.to(dev), ks.to(dev), vs.to(dev)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    return (_rand(gen, (s, l_, kv, d), dt).to(dev),
            _rand(gen, (s, l_, kv, d), dt).to(dev), None, None)


def check_quant_matmul(K, dev, gen):
    """Every mode: int8 and int4 (groups 2, 16), f32/bf16 in and out, odd
    M and F (both forms of the tile: the tensor cores take bf16 x with E a
    multiple of 128 and int4 groups of a multiple of 16); then the 124M
    decode and prefill shapes. Then the batch-invariance gate: at every
    124M shape, int8 and int4 (group 128), the rows of x[:1], x[:7],
    x[:32] and x[:256] through the kernel are bitwise equal to the same
    rows of the product of all 256."""
    cases = []
    for bits, group in ((8, None), (4, 2), (4, 16)):
        for xdt in (torch.float32, torch.bfloat16):
            for m, f, e in ((1, 37, 48), (7, 100, 96), (33, 65, 32),
                            (1, 37, 128), (33, 65, 256), (40, 130, 1024)):
                cases.append(("ragged", m, f, e, bits, group, xdt, xdt))
    cases.append(("ragged", 5, 40, 64, 8, None, torch.bfloat16,
                  torch.float32))
    for m in (32, 256):
        for f, e in ((2304, 768), (768, 768), (3072, 768), (768, 3072),
                     (32000, 768)):
            cases.append(("124M", m, f, e, 8, None, torch.bfloat16,
                          torch.bfloat16))
        cases.append(("124M", m, 3072, 768, 4, 128, torch.bfloat16,
                      torch.bfloat16))
        cases.append(("124M", m, 768, 3072, 4, 16, torch.float32,
                      torch.float32))
    worst = 0.0
    for tag, m, f, e, bits, group, xdt, odt in cases:
        x = _rand(gen, (m, e), xdt).to(dev)
        q, s = _weights(gen, f, e, bits, group, dev)
        got = K.quant_matmul(x, q, s, bits=bits, group=group, out_dtype=odt)
        want = K.quant_matmul_plain(x, q, s, bits, group, odt)
        torch.cuda.synchronize()
        err = compare("quant_matmul %s m=%d f=%d e=%d bits=%d" % (
            tag, m, f, e, bits), got, want)
        worst = max(worst, err)
    log("quant_matmul: %d cases agree, max |err| %.3g" % (len(cases), worst))
    gates = 0
    for f, e in QMM_SHAPES:
        for bits, group in ((8, None), (4, 128)):
            x = _rand(gen, (256, e), torch.bfloat16).to(dev)
            q, s = _weights(gen, f, e, bits, group, dev)
            full = K.quant_matmul(x, q, s, bits=bits, group=group)
            for m in (1, 7, 32, 256):
                rows = K.quant_matmul(x[:m].clone(), q, s, bits=bits,
                                      group=group)
                if not torch.equal(rows, full[:m]):
                    raise AssertionError(
                        "quant_matmul F=%d E=%d bits=%d: rows of x[:%d] "
                        "differ from the same rows of the 256-row product "
                        "(max |diff| %.3g)" % (f, e, bits, m, (
                            rows.float() - full[:m].float()).abs().max()))
                gates += 1
    log("quant_matmul: batch invariance, %d subsets bitwise equal to the "
        "256-row product" % gates)
    return worst


# the 124M LM's quantized products (F, E): qkv, proj, ffn1, ffn2, lm_head
QMM_SHAPES = ((2304, 768), (768, 768), (3072, 768), (768, 3072),
              (32000, 768))


def paged_cases(sms):
    """(S, C, H, KV, D, L, cache, q dtype, pos, dead rows NaN): float and
    int8 KV, C in {1, 5, 64, 256}, GQA 12->4, pos at 0, in the middle and at
    L-C; f32 and bf16; the 124M shapes in bf16. Then the short chunks the
    decode entry takes on a card of ``sms`` SMs: C in {1, 2, 4, 15} with
    pos on the edges of its key ranges (range - 1, range, L - C) and L not
    a multiple of the range (L = 1001, ranges of 126 keys at head_dim 64),
    GQA 12->3 and 12->4, NaN past each slot's live rows at C = 1 and 4, the
    int8 and f32 caches, and head_dim 16, 32, 100 and 128. Then the chunks
    the chunk entry takes, a bf16 q over the bf16 and over the int8 cache
    alike: C in {16, 64, 100, 128, 256}, pos 0, 512 and L-C (L=1024), one
    slot and three slots at those three positions, GQA 12->4 and 12->12,
    cases whose cache rows (int8: whose row scales) past each slot's live
    keys hold NaN (never read), and head_dim 16, 32 and 128. Then what the
    scalar entry still takes: an f32 q over an f32 cache at C = 64 and
    256, bf16 at head_dim 100 with C = 64, and the int8 cache under an f32
    q, with NaN scales past the live keys."""
    from mxnet_tpu_torch.ops.kernels import paged_decode_splits

    def edges(l_, d, c):
        w = -(-l_ // paged_decode_splits(l_, d, sms))
        return [w - 1, w, l_ - c]

    bf = torch.bfloat16
    f32 = torch.float32
    cases = []
    for kind in ("f32", "bf16", "int8"):
        for qdt in (torch.float32, bf):
            for c in (1, 5):
                for h, kv in ((12, 4), (4, 4)):
                    cases.append((3, c, h, kv, 64, 64, kind, qdt,
                                  [0, 31, 64 - c], False))
    cases.append((2, 64, 12, 4, 64, 128, "int8", bf, [0, 64], False))
    cases.append((1, 256, 12, 12, 64, 1024, "bf16", bf, [0], False))
    cases.append((1, 256, 12, 12, 64, 1024, "int8", bf, [0], False))
    cases.append((1, 64, 12, 12, 64, 1024, "bf16", bf, [0], False))
    cases.append((32, 1, 12, 12, 64, 1024, "bf16", bf, None, False))
    for c in (1, 2, 4, 15):
        for h, kv in ((12, 3), (12, 4)):
            cases.append((3, c, h, kv, 64, 1001, "bf16", bf,
                          edges(1001, 64, c), False))
    for c in (1, 4):
        for h, kv in ((12, 3), (12, 4)):
            cases.append((3, c, h, kv, 64, 1001, "bf16", bf,
                          edges(1001, 64, c), True))
    cases += [(3, 1, 12, 4, 64, 1001, "int8", bf, edges(1001, 64, 1), False),
              (3, 4, 12, 12, 64, 1001, "int8", bf, edges(1001, 64, 4),
               False),
              (3, 2, 12, 3, 64, 1001, "f32", f32, edges(1001, 64, 2), False)]
    for d, l_ in ((16, 1001), (32, 1001), (100, 1000), (128, 1001)):
        cases.append((3, 4, 12, 4, d, l_, "bf16", bf, edges(l_, d, 4),
                      False))
    cases.append((3, 1, 12, 3, 100, 1000, "int8", f32, edges(1000, 100, 1),
                  False))
    for kind in ("bf16", "int8"):
        for c in (16, 64, 100, 128, 256):
            for h, kv in ((12, 12), (12, 4)):
                at = [0, 512, 1024 - c]
                cases += [(1, c, h, kv, 64, 1024, kind, bf, [p], False)
                          for p in at]
                cases.append((3, c, h, kv, 64, 1024, kind, bf, at, False))
        cases += [(3, 100, 12, 4, 64, 1024, kind, bf, [0, 300, 924], True),
                  (1, 256, 12, 12, 64, 1024, kind, bf, [0], True)]
        cases += [(2, 100, 4, 2, d, 256, kind, bf, [0, 156], False)
                  for d in (16, 32, 128)]
        cases.append((3, 64, 12, 4, 128, 1024, kind, bf, [0, 300, 960],
                      True))
    cases += [(2, 64, 12, 4, 64, 1024, "f32", f32, [0, 960], False),
              (1, 256, 12, 12, 64, 1024, "f32", f32, [0], False),
              (2, 64, 12, 4, 100, 1000, "bf16", bf, [0, 936], False),
              (2, 64, 12, 4, 64, 1024, "int8", f32, [0, 512], False),
              (3, 100, 12, 4, 64, 1024, "int8", f32, [0, 300, 924], True)]
    return cases


def check_paged_attention(K, dev, gen):
    """Every case of ``paged_cases`` against the plain version, on the C
    entry ``K.paged_entry`` picks for it (asserted from the launch
    counters); every entry takes some case. A case with NaN past each
    slot's live rows (in the rows of a float cache, in the row scales of
    an int8 one) is held against the plain version slot by slot (it reads
    up to the largest pos + C of its batch). Returns {entry: max
    |err|}."""
    worst = {"paged_attention": 0.0, "paged_attention_chunk": 0.0,
             "paged_attention_decode": 0.0}
    counts = dict.fromkeys(worst, 0)
    cases = paged_cases(K._sm_count(dev))
    for s_, c, h, kv, d, l_, kind, qdt, pos, nan in cases:
        if pos is None:
            pos = torch.randint(0, l_ - c + 1, (s_,), generator=gen)
        pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
        q = _rand(gen, (s_, c, h, d), qdt).to(dev)
        k, v, ks, vs = _cache(gen, s_, l_, kv, d, kind, dev)
        if nan:
            for i, p in enumerate(pos.tolist()):
                for t in ((ks, vs) if kind == "int8" else (k, v)):
                    t[i, p + c:] = float("nan")
        entry = K.paged_entry(q.dtype, k.dtype, c, d)
        before = K.launch_counts()
        got = K.paged_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
        after = K.launch_counts()
        if nan:
            want = torch.cat([K.paged_attention_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], pos[i:i + 1],
                None if ks is None else ks[i:i + 1],
                None if vs is None else vs[i:i + 1])
                for i in range(s_)])
        else:
            want = K.paged_attention_plain(q, k, v, pos, ks, vs)
        torch.cuda.synchronize()
        ran = {e for e in after if after[e] != before[e]}
        if ran != {entry}:
            raise AssertionError("paged_attention s=%d c=%d %s %s launched %s,"
                                 " its route is %s" % (s_, c, kind, qdt,
                                                       sorted(ran), entry))
        err = compare("%s s=%d c=%d h=%d kv=%d d=%d l=%d pos=%s %s %s%s" % (
            entry, s_, c, h, kv, d, l_, pos.tolist()[:3], kind, qdt,
            " NaN past the live rows" if nan else ""), got, want)
        worst[entry] = max(worst[entry], err)
        counts[entry] += 1
    idle = [e for e, n in counts.items() if not n]
    if idle:
        raise AssertionError("paged_attention: no case reached %s" % idle)
    log("paged_attention: %d cases agree, %s by entry (%d with NaN past "
        "the live rows); max |err| %s" % (
            sum(counts.values()), counts, sum(1 for cs in cases if cs[-1]),
            {k_: "%.3g" % v_ for k_, v_ in worst.items()}))
    return worst


def _fused_inputs(gen, s_, h, kv, d, l_, bits, group, xdt, cdt, dev, pos):
    e = h * d
    fq = e + 2 * kv * d
    wq, sq = _weights(gen, fq, e, bits, group, dev)
    wo, so = _weights(gen, e, e, bits, group, dev)
    bq = _rand(gen, (fq,), scale=0.1).to(dev)
    bo = _rand(gen, (e,), scale=0.1).to(dev)
    x = _rand(gen, (s_, e), xdt).to(dev)
    kc = _rand(gen, (s_, l_, kv, d), cdt).to(dev)
    vc = _rand(gen, (s_, l_, kv, d), cdt).to(dev)
    if pos is None:
        pos = torch.randint(0, l_, (s_,), generator=gen)
    pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
    return x, pos, kc, vc, wq, sq, bq, wo, so, bo


def check_fused_decode_attention(K, dev, gen):
    """int8 and int4 (group 16), rope on and off, GQA 12->4, pos at 0,
    in the middle and at L-1; f32 and bf16; the 124M shape in bf16, with
    12 and with 4 kv heads (and with pos on the edges of the read's key
    ranges), and in int4 (group 128) with rope. Then the
    batch-invariance gate: slots [5], [0, 3, 9, 20, 31] and all 32 of a
    124M step (int8, rope, 12 and 4 kv heads) give bitwise the same rows
    as among all 32."""
    cases = []
    for bits, group in ((8, None), (4, 16)):
        for rope in (True, False):
            for dt in (torch.float32, torch.bfloat16):
                cases.append((3, 12, 4, 8, 40, bits, group, rope, dt,
                              [0, 17, 39]))
    cases.append((4, 12, 12, 64, 128, 8, None, True, torch.bfloat16,
                  [0, 1, 63, 127]))
    cases.append((32, 12, 12, 64, 1024, 8, None, False, torch.bfloat16,
                  None))
    cases.append((32, 12, 4, 64, 1024, 8, None, True, torch.bfloat16,
                  None))
    cases.append((4, 12, 4, 64, 1024, 8, None, True, torch.bfloat16,
                  [511, 512, 513, 1023]))     # the key ranges' edges
    cases.append((32, 12, 12, 64, 1024, 4, 128, True, torch.bfloat16,
                  [0, 1023] + [None] * 30))
    worst = 0.0
    for s_, h, kv, d, l_, bits, group, rope, dt, pos in cases:
        if pos is not None and None in pos:
            pos = [p if p is not None else int(torch.randint(
                0, l_, (1,), generator=gen)) for p in pos]
        args = _fused_inputs(gen, s_, h, kv, d, l_, bits, group, dt, dt,
                             dev, pos)
        kw = dict(heads=h, kv_heads=kv, bits=bits, group=group, rope=rope)
        got = K.fused_decode_attention(*args, **kw)
        cos, sin = K._rope_tables(args[1], d // 2, rope, 10000.0)
        want = K.fused_decode_attention_plain(
            *args[:6], args[6].float(), *args[7:9], args[9].float(), cos,
            sin, h, bits, group, 1.0 / math.sqrt(d))
        torch.cuda.synchronize()
        for part, g_, w_ in zip(("out", "k_new", "v_new"), got, want):
            err = compare("fused_decode_attention %s s=%d h=%d kv=%d l=%d "
                          "bits=%d rope=%s %s" % (part, s_, h, kv, l_, bits,
                                                   rope, dt), g_, w_)
            worst = max(worst, err)
    log("fused_decode_attention: %d cases agree, max |err| %.3g"
        % (len(cases), worst))
    for kv in (12, 4):
        args = _fused_inputs(gen, 32, 12, kv, 64, 1024, 8, None,
                             torch.bfloat16, torch.bfloat16, dev, None)
        kw = dict(heads=12, kv_heads=kv, bits=8, rope=True)
        full = K.fused_decode_attention(*args, **kw)
        for rows in ([5], [0, 3, 9, 20, 31], list(range(32))):
            sub = [a[rows].contiguous() if i < 4 else a
                   for i, a in enumerate(args)]
            for part, g_, f_ in zip(("out", "k_new", "v_new"),
                                    K.fused_decode_attention(*sub, **kw),
                                    full):
                if not torch.equal(g_, f_[rows]):
                    raise AssertionError(
                        "fused_decode_attention kv=%d: %s of slots %s alone"
                        " differs from the same slots among 32" % (
                            kv, part, rows[:5]))
    log("fused_decode_attention: batch invariance, slots at S=1, 5, 32 "
        "bitwise equal to the same slots among 32 (kv heads 12 and 4)")
    return worst


def time_kernels(K, dev, gen, worst):
    """Each kernel at a main-path shape of the 124M LM: its time, its
    plain version's, its bound and a library call's, in one entry of the
    kernels line (rows at the other main-path shapes are printed too)."""
    import torch.nn.functional as F
    timer = Timer(dev)
    entries = {}

    def row(name, shape, fn, plain, lib, nb, flops, dtype):
        ms, pms = timer(fn), timer(plain)
        lms = timer(lib) if lib is not None else None
        bms, by = bound_ms(nb, flops, dtype)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %s  "
            "bound %.4f ms (%s)" % (name, shape, ms, pms,
                                    "%.4f ms" % lms if lms else "none",
                                    bms, by))
        return {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "library_ms": lms, "shape": shape}

    # quant_matmul: every product of a 124M decode step (M = 32 slots)
    # and of a prefill at the largest bucket (M = 256); beside the library
    # call (the f32 product of the dequantized weight), dense_bf16_ms:
    # F.linear on the weight already dequantized to bf16, twice the bytes
    for m in (32, 256):
        for (f, e), what in zip(QMM_SHAPES, ("qkv", "proj", "ffn1", "ffn2",
                                             "lm_head")):
            x = _rand(gen, (m, e), torch.bfloat16).to(dev)
            q, s = _weights(gen, f, e, 8, None, dev)
            out = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
            r = row("quant_matmul", "%s M=%d F=%d E=%d" % (what, m, f, e),
                    lambda: K.quant_matmul(x, q, s),
                    lambda: K.quant_matmul_plain(x, q, s, 8, None,
                                                 torch.bfloat16),
                    lambda: torch.matmul(x.float(),
                                         (q.float() * s[:, None]).t()),
                    nbytes(x, q, s, out), 2 * m * f * e, torch.bfloat16)
            wd = (q.float() * s[:, None]).to(torch.bfloat16)
            r["dense_bf16_ms"] = timer(lambda: F.linear(x, wd))
            log("  quant_matmul %s M=%d: F.linear on the bf16 weight %.4f "
                "ms" % (what, m, r["dense_bf16_ms"]))
            del wd
            if what == "lm_head" and m == 32:
                entries["quant_matmul"] = r

    # paged_attention: the serving buckets' prefill chunks (C = 64, 128,
    # 256 at pos 0) on the chunk entry, and the int8-KV serve's C = 256
    # chunk on it too (the chunk row's "int8"); the scalar entry's own row
    # at an f32 C = 256 chunk, on no path; then the decode entry at C = 1
    # over 32 slots with a bf16 cache (the default serving configuration's
    # read, beside SDPA with a mask) and with the int8 cache (the int8-KV
    # serve's), and at C = 4 (a spec_k = 3 verify chunk). Each row off the
    # scalar entry puts the scalar entry beside it on the same inputs, in
    # turns.
    l_, h, d = 1024, 12, 64
    for s_, c, pos, kind in ((1, 64, [0], "bf16"), (1, 128, [0], "bf16"),
                             (1, 256, [0], "bf16"), (1, 256, [0], "int8"),
                             (1, 256, [0], "f32"),
                             (32, 1, None, "bf16"), (32, 1, None, "int8"),
                             (32, 4, None, "bf16")):
        if pos is None:
            pos = torch.randint(0, l_ - c + 1, (s_,), generator=gen)
        pos = torch.as_tensor(pos, dtype=torch.int32).to(dev)
        qdt = torch.float32 if kind == "f32" else torch.bfloat16
        q = _rand(gen, (s_, c, h, d), qdt).to(dev)
        k, v, ks, vs = _cache(gen, s_, l_, h, d, kind, dev)
        keys = [int(p) + cc + 1 for p in pos.tolist() for cc in range(c)]
        live_rows = sum(int(p) + c for p in pos.tolist())
        nb = nbytes(q) * 2 + live_rows * h * d * k.element_size() * 2 \
            + (live_rows * h * 4 * 2 if ks is not None else 0)
        flops = 4 * h * d * sum(keys)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        entry = K.paged_entry(q.dtype, k.dtype, c, d)
        shape = "S=%d C=%d H=12 L=1024 %s KV%s" % (
            s_, c, kind, ", f32 q" if kind == "f32" else "")
        lib = None
        if c < 16 and kind == "bf16":
            mask = (torch.arange(l_, device=dev)[None, None, :]
                    <= pos[:, None, None].long()
                    + torch.arange(c, device=dev)[None, :, None]
                    )[:, None]                            # [S, 1, C, L]

            def lib():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
        elif kind != "int8":
            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt[:, :, :c], vt[:, :, :c], is_causal=True)

        def wrapper():
            return K.paged_attention(q, k, v, pos, k_scale=ks, v_scale=vs)
        r = row(entry, shape, wrapper,
                lambda: K.paged_attention_plain(q, k, v, pos, ks, vs),
                lib, nb, flops, qdt)
        if entry != "paged_attention":
            out = torch.empty_like(q)
            P = K._ptr

            def scalar():
                K._launch("paged_attention", P(q), P(k), P(v), P(ks),
                          P(vs), P(pos), P(out), s_, c, h, h, l_, d,
                          1.0 / math.sqrt(d), K._CODE[q.dtype],
                          K._CODE[k.dtype])
            sms = [timer(f) for f in (scalar, wrapper, wrapper, scalar)]
            log("  A/B %s: scalar entry %.4f ms, %s %.4f ms, %.4f ms, "
                "scalar %.4f ms (same inputs, in turns)"
                % (shape, sms[0], entry, sms[1], sms[2], sms[3]))
            r["scalar_ms"] = statistics.median([sms[0], sms[3]])
        if entry == "paged_attention_decode" and c == 1 and kind == "bf16":
            entries[entry] = r
        elif entry == "paged_attention_decode" or kind == "int8":
            entries[entry]["int8" if kind == "int8" else "c%d" % c] = {
                k_: r[k_] for k_ in ("ms", "scalar_ms", "plain_ms",
                                     "library_ms", "bound_ms", "shape")}
        elif c == 256:
            entries[entry] = r

    # fused_decode_attention: one decode step of one attention node
    s_, h, d, l_ = 32, 12, 64, 1024
    args = _fused_inputs(gen, s_, h, h, d, l_, 8, None, torch.bfloat16,
                         torch.bfloat16, dev, None)
    x, pos = args[0], args[1]
    kw = dict(heads=h, kv_heads=h, bits=8, rope=False)
    cos, sin = K._rope_tables(pos, d // 2, False, 10000.0)
    e = h * d
    live = sum(pos.tolist())
    nb = nbytes(x, pos, *args[4:]) + live * h * d * 2 * 2 \
        + nbytes(x) + 2 * s_ * h * d * 2
    flops = 2 * s_ * (3 * e * e + e * e) + 4 * h * d * (live + s_)
    entries["fused_decode_attention"] = row(
        "fused_decode_attention", "S=32 E=768 L=1024 int8",
        lambda: K.fused_decode_attention(*args, **kw),
        lambda: K.fused_decode_attention_plain(
            *args[:6], args[6].float(), *args[7:9], args[9].float(), cos,
            sin, h, 8, None, 1.0 / math.sqrt(d)),
        None, nb, flops, torch.bfloat16)
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


# -- phase 3b: the training kernels against their plain versions ------------

# bf16 flash gradients: |kernel - plain| <= GRAD_REL * max|plain| per
# tensor. The kernels round P and dS to bf16 (2^-9 relative) for the
# products with V, K, Q and dO, where the plain version keeps them f32; a
# gradient sums up to T such rounded terms of mixed sign, and the results
# are stored in bf16 (2^-9 relative of the largest value): a few bf16 ulps
# of the tensor's largest value, not of each element (elements near 0 come
# from cancelling sums)
GRAD_REL = 2.0 ** -6


def compare_scaled(name, got, want, rel):
    """Max |got - want| / max|want|, raising past ``rel``."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    top = w.abs().max().item()
    if not torch.isfinite(g).all() or err > rel * top:
        raise AssertionError(
            "%s: kernel disagrees with the plain version: max |err| %.3g, "
            "%.3g of max |plain| %.3g (gate %.3g)" % (
                name, err, err / max(top, 1e-30), top, rel))
    return err


def _flash_inputs(gen, b, t, h, d, dtype, dev):
    return [_rand(gen, (b, t, h, d), dtype).to(dev) for _ in range(4)]


def flash_cases():
    """(B, T, H, D, causal, window, dtype, scale): the 124M training shape,
    then ragged lengths (T=100, T=1000: not multiples of the 64-row tiles),
    non-causal and windowed, f32 and bf16, every head_dim the kernels take,
    and a negative and a zero scale (None: 1/sqrt(D))."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(8, 1024, 12, 64, True, 0, bf, None)]
    for dt in (f32, bf):
        for t in (100, 1000):
            cases += [(2, t, 3, 64, True, 0, dt, None),
                      (2, t, 3, 64, False, 0, dt, None),
                      (2, t, 3, 64, True, 33, dt, None)]
        for d in (16, 32, 128) + ((8,) if dt is f32 else ()):
            cases.append((2, 77, 2, d, True, 5 if d == 32 else 0, dt, None))
        cases += [(2, 100, 3, 64, True, 0, dt, -0.125),
                  (2, 100, 3, 64, False, 0, dt, 0.0)]
    return cases


def check_flash_attention(K, dev, gen):
    """Forward (o, lse), then dQ and dK/dV from the same o and lse, kernel
    against plain, in every case of ``flash_cases``; then the f32 forward
    and backward from q/k/v views whose rows are off 16-byte boundaries and
    from a dO off one. Returns the largest errors: {entry: max |err|}."""
    worst = {"flash_attention_fwd": 0.0, "flash_attention_dq": 0.0,
             "flash_attention_dkv": 0.0}
    for b, t, h, d, causal, window, dt, scale in flash_cases():
        q, k, v, do = _flash_inputs(gen, b, t, h, d, dt, dev)
        kw = dict(causal=causal, window=window, scale=scale)
        tag = "B=%d T=%d H=%d D=%d causal=%s window=%d scale=%s %s" % (
            b, t, h, d, causal, window, scale, dt)
        o, lse = K.flash_attention_fwd(q, k, v, **kw)
        o_p, lse_p = K.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                 window)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        grads_p = K.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                              scale, window)
        torch.cuda.synchronize()
        worst["flash_attention_fwd"] = max(
            worst["flash_attention_fwd"],
            compare("flash fwd o " + tag, o, o_p),
            compare("flash fwd lse " + tag, lse, lse_p))
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p):
            entry = "flash_attention_dq" if name == "dq" else \
                "flash_attention_dkv"
            err = compare("flash %s %s" % (name, tag), g_, w_) \
                if dt is torch.float32 else \
                compare_scaled("flash %s %s" % (name, tag), g_, w_, GRAD_REL)
            worst[entry] = max(worst[entry], err)
    # the f32 kernels' 4-byte copies: q, k and v as views into one buffer
    # whose rows lie 97 floats apart, off 16-byte boundaries, with dO
    # starting one float past a 16-byte boundary; then contiguous q, k and
    # v with only dO (and o) off a boundary, so that dO alone picks the
    # backward's copies
    b, t, h, d = 2, 77, 2, 16
    buf = _rand(gen, (b, t, 3 * h * d + 1)).to(dev)
    views = [buf[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
             for i in range(3)]
    q0, k0, v0, do0 = _flash_inputs(gen, b, t, h, d, torch.float32, dev)

    def off16(a):
        """a's values, contiguous, one float past a 16-byte boundary."""
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        return flat[1:].view(a.shape).copy_(a)

    for what, (q, k, v), o_off in (
            ("q/k/v rows 97 floats apart, dO off 16 bytes", views, False),
            ("dO and o off 16 bytes", (q0, k0, v0), True)):
        o, lse = K.flash_attention_fwd(q, k, v, causal=True)
        o_p, lse_p = K.flash_attention_fwd_plain(q, k, v, True)
        if o_off:
            o = off16(o)
        do = off16(do0)
        grads = K.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        grads_p = K.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        tag = "B=2 T=77 H=2 D=16 causal f32, " + what
        worst["flash_attention_fwd"] = max(
            worst["flash_attention_fwd"],
            compare("flash fwd o " + tag, o, o_p),
            compare("flash fwd lse " + tag, lse, lse_p))
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p):
            entry = "flash_attention_dq" if name == "dq" else \
                "flash_attention_dkv"
            worst[entry] = max(worst[entry], compare(
                "flash %s %s" % (name, tag), g_, w_))
    log("flash_attention: %d cases agree (fwd, dq, dk/dv; and the f32 "
        "forward and backward from misaligned views), max |err| %s" % (
            len(flash_cases()), {k: "%.3g" % v for k, v in worst.items()}))
    return worst


def check_flash_repeat(K, dev):
    """Two runs of the bf16 backward on the same (q, k, v, o, lse, dO) give
    the same bits (each output tile has one owner: no atomics), at the
    124M training shape and at a ragged windowed one (inputs from a
    generator of their own)."""
    gen = torch.Generator().manual_seed(2)
    for b, t, h, d, causal, window in ((8, 1024, 12, 64, True, 0),
                                       (2, 1000, 3, 64, True, 33)):
        q, k, v, do = _flash_inputs(gen, b, t, h, d, torch.bfloat16, dev)
        kw = dict(causal=causal, window=window)
        o, lse = K.flash_attention_fwd(q, k, v, **kw)
        runs = [K.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        tag = "B=%d T=%d H=%d D=%d causal=%s window=%d bf16" % (
            b, t, h, d, causal, window)
        if not same:
            raise AssertionError("flash backward %s: two runs on the same "
                                 "inputs differ" % tag)
        log("flash backward %s: two runs give the same bits" % tag)


# -- phase 3d: striped_pair_attention against its plain version -------------

SP_RING, SP_C, SP_BH, SP_D = 4, 1024, 24, 64   # one hop of the SP main path


def spair_cases():
    """(BH, C, D, n, q_off, k_off, dtype): every ring position pair of the
    main path's hop (n=4, [24, 1024, 64]) in f32 and bf16; n=1 (the causal
    mask); n=3 at a ragged C=100 (not a multiple of the tiles), every pair;
    head_dim 32, 64 and 128, and in f32 also 8 and 16."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(SP_BH, SP_C, SP_D, SP_RING, qo, ko, dt) for dt in (f32, bf)
             for qo in range(SP_RING) for ko in range(SP_RING)]
    cases += [(6, 300, 64, 1, 0, 0, dt) for dt in (f32, bf)]
    cases += [(4, 100, 64, 3, qo, ko, dt) for dt in (f32, bf)
              for qo in range(3) for ko in range(3)]
    cases += [(4, 200, d, 4, qo, ko, dt) for d in (32, 64, 128)
              for dt in (f32, bf) for qo, ko in ((1, 2), (2, 1))]
    cases += [(4, 200, d, 4, qo, ko, f32) for d in (8, 16)
              for qo, ko in ((1, 2), (2, 1))]
    return cases


def check_striped_pair(K, dev, gen):
    """Forward (o, lse), then dQ and dK/dV from the same o and lse under a
    random g_o and a nonzero g_lse, kernel against plain, in every case of
    ``spair_cases``: o and f32 gradients to the dtype's tolerance, lse to
    the f32 tolerance, bf16 gradients to GRAD_REL of the tensor's largest
    value (the flash rule of phase 3b). At n=1 the hop is causal attention:
    its o, lse and gradients (g_lse = 0) are also held against the flash
    kernels on the same inputs. Returns {entry: max |err|}."""
    worst = dict.fromkeys(("striped_pair_fwd", "striped_pair_dq",
                           "striped_pair_dkv"), 0.0)
    cases = spair_cases()
    for bh, c, d, n, qo, ko, dt in cases:
        q, k, v, go = (_rand(gen, (bh, c, d), dt).to(dev) for _ in range(4))
        gl = _rand(gen, (bh, c, 1)).to(dev)
        tag = "BH=%d C=%d D=%d n=%d q_off=%d k_off=%d %s" % (
            bh, c, d, n, qo, ko, dt)
        o, lse = K.striped_pair_attention_fwd(q, k, v, qo, ko, n_stride=n)
        o_p, lse_p = K.striped_pair_attention_plain(q, k, v, qo, ko, n)
        grads = K.striped_pair_attention_bwd(q, k, v, o, lse, go, gl, qo, ko,
                                             n_stride=n)
        grads_p = K.striped_pair_attention_bwd_plain(q, k, v, o, lse, go, gl,
                                                     qo, ko, n)
        torch.cuda.synchronize()
        worst["striped_pair_fwd"] = max(
            worst["striped_pair_fwd"], compare("striped o " + tag, o, o_p),
            compare("striped lse " + tag, lse, lse_p))
        for name, g_, w_ in zip(("dq", "dk", "dv"), grads, grads_p):
            entry = "striped_pair_dq" if name == "dq" else "striped_pair_dkv"
            err = compare("striped %s %s" % (name, tag), g_, w_) \
                if dt is torch.float32 else \
                compare_scaled("striped %s %s" % (name, tag), g_, w_,
                               GRAD_REL)
            worst[entry] = max(worst[entry], err)
        if n == 1:
            as4 = [t[:, :, None, :] for t in (q, k, v, go)]
            fo, flse = K.flash_attention_fwd(*as4[:3], causal=True)
            fg = K.flash_attention_bwd(*as4[:3], fo, flse, as4[3],
                                       causal=True)
            sg = K.striped_pair_attention_bwd(q, k, v, o, lse, go,
                                              torch.zeros_like(gl), 0, 0,
                                              n_stride=1)
            torch.cuda.synchronize()
            same = torch.equal(fo[:, :, 0], o) and torch.equal(
                flse, lse[..., 0]) and all(
                torch.equal(a[:, :, 0], b) for a, b in zip(fg, sg))
            compare("striped n=1 o vs flash " + tag, o, fo[:, :, 0])
            compare("striped n=1 lse vs flash " + tag, lse[..., 0], flse)
            for name, a, b in zip(("dq", "dk", "dv"), sg, fg):
                if dt is torch.float32:
                    compare("striped n=1 %s vs flash %s" % (name, tag), a,
                            b[:, :, 0])
                else:
                    compare_scaled("striped n=1 %s vs flash %s" % (name, tag),
                                   a, b[:, :, 0], GRAD_REL)
            log("striped_pair n=1 %s: equals flash_attention causal (bitwise "
                "%s)" % (dt, same))
    log("striped_pair_attention: %d cases agree (fwd o and lse, dq, dk/dv "
        "with g_lse), max |err| %s" % (
            len(cases), {k_: "%.3g" % v_ for k_, v_ in worst.items()}))
    return worst


def time_striped_pair(K, dev, gen, worst):
    """One hop of the SP main path ([24, 1024, 64], n=4, q_off=1, k_off=2)
    in f32 (the main path's dtype: the kernels line) and bf16: each C
    entry's time, the plain version's, the bound from the hop's visible
    pairs, and the one PyTorch call that gives (o, lse) with the striped
    mask as a bias (``_scaled_dot_product_efficient_attention``) and the
    one that gives (dq, dk, dv) from it
    (``_scaled_dot_product_efficient_attention_backward``); then the
    compiler's line of each f32 forward kernel."""
    timer = Timer(dev)
    qo, ko = 1, 2
    mask = K._striped_mask(SP_C, SP_C, qo, ko, SP_RING, dev)
    pairs = int(mask.sum()) * SP_BH
    scale = 1.0 / math.sqrt(SP_D)
    entries = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, go = (_rand(gen, (SP_BH, SP_C, SP_D), dt).to(dev)
                       for _ in range(4))
        gl = _rand(gen, (SP_BH, SP_C, 1)).to(dev)
        o, lse = K.striped_pair_attention_fwd(q, k, v, qo, ko,
                                              n_stride=SP_RING)
        dcap = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        cfg = (SP_BH, SP_C, SP_C, SP_D, scale, SP_RING, qo, ko, K._CODE[dt])
        P = K._ptr

        def dq_launch():
            K._launch("striped_pair_dq", P(q), P(k), P(v), P(o), P(go),
                      P(lse), P(gl), P(dcap), P(dq), *cfg)

        def dkv_launch():
            K._launch("striped_pair_dkv", P(q), P(k), P(v), P(go), P(lse),
                      P(dcap), P(dk), P(dv), *cfg)

        dq_launch()
        bias = torch.zeros((SP_C, SP_C), dtype=dt, device=dev).masked_fill(
            ~mask, float("-inf"))[None, None].expand(1, SP_BH, SP_C, SP_C)
        q4, k4, v4 = (x[None] for x in (q, k, v))

        def lib():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, bias, True, scale=scale)

        lo4, llse, seed, offset = lib()
        go4 = go[None]

        def lib_bwd():
            return torch.ops.aten \
                ._scaled_dot_product_efficient_attention_backward(
                    go4, q4, k4, v4, bias, lo4, llse, seed, offset, 0.0,
                    [True, True, True, False], False, scale=scale)

        ms = {"fwd": timer(lambda: K.striped_pair_attention_fwd(
                  q, k, v, qo, ko, n_stride=SP_RING)),
              "dq": timer(dq_launch), "dkv": timer(dkv_launch)}
        plain = {"fwd": timer(lambda: K.striped_pair_attention_plain(
                     q, k, v, qo, ko, SP_RING)),
                 "bwd": timer(lambda: K.striped_pair_attention_bwd_plain(
                     q, k, v, o, lse, go, gl, qo, ko, SP_RING))}
        lib_ms = timer(lib)
        lib_bwd_ms = timer(lib_bwd)
        row = nbytes(q)
        spec = {
            # entry: (ms, plain ms, library ms, bytes, flops)
            "striped_pair_fwd": (ms["fwd"], plain["fwd"], lib_ms,
                                 4 * row + nbytes(lse), 4 * SP_D * pairs),
            "striped_pair_dq": (ms["dq"], plain["bwd"], lib_bwd_ms,
                                6 * row + 3 * nbytes(lse), 6 * SP_D * pairs),
            "striped_pair_dkv": (ms["dkv"], plain["bwd"], lib_bwd_ms,
                                 6 * row + 2 * nbytes(lse),
                                 8 * SP_D * pairs),
        }
        shape = "BH=24 C=1024 D=64 n=4 q_off=1 k_off=2 %s" % (
            "f32" if dt is torch.float32 else "bf16")
        for name, (kms, pms, lms, nb, flops) in spec.items():
            bms, by = bound_ms(nb, flops, dt)
            log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %s  "
                "bound %.4f ms (%s)" % (name, shape, kms, pms,
                                        "%.4f ms" % lms if lms else "none",
                                        bms, by))
            if dt is torch.float32:
                entries[name] = {"ms": kms, "plain_ms": pms,
                                 "library_ms": lms, "bound_ms": bms,
                                 "bound_by": by, "shape": shape}
    log("  (%d visible pairs of %d in the hop; plain dq and dkv times are "
        "the whole plain backward; the library times are the efficient "
        "attention forward with the mask as a bias and the logsumexp, and "
        "its backward (dq, dk, dv in one call, no lse cotangent) for both "
        "dq and dkv)" % (pairs, SP_BH * SP_C * SP_C))
    log(ptxas_lines(K, "striped_pair_attention",
                    ("fwd_f32", "dq_f32", "dkv_f32")))
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


def check_fused_linear(K, dev, gen):
    """Every activation at a ragged shape (M=100, K=70, N=130: no tile or
    16-byte multiple) in f32 and bf16, with and without bias, with and
    without the per-column ``scale`` (the folded BatchNorm of the conv
    path), then the 124M ffn1 shape (M=8192, K=768, N=3072, bf16, relu;
    also in f32, where it takes the 128-column tile) and the SP path's
    (one rank's M=2048, f32, relu with bias); then f32 at M=129, N=65 with
    K = 3, 5 and 767, and from a misaligned view of x."""
    cases = [(100, 70, 130, act, dt, bias, scale)
             for act in ("linear", "relu", "sigmoid", "tanh")
             for dt in (torch.float32, torch.bfloat16)
             for bias in (True, False) for scale in (False, True)]
    cases += [(8192, 768, 3072, "relu", torch.bfloat16, True, False),
              (8192, 768, 3072, "relu", torch.bfloat16, True, True),
              (33, 768, 2304, "tanh", torch.bfloat16, True, True),
              (2048, 768, 3072, "relu", torch.float32, True, False),
              (8192, 768, 3072, "relu", torch.float32, True, True)]
    # f32 around the register tiles (128 rows, 64 or 128 columns, K steps
    # of 16): one row and one column past a tile, K not a multiple of 4
    # or of 16; "view": x a contiguous view 4 bytes off a 16-byte boundary
    # (the guarded element loads)
    cases += [(129, kd, 65, "relu", torch.float32, True, True)
              for kd in (3, 5, 767)]
    cases += [(129, 64, 65, "linear", torch.float32, "view", False)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for m, kd, n, act, dt, bias, scale in cases:
        x = _rand(gen, (m, kd), dt).to(dev)
        if bias == "view":
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(m, kd)
            assert x.data_ptr() % 16 == 4
        w = _rand(gen, (n, kd), dt, 1.0 / math.sqrt(kd)).to(dev)
        b = _rand(gen, (n,), dt, 0.1).to(dev) if bias else None
        s = (torch.rand((n,), generator=gen) + 0.5).to(dev) if scale \
            else None
        got = K.fused_linear_fwd(x, w, b, act, s)
        want = K.fused_linear_plain(x, w, b, act, s)
        torch.cuda.synchronize()
        worst[dt] = max(worst[dt], compare(
            "fused_linear M=%d K=%d N=%d %s %s bias=%s scale=%s"
            % (m, kd, n, act, dt, bias, scale), got, want))
    log("fused_linear: %d cases agree (%d with scale), max |err| f32 %.3g, "
        "bf16 %.3g" % (len(cases), sum(bool(c[-1]) for c in cases),
                       worst[torch.float32], worst[torch.bfloat16]))
    return max(worst.values())


# -- phase 3c: the conv-net kernels against their plain versions ---------------

RESNET_CLASSES, RESNET_LAYERS, RESNET_HW = 1000, 50, 224
RESNET_B = 256                      # bench.py:115 bench_resnet50
# matmul_stats' column sums: |kernel - plain| <= STAT_REL * sum_m |y| for
# s1 and STAT_REL * sum_m y^2 for s2, per column. Both sum the same exact
# f32 products (bf16 x bf16 is exact in f32) in other orders, each a tree
# of partial sums (128-row tiles, then torch.sum): the error of such a sum
# of M terms grows like log2(M) f32 ulps of the sum of magnitudes, ~1e-6
# at M = 802816 (stage 1 at B=256); sqrt(M) ulps, the typical error of a
# sum in sequence, is 5.3e-5
STAT_REL = 1e-4


def resnet_convs(batch):
    """Every conv -> BatchNorm chain of ResNet-50 at ``batch`` x 3 x 224 x
    224, in the plan's order: {name, x, w (shapes), stride, pad, dilate,
    act, pointwise}, from the port's FusionPlan and shape inference."""
    from mxnet_tpu_torch.models import get_resnet
    from mxnet_tpu_torch.ops.fusion import FusionPlan
    sym = get_resnet(RESNET_CLASSES, RESNET_LAYERS)
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(
        data=(batch, 3, RESNET_HW, RESNET_HW), softmax_label=(batch,))
    shape_of = {(id(n), i): s for (n, i), s in zip(internals._heads, outs)}
    convs = []
    plan = FusionPlan(sym._topo(), sym._heads)
    for kind, nodes in plan.chains.values():
        conv = nodes[0]
        p = conv.params
        (xn, xi), (wn, _) = conv.inputs[:2]
        convs.append(dict(
            name=conv.name, x=shape_of[(id(xn), xi)],
            w=shape_of[(id(wn), 0)], stride=tuple(p["stride"]),
            pad=tuple(p["pad"]), dilate=tuple(p["dilate"]),
            act="relu" if kind == "conv_bn_relu" else "linear",
            pointwise=FusionPlan._conv_is_pointwise(p)))
    return convs


def _stats_err(name, got, want, scale):
    """Max |got - want| / scale per column, raising past STAT_REL."""
    rel = ((got.float() - want.float()).abs() / scale.clamp_min(1e-30))
    if not torch.isfinite(got).all() or (rel > STAT_REL).any():
        raise AssertionError(
            "%s: kernel disagrees with the plain version: %.3g of the sum "
            "of magnitudes (gate %g)" % (name, rel.max().item(), STAT_REL))
    return rel.max().item()


def check_matmul_stats(K, dev, gen, dgen):
    """Each distinct pointwise conv of ResNet-50 at the main path's B=256
    in bf16 (M = 256 H W, K and N its channels; inputs drawn on the card
    from ``dgen``), then ragged shapes: (130, 70, 36) in f32 and
    bf16, M = 1000 (not a multiple of the 128-row tile), N = 130 past one
    column tile, K = 33 (the guarded scalar loads), and an f32 product
    large enough to take the 128-column f32 tile (25088, 256, 1024). y to
    the dtype's
    tolerance; s1 and s2 per column to STAT_REL of the sums of |y| and
    y^2. Returns the largest |y| error."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = sorted({(c["x"][0] * c["x"][2] * c["x"][3], c["w"][1], c["w"][0])
                    for c in resnet_convs(RESNET_B) if c["pointwise"]})
    cases = [(m, kd, n, bf, dgen) for m, kd, n in cases]
    cases += [(m, kd, n, dt, gen) for m, kd, n, dt in (
        (130, 70, 36, f32), (130, 70, 36, bf), (1000, 64, 64, bf),
        (1000, 64, 64, f32), (257, 24, 130, bf), (77, 33, 20, bf),
        (77, 33, 20, f32), (25088, 256, 1024, f32))]
    worst, worst_stat = 0.0, 0.0
    for m, kd, n, dt, g in cases:
        x = _rand(g, (m, kd), dt).to(dev)
        w = _rand(g, (n, kd), dt, 1.0 / math.sqrt(kd)).to(dev)
        y, s1, s2 = K.matmul_stats_fwd(x, w)
        yp, s1p, s2p = K.matmul_stats_plain(x, w)
        mag = (x.float() @ w.float().t()).abs().sum(dim=0)
        torch.cuda.synchronize()
        tag = "M=%d K=%d N=%d %s" % (m, kd, n, dt)
        worst = max(worst, compare("matmul_stats y " + tag, y, yp))
        worst_stat = max(worst_stat,
                         _stats_err("matmul_stats s1 " + tag, s1, s1p, mag),
                         _stats_err("matmul_stats s2 " + tag, s2, s2p, s2p))
        del x, w, y, s1, s2, yp, s1p, s2p, mag
    log("matmul_stats: %d cases agree (%d ResNet-50 1x1 shapes at B=%d), "
        "max |y err| %.3g, statistics within %.3g of their sums of "
        "magnitudes (gate %g)" % (len(cases), len(cases) - 8, RESNET_B,
                                  worst, worst_stat, STAT_REL))
    return worst


def _conv_inputs(gen, xs, ws, dt, dev):
    fan_in = ws[1] * ws[2] * ws[3]
    return (_rand(gen, xs, dt).to(dev),
            _rand(gen, ws, dt, 1.0 / math.sqrt(fan_in)).to(dev),
            (torch.rand((ws[0],), generator=gen, device=gen.device)
             + 0.5).to(dev),
            _rand(gen, (ws[0],), scale=0.1).to(dev))


def check_fused_conv_bn_act(K, dev, gen, dgen):
    """Each distinct conv of ResNet-50 at the main path's B=256 with its
    chain's activation: in f32 (what the eval forward runs: the implicit
    GEMM) from an NCHW and from a channels-last x (the stem's C = 3 takes
    the guarded element loads), in bf16 on the channels-last x the
    previous fused conv leaves (the stem's input NCHW; inputs drawn on the
    card from ``dgen``), then
    small ragged cases in f32 and bf16, relu and linear: 3x3 pad 1, 7x7/2
    pad 3, a non-square kernel with stride (2, 1), pad (1, 2) and dilation
    (2, 1), dilation 2, 1x1 stride 1 and stride 2, each from an NCHW and a
    channels-last x; then the Winograd path's ragged cases in f32 at B=2
    (odd H x W, 7 x 7, 3 x 3, 1 x 1, pads 0 and 2, C = 4 and 12, O past a
    64-channel block) and 3x3 convs that stay on the implicit GEMM (C = 3,
    stride 2), each asserted on the path ``kernels.conv_algo`` names and
    logged with it. Against the plain version (F.conv2d in f32, TF32 off),
    to the dtype's tolerance."""
    bf, f32 = torch.bfloat16, torch.float32
    seen, cases = set(), []
    for c in resnet_convs(RESNET_B):
        key = (c["x"], c["w"], c["stride"], c["pad"], c["dilate"], c["act"])
        if key not in seen:
            seen.add(key)
            cases += [key + (f32, dgen, cl) for cl in (False, True)]
            cases.append(key + (bf, dgen, c["x"][1] > 3))
    n_resnet = len(cases)
    for dt in (f32, bf):
        for ws, st, pd, dl, act in (
                ((9, 5, 3, 3), (1, 1), (1, 1), (1, 1), "relu"),
                ((9, 5, 7, 7), (2, 2), (3, 3), (1, 1), "relu"),
                ((9, 5, 3, 2), (2, 1), (1, 2), (2, 1), "linear"),
                ((9, 5, 3, 3), (1, 1), (2, 2), (2, 2), "linear"),
                ((9, 5, 1, 1), (1, 1), (0, 0), (1, 1), "relu"),
                ((9, 5, 1, 1), (2, 2), (0, 0), (1, 1), "linear")):
            for cl in (False, True):
                cases.append(((2, 5, 13, 10), ws, st, pd, dl, act, dt, gen,
                              cl))
    n_small = len(cases) - n_resnet
    # (x, w, stride, pad, act, the path): ragged Winograd cases, then 3x3
    # convs the rule keeps on the implicit GEMM
    wino = [((2, 8, 9, 13), (12, 8, 3, 3), 1, 0, "relu", "winograd"),
            ((2, 8, 9, 13), (72, 8, 3, 3), 1, 2, "linear", "winograd"),
            ((2, 16, 7, 7), (36, 16, 3, 3), 1, 1, "relu", "winograd"),
            ((2, 4, 5, 11), (9, 4, 3, 3), 1, 1, "linear", "winograd"),
            ((2, 4, 3, 3), (9, 4, 3, 3), 1, 0, "relu", "winograd"),
            ((2, 12, 1, 1), (33, 12, 3, 3), 1, 2, "linear", "winograd"),
            ((2, 3, 9, 13), (9, 3, 3, 3), 1, 1, "relu", "implicit"),
            ((2, 8, 9, 13), (12, 8, 3, 3), 2, 1, "relu", "implicit")]
    for xs, ws, st, pd, act, path in wino:
        for cl in (False, True):
            cases.append((xs, ws, (st, st), (pd, pd), (1, 1), act, f32, gen,
                          cl, path))
    worst = {f32: 0.0, bf: 0.0}
    paths = {}
    for xs, ws, st, pd, dl, act, dt, g, cl, *want_path in cases:
        x, w, s, b = _conv_inputs(g, xs, ws, dt, dev)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        kw = dict(stride=st, pad=pd, dilate=dl, act=act)
        path = K.conv_algo(dt, xs[1], ws[2:], st, pd, dl)
        paths[path] = paths.get(path, 0) + 1
        tag = "fused_conv_bn_act x=%s%s w=%s %s %s (%s)" % (
            xs, " channels-last" if cl else "", ws, kw, dt, path)
        if want_path and path != want_path[0]:
            raise AssertionError("%s: the rule names %s, the case wants %s"
                                 % (tag, path, want_path[0]))
        got = K.fused_conv_bn_act(x, w, s, b, **kw)
        want = K.fused_conv_bn_act_plain(x, w, s, b, **kw)
        torch.cuda.synchronize()
        err = compare(tag, got, want)
        worst[dt] = max(worst[dt], err)
        if want_path:
            log("  %s: max |err| %.3g" % (tag, err))
        del x, w, s, b, got, want
    log("fused_conv_bn_act: %d cases agree (%d ResNet-50 conv shapes at "
        "B=%d, each in f32 from NCHW and channels-last x and in bf16; %d "
        "small ragged; %d of the Winograd rule's edges), max |err| f32 "
        "%.3g, bf16 %.3g; cases by path %s" % (
            len(cases), n_resnet // 3, RESNET_B, n_small,
            len(cases) - n_resnet - n_small, worst[f32], worst[bf],
            json.dumps(paths, sort_keys=True)))
    return max(worst.values())


def time_cnn_kernels(K, dev, gen, worst):
    """The conv-net kernels at ResNet-50's B=256 shapes (inputs drawn on
    the card from ``gen``; the checks above held both at these shapes):
    matmul_stats at stage 1's `_a` conv (M = 256*56*56, K = 256, N = 64),
    fused_conv_bn_act in f32 (the eval forward's path) at the stride-1 3x3
    convs of stages 1-4 (x channels-last, as the main path gives it, relu;
    Winograd F(2x2, 3x3)), the stem and stage 2's 1x1 stride-2 projection
    (the implicit GEMM), and in bf16 at stage 1's 3x3 conv, whose time
    includes the im2col gather (the GEMM alone is printed beside it); then
    the compiler's line (registers, spills) of each f32 conv and GEMM
    kernel. A Winograd row's bound is stated two ways: from the direct
    product's FLOPs, and from F(2x2, 3x3)'s 16 multiply-adds per 2 x 2
    output tile, channel and output channel (the operations the kernel
    does; its ``bound_ms``)."""
    import torch.nn.functional as F
    timer = Timer(dev)
    bf = torch.bfloat16
    entries = {}
    m, kd, n = RESNET_B * 56 * 56, 256, 64
    x = _rand(gen, (m, kd), bf).to(dev)
    w = _rand(gen, (n, kd), bf, 1.0 / math.sqrt(kd)).to(dev)
    y = torch.empty((m, n), dtype=bf, device=dev)

    def lib_stats():
        out = torch.matmul(x, w.t())
        return out.sum(dim=0, dtype=torch.float32), \
            out.float().square().sum(dim=0)

    kms = timer(lambda: K.matmul_stats_fwd(x, w))
    pms = timer(lambda: K.matmul_stats_plain(x, w))
    lms = timer(lib_stats)
    bms, by = bound_ms(nbytes(x, w, y) + 2 * 4 * n, 2 * m * n * kd + 3 * m * n,
                       bf)
    shape = "stage1 _a M=%d K=%d N=%d bf16" % (m, kd, n)
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(matmul + two column sums)  bound %.4f ms (%s)" % (
            "matmul_stats", shape, kms, pms, lms, bms, by))
    entries["matmul_stats"] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                               "bound_ms": bms, "bound_by": by,
                               "shape": shape}
    del x, w, y

    # fused_conv_bn_act in f32 (the eval forward's path) at stage 1's 3x3
    # conv (the kernels line's row) and those of stages 2-4 (Winograd), the
    # stem (NCHW x, C = 3: the implicit GEMM's guarded loads) and stage
    # 2's 1x1 stride-2 projection; then bf16 at stage 1's 3x3 conv, with
    # its GEMM alone beside it (the bf16 path still gathers the patches by
    # one strided copy)
    P = K._ptr
    rows = {}
    for tag, xs, ws, st, pd, act, cl, dt in (
            ("f32", (RESNET_B, 64, 56, 56), (64, 64, 3, 3), 1, 1, "relu",
             True, torch.float32),
            ("stage2", (RESNET_B, 128, 28, 28), (128, 128, 3, 3), 1, 1,
             "relu", True, torch.float32),
            ("stage3", (RESNET_B, 256, 14, 14), (256, 256, 3, 3), 1, 1,
             "relu", True, torch.float32),
            ("stage4", (RESNET_B, 512, 7, 7), (512, 512, 3, 3), 1, 1,
             "relu", True, torch.float32),
            ("stem", (RESNET_B, 3, 224, 224), (64, 3, 7, 7), 2, 3, "relu",
             False, torch.float32),
            ("proj", (RESNET_B, 256, 56, 56), (512, 256, 1, 1), 2, 0,
             "linear", True, torch.float32),
            ("bf16", (RESNET_B, 64, 56, 56), (64, 64, 3, 3), 1, 1, "relu",
             True, bf)):
        kw = dict(stride=(st, st), pad=(pd, pd), dilate=(1, 1), act=act)
        x, w, s, b = _conv_inputs(gen, xs, ws, dt, dev)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        out = K.fused_conv_bn_act(x, w, s, b, **kw)
        wf = (w.float() * s[:, None, None, None]).to(dt)  # the folded weight
        bb = b.to(dt)
        act_fn = torch.relu if act == "relu" else (lambda y: y)
        kms = timer(lambda: K.fused_conv_bn_act(x, w, s, b, **kw))
        pms = timer(lambda: K.fused_conv_bn_act_plain(x, w, s, b, **kw))
        lms = timer(lambda: act_fn(F.conv2d(x, wf, bb, stride=st,
                                            padding=pd)))
        m, kdim = out.numel() // ws[0], ws[1] * ws[2] * ws[3]
        path = K.conv_algo(dt, xs[1], ws[2:], (st, st), (pd, pd), (1, 1))
        io = nbytes(x, w, s, b, out)
        bms, by = bound_ms(io, 2 * m * ws[0] * kdim, dt)
        shape = "%s %dx%d/%d x=%s%s %s %s (%s)" % (
            {"f32": "stage1", "bf16": "stage1", "stem": "stem",
             "proj": "stage2 projection"}.get(tag, tag), ws[2], ws[3], st,
            "x".join(map(str, xs)), " channels-last" if cl else " NCHW",
            "f32" if dt == torch.float32 else "bf16", act, path)
        row = {"ms": kms, "plain_ms": pms, "library_ms": lms,
               "bound_ms": bms, "bound_by": by, "shape": shape}
        extra = ""
        if path == "winograd":
            # F(2x2, 3x3): 16 multiply-adds per 2x2 outputs, i.e. 4 per
            # output position, input channel and output channel (the
            # function's own work; a ragged tile's padding is not counted)
            row["bound_direct_ms"], row["bound_direct_by"] = bms, by
            row["bound_ms"], row["bound_by"] = bound_ms(
                io, 2 * 4 * m * xs[1] * ws[0], dt)
            extra = " (bound from the direct product %.4f ms (%s))" % (
                bms, by)
            bms, by = row["bound_ms"], row["bound_by"]
        if dt == bf:
            xm, wm, _, _ = K._im2col(x, w, (st, st), (pd, pd), (1, 1))
            om = torch.empty((xm.shape[0], ws[0]), dtype=dt, device=dev)

            def gemm_only():
                K._launch("fused_conv_bn_act", P(xm), P(wm), P(s), P(b),
                          P(om), None, 0, 1, 1, xm.shape[0], xm.shape[1], 1,
                          xm.shape[0], ws[0], 1, 1, 1, 1, 0, 0, 1, 1, 1,
                          K._CODE[dt])

            row["gemm_ms"] = timer(gemm_only)
            extra = " (of which the GEMM %.4f ms, the im2col gather the " \
                "rest)" % row["gemm_ms"]
            del xm, wm, om
        log("time %-22s %-34s kernel %.4f ms%s  plain %.4f ms  library "
            "%.4f ms (F.conv2d with the scale folded%s%s)  bound %.4f ms "
            "(%s)%s" % ("fused_conv_bn_act", shape, kms,
                        extra if dt == bf else "", pms, lms,
                        " + relu" if act == "relu" else "",
                        ", TF32 off" if dt == torch.float32 else "", bms, by,
                        extra if path == "winograd" else ""))
        rows[tag] = row
        del x, w, s, b, out, wf, bb
    # the main path (the eval forward) runs the f32 path: stage 1's 3x3
    # conv is the kernels line's row, the other rows ride along in it
    entries["fused_conv_bn_act"] = dict(
        rows["f32"], **{t: rows[t] for t in ("stage2", "stage3", "stage4",
                                             "stem", "proj", "bf16")})
    for kname, keys in (("fused_linear", ("conv_wino", "wino_weights",
                                          "conv_f32", "fused_linear_f32")),
                        ("matmul_stats", ("matmul_stats_f32",))):
        log(ptxas_lines(K, kname, keys))
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


def check_mha_gqa(dev):
    """MultiHeadAttention's flash path with GQA (12 heads over 4 kv heads,
    the K/V repeat before the kernel), rope and a window, at T=100: its
    output and the gradients of sum(out * g) for the data and the four
    weights, on the card (the flash kernels) against the same op on the
    host (their plain versions), f32."""
    from mxnet_tpu_torch.ops.registry import get
    spec = get("MultiHeadAttention")
    b, t, e, h, kv = 2, 100, 768, 12, 4
    f = e + 2 * kv * (e // h)
    rng = np.random.RandomState(9)
    ins = [rng.randn(b, t, e), rng.randn(f, e) / math.sqrt(e),
           rng.randn(f) * 0.1, rng.randn(e, e) / math.sqrt(e),
           rng.randn(e) * 0.1]
    g = torch.from_numpy(rng.randn(b, t, e).astype(np.float32))
    worst = 0.0
    for window in (0, 33):
        p = spec.parse_params(dict(num_heads=h, num_kv_heads=kv, rope=True,
                                   window=window))
        res = {}
        for where in (dev, "cpu"):
            xs = [torch.from_numpy(a.astype(np.float32)).to(where)
                  .requires_grad_() for a in ins]
            out = spec.forward(p, xs, [], False, None)[0][0]
            (out * g.to(where)).sum().backward()
            res[str(where)] = [out.detach().cpu()] + [x.grad.cpu()
                                                      for x in xs]
        for i, (got, want) in enumerate(zip(res[str(dev)], res["cpu"])):
            worst = max(worst, compare("MultiHeadAttention GQA rope window=%d"
                                       " %s" % (window, ("out", "d_data",
                                                         "d_qkv_weight",
                                                         "d_qkv_bias",
                                                         "d_out_weight",
                                                         "d_out_bias")[i]),
                                       got, want))
    log("MultiHeadAttention GQA 12->4 rope, window 0 and 33, T=100: card "
        "against host agree, max |err| %.3g" % worst)


def time_train_kernels(K, dev, gen, worst):
    """The training kernels at the 124M step's shapes (B=8, T=1024, 12
    heads of 64, causal, bf16; ffn1 M=8192 K=768 N=3072 relu): time, plain
    time, bound and library time of each C entry; flash's f32 backward
    (the SP path's kernels under the flash mask) at B=1; and
    ``fused_linear`` at the SP step's f32 ffn1 (M=2048)."""
    import torch.nn.functional as F
    timer = Timer(dev)
    b, t, h, d = 8, 1024, 12, 64
    q, k, v, do = _flash_inputs(gen, b, t, h, d, torch.bfloat16, dev)
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    cfg = K._flash_kernel_args("flash_attention_dq", q, k, v) \
        + (1.0 / math.sqrt(d), 1, 0, K._CODE[torch.bfloat16])
    P = K._ptr

    def dq_launch():
        K._launch("flash_attention_dq", P(q), P(k), P(v), P(o), P(do),
                  P(lse), P(dcap), P(dq), *cfg)

    def dkv_launch():
        K._launch("flash_attention_dkv", P(q), P(k), P(v), P(do), P(lse),
                  P(dcap), P(dk), P(dv), *cfg)

    dq_launch()
    pairs = t * (t + 1) // 2 * b * h           # visible (query, key) pairs
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    gt = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True
                                       ).backward(gt)

    ms = {"fwd": timer(lambda: K.flash_attention_fwd(q, k, v, causal=True)),
          "dq": timer(dq_launch), "dkv": timer(dkv_launch)}
    plain = {"fwd": timer(lambda: K.flash_attention_fwd_plain(q, k, v,
                                                              True)),
             "bwd": timer(lambda: K.flash_attention_bwd_plain(
                 q, k, v, o, lse, do, True))}
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd = timer(sdpa_fwd_bwd) - lib_fwd
    row = nbytes(q)                             # one [B, T, H, D] tensor
    spec = {
        # entry: (ms, plain ms, library ms, bytes, flops)
        "flash_attention_fwd": (ms["fwd"], plain["fwd"], lib_fwd,
                                4 * row + nbytes(lse), 4 * d * pairs),
        "flash_attention_dq": (ms["dq"], plain["bwd"], lib_bwd,
                               6 * row + 2 * nbytes(lse), 6 * d * pairs),
        "flash_attention_dkv": (ms["dkv"], plain["bwd"], lib_bwd,
                                6 * row + 2 * nbytes(lse), 8 * d * pairs),
    }
    entries = {}
    shape = "B=8 T=1024 H=12 D=64 causal bf16"
    for name, (kms, pms, lms, nb, flops) in spec.items():
        bms, by = bound_ms(nb, flops, torch.bfloat16)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f "
            "ms  bound %.4f ms (%s)" % (name, shape, kms, pms, lms, bms, by))
        entries[name] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                         "bound_ms": bms, "bound_by": by, "shape": shape}
    log("  (plain and library times of dq and dkv are those of the whole "
        "backward: the plain backward, and SDPA forward+backward minus its "
        "forward)")
    # the f32 backward (the SP path's form, flash under Mask::Flash) at
    # B=1 T=1024: rows that ride along in the kernels line as "f32"
    b = 1
    q, k, v, do = _flash_inputs(gen, b, t, h, d, torch.float32, dev)
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    dcap = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    cfg = K._flash_kernel_args("flash_attention_dq", q, k, v) \
        + (1.0 / math.sqrt(d), 1, 0, K._CODE[torch.float32])
    dq_launch()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    gt = do.transpose(1, 2)
    ms = {"dq": timer(dq_launch), "dkv": timer(dkv_launch)}
    pms = timer(lambda: K.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    True))
    lib_fwd = timer(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    lib_bwd = timer(sdpa_fwd_bwd) - lib_fwd
    pairs, row = t * (t + 1) // 2 * b * h, nbytes(q)
    shape = "B=1 T=1024 H=12 D=64 causal f32"
    for name, nb, flops in (
            ("flash_attention_dq", 6 * row + 2 * nbytes(lse), 6 * d * pairs),
            ("flash_attention_dkv", 6 * row + 2 * nbytes(lse),
             8 * d * pairs)):
        kms = ms[name.rsplit("_", 1)[1]]
        bms, by = bound_ms(nb, flops, torch.float32)
        log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f "
            "ms  bound %.4f ms (%s)" % (name, shape, kms, pms, lib_bwd, bms,
                                        by))
        entries[name]["f32"] = {"ms": kms, "plain_ms": pms,
                                "library_ms": lib_bwd, "bound_ms": bms,
                                "bound_by": by, "shape": shape}

    m, kd, n = 8192, 768, 3072
    x = _rand(gen, (m, kd), torch.bfloat16).to(dev)
    w = _rand(gen, (n, kd), torch.bfloat16, 1.0 / math.sqrt(kd)).to(dev)
    bias = _rand(gen, (n,), torch.bfloat16, 0.1).to(dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    kms = timer(lambda: K.fused_linear_fwd(x, w, bias, "relu"))
    pms = timer(lambda: K.fused_linear_plain(x, w, bias, "relu"))
    lms = timer(lambda: torch.relu(F.linear(x, w, bias)))
    bms, by = bound_ms(nbytes(x, w, bias, out), 2 * m * n * kd,
                       torch.bfloat16)
    shape = "ffn1 M=8192 K=768 N=3072 bf16 relu"
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(F.linear + relu, two calls)  bound %.4f ms (%s)" % (
            "fused_linear", shape, kms, pms, lms, bms, by))
    entries["fused_linear"] = {"ms": kms, "plain_ms": pms, "library_ms": lms,
                               "bound_ms": bms, "bound_by": by,
                               "shape": shape}
    # the SP path's f32 ffn1 (one rank's M=2048), beside F.linear in f32
    # (TF32 off): the f32 row rides along in the kernels line
    m = 2048
    x = _rand(gen, (m, kd)).to(dev)
    w, bias = w.float(), bias.float()
    out = torch.empty((m, n), device=dev)
    kms = timer(lambda: K.fused_linear_fwd(x, w, bias, "relu"))
    pms = timer(lambda: K.fused_linear_plain(x, w, bias, "relu"))
    lms = timer(lambda: torch.relu(F.linear(x, w, bias)))
    bms, by = bound_ms(nbytes(x, w, bias, out), 2 * m * n * kd,
                       torch.float32)
    shape = "SP ffn1 M=2048 K=768 N=3072 f32 relu"
    log("time %-22s %-34s kernel %.4f ms  plain %.4f ms  library %.4f ms "
        "(F.linear f32, TF32 off, + relu)  bound %.4f ms (%s)" % (
            "fused_linear", shape, kms, pms, lms, bms, by))
    entries["fused_linear"]["f32"] = {
        "ms": kms, "plain_ms": pms, "library_ms": lms, "bound_ms": bms,
        "bound_by": by, "shape": shape}
    for name, r in entries.items():
        r["max_abs_err"] = worst[name]
    return entries


# -- phase 4: the main path -------------------------------------------------

VOCAB, LAYERS, EMBED, HEADS = 32000, 12, 768, 12
MAX_LEN, SLOTS, BUCKETS, STEPS_PER_ROUND = 1024, 32, (64, 128, 256), 8
N_REQUESTS, WAVES = 24, 9

# card vs host logits of the 124M LM in bf16: within LOGIT_ULPS bf16 ulps
# (2^-7 relative) of the row's largest |logit|. bf16 keeps 8 significant
# bits, and each side rounds the residual stream after each of ~10 ops per
# layer (120 roundings over 12 layers), in another order on each side: a
# random walk of ~sqrt(120) half-ulps, about 6 ulps, with room above it
LOGIT_ULPS = 16


def _lm_params(symbol, max_len, seed):
    """Seeded U(-0.05, 0.05) f32 weights for every argument of the LM."""
    shapes = {"data": (1, max_len), "softmax_label": (1, max_len)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.05, 0.05, sh).astype(np.float32)
            for n, sh in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}


def _serve_wave(engine, work):
    """Serve ``work`` [(prompt, budget)]: 8 requests up front, 4 more
    before each of the next rounds. Returns (requests, seconds)."""
    work = list(work)
    handles = []
    t0 = time.perf_counter()
    while work or not engine.idle:
        for _ in range(8 if not handles else 4):
            if work:
                prompt, budget = work.pop(0)
                handles.append(engine.submit(prompt, max_tokens=budget))
        engine.step()
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0


def _wave_metrics(handles, seconds):
    """(tokens/s, ms per token p50, p99) of one wave."""
    ntok = sum(len(h.tokens) for h in handles)
    tpot = [(h.t_done - h.t_first) / (len(h.tokens) - 1) * 1e3
            for h in handles if len(h.tokens) > 1]
    return (ntok / seconds, float(np.percentile(tpot, 50)),
            float(np.percentile(tpot, 99)))


# -- the program layer: captured against uncaptured --------------------------

def check_compile_counts(engine, what):
    """The JAX package's compile contract for the waves served here: one
    decode program, no verify or copy program, one prefill program per
    bucket (every bucket is used)."""
    cc = engine.compile_counts
    want = {"decode": 1, "verify": 0, "prefill": dict.fromkeys(BUCKETS, 1),
            "copy": {}}
    if cc != want:
        raise AssertionError("%s: compile_counts %r, the contract wants %r"
                             % (what, cc, want))
    log("%s: compile_counts %s" % (what, json.dumps(
        {k: ({str(b): n for b, n in v.items()} if isinstance(v, dict)
             else v) for k, v in cc.items()})))


@contextlib.contextmanager
def eager_programs():
    """Every ``Program`` call inside runs its function uncaptured
    (``Program._run_eager``) over the same buffers: the captured paths
    are held against it, and its times stand for the uncaptured path."""
    from mxnet_tpu_torch.parallel.program import Program
    captured = Program.__call__
    Program.__call__ = Program._run_eager
    try:
        yield
    finally:
        Program.__call__ = captured


def free_programs():
    """Free the graphs and memory pools of the engines and trainers a
    phase left behind (each program and its owner refer to each other, so
    only the cycle collector frees them)."""
    gc.collect()
    torch.cuda.empty_cache()


def memory():
    """'peak P MB allocated, R MB reserved': the peak since the last
    reset, and the caching allocator's segments now, which hold the
    programs' graph pools (a captured program's intermediates stay in its
    pool between replays, reserved but not allocated)."""
    return "peak %.1f MB allocated, %.1f MB reserved" % (
        torch.cuda.max_memory_allocated() / 2**20,
        torch.cuda.memory_reserved() / 2**20)


def host_calls(prof):
    """{name: count} of the CUDA API calls (``cuda*`` and ``cu*``) that
    put work on the card (kernel and graph launches, copies, memsets) in
    a profile."""
    from torch.autograd import DeviceType
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.key.startswith("cu")
            and any(w in e.key for w in ("Launch", "Memcpy", "Memset"))}


def check_eager_wave(engine, work, first):
    """The main path's wave through ``Program._run_eager``: its 24 streams
    must equal the captured wave's (``first``). Returns its tokens/s."""
    with eager_programs():
        handles, secs = _serve_wave(engine, work)
    for h, h0 in zip(handles, first):
        if h.tokens != h0.tokens:
            raise AssertionError(
                "request %s: the captured wave's stream differs from the "
                "same wave run uncaptured" % h.id)
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("main path, the same wave uncaptured (Program._run_eager): %d "
        "streams equal the captured wave's; %.1f tokens/s, ms per token "
        "p50 %.3f p99 %.3f; %s" % (len(handles), tps, p50, p99, card_line()))
    return tps


def check_sampled_wave(engine, work):
    """Sampled decoding on the card: one request (temperature 0.9, seed
    5) alone, then the same request inside a busy wave of sampled and
    greedy requests, each captured and uncaptured. Its stream must be
    the same in all four runs (a function of the seed and the positions,
    not of the batch), and the busy wave's streams captured must equal
    them uncaptured."""
    prompt = work[1][0]
    runs = {}
    for mode in ("captured", "uncaptured"):
        ctx = eager_programs() if mode == "uncaptured" \
            else contextlib.nullcontext()
        with ctx:
            alone = engine.submit(prompt, max_tokens=32, temperature=0.9,
                                  seed=5)
            while not engine.idle:
                engine.step()
            busy = [engine.submit(p, max_tokens=b,
                                  temperature=(0.7 if i % 2 else 0.0),
                                  seed=100 + i)
                    for i, (p, b) in enumerate(work[:12])]
            busy.insert(5, engine.submit(prompt, max_tokens=32,
                                         temperature=0.9, seed=5))
            while not engine.idle:
                engine.step()
        runs[mode] = (alone.tokens, [h.tokens for h in busy])
    streams = [runs[m][0] for m in runs] + [runs[m][1][5] for m in runs]
    if any(s != streams[0] for s in streams) or len(streams[0]) != 32:
        raise AssertionError("sampled request: its stream alone and in a "
                             "busy wave, captured and uncaptured, differ: "
                             "%r" % streams)
    if runs["captured"][1] != runs["uncaptured"][1]:
        raise AssertionError("sampled wave: captured and uncaptured "
                             "streams differ")
    log("sampled decoding: one request's 32 tokens equal alone and inside "
        "a busy wave beside 12 others (6 sampled), captured and uncaptured; "
        "the busy wave's streams equal captured and uncaptured (%d distinct "
        "tokens in the request's stream)" % len(set(streams[0])))


def serve_main_path(K, dev):
    """The 124M LM through save_checkpoint -> InferenceEngine.
    from_checkpoint -> WAVES waves of the same staggered greedy requests.
    Returns the launch counts of the served waves (counters zeroed just
    before the first and read just after the last), the checkpoint's
    prefix and the requests."""
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.serving import InferenceEngine

    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS)
    ckpt = os.path.join(HERE, "build", "smoke_ckpt")
    os.makedirs(ckpt, exist_ok=True)
    prefix = os.path.join(ckpt, "lm124m")
    t0 = time.perf_counter()
    save_checkpoint(prefix, 0, symbol, _lm_params(symbol, MAX_LEN, 0), {})
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused",
        compute_dtype="bfloat16", device=dev)
    torch.cuda.synchronize()
    log("main path: 124M LM (%d layers, E=%d, %d heads, vocab %d) "
        "checkpointed and loaded in %.1f s; int8 weights %.1f MB" % (
            LAYERS, EMBED, HEADS, VOCAB, time.perf_counter() - t0,
            engine.weight_bytes / 1e6))

    rs = np.random.RandomState(1)
    work = [(rs.randint(0, VOCAB, (int(rs.choice([24, 48, 96, 120, 200,
                                                  256])),)),
             int(rs.choice([32, 64]))) for _ in range(N_REQUESTS)]

    # warm-up: one request per bucket (first launches, cuBLAS-free path)
    for p in BUCKETS:
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()

    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    waves = [_serve_wave(engine, work) for _ in range(WAVES)]
    launches = K.launch_counts()
    rounds = engine.stats["steps"] - stats0["steps"]
    prefills = engine.stats["prefills"] - stats0["prefills"]
    steps = rounds * STEPS_PER_ROUND

    first = waves[0][0]
    for handles, _ in waves:
        for h, h0 in zip(handles, first):
            if not h.done or h.retire_reason != "length" \
                    or len(h.tokens) != h.limit:
                raise AssertionError("request %s did not finish its "
                                     "budget: %r" % (h.id, h))
            toks = np.asarray(h.tokens)
            if toks.min() < 0 or toks.max() >= VOCAB:
                raise AssertionError("request %s emitted ids outside the "
                                     "vocab" % h.id)
            if h.tokens != h0.tokens:
                raise AssertionError(
                    "request %s: a later wave's greedy stream differs from "
                    "the first wave's on the same prompt" % h.id)
    want = dict.fromkeys(launches, 0)   # the training entries stay 0
    want.update({"fused_decode_attention": LAYERS * steps,
                 # every prefill chunk (C = 64, 128, 256, bf16) takes the
                 # chunk entry; the scalar one stays 0
                 "paged_attention_chunk": LAYERS * prefills,
                 # per decode step: ffn1, ffn2 per layer + lm_head; per
                 # prefill also the qkv and out projections
                 "quant_matmul": (2 * LAYERS + 1) * steps
                 + (4 * LAYERS + 1) * prefills})
    if launches != want:
        raise AssertionError("launch counts %r, the main path wants %r"
                             % (launches, want))

    # two requests' streams against the offline decoder on the same weights
    dec = engine._dec
    checked = (first[0], max(first[1:], key=lambda r: len(r.prompt)))
    for h in checked:
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError(
                "request %s: the engine's greedy stream differs from "
                "Decoder.generate" % h.id)

    per_wave = [_wave_metrics(h, t) for h, t in waves]
    for i, ((hs, t), (tps, p50, p99)) in enumerate(zip(waves, per_wave)):
        log("main path wave %d: %d requests, %d tokens in %.3f s = %.1f "
            "tokens/s; ms per token p50 %.3f p99 %.3f" % (
                i, len(hs), sum(len(h.tokens) for h in hs), t, tps, p50,
                p99))
    cols = list(zip(*per_wave))
    log("main path: %d waves x %d requests, %d prefills, %d rounds x %d "
        "steps; median over waves (min-max): %.1f tokens/s (%.1f-%.1f), "
        "ms per token p50 %.3f (%.3f-%.3f), p99 %.3f (%.3f-%.3f); memory "
        "since the engine was built: %s; %s" % (
            WAVES, N_REQUESTS, prefills, rounds, STEPS_PER_ROUND,
            *(v for c in cols for v in (statistics.median(c), min(c),
                                        max(c))),
            memory(), card_line()))
    log("main path launches: %s" % json.dumps(launches))
    check_compile_counts(engine, "main path")
    check_eager_wave(engine, work, first)
    check_sampled_wave(engine, work)
    check_compile_counts(engine, "main path after the checks")
    check_main_against_host(prefix, dec, checked)
    profile_decode(engine, rs)
    with eager_programs():
        profile_decode(engine, rs, trace=None, what="uncaptured")
    time_prefill(K, dec)
    time_engine_prefill(engine)
    return launches, prefix, work


def time_prefill(K, dec, reps=10, profiled=3, what="124M"):
    """One 256-token prefill of the 124M decoder (the largest bucket, one
    slot, pos 0): its wall time after a synchronize (median and min-max of
    ``reps``), then, over ``profiled`` more under torch.profiler, its card
    kernel time and the paged chunk kernel's part of it (the kernels named
    ``fwd_mma``: the prefill runs no other attention forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = np.random.RandomState(5).randint(0, VOCAB, (1, BUCKETS[-1]))
    cache = dec.init_cache(1)
    for _ in range(2):
        dec.prefill(cache, prompt)
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dec.prefill(cache, prompt)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            dec.prefill(cache, prompt)
        torch.cuda.synchronize()
    chunks = K.launch_counts()["paged_attention_chunk"]
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(us for _, us in rows) / profiled / 1e3
    paged = sum(us for key, us in rows if "fwd_mma" in key) / profiled / 1e3
    log("prefill of %d tokens (%s, one slot, pos 0): wall %.3f ms median "
        "(%.3f-%.3f) after a synchronize; card kernels %.3f ms, of which "
        "the paged chunk kernel %.4f ms (%d launches a prefill); %s" % (
            BUCKETS[-1], what, statistics.median(walls), min(walls),
            max(walls),
            total, paged, chunks // profiled, card_line()))


def time_engine_prefill(engine, reps=10, profiled=3):
    """One 256-token prefill through the engine's captured bucket-256
    program (an admission: the operand copy, the replay and the first
    token's copy; ``engine._admit`` with one request queued): its wall
    time after a synchronize (median and min-max of ``reps``), then over
    ``profiled`` more under torch.profiler its card kernel time and host
    calls; the peak memory over all of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompt = np.random.RandomState(5).randint(0, VOCAB, (BUCKETS[-1],))

    def admit():
        engine.submit(prompt, max_tokens=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._admit()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def drain():
        while not engine.idle:
            engine.step()

    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(reps):
        walls.append(admit())
        drain()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            engine.submit(prompt, max_tokens=1)
        engine._admit()
        torch.cuda.synchronize()
    drain()
    rows = [e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    calls = host_calls(prof)
    log("engine prefill of %d tokens (captured bucket-%d program, one slot, "
        "pos 0): wall %.3f ms median (%.3f-%.3f) after a synchronize; card "
        "kernels %.3f ms; host calls per prefill %.1f %s; memory %s; %s" % (
            BUCKETS[-1], BUCKETS[-1], statistics.median(walls), min(walls),
            max(walls), sum(rows) / profiled / 1e3,
            sum(calls.values()) / profiled, json.dumps(calls), memory(),
            card_line()))


def serve_default_path(K, dev, prefix, work):
    """The 124M checkpoint served as ``InferenceEngine.from_checkpoint``
    serves it by default (``weight_dtype`` and ``matmul_impl`` left to the
    decoder: float weights, dense products), in bf16: each decode step's
    attention is a C=1 read of the bf16 cache through
    ``paged_attention_decode``, each prefill chunk goes through
    ``paged_attention_chunk``. One wave of the main path's requests with
    the counters zeroed just before it and read just after: exact
    launches (no other kernel), every budget met, two requests' streams
    equal to ``Decoder.generate``; tokens/s, ms per token, and a 2-round
    decode profile (card kernel ms per decode step). Returns the launch
    counts."""
    from mxnet_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, compute_dtype="bfloat16",
        device=dev)
    dec = engine._dec
    if (dec.weight_dtype, dec._matmul_impl) != ("float", "dense"):
        raise AssertionError("the default engine took weight_dtype=%r, "
                             "matmul_impl=%r" % (dec.weight_dtype,
                                                 dec._matmul_impl))
    rs = np.random.RandomState(6)
    for p in BUCKETS:                    # warm-up: one request per bucket
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    launches = K.launch_counts()
    prefills = engine.stats["prefills"] - stats0["prefills"]
    steps = (engine.stats["steps"] - stats0["steps"]) * STEPS_PER_ROUND
    for h in handles:
        if not h.done or h.retire_reason != "length" \
                or len(h.tokens) != h.limit:
            raise AssertionError("default engine: request %s did not "
                                 "finish its budget: %r" % (h.id, h))
    want = dict.fromkeys(launches, 0)
    want.update({"paged_attention_decode": LAYERS * steps,
                 "paged_attention_chunk": LAYERS * prefills})
    if launches != want:
        raise AssertionError("default engine: launch counts %r, the path "
                             "wants %r" % (launches, want))
    for h in (handles[0], max(handles[1:], key=lambda r: len(r.prompt))):
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError("default engine: request %s's stream "
                                 "differs from Decoder.generate" % h.id)
    check_compile_counts(engine, "default engine")
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("default engine (float weights, dense products): %d requests, %d "
        "prefills, %d decode steps in %.3f s = %.1f tokens/s, ms per token "
        "p50 %.3f p99 %.3f; launches %s; %s" % (
            len(handles), prefills, steps, secs, tps, p50, p99,
            json.dumps({e: n for e, n in launches.items() if n}),
            card_line()))
    profile_decode(engine, rs, trace="decode_default_trace.json.gz")
    return launches


def serve_int8_kv_path(K, dev, prefix, work):
    """The 124M checkpoint served with the int8 KV cache
    (``cache_dtype="int8"``): the decode chain runs unfused, so each decode
    step's attention is a C=1 read of the int8 rows through
    ``paged_attention_decode``, and each prefill chunk (C >= 64) goes
    through ``paged_attention_chunk`` (the int8 tiles on the tensor cores),
    none through the scalar ``paged_attention`` entry. One wave of the main
    path's requests with the counters zeroed just before it and read just
    after: exact launches, every budget met, and two requests' streams
    equal to ``Decoder.generate`` of the same decoder; then one 256-token
    prefill's wall and card time. Returns the launch counts."""
    from mxnet_tpu_torch.serving import InferenceEngine

    engine = InferenceEngine.from_checkpoint(
        prefix, 0, max_len=MAX_LEN, slots=SLOTS, prefill_buckets=BUCKETS,
        steps_per_round=STEPS_PER_ROUND, attn_impl="paged",
        weight_dtype="int8", matmul_impl="fused", cache_dtype="int8",
        compute_dtype="bfloat16", device=dev)
    rs = np.random.RandomState(4)
    for p in BUCKETS:                    # warm-up: one request per bucket
        engine.submit(rs.randint(0, VOCAB, (p,)), max_tokens=4)
    while not engine.idle:
        engine.step()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    stats0 = dict(engine.stats)
    handles, secs = _serve_wave(engine, work)
    launches = K.launch_counts()
    prefills = engine.stats["prefills"] - stats0["prefills"]
    steps = (engine.stats["steps"] - stats0["steps"]) * STEPS_PER_ROUND
    for h in handles:
        if not h.done or h.retire_reason != "length" \
                or len(h.tokens) != h.limit:
            raise AssertionError("int8 KV: request %s did not finish its "
                                 "budget: %r" % (h.id, h))
    want = dict.fromkeys(launches, 0)
    want.update({"paged_attention_chunk": LAYERS * prefills,
                 "paged_attention_decode": LAYERS * steps,
                 # qkv, out, ffn1 and ffn2 per layer + lm_head, per decode
                 # step and per prefill
                 "quant_matmul": (4 * LAYERS + 1) * (steps + prefills)})
    if launches != want:
        raise AssertionError("int8 KV path: launch counts %r, the path "
                             "wants %r" % (launches, want))
    dec = engine._dec
    for h in (handles[0], max(handles[1:], key=lambda r: len(r.prompt))):
        ref = dec.generate(h.prompt[None], len(h.tokens))[0, len(h.prompt):]
        if ref.cpu().tolist() != h.tokens:
            raise AssertionError("int8 KV: request %s's stream differs from "
                                 "Decoder.generate" % h.id)
    check_compile_counts(engine, "int8 KV path")
    tps, p50, p99 = _wave_metrics(handles, secs)
    log("int8 KV path: %d requests, %d prefills, %d decode steps in %.3f s "
        "= %.1f tokens/s, ms per token p50 %.3f p99 %.3f; launches %s" % (
            len(handles), prefills, steps, secs, tps, p50, p99,
            json.dumps({e: n for e, n in launches.items() if n})))
    time_prefill(K, dec, what="124M, int8 KV")
    time_engine_prefill(engine)
    return launches


def check_main_against_host(prefix, dec, handles, steps=16):
    """The 124M decoder rebuilt on the host from the same checkpoint (the
    plain versions, bf16) against the card's, for each served request:
    prefill logits over the prompt and its served stream agree within
    LOGIT_ULPS; each token the card chose is the host's argmax up to that
    tolerance; and the host's own greedy stream of ``steps`` tokens is
    reported against the card's (random weights leave near ties)."""
    from mxnet_tpu_torch.parallel import Decoder

    host = Decoder.from_checkpoint(
        prefix, 0, MAX_LEN, attn_impl="paged", weight_dtype="int8",
        matmul_impl="fused", compute_dtype="bfloat16", device="cpu")
    for h in handles:
        p = len(h.prompt)
        seq = np.concatenate([np.asarray(h.prompt),
                              np.asarray(h.tokens[:-1])])[None]
        lc, _ = dec.prefill(dec.init_cache(1), seq)
        lh, _ = host.prefill(host.init_cache(1), seq)
        lc, lh = lc[0].float().cpu(), lh[0].float()
        tol = LOGIT_ULPS * 2.0 ** -7 * lh.abs().amax(dim=-1)
        err = (lc - lh).abs().amax(dim=-1)
        rows = lh[p - 1:]
        toks = torch.as_tensor(h.tokens)
        gap = rows.amax(dim=-1) - rows.gather(1, toks[:, None])[:, 0]
        if (err > tol).any() or (gap > tol[p - 1:]).any():
            raise AssertionError(
                "request %s: the 124M LM on the card and on the host "
                "disagree: max |logit err| %.4g (tolerance %.4g), the "
                "card's tokens up to %.4g below the host's best" % (
                    h.id, err.max().item(), tol.min().item(),
                    gap.max().item()))
        ref = host.generate(np.asarray(h.prompt)[None], steps)[0, p:]
        same = next((i for i, (a, b) in enumerate(zip(ref.tolist(),
                                                      h.tokens))
                     if a != b), steps)
        log("124M card vs host, request %s (prompt %d): prefill logits max "
            "|err| %.4g = %.2f ulps of the row max (tolerance %d); card "
            "tokens the host's argmax at %d of %d positions, all within "
            "tolerance; host greedy stream equals the card's for %d of %d "
            "tokens" % (
                h.id, p, err.max().item(),
                (err / (2.0 ** -7 * lh.abs().amax(dim=-1))).max().item(),
                LOGIT_ULPS, int((rows.argmax(dim=-1) == toks).sum()),
                len(toks), same, steps))


def profile_decode(engine, rs, rounds=2, trace="decode_trace.json",
                   what="captured"):
    """Where a decode round's time goes: every slot busy (prompts of 64,
    long budgets), ``rounds`` rounds after one warm round: their wall
    time and the card's time over them by CUDA events, then the same
    number of rounds under torch.profiler. Prints the wall time per step,
    the card's kernel time per step (the profiler's sum; the events' span
    beside it) and its idle share (1 - kernel time / wall time), the host
    calls per round that put work on the card, the kernels by device time,
    and the peak memory; the trace goes to chiprun_out/ unless ``trace``
    is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(SLOTS):
        engine.submit(rs.randint(0, VOCAB, (64,)),
                      max_tokens=(2 * rounds + 2) * STEPS_PER_ROUND)
    engine.step()                        # admit all, one warm round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = Timer._events(1)[0]
    t0 = time.perf_counter()
    a.record()
    for _ in range(rounds):
        engine.step()
    b.record()
    torch.cuda.synchronize()
    wall_ev = time.perf_counter() - t0
    span_ms = a.elapsed_time(b)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    while not engine.idle:
        engine.step()
    steps = rounds * STEPS_PER_ROUND
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    calls = host_calls(prof)
    log("decode profile (%s): %d steps x %d slots; wall %.3f ms per step "
        "(unprofiled: %.3f, card span by events %.3f), card kernels %.3f "
        "ms per step, idle share %.3f; host calls per round %.1f %s; memory "
        "%s; %s" % (
            what, steps, SLOTS, wall * 1e3 / steps, wall_ev * 1e3 / steps,
            span_ms / steps, busy_us / 1e3 / steps,
            1.0 - busy_us / 1e6 / wall, sum(calls.values()) / rounds,
            json.dumps(calls), memory(), card_line()))
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log("  %-60s %8.3f ms per step  %5d calls" % (
            key[:60], us / 1e3 / steps, n))
    if trace is None:
        return
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, trace))


def check_small_against_host(dev):
    """A 2-layer LM served on the card (kernels) and on the host (plain
    versions) from the same seeded weights, in the decoder's other modes
    too: f32 prefill logits within 1e-3 (sums run in other orders) and
    greedy tokens equal. Weights are fan-in scaled so that the streams
    vary and the logits are far from ties."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import Decoder

    configs = [  # (model kwargs, decoder kwargs)
        (dict(num_kv_heads=2), dict(weight_dtype="int8",
                                    matmul_impl="fused")),
        (dict(num_kv_heads=2, pos_encoding="rope"),
         dict(weight_dtype="int4", matmul_impl="fused")),
        (dict(), dict(weight_dtype="int8", matmul_impl="pallas",
                      cache_dtype="int8")),
        (dict(pos_encoding="rope"), dict(weight_dtype="float")),
    ]
    prompt = np.random.RandomState(3).randint(0, 97, (2, 11))
    for mkw, dkw in configs:
        symbol = get_transformer_lm(97, num_layers=2, embed_dim=64,
                                    num_heads=4, **mkw)
        shapes = {"data": (1, 64), "softmax_label": (1, 64)}
        arg_shapes, _, _ = symbol.infer_shape(**shapes)
        rng = np.random.RandomState(2)
        params = {n: (rng.randn(*sh) * (1.5 / np.sqrt(sh[1])
                                        if len(sh) == 2 else 0.1)
                      + (n.endswith("_gamma"))).astype(np.float32)
                  for n, sh in zip(symbol.list_arguments(), arg_shapes)
                  if n not in shapes}
        out = {}
        for where in (dev, "cpu"):
            d = Decoder(symbol, params, max_len=64, device=where, **dkw)
            logits, _ = d.prefill(d.init_cache(2), prompt)
            out[str(where)] = (logits.cpu(), d.generate(prompt, 20).cpu())
        (lg, tg), (lh, th) = out[str(dev)], out["cpu"]
        err = (lg - lh).abs().max().item()
        same = torch.equal(tg, th)
        if err > 1e-3 or not same:
            raise AssertionError(
                "small LM %s %s: card and host disagree (max |logit err| "
                "%.3g, tokens equal %s)" % (mkw, dkw, err, same))
        log("small LM %s %s: card vs host prefill logits max |err| %.3g, "
            "greedy tokens equal (%d distinct)" % (
                mkw, dkw, err, len(set(tg[:, 11:].flatten().tolist()))))


# -- phase 5: the training main path -----------------------------------------

TRAIN_B, TRAIN_T = 8, 1024          # bench.py:214 bench_transformer_lm
WARM_STEPS, TIMED_STEPS = 3, 12
TRAIN_ENTRIES = ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "fused_linear")
# card vs host after one f32 step from the same weights (TF32 off on the
# card). The step's softmax output: within PROB_REL of its largest value
# (sums in other orders). The parameter deltas, per tensor:
# ||delta_card - delta_host|| / ||delta_host|| <= DELTA_REL, and every
# element within ELEM_REL of the tensor's largest delta. Both are far
# looser than f32 rounding because of the ReLU kink: a pre-activation
# within an ulp of zero lands on either side under any change of
# summation order, which flips that unit's derivative, rewrites its row of
# the ffn1 gradient and moves every gradient below it. Two correct host
# implementations (plain flash attention against dense attention) differ
# by up to 3.8e-3 per tensor in the norm and 0.040 of the largest element;
# a wrong kernel moves whole tensors by O(1)
PROB_REL = 1e-4
DELTA_REL = 2e-2
ELEM_REL = 0.1


def _lm_train_loss(outs, label):
    """Mean -log p[label] of the [B, V, T] softmax output."""
    p = outs[0].float()
    return -torch.log(p.gather(1, label[:, None, :]).clamp_min(1e-30)
                      ).mean().item()


def _train_batch(seed, b, t):
    rs = np.random.RandomState(seed)
    return {"data": rs.randint(0, VOCAB, (b, t)).astype(np.int32),
            "softmax_label": rs.randint(0, VOCAB, (b, t)).astype(np.int32)}


def _trainer(dev, b, t, compute_dtype):
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer
    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS, impl="flash")
    return ParallelTrainer(
        symbol, {"data": (b, t), "softmax_label": (b, t)}, optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        compute_dtype=compute_dtype, seed=0, device=dev).init_params()


def train_main_path(K, dev):
    """The 124M LM trained by ParallelTrainer(device=None) in bf16 at
    B=8, T=1024 on one repeated seeded batch: WARM_STEPS steps, then
    TIMED_STEPS steps with the launch counters zeroed just before and read
    just after. Returns the launch counts of the timed steps."""
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(None, TRAIN_B, TRAIN_T, "bfloat16")
    if trainer.device != dev:
        raise AssertionError("device=None resolved to %s" % trainer.device)
    batch = _train_batch(7, TRAIN_B, TRAIN_T)
    label = torch.as_tensor(batch["softmax_label"]).long().to(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(_lm_train_loss(trainer.step(batch), label))
    torch.cuda.synchronize()
    log("train: 124M LM (%d layers, E=%d, %d heads, vocab %d), B=%d T=%d "
        "bf16, SGD lr 1e-3 momentum 0.9; %d warm-up steps in %.1f s" % (
            LAYERS, EMBED, HEADS, VOCAB, TRAIN_B, TRAIN_T, WARM_STEPS,
            time.perf_counter() - t0))
    K.reset_launch_counts()
    secs, queued = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        outs = trainer.step(batch)
        queued.append(time.perf_counter() - t0)   # the host's part
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(_lm_train_loss(outs, label))
    launches = K.launch_counts()
    mem = memory()
    want = dict.fromkeys(launches, 0)
    want.update({e: LAYERS * TIMED_STEPS for e in TRAIN_ENTRIES})
    if launches != want:
        raise AssertionError("train launch counts %r, the main path wants %r"
                             % (launches, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.01:
        raise AssertionError("the loss on the repeated batch did not fall: "
                             "%r" % losses)
    tokens = TRAIN_B * TRAIN_T
    tps = [tokens / s for s in secs]
    n_params = LAYERS * (12 * EMBED * EMBED) + VOCAB * EMBED
    flops_per_tok = 6.0 * n_params + 12.0 * LAYERS * EMBED * TRAIN_T
    med = statistics.median(tps)
    log("train: %d timed steps; tokens/s median %.1f (min %.1f, max %.1f); "
        "ms per step median %.3f (min %.3f, max %.3f); MFU %.4f (%.4g "
        "FLOP per token, bench.py:231-236, over 989 TFLOP/s); memory since "
        "the trainer was built: %s; %s" % (
            TIMED_STEPS, med, min(tps), max(tps),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            med * flops_per_tok / 989e12, flops_per_tok, mem,
            card_line()))
    log("train: step() returns to the host after %.3f ms (median; min "
        "%.3f, max %.3f); the card finishes the step %.3f ms after it "
        "began (median); where the two are close, the host bounds the "
        "step" % (
            statistics.median(queued) * 1e3, min(queued) * 1e3,
            max(queued) * 1e3, statistics.median(secs) * 1e3))
    log("train: loss over the %d steps %s" % (
        len(losses), " ".join("%.4f" % v for v in losses)))
    log("train launches: %s" % json.dumps(launches))
    profile_train(trainer, batch)
    time_train_uncaptured(trainer, batch, secs)
    check_train_capture(trainer, batch, outs)
    return launches


def time_train_uncaptured(trainer, batch, captured_secs, steps=5):
    """The same step through ``Program._run_eager`` (uncaptured, over the
    same buffers): ``steps`` steps' wall time and the host's part, beside
    the captured steps' wall time; then a 2-step profile of it."""
    prog = trainer._step_program(batch, "step")

    def eager_step():
        trainer._next_lr()
        return [o.clone() for o in prog._run_eager()]

    eager_step()
    torch.cuda.synchronize()
    secs, queued = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        eager_step()
        queued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    log("train uncaptured (Program._run_eager): ms per step median %.3f "
        "(min %.3f, max %.3f), the host's part %.3f; captured: %.3f; %s" % (
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            statistics.median(queued) * 1e3,
            statistics.median(captured_secs) * 1e3, card_line()))
    profile_train(trainer, batch, trace=None, what="train uncaptured",
                  call=eager_step)


def check_train_capture(trainer, batch, outs, n=3):
    """From the same parameters (``set_params``, zero momentum), one
    captured step and one uncaptured step (``Program._run_eager``) must
    give the same parameters bitwise; ``multi_step(batch, n)`` the same
    bitwise as ``n`` captured ``step()``s. Then the cost of ``step()``'s
    output copy (CUDA events), and TIMED_STEPS steps as one
    ``multi_step`` (wall time per step)."""
    init, _ = trainer.get_params()
    prog = trainer._step_program(batch, "step")

    def after(run):
        trainer.set_params(init)
        run()
        torch.cuda.synchronize()
        return trainer._flat.clone()

    def eager():
        trainer._next_lr()
        prog._run_eager()

    cap = after(lambda: trainer.step(batch))
    eag = after(eager)
    if not torch.equal(cap, eag):
        raise AssertionError(
            "a captured train step and an uncaptured one from the same "
            "parameters differ: max |diff| %.3g" % (cap - eag).abs().max())
    steps = after(lambda: [trainer.step(batch) for _ in range(n)])
    multi = after(lambda: trainer.multi_step(batch, n))
    if not torch.equal(steps, multi):
        raise AssertionError(
            "multi_step(batch, %d) and %d captured steps differ: max |diff| "
            "%.3g" % (n, n, (steps - multi).abs().max()))
    copy_ms = Timer(trainer.device)(lambda: [o.clone() for o in outs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.multi_step(batch, TIMED_STEPS)
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / TIMED_STEPS
    log("train capture: a captured step equals an uncaptured one bitwise "
        "(%d parameters); multi_step(batch, %d) equals %d captured steps "
        "bitwise; step()'s output copy (%.1f MB) %.4f ms; multi_step(batch, "
        "%d) %.3f ms per step; %s" % (
            cap.numel(), n, n, nbytes(*outs) / 1e6, copy_ms, TIMED_STEPS,
            per * 1e3, card_line()))


def profile_train(trainer, batch, steps=2, trace="train_trace.json",
                  what="train", call=None):
    """Where a train step's time goes: ``steps`` calls of ``call`` (a
    train step by default) under torch.profiler. Prints the wall and card
    kernel time per step, the card's busy share (kernel time / wall time),
    and the kernels by device time; the trace is written beside the other
    traces unless ``trace`` is None. Returns (wall ms, kernel ms, busy
    share) per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call = call or (lambda: trainer.step(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    calls = host_calls(prof)
    log("%s profile: %d steps; wall %.3f ms per step, card kernels %.3f "
        "ms per step, busy share %.3f, idle share %.3f; host calls per "
        "step %.1f %s" % (
            what, steps, wall * 1e3 / steps, busy_us / 1e3 / steps,
            busy_us / 1e6 / wall, 1.0 - busy_us / 1e6 / wall,
            sum(calls.values()) / steps, json.dumps(calls)))
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log("  %-60s %8.3f ms per step  %5d calls" % (
            key[:60], us / 1e3 / steps, n))
    result = (wall * 1e3 / steps, busy_us / 1e3 / steps, busy_us / 1e6 / wall)
    if trace is None:
        return result
    out = os.path.join(HERE, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, trace))
    return result


def check_train_against_host(dev, b=1, t=128):
    """The 124M LM with the same seeded initial weights takes one f32
    step at B=1, T=128 on the card (the kernels) and on the host (their
    plain versions): the softmax outputs agree within PROB_REL and every
    parameter's delta within DELTA_REL and ELEM_REL (see above)."""
    batch = _train_batch(11, b, t)
    res = {}
    for where in (dev, "cpu"):
        tr = _trainer(where, b, t, None)
        before = {n: v.clone() for n, v in tr.params.items()}
        probs = tr.step(batch)[0].cpu()
        res[str(where)] = (probs, {n: (tr.params[n] - before[n]).cpu()
                                   for n in before})
    (pc, card), (ph, host) = res[str(dev)], res["cpu"]
    perr = (pc - ph).abs().max().item() / ph.abs().max().item()
    rows = []
    for n, dh in host.items():
        fro = ((card[n] - dh).norm() / dh.norm()).item()
        top = ((card[n] - dh).abs().max() / dh.abs().max()).item()
        rows.append((fro, top, n))
    rows.sort(reverse=True)
    if not perr <= PROB_REL or not all(r[0] <= DELTA_REL and r[1] <= ELEM_REL
                                       for r in rows):
        raise AssertionError(
            "card vs host step: softmax output %.3g of its max (gate %g); "
            "worst deltas (norm, largest element) %s (gates %g, %g)" % (
                perr, PROB_REL,
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL, ELEM_REL))
    worst_elem = max(rows, key=lambda r: r[1])
    log("train card vs host: one f32 step of the 124M LM at B=%d T=%d; "
        "softmax output max |err| %.3g of its max (gate %g); %d parameter "
        "deltas agree, worst in norm %s %.3g (gate %g), worst element %s "
        "%.3g of its largest delta (gate %g)" % (
            b, t, perr, PROB_REL, len(rows), rows[0][2], rows[0][0],
            DELTA_REL, worst_elem[2], worst_elem[1], ELEM_REL))


# -- phase 6: the conv-net path: ResNet-50 -------------------------------------

RESNET_FLOPS_PER_IMG = 3 * 4.1e9    # bench.py:39, forward + backward
RESNET_CHAINS, RESNET_POINTWISE = 53, 33
GATE = "MXNET_PALLAS_CONVBN_TRAIN"
# card vs host, f32, from the same weights: log-probabilities of the eval
# forward within LOGP_ATOL (53 convs summed in other orders, the card's
# fused_conv_bn_act against F.conv2d on the host); one train step's
# softmax output and parameter deltas within the LM check's gates
# (PROB_REL, DELTA_REL, ELEM_REL: the ReLU kink, above)
LOGP_ATOL = 1e-3


def _resnet_trainer(dev, b, compute_dtype):
    from mxnet_tpu_torch.models import get_resnet
    from mxnet_tpu_torch.parallel import ParallelTrainer
    return ParallelTrainer(
        get_resnet(RESNET_CLASSES, RESNET_LAYERS),
        {"data": (b, 3, RESNET_HW, RESNET_HW), "softmax_label": (b,)},
        optimizer="sgd", optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9, "wd": 1e-4},
        compute_dtype=compute_dtype, seed=0, device=dev)


def _resnet_batch(seed, b, dev=None):
    """Images uniform in [0, 1) and integer labels from one seed (as
    bench.py makes them), on ``dev`` when given (a device-resident batch,
    as bench.py times it)."""
    rs = np.random.RandomState(seed)
    batch = {"data": rs.rand(b, 3, RESNET_HW, RESNET_HW).astype(np.float32),
             "softmax_label": rs.randint(0, RESNET_CLASSES, (b,)
                                         ).astype(np.int32)}
    if dev is not None:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return batch


def _resnet_scaled_params(seed):
    """Fan-in scaled weights, gamma near 1 but near 0.2 at the end of each
    residual branch (so the residual stream stays O(1) through 16 units
    and the logits O(1): log-probabilities are then comparable and the
    top-1 far from ties), nonzero beta and moving statistics (so the eval
    fold does real work)."""
    from mxnet_tpu_torch.models import get_resnet
    sym = get_resnet(RESNET_CLASSES, RESNET_LAYERS)
    shapes = {"data": (1, 3, RESNET_HW, RESNET_HW), "softmax_label": (1,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {}
    for n, sh in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            v = rng.randn(*sh) * np.sqrt(2.0 / np.prod(sh[1:]))
        elif n.endswith("_gamma"):
            v = (0.2 if n.endswith("_c_bn_gamma") else 1.0) \
                * (1.0 + 0.1 * rng.randn(*sh))
        else:
            v = 0.1 * rng.randn(*sh)
        args[n] = v.astype(np.float32)
    aux = {n: (0.1 * rng.randn(*sh) if n.endswith("mean")
               else rng.uniform(0.5, 1.5, sh)).astype(np.float32)
           for n, sh in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _resnet_loss(outs, label):
    p = outs[0].float()
    return -torch.log(p.gather(1, label[:, None]).clamp_min(1e-30)
                      ).mean().item()


def _resnet_steps(K, trainer, batch, label, losses, steps):
    """``steps`` timed train steps with the launch counters zeroed just
    before and read just after: (seconds, host seconds, launches, the
    memory since the trainer was built)."""
    K.reset_launch_counts()
    secs, queued = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        outs = trainer.step(batch)
        queued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(_resnet_loss(outs, label))
    return secs, queued, K.launch_counts(), memory()


def _report_resnet(what, b, secs, queued, mem, busy):
    ips = [b / t for t in secs]
    med = statistics.median(ips)
    log("%s: %d timed steps at B=%d; img/s median %.1f (min %.1f, max "
        "%.1f); ms per step median %.3f (min %.3f, max %.3f); MFU %.4f "
        "(%.3g FLOP per image, bench.py:39, over 989 TFLOP/s); step() "
        "returns after %.3f ms (median); busy share %.3f (profiled); memory "
        "since the trainer was built: %s; %s" % (
            what, len(secs), b, med, min(ips), max(ips),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            med * RESNET_FLOPS_PER_IMG / 989e12, RESNET_FLOPS_PER_IMG,
            statistics.median(queued) * 1e3, busy, mem,
            card_line()))


def train_resnet(K, dev):
    """ResNet-50 trained by ParallelTrainer(device=None) as bench.py:115-124
    trains it (B=256, 224 x 224, bf16 over f32 master weights, SGD lr 0.1
    momentum 0.9 wd 1e-4, default init) with MXNET_PALLAS_CONVBN_TRAIN=1
    set before the trainer is built: WARM_STEPS steps, then TIMED_STEPS
    with exactly RESNET_POINTWISE matmul_stats launches per step and a
    falling loss, a 2-step profile; then the same TIMED_STEPS with the
    gate unset (no launch: the unfused ops). Returns the gate-on launch
    counts."""
    os.environ[GATE] = "1"
    torch.cuda.reset_peak_memory_stats()
    trainer = _resnet_trainer(None, RESNET_B, "bfloat16").init_params()
    if trainer.device != dev:
        raise AssertionError("device=None resolved to %s" % trainer.device)
    batch = _resnet_batch(0, RESNET_B, dev)
    label = batch["softmax_label"].long()
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(_resnet_loss(trainer.step(batch), label))
    torch.cuda.synchronize()
    log("resnet train: ResNet-50, B=%d 3x%dx%d bf16, SGD lr 0.1 momentum "
        "0.9 wd 1e-4, %s=1; %d warm-up steps in %.1f s" % (
            RESNET_B, RESNET_HW, RESNET_HW, GATE, WARM_STEPS,
            time.perf_counter() - t0))
    secs, queued, launches, peak = _resnet_steps(
        K, trainer, batch, label, losses, TIMED_STEPS)
    want = dict.fromkeys(launches, 0)
    want["matmul_stats"] = RESNET_POINTWISE * TIMED_STEPS
    if launches != want:
        raise AssertionError("resnet train launch counts %r, the main path "
                             "wants %r" % (launches, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - 0.01:
        raise AssertionError("the ResNet-50 loss on the repeated batch did "
                             "not fall: %r" % losses)
    _, _, busy = profile_train(trainer, batch, trace="resnet_train_trace.json",
                               what="resnet train (%s=1)" % GATE)
    _report_resnet("resnet train (%s=1)" % GATE, RESNET_B, secs, queued,
                   peak, busy)
    log("resnet train: loss over the %d steps %s" % (
        len(losses), " ".join("%.4f" % v for v in losses)))
    log("resnet train launches: %s" % json.dumps(launches))

    # the step program read the gate when it was built, as the JAX
    # package reads it when it traces: the gate-off steps take a trainer
    # built with the gate unset, from the same seeded initial weights
    del os.environ[GATE]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = _resnet_trainer(None, RESNET_B, "bfloat16").init_params()
    trainer.step(batch)                 # the unfused step's capture
    torch.cuda.synchronize()
    secs, queued, off, peak = _resnet_steps(K, trainer, batch, label, [],
                                            TIMED_STEPS)
    if any(off.values()):
        raise AssertionError("with %s unset the step launched %r" % (
            GATE, off))
    _, _, busy = profile_train(trainer, batch, trace=None,
                               what="resnet train (%s unset)" % GATE)
    _report_resnet("resnet train (%s unset)" % GATE, RESNET_B, secs, queued,
                   peak, busy)
    return {"matmul_stats": launches["matmul_stats"]}


def eval_resnet(K, dev):
    """ResNet-50's inference forward, ``trainer.forward()`` at B=256 of
    the bf16 trainer, from fan-in scaled weights and nonzero moving
    statistics. As in the JAX package, forward() runs on the f32 master
    parameters and the batch as given, so the chains run the kernel's f32
    path: 2 warm-up forwards, then TIMED_STEPS with exactly RESNET_CHAINS
    fused_conv_bn_act launches each; finite probabilities that sum to 1.
    Returns the launch counts."""
    trainer = _resnet_trainer(None, RESNET_B, "bfloat16")
    trainer.init_params(*_resnet_scaled_params(1))
    batch = _resnet_batch(2, RESNET_B, dev)
    for _ in range(2):
        trainer.forward(batch)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    secs, outs = [], None
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        outs = trainer.forward(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want["fused_conv_bn_act"] = RESNET_CHAINS * TIMED_STEPS
    if launches != want:
        raise AssertionError("resnet eval launch counts %r, the main path "
                             "wants %r" % (launches, want))
    p = outs[0].float()
    if p.shape != (RESNET_B, RESNET_CLASSES) or not torch.isfinite(p).all() \
            or (p.sum(dim=1) - 1).abs().max().item() > 1e-2:
        raise AssertionError("resnet eval: the probabilities are not finite "
                             "rows of %d summing to 1" % RESNET_CLASSES)
    _, _, busy = profile_train(trainer, batch, trace=None,
                               what="resnet eval",
                               call=lambda: trainer.forward(batch))
    ips = [RESNET_B / t for t in secs]
    log("resnet eval: %d forwards at B=%d f32 (bf16 trainer); img/s median "
        "%.1f (min %.1f, "
        "max %.1f); ms per forward median %.3f; busy share %.3f (profiled); "
        "peak memory %.1f MB; %d distinct top-1 classes; %s" % (
            TIMED_STEPS, RESNET_B, statistics.median(ips), min(ips),
            max(ips), statistics.median(secs) * 1e3, busy, peak / 2**20,
            len(set(p.argmax(dim=1).tolist())), card_line()))
    log("resnet eval launches: %s" % json.dumps(launches))

    # the same forwards with no chain fused (F.conv2d, BatchNorm and relu
    # as separate ops, no kernel of the port): what the fold costs or
    # saves
    from mxnet_tpu_torch.ops.fusion import eval_graph
    topo, heads = trainer.symbol._topo(), trainer.symbol._heads
    fused_fn = trainer._graph_fn
    trainer._graph_fn = lambda a, x, t, g: eval_graph(topo, heads, a, x, t,
                                                      g)[:2]
    for _ in range(2):
        trainer.forward(batch)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    usecs = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        uouts = trainer.forward(batch)
        torch.cuda.synchronize()
        usecs.append(time.perf_counter() - t0)
    trainer._graph_fn = fused_fn
    if any(K.launch_counts().values()):
        raise AssertionError("the unfused forward launched %r"
                             % K.launch_counts())
    q = uouts[0].float()
    log("resnet eval unfused (no chain fused): %d forwards at B=%d f32; "
        "ms per forward median %.3f (min %.3f, max %.3f) against %.3f "
        "fused; probabilities max |fused - unfused| %.3g, top-1 equal for "
        "%d of %d; %s" % (
            TIMED_STEPS, RESNET_B, statistics.median(usecs) * 1e3,
            min(usecs) * 1e3, max(usecs) * 1e3, statistics.median(secs) * 1e3,
            (p - q).abs().max().item(),
            int((p.argmax(dim=1) == q.argmax(dim=1)).sum()), RESNET_B,
            card_line()))
    return {"fused_conv_bn_act": launches["fused_conv_bn_act"]}


def check_resnet_against_host(dev, b=2):
    """ResNet-50 in f32 at B=2 from the same fan-in scaled weights on the
    card (the kernels) and on the host (their plain versions), with
    MXNET_PALLAS_CONVBN_TRAIN=1: the eval forward's log-probabilities
    within LOGP_ATOL and the same top-1; then one train step's softmax
    output within PROB_REL and each parameter's delta within DELTA_REL
    (norm) and ELEM_REL (largest element)."""
    os.environ[GATE] = "1"
    args, aux = _resnet_scaled_params(3)
    batch = _resnet_batch(4, b)
    res = {}
    for where in (dev, "cpu"):
        tr = _resnet_trainer(where, b, None)
        tr.init_params(args, aux)
        logp = torch.log(tr.forward(batch)[0].cpu())
        before = {n: v.clone() for n, v in tr.params.items()}
        probs = tr.step(batch)[0].cpu()
        res[str(where)] = (logp, probs, {n: (tr.params[n] - before[n]).cpu()
                                         for n in before})
    del os.environ[GATE]
    (lc, pc, card), (lh, ph, host) = res[str(dev)], res["cpu"]
    lerr = (lc - lh).abs().max().item()
    top = lh.topk(2, dim=1).values
    gap = (top[:, 0] - top[:, 1]).min().item()
    same = torch.equal(lc.argmax(dim=1), lh.argmax(dim=1))
    perr = (pc - ph).abs().max().item() / ph.abs().max().item()
    rows = sorted((((card[n] - dh).norm() / dh.norm()).item(),
                   ((card[n] - dh).abs().max() / dh.abs().max()).item(), n)
                  for n, dh in host.items())[::-1]
    # written so that a NaN fails every gate
    if not (lerr <= LOGP_ATOL and same and perr <= PROB_REL) \
            or not all(r[0] <= DELTA_REL and r[1] <= ELEM_REL for r in rows):
        raise AssertionError(
            "resnet card vs host: eval log-probabilities max |err| %.3g (gate "
            "%g), top-1 equal %s; train softmax %.3g of its max (gate %g); "
            "worst deltas (norm, largest element) %s (gates %g, %g)" % (
                lerr, LOGP_ATOL, same, perr, PROB_REL,
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL, ELEM_REL))
    worst_elem = max(rows, key=lambda r: r[1])
    log("resnet card vs host: ResNet-50 f32 at B=%d, %s=1; eval "
        "log-probabilities max |err| %.3g (gate %g), top-1 equal (smallest "
        "top-2 gap %.3g); one train step: softmax output %.3g of its max "
        "(gate %g), %d parameter deltas agree, worst in norm %s %.3g (gate "
        "%g), worst element %s %.3g (gate %g)" % (
            b, GATE, lerr, LOGP_ATOL, gap, perr, PROB_REL, len(rows),
            rows[0][2], rows[0][0], DELTA_REL, worst_elem[2], worst_elem[1],
            ELEM_REL))


# -- phase 7: the sequence-parallel training path ----------------------------

SP_B, SP_T = 2, 4096                # 8192 tokens a step, as TRAIN_B x TRAIN_T
SP_MESH = {"dp": 1, "sp": SP_RING}
SP_ENTRIES = ("striped_pair_fwd", "striped_pair_dq", "striped_pair_dkv")
# the striped ring against dense causal attention on the card, f32 (TF32
# off): tests/test_parallel.py's ring tolerance
RING_TOL = (2e-4, 2e-5)
# the f32 SP loss is computed the same way every step; f32 noise on a loss
# of ~10.4 is ~1e-5, so a fall of LOSS_FALL is a real one
LOSS_FALL = 1e-3


def _sp_mesh(dev):
    from mxnet_tpu_torch.parallel import build_mesh
    return build_mesh(SP_MESH, [dev] * SP_RING)


def check_ring_on_card(dev):
    """striped_ring_attention over a 4-rank mesh on one card ([cuda:0] *
    4: every hop runs the pair kernel at a real striped offset) against
    dense causal attention, values and the q/k/v gradients of sum(out *
    w), f32, at T=32 (tests/test_parallel.py's shape) and at a ragged
    T=4*100 with 3 heads of 64 (local C=100: not a multiple of the
    tiles)."""
    from mxnet_tpu_torch.parallel import striped_ring_attention
    mesh = _sp_mesh(dev)
    rtol, atol = RING_TOL
    worst = 0.0
    for b, t, h, d in ((2, 32, 2, 8), (2, 400, 3, 64)):
        rng = np.random.RandomState(t)
        q, k, v, w = (torch.from_numpy(rng.randn(b, t, h, d).astype(
            np.float32)).to(dev).requires_grad_() for _ in range(4))
        res = []
        for fn in (lambda: striped_ring_attention(q, k, v, mesh),
                   lambda: _dense_causal(q, k, v)):
            out = fn()
            res.append([out.detach()] + list(torch.autograd.grad(
                (out * w).sum(), (q, k, v))))
        torch.cuda.synchronize()
        for name, got, want in zip(("out", "dq", "dk", "dv"), *res):
            err = (got - want).abs()
            if not torch.isfinite(got).all() \
                    or (err > atol + rtol * want.abs()).any():
                raise AssertionError(
                    "striped ring on %s vs dense causal, %s B=%d T=%d H=%d "
                    "D=%d: max |err| %.3g" % (mesh, name, b, t, h, d,
                                              err.max().item()))
            worst = max(worst, err.max().item())
    log("striped ring on a 4-rank mesh on one card vs dense causal "
        "attention: out, dq, dk, dv agree at T=32 and T=400, max |err| "
        "%.3g (rtol %g, atol %g)" % (worst, rtol, atol))


def _dense_causal(q, k, v):
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(dim=-1), v)


def _sp_trainer(dev, b, t, arg_params=None):
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import SequenceParallelTrainer
    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS, impl="ring_striped")
    return SequenceParallelTrainer(
        symbol, {"data": (b, t), "softmax_label": (b, t)}, _sp_mesh(dev),
        optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        seed=0).init_params(arg_params)


def sp_main_path(K, dev):
    """The 124M LM (impl="ring_striped") trained by SequenceParallelTrainer
    on the mesh {dp: 1, sp: 4} over [cuda:0] * 4 at B=2, T=4096 (local
    C=1024 a rank), f32, SGD lr 1e-3 momentum 0.9, rescale_grad 1/(B T),
    the default Uniform(0.05) init from seed 0, on one repeated seeded
    batch: WARM_STEPS steps, then TIMED_STEPS with the launch counters
    zeroed just before and read just after. Per step, exactly 12 layers x
    4 ranks x 4 hops = 192 launches of each striped_pair entry and 12 x 4
    of fused_linear (each rank's ffn1 + relu chains). Returns the launch
    counts of the timed steps."""
    trainer = _sp_trainer(dev, SP_B, SP_T)
    batch = _train_batch(7, SP_B, SP_T)
    losses = []
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        losses.append(trainer.step(batch).item())
    torch.cuda.synchronize()
    log("sp train: 124M LM (%d layers, E=%d, %d heads, vocab %d, "
        "impl=ring_striped), B=%d T=%d f32 on the mesh %s over %d x %s, "
        "local C=%d; SGD lr 1e-3 momentum 0.9; %d warm-up steps in %.1f s"
        % (LAYERS, EMBED, HEADS, VOCAB, SP_B, SP_T, SP_MESH, SP_RING, dev,
           SP_T // SP_RING, WARM_STEPS, time.perf_counter() - t0))
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    secs, queued = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        nll = trainer.step(batch)
        queued.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(nll.item())
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = dict.fromkeys(launches, 0)
    per_step.update({e: LAYERS * SP_RING * SP_RING for e in SP_ENTRIES})
    per_step["fused_linear"] = LAYERS * SP_RING
    want = {e: n * TIMED_STEPS for e, n in per_step.items()}
    if launches != want:
        raise AssertionError("sp train launch counts %r, the main path "
                             "wants %r" % (launches, want))
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0] - LOSS_FALL:
        raise AssertionError("the SP loss on the repeated batch did not "
                             "fall: %r" % losses)
    tokens = SP_B * SP_T
    tps = [tokens / s for s in secs]
    log("sp train: %d timed steps; tokens/s median %.1f (min %.1f, max "
        "%.1f); ms per step median %.3f (min %.3f, max %.3f); step() "
        "returns after %.3f ms (median; min %.3f, max %.3f); peak memory "
        "%.1f MB; %s" % (
            TIMED_STEPS, statistics.median(tps), min(tps), max(tps),
            statistics.median(secs) * 1e3, min(secs) * 1e3, max(secs) * 1e3,
            statistics.median(queued) * 1e3, min(queued) * 1e3,
            max(queued) * 1e3, peak / 2**20, card_line()))
    log("sp train: loss over the %d steps %s" % (
        len(losses), " ".join("%.5f" % v for v in losses)))
    log("sp train launches per step: %s" % json.dumps(
        {e: n for e, n in per_step.items() if n}))
    # gzipped: the 2 steps make a trace of over 30 MB
    profile_train(trainer, batch, trace="sp_train_trace.json.gz",
                  what="sp train")
    return launches


def _delta_rows(got, want):
    """[(norm of the difference / norm of want, largest |difference| /
    largest |want|, name)] per tensor, worst norm first."""
    return sorted((((got[n] - dw).norm() / dw.norm()).item(),
                   ((got[n] - dw).abs().max() / dw.abs().max()).item(), n)
                  for n, dw in want.items())[::-1]


def check_sp_against_flash(dev, b=1, t=1024):
    """One f32 step of the 124M LM from the same seeded weights through
    SequenceParallelTrainer(impl="ring_striped") on [cuda:0] * 4 and
    through ParallelTrainer(impl="flash", device=None), both with
    rescale_grad 1/(B T): every parameter's delta agrees within DELTA_REL
    of its norm (the ReLU kink rule). The on-card oracle that the striped
    ring is causal attention. The same step with impl="dense" is the
    yardstick of what two correct attentions differ by at this length:
    its distance from the flash step is reported beside the SP step's,
    per tensor in the norm and in the largest element (where a few kink
    flips show most)."""
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer

    def single(impl):
        symbol = get_transformer_lm(VOCAB, num_layers=LAYERS,
                                    embed_dim=EMBED, num_heads=HEADS,
                                    impl=impl)
        return ParallelTrainer(
            symbol, {"data": (b, t), "softmax_label": (b, t)},
            optimizer="sgd",
            optimizer_params={"learning_rate": 1e-3, "momentum": 0.9,
                              "rescale_grad": 1.0 / (b * t)},
            seed=0, device=None)

    flash = single("flash")
    params = _lm_params(flash.symbol, t, 5)
    batch = _train_batch(13, b, t)
    deltas = []
    for tr in (_sp_trainer(dev, b, t, params), flash.init_params(params),
               single("dense").init_params(params)):
        before = {n: v.clone() for n, v in tr.params.items()}
        tr.step(batch)
        deltas.append({n: (tr.params[n] - before[n]).cpu() for n in before})
        del tr, before
    torch.cuda.synchronize()
    sp, want, dense = deltas
    rows, ref = _delta_rows(sp, want), _delta_rows(dense, want)
    if not all(r[0] <= DELTA_REL for r in rows):
        raise AssertionError(
            "sp ring_striped vs flash step: worst deltas (norm, largest "
            "element) %s (gate %g on the norm)" % (
                ["%s %.3g %.3g" % (n, f, e) for f, e, n in rows[:5]],
                DELTA_REL))
    elem, ref_elem = max(rows, key=lambda r: r[1]), max(ref,
                                                        key=lambda r: r[1])
    log("sp vs flash: one f32 step of the 124M LM at B=%d T=%d, "
        "SequenceParallelTrainer(ring_striped, sp=4 on one card) against "
        "ParallelTrainer(flash); %d parameter deltas agree, worst in norm "
        "%s %.3g (gate %g); worst element %s %.3g of its largest delta. "
        "Yardstick, ParallelTrainer(dense) against flash: worst in norm %s "
        "%.3g, worst element %s %.3g" % (
            b, t, len(rows), rows[0][2], rows[0][0], DELTA_REL, elem[2],
            elem[1], ref[0][2], ref[0][0], ref_elem[2], ref_elem[1]))


# -- main -------------------------------------------------------------------

def ptxas_summary(K, name, rows=None):
    """The build log of source ``name`` (or its ``K.ptxas_report`` rows)
    in a few lines: its compiled functions, their largest register count,
    and each function that spills, with its registers and spilled
    bytes."""
    rows = rows or K.ptxas_report(K.build_log(name))
    regs = [r["registers"] for r in rows if r["registers"] is not None]
    spills = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    return "  ptxas %s: %d functions, registers max %d, %d spill%s" % (
        name, len(regs), max(regs), len(spills), "".join(
            "\n    spills: %s: %s registers, %d bytes stored, %d loaded"
            % (r["name"], r["registers"], r["spill_stores"],
               r["spill_loads"]) for r in spills))


def ptxas_lines(K, name, keys):
    """One line per function of source ``name`` whose demangled name holds
    one of ``keys``: its registers and spilled bytes."""
    rows = [r for r in K.ptxas_report(K.build_log(name))
            if any(k in r["name"] for k in keys)]
    return "\n".join("  ptxas %s: %s registers, %d bytes spill stores, %d "
                     "spill loads" % (r["name"], r["registers"],
                                      r["spill_stores"], r["spill_loads"])
                     for r in rows)


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device — this script runs on the card")
        return 2
    sys.path.insert(0, HERE)
    from mxnet_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log("card: %s | nvidia-smi: %s | torch %s cuda %s" % (
        name, card, torch.__version__, torch.version.cuda))

    t_start = t0 = time.perf_counter()
    secs = K.build()
    log("build: %.1f s wall (%s)" % (time.perf_counter() - t0, ", ".join(
        "%s %.1f s" % kv for kv in secs.items())))
    for kname in K.KERNELS:
        log(ptxas_summary(K, kname))
    # the paged chunk's instantiations, bf16 and int8 cache; the int8
    # ones must not spill
    log(ptxas_lines(K, "paged_attention", ["fwd_mma"]))
    spilled = [r["name"] for r in K.ptxas_report(
        K.build_log("paged_attention"))
        if "fwd_mma" in r["name"] and "signed char" in r["name"]
        and (r["spill_stores"] or r["spill_loads"])]
    if spilled:
        raise AssertionError("the int8 paged chunk spills: %s" % spilled)

    gen = torch.Generator().manual_seed(0)
    worst = {"quant_matmul": check_quant_matmul(K, dev, gen),
             "fused_decode_attention": check_fused_decode_attention(
                 K, dev, gen)}
    worst.update(check_paged_attention(K, dev, gen))
    worst.update(check_flash_attention(K, dev, gen))
    check_flash_repeat(K, dev)
    worst["fused_linear"] = check_fused_linear(K, dev, gen)
    dgen = torch.Generator(device=dev).manual_seed(1)
    worst["matmul_stats"] = check_matmul_stats(K, dev, gen, dgen)
    worst["fused_conv_bn_act"] = check_fused_conv_bn_act(K, dev, gen, dgen)
    worst.update(check_striped_pair(K, dev, gen))
    check_mha_gqa(dev)
    timed = time_kernels(K, dev, gen, worst)
    timed.update(time_train_kernels(K, dev, gen, worst))
    timed.update(time_cnn_kernels(K, dev, dgen, worst))
    timed.update(time_striped_pair(K, dev, gen, worst))
    launches, prefix, work = serve_main_path(K, dev)
    free_programs()
    launches["paged_attention_decode"] = serve_default_path(
        K, dev, prefix, work)["paged_attention_decode"]
    free_programs()
    serve_int8_kv_path(K, dev, prefix, work)
    free_programs()
    check_small_against_host(dev)
    launches.update({e: n for e, n in train_main_path(K, dev).items()
                     if e in TRAIN_ENTRIES})
    free_programs()
    check_train_against_host(dev)
    free_programs()
    launches.update(train_resnet(K, dev))
    free_programs()
    launches.update(eval_resnet(K, dev))
    check_resnet_against_host(dev)
    free_programs()
    check_ring_on_card(dev)
    launches.update({e: n for e, n in sp_main_path(K, dev).items()
                     if e in SP_ENTRIES})
    check_sp_against_flash(dev)
    replaces = {
        "paged_attention": 1115, "paged_attention_chunk": 1115,
        "paged_attention_decode": 1115,
        "quant_matmul": 1259,
        "fused_decode_attention": 1389,
        "flash_attention_fwd": 107,     # _attn_fwd_kernel
        "flash_attention_dq": 200,      # _attn_dq_kernel
        "flash_attention_dkv": 241,     # _attn_dkv_kernel
        "striped_pair_fwd": 445,        # _spair_fwd_kernel
        "striped_pair_dq": 491,         # _spair_dq_kernel
        "striped_pair_dkv": 528,        # _spair_dkv_kernel
        "fused_linear": 725,            # _gemm_epi_kernel
        "fused_conv_bn_act": 838,
        "matmul_stats": 876}            # _gemm_stats_kernel
    # the scalar paged entry takes what no path runs (an f32 q or cache
    # at C >= 16, an int8 cache under an f32 q): its row is off the paths
    missing = [e for e in K.SOURCE if not launches[e]
               and e not in OFF_PATH]
    if missing:
        raise AssertionError("the main paths never launched %s" % missing)
    line = {"kernels": [dict(
        name=e, route="cuda",
        source="mxnet_tpu_torch/ops/csrc/%s.cu" % K.SOURCE[e],
        replaces="mxnet_tpu/ops/pallas_kernels.py:%d" % replaces[e],
        launches=launches[e], max_abs_err=timed[e]["max_abs_err"],
        ms=timed[e]["ms"], plain_ms=timed[e]["plain_ms"],
        bound_ms=timed[e]["bound_ms"], bound_by=timed[e]["bound_by"],
        library_ms=timed[e]["library_ms"], shape=timed[e]["shape"],
        **{k: timed[e][k] for k in ("stage2", "stage3", "stage4", "stem",
                                    "proj", "bf16", "f32", "scalar_ms",
                                    "int8", "c4")
           if k in timed[e]})
        for e in K.SOURCE]}
    log("chip_smoke: every phase passed in %.1f s"
        % (time.perf_counter() - t_start))
    log(json.dumps(line))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
