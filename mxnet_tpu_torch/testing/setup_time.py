"""Set-up time of the serving engine and the trainer on the card, at the
sizes of ``chip_smoke.py``'s phases 4 and 5: the 124M LM (12 layers,
E=768, 12 heads, vocab 32000).

- engine: ``InferenceEngine`` over a ``Decoder`` with phase 4's settings
  (int8 weights, the fused decode step, paged reads, bf16, 32 slots,
  buckets 64/128/256, 8 steps a round). ``first_s`` serves one request a
  bucket from a fresh engine, so every prefill program and the decode
  program is built and captured inside it; ``again_s`` serves the same
  requests again, all replays. Their difference is the programs' build.
- trainer: ``ParallelTrainer`` on the same LM in bf16 at B=8, T=1024 with
  SGD and momentum; ``first_step_s`` builds and captures the step
  program, ``step_s`` is the second step.

Every time is taken after a ``torch.cuda.synchronize``. Weights are
seeded. Run from a checkout on a machine with the card::

    python mxnet_tpu_torch/testing/setup_time.py [--root DIR]

``--root`` imports ``mxnet_tpu_torch`` from the checkout at ``DIR``
instead (to hold two trees against each other on one card; its kernels
must be built there). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

VOCAB, LAYERS, EMBED, HEADS = 32000, 12, 768, 12
MAX_LEN, SLOTS, BUCKETS, STEPS_PER_ROUND = 1024, 32, (64, 128, 256), 8
TRAIN_B, TRAIN_T = 8, 1024


def _lm_params(symbol, seed):
    shapes = {"data": (1, MAX_LEN), "softmax_label": (1, MAX_LEN)}
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    return {n: rng.uniform(-0.05, 0.05, sh).astype(np.float32)
            for n, sh in zip(symbol.list_arguments(), arg_shapes)
            if n not in shapes}


def engine_setup(dev):
    import torch
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel.decode import Decoder
    from mxnet_tpu_torch.serving import InferenceEngine

    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS)
    params = _lm_params(symbol, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = Decoder(symbol, params, MAX_LEN, attn_impl="paged",
                  weight_dtype="int8", matmul_impl="fused",
                  compute_dtype="bfloat16", device=dev)
    engine = InferenceEngine(dec, slots=SLOTS, prefill_buckets=BUCKETS,
                             steps_per_round=STEPS_PER_ROUND,
                             prefix_cache_mb=0, prefill_chunk=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, VOCAB, (p,)) for p in BUCKETS]
    out = {"decoder_and_engine_s": build_s}
    for what in ("first_s", "again_s"):
        t0 = time.perf_counter()
        for p in prompts:
            engine.submit(p, max_tokens=4)
        while not engine.idle:
            engine.step()
        torch.cuda.synchronize()
        out[what] = time.perf_counter() - t0
    out["programs"] = len(engine._programs)
    engine.close()
    return out


def trainer_setup(dev):
    import torch
    from mxnet_tpu_torch.models import get_transformer_lm
    from mxnet_tpu_torch.parallel import ParallelTrainer

    symbol = get_transformer_lm(VOCAB, num_layers=LAYERS, embed_dim=EMBED,
                                num_heads=HEADS, impl="flash")
    trainer = ParallelTrainer(
        symbol, {"data": (TRAIN_B, TRAIN_T),
                 "softmax_label": (TRAIN_B, TRAIN_T)}, optimizer="sgd",
        optimizer_params={"learning_rate": 1e-3, "momentum": 0.9},
        compute_dtype="bfloat16", seed=0, device=dev).init_params()
    rs = np.random.RandomState(7)
    batch = {k: rs.randint(0, VOCAB, (TRAIN_B, TRAIN_T)).astype(np.int32)
             for k in ("data", "softmax_label")}
    out = {}
    for what in ("first_step_s", "step_s"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        out[what] = time.perf_counter() - t0
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="the checkout to import mxnet_tpu_torch from "
                         "(default: this script's)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root) if args.root else
                    os.path.dirname(os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__)))))
    import torch
    import mxnet_tpu_torch
    dev = torch.device("cuda:0")
    res = {"root": os.path.dirname(os.path.dirname(os.path.abspath(
        mxnet_tpu_torch.__file__))),
           "card": torch.cuda.get_device_name(0)}
    res["engine"] = engine_setup(dev)
    torch.cuda.empty_cache()
    res["trainer"] = trainer_setup(dev)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
