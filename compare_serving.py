#!/usr/bin/env python3
"""Phase 4's serving wave on this tree and on another tree, in turns, on
one CUDA card.

    python3 compare_serving.py --parent build/parent [--runs 4] [--waves 9]

``--parent`` is the root of another checkout (for example a parent commit
unpacked with ``git archive <commit> | tar -x -C build/parent``). Each run
is a process of its own, started in one tree's root, the trees taking
turns (parent, this, this, parent, ...): it loads ``chip_smoke.py``'s
124M checkpoint (written once, by this script, into this tree's
``build/smoke_ckpt/``), builds that tree's ``InferenceEngine`` as
``chip_smoke.py``'s phase 4 builds it — with the tree's own defaults, so
on a tree with the robustness and observability layer, telemetry on and a
256-request flight recorder — warms it with one request per bucket and
serves phase 4's 24 staggered greedy requests ``--waves`` times. It
prints one JSON line: each wave's tokens/s and ms per token p50/p99, and
a digest of the streams. This script prints every run, each tree's median
tokens/s over its waves, the ratio of this tree's median to the parent's,
and whether every run's streams are the same; it exits non-zero if they
are not. The kernels are built once, in this tree; a parent whose kernel
sources are the same gets copies of the libraries (their file names carry
a hash of the sources), any other builds its own.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SERVING_SOURCES = ("paged_attention", "quant_matmul", "fused_decode_attention")

# one run, executed with the tree's root as the working directory and the
# first entry of sys.path: it imports that tree's package and chip_smoke
CHILD = r"""
import hashlib, json, sys
import numpy as np, torch
import chip_smoke as cs
from mxnet_tpu_torch.serving import InferenceEngine

prefix, waves = sys.argv[1], int(sys.argv[2])
engine = InferenceEngine.from_checkpoint(
    prefix, 0, max_len=cs.MAX_LEN, slots=cs.SLOTS,
    prefill_buckets=cs.BUCKETS, steps_per_round=cs.STEPS_PER_ROUND,
    attn_impl="paged", weight_dtype="int8", matmul_impl="fused",
    compute_dtype="bfloat16", device=torch.device("cuda", 0),
    prefix_cache_mb=0, prefill_chunk=0)
# phase 4's work and warm-up, drawn as serve_main_path draws them
rs = np.random.RandomState(1)
work = [(rs.randint(0, cs.VOCAB, (int(rs.choice([24, 48, 96, 120, 200,
                                                 256])),)),
         int(rs.choice([32, 64]))) for _ in range(cs.N_REQUESTS)]
for p in cs.BUCKETS:
    engine.submit(rs.randint(0, cs.VOCAB, (p,)), max_tokens=4)
while not engine.idle:
    engine.step()
torch.cuda.synchronize()
out, digest = [], hashlib.sha256()
for _ in range(waves):
    handles, secs = cs._serve_wave(engine, work)
    out.append(cs._wave_metrics(handles, secs))
    digest.update(json.dumps([h.tokens for h in handles]).encode())
print(json.dumps({"tokens_per_s": [o[0] for o in out],
                  "p50_ms": [o[1] for o in out],
                  "p99_ms": [o[2] for o in out],
                  "streams": digest.hexdigest()[:16]}))
"""


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def checkpoint():
    """chip_smoke's 124M checkpoint (seed 0), written once."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch.models import get_transformer_lm
    prefix = os.path.join(HERE, "build", "smoke_ckpt", "lm124m")
    if not os.path.exists(prefix + "-0000.params"):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        symbol = get_transformer_lm(cs.VOCAB, num_layers=cs.LAYERS,
                                    embed_dim=cs.EMBED, num_heads=cs.HEADS)
        save_checkpoint(prefix, 0, symbol,
                        cs._lm_params(symbol, cs.MAX_LEN, 0), {})
    return prefix


def share_kernels(parent):
    """Build the serving kernels here; give the parent copies of the
    libraries whose names (source hashes) it would build too."""
    from mxnet_tpu_torch.ops import kernels as K
    K.build(SERVING_SOURCES)
    dst = os.path.join(parent, "build", "kernels")
    os.makedirs(dst, exist_ok=True)
    for lib in glob.glob(os.path.join(HERE, "build", "kernels", "*.so")):
        target = os.path.join(dst, os.path.basename(lib))
        if not os.path.exists(target):
            shutil.copy(lib, target)


def run(tree, prefix, waves):
    env = dict(os.environ, PYTHONPATH=tree)
    res = subprocess.run([sys.executable, "-c", CHILD, prefix, str(waves)],
                         cwd=tree, env=env, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit("run in %s failed:\n%s" % (tree,
                                                     res.stderr[-4000:]))
    return json.loads(res.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--runs", type=int, default=4,
                    help="processes, alternating parent and this tree in "
                         "the order parent, this, this, parent")
    ap.add_argument("--waves", type=int, default=9)
    args = ap.parse_args()
    parent = os.path.abspath(args.parent)
    prefix = checkpoint()
    share_kernels(parent)
    order = [(parent, HERE, HERE, parent)[i % 4] for i in range(args.runs)]
    tps = {parent: [], HERE: []}
    streams = set()
    for i, tree in enumerate(order):
        got = run(tree, prefix, args.waves)
        name = "parent" if tree == parent else "this tree"
        tps[tree] += got["tokens_per_s"]
        streams.add(got["streams"])
        print("run %d (%s): tokens/s per wave %s; ms per token p50 median "
              "%.3f, p99 median %.3f; streams %s" % (
                  i, name, " ".join("%.1f" % t for t in got["tokens_per_s"]),
                  statistics.median(got["p50_ms"]),
                  statistics.median(got["p99_ms"]), got["streams"]),
              flush=True)
    med = {t: statistics.median(v) for t, v in tps.items()}
    print("median tokens/s over %d waves each: parent %.1f (%.1f-%.1f), "
          "this tree %.1f (%.1f-%.1f); this tree / parent %.4f; streams %s; "
          "%s" % (
              len(tps[HERE]), med[parent], min(tps[parent]),
              max(tps[parent]), med[HERE], min(tps[HERE]), max(tps[HERE]),
              med[HERE] / med[parent],
              "the same in every run" if len(streams) == 1 else "DIFFER",
              card_line()), flush=True)
    return 0 if len(streams) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
