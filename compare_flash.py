#!/usr/bin/env python3
"""``flash_attention``'s CUDA entries against another version of their
source, in one process on one card.

    python3 compare_flash.py --parent DIR

DIR is a checkout of another commit (``git archive <commit> | tar -x -C
DIR``). Its ``mxnet_tpu_torch/ops/csrc/flash_attention.cu`` is built beside
this tree's, and the same inputs go through both in four cases (the 124M
LM's training shape, a windowed ragged T in bf16, non-causal f32, a
windowed head_dim 32 f32):

* the forward: o and lse of this build within ``chip_smoke.TOL`` of the
  other's in bf16 (the bf16 forward sums in another order, takes exp2
  and masks only boundary tiles), bitwise equal in f32 (the f32 kernels
  are unchanged);
* the backward: both builds' dQ and dK/dV entries are fed the same
  (q, k, v, o, lse, dO), the other build's o and lse. In bf16 dcap is
  held within ``chip_smoke.TOL`` of the other's and dQ, dK and dV within
  ``chip_smoke.GRAD_REL`` of the other's largest value (the rule that
  holds them against the plain version: the bf16 backward sums in
  another order and takes exp2); in f32 all four are bitwise equal.

Then the three entries are timed at the 124M shape in turns (other, this,
this, other) with ``chip_smoke.py``'s timer. Both builds' compiler reports
are printed first: each function that spills, with its registers and
spilled bytes. Exits non-zero if any check fails. Needs a CUDA card and
``nvcc``.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

CASES = [(8, 1024, 12, 64, True, 0, torch.bfloat16),
         (2, 1000, 3, 64, True, 33, torch.bfloat16),
         (2, 1000, 3, 64, False, 0, torch.float32),
         (2, 77, 2, 32, True, 5, torch.float32)]


def _load(K, path):
    lib = ctypes.CDLL(path)
    for e in K.ENTRIES["flash_attention"]:
        fn = getattr(lib, "mx_" + e)
        fn.restype = ctypes.c_int
        fn.argtypes = K._ARGTYPES[e]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout of the commit to compare against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device", flush=True)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log(cs.card_line())
    out = os.path.join(HERE, "build", "kernels", "other_flash_attention.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out[:-3] + ".log", "w") as log:
        subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v", "-o", out, os.path.join(
                            os.path.abspath(args.parent), "mxnet_tpu_torch",
                            "ops", "csrc", "flash_attention.cu")],
                       stdout=log, stderr=subprocess.STDOUT, check=True)
    K.build(("flash_attention",))
    for name, path in (("other", out[:-3] + ".log"),
                       ("this", K.build_log("flash_attention"))):
        cs.log(name + cs.ptxas_summary(K, "flash_attention",
                                       K.ptxas_report(path)))
    libs = {"other": _load(K, out),
            "this": _load(K, K._lib_path("flash_attention"))}
    gen = torch.Generator().manual_seed(0)
    P = K._ptr
    timer = cs.Timer(dev)
    failed = []
    for b, t, h, d, causal, window, dt in CASES:
        q, k, v, do = cs._flash_inputs(gen, b, t, h, d, dt, dev)
        cfg = K._flash_kernel_args("flash_attention", q, k, v)
        tail = (1.0 / d ** 0.5, int(causal), int(window), K._CODE[dt])
        st = torch.cuda.current_stream().cuda_stream
        tag = "B=%d T=%d H=%d D=%d causal=%s window=%d %s" % (
            b, t, h, d, causal, window, dt)
        fwd, bwd, calls = {}, {}, {}
        for name, lib in libs.items():
            o = torch.empty_like(q)
            lse = torch.empty((b * h, t), dtype=torch.float32, device=dev)
            calls[name] = {"fwd": lambda lib=lib, o=o, lse=lse:
                           lib.mx_flash_attention_fwd(
                               P(q), P(k), P(v), P(o), P(lse), *cfg, *tail,
                               st)}
            _run(name, "fwd", calls[name]["fwd"])
            fwd[name] = (o, lse)
        # the backward of both builds from the same (o, lse): the other's
        o, lse = fwd["other"]
        for name, lib in libs.items():
            dcap = torch.empty_like(lse)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            calls[name]["dq"] = lambda lib=lib, dcap=dcap, dq=dq: \
                lib.mx_flash_attention_dq(
                    P(q), P(k), P(v), P(o), P(do), P(lse), P(dcap), P(dq),
                    *cfg, *tail, st)
            calls[name]["dkv"] = lambda lib=lib, dcap=dcap, dk=dk, dv=dv: \
                lib.mx_flash_attention_dkv(
                    P(q), P(k), P(v), P(do), P(lse), P(dcap), P(dk), P(dv),
                    *cfg, *tail, st)
            _run(name, "dq", calls[name]["dq"])
            _run(name, "dkv", calls[name]["dkv"])
            bwd[name] = (dcap, dq, dk, dv)
        torch.cuda.synchronize()
        if dt is torch.float32:
            fwd_ok = all(torch.equal(x, y) for x, y in zip(fwd["other"],
                                                           fwd["this"]))
            how = "bitwise equal"
        else:
            atol, rtol = cs.TOL[torch.bfloat16]
            errs = [(x.float() - y.float()).abs()
                    for x, y in zip(fwd["this"], fwd["other"])]
            fwd_ok = all(bool((e <= atol + rtol * y.float().abs()).all())
                         for e, y in zip(errs, fwd["other"]))
            how = "within TOL[bf16] (atol %g, rtol %g), max |err| o %.3g " \
                "lse %.3g" % (atol, rtol, errs[0].max().item(),
                              errs[1].max().item())
        if dt is torch.float32:
            bwd_ok = all(torch.equal(x, y) for x, y in zip(bwd["other"],
                                                           bwd["this"]))
            bhow = "bitwise equal"
        else:
            bwd_ok, bhow = _bwd_close(cs, bwd["this"], bwd["other"])
        cs.log("flash %s: forward (o, lse) this vs other %s: %s; backward "
               "(dcap, dq, dk, dv) from the same (o, lse) %s: %s"
               % (tag, how, fwd_ok, bhow, bwd_ok))
        if not (fwd_ok and bwd_ok):
            failed.append(tag)
        if t == 1024:
            mean = {}
            for entry in ("fwd", "dq", "dkv"):
                ms = [timer(calls[n][entry])
                      for n in ("other", "this", "this", "other")]
                cs.log("time flash_attention_%-4s %s  other %.4f ms  this "
                       "%.4f ms  this %.4f ms  other %.4f ms"
                       % ((entry, tag) + tuple(ms)))
                mean[entry] = ((ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2)
            other, this = (mean["dq"][i] + mean["dkv"][i] for i in (0, 1))
            cs.log("backward dq + dkv %s: other %.4f ms, this %.4f ms, "
                   "%.2fx" % (tag, other, this, other / this))
    if failed:
        raise AssertionError("flash outputs disagree with the other "
                             "version's in %s" % failed)
    cs.log("compare_flash: all %d cases agree" % len(CASES))
    return 0


def _bwd_close(cs, this, other):
    """(ok, how): dcap within ``TOL[f32]``, dQ/dK/dV within ``GRAD_REL``
    of the other build's largest value."""
    atol, rtol = cs.TOL[torch.float32]
    err = (this[0] - other[0]).abs()
    ok = bool((err <= atol + rtol * other[0].abs()).all())
    rel = []
    for x, y in zip(this[1:], other[1:]):
        e = (x.float() - y.float()).abs().max().item()
        top = y.float().abs().max().item()
        rel.append(e / max(top, 1e-30))
        ok = ok and bool(torch.isfinite(x).all()) and \
            e <= cs.GRAD_REL * top
    return ok, ("dcap within TOL[f32] (max |err| %.3g), dq/dk/dv within "
                "GRAD_REL %.3g of max |other| (%s)" % (
                    err.max().item(), cs.GRAD_REL,
                    ", ".join("%.3g" % r for r in rel)))


def _run(name, entry, call):
    if call() != 0:
        raise RuntimeError("%s flash_attention_%s failed to launch"
                           % (name, entry))


if __name__ == "__main__":
    sys.exit(main())
