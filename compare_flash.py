#!/usr/bin/env python3
"""This tree's CUDA kernels against another version of their sources, in
one process on one card: ``flash_attention``'s and
``striped_pair_attention``'s entries, the GEMMs behind ``fused_linear``,
``fused_conv_bn_act`` and ``matmul_stats`` in bf16 and f32, the paged
reads (short chunks and prefill chunks) and the int8-weight decode
step.

    python3 compare_flash.py --parent DIR

DIR is a checkout of another commit (``git archive <commit> | tar -x -C
DIR``). Its ``flash_attention.cu``, ``striped_pair_attention.cu``,
``fused_linear.cu``, ``matmul_stats.cu`` and ``paged_attention.cu``
(under ``mxnet_tpu_torch/ops/csrc``) are built beside this tree's, all at
once, and the same inputs go through both builds, each entry with the
argument types its own tree's source declares. Each comparison is held
to the tolerance below and also says whether the two builds' outputs are
bitwise equal.

* flash, in five cases (the 124M LM's training shape, a windowed ragged T
  in bf16; non-causal f32, a windowed head_dim 32 f32, the LM's shape at
  B=1 in f32). The forward: o and lse of this build within
  ``chip_smoke.TOL`` of the other's (the bf16 forward may sum in another
  order, take exp2 and mask only boundary tiles; the f32 forward is the
  tiled one). The backward: both builds' dQ and dK/dV entries are fed the
  same (q, k, v, o, lse, dO), the other build's o and lse; dcap is held
  within ``chip_smoke.TOL[f32]`` of the other's and dQ, dK and dV within
  ``chip_smoke.GRAD_REL`` of the other's largest value (the bf16 backward
  rounds P and dS; the tiled f32 backward sums in another order than the
  first port's).
* the striped hop of the SP path ([24, 1024, 64], n=4, q_off=1, k_off=2)
  in f32 and bf16, held as the flash cases.
* the bf16 GEMM: ``fused_linear`` at the 124M LM's four products (M =
  8192 tokens: qkv N=2304, proj, ffn1 N=3072 with relu, ffn2 K=3072) and
  at a ragged M=100 K=70 N=130 (the guarded loads); ``fused_conv_bn_act``'s
  GEMM at ResNet-50's stage-1 3x3 conv (M=802816 patches of K=576, N=64,
  the folded BatchNorm and relu); ``matmul_stats`` at stage 1's first 1x1
  conv (M=802816, K=256, N=64). Outputs within ``chip_smoke.TOL`` of the
  other's in bf16, column sums within ``chip_smoke.STAT_REL`` of their
  sums of magnitudes. The conv entry is called in the form each tree's
  source declares: the conv's geometry, or the geometry and a workspace.
* the f32 GEMM: ``fused_linear`` at the SP path's ffn1 (M=2048 K=768
  N=3072, relu and bias), ``matmul_stats`` at stage 1's first 1x1 conv,
  ``fused_conv_bn_act`` at the stride-1 3x3 convs of stages 1-4 (Winograd
  in a tree whose conv entry takes a workspace, else the implicit GEMM),
  the stem and stage 2's 1x1 stride-2 projection at B=256, each with the
  host-side work its tree's wrapper does (the channels-last copy, weight
  permutation and Winograd workspace). Outputs
  within ``chip_smoke.TOL[f32]``, column sums within
  ``chip_smoke.STAT_REL``.
* the paged read at C < 16 (S=32 slots, 12 heads of 64, L=1024, random
  pos): this tree's ``paged_attention_decode`` against the other's entry
  for the same call, ``paged_attention_decode`` if it has one, else the
  scalar ``paged_attention``; bf16 and int8 caches at C=1, bf16 at C=4.
  Outputs within ``chip_smoke.TOL`` of the other's.
* the prefill chunk (12 heads of 64, L=1024): this tree's bf16
  ``paged_attention_chunk`` against the other's at C = 64, 128, 256 (one
  slot, pos 0) and C = 100 over three slots with GQA 12->4; this tree's
  int8 chunk against the other's entry for the same call (the scalar
  ``paged_attention`` in a tree before the int8 chunk) at C = 64, 128,
  256. Outputs within ``chip_smoke.TOL`` of the other's.
* the int8-weight decode step: ``quant_matmul`` at the 124M LM's five
  products at M=32 (a decode step) and M=256 (a prefill), bf16 x and out,
  and ``fused_decode_attention`` at S=32, 12 heads of 64, L=1024, random
  pos, int8, bf16, each entry called in the form its tree's
  source declares (``_qmm_form``: with or without the arrival counts;
  the old fused entry's per-slot partials, counts and shared-memory size;
  an older fused entry's lack of a dtype for k_new and v_new).
  Outputs within ``chip_smoke.TOL`` of the other's.

Each shape of the 124M LM, of the SP hop and of ResNet-50 is then timed in
turns (other, this, this, other) with ``chip_smoke.py``'s timer. Both
builds' compiler reports are printed first: each function that spills,
with its registers and spilled bytes. Exits non-zero if any check fails.
Needs a CUDA card and ``nvcc``.
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
         (2, 77, 2, 32, True, 5, torch.float32),
         (1, 1024, 12, 64, True, 0, torch.float32)]


# the sources built from both trees
SOURCES = ("flash_attention", "striped_pair_attention", "fused_linear",
           "matmul_stats", "paged_attention", "quant_matmul",
           "fused_decode_attention")

_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


def _argtypes(tree, source, entry):
    """``mx_<entry>``'s argument types as the tree's ``<source>.cu``
    declares them (pointers as ``c_void_p``), or None if it has no such
    entry."""
    with open(os.path.join(tree, "mxnet_tpu_torch", "ops", "csrc",
                           source + ".cu")) as f:
        src = f.read()
    at = src.find("mx_%s(" % entry)
    if at < 0:
        return None
    sig = src[at:]
    types = []
    for p in sig[sig.index("(") + 1:sig.index(")")].split(","):
        words = p.replace("const ", "").replace("*", " * ").split()[:-1]
        types.append(ctypes.c_void_p if "*" in words
                     else _CTYPES[" ".join(words)])
    return types


def _qmm_form(tree):
    """"counts" if the tree's mx_quant_matmul takes the arrival counts (and
    its fused entry the new workspaces), else "finish"."""
    with open(os.path.join(tree, "mxnet_tpu_torch", "ops", "csrc",
                           "quant_matmul.cu")) as f:
        src = f.read()
    sig = src[src.index("mx_quant_matmul("):]
    return "counts" if "void* count" in sig[:sig.index(")")] else "finish"


def _conv_form(tree):
    """"workspace" if the tree's mx_fused_conv_bn_act takes the conv's
    geometry and a workspace (the Winograd path's), "geometry" if it takes
    the geometry alone (x channels-last). A tree whose entry still takes
    the patches is compared from its own compare_flash.py."""
    with open(os.path.join(tree, "mxnet_tpu_torch", "ops", "csrc",
                           "fused_linear.cu")) as f:
        src = f.read()
    sig = src[src.index("mx_fused_conv_bn_act("):]
    sig = sig[:sig.index(")")]
    if "int OH" not in sig:
        raise SystemExit("%s: its conv entry takes the patches; compare it "
                         "with that tree's own compare_flash.py" % tree)
    return "workspace" if "void* ws" in sig else "geometry"


def _load(K, name, path, tree):
    """Source ``name``'s library at ``path``, each entry with the argument
    types ``tree``'s source declares (:func:`_argtypes`); an entry the
    library lacks is left out."""
    lib = ctypes.CDLL(path)
    for e in K.ENTRIES[name]:
        fn = getattr(lib, "mx_" + e, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = _argtypes(tree, name, e)
    return lib


def _build_other(K, parent):
    """Compile the other tree's SOURCES into build/kernels/other_*.so, one
    nvcc per source, all at once; returns {source: library path}."""
    procs = {}
    for name in SOURCES:
        out = os.path.join(HERE, "build", "kernels", "other_%s.so" % name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        log = open(out[:-3] + ".log", "w")
        procs[name] = (subprocess.Popen(
            [K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", out, os.path.join(
                 os.path.abspath(parent), "mxnet_tpu_torch", "ops", "csrc",
                 name + ".cu")], stdout=log, stderr=subprocess.STDOUT),
            log, out)
    for name, (proc, log, out) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError("nvcc failed for the other %s.cu (log %s)"
                               % (name, out[:-3] + ".log"))
    return {name: out for name, (_, _, out) in procs.items()}


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
    K.build(SOURCES)
    other = _build_other(K, args.parent)
    libs = {"other": {}, "this": {}}
    forms = {"other": _conv_form(args.parent), "this": _conv_form(HERE)}
    qforms = {"other": _qmm_form(args.parent), "this": _qmm_form(HERE)}
    for name in SOURCES:
        for who, path in (("other", other[name][:-3] + ".log"),
                          ("this", K.build_log(name))):
            cs.log(who + cs.ptxas_summary(K, name, K.ptxas_report(path)))
        libs["other"][name] = _load(K, name, other[name], args.parent)
        libs["this"][name] = _load(K, name, K._lib_path(name), HERE)
    timer = cs.Timer(dev)
    failed = _compare_flash(cs, K, libs, dev, timer)
    failed += _compare_striped(cs, K, libs, dev, timer)
    failed += _compare_gemm(cs, K, libs, forms, dev, timer)
    failed += _compare_f32_gemm(cs, K, libs, forms, dev, timer)
    failed += _compare_decode(cs, K, libs, dev, timer)
    failed += _compare_chunk(cs, K, libs, dev, timer)
    failed += _compare_quant(cs, K, libs, qforms["other"], dev, timer)
    if failed:
        raise AssertionError("outputs disagree with the other version's in "
                             "%s" % failed)
    cs.log("compare_flash: every case agrees")
    return 0


def _agree(cs, this, other):
    """(ok, how): each tensor of ``this`` within ``cs.TOL`` of ``other``'s,
    and whether all are bitwise equal."""
    oks, errs = zip(*(_close(cs, x, y) for x, y in zip(this, other)))
    same = all(torch.equal(x, y) for x, y in zip(this, other))
    return all(oks), "within TOL (max |err| %s; bitwise equal: %s)" % (
        ", ".join("%.3g" % e for e in errs), same)


def _compare_flash(cs, K, libs, dev, timer):
    """The flash cases; returns the tags of those that disagree."""
    libs = {who: ls["flash_attention"] for who, ls in libs.items()}
    gen = torch.Generator().manual_seed(0)
    P = K._ptr
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
            _run(name, "flash_attention_fwd", calls[name]["fwd"])
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
            _run(name, "flash_attention_dq", calls[name]["dq"])
            _run(name, "flash_attention_dkv", calls[name]["dkv"])
            bwd[name] = (dcap, dq, dk, dv)
        torch.cuda.synchronize()
        # forwards and backwards may sum in other orders: within TOL, and
        # the backward fed the same (o, lse) within _bwd_close
        fwd_ok, how = _agree(cs, fwd["this"], fwd["other"])
        same = all(torch.equal(x, y) for x, y in zip(bwd["other"],
                                                     bwd["this"]))
        bwd_ok, bhow = _bwd_close(cs, bwd["this"], bwd["other"])
        bhow += "; bitwise equal: %s" % same
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
    return failed


# (BH, C, D, n, q_off, k_off, dtype): the SP path's hop
SPAIR_CASES = [(24, 1024, 64, 4, 1, 2, torch.float32),
               (24, 1024, 64, 4, 1, 2, torch.bfloat16)]


def _compare_striped(cs, K, libs, dev, timer):
    """The striped hop, as the flash cases: the forward (o, lse) of this
    build within ``cs.TOL`` of the other's, then both builds' dQ and dK/dV
    entries fed the other's (o, lse) within ``_bwd_close``; each entry
    timed in turns. Returns the tags that disagree."""
    libs = {who: ls["striped_pair_attention"] for who, ls in libs.items()}
    gen = torch.Generator().manual_seed(4)
    P = K._ptr
    st = torch.cuda.current_stream().cuda_stream
    failed = []
    for bh, c, d, n, qo, ko, dt in SPAIR_CASES:
        q, k, v, go = (cs._rand(gen, (bh, c, d), dt).to(dev)
                       for _ in range(4))
        gl = cs._rand(gen, (bh, c, 1)).to(dev)
        cfg = (bh, c, c, d, 1.0 / d ** 0.5, n, qo, ko, K._CODE[dt], st)
        tag = "BH=%d C=%d D=%d n=%d q_off=%d k_off=%d %s" % (
            bh, c, d, n, qo, ko, dt)
        fwd, bwd, calls = {}, {}, {}
        for who, lib in libs.items():
            o = torch.empty_like(q)
            lse = torch.empty((bh, c, 1), device=dev)
            calls[who] = {"fwd": lambda lib=lib, o=o, lse=lse:
                          lib.mx_striped_pair_fwd(P(q), P(k), P(v), P(o),
                                                  P(lse), *cfg)}
            _run(who, "striped_pair_fwd", calls[who]["fwd"])
            fwd[who] = (o, lse)
        o, lse = fwd["other"]
        for who, lib in libs.items():
            dcap = torch.empty_like(lse)
            dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
            calls[who]["dq"] = lambda lib=lib, dcap=dcap, dq=dq: \
                lib.mx_striped_pair_dq(P(q), P(k), P(v), P(o), P(go),
                                       P(lse), P(gl), P(dcap), P(dq), *cfg)
            calls[who]["dkv"] = lambda lib=lib, dcap=dcap, dk=dk, dv=dv: \
                lib.mx_striped_pair_dkv(P(q), P(k), P(v), P(go), P(lse),
                                        P(dcap), P(dk), P(dv), *cfg)
            _run(who, "striped_pair_dq", calls[who]["dq"])
            _run(who, "striped_pair_dkv", calls[who]["dkv"])
            bwd[who] = (dcap, dq, dk, dv)
        torch.cuda.synchronize()
        fwd_ok, how = _agree(cs, fwd["this"], fwd["other"])
        same = all(torch.equal(x, y) for x, y in zip(bwd["this"],
                                                     bwd["other"]))
        bwd_ok, bhow = _bwd_close(cs, bwd["this"], bwd["other"])
        bhow += "; bitwise equal: %s" % same
        cs.log("striped %s: forward (o, lse) this vs other %s: %s; backward "
               "(dcap, dq, dk, dv) from the same (o, lse) %s: %s"
               % (tag, how, fwd_ok, bhow, bwd_ok))
        if not (fwd_ok and bwd_ok):
            failed.append("striped " + tag)
        for entry in ("fwd", "dq", "dkv"):
            ms = [timer(calls[w_][entry])
                  for w_ in ("other", "this", "this", "other")]
            cs.log("time striped_pair_%-4s %s  other %.4f ms  this %.4f ms  "
                   "this %.4f ms  other %.4f ms  (%.2fx)" % (
                       (entry, tag) + tuple(ms)
                       + ((ms[0] + ms[3]) / (ms[1] + ms[2]),)))
    return failed


# (what, entry, M, K, N, act): the 124M LM's products at B=8, T=1024, a
# ragged shape, ResNet-50's stage-1 3x3 conv GEMM and first 1x1 conv
GEMM_CASES = [("qkv", "fused_linear", 8192, 768, 2304, 0),
              ("proj", "fused_linear", 8192, 768, 768, 0),
              ("ffn1", "fused_linear", 8192, 768, 3072, 1),
              ("ffn2", "fused_linear", 8192, 3072, 768, 0),
              ("ragged", "fused_linear", 100, 70, 130, 1),
              ("stage-1 3x3 conv", "fused_conv_bn_act", 802816, 576, 64, 1),
              ("stage-1 _a", "matmul_stats", 802816, 256, 64, 0)]


def _close(cs, got, want):
    """(ok, max |err|): ``got`` within ``cs.TOL`` of ``want``'s dtype."""
    atol, rtol = cs.TOL[want.dtype]
    err = (got.float() - want.float()).abs()
    return (bool(torch.isfinite(got).all())
            and bool((err <= atol + rtol * want.float().abs()).all()),
            err.max().item())


def _conv_gemm_call(fn, form, x, w, scale, bias, y, m, n, kd, act, dtype,
                    st):
    """mx_fused_conv_bn_act over patches x [m, kd] in either form, as the x
    of a 1x1 stride-1 conv over [1, 1, m, kd] (the workspace form with no
    workspace)."""
    P = torch.Tensor.data_ptr
    head = (P(x), P(w), P(scale), P(bias), P(y))
    if form == "workspace":
        head += (None, 0)
    return fn(*head, 1, 1, m, kd, 1, m, n, 1, 1, 1, 1, 0, 0, 1, 1, act,
              dtype, st)


def _compare_gemm(cs, K, libs, forms, dev, timer):
    """The bf16 GEMM cases; returns the tags of those that disagree."""
    P = K._ptr
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    st = torch.cuda.current_stream().cuda_stream
    failed = []
    for what, entry, m, kd, n, act in GEMM_CASES:
        x = cs._rand(gen, (m, kd), bf)
        w = cs._rand(gen, (n, kd), bf, 1.0 / kd ** 0.5)
        bias = cs._rand(gen, (n,), scale=0.1)
        scale = torch.rand((n,), generator=gen, device=dev) + 0.5 \
            if entry == "fused_conv_bn_act" else None
        outs, calls = {}, {}
        for who in ("other", "this"):
            lib = libs[who]["matmul_stats" if entry == "matmul_stats"
                            else "fused_linear"]
            y = torch.empty((m, n), dtype=bf, device=dev)
            if entry == "matmul_stats":
                tiles = -(-m // 128)
                s1 = torch.empty((tiles, n), device=dev)
                s2 = torch.empty((tiles, n), device=dev)
                calls[who] = lambda lib=lib, y=y, s1=s1, s2=s2: \
                    lib.mx_matmul_stats(P(x), P(w), P(y), P(s1), P(s2), m,
                                        n, kd, 1, st)
                outs[who] = (y, s1, s2)
            elif entry == "fused_conv_bn_act":
                fn = lib.mx_fused_conv_bn_act
                calls[who] = lambda fn=fn, y=y, form=forms[who]: \
                    _conv_gemm_call(fn, form, x, w, scale, bias, y, m, n,
                                    kd, act, 1, st)
                outs[who] = (y,)
            else:
                fn = getattr(lib, "mx_" + entry)
                calls[who] = lambda fn=fn, y=y: fn(
                    P(x), P(w), P(scale), P(bias), P(y), m, n, kd, act, 1,
                    st)
                outs[who] = (y,)
            _run(who, entry, calls[who])
        torch.cuda.synchronize()
        ok, err = _close(cs, outs["this"][0], outs["other"][0])
        how = "y within TOL[bf16] (max |err| %.3g; bitwise equal: %s)" % (
            err, all(torch.equal(a, b) for a, b in zip(outs["this"],
                                                       outs["other"])))
        if entry == "matmul_stats":
            mag = (x.float() @ w.float().t()).abs().sum(dim=0)
            for i, ref in ((1, mag), (2, outs["other"][2].sum(dim=0))):
                rel = ((outs["this"][i].sum(dim=0)
                        - outs["other"][i].sum(dim=0)).abs()
                       / ref.clamp_min(1e-30)).max().item()
                ok = ok and rel <= cs.STAT_REL
                how += ", s%d within %.3g of its sum of magnitudes" % (i, rel)
        tag = "%s %s M=%d K=%d N=%d" % (entry, what, m, kd, n)
        cs.log("gemm %s: this vs other %s: %s" % (tag, how, ok))
        if not ok:
            failed.append(tag)
        if what != "ragged":
            ms = [timer(calls[who]) for who in ("other", "this", "this",
                                                 "other")]
            cs.log("time %-48s other %.4f ms  this %.4f ms  this %.4f ms  "
                   "other %.4f ms  (%.2fx)" % (
                       tag, *ms, (ms[0] + ms[3]) / (ms[1] + ms[2])))
        del x, w, outs, calls
    return failed


# (what, x shape, w shape, stride, pad, act, channels-last x): the f32
# conv entry at ResNet-50's stride-1 3x3 convs of stages 1-4, its stem and
# stage 2's 1x1 stride-2 projection, at B=256
F32_CONVS = [("stage-1 3x3", (256, 64, 56, 56), (64, 64, 3, 3), 1, 1, 1,
              True),
             ("stage-2 3x3", (256, 128, 28, 28), (128, 128, 3, 3), 1, 1, 1,
              True),
             ("stage-3 3x3", (256, 256, 14, 14), (256, 256, 3, 3), 1, 1, 1,
              True),
             ("stage-4 3x3", (256, 512, 7, 7), (512, 512, 3, 3), 1, 1, 1,
              True),
             ("stem 7x7/2", (256, 3, 224, 224), (64, 3, 7, 7), 2, 3, 1,
              False),
             ("stage-2 1x1/2 projection", (256, 256, 56, 56),
              (512, 256, 1, 1), 2, 0, 0, True)]


def _compare_f32_gemm(cs, K, libs, forms, dev, timer):
    """The f32 GEMM entries: fused_linear at the SP path's ffn1, matmul_stats
    at stage 1's first 1x1 conv and fused_conv_bn_act at F32_CONVS, this
    build's outputs within ``cs.TOL[f32]`` of the other's (column sums
    within ``cs.STAT_REL``), each timed in turns with its wrapper's
    channels-last copy of an NCHW x and weight permutation
    (``K._conv_operands``) and, in the workspace form, the Winograd
    workspace. Returns the tags that disagree."""
    P = K._ptr
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(5)
    st = torch.cuda.current_stream().cuda_stream
    failed = []

    def report(tag, ok, how, calls):
        cs.log("f32 %s: this vs other %s: %s" % (tag, how, ok))
        if not ok:
            failed.append(tag)
        ms = [timer(calls[who]) for who in ("other", "this", "this",
                                             "other")]
        cs.log("time %-48s other %.4f ms  this %.4f ms  this %.4f ms  "
               "other %.4f ms  (%.2fx)" % (
                   tag, *ms, (ms[0] + ms[3]) / (ms[1] + ms[2])))

    m, kd, n = 2048, 768, 3072
    x = cs._rand(gen, (m, kd))
    w = cs._rand(gen, (n, kd), f32, 1.0 / kd ** 0.5)
    bias = cs._rand(gen, (n,), scale=0.1)
    outs, calls = {}, {}
    for who in ("other", "this"):
        y = torch.empty((m, n), device=dev)
        calls[who] = lambda lib=libs[who]["fused_linear"], y=y: \
            lib.mx_fused_linear(P(x), P(w), None, P(bias), P(y), m, n, kd,
                                1, 0, st)
        _run(who, "fused_linear", calls[who])
        outs[who] = y
    torch.cuda.synchronize()
    ok, err = _close(cs, outs["this"], outs["other"])
    report("fused_linear SP ffn1 M=%d K=%d N=%d f32 relu" % (m, kd, n), ok,
           "within TOL[f32] (max |err| %.3g)" % err, calls)

    m, kd, n = 802816, 256, 64
    x = cs._rand(gen, (m, kd))
    w = cs._rand(gen, (n, kd), f32, 1.0 / kd ** 0.5)
    outs, calls = {}, {}
    for who in ("other", "this"):
        y = torch.empty((m, n), device=dev)
        # the partials of 64- or 128-row tiles, unwritten rows left 0
        s1, s2 = torch.zeros((2, -(-m // 64), n), device=dev)
        calls[who] = lambda lib=libs[who]["matmul_stats"], y=y, s1=s1, \
            s2=s2: lib.mx_matmul_stats(P(x), P(w), P(y), P(s1), P(s2), m, n,
                                       kd, 0, st)
        _run(who, "matmul_stats", calls[who])
        outs[who] = (y, s1.sum(dim=0), s2.sum(dim=0))
    torch.cuda.synchronize()
    ok, err = _close(cs, outs["this"][0], outs["other"][0])
    how = "y within TOL[f32] (max |err| %.3g)" % err
    mag = (x @ w.t()).abs().sum(dim=0)
    for i, ref in ((1, mag), (2, outs["other"][2])):
        rel = ((outs["this"][i] - outs["other"][i]).abs()
               / ref.clamp_min(1e-30)).max().item()
        ok = ok and rel <= cs.STAT_REL
        how += ", s%d within %.3g of its sum of magnitudes" % (i, rel)
    report("matmul_stats stage-1 _a M=%d K=%d N=%d f32" % (m, kd, n), ok,
           how, calls)
    del x, w, outs, calls, mag

    for what, xs, wsh, s_, p_, act, cl in F32_CONVS:
        x, w, scale, bias = cs._conv_inputs(gen, xs, wsh, f32, dev)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        stride, pad = (s_, s_), (p_, p_)
        oh, ow = K._conv_out_hw(xs[2], xs[3], wsh[2], wsh[3], stride, pad,
                                (1, 1))
        mm = xs[0] * oh * ow
        outs, calls = {}, {}
        for who in ("other", "this"):
            fn = libs[who]["fused_linear"].mx_fused_conv_bn_act
            y = torch.empty((mm, wsh[0]), device=dev)

            def call(fn=fn, y=y, form=forms[who]):
                xc, wm, geom = K._conv_operands(x, w, stride, pad, (1, 1))
                tail = ()
                if form == "workspace":
                    ws = None  # the wrapper's workspace, kept alive
                    if K.conv_algo(f32, xs[1], wsh[2:], stride, pad,
                                   (1, 1)) == "winograd":
                        ws = K._winograd_workspace(xs[1], wsh[0], dev)
                    tail = (P(ws), 0 if ws is None else ws.numel())
                return fn(P(xc), P(wm), P(scale), P(bias), P(y), *tail,
                          *geom, act, 0, st)
            calls[who] = call
            _run(who, "fused_conv_bn_act", call)
            outs[who] = y
        torch.cuda.synchronize()
        ok, err = _close(cs, outs["this"], outs["other"])
        report("fused_conv_bn_act %s x=%s%s f32" % (
            what, "x".join(map(str, xs)), " channels-last" if cl else ""),
            ok, "within TOL[f32] (max |err| %.3g)" % err, calls)
        del x, w, scale, bias, outs, calls
    return failed


def _compare_decode(cs, K, libs, dev, timer):
    """This tree's decode entry against the other's entry for the same
    short chunk; returns the tags of those that disagree."""
    P = K._ptr
    gen = torch.Generator().manual_seed(3)
    st = torch.cuda.current_stream().cuda_stream
    l_, h, d = 1024, 12, 64
    ns = K.paged_decode_splits(l_, d, K._sm_count(dev))
    failed = []
    for s_, c, kind in ((32, 1, "bf16"), (32, 1, "int8"), (32, 4, "bf16")):
        pos = torch.randint(0, l_ - c + 1, (s_,), generator=gen,
                            dtype=torch.int32).to(dev)
        q = cs._rand(gen, (s_, c, h, d), torch.bfloat16).to(dev)
        k, v, ks, vs = cs._cache(gen, s_, l_, h, d, kind, dev)
        head = (P(q), P(k), P(v), P(ks), P(vs), P(pos))
        tail = (1.0 / d ** 0.5, K._CODE[q.dtype], K._CODE[k.dtype], st)
        outs, calls = {}, {}
        for who in ("other", "this"):
            lib = libs[who]["paged_attention"]
            out = torch.empty_like(q)
            if hasattr(lib, "mx_paged_attention_decode"):
                ws = torch.empty((s_, h, ns, c, d + 2), device=dev)
                calls[who] = lambda lib=lib, out=out, ws=ws: \
                    lib.mx_paged_attention_decode(
                        *head, P(out), P(ws), s_, c, h, h, l_, d, ns, *tail)
            else:
                calls[who] = lambda lib=lib, out=out: \
                    lib.mx_paged_attention(*head, P(out), s_, c, h, h, l_,
                                           d, *tail)
            _run(who, "paged read", calls[who])
            outs[who] = out
        torch.cuda.synchronize()
        ok, how = _agree(cs, (outs["this"],), (outs["other"],))
        tag = "S=%d C=%d H=12 L=1024 %s KV" % (s_, c, kind)
        cs.log("paged read %s: this (decode entry) vs other %s: %s"
               % (tag, how, ok))
        if not ok:
            failed.append(tag)
        ms = [timer(calls[who]) for who in ("other", "this", "this",
                                             "other")]
        cs.log("time paged read %-30s other %.4f ms  this %.4f ms  this "
               "%.4f ms  other %.4f ms  (%.2fx)" % (
                   tag, *ms, (ms[0] + ms[3]) / (ms[1] + ms[2])))
    return failed


def _chunk_call(K, lib, q, k, v, ks, vs, pos, out, shape, st):
    """mx_paged_attention_chunk of ``lib`` in the form its source
    declares: with the row scales and the cache's dtype code, or, in a
    tree from before the int8 chunk, the bf16 form."""
    P = K._ptr
    fn = lib.mx_paged_attention_chunk
    if len(fn.argtypes) == len(K._ARGTYPES["paged_attention_chunk"]):
        return fn(P(q), P(k), P(v), P(ks), P(vs), P(pos), P(out), *shape,
                  K._CODE[k.dtype], st)
    return fn(P(q), P(k), P(v), P(pos), P(out), *shape, st)


def _compare_chunk(cs, K, libs, dev, timer):
    """The prefill chunk: this tree's bf16 chunk against the other's (C =
    64, 128, 256 at pos 0, one slot; C = 100 over three slots at pos 0,
    300, 924 with GQA 12->4), and this tree's int8 chunk against the
    other's entry for the same call (the scalar ``paged_attention`` in a
    tree before the int8 chunk) at C = 64, 128, 256, pos 0: outputs within
    ``cs.TOL`` of the other's, each timed in turns. Returns the tags that
    disagree."""
    P = K._ptr
    gen = torch.Generator().manual_seed(6)
    st = torch.cuda.current_stream().cuda_stream
    l_, h, d = 1024, 12, 64
    failed = []
    cases = [(1, c, 12, [0], "bf16") for c in (64, 128, 256)] \
        + [(3, 100, 4, [0, 300, 924], "bf16")] \
        + [(1, c, 12, [0], "int8") for c in (64, 128, 256)]
    for s_, c, kv, pos, kind in cases:
        pos = torch.tensor(pos, dtype=torch.int32, device=dev)
        q = cs._rand(gen, (s_, c, h, d), torch.bfloat16).to(dev)
        k, v, ks, vs = cs._cache(gen, s_, l_, kv, d, kind, dev)
        shape = (s_, c, h, kv, l_, d, 1.0 / d ** 0.5)
        outs, calls = {}, {}
        for who in ("other", "this"):
            lib = libs[who]["paged_attention"]
            out = torch.empty_like(q)
            if who == "other" and kind == "int8" and len(
                    lib.mx_paged_attention_chunk.argtypes) != len(
                        K._ARGTYPES["paged_attention_chunk"]):
                calls[who] = lambda lib=lib, out=out: \
                    lib.mx_paged_attention(
                        P(q), P(k), P(v), P(ks), P(vs), P(pos), P(out),
                        *shape, K._CODE[q.dtype], K._CODE[k.dtype], st)
            else:
                calls[who] = lambda lib=lib, out=out: _chunk_call(
                    K, lib, q, k, v, ks, vs, pos, out, shape, st)
            _run(who, "paged chunk", calls[who])
            outs[who] = out
        torch.cuda.synchronize()
        ok, how = _agree(cs, (outs["this"],), (outs["other"],))
        tag = "S=%d C=%d H=12 KV=%d L=1024 pos=%s %s KV" % (
            s_, c, kv, pos.tolist(), kind)
        cs.log("paged chunk %s: this (chunk entry) vs other %s: %s"
               % (tag, how, ok))
        if not ok:
            failed.append(tag)
        ms = [timer(calls[who]) for who in ("other", "this", "this",
                                             "other")]
        cs.log("time paged chunk %-40s other %.4f ms  this %.4f ms  this "
               "%.4f ms  other %.4f ms  (%.2fx)" % (
                   tag, *ms, (ms[0] + ms[3]) / (ms[1] + ms[2])))
    return failed


def _old_qmm_splits(f, e, sms):
    """The contraction splits of the finishing-kernel quant_matmul (PR 1-9):
    32-wide steps, two blocks an SM over 64-channel tiles."""
    n_f, n_k = -(-f // 64), -(-e // 32)
    want = min(n_k, max(1, -(-2 * sms // n_f)))
    steps = -(-n_k // want)
    return -(-n_k // steps)


def _compare_quant(cs, K, libs, form, dev, timer):
    """quant_matmul at the 124M LM's products (M=32 and M=256) and
    fused_decode_attention at S=32 L=1024, this tree (the wrappers)
    against the other's entries called in ``form``; returns the tags that
    disagree."""
    P = K._ptr
    gen = torch.Generator().manual_seed(4)
    st = torch.cuda.current_stream().cuda_stream
    sms = K._sm_count(dev)
    failed = []

    def report(tag, this, other, calls):
        ok, how = _agree(cs, this, other)
        cs.log("%s: this vs other %s: %s" % (tag, how, ok))
        if not ok:
            failed.append(tag)
        ms = [timer(calls[who]) for who in ("other", "this", "this",
                                             "other")]
        cs.log("time %-44s other %.4f ms  this %.4f ms  this %.4f ms  "
               "other %.4f ms  (%.2fx)" % (
                   tag, *ms, (ms[0] + ms[3]) / (ms[1] + ms[2])))

    for m, (f, e), what in [(m, fe, w) for m in (32, 256) for fe, w in zip(
            cs.QMM_SHAPES, ("qkv", "proj", "ffn1", "ffn2", "lm_head"))]:
        x = cs._rand(gen, (m, e), torch.bfloat16).to(dev)
        q, s = cs._weights(gen, f, e, 8, None, dev)
        lib = libs["other"]["quant_matmul"]
        out = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
        if form == "finish":
            ks = _old_qmm_splits(f, e, sms)
            part = torch.empty((ks, m, f), device=dev)
            other = lambda: lib.mx_quant_matmul(
                P(x), P(q), P(s), P(out), P(part), m, e, f, 8, 0, ks, 1, 1,
                st)
        else:
            ks = K.quant_matmul_splits(f, e, sms)
            part, cnt = K._split_workspace(m, f, ks, dev)
            other = lambda: lib.mx_quant_matmul(
                P(x), P(q), P(s), P(out), P(part), P(cnt), m, e, f, 8, 0,
                ks, 1, 1, st)
        _run("other", "quant_matmul", other)
        mine = K.quant_matmul(x, q, s)
        torch.cuda.synchronize()
        report("quant_matmul %s M=%d F=%d E=%d int8" % (what, m, f, e),
               (mine,), (out,), {"other": other,
                                 "this": lambda: K.quant_matmul(x, q, s)})
        del x, q, s, out, part

    s_, h, d, l_ = 32, 12, 64, 1024
    args = cs._fused_inputs(gen, s_, h, h, d, l_, 8, None, torch.bfloat16,
                            torch.bfloat16, dev, None)
    x, pos, kc, vc, wq, sq, bq, wo, so, bo = args
    e = h * d
    cos, sin = K._rope_tables(pos, d // 2, False, 10000.0)
    out = torch.empty_like(x)
    kn = torch.empty((s_, h, d), dtype=torch.bfloat16, device=dev)
    vn = torch.empty_like(kn)
    lib = libs["other"]["fused_decode_attention"]
    head = (P(x), P(pos), P(kc), P(vc), P(wq), P(sq), P(bq), P(wo), P(so),
            P(bo), P(cos), P(sin), P(out), P(kn), P(vn))
    if form == "finish":
        part = torch.empty((s_, h, e), device=dev)
        cnt = torch.empty((s_,), dtype=torch.int32, device=dev)
        smem = 4 * (e + (2 + 2 + 8) * d + (l_ + 1))
        other = lambda: lib.mx_fused_decode_attention(
            *head, P(part), P(cnt), s_, e, h, h, d, l_, 8, 0, smem,
            1.0 / d ** 0.5, 1, 1, st)
    else:
        fn = lib.mx_fused_decode_attention
        # a tree whose entry takes no dtype for k_new and v_new: the
        # wrapper's last argument before the stream is dropped
        call = fn if len(fn.argtypes) == len(
            K._ARGTYPES["fused_decode_attention"]) \
            else (lambda *a: fn(*a[:-2], a[-1]))

        def other():
            kw = dict(heads=h, kv_heads=h, bits=8, rope=False)
            saved = K._lib
            K._lib = lambda entry: call
            try:
                o, k_, v_ = K.fused_decode_attention(*args, **kw)
            finally:
                K._lib = saved
            out.copy_(o)
            kn.copy_(k_)
            vn.copy_(v_)
            return 0
    _run("other", "fused_decode_attention", other)
    kw = dict(heads=h, kv_heads=h, bits=8, rope=False)
    mine = K.fused_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    report("fused_decode_attention S=32 L=1024 int8", mine, (out, kn, vn),
           {"other": other,
            "this": lambda: K.fused_decode_attention(*args, **kw)})
    return failed


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
        raise RuntimeError("%s %s failed to launch" % (name, entry))


if __name__ == "__main__":
    sys.exit(main())
