"""KV-cache autoregressive decoding for Symbol-built transformer LMs.

Counterpart of ``mxnet_tpu/parallel/decode.py`` ``Decoder``, paged path:
the incremental program is DERIVED from the LM's own Symbol graph — the
topological walk runs every position-wise op's ``OpSpec.forward``
unchanged, slices ``PositionalEmbedding`` at the current positions and
swaps every ``MultiHeadAttention`` node for a cached variant that writes
the new tokens' K/V into a ``[B, max_len, Hkv, D]`` cache and reads it
through :func:`~mxnet_tpu_torch.ops.kernels.paged_attention` (or, for a
single decode token with quantized projections and ``matmul_impl=
"fused"``, through :func:`~mxnet_tpu_torch.ops.kernels.
fused_decode_attention`).

The decoder runs eagerly: ``generate`` is a Python loop, and the cache
is updated IN PLACE (one buffer per node for the life of the cache
instead of a donated copy per step). The serving engine runs the same
walk inside its compiled programs (``parallel.program``), with
:func:`sample_tokens` over :func:`uniform_draw`, the draw as a pure
function of (seed, position). Windowed ring
caches, ``cache_block``, tensor/expert parallelism, speculative verify
and beam search belong to later slices of the port.
"""
from __future__ import annotations

import os

import torch

from ..base import MXNetError, later_slice, refuse_unported, torch_dtype
from ..context import resolve_device
from ..ops import kernels
from ..ops.attention import MultiHeadAttention as _MHA, rope_rotate
from ..serving.quant import (QuantizedTensor, embedding_rows,
                             quantize_params, quantized_weight_names,
                             resolve_group, scale_fused_matmul)

__all__ = ["Decoder", "sample_tokens", "uniform_draw"]

# ops whose forward acts independently per position on [B, C, ...] data
_POSITIONWISE = {
    "Embedding", "LayerNorm", "FullyConnected", "Activation", "LeakyReLU",
    "Dropout", "BlockGrad", "Cast", "ElementWiseSum",
    "_Plus", "_Minus", "_Mul", "_Div", "_PlusScalar", "_MinusScalar",
    "_MulScalar", "_DivScalar", "_RMinusScalar", "_RDivScalar",
}
_TEMPORAL = {"MultiHeadAttention", "PositionalEmbedding"}
_LOSS_HEADS = {"SoftmaxOutput"}


def _logits_symbol(symbol):
    """Re-head a loss-ended LM at its [B, T, V] logits: strip the loss
    node, then the layout ops the loss variants insert between the head
    and the loss (SwapAxis for [B,V,T], Reshape for the flat layout)."""
    heads = symbol._heads
    if len(heads) == 1 and not heads[0][0].is_var \
            and heads[0][0].spec.name in _LOSS_HEADS:
        node = heads[0][0].inputs[0][0]
        while not node.is_var \
                and node.spec.name in ("SwapAxis", "Reshape", "Flatten"):
            node = node.inputs[0][0]
        return symbol.get_internals()[node.name + "_output"]
    return symbol


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in two 16-bit halves of ``c`` so that no product
    leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """lowbias32 (C. Wellons, "Prospecting for hash functions", 2018): a
    bijection of [0, 2**32) whose output bits each flip with probability
    near 1/2 when one input bit flips."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_draw(seed, position):
    """One uniform in (0, 1) per element: a function of the int64
    ``seed`` and ``position`` and of nothing else (the port's counterpart
    of ``jax.random.fold_in(key(seed), position)``). Both halves of the
    seed and then the position are folded through :func:`_hash32`; the
    top 24 bits of the result give the float32 uniform."""
    h = _hash32(seed & _M32)
    h = _hash32(h ^ ((seed >> 32) & _M32))
    h = _hash32(_hash32(h ^ (position & _M32)))
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def sample_tokens(logits, temperature, u):
    """The next token of each row of ``logits`` [N, V]: the argmax where
    ``temperature`` [N] is 0; elsewhere the token whose interval of the
    cumulative ``softmax(logits / temperature)`` holds ``u`` [N], the
    row's :func:`uniform_draw` of (seed, position) — so a request's
    stream depends on its seed and its positions only, never on what
    else shares the batch. All on the device, with no host read."""
    greedy = torch.argmax(logits, dim=-1)
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))
    cdf = torch.cumsum(torch.softmax(logits.to(torch.float32) / t[:, None],
                                     dim=-1), dim=-1)
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None].contiguous()
                               )[:, 0]
    drawn = drawn.clamp_max(logits.shape[-1] - 1)
    return torch.where(temperature > 0, drawn, greedy)


class Decoder:
    """Autoregressive KV-cache decoder over a Symbol LM (paged reads).

    Parameters
    ----------
    symbol : Symbol
        The LM graph, logits-headed or ending in SoftmaxOutput (the loss
        head is stripped).
    params : dict[str, tensor or numpy array]
        Parameter values by name (e.g. a checkpoint's ``arg_params``).
    max_len : int
        Static cache length (within the trained ``pos_embed`` table).
    aux_params : dict, optional
        Auxiliary states of graphs that carry them.
    compute_dtype : str or torch.dtype, optional
        Cast floating parameters (and the cache) for the decode math,
        e.g. ``"bfloat16"``.
    cache_block : {"auto", None}
        As in the JAX package, where with ``attn_impl="paged"`` both mean
        no blocked read (the paged read is already bounded by each
        sequence's live rows); an integer block (the dense path's
        blocked read) raises: it belongs to a later slice.
    cache_dtype : optional
        ``"int8"`` stores K/V quantized with f32 row scales (amax/127 per
        position and head), dequantized inside the paged kernel; a float
        dtype stores the cache at that dtype; default follows
        ``compute_dtype``.
    attn_impl : {None, "paged"}
        The cache read: the paged kernel over each sequence's live rows.
        ``None`` reads ``MXNET_SERVING_ATTN_IMPL`` as the JAX package
        does; unset, it means ``"paged"`` here where the JAX package
        takes ``"dense"``. Both reads compute the same attention over a
        sequence's live rows; the dense read (``"dense"``) raises: it
        belongs to a later slice.
    weight_dtype : {None, "float", "int8", "int4"}
        Weight storage: quantize every matmul weight (attention
        projections, FullyConnected, Embedding) with per-output-channel
        (int8) or per-group (int4) f32 scales, dequantized on the fly.
        ``None`` reads ``MXNET_SERVING_WEIGHT_DTYPE``, else ``"float"``,
        as the JAX package does.
    weight_group : int, optional
        int4 group width (default: the largest of 128..2 dividing E).
    matmul_impl : {None, "dense", "pallas", "fused"}
        Quantized products: ``"dense"`` the plain chunked product,
        ``"pallas"`` the ``quant_matmul`` kernel, ``"fused"`` the kernel
        plus the one-launch ``fused_decode_attention`` step where
        eligible (the name is the JAX package's, so one configuration
        reads the same in both). ``None`` reads
        ``MXNET_SERVING_MATMUL_IMPL``, else ``"dense"``, as the JAX
        package does.
    device : optional, keyword-only (the port's own)
        Where parameters and caches live; ``None`` means ``cuda:0`` and
        raises without CUDA. Pass ``"cpu"`` to run the plain versions on
        the host.
    """

    def __init__(self, symbol, params, max_len, aux_params=None,
                 compute_dtype=None, cache_block="auto", cache_dtype=None,
                 attn_impl=None, weight_dtype=None, weight_group=None,
                 matmul_impl=None, *, device=None):
        if attn_impl is None:
            attn_impl = os.environ.get("MXNET_SERVING_ATTN_IMPL") or "paged"
        if attn_impl == "dense":
            raise later_slice("Decoder", "attn_impl='dense' (the dense "
                              "cache read)")
        if attn_impl != "paged":
            raise MXNetError(
                "Decoder: attn_impl must be 'paged' (or 'dense', a later "
                "slice), got %r" % (attn_impl,))
        if cache_block not in ("auto", None):
            raise later_slice("Decoder", "cache_block=%r (the dense "
                              "path's blocked read)" % (cache_block,))
        if weight_dtype is None:
            weight_dtype = os.environ.get(
                "MXNET_SERVING_WEIGHT_DTYPE") or "float"
        if matmul_impl is None:
            matmul_impl = os.environ.get(
                "MXNET_SERVING_MATMUL_IMPL") or "dense"
        self.device = resolve_device(device)
        symbol = _logits_symbol(symbol)
        self._topo = symbol._topo()
        self._heads = symbol._heads
        if len(self._heads) != 1:
            raise MXNetError("Decoder needs a single-output symbol, got %d"
                             % len(self._heads))
        self.max_len = int(max_len)
        self._attn_impl = attn_impl
        if matmul_impl not in ("dense", "pallas", "fused"):
            raise MXNetError(
                "Decoder: matmul_impl must be 'dense', 'pallas' or "
                "'fused', got %r" % (matmul_impl,))
        self._matmul_impl = matmul_impl
        if weight_dtype not in ("float", "int8", "int4"):
            raise MXNetError(
                "Decoder: weight_dtype must be 'float', 'int8' or "
                "'int4', got %r" % (weight_dtype,))
        self.weight_dtype = weight_dtype
        self.weight_group = weight_group
        self._bias32 = {}

        self._mha = []
        for n in self._topo:
            if n.is_var:
                continue
            name = n.spec.name
            if name == "MultiHeadAttention":
                if not n.params["causal"]:
                    raise MXNetError(
                        "Decoder: attention node %r is non-causal — "
                        "autoregressive decoding is defined only for "
                        "causal attention" % n.name)
                if n.params.get("window", 0):
                    raise MXNetError(
                        "Decoder: windowed ring caches (node %r) are not "
                        "ported to the PyTorch package yet" % n.name)
                self._mha.append(n)
            elif name not in _TEMPORAL and name not in _POSITIONWISE:
                raise MXNetError(
                    "Decoder: op %s (node %r) is not known to be "
                    "position-wise; the decode transform supports the "
                    "standard LM ops (%s)"
                    % (name, n.name, ", ".join(sorted(_POSITIONWISE))))

        arg_names = [n.name for n in self._topo if n.is_var]
        self._data_name = "data" if "data" in arg_names else arg_names[0]
        missing = [a for a in arg_names
                   if a != self._data_name and a not in params]
        if missing:
            raise MXNetError("Decoder: missing parameter values for %s"
                             % missing)
        cdt = None if compute_dtype is None else torch_dtype(compute_dtype)

        def place(v):
            t = torch.as_tensor(v).detach().to(self.device)
            return t.to(cdt) if cdt is not None and t.is_floating_point() \
                else t

        self._params = {a: place(params[a]) for a in arg_names
                        if a != self._data_name}
        aux_names = symbol.list_auxiliary_states()
        missing_aux = [a for a in aux_names if a not in (aux_params or {})]
        if missing_aux:
            raise MXNetError("Decoder: missing aux_params values for %s"
                             % missing_aux)
        self._aux = [place(aux_params[a]) for a in aux_names]
        if cache_dtype is None:
            self._cache_int8 = False
            self._cache_dtype = cdt or torch.float32
        else:
            self._cache_dtype = torch_dtype(cache_dtype)
            self._cache_int8 = self._cache_dtype == torch.int8
            if not self._cache_int8 \
                    and not self._cache_dtype.is_floating_point:
                raise MXNetError(
                    "Decoder: cache_dtype must be 'int8' or a float "
                    "dtype, got %r" % (cache_dtype,))

        for n in self._topo:
            if not n.is_var and n.spec.name == "PositionalEmbedding":
                pos_param = n.inputs[1][0].name
                rows = self._params[pos_param].shape[0]
                if rows < self.max_len:
                    raise MXNetError(
                        "Decoder: max_len=%d exceeds the %d trained "
                        "positions of %r" % (self.max_len, rows,
                                             pos_param))

        if weight_dtype in ("int8", "int4"):
            bits = 8 if weight_dtype == "int8" else 4
            if bits == 4 and self._mha:
                wname = self._mha[0].inputs[1][0].name
                self.weight_group = resolve_group(
                    self._params[wname].shape[-1], weight_group)
            self._params = quantize_params(
                self._params, quantized_weight_names(self._topo),
                bits=bits, group=weight_group,
                row_quant=self._embedding_weight_names())

    @classmethod
    def from_checkpoint(cls, prefix, epoch, max_len, **kwargs):
        """Build a decoder from ``prefix-symbol.json`` +
        ``prefix-NNNN.params`` (either package's checkpoints)."""
        from ..model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(symbol, arg_params, max_len, aux_params=aux_params,
                   **kwargs)

    def _embedding_weight_names(self):
        """Parameter names consumed as Embedding tables (always per-row
        int8 under quantization: they are gathered by rows)."""
        return {n.inputs[1][0].name for n in self._topo
                if not n.is_var and n.spec.name == "Embedding"}

    # -- cache ----------------------------------------------------------
    def init_cache(self, batch_size, kv_sharding=None):
        """Zeroed K/V buffers, ``[B, max_len, Hkv, D]`` per attention
        node (plus ``[B, max_len, Hkv]`` f32 row scales for an int8
        cache). ``kv_sharding`` (a cache laid out over a mesh's kv heads)
        raises unless None: it belongs to a later slice."""
        refuse_unported("Decoder.init_cache",
                        kv_sharding=(kv_sharding, None))
        caches = []
        for n in self._mha:
            w = self._params[n.inputs[1][0].name]
            e = w.shape[-1] if isinstance(w, QuantizedTensor) \
                else w.shape[1]
            h = n.params["num_heads"]
            shape = (batch_size, self.max_len, _MHA.kv_heads(n.params),
                     e // h)
            kw = dict(device=self.device)
            if self._cache_int8:
                entry = (torch.zeros(shape, dtype=torch.int8, **kw),
                         torch.ones(shape[:3], dtype=torch.float32, **kw),
                         torch.zeros(shape, dtype=torch.int8, **kw),
                         torch.ones(shape[:3], dtype=torch.float32, **kw))
            else:
                entry = (torch.zeros(shape, dtype=self._cache_dtype, **kw),
                         torch.zeros(shape, dtype=self._cache_dtype, **kw))
            caches.append(entry)
        return caches

    @staticmethod
    def _quantize_rows(x):
        """[B, C, H, D] float -> (int8 values, [B, C, H] f32 scales):
        symmetric amax/127 per (position, head) row."""
        xf = x.to(torch.float32)
        s = xf.abs().amax(dim=-1) / 127.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        return torch.round(xf / s[..., None]).to(torch.int8), s

    def _write_cache(self, entry, k, v, ctx):
        """Write a [B, C, Hkv, D] K/V chunk into rows ``[pos, pos+C)`` of
        each batch row, in place (the rows come from the run's ``ctx``)."""
        sidx, rows = ctx["sidx"], ctx["rows"]
        if self._cache_int8:
            ck, ks, cv, vs = entry
            k8, ksc = self._quantize_rows(k)
            v8, vsc = self._quantize_rows(v)
            ck[sidx, rows] = k8
            ks[sidx, rows] = ksc
            cv[sidx, rows] = v8
            vs[sidx, rows] = vsc
        else:
            ck, cv = entry
            ck[sidx, rows] = k.to(ck.dtype)
            cv[sidx, rows] = v.to(cv.dtype)
        return entry

    # -- the derived incremental walk -----------------------------------
    def _qmm(self, x, qt, impl):
        """One quantized matmul ``x [..., E] @ qt [F, E]^T`` under
        ``impl``: the plain chunked product for ``"dense"``, the
        ``quant_matmul`` kernel otherwise."""
        if impl == "dense":
            return scale_fused_matmul(x, qt)
        f = qt.q.shape[0]
        out = kernels.quant_matmul(x.reshape(-1, x.shape[-1]), qt.q,
                                   qt.scale, bits=qt.bits, group=qt.group,
                                   out_dtype=x.dtype)
        return out.reshape(tuple(x.shape[:-1]) + (f,))

    def _f32(self, t):
        """``t`` in f32, converted once per parameter tensor (the fused
        kernel takes its biases in f32 whatever the compute dtype)."""
        hit = self._bias32.get(id(t))
        if hit is None or hit[0] is not t:
            hit = self._bias32[id(t)] = (t, t.to(torch.float32).contiguous())
        return hit[1]

    def _fused_decode_mha(self, node, ins, entry, ctx):
        """The one-launch decode chain (``matmul_impl="fused"``): QKV
        projection -> rope -> attention over the live rows and the new
        token -> output projection; the new k/v rows are written after
        the kernel, which reads the same as writing first."""
        x, wqkv, bqkv, wo, bo = ins
        b, _, e = x.shape
        out, kn, vn = kernels.fused_decode_attention(
            x.reshape(b, e), ctx["pos"], entry[0], entry[1],
            wqkv.q, wqkv.scale, self._f32(bqkv), wo.q, wo.scale,
            self._f32(bo),
            heads=node.params["num_heads"],
            kv_heads=_MHA.kv_heads(node.params), bits=wqkv.bits,
            group=wqkv.group, rope=bool(node.params.get("rope")),
            rope_base=float(node.params.get("rope_base") or 10000.0))
        entry = self._write_cache(entry, kn[:, None], vn[:, None], ctx)
        return out.reshape(b, 1, e), entry

    def _cached_mha(self, node, ins, entry, ctx, mm_impl):
        x, wqkv, bqkv, wo, bo = ins
        b, c, e = x.shape
        h = node.params["num_heads"]
        d = e // h
        kv = _MHA.kv_heads(node.params)
        # the JAX package's eligibility rule (decode.py l.587-595); the
        # port has no tp or windowed nodes, so those terms always hold
        if (mm_impl == "fused" and c == 1 and len(entry) == 2
                and isinstance(wqkv, QuantizedTensor)
                and isinstance(wo, QuantizedTensor)
                and wqkv.bits == wo.bits and wqkv.group == wo.group
                and self._attn_impl == "paged"):
            return self._fused_decode_mha(node, ins, entry, ctx)
        if isinstance(wqkv, QuantizedTensor):
            qkv = self._qmm(x, wqkv, mm_impl) + bqkv
        else:
            qkv = torch.matmul(x, wqkv.t()) + bqkv
        q = qkv[..., :e].reshape(b, c, h, d)
        k = qkv[..., e:e + kv * d].reshape(b, c, kv, d)
        v = qkv[..., e + kv * d:].reshape(b, c, kv, d)
        if node.params.get("rope"):
            q = rope_rotate(q, ctx["rows"], node.params["rope_base"])
            k = rope_rotate(k, ctx["rows"], node.params["rope_base"])
        entry = self._write_cache(entry, k, v, ctx)
        if self._cache_int8:
            ck, ks, cv, vs = entry
            o = kernels.paged_attention(q.contiguous(), ck, cv, ctx["pos"],
                                        k_scale=ks, v_scale=vs)
        else:
            ck, cv = entry
            o = kernels.paged_attention(q.contiguous(), ck, cv, ctx["pos"])
        o = o.reshape(b, c, e)
        if isinstance(wo, QuantizedTensor):
            return self._qmm(o, wo, mm_impl) + bo, entry
        return torch.matmul(o, wo.t()) + bo, entry

    def _run(self, params, aux, caches, pos, tokens, mm_impl=None):
        """One chunk: tokens [B, C] at positions ``[pos, pos+C)`` ->
        (logits [B, C, V], caches). ``pos`` is an int (every row at the
        same position) or an int32 tensor [B] (each row at its own);
        the caches are written in place and returned."""
        if mm_impl is None:
            mm_impl = self._matmul_impl
        b, c = tokens.shape
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((b,), int(pos), dtype=torch.int32,
                             device=self.device)
        # what every attention and positional node of this chunk shares:
        # each row's positions [pos, pos+C) and its batch index
        ctx = {"pos": pos,
               "rows": pos.long()[:, None]
               + torch.arange(c, device=pos.device),
               "sidx": torch.arange(b, device=pos.device)[:, None]}
        env = {}
        mha_i = 0
        aux_cursor = 0
        for n in self._topo:
            if n.is_var:
                env[(id(n), 0)] = tokens if n.name == self._data_name \
                    else params[n.name]
                continue
            ins = [env[(id(inp), idx)] for inp, idx in n.inputs]
            name = n.spec.name
            if name == "MultiHeadAttention":
                env[(id(n), 0)], caches[mha_i] = self._cached_mha(
                    n, ins, caches[mha_i], ctx, mm_impl)
                mha_i += 1
                continue
            if name == "PositionalEmbedding":
                x, posp = ins
                env[(id(n), 0)] = x + posp[ctx["rows"]]
                continue
            if name == "FullyConnected" \
                    and isinstance(ins[1], QuantizedTensor):
                xin = ins[0]
                if n.params["flatten"]:
                    xin = xin.reshape(xin.shape[0], -1)
                out = self._qmm(xin, ins[1], mm_impl)
                if not n.params["no_bias"]:
                    out = out + ins[2]
                env[(id(n), 0)] = out
                continue
            if name == "Embedding" and isinstance(ins[1], QuantizedTensor):
                env[(id(n), 0)] = embedding_rows(ins[1], ins[0])
                continue
            n_aux = len(n.spec.aux_states(n.params))
            aux_in = aux[aux_cursor:aux_cursor + n_aux]
            aux_cursor += n_aux
            outs, _ = n.spec.forward(n.params, ins, aux_in, False, None)
            for j, o in enumerate(outs):
                env[(id(n), j)] = o
        head, idx = self._heads[0]
        return env[(id(head), idx)], caches

    # -- slot-addressed forms (serving engine) --------------------------
    def _run_slots(self, params, aux, caches, pos, tokens, impl=None,
                   mm_impl=None):
        """Per-slot ``_run``: ``pos`` [S] int32 positions, ``tokens``
        [S, C] -> (logits [S, C, V], caches): one batched walk in which
        each slot writes and reads at its own clock."""
        if impl not in (None, "paged"):
            raise MXNetError("Decoder: the PyTorch port serves impl="
                             "'paged' only, got %r" % (impl,))
        return self._run(params, aux, caches, pos, tokens, mm_impl=mm_impl)

    @staticmethod
    def slot_update(caches, slot, sub, rows):
        """Write rows ``rows`` (an int64 tensor of row indices) of the b=1
        cache ``sub`` into the same rows of ``slot`` of the full cache, in
        place: one ``index_put_`` per buffer, keyed by ``slot``, an int64
        tensor [1] on the cache's device (a program's operand, as the JAX
        package's ``dynamic_update_slice`` is keyed by a traced slot)."""
        for entry, sentry in zip(caches, sub):
            for full, s in zip(entry, sentry):
                full.index_put_((slot.expand(rows.shape[0]), rows),
                                s[0].index_select(0, rows))
        return caches

    # -- user API -------------------------------------------------------
    def _tokens(self, tokens):
        t = torch.as_tensor(tokens)
        if t.is_floating_point():
            raise MXNetError("Decoder: token ids must be integers")
        return t.to(device=self.device, dtype=torch.int64)

    def prefill(self, caches, tokens):
        """Process a [B, P] prompt from position 0; returns
        (logits [B, P, V], caches)."""
        tokens = self._tokens(tokens)
        if tokens.shape[1] > self.max_len:
            raise MXNetError("Decoder: prompt length %d exceeds max_len %d"
                             % (tokens.shape[1], self.max_len))
        return self._run(self._params, self._aux, caches, 0, tokens)

    def step(self, caches, pos, token):
        """One token per sequence: token [B] at position ``pos`` ->
        (logits [B, V], caches)."""
        if not 0 <= pos < self.max_len:
            raise MXNetError(
                "Decoder: step position %d outside the cache [0, %d)"
                % (pos, self.max_len))
        logits, caches = self._run(self._params, self._aux, caches, pos,
                                   self._tokens(token)[:, None])
        return logits[:, 0], caches

    def generate(self, prompt, num_steps, rng=None, temperature=0.0,
                 return_cache=False):
        """Greedy (``temperature=0``) or sampled continuation.

        prompt: [B, P] token ids. Returns [B, P + num_steps] int64 —
        the prompt followed by the generated ids — or ``(tokens,
        caches)`` with ``return_cache=True`` (K/V through position
        ``P + num_steps - 1``). Sampled draws come from ``rng``, a
        ``torch.Generator`` on the decoder's device where the JAX
        package takes a PRNG key: the same seed gives the same draws
        (not the JAX package's). ``rng=None`` draws from PyTorch's
        default generator, so repeated calls differ, as they do in the
        JAX package."""
        if rng is not None and not isinstance(rng, torch.Generator):
            raise MXNetError("Decoder.generate: rng must be a "
                             "torch.Generator, got %r" % type(rng).__name__)
        prompt = self._tokens(prompt)
        b, p = prompt.shape
        if p + num_steps > self.max_len:
            raise MXNetError(
                "Decoder: prompt %d + steps %d exceeds max_len %d"
                % (p, num_steps, self.max_len))

        def pick(logits):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            probs = torch.softmax(logits.to(torch.float32) / temperature,
                                  dim=-1)
            return torch.multinomial(probs, 1, generator=rng)[:, 0]

        caches = self.init_cache(b)
        logits, caches = self._run(self._params, self._aux, caches, 0,
                                   prompt)
        tok = pick(logits[:, -1])
        toks = []
        for i in range(num_steps):
            toks.append(tok)
            logits, caches = self._run(self._params, self._aux, caches,
                                       p + i, tok[:, None])
            tok = pick(logits[:, 0])
        out = torch.cat([prompt] + [t[:, None] for t in toks], dim=1)
        return (out, caches) if return_cache else out
