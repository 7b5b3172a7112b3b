"""Decoder-only transformer language model.

Counterpart of ``mxnet_tpu/models/transformer.py`` ``get_transformer_lm``
(l.89), ``moe_transformer_block`` (l.67), ``tp_rules`` (l.201) and
``ep_rules`` (l.218): the same Symbol graph, node names, parameter layouts
and pipeline-stage tags, so a checkpoint of either package serves in the
other and ``tojson()`` is the JAX package's.
"""
from __future__ import annotations

from .. import symbol as sym
from ..attribute import AttrScope

__all__ = ["transformer_block", "moe_transformer_block",
           "get_transformer_lm", "tp_rules", "ep_rules"]


def _ln(data, name):
    return sym.LayerNorm(data=data,
                         gamma=sym.Variable(name + "_gamma"),
                         beta=sym.Variable(name + "_beta"),
                         name=name)


def _attn_sublayer(data, num_heads, name, causal, impl, dropout,
                   rope=False, num_kv_heads=0, window=0):
    """x + MHA(LN(x)) then LN: the attention half every block shares."""
    ln1 = _ln(data, name + "_ln1")
    attn = sym.MultiHeadAttention(
        data=ln1,
        qkv_weight=sym.Variable(name + "_qkv_weight"),
        qkv_bias=sym.Variable(name + "_qkv_bias"),
        out_weight=sym.Variable(name + "_proj_weight"),
        out_bias=sym.Variable(name + "_proj_bias"),
        num_heads=num_heads, num_kv_heads=num_kv_heads, causal=causal,
        impl=impl, dropout=dropout, rope=rope, window=window,
        name=name + "_attn")
    x = data + attn
    return x, _ln(x, name + "_ln2")


def transformer_block(data, num_heads, hidden, embed_dim, name,
                      causal=True, impl="flash", dropout=0.0,
                      rope=False, num_kv_heads=0, window=0):
    """Pre-LN block: x + MHA(LN(x)); x + FFN(LN(x)). data: [B,T,E]."""
    x, ln2 = _attn_sublayer(data, num_heads, name, causal, impl, dropout,
                            rope=rope, num_kv_heads=num_kv_heads,
                            window=window)
    f1 = sym.FullyConnected(data=ln2, num_hidden=hidden,
                            name=name + "_ffn1", flatten=False)
    act = sym.Activation(data=f1, act_type="relu", name=name + "_ffn_relu")
    f2 = sym.FullyConnected(data=act, num_hidden=embed_dim,
                            name=name + "_ffn2", flatten=False)
    return x + f2


def moe_transformer_block(data, num_heads, hidden, embed_dim, num_experts,
                          name, causal=True, impl="flash", dropout=0.0,
                          moe_top_k=0, rope=False, num_kv_heads=0,
                          window=0):
    """The block whose FFN is a mixture of ``num_experts`` experts
    (``MoEFFN``); ``moe_top_k > 0`` is static-shaped top-k routing."""
    x, ln2 = _attn_sublayer(data, num_heads, name, causal, impl, dropout,
                            rope=rope, num_kv_heads=num_kv_heads,
                            window=window)
    moe = sym.MoEFFN(
        data=ln2,
        gate_weight=sym.Variable(name + "_gate_weight"),
        expert_w1=sym.Variable(name + "_expert_w1"),
        expert_b1=sym.Variable(name + "_expert_b1"),
        expert_w2=sym.Variable(name + "_expert_w2"),
        expert_b2=sym.Variable(name + "_expert_b2"),
        num_experts=num_experts, hidden=hidden, top_k=moe_top_k,
        name=name + "_moe")
    return x + moe


def get_transformer_lm(vocab_size, num_layers=2, embed_dim=128, num_heads=4,
                       ffn_hidden=None, seq_len=None, impl="flash",
                       dropout=0.0, num_experts=0, pipeline_stages=None,
                       moe_top_k=0, loss_layout="reference",
                       pos_encoding="learned", num_kv_heads=0, window=0):
    """Decoder-only LM: Embedding -> N blocks -> FC head -> per-position
    softmax over the vocab. ``loss_layout`` "reference" swaps the
    [B,T,V] logits to [B,V,T] for the multi_output SoftmaxOutput; "flat"
    reshapes them to [B*T,V]; "ce" ends the flat logits in the fused
    ``SoftmaxCELoss`` head, whose output is the per-token loss [B*T] (f32;
    the probabilities are never formed, and the parameter updates are the
    other layouts'). ``pos_encoding`` "learned" adds the
    ``pos_embed`` table, "rope" rotates q/k in every attention.
    ``num_kv_heads`` is grouped-query attention, ``window`` sliding-window
    attention (0 = unlimited). ``num_experts`` builds every block with
    :func:`moe_transformer_block` (``moe_top_k`` its top-k routing, read
    only with ``num_experts``, as in the JAX package).
    ``pipeline_stages=S`` tags every node with ``ctx_group="stage<K>"``
    (the reference's graph-cut attribute), as the JAX package does: the
    embedding with block 0, block ``i`` in stage ``i * S // num_layers``,
    the final LayerNorm, the head and the loss in stage ``S - 1``; the
    tagged symbol drives ``parallel.PipelineTrainer``. The parameters are
    the JAX package's, in its order."""
    if pos_encoding not in ("learned", "rope"):
        raise ValueError("pos_encoding must be 'learned' or 'rope', "
                         "got %r" % (pos_encoding,))
    if loss_layout not in ("reference", "flat", "ce"):
        raise ValueError("loss_layout must be 'reference', 'flat' or "
                         "'ce', got %r" % (loss_layout,))
    if ffn_hidden is None:
        ffn_hidden = 4 * embed_dim

    def scope(i=None, last=False):
        if not pipeline_stages:
            return AttrScope()
        if last:
            s = pipeline_stages - 1
        else:
            s = 0 if i is None else i * pipeline_stages // num_layers
        return AttrScope(ctx_group="stage%d" % s)

    with scope(0):
        data = sym.Variable("data")  # [B, T] int tokens
        net = sym.Embedding(data=data, input_dim=vocab_size,
                            output_dim=embed_dim, name="embed")
        rope = pos_encoding == "rope"
        if not rope:
            net = sym.PositionalEmbedding(data=net,
                                          pos=sym.Variable("pos_embed"),
                                          name="pos_add")
    for i in range(num_layers):
        with scope(i):
            if num_experts:
                net = moe_transformer_block(
                    net, num_heads, ffn_hidden, embed_dim, num_experts,
                    "layer%d" % i, impl=impl, dropout=dropout,
                    moe_top_k=moe_top_k, rope=rope,
                    num_kv_heads=num_kv_heads, window=window)
            else:
                net = transformer_block(net, num_heads, ffn_hidden,
                                        embed_dim, "layer%d" % i,
                                        impl=impl, dropout=dropout,
                                        rope=rope,
                                        num_kv_heads=num_kv_heads,
                                        window=window)
    with scope(last=True):
        ln_f = _ln(net, "lnf")
        logits = sym.FullyConnected(data=ln_f, num_hidden=vocab_size,
                                    name="lm_head", flatten=False)
        if loss_layout in ("flat", "ce"):
            flat = sym.Reshape(data=logits, shape=(-1, vocab_size),
                               name="logits_flat")
            flat_label = sym.Reshape(
                data=sym.Variable("softmax_label"), shape=(-1,),
                name="label_flat")
            if loss_layout == "ce":
                return sym.SoftmaxCELoss(data=flat, label=flat_label,
                                         name="softmax")
            return sym.SoftmaxOutput(data=flat, label=flat_label,
                                     name="softmax")
        logits_t = sym.SwapAxis(data=logits, dim1=1, dim2=2,
                                name="logits_t")
        return sym.SoftmaxOutput(data=logits_t, name="softmax",
                                 multi_output=True)


def tp_rules():
    """Tensor-parallel sharding rules, the JAX package's (the Megatron
    layout: QKV/FFN1 column-parallel, proj/FFN2 row-parallel), for
    ``ShardingRules(param_rules=...)``. ``ParallelTrainer`` stores each
    such parameter as the rule shards it and gathers it where the walk
    uses it."""
    from ..parallel.shard import P
    return [
        (r"_qkv_weight$", P("tp", None)),
        (r"_qkv_bias$", P("tp")),
        (r"_ffn1_weight$", P("tp", None)),
        (r"_ffn1_bias$", P("tp")),
        (r"_proj_weight$", P(None, "tp")),
        (r"_ffn2_weight$", P(None, "tp")),
        (r"embed_weight$", P("tp", None)),
        (r"lm_head_weight$", P("tp", None)),
    ]

def ep_rules():
    """Expert-parallel sharding rules, the JAX package's: the leading
    ``num_experts`` dim of every expert stack shards over ``ep``. A list of
    ``(name regex, PartitionSpec)`` for ``ShardingRules(param_rules=...)``;
    the serving engine's ``ep`` shards its own copy
    (``serving/engine.py``)."""
    from ..parallel.shard import P
    return [
        (r"_expert_w1$", P("ep", None, None)),
        (r"_expert_b1$", P("ep", None)),
        (r"_expert_w2$", P("ep", None, None)),
        (r"_expert_b2$", P("ep", None)),
    ]
