"""Decoder-only transformer language model.

Counterpart of ``mxnet_tpu/models/transformer.py`` ``get_transformer_lm``
(l.89): the same Symbol graph, node names and parameter layouts, so a
checkpoint of either package serves in the other. Pipeline-stage tags
and mixture-of-experts blocks wait for later slices of the port.
"""
from __future__ import annotations

from .. import symbol as sym
from ..base import later_slice

__all__ = ["transformer_block", "get_transformer_lm"]


def _ln(data, name):
    return sym.LayerNorm(data=data,
                         gamma=sym.Variable(name + "_gamma"),
                         beta=sym.Variable(name + "_beta"),
                         name=name)


def transformer_block(data, num_heads, hidden, embed_dim, name,
                      causal=True, impl="flash", dropout=0.0,
                      rope=False, num_kv_heads=0, window=0):
    """Pre-LN block: x + MHA(LN(x)); x + FFN(LN(x)). data: [B,T,E]."""
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
    ln2 = _ln(x, name + "_ln2")
    f1 = sym.FullyConnected(data=ln2, num_hidden=hidden,
                            name=name + "_ffn1", flatten=False)
    act = sym.Activation(data=f1, act_type="relu", name=name + "_ffn_relu")
    f2 = sym.FullyConnected(data=act, num_hidden=embed_dim,
                            name=name + "_ffn2", flatten=False)
    return x + f2


def get_transformer_lm(vocab_size, num_layers=2, embed_dim=128, num_heads=4,
                       ffn_hidden=None, seq_len=None, impl="flash",
                       dropout=0.0, num_experts=0, pipeline_stages=None,
                       moe_top_k=0, loss_layout="reference",
                       pos_encoding="learned", num_kv_heads=0, window=0):
    """Decoder-only LM: Embedding -> N blocks -> FC head -> per-position
    softmax over the vocab. ``loss_layout`` "reference" swaps the
    [B,T,V] logits to [B,V,T] for the multi_output SoftmaxOutput; "flat"
    reshapes them to [B*T,V]. ``pos_encoding`` "learned" adds the
    ``pos_embed`` table, "rope" rotates q/k in every attention.
    ``num_kv_heads`` is grouped-query attention, ``window`` sliding-window
    attention (0 = unlimited). The parameters are the JAX package's, in
    its order; ``num_experts``, ``pipeline_stages`` and ``moe_top_k``
    (mixture-of-experts blocks, pipeline stage tags) raise unless left
    at their defaults (or 0): they belong to a later slice."""
    if num_experts:
        raise later_slice("get_transformer_lm", "mixture-of-experts blocks "
                          "(num_experts=%d)" % num_experts)
    if pipeline_stages:
        raise later_slice("get_transformer_lm", "pipeline stage tags "
                          "(pipeline_stages=%r)" % (pipeline_stages,))
    if moe_top_k:
        raise later_slice("get_transformer_lm", "top-k expert routing "
                          "(moe_top_k=%r)" % (moe_top_k,))
    if pos_encoding not in ("learned", "rope"):
        raise ValueError("pos_encoding must be 'learned' or 'rope', "
                         "got %r" % (pos_encoding,))
    if loss_layout not in ("reference", "flat"):
        raise ValueError("loss_layout must be 'reference' or 'flat' in "
                         "the PyTorch port, got %r" % (loss_layout,))
    if ffn_hidden is None:
        ffn_hidden = 4 * embed_dim
    data = sym.Variable("data")  # [B, T] int tokens
    net = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=embed_dim, name="embed")
    rope = pos_encoding == "rope"
    if not rope:
        net = sym.PositionalEmbedding(data=net,
                                      pos=sym.Variable("pos_embed"),
                                      name="pos_add")
    for i in range(num_layers):
        net = transformer_block(net, num_heads, ffn_hidden, embed_dim,
                                "layer%d" % i, impl=impl, dropout=dropout,
                                rope=rope, num_kv_heads=num_kv_heads,
                                window=window)
    ln_f = _ln(net, "lnf")
    logits = sym.FullyConnected(data=ln_f, num_hidden=vocab_size,
                                name="lm_head", flatten=False)
    if loss_layout == "flat":
        flat = sym.Reshape(data=logits, shape=(-1, vocab_size),
                           name="logits_flat")
        flat_label = sym.Reshape(
            data=sym.Variable("softmax_label"), shape=(-1,),
            name="label_flat")
        return sym.SoftmaxOutput(data=flat, label=flat_label,
                                 name="softmax")
    logits_t = sym.SwapAxis(data=logits, dim1=1, dim2=2, name="logits_t")
    return sym.SoftmaxOutput(data=logits_t, name="softmax",
                             multi_output=True)
