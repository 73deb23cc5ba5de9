"""Decoder-only Transformer language model and its serving graphs.

Counterpart of ``mxnet_tpu/models/transformer.py``: the same constructor
calls build the same graphs, node for node and name for name, so a
checkpoint of one package loads into the other and the Symbol JSON is
identical. Pre-norm blocks: x + MHA(LN(x)), x + FFN(LN(x)).

Ported here: ``get_symbol`` (training head, used to name the weights),
``get_prefill_symbol`` and the per-lane ring variant of
``get_decode_symbol``. The paged and shared-pool decode variants and the
chunk graph come with the paged-decode slice.
"""
import numpy as np

from .. import symbol as sym


def _layer_norm(x, name, dim):
    # Deliberately the naive frontend composition, as in the JAX package:
    # the variance branch recomputes its own mean/centering and the square
    # is spelled as a self-multiply. The bind-time rewrite (cse merges the
    # duplicates, canonicalize turns x*x into square) brings it to the form
    # the norm_residual fusion pattern matches.
    mean = sym.mean(x, axis=-1, keepdims=True)
    cent = sym.broadcast_sub(x, mean, name="%s_cent" % name)
    cent_v = sym.broadcast_sub(x, sym.mean(x, axis=-1, keepdims=True))
    var = sym.mean(cent_v * cent_v, axis=-1, keepdims=True)
    inv = sym.rsqrt(var + 1e-5)
    normed = sym.broadcast_mul(cent, inv)
    gamma = sym.Variable("%s_gamma" % name, shape=(dim,))
    beta = sym.Variable("%s_beta" % name, shape=(dim,))
    return sym.broadcast_add(sym.broadcast_mul(normed, gamma), beta, name=name)


def _split_fused(fused, n_parts, seq_len, num_heads, dh):
    """Split one fused (B, T, n_parts·M) projection into n_parts head-major
    (B, H, T, dh) tensors — the single owner of the fused-weight layout."""
    fused = sym.Reshape(fused, shape=(-1, seq_len, n_parts, num_heads, dh))
    outs = []
    for i in range(n_parts):
        p = sym.Reshape(sym.slice_axis(fused, axis=2, begin=i, end=i + 1),
                        shape=(-1, seq_len, num_heads, dh))
        outs.append(sym.SwapAxis(p, dim1=1, dim2=2))  # (B,T,H,D)→(B,H,T,D)
    return outs


def _attention_block(x, name, num_heads, model_dim, seq_len, causal=True,
                     return_kv=False):
    """Self-attention with one fused 3·M-wide qkv projection. ``return_kv``
    also hands back the head-major (B, H, T, dh) key/value tensors, which
    the prefill graph exports to seed the decode ring."""
    dh = model_dim // num_heads
    qkv = sym.FullyConnected(data=x, num_hidden=3 * model_dim, flatten=False,
                             name="%s_qkv" % name)
    q, k, v = _split_fused(qkv, 3, seq_len, num_heads, dh)
    att = sym.MultiHeadAttention(query=q, key=k, value=v, causal=causal,
                                 name="%s_att" % name)
    att = sym.SwapAxis(att, dim1=1, dim2=2)  # (B,T,H,D)
    att = sym.Reshape(att, shape=(-1, seq_len, model_dim))
    proj = sym.FullyConnected(data=att, num_hidden=model_dim, flatten=False,
                              name="%s_proj" % name)
    if return_kv:
        return proj, k, v
    return proj


def _ffn(x, name, model_dim, ffn_dim):
    h = sym.FullyConnected(data=x, num_hidden=ffn_dim, flatten=False,
                           name="%s_ffn1" % name)
    h = sym.Activation(h, act_type="relu")
    return sym.FullyConnected(data=h, num_hidden=model_dim, flatten=False,
                              name="%s_ffn2" % name)


def get_prefill_symbol(vocab_size=32000, num_layers=6, num_heads=8,
                       model_dim=512, ffn_dim=2048, prefill_len=64,
                       pos_len=None):
    """Serving prefill graph: the decoder-only LM over a fixed
    ``prefill_len`` bucket, also exporting every layer's head-major K/V.

    Outputs: ``[logits (B·P, vocab), k_0, v_0, ..., k_{L-1}, v_{L-1}]`` with
    each k/v of shape (B, H, P, dh). Weight names are those of
    ``get_symbol``; prompts are right-padded to ``prefill_len``."""
    pos_len = pos_len or prefill_len
    data = sym.Variable("data")  # (B, P) int tokens, right-padded
    embed = sym.Embedding(data=data, input_dim=vocab_size,
                          output_dim=model_dim, name="embed")
    pos = sym.Variable("pos_embed_weight", shape=(pos_len, model_dim))
    if prefill_len != pos_len:
        pos = sym.slice_axis(pos, axis=0, begin=0, end=prefill_len)
    x = sym.broadcast_add(
        embed, sym.Reshape(pos, shape=(1, prefill_len, model_dim)),
        name="pos_add")
    kvs = []
    for i in range(num_layers):
        name = "layer%d" % i
        a, k, v = _attention_block(
            _layer_norm(x, "%s_ln1" % name, model_dim), name, num_heads,
            model_dim, prefill_len, causal=True, return_kv=True)
        kvs += [k, v]
        x = x + a
        x = x + _ffn(_layer_norm(x, "%s_ln2" % name, model_dim), name,
                     model_dim, ffn_dim)
    x = _layer_norm(x, "final_ln", model_dim)
    logits = sym.FullyConnected(
        data=sym.Reshape(x, shape=(-1, model_dim)), num_hidden=vocab_size,
        name="lm_head")
    return sym.Group([logits] + kvs)


def get_decode_symbol(vocab_size=32000, num_layers=6, num_heads=8,
                      model_dim=512, ffn_dim=2048, max_len=64, pos_len=None,
                      token_out=True):
    """Serving single-token decode graph over a ring KV buffer of
    ``max_len`` slots per layer (the per-lane ring variant).

    Inputs beyond the weights: ``data`` (B, 1) token ids, ``pos_idx`` (B, 1)
    absolute positions, ``slot_onehot`` (max_len,) the ring slot this token
    writes, ``kv_mask`` (max_len,) the additive score mask, and the ring
    buffers ``kv_k_i``/``kv_v_i`` (B, H, max_len, dh). The KV write is
    in-graph: ``kv' = kv·(1-oh) + kv_new·oh``.

    T=1 collapses attention to a masked weighted sum, so it is composed from
    broadcast primitives instead of the MultiHeadAttention op.

    Outputs: ``[logits (B, vocab), k'_0, v'_0, ...]`` plus, with
    ``token_out``, a trailing on-device ``greedy_token`` (B,) argmax head."""
    pos_len = pos_len or max_len
    dh = model_dim // num_heads
    scale = 1.0 / float(np.sqrt(dh))
    data = sym.Variable("data")
    pos_idx = sym.Variable("pos_idx")
    oh = sym.Variable("slot_onehot")
    msk = sym.Variable("kv_mask")
    oh4 = sym.Reshape(oh, shape=(1, 1, max_len, 1))
    msk3 = sym.Reshape(msk, shape=(1, 1, max_len))
    keep4 = 1.0 - oh4
    emb = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=model_dim, name="embed")
    posrow = sym.Embedding(data=pos_idx, input_dim=pos_len,
                           output_dim=model_dim, name="pos_embed")
    x = emb + posrow  # (B, 1, M)
    kv_outs = []
    for i in range(num_layers):
        name = "layer%d" % i
        ln = _layer_norm(x, "%s_ln1" % name, model_dim)
        qkv = sym.FullyConnected(data=ln, num_hidden=3 * model_dim,
                                 flatten=False, name="%s_qkv" % name)
        q, k_new, v_new = _split_fused(qkv, 3, 1, num_heads, dh)
        kv_k = sym.Variable("kv_k_%d" % i)
        kv_v = sym.Variable("kv_v_%d" % i)
        k_upd = sym.broadcast_add(sym.broadcast_mul(kv_k, keep4),
                                  sym.broadcast_mul(k_new, oh4),
                                  name="%s_kupd" % name)
        v_upd = sym.broadcast_add(sym.broadcast_mul(kv_v, keep4),
                                  sym.broadcast_mul(v_new, oh4),
                                  name="%s_vupd" % name)
        kv_outs += [k_upd, v_upd]
        scores = sym.sum(sym.broadcast_mul(q, k_upd), axis=3) * scale
        scores = sym.broadcast_add(scores, msk3)  # (B, H, S)
        p = sym.softmax(scores, axis=-1)
        ctx = sym.sum(sym.broadcast_mul(sym.expand_dims(p, axis=3), v_upd),
                      axis=2)  # (B, H, dh)
        att = sym.Reshape(
            sym.SwapAxis(sym.Reshape(ctx, shape=(-1, num_heads, 1, dh)),
                         dim1=1, dim2=2),
            shape=(-1, 1, model_dim))
        x = x + sym.FullyConnected(data=att, num_hidden=model_dim,
                                   flatten=False, name="%s_proj" % name)
        x = x + _ffn(_layer_norm(x, "%s_ln2" % name, model_dim), name,
                     model_dim, ffn_dim)
    x = _layer_norm(x, "final_ln", model_dim)
    logits = sym.FullyConnected(
        data=sym.Reshape(x, shape=(-1, model_dim)), num_hidden=vocab_size,
        name="lm_head")
    outs = [logits] + kv_outs
    if token_out:
        outs.append(sym.argmax(logits, axis=-1, name="greedy_token"))
    return sym.Group(outs)


def get_symbol(vocab_size=32000, num_layers=6, num_heads=8, model_dim=512,
               ffn_dim=2048, seq_len=64):
    """The training graph (softmax head over (B·T, vocab)); its arguments
    name the weights every serving graph reads."""
    data = sym.Variable("data")  # (B, T) int tokens
    label = sym.Variable("softmax_label")
    embed = sym.Embedding(data=data, input_dim=vocab_size,
                          output_dim=model_dim, name="embed")
    pos = sym.Variable("pos_embed_weight", shape=(seq_len, model_dim))
    x = sym.broadcast_add(embed, sym.Reshape(pos, shape=(1, seq_len, model_dim)),
                          name="pos_add")
    for i in range(num_layers):
        name = "layer%d" % i
        a = _attention_block(_layer_norm(x, "%s_ln1" % name, model_dim),
                             name, num_heads, model_dim, seq_len)
        x = x + a
        h = _layer_norm(x, "%s_ln2" % name, model_dim)
        h = sym.FullyConnected(data=h, num_hidden=ffn_dim, flatten=False,
                               name="%s_ffn1" % name)
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(data=h, num_hidden=model_dim, flatten=False,
                               name="%s_ffn2" % name)
        x = x + h
    x = _layer_norm(x, "final_ln", model_dim)
    x = sym.Reshape(x, shape=(-1, model_dim))
    logits = sym.FullyConnected(data=x, num_hidden=vocab_size, name="lm_head")
    label_flat = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(data=logits, label=label_flat, name="softmax")
