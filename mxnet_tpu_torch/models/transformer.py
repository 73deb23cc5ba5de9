"""Decoder-only Transformer language model and its serving graphs.

Counterpart of ``mxnet_tpu/models/transformer.py``: the same constructor
calls build the same graphs, node for node and name for name, so a
checkpoint of one package loads into the other and the Symbol JSON is
identical. Pre-norm blocks: x + MHA(LN(x)), x + FFN(LN(x)).

Ported here: ``get_symbol`` (training head, used to name the weights),
the encoder-decoder MT model ``get_symbol_mt``, ``get_prefill_symbol``, ``get_decode_symbol`` with its per-lane ring,
per-stream and shared-pool variants, the chunk graph ``get_chunk_symbol``
of the paged decoder, and ``draft_config`` for speculative decoding.
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


# copied from mxnet_tpu/models/transformer.py (:70-98, backend-free)
def _split_heads(x, seq_len, num_heads, dh):
    """(B, T, M) → (B, H, T, dh) for the fused attention op."""
    x = sym.Reshape(x, shape=(-1, seq_len, num_heads, dh))
    return sym.SwapAxis(x, dim1=1, dim2=2)


def _merge_heads(att, seq_len, model_dim):
    att = sym.SwapAxis(att, dim1=1, dim2=2)
    return sym.Reshape(att, shape=(-1, seq_len, model_dim))


def _cross_attention(q_in, kv_in, name, num_heads, model_dim, q_len, kv_len):
    """Attention with separate query/key-value sources (the MT decoder's
    encoder-attention). Only the q projection is separate; k and v share
    one fused 2·M-wide projection of kv_in, as the self-attention block's
    qkv does."""
    dh = model_dim // num_heads
    q = sym.FullyConnected(data=q_in, num_hidden=model_dim, flatten=False,
                           name="%s_q" % name)
    kv = sym.FullyConnected(data=kv_in, num_hidden=2 * model_dim,
                            flatten=False, name="%s_kv" % name)
    k, v = _split_fused(kv, 2, kv_len, num_heads, dh)
    att = sym.MultiHeadAttention(
        query=_split_heads(q, q_len, num_heads, dh),
        key=k, value=v,
        causal=False, name="%s_att" % name)
    att = _merge_heads(att, q_len, model_dim)
    return sym.FullyConnected(data=att, num_hidden=model_dim, flatten=False,
                              name="%s_proj" % name)


def _ffn(x, name, model_dim, ffn_dim):
    h = sym.FullyConnected(data=x, num_hidden=ffn_dim, flatten=False,
                           name="%s_ffn1" % name)
    h = sym.Activation(h, act_type="relu")
    return sym.FullyConnected(data=h, num_hidden=model_dim, flatten=False,
                              name="%s_ffn2" % name)


# copied from mxnet_tpu/models/transformer.py (:109-162, backend-free)
def _embed_with_pos(tokens, vocab_size, model_dim, seq_len, name):
    embed = sym.Embedding(data=tokens, input_dim=vocab_size,
                          output_dim=model_dim, name="%s_embed" % name)
    pos = sym.Variable("%s_pos_weight" % name, shape=(seq_len, model_dim))
    return sym.broadcast_add(
        embed, sym.Reshape(pos, shape=(1, seq_len, model_dim)),
        name="%s_pos_add" % name)


def get_symbol_mt(vocab_size=32000, num_layers=6, num_heads=8, model_dim=512,
                  ffn_dim=2048, src_len=64, tgt_len=64, **kwargs):
    """Encoder-decoder Transformer-base for MT (BASELINE.md stretch config:
    "Transformer-base MT"), the JAX package's ``get_symbol_mt`` node for
    node: a pre-norm encoder of non-causal self-attention, a decoder of
    causal self-attention and cross-attention on the encoder's memory.

    Inputs: ``data`` (B, src_len) source tokens, ``dec_data`` (B, tgt_len)
    shifted-right target tokens, ``softmax_label`` (B, tgt_len). Fixed
    lengths (pad to bucket shapes; BucketingModule handles the rest) —
    padding attends as ordinary tokens, the toy/bucketed regime this model
    targets."""
    src = sym.Variable("data")
    tgt = sym.Variable("dec_data")
    label = sym.Variable("softmax_label")

    # ---- encoder: pre-norm self-attention stack, non-causal
    x = _embed_with_pos(src, vocab_size, model_dim, src_len, "enc")
    for i in range(num_layers):
        n = "enc%d" % i
        ln = _layer_norm(x, "%s_ln1" % n, model_dim)
        x = x + _attention_block(ln, n + "_self", num_heads, model_dim,
                                 src_len, causal=False)
        x = x + _ffn(_layer_norm(x, "%s_ln2" % n, model_dim), n,
                     model_dim, ffn_dim)
    memory = _layer_norm(x, "enc_final_ln", model_dim)

    # ---- decoder: causal self-attention + cross-attention on the memory
    y = _embed_with_pos(tgt, vocab_size, model_dim, tgt_len, "dec")
    for i in range(num_layers):
        n = "dec%d" % i
        ln = _layer_norm(y, "%s_ln1" % n, model_dim)
        y = y + _attention_block(ln, n + "_self", num_heads, model_dim,
                                 tgt_len, causal=True)
        y = y + _cross_attention(_layer_norm(y, "%s_ln2" % n, model_dim),
                                 memory, n + "_cross", num_heads, model_dim,
                                 tgt_len, src_len)
        y = y + _ffn(_layer_norm(y, "%s_ln3" % n, model_dim), n,
                     model_dim, ffn_dim)
    y = _layer_norm(y, "dec_final_ln", model_dim)
    y = sym.Reshape(y, shape=(-1, model_dim))
    logits = sym.FullyConnected(data=y, num_hidden=vocab_size, name="mt_head")
    label_flat = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(data=logits, label=label_flat, name="softmax")


def get_prefill_symbol(vocab_size=32000, num_layers=6, num_heads=8,
                       model_dim=512, ffn_dim=2048, prefill_len=64,
                       pos_len=None, **kwargs):
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
                      per_stream_slots=False, global_slots=False,
                      token_out=True, **kwargs):
    """Serving single-token decode graph over a KV buffer of ``max_len``
    slots per layer.

    Inputs beyond the weights: ``data`` (B, 1) token ids, ``pos_idx`` (B, 1)
    absolute positions, ``slot_onehot`` the slot each token writes,
    ``kv_mask`` the additive score mask (0 on slots holding context, the
    current one included; a large negative elsewhere), and the buffers
    ``kv_k_i``/``kv_v_i``. The KV write is in-graph:
    ``kv' = kv·(1-oh) + kv_new·oh``; the updated buffers are outputs.

    - the per-lane ring (default): ``slot_onehot`` and ``kv_mask`` are
      (max_len,), the buffers (B, H, max_len, dh), every lane at one
      position;
    - ``per_stream_slots``: ``slot_onehot`` and ``kv_mask`` are (B,
      max_len), one write slot, valid-slot set and position per lane; an
      all-zero onehot row writes nothing, which is how idle lanes ride
      along;
    - ``global_slots`` (per-stream staging over ONE shared pool): the
      buffers are (H, max_len, dh) with ``max_len`` the pool's slots; each
      lane's write is summed into the pool (writers' slots are disjoint)
      and each lane attends the whole pool under its own mask, so lanes
      can read the same physical page.

    T=1 collapses attention to a masked weighted sum, so it is composed from
    broadcast primitives instead of the MultiHeadAttention op.

    Outputs: ``[logits (B, vocab), k'_0, v'_0, ...]`` plus, with
    ``token_out``, a trailing on-device ``greedy_token`` (B,) argmax head;
    the decoders detect the head by that name."""
    pos_len = pos_len or max_len
    dh = model_dim // num_heads
    scale = 1.0 / float(np.sqrt(dh))
    data = sym.Variable("data")
    pos_idx = sym.Variable("pos_idx")
    oh = sym.Variable("slot_onehot")
    msk = sym.Variable("kv_mask")
    if per_stream_slots or global_slots:
        oh4 = sym.Reshape(oh, shape=(-1, 1, max_len, 1))
        msk3 = sym.Reshape(msk, shape=(-1, 1, max_len))
    else:
        oh4 = sym.Reshape(oh, shape=(1, 1, max_len, 1))
        msk3 = sym.Reshape(msk, shape=(1, 1, max_len))
    if global_slots:
        # the lanes' onehots summed over the batch axis (disjoint slots, so
        # still 0/1) give the pool's keep mask
        keep3 = 1.0 - sym.Reshape(sym.sum(oh, axis=0),
                                  shape=(1, max_len, 1))
        keep4 = None
    else:
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
        if global_slots:
            # each lane's (B,H,1,dh) new K/V into its onehot slot, summed
            # over lanes: with writer-disjoint slots the sum is the scatter
            wr_k = sym.sum(sym.broadcast_mul(k_new, oh4), axis=0)
            wr_v = sym.sum(sym.broadcast_mul(v_new, oh4), axis=0)
            k_upd = sym.broadcast_add(sym.broadcast_mul(kv_k, keep3),
                                      wr_k, name="%s_kupd" % name)
            v_upd = sym.broadcast_add(sym.broadcast_mul(kv_v, keep3),
                                      wr_v, name="%s_vupd" % name)
            kv_outs += [k_upd, v_upd]
            k_att = sym.Reshape(k_upd, shape=(-1, num_heads, max_len, dh))
            v_att = sym.Reshape(v_upd, shape=(-1, num_heads, max_len, dh))
        else:
            k_upd = sym.broadcast_add(sym.broadcast_mul(kv_k, keep4),
                                      sym.broadcast_mul(k_new, oh4),
                                      name="%s_kupd" % name)
            v_upd = sym.broadcast_add(sym.broadcast_mul(kv_v, keep4),
                                      sym.broadcast_mul(v_new, oh4),
                                      name="%s_vupd" % name)
            kv_outs += [k_upd, v_upd]
            k_att, v_att = k_upd, v_upd
        scores = sym.sum(sym.broadcast_mul(q, k_att), axis=3) * scale
        scores = sym.broadcast_add(scores, msk3)  # (B, H, S)
        p = sym.softmax(scores, axis=-1)
        ctx = sym.sum(sym.broadcast_mul(sym.expand_dims(p, axis=3), v_att),
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


def get_chunk_symbol(vocab_size=32000, num_layers=6, num_heads=8,
                     model_dim=512, ffn_dim=2048, chunk_len=8,
                     total_slots=64, pos_len=64, token_out=True, **kwargs):
    """Rectangular T-token chunk graph over the shared paged pool: ONE
    lane's next ``chunk_len`` positions scored, and written where its
    write rows say, in one dispatch. The paged decoder's chunked prefill
    and the speculative verify pass are this graph at two T.

    Inputs beyond the weights: ``data`` and ``pos_idx`` (1, T) (pad rows
    0), ``write_onehot`` (T, total_slots) each row's write slot (an
    all-zero row writes nothing: the pad rows, and the zero-write replay
    of a fully cached prompt, ``kv·1 + Σ(new·0) = kv``), ``att_mask`` (T,
    total_slots) each row's additive mask (the lane's earlier slots and
    the chunk's slots up to row j; all T writes land before attention), and
    the pool buffers ``kv_k_i``/``kv_v_i`` (H, total_slots, dh).

    Outputs: ``[logits (T, vocab), k'_0, v'_0, ...]`` plus, with
    ``token_out``, a trailing on-device ``chunk_token`` (T,) argmax head."""
    T, S = int(chunk_len), int(total_slots)
    dh = model_dim // num_heads
    scale = 1.0 / float(np.sqrt(dh))
    data = sym.Variable("data")
    pos_idx = sym.Variable("pos_idx")
    w_oh = sym.Variable("write_onehot")
    msk = sym.Variable("att_mask")
    w4 = sym.Reshape(w_oh, shape=(1, T, S, 1))
    keep3 = 1.0 - sym.Reshape(sym.sum(w_oh, axis=0), shape=(1, S, 1))
    msk3 = sym.Reshape(msk, shape=(1, T, S))
    emb = sym.Embedding(data=data, input_dim=vocab_size,
                        output_dim=model_dim, name="embed")
    posrow = sym.Embedding(data=pos_idx, input_dim=pos_len,
                           output_dim=model_dim, name="pos_embed")
    x = emb + posrow  # (1, T, M)
    kv_outs = []
    for i in range(num_layers):
        name = "layer%d" % i
        ln = _layer_norm(x, "%s_ln1" % name, model_dim)
        qkv = sym.FullyConnected(data=ln, num_hidden=3 * model_dim,
                                 flatten=False, name="%s_qkv" % name)
        q, k_new, v_new = _split_fused(qkv, 3, T, num_heads, dh)
        kv_k = sym.Variable("kv_k_%d" % i)
        kv_v = sym.Variable("kv_v_%d" % i)
        # the T new rows into the pool: (H,T,1,dh)·(1,T,S,1) summed over
        # the rows (writer-disjoint slots: the sum is the scatter)
        k_rows = sym.Reshape(k_new, shape=(num_heads, T, 1, dh))
        v_rows = sym.Reshape(v_new, shape=(num_heads, T, 1, dh))
        wr_k = sym.sum(sym.broadcast_mul(k_rows, w4), axis=1)
        wr_v = sym.sum(sym.broadcast_mul(v_rows, w4), axis=1)
        k_upd = sym.broadcast_add(sym.broadcast_mul(kv_k, keep3), wr_k,
                                  name="%s_kupd" % name)
        v_upd = sym.broadcast_add(sym.broadcast_mul(kv_v, keep3), wr_v,
                                  name="%s_vupd" % name)
        kv_outs += [k_upd, v_upd]
        q4 = sym.Reshape(q, shape=(num_heads, T, 1, dh))
        k4 = sym.Reshape(k_upd, shape=(num_heads, 1, S, dh))
        v4 = sym.Reshape(v_upd, shape=(num_heads, 1, S, dh))
        scores = sym.sum(sym.broadcast_mul(q4, k4), axis=3) * scale
        scores = sym.broadcast_add(scores, msk3)  # (H, T, S)
        p = sym.softmax(scores, axis=-1)
        ctx = sym.sum(sym.broadcast_mul(sym.expand_dims(p, axis=3), v4),
                      axis=2)  # (H, T, dh)
        att = sym.Reshape(
            sym.SwapAxis(sym.Reshape(ctx, shape=(-1, num_heads, T, dh)),
                         dim1=1, dim2=2),
            shape=(-1, T, model_dim))
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
        outs.append(sym.argmax(logits, axis=-1, name="chunk_token"))
    return sym.Group(outs)


def draft_config(cfg, num_layers=1):
    """The speculative draft's config: the first ``num_layers`` blocks of a
    target's. Weight names are positional, so the target's checkpoint feeds
    the draft unchanged (the deeper layers' entries go unread)."""
    k = int(num_layers)
    if not 0 < k <= int(cfg.get("num_layers", k)):
        raise ValueError("draft_config: draft num_layers %d not in (0, %d]"
                         % (k, int(cfg.get("num_layers", k))))
    out = dict(cfg)
    out["num_layers"] = k
    return out


def get_symbol(vocab_size=32000, num_layers=6, num_heads=8, model_dim=512,
               ffn_dim=2048, seq_len=64, **kwargs):
    """The training graph (softmax head over (B·T, vocab)); its arguments
    name the weights every serving graph reads. Extra keywords are accepted
    and ignored, as the reference's graph functions do."""
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
