# copied from mxnet_tpu/models/recommender.py (backend-free)
"""DLRM-style two-tower recommender: embedding tables + MLP.

The embedding-dominated member of the zoo: most of the trainable bytes
live in two ``SparseEmbedding`` tables whose gradients are row-sparse by
contract, so training ships and updates only the rows a batch looked up
(``sparse/kvstore_sparse.py``).

Architecture: sparse id features ``user``/``item`` → embedding rows; dense
features → bottom MLP projected to the embedding width; the three vectors
concatenate, with the explicit user·item dot appended, into a top MLP
ending in a logistic click head.

Inputs: ``user`` (B,), ``item`` (B,) integer ids; ``dense`` (B, dense_dim)
float features; ``label`` (B,) in {0,1}.
"""
from .. import symbol as sym

__all__ = ["get_symbol"]


def _mlp(x, dims, name, act="relu"):
    for i, d in enumerate(dims):
        x = sym.FullyConnected(x, num_hidden=d, name="%s_fc%d" % (name, i))
        x = sym.Activation(x, act_type=act, name="%s_act%d" % (name, i))
    return x


def get_symbol(num_users=65536, num_items=32768, embed_dim=64, dense_dim=16,
               bottom_hidden=(128,), top_hidden=(512, 256), **kwargs):
    """Build the recommender Symbol (defaults: tables 65536 x 64 and
    32768 x 64, bottom MLP (128, 64), top MLP (512, 256))."""
    user = sym.Variable("user")
    item = sym.Variable("item")
    dense = sym.Variable("dense")
    label = sym.Variable("label")

    u = sym.SparseEmbedding(data=user, input_dim=num_users,
                            output_dim=embed_dim, name="user_embed")
    v = sym.SparseEmbedding(data=item, input_dim=num_items,
                            output_dim=embed_dim, name="item_embed")

    # bottom MLP: dense features projected to the embedding width
    d = _mlp(dense, tuple(bottom_hidden) + (embed_dim,), "bot")

    # two-tower affinity: the explicit user·item interaction
    dot_uv = sym.sum(u * v, axis=1, keepdims=True)

    z = sym.Concat(u, v, d, dot_uv, num_args=4, dim=1, name="interact")
    top = _mlp(z, tuple(top_hidden), "top")
    logit = sym.FullyConnected(top, num_hidden=1, name="click")
    return sym.LogisticRegressionOutput(data=logit, label=label,
                                        name="click_prob")
