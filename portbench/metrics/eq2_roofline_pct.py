"""The round's Eq.-2 work at the card's bound over the device time of the
pair-KL kernels (``csrc/kl_mutual_pair.cu``).  Unsharded, the round makes
one square call on the (K, B_pub * S, V) public logits (forward and
backward); on a client mesh each card makes a pair call of its K_loc live
clients against the K gathered."""
from portbench.yard import trace as T
from portbench.yard import work

LAYER = "Eq. 2: core/mutual.py, kernels/kl_mutual.py"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("kl_square_fwd", "kl_square_bwd", "kl_pair_fwd", "kl_pair_bwd")


def read(ctx):
    secs = T.device_seconds(ctx.trace, KERNELS)
    if secs <= 0:
        return None
    tr, V = ctx.cell["traffic"], ctx.cell["config"]["model"]["vocab_size"]
    K, rows, n = tr["clients"], tr["public_batch"] * tr["seq"], tr["cards"]
    if n == 1:
        bound = work.kl_bound_s(K, K, rows, V, square=True)
    else:
        k_loc = -(-K // n)
        bound = n * work.kl_bound_s(k_loc, K, rows, V, square=False)
    return 100.0 * bound * ctx.trace.n_rounds / secs
