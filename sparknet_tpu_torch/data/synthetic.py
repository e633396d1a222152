"""Synthetic token streams for the transformer LM: bigram_corpus and
lm_batch_stream, copied from sparknet_tpu/data/synthetic.py (numpy only).
With the same seed they give the same token stream as the JAX package.
"""

import numpy as np


def bigram_corpus(vocab_size=512, seed=0, concentration=0.3):
    """Learnable synthetic token stream: a fixed random bigram transition
    table (Dirichlet rows, peaked by ``concentration``). A model that
    learns the table reaches the table's conditional entropy; an
    untrained one sits at ln(vocab).
    Returns (sample_fn(n_seqs, seq_len, rng) -> int32 (n, S+1), the exact
    per-token cross-entropy floor in nats)."""
    rs = np.random.RandomState(seed)
    probs = rs.dirichlet([concentration] * vocab_size, size=vocab_size)
    # asymptotic floor: row entropies weighted by the chain's STATIONARY
    # distribution (tokens past the uniform first position converge to
    # it), not by a uniform predecessor — H = -sum_i pi_i sum_j P_ij ln P_ij
    pi = np.full(vocab_size, 1.0 / vocab_size)
    for _ in range(200):
        nxt = pi @ probs
        if np.abs(nxt - pi).max() < 1e-12:
            pi = nxt
            break
        pi = nxt
    row_ent = -(probs * np.log(np.maximum(probs, 1e-12))).sum(1)
    floor = float(pi @ row_ent)
    cum = np.cumsum(probs, axis=1)
    cum[:, -1] = 1.0   # float cumsum can end at 1-eps; u above it would
    #                    index one past the vocab

    def sample(n, seq_len, rng):
        toks = np.empty((n, seq_len + 1), np.int32)
        toks[:, 0] = rng.randint(0, vocab_size, n)
        for t in range(seq_len):
            u = rng.rand(n)
            rows = cum[toks[:, t]]
            toks[:, t + 1] = (rows < u[:, None]).sum(1)
        return toks

    return sample, floor


def lm_batch_stream(vocab_size, batch_size, seq_len, seed=0,
                    concentration=0.3):
    """Infinite {"data", "label"} feed dicts from bigram_corpus (label =
    next token). -> (iterator, loss_floor_nats)."""
    sample, floor = bigram_corpus(vocab_size, seed=seed,
                                  concentration=concentration)
    rng = np.random.RandomState(seed + 1)

    def gen():
        while True:
            toks = sample(batch_size, seq_len, rng)
            yield {"data": toks[:, :-1], "label": toks[:, 1:]}

    return gen(), floor
