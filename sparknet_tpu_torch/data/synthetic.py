"""Synthetic data, copied from sparknet_tpu/data/synthetic.py (numpy
only); from the same seed each gives the same arrays as the JAX package.

* ``class_gaussian_images`` — class-conditional Gaussian images, the
  CIFAR app's stand-in when no binaries are given.
* ``shape_texture_images`` — ten shape/texture classes under random pose,
  colors and noise: what ``make_synth_cifar`` writes as CIFAR binaries.
* ``bigram_corpus`` / ``lm_batch_stream`` — the transformer LM's token
  stream.
"""

import functools

import numpy as np


def class_gaussian_images(n, shape=(3, 32, 32), num_classes=10, seed=0,
                          signal=2.0):
    """(images float32 (n, *shape), labels int32): per-class mean patterns
    plus unit noise."""
    rs = np.random.RandomState(seed)
    protos = rs.randn(num_classes, *shape).astype(np.float32)
    labels = rs.randint(0, num_classes, size=n).astype(np.int32)
    images = (signal * protos[labels]
              + rs.randn(n, *shape).astype(np.float32))
    return images, labels


def shape_texture_images(n, seed=0, size=32, noise=28.0, num_classes=10,
                         chunk=2048, label_noise=0.0):
    """(images uint8 (n, 3, size, size) CHW, labels int32 (n,)).

    Ten shape/texture classes under random rotation (±26°), scale,
    translation, colors and noise.  Orientation stays informative (stripe
    classes 4/5 differ by it), so rotation is bounded rather than uniform.

    ``label_noise`` > 0 is the HARD mode for convergence experiments:
    that fraction of RETURNED labels is resampled uniformly after
    rendering (images keep their true class), capping attainable test
    accuracy at (1-p) + p/K — e.g. 0.73 at p=0.3, K=10 — so strategy
    comparisons run in a contested 60-75% plateau region instead of the
    ~95% band where everything looks the same.
    """
    if num_classes > 10:
        raise ValueError("only 10 shape classes are defined")
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, num_classes, n).astype(np.int32)
    ys, xs = np.mgrid[0:size, 0:size]
    base_u = ((xs + 0.5) / size * 2 - 1).astype(np.float32)
    base_v = ((ys + 0.5) / size * 2 - 1).astype(np.float32)
    imgs = np.empty((n, 3, size, size), np.uint8)
    eps = 0.09

    def soft(x):                       # smooth indicator of x > 0
        return 1.0 / (1.0 + np.exp(np.clip(-x / eps, -30, 30)))

    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        b = i1 - i0
        lab = labels[i0:i1]
        th = rs.uniform(-0.45, 0.45, b).astype(np.float32)
        sc = rs.uniform(0.45, 0.85, b).astype(np.float32)
        tx = rs.uniform(-0.25, 0.25, b).astype(np.float32)
        ty = rs.uniform(-0.25, 0.25, b).astype(np.float32)
        freq = rs.uniform(5.5, 9.5, b).astype(np.float32)
        ph = rs.uniform(0, 2 * np.pi, b).astype(np.float32)
        # same color law for every class: color carries zero class signal
        fg = rs.uniform(110, 255, (b, 3)).astype(np.float32)
        bg = rs.uniform(0, 145, (b, 3)).astype(np.float32)
        c, s = np.cos(th)[:, None, None], np.sin(th)[:, None, None]
        u0 = base_u[None] - tx[:, None, None]
        v0 = base_v[None] - ty[:, None, None]
        u = (c * u0 + s * v0) / sc[:, None, None]
        v = (-s * u0 + c * v0) / sc[:, None, None]
        rho = np.sqrt(u * u + v * v)
        m = np.zeros((b, size, size), np.float32)
        for k in range(num_classes):
            idx = np.where(lab == k)[0]
            if not idx.size:
                continue
            U, V, R = u[idx], v[idx], rho[idx]
            F, P = freq[idx][:, None, None], ph[idx][:, None, None]
            if k == 0:                                  # disk
                mk = soft(0.72 - R)
            elif k == 1:                                # ring
                mk = soft(0.80 - R) * soft(R - 0.42)
            elif k == 2:                                # square
                mk = soft(0.62 - np.maximum(np.abs(U), np.abs(V)))
            elif k == 3:                                # diamond
                mk = soft(0.85 - (np.abs(U) + np.abs(V)))
            elif k == 4:                                # horizontal stripes
                mk = soft(np.sin(F * V + P)) * soft(0.85 - R)
            elif k == 5:                                # vertical stripes
                mk = soft(np.sin(F * U + P)) * soft(0.85 - R)
            elif k == 6:                                # checkerboard
                mk = soft(np.sin(F * U + P) * np.sin(F * V + P)) \
                    * soft(0.80 - np.maximum(np.abs(U), np.abs(V)))
            elif k == 7:                                # cross
                bar = np.maximum(soft(0.22 - np.abs(U)),
                                 soft(0.22 - np.abs(V)))
                mk = bar * soft(0.80 - np.maximum(np.abs(U), np.abs(V)))
            elif k == 8:                                # triangle (apex up)
                mk = soft((V + 0.60) * 0.65 - np.abs(U)) * soft(0.55 - V)
            else:                                       # two disks
                d1 = np.sqrt((U - 0.45) ** 2 + V * V)
                d2 = np.sqrt((U + 0.45) ** 2 + V * V)
                mk = np.maximum(soft(0.32 - d1), soft(0.32 - d2))
            m[idx] = mk
        pix = bg[:, :, None, None] + (fg - bg)[:, :, None, None] * m[:, None]
        pix += rs.randn(b, 3, size, size).astype(np.float32) * noise
        imgs[i0:i1] = np.clip(pix, 0, 255).astype(np.uint8)
    if label_noise > 0:
        labels = labels.copy()
        flip = rs.rand(n) < label_noise
        labels[flip] = rs.randint(0, num_classes,
                                  int(flip.sum())).astype(np.int32)
    return imgs, labels


@functools.lru_cache(maxsize=4)
def _bigram_table(vocab_size, seed, concentration):
    """(row-wise cumulative transition table, read-only; the floor) of
    bigram_corpus. A pure function of its arguments, kept for the
    process: at vocab 8192 its vocab^2 Dirichlet draws take seconds, and
    a process that builds several streams of one corpus (a resume, each
    mesh branch) makes the table once."""
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
    cum.flags.writeable = False
    return cum, floor


def bigram_corpus(vocab_size=512, seed=0, concentration=0.3):
    """Learnable synthetic token stream: a fixed random bigram transition
    table (Dirichlet rows, peaked by ``concentration``). A model that
    learns the table reaches the table's conditional entropy; an
    untrained one sits at ln(vocab).
    Returns (sample_fn(n_seqs, seq_len, rng) -> int32 (n, S+1), the exact
    per-token cross-entropy floor in nats)."""
    cum, floor = _bigram_table(vocab_size, seed, concentration)

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
