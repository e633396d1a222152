"""Data sources of the port: the LM's synthetic bigram stream."""

from .synthetic import bigram_corpus, lm_batch_stream

__all__ = ["bigram_corpus", "lm_batch_stream"]
