"""Layer functions of the attention-only decoders: norms, positions,
embeddings, feed-forward blocks and attention (the JAX package's
``models/layers``, less MLA, MoE, mamba2 and rwkv6)."""
