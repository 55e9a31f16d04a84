"""Layer functions of the decoders: norms, positions, embeddings,
feed-forward blocks, attention, mixture of experts, multi-head latent
attention, mamba2 (SSD) and rwkv6 (the JAX package's ``models/layers``)."""
