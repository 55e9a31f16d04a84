"""Layer functions of the attention-only, MoE and MLA decoders: norms,
positions, embeddings, feed-forward blocks, attention, mixture of experts
and multi-head latent attention (the JAX package's ``models/layers``,
less mamba2 and rwkv6)."""
