"""ViT encoder, attentive probe, transformer blocks and initializers."""
