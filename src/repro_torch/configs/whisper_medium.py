"""whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356]: the
port's copy of ``repro.configs.whisper_medium``.

The mel-spectrogram and conv frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, encoder_seq, d_model).
LayerNorm, a GELU MLP with biases, sinusoidal positions, full MHA (16 KV
heads) with qkv biases, and cross-attention in every decoder layer.
Positions are sinusoidal, not learned, so the backbone takes text longer
than Whisper's native 448 positions.
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    encoder_layers=24,
    encoder_seq=1500,
    norm="layernorm",
    qkv_bias=True,
    citation="arXiv:2212.04356",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    arch_type="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    encoder_layers=2,
    encoder_seq=64,
    norm="layernorm",
    qkv_bias=True,
    citation="reduced variant of arXiv:2212.04356",
)
