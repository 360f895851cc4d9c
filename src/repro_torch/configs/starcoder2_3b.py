"""starcoder2-3b — dense, GQA (kv=2), RoPE [arXiv:2402.19173]: the port's copy
of ``repro.configs.starcoder2_3b``.

What is built is what the reference computes, not the upstream model: an
RMSNorm / SwiGLU decoder with no biases (upstream StarCoder2 uses layernorm,
a GELU MLP and biases), untied LM head.
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    citation="arXiv:2402.19173",
)

SMOKE = ArchConfig(
    name="starcoder2-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    citation="reduced variant of arXiv:2402.19173",
)
