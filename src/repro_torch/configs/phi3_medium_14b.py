"""phi3-medium-14b — dense, RoPE + SwiGLU + GQA [arXiv:2404.14219]: the port's
copy of ``repro.configs.phi3_medium_14b``.

An RMSNorm / SwiGLU decoder with no biases and an untied LM head, as the
reference computes it (upstream fuses qkv and gate/up; here they are apart).
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    citation="arXiv:2404.14219",
)

SMOKE = ArchConfig(
    name="phi3-medium-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=160,
    n_heads=4,
    n_kv_heads=2,
    d_ff=448,
    vocab=512,
    citation="reduced variant of arXiv:2404.14219",
)
