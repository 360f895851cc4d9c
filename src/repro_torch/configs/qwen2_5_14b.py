"""qwen2.5-14b — dense, GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family scaling]: the
port's copy of ``repro.configs.qwen2_5_14b``.

An RMSNorm / SwiGLU decoder with biases on q, k and v only, untied LM head, as
the reference computes it. SMOKE's head dim is 40 (160 / 4), so its attention
tensors' trailing axes are no multiple of a 64-wide chunk.
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    citation="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=160,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab=512,
    qkv_bias=True,
    citation="reduced variant of hf:Qwen/Qwen2.5-0.5B",
)
