"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct]:
the port's copy of ``repro.configs.phi3_5_moe_42b``.

As the reference computes it: RMSNorm, GQA attention without biases, and in
every layer a softmax router over 16 SwiGLU experts, top-2 with renormalised
gates and capacity factor 1.25 (``models.moe``); upstream's layernorm and
sparsemixer routing are not modelled. The expert tensors are stacked,
(L, 16, 4096, 6400).
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    moe_topk=2,
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab=512,
    n_experts=4,
    moe_topk=2,
    citation="reduced variant of hf:microsoft/Phi-3.5-MoE-instruct",
)
