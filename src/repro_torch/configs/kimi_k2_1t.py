"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 (paper-table entry)
[arXiv:2501.kimi2]. Fine-grained experts (d_ff=2048 per expert). The port's copy
of ``repro.configs.kimi_k2_1t``.

As the reference computes it: RMSNorm, GQA attention (no MLA), and in every
layer a softmax router over 384 SwiGLU experts, top-8, with no shared expert
and no dense first layers. Its ARCH does not fit one card (about 1e12
parameters); the tests count it abstractly and train SMOKE.
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    n_experts=384,
    moe_topk=8,
    citation="arXiv:2501.kimi2",
)

SMOKE = ArchConfig(
    name="kimi-k2-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    d_ff=64,
    vocab=512,
    n_experts=4,
    moe_topk=2,
    citation="reduced variant of arXiv:2501.kimi2",
)
