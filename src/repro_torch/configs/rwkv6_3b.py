"""rwkv6-3b "Finch" — attention-free SSM with data-dependent decay
[arXiv:2404.05892]: the port's copy of ``repro.configs.rwkv6_3b``.

n_heads / n_kv_heads are nominal (d_model / ssm_head_dim). As the reference
computes it: RMSNorm before the time mix and the channel mix, token shift
with five low-rank (64 wide) ddlerp adapters, the decay exp(-exp(wd)) from
its own adapter, a per-head bonus and group norm (``models.rwkv``).
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # = d_model / ssm_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    ssm_head_dim=64,
    citation="arXiv:2404.05892",
)

SMOKE = ArchConfig(
    name="rwkv6-smoke",
    arch_type="ssm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=448,
    vocab=512,
    ssm_head_dim=32,
    citation="reduced variant of arXiv:2404.05892",
)
