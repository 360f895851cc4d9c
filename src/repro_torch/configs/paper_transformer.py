"""The paper's own Transformer-base (WMT14 En-De, Vaswani et al.): the port's
copy of ``repro.configs.paper_transformer``."""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="paper-transformer-base",
    arch_type="dense",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=37000,
    norm="layernorm",
    qkv_bias=True,
    citation="Vaswani et al. 2017; ScaleCom Table 2/3",
)

SMOKE = ArchConfig(
    name="paper-transformer-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab=512,
    norm="layernorm",
    qkv_bias=True,
    citation="reduced Vaswani et al. 2017",
)
