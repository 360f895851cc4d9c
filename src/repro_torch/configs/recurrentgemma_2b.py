"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427]: the port's copy of ``repro.configs.recurrentgemma_2b``.

head_dim 256, a single KV head on the attention layers, which attend within
``local_window`` positions. Layers come in ``rec, rec, attn`` units stacked
under ``params["units"]``; the 26 layers leave two recurrent layers over,
un-stacked under ``params["tail"]`` (``models.transformer``).
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    hybrid_pattern=("rec", "rec", "attn"),
    local_window=2048,
    citation="arXiv:2402.19427",
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke",
    arch_type="hybrid",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    d_ff=384,
    vocab=512,
    head_dim=32,
    hybrid_pattern=("rec", "rec", "attn"),
    local_window=64,
    citation="reduced variant of arXiv:2402.19427",
)
