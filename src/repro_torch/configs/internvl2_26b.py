"""internvl2-26b — VLM: the InternViT frontend, a stub of patch embeddings as
in the reference, + the InternLM2 decoder backbone [arXiv:2404.16821]: the
port's copy of ``repro.configs.internvl2_26b``.

``vision_tokens`` stub embeddings are prepended to the text stream; their
labels are 0 and their mask 0, so the loss is over the text only.
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    vision_tokens=256,  # stub ViT patch embeddings prepended to the text stream
    citation="arXiv:2404.16821",
)

SMOKE = ArchConfig(
    name="internvl2-smoke",
    arch_type="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab=512,
    vision_tokens=16,
    citation="reduced variant of arXiv:2404.16821",
)
