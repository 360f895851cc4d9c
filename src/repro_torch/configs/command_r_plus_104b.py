"""command-r-plus-104b — dense, GQA (96H/8kv), no biases
[hf:CohereForAI/c4ai-command-r-v01]: the port's copy of
``repro.configs.command_r_plus_104b``. Large enough that the fp8 residue codec
and hierarchical ScaleCom matter.

As the reference computes it: a sequential RMSNorm / SwiGLU decoder with an
untied LM head (upstream's parallel attention/MLP block, layernorm and tied
embeddings are not modelled).
"""

from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    citation="hf:CohereForAI/c4ai-command-r-v01",
)

SMOKE = ArchConfig(
    name="command-r-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=192,
    n_heads=6,
    n_kv_heads=2,
    d_ff=512,
    vocab=512,
    citation="reduced variant of hf:CohereForAI/c4ai-command-r-v01",
)
