"""The decoder-only transformers (dense and MoE). ``build_model`` is the construction
entry point."""

from repro_torch.models.transformer import Model, build_model

__all__ = ["Model", "build_model"]
