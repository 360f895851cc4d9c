"""The models of the registry: dense and MoE decoders, the RWKV-6 SSM, the
RecurrentGemma hybrid, the Whisper encoder-decoder and the VLM decoder.
``build_model`` is the construction entry point; ``DTYPES`` names the
compute and parameter dtypes it takes."""

from repro_torch.models.transformer import DTYPES, Model, build_model

__all__ = ["DTYPES", "Model", "build_model"]
