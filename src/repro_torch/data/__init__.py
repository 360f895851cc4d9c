from repro_torch.data.pipeline import SyntheticLM, make_batches, model_inputs

__all__ = ["SyntheticLM", "make_batches", "model_inputs"]
