from repro_torch.data.pipeline import SyntheticLM, make_batches

__all__ = ["SyntheticLM", "make_batches"]
