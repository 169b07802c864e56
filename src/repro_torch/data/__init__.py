from repro_torch.data.pipeline import DataState, SyntheticFrames, SyntheticLM

__all__ = ["DataState", "SyntheticFrames", "SyntheticLM"]
