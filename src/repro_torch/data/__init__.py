from .pipeline import SyntheticLMData, DataState

__all__ = ["SyntheticLMData", "DataState"]
