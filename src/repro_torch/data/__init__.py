from .pipeline import DataConfig, DataState, Pipeline, batch_at

__all__ = ["DataConfig", "DataState", "Pipeline", "batch_at"]
