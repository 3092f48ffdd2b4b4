from repro_torch.data.pipeline import DataConfig, SyntheticLM, pack_documents

__all__ = ["DataConfig", "SyntheticLM", "pack_documents"]
