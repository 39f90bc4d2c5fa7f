from .pipeline import DataConfig, Prefetcher, SyntheticTokens, pack_documents
__all__ = ["DataConfig", "SyntheticTokens", "Prefetcher", "pack_documents"]
