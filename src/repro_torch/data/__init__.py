from repro_torch.data.pipeline import (
    DataConfig,
    TokenPipeline,
    pack_documents,
)

__all__ = ["DataConfig", "TokenPipeline", "pack_documents"]
