from repro_torch.optim.compression import (  # noqa: F401
    CompressionState, compressed_allreduce, compression_init, topk_compress,
    topk_decompress,
)
