from repro_torch.kernels.dp_clip.ops import (LAUNCHES, MAX_CHUNK,
                                             clip_accumulate,
                                             clip_accumulate_chunk,
                                             clip_accumulate_chunk_leaf,
                                             clip_accumulate_leaf,
                                             fused_sumsq, sumsq,
                                             sumsq_chunk)

__all__ = ["LAUNCHES", "MAX_CHUNK", "clip_accumulate",
           "clip_accumulate_chunk", "clip_accumulate_chunk_leaf",
           "clip_accumulate_leaf", "fused_sumsq", "sumsq", "sumsq_chunk"]
