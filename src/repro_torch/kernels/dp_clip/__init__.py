from repro_torch.kernels.dp_clip.ops import (LAUNCHES, clip_accumulate,
                                             clip_accumulate_leaf,
                                             fused_sumsq, sumsq)

__all__ = ["LAUNCHES", "clip_accumulate", "clip_accumulate_leaf",
           "fused_sumsq", "sumsq"]
