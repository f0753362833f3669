from unimedvl_tpu_torch.inference.pipeline import GenContext, InterleaveInferencer

__all__ = ["GenContext", "InterleaveInferencer"]
