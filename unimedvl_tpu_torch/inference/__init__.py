from unimedvl_tpu_torch.inference.pipeline import GenContext, InterleaveInferencer
from unimedvl_tpu_torch.inference.serving import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "GenContext", "InterleaveInferencer", "Request"]
