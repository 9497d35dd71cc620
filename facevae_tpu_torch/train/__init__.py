"""Runtime (port of facevae_tpu/train): inference.py only in this slice."""
from facevae_tpu_torch.train.inference import InferencePipeline
