"""Runtime (port of facevae_tpu/train): the inference graphs, the training
objective, the train state, the single-device step and the epoch
checkpoints."""
from facevae_tpu_torch.train.inference import InferencePipeline
from facevae_tpu_torch.train.objective import LOSS_NAMES, discriminator_forward, generator_forward
from facevae_tpu_torch.train.state import TrainState, build_all_modules, create_train_state
from facevae_tpu_torch.train.step import train_step
from facevae_tpu_torch.train.checkpoint import (AsyncCheckpointer, checkpoint_path,
                                               load_checkpoint, save_checkpoint)
