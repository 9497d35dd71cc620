"""Runtime (port of facevae_tpu/train): the inference graphs, the training
objective, the train state, the single-device step, the epoch checkpoints,
the logger, the epoch loop (train/loop.py) and the training CLI
(train/cli.py, python -m facevae_tpu_torch.train)."""
from facevae_tpu_torch.train.inference import InferencePipeline
from facevae_tpu_torch.train.objective import LOSS_NAMES, discriminator_forward, generator_forward
from facevae_tpu_torch.train.state import TrainState, build_all_modules, create_train_state
from facevae_tpu_torch.train.step import train_step
from facevae_tpu_torch.train.checkpoint import (AsyncCheckpointer, checkpoint_path,
                                               load_checkpoint, save_checkpoint)
