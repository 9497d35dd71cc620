"""The evaluation data path (port of facevae_tpu/data, without the training
augmentation and loader): the frame datasets and the port's own PNG / GIF
I/O."""
from facevae_tpu_torch.data.dataset import DatasetRepeater, FramesDataset, PairedDataset, read_video
from facevae_tpu_torch.data.image_io import read_png, write_gif, write_png
