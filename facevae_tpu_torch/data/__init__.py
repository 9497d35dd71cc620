"""The data path (port of facevae_tpu/data): the frame datasets, the
prefetching loader and the port's own image and video I/O.  The CPU augmentation
(data/augmentation.py, cv2 and PIL), the on-device augmentation
(data/device_aug.py) and the device frame cache (data/device_cache.py) are
imported from their modules."""
from facevae_tpu_torch.data.dataset import DatasetRepeater, FramesDataset, PairedDataset, read_video
from facevae_tpu_torch.data.image_io import (read_gif, read_image, read_mp4, read_png, write_gif,
                                             write_png)
from facevae_tpu_torch.data.loader import PrefetchLoader
