"""Pure tensor ops (port of facevae_tpu/ops): geometry.py, heatmap.py,
grid_sample.py, interpolate.py, motion.py, normalization.py, tps.py,
rotations.py (not exported, as in the JAX package), and fast_warp.py with
the warp kernels' wrappers.  Exported as the JAX package exports its own
(the resize / pooling ops take PyTorch's NC(D)HW layout)."""
from facevae_tpu_torch.ops.geometry import (
    make_coordinate_grid_2d,
    make_coordinate_grid_3d,
    rotation_matrix_x,
    rotation_matrix_y,
    rotation_matrix_z,
    transform_kp,
    transform_kp_with_new_pose,
)
from facevae_tpu_torch.ops.heatmap import (
    heatmap2kp,
    kp2gaussian_2d,
    kp2gaussian_3d,
    out2heatmap,
)
from facevae_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_3d
from facevae_tpu_torch.ops.interpolate import (
    avg_pool_2d,
    avg_pool_3d,
    interpolate_bilinear_2d,
    max_pool_2d,
    resize_bilinear_half,
    upsample_nearest_2d,
    upsample_nearest_3d,
)
from facevae_tpu_torch.ops.motion import (
    create_deformed_source_image,
    create_heatmap_representations,
    create_sparse_motions,
)
from facevae_tpu_torch.ops.normalization import (
    apply_imagenet_normalization,
    apply_vggface_normalization,
)
from facevae_tpu_torch.ops.tps import (
    TransformParams,
    random_transform_params,
    transform_frame,
    warp_coordinates,
)
