"""Pure tensor ops (port of facevae_tpu/ops): geometry.py, heatmap.py,
interpolate.py, motion.py, and fast_warp.py with the warp kernel's wrapper."""
