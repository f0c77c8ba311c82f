"""websplat_tpu_torch -- the PyTorch + CUDA port of websplat_tpu.

The default single-device frame of an uncompressed cloud, on tensors:
a fused frontend, two overflow walks, the dense extreme-tail grid with a
compaction, the sort and tile ranges, and the tile rasterizer.  On an
NVIDIA Hopper card the frontend, the overflow walk, the compactor and the
rasterizer are hand-written CUDA kernels (``csrc/``, built by nvcc at first
use, ``kernels/build.py``); on the CPU each runs its plain PyTorch version.
The JAX package ``websplat_tpu`` is the reference this package is held
against; this package imports neither it nor JAX.
"""

__version__ = "0.1.0"

from websplat_tpu_torch.config import RasterConfig, SplattingArgs
from websplat_tpu_torch.io.loader import GaussianCloud, load_gaussian_cloud
from websplat_tpu_torch.models.camera import PerspectiveCamera, PerspectiveProjection
from websplat_tpu_torch.render.renderer import GaussianRenderer

__all__ = [
    "RasterConfig",
    "SplattingArgs",
    "GaussianCloud",
    "load_gaussian_cloud",
    "PerspectiveCamera",
    "PerspectiveProjection",
    "GaussianRenderer",
]
