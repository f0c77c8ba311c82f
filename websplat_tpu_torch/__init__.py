"""websplat_tpu_torch -- the PyTorch + CUDA port of websplat_tpu.

Every single-device frame of an uncompressed (PLY) or compressed (c3dgs
npz) cloud that the JAX package renders, on tensors: for a compressed
cloud the per-frame expansion of its int8 streams and codebooks
(optionally frustum-culled and compacted first), then a fused frontend
(row-major slot walk with overflow on, center-out for clamped splats with
overflow off), the overflow walk's two levels and the dense extreme-tail
grid with a compaction (as far as the config turns them on), the sort and
tile ranges, and the tile rasterizer (the scan or tree composite, or the
slab composites "mxu" / "hybrid").  Beside the frame, the packed emission
(``ops/preprocess.py:preprocess_packed`` and ``ops/emit_compact.py``).  On
an NVIDIA Hopper card the frontend, the overflow walk, the compactor, both
rasterizers and the packed emission are hand-written CUDA kernels
(``csrc/``, built by nvcc at first use, ``kernels/build.py``); on the CPU
each runs its plain PyTorch version.  The host layer (cameras.json scenes,
animation, the orbit controller, a stopwatch) and the apps
(``python -m websplat_tpu_torch.apps.{render,measure,video,viewer}``) are
the JAX package's.
The package and its subpackages export the JAX package's public names
(``tests/test_torch_public_names.py`` accounts for each of them).
The JAX package ``websplat_tpu`` is the reference this package is held
against; this package imports neither it nor JAX.
"""

__version__ = "0.1.0"

from websplat_tpu_torch.config import RasterConfig, SplattingArgs
from websplat_tpu_torch.io.loader import GaussianCloud, load_gaussian_cloud
from websplat_tpu_torch.models.camera import (
    PerspectiveCamera,
    PerspectiveProjection,
    build_proj,
    focal2fov,
    fov2focal,
    world2view,
)
from websplat_tpu_torch.models.scene import Scene, SceneCamera, Split
from websplat_tpu_torch.render.renderer import GaussianRenderer

__all__ = [
    "RasterConfig",
    "SplattingArgs",
    "GaussianCloud",
    "load_gaussian_cloud",
    "PerspectiveCamera",
    "PerspectiveProjection",
    "build_proj",
    "focal2fov",
    "fov2focal",
    "world2view",
    "Scene",
    "SceneCamera",
    "Split",
    "GaussianRenderer",
]
