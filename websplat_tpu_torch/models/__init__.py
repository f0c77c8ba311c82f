"""Camera model and cameras.json scenes (NumPy); counterpart of
``websplat_tpu/models/__init__.py``, with the same names."""

from websplat_tpu_torch.models.camera import (
    PerspectiveCamera,
    PerspectiveProjection,
    build_proj,
    focal2fov,
    fov2focal,
    world2view,
)
from websplat_tpu_torch.models.scene import Scene, SceneCamera, Split

__all__ = [
    "PerspectiveCamera",
    "PerspectiveProjection",
    "build_proj",
    "focal2fov",
    "fov2focal",
    "world2view",
    "Scene",
    "SceneCamera",
    "Split",
]
