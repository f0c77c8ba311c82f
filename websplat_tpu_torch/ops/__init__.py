"""Frame stages: plain PyTorch versions and their CUDA kernel wrappers.

Counterpart of ``websplat_tpu/ops/__init__.py``.  ``DeviceCloud``,
``sort_instances`` and ``tile_ranges`` keep their names.  The JAX
package's other exports have another contract here, so each is named by
its counterpart instead:

- ``CameraParams`` and ``DeviceSettings`` (device pytrees of the camera and
  the settings): ``ops/preprocess.py:FrameScalars`` on the host, and on the
  device ``render/renderer.py:frame_block``, one (55,) f32 tensor;
- ``preprocess`` (the slot-instance stream): ``render/renderer.py:
  frame_stream``, and ``ops/preprocess.py:preprocess_packed`` for the
  packed emission;
- ``sort_instances`` with ``n_valid`` (the sort of a device-side live
  prefix): ``ops/sort.py:sort_live``.
"""

from websplat_tpu_torch.ops.preprocess import DeviceCloud
from websplat_tpu_torch.ops.sort import sort_instances, tile_ranges

__all__ = ["DeviceCloud", "sort_instances", "tile_ranges"]
