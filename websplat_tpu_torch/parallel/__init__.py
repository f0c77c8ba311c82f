"""Rendering several views: on one device, or over a group of devices.

Counterpart of ``websplat_tpu/parallel/__init__.py``, with the same names
but ``view_mesh`` (a JAX device mesh), whose counterpart is
``parallel/group.py:view_group`` (a ``torch.distributed`` group).
"""

from websplat_tpu_torch.parallel.multiview import (
    make_view_parallel_renderer,
    render_views,
    stack_cameras,
)

__all__ = ["make_view_parallel_renderer", "render_views", "stack_cameras"]
