"""The whole-frame renderer; counterpart of
``websplat_tpu/render/__init__.py``, with the same names."""

from websplat_tpu_torch.render.renderer import GaussianRenderer, render_frame

__all__ = ["GaussianRenderer", "render_frame"]
