"""Host-side math and image helpers (NumPy); counterpart of
``websplat_tpu/utils/__init__.py``, with the same names."""

from websplat_tpu_torch.utils import gmath
from websplat_tpu_torch.utils.image import psnr, write_png

__all__ = ["gmath", "psnr", "write_png"]
