"""Host-side cloud IO (PLY and c3dgs npz); counterpart of
``websplat_tpu/io/__init__.py``, with the same names."""

from websplat_tpu_torch.io.loader import GaussianCloud, load_gaussian_cloud

__all__ = ["GaussianCloud", "load_gaussian_cloud"]
