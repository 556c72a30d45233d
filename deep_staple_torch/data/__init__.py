from .nifti import NiftiImage, load_nifti, save_nifti
from .np_ops import pad_to_size_np, resize_nd_np

__all__ = ["NiftiImage", "load_nifti", "save_nifti", "pad_to_size_np", "resize_nd_np"]
